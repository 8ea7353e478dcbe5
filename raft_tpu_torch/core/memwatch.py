"""Memory truth: what an index holds, where, and what still fits — the
port of ``raft_tpu/core/memwatch.py`` (its byte model, live device stats,
the ledger, its scrape surface and the opt-in capacity gate).

- :func:`index_memory_model`: the bytes of every tensor field of an index
  dataclass, from shape x element size, split by :func:`memory_tier` into
  device-resident bytes and host-resident bytes (the tiered cold plane).
- :func:`device_memory_stats`: live per-device truth from
  ``torch.cuda.mem_get_info`` and ``torch.cuda.memory_stats``. Bytes that
  PyTorch's caching allocator has reserved but not handed out count as
  free: the allocator gives them to the next tensor without a new
  ``cudaMalloc``, so leaving them out would under-size the hot tier.
- :class:`MemoryLedger`: watched indexes, the reservation forecast
  (resident bytes plus an attached executor's
  :meth:`~raft_tpu_torch.core.executor.SearchExecutor.memory_reservations`),
  headroom (live stats, else a configured ``capacity_bytes`` minus the
  forecast), the ``fits``/``admit`` verdicts, named byte holds, the
  per-dispatch watermark (:meth:`MemoryLedger.sample_dispatch`, a host read
  of ``torch.cuda.memory_stats``) and the scrape surface
  (:meth:`MemoryLedger.snapshot`, :meth:`MemoryLedger.publish`,
  :meth:`MemoryLedger.federation_payload`), in the JAX package's keys and
  gauge names.
- :func:`install_gate` / :func:`admit`: the opt-in process-wide gate that
  build paths consult; without a gate every admission passes.
- :func:`parse_memory_profile` / :func:`diff_memory_profiles`: the
  allocator's own view, ``torch.cuda.memory._snapshot()`` (in place of
  XLA's pprof device-memory profile), grouped by segment and by the
  frames the snapshot recorded, and the per-group divergence between two
  snapshots, in the JAX package's keys.
"""

from __future__ import annotations

import dataclasses
import math
import re
import threading
import weakref
from typing import Any, Dict, Optional

import numpy as np
import torch

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.validation import expect

GATE_ADMITTED = "memory.gate.admitted"
GATE_REFUSED = "memory.gate.refused"
SAMPLES = "memory.samples"

_LABEL_SUB = re.compile(r"[^A-Za-z0-9_:-]").sub


class CapacityExceeded(RuntimeError):
    """The planned allocation does not fit the remaining device headroom:
    raised on the host before anything is allocated, with the numbers the
    refusal was computed from."""

    def __init__(self, what: str, required_bytes: int,
                 headroom_bytes: float):
        self.what = what
        self.required_bytes = int(required_bytes)
        self.headroom_bytes = float(headroom_bytes)
        super().__init__(
            f"{what}: planned allocation of {self.required_bytes} bytes "
            f"exceeds the remaining device headroom of "
            f"{int(self.headroom_bytes)} bytes (capacity gate — see "
            "raft_tpu_torch.core.memwatch.install_gate)")


def _is_array(v: Any) -> bool:
    return isinstance(v, (torch.Tensor, np.ndarray))


def array_bytes(a) -> int:
    """Byte size of one tensor or array from shape x element size."""
    itemsize = (a.element_size() if isinstance(a, torch.Tensor)
                else a.dtype.itemsize)
    return int(math.prod(tuple(a.shape))) * int(itemsize)


def memory_tier(a) -> str:
    """Which memory an array's bytes occupy: ``"host"`` for numpy arrays
    and pinned (page-locked) CPU tensors — the tiered cold plane —
    ``"device"`` otherwise. A CPU tensor that is not pinned counts as
    ``"device"``: a CPU-only index keeps all its tensors in one pool, as
    the JAX package's CPU default memory does."""
    if isinstance(a, np.ndarray):
        return "host"
    if isinstance(a, torch.Tensor) and a.device.type == "cpu" \
            and a.is_pinned():
        return "host"
    return "device"


def _ordinal(a) -> int:
    if isinstance(a, torch.Tensor) and a.device.type == "cuda":
        return a.device.index or 0
    return 0


def index_memory_model(index) -> dict:
    """The resident-bytes model of one index dataclass: per tensor field
    its bytes, shape, dtype and tier, and the totals. Fields that are
    ``None`` or not arrays are skipped; host-tier bytes go to
    ``host_resident_bytes`` instead of the device totals."""
    expect(dataclasses.is_dataclass(index),
           f"index_memory_model needs an index dataclass, got "
           f"{type(index)!r}")
    components: dict = {}
    total = host_total = 0
    per_device: Dict[int, int] = {}
    for f in dataclasses.fields(index):
        v = getattr(index, f.name, None)
        if not _is_array(v):
            continue
        b = array_bytes(v)
        tier = memory_tier(v)
        components[f.name] = {"bytes": b, "shard_bytes": b,
                              "shape": [int(s) for s in v.shape],
                              "dtype": str(v.dtype), "tier": tier}
        if tier == "host":
            host_total += b
            continue
        total += b
        o = _ordinal(v)
        per_device[o] = per_device.get(o, 0) + b
    # one device holds the whole index: a shard is all of it
    return {
        "family": type(index).__name__,
        "components": components,
        "resident_bytes": total,
        "shard_resident_bytes": total,
        "host_resident_bytes": host_total,
        "per_device_bytes": per_device,
    }


def packed_layout_bytes(n_lists: int, max_list_size: int, row_bytes: int,
                        *, norms: bool = True, indices: bool = True) -> int:
    """Planned bytes of one padded ``(n_lists, max_list_size, ...)`` list
    layout before it is allocated: ``row_bytes`` per slot, plus the
    float32 norm and int32 id planes when asked."""
    slots = int(n_lists) * int(max_list_size)
    b = slots * int(row_bytes)
    if norms:
        b += slots * 4
    if indices:
        b += slots * 4
    return b


def dealt_shard_bytes(arrays, r: int) -> int:
    """Per-shard bytes of dealing these build-device tensors over ``r``
    shards (``raft_tpu/core/memwatch.py:283``): each shard receives
    ``ceil(rows / r)`` list blocks of every dealt tensor. Accepts tensors,
    numpy arrays or ``(shape, dtype)`` pairs of planned buffers; pure
    shape arithmetic, computed before anything moves."""
    total = 0
    for a in arrays:
        if a is None:
            continue
        if isinstance(a, tuple):
            shape, dtype = a
            itemsize = (torch.empty((), dtype=dtype).element_size()
                        if isinstance(dtype, torch.dtype)
                        else np.dtype(dtype).itemsize)
        elif _is_array(a):
            shape = tuple(a.shape)
            itemsize = (a.element_size() if isinstance(a, torch.Tensor)
                        else a.dtype.itemsize)
        else:
            continue
        rows = -(-int(shape[0]) // max(int(r), 1))
        total += rows * int(np.prod(shape[1:], dtype=np.int64)) * itemsize
    return total


def device_memory_stats(devices=None) -> dict:
    """Live truth per CUDA device: ``{"supported": bool, "devices":
    {ordinal: {"in_use_bytes", "peak_bytes", "limit_bytes"}}}``.

    ``limit_bytes`` is the card's memory; ``in_use_bytes`` what is in use
    by anyone, less the bytes PyTorch's allocator has reserved but not
    handed out (free to the next tensor); ``peak_bytes`` the same with
    this process's allocated peak in place of its allocated bytes.
    Without a CUDA device: ``supported: False`` and no devices."""
    if devices is None:
        devices = (range(torch.cuda.device_count())
                   if torch.cuda.is_available() else ())
    out: Dict[str, Any] = {"supported": False, "devices": {}}
    for d in devices:
        free, total = torch.cuda.mem_get_info(d)
        stats = torch.cuda.memory_stats(d)
        allocated = stats.get("allocated_bytes.all.current", 0)
        reserved = stats.get("reserved_bytes.all.current", 0)
        peak = stats.get("allocated_bytes.all.peak", allocated)
        in_use = total - free - (reserved - allocated)
        out["supported"] = True
        out["devices"][int(d)] = {
            "in_use_bytes": float(in_use),
            "peak_bytes": float(in_use - allocated + peak),
            "limit_bytes": float(total),
        }
    return out


class MemoryLedger:
    """The memory truth of one serving process: watched indexes, their
    forecast, headroom and capacity verdicts, named byte holds, the
    dispatch watermark and the scrape surface.

    ``executor`` (optional, or later :meth:`attach`) wires the two
    dispatch-path touchpoints: the executor calls :meth:`sample_dispatch`
    after every dispatch, and the forecast reads its
    :meth:`~raft_tpu_torch.core.executor.SearchExecutor
    .memory_reservations`. ``capacity_bytes`` is a per-device capacity for
    a process without live stats (the CPU tests, or an operator's budget
    below the card); live limits win where there are any."""

    def __init__(self, executor=None, *,
                 capacity_bytes: Optional[float] = None):
        self.capacity_bytes = capacity_bytes
        self._lock = threading.Lock()
        # label -> weakref(index): an index dropped by its owner is not
        # kept alive by its accounting
        self._watched: "dict[str, weakref.ref]" = {}  # guarded-by: _lock
        self._reservations: Dict[str, int] = {}       # guarded-by: _lock
        # live-stats support is probed once: without a card the dispatch
        # sample is a counter bump and nothing else
        self._live_supported: Optional[bool] = None
        self._wm_in_use = 0.0     # guarded-by: _lock
        self._wm_forecast = 0.0   # guarded-by: _lock
        # the last snapshot publish() produced (federation_payload reads it)
        self.last_snapshot: Optional[dict] = None
        self.executor = None
        if executor is not None:
            self.attach(executor)

    def attach(self, executor) -> "MemoryLedger":
        """Wire ``executor`` both ways: its dispatches sample the
        watermark, the forecast reads its reservations."""
        self.executor = executor
        if hasattr(executor, "attach_memwatch"):
            executor.attach_memwatch(self)
        return self

    def watch(self, label: str, index) -> str:
        """Register ``index`` under ``label`` (sanitized to one dot-free
        segment, returned); re-watching a label replaces it."""
        label = _LABEL_SUB("-", str(label)) or "index"
        with self._lock:
            self._watched[label] = weakref.ref(index)
        return label

    def unwatch(self, label: str) -> None:
        with self._lock:
            self._watched.pop(label, None)
        tracing.reset_gauges(f"memory.index.{label}.")

    def _watched_models_locked(self) -> dict:
        out, dead = {}, []
        for label, ref in self._watched.items():
            index = ref()
            if index is None:
                dead.append(label)
            else:
                out[label] = index_memory_model(index)
        for label in dead:
            self._watched.pop(label, None)
        return out

    def resident(self) -> dict:
        """``{label: index_memory_model(index)}`` for every watched index
        still alive."""
        with self._lock:
            return self._watched_models_locked()

    def live(self) -> dict:
        """:func:`device_memory_stats` of every visible CUDA device."""
        stats = device_memory_stats()
        self._live_supported = stats["supported"]
        return stats

    def forecast(self, models: Optional[dict] = None) -> dict:
        """The reservation forecast: watched resident bytes plus the
        attached executor's static buffers and probe planes, and its
        largest graph pool on every device holding state (any replay may
        be the one that peaks), folded per device; ``peak_bytes`` is the
        worst device's."""
        if models is None:
            models = self.resident()
        per_device: Dict[int, float] = {}
        resident_total = 0
        for model in models.values():
            resident_total += model["resident_bytes"]
            for o, b in model["per_device_bytes"].items():
                per_device[o] = per_device.get(o, 0.0) + b
        donated = probe = temp = 0.0
        if self.executor is not None and hasattr(self.executor,
                                                 "memory_reservations"):
            res = self.executor.memory_reservations()
            donated = float(sum(res["donated_state_bytes"].values()))
            probe = float(sum(res["probe_plane_bytes"].values()))
            temp = float(res["max_temp_bytes"])
            for part in ("donated_state_bytes", "probe_plane_bytes"):
                for o, b in res[part].items():
                    per_device[o] = per_device.get(o, 0.0) + b
            for o in list(per_device) or [0]:
                per_device[o] = per_device.get(o, 0.0) + temp
        return {
            "resident_bytes": float(resident_total),
            "donated_state_bytes": donated,
            "probe_plane_bytes": probe,
            "max_temp_bytes": temp,
            "per_device_bytes": {int(o): float(b)
                                 for o, b in per_device.items()},
            "peak_bytes": float(max(per_device.values(), default=0.0)),
        }

    def _headroom_from(self, stats: dict, fc: Optional[dict]):
        """Headroom from inputs already read (``fc`` computed only when
        live stats cannot decide); named holds subtract last."""
        base: Optional[float] = None
        if stats["supported"] and stats["devices"]:
            rooms = [d["limit_bytes"] - d["in_use_bytes"]
                     for d in stats["devices"].values()
                     if d["limit_bytes"] > 0]
            if rooms:
                base = float(min(rooms))
        if base is None and self.capacity_bytes is not None:
            if fc is None:
                fc = self.forecast()
            base = float(self.capacity_bytes - fc["peak_bytes"])
        if base is None:
            return None
        return base - self.reserved_bytes()

    def headroom_bytes(self) -> Optional[float]:
        """Remaining per-device headroom: the least ``limit − in_use``
        over the live devices; without live stats ``capacity_bytes −
        forecast peak`` when a capacity was set; ``None`` when unknowable.
        Named holds (:meth:`reserve`) are subtracted last."""
        return self._headroom_from(self.live(), None)

    def fits(self, what, *, safety_fraction: float = 0.0) -> dict:
        """Would ``what`` (a byte count, a model dict or an index) fit?
        ``{"fits", "unknown", "required_bytes", "headroom_bytes"}``;
        ``unknown: True`` (and ``fits: True``) when there is no headroom
        source. ``safety_fraction`` keeps that share of the headroom
        free."""
        if isinstance(what, (int, float)):
            required = int(what)
        elif isinstance(what, dict):
            required = int(what.get("shard_resident_bytes",
                                    what.get("resident_bytes", 0)))
        else:
            required = int(index_memory_model(what)["shard_resident_bytes"])
        headroom = self.headroom_bytes()
        if headroom is None:
            return {"fits": True, "unknown": True,
                    "required_bytes": required, "headroom_bytes": None}
        return {"fits": required <= headroom * (1.0 - safety_fraction),
                "unknown": False, "required_bytes": required,
                "headroom_bytes": float(headroom)}

    def admit(self, nbytes: int, what: str) -> None:
        """Raise :class:`CapacityExceeded` when ``nbytes`` exceeds the
        known headroom; counts every decision (``memory.gate.*``)."""
        verdict = self.fits(nbytes)
        if not verdict["fits"]:
            tracing.inc_counter(GATE_REFUSED)
            raise CapacityExceeded(what, nbytes, verdict["headroom_bytes"])
        tracing.inc_counter(GATE_ADMITTED)

    def reserve(self, what: str, nbytes: int) -> None:
        """Set the named hold ``what`` to ``nbytes``: bytes a background
        channel has claimed, which every later headroom read subtracts.
        Growing a hold passes the gate (the prior hold is kept on a
        refusal); shrinking, to 0 included, always passes."""
        nbytes = int(nbytes)
        expect(nbytes >= 0, "a reservation cannot hold negative bytes")
        with self._lock:
            prev = int(self._reservations.pop(what, 0))
            if nbytes <= prev:
                if nbytes > 0:
                    self._reservations[what] = nbytes
                return
        # growth is judged against the headroom without the prior hold
        verdict = self.fits(nbytes)
        if not verdict["fits"]:
            with self._lock:
                if prev > 0:
                    self._reservations[what] = prev
            tracing.inc_counter(GATE_REFUSED)
            raise CapacityExceeded(what, nbytes, verdict["headroom_bytes"])
        tracing.inc_counter(GATE_ADMITTED)
        with self._lock:
            self._reservations[what] = nbytes

    def release(self, what: str) -> None:
        """Drop the named hold (idempotent)."""
        with self._lock:
            self._reservations.pop(what, None)

    def reserved_bytes(self) -> float:
        """Total bytes across all named holds."""
        with self._lock:
            return float(sum(self._reservations.values()))

    # -- the dispatch watermark ---------------------------------------------

    def sample_dispatch(self) -> None:
        """One watermark sample, which the executor takes after each
        dispatch: a host read of PyTorch's allocator statistics
        (``torch.cuda.memory_stats``: the bytes this process has
        allocated on each card), never a device sync and never
        ``cudaMemGetInfo``. Without a card it is the ``memory.samples``
        counter alone."""
        tracing.inc_counter(SAMPLES)
        if self._live_supported is None:
            self._live_supported = torch.cuda.is_available()
        if not self._live_supported:
            return
        in_use = float(sum(
            torch.cuda.memory_stats(d).get("allocated_bytes.all.current", 0)
            for d in range(torch.cuda.device_count())))
        with self._lock:
            self._wm_in_use = max(self._wm_in_use, in_use)

    # -- the scrape surface -------------------------------------------------

    def snapshot(self) -> dict:
        """The ``/memory.json`` body: model, live truth, forecast,
        headroom, divergence (live in-use bytes less the modeled ones) and
        watermarks, each input read once."""
        models = self.resident()
        live = self.live()
        fc = self.forecast(models)
        headroom = self._headroom_from(live, fc)
        divergence = None
        if live["supported"] and live["devices"]:
            in_use = sum(d["in_use_bytes"] for d in live["devices"].values())
            modeled = (fc["resident_bytes"] + fc["donated_state_bytes"]
                       + fc["probe_plane_bytes"])
            divergence = float(in_use - modeled)
        with self._lock:
            self._wm_forecast = max(self._wm_forecast, fc["peak_bytes"])
            wm_in_use, wm_forecast = self._wm_in_use, self._wm_forecast
        host_total = sum(m.get("host_resident_bytes", 0)
                         for m in models.values())
        return {
            "supported": live["supported"],
            "devices": live["devices"],
            "indexes": models,
            "resident_total_bytes": fc["resident_bytes"],
            "host_resident_total_bytes": float(host_total),
            "forecast": fc,
            "reserved_held_bytes": self.reserved_bytes(),
            "headroom_bytes": headroom,
            "divergence_bytes": divergence,
            "watermark": {"in_use_peak_bytes": wm_in_use,
                          "forecast_peak_bytes": wm_forecast},
            "capacity_bytes": self.capacity_bytes,
        }

    def publish(self) -> dict:
        """Publish the ``memory.*`` gauges from one :meth:`snapshot` and
        return it; stale per-index and per-device gauges retire first."""
        snap = self.snapshot()
        tracing.reset_gauges("memory.index.")
        tracing.reset_gauges("memory.device.")
        fc = snap["forecast"]
        vals: Dict[str, float] = {
            "memory.live.supported": 1.0 if snap["supported"] else 0.0,
            "memory.resident.total_bytes": snap["resident_total_bytes"],
            "memory.host.resident_bytes": snap["host_resident_total_bytes"],
            "memory.reserved.donated_state_bytes":
                fc["donated_state_bytes"],
            "memory.reserved.probe_planes_bytes": fc["probe_plane_bytes"],
            "memory.reserved.max_temp_bytes": fc["max_temp_bytes"],
            "memory.reserved.held_bytes": snap["reserved_held_bytes"],
            "memory.forecast.peak_bytes": fc["peak_bytes"],
            "memory.hbm.headroom_bytes":
                -1.0 if snap["headroom_bytes"] is None
                else float(snap["headroom_bytes"]),
            "memory.watermark.in_use_peak_bytes":
                snap["watermark"]["in_use_peak_bytes"],
            "memory.watermark.forecast_peak_bytes":
                snap["watermark"]["forecast_peak_bytes"],
        }
        if snap["divergence_bytes"] is not None:
            vals["memory.divergence_bytes"] = snap["divergence_bytes"]
        for label, model in snap["indexes"].items():
            base = f"memory.index.{label}."
            vals[base + "resident_bytes"] = float(model["resident_bytes"])
            vals[base + "shard_bytes"] = float(
                model["shard_resident_bytes"])
            if model.get("host_resident_bytes"):
                vals[base + "host_bytes"] = float(
                    model["host_resident_bytes"])
        for o, d in snap["devices"].items():
            base = f"memory.device.{o}."
            vals[base + "in_use_bytes"] = d["in_use_bytes"]
            vals[base + "peak_bytes"] = d["peak_bytes"]
            vals[base + "limit_bytes"] = d["limit_bytes"]
        tracing.set_gauges(vals)
        self.last_snapshot = snap
        return snap

    def federation_payload(self) -> dict:
        """The fleet-merge inputs (the ``memory`` block of
        ``/snapshot.json``): per-index resident bytes (summed fleet-side),
        headroom (the fleet takes the least; null without live stats),
        device truth per replica. Reuses the snapshot :meth:`publish`
        made last, else takes one."""
        snap = (self.last_snapshot if self.last_snapshot is not None
                else self.snapshot())
        return {
            "supported": snap["supported"],
            "resident": {label: int(m["resident_bytes"])
                         for label, m in snap["indexes"].items()},
            "resident_total_bytes": int(snap["resident_total_bytes"]),
            "host_resident_total_bytes":
                int(snap["host_resident_total_bytes"]),
            "forecast_peak_bytes": snap["forecast"]["peak_bytes"],
            "headroom_bytes": snap["headroom_bytes"],
            "divergence_bytes": snap["divergence_bytes"],
            "devices": snap["devices"],
        }


# ---------------------------------------------------------------------------
# /memory_profile diffing: per-allocation-group divergence attribution
# ---------------------------------------------------------------------------

# the frames of the allocator and of the framework itself, which name no
# caller: the first frame outside them is the allocation's site
_FRAMEWORK_FRAMES = ("/torch/", "\\torch\\", "<frozen",
                     "/raft_tpu_torch/core/")


def _site(frames) -> str:
    """The first recorded Python frame outside the framework, as
    ``name@file:line`` (``(none)`` when the snapshot recorded none)."""
    for f in frames or ():
        fname = str(f.get("filename", ""))
        if (not fname.endswith(".py")
                or any(m in fname for m in _FRAMEWORK_FRAMES)):
            continue
        return f"{f.get('name', '')}@{fname.rsplit('/', 1)[-1]}:" \
               f"{f.get('line', 0)}"
    return "(none)"


def parse_memory_profile(snapshot) -> Dict[str, int]:
    """One ``torch.cuda.memory._snapshot()`` (a dict, or its pickle)
    reduced into ``{label_key: bytes}`` of the allocated blocks
    (``memwatch.py:749``): ``label_key`` is
    ``device=<d>,segment=<large|small>,site=<name@file:line>``, the site
    being the first frame outside the framework that
    ``torch.cuda.memory._record_memory_history`` recorded
    (``site=(none)`` without history). Cached but unallocated bytes are
    not counted: the groups say what holds memory, as the JAX package's
    live-buffer groups do."""
    if isinstance(snapshot, (bytes, bytearray)):
        import pickle

        snapshot = pickle.loads(snapshot)
    out: Dict[str, int] = {}
    for seg in snapshot.get("segments", ()):
        dev = seg.get("device", 0)
        kind = seg.get("segment_type", "")
        for blk in seg.get("blocks", ()):
            if blk.get("state") != "active_allocated":
                continue
            key = f"device={dev},segment={kind},site={_site(blk.get('frames'))}"
            out[key] = out.get(key, 0) + int(blk.get("size", 0))
    return out


def diff_memory_profiles(before: Dict[str, int],
                         after: Dict[str, int]) -> dict:
    """Per-group divergence between two parsed snapshots
    (``memwatch.py:832``): ``deltas`` (largest |delta| first, ties by
    label) and the totals before, after and between."""
    keys = sorted(set(before) | set(after))
    deltas = []
    for key in keys:
        b = int(before.get(key, 0))
        a = int(after.get(key, 0))
        if a != b:
            deltas.append({"label": key, "from_bytes": b,
                           "to_bytes": a, "delta_bytes": a - b})
    deltas.sort(key=lambda d: (-abs(d["delta_bytes"]), d["label"]))
    return {
        "deltas": deltas,
        "total_before_bytes": int(sum(before.values())),
        "total_after_bytes": int(sum(after.values())),
        "total_delta_bytes": int(sum(after.values())
                                 - sum(before.values())),
    }


_GATE: Optional[MemoryLedger] = None  # guarded-by: _GATE_LOCK
_GATE_LOCK = threading.Lock()


def install_gate(ledger: MemoryLedger) -> None:
    """Arm the process-wide capacity gate: :func:`admit` then refuses
    allocations that do not fit ``ledger``'s headroom."""
    global _GATE
    with _GATE_LOCK:
        _GATE = ledger


def remove_gate() -> None:
    """Disarm the gate."""
    global _GATE
    with _GATE_LOCK:
        _GATE = None


def gate() -> Optional[MemoryLedger]:
    """The armed ledger, or None."""
    with _GATE_LOCK:
        return _GATE


def admit(nbytes: int, what: str) -> None:
    """The build paths' gate check: a no-op unless a gate is installed,
    else :meth:`MemoryLedger.admit`."""
    g = gate()
    if g is not None:
        g.admit(int(nbytes), what)
