"""Memory truth: what an index holds, where, and what still fits — the
port of ``raft_tpu/core/memwatch.py`` (its byte model, live device stats,
the ledger and the opt-in capacity gate).

- :func:`index_memory_model`: the bytes of every tensor field of an index
  dataclass, from shape x element size, split by :func:`memory_tier` into
  device-resident bytes and host-resident bytes (the tiered cold plane).
- :func:`device_memory_stats`: live per-device truth from
  ``torch.cuda.mem_get_info`` and ``torch.cuda.memory_stats``. Bytes that
  PyTorch's caching allocator has reserved but not handed out count as
  free: the allocator gives them to the next tensor without a new
  ``cudaMalloc``, so leaving them out would under-size the hot tier.
- :class:`MemoryLedger`: watched indexes, the resident forecast, headroom
  (live stats, else a configured ``capacity_bytes`` minus the forecast),
  the ``fits``/``admit`` verdicts and named byte holds.
- :func:`install_gate` / :func:`admit`: the opt-in process-wide gate that
  build paths consult; without a gate every admission passes.

Not ported yet: ``sample_dispatch``, ``publish``, ``snapshot``,
``federation_payload`` and the memory-profile parsing (they serve the
exporter, which is not ported), and the executor's reservations
(:meth:`raft_tpu_torch.core.executor.SearchExecutor.memory_reservations`)
in :meth:`MemoryLedger.forecast`.
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
        components[f.name] = {"bytes": b,
                              "shape": [int(s) for s in v.shape],
                              "dtype": str(v.dtype), "tier": tier}
        if tier == "host":
            host_total += b
            continue
        total += b
        o = _ordinal(v)
        per_device[o] = per_device.get(o, 0) + b
    return {
        "family": type(index).__name__,
        "components": components,
        "resident_bytes": total,
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
    forecast, headroom and capacity verdicts, and named byte holds.

    ``capacity_bytes`` is a per-device capacity for a process without
    live stats (the CPU tests, or an operator's budget below the card);
    live limits win where there are any."""

    def __init__(self, *, capacity_bytes: Optional[float] = None):
        self.capacity_bytes = capacity_bytes
        self._lock = threading.Lock()
        # label -> weakref(index): an index dropped by its owner is not
        # kept alive by its accounting
        self._watched: "dict[str, weakref.ref]" = {}  # guarded-by: _lock
        self._reservations: Dict[str, int] = {}       # guarded-by: _lock

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

    def resident(self) -> dict:
        """``{label: index_memory_model(index)}`` for every watched index
        still alive."""
        with self._lock:
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

    def live(self) -> dict:
        """:func:`device_memory_stats` of every visible CUDA device."""
        return device_memory_stats()

    def forecast(self, models: Optional[dict] = None) -> dict:
        """Watched resident bytes folded per device; ``peak_bytes`` is
        the worst device's."""
        if models is None:
            models = self.resident()
        per_device: Dict[int, float] = {}
        resident_total = 0
        for model in models.values():
            resident_total += model["resident_bytes"]
            for o, b in model["per_device_bytes"].items():
                per_device[o] = per_device.get(o, 0.0) + b
        return {
            "resident_bytes": float(resident_total),
            "per_device_bytes": {int(o): float(b)
                                 for o, b in per_device.items()},
            "peak_bytes": float(max(per_device.values(), default=0.0)),
        }

    def headroom_bytes(self) -> Optional[float]:
        """Remaining per-device headroom: the least ``limit − in_use``
        over the live devices; without live stats ``capacity_bytes −
        forecast peak`` when a capacity was set; ``None`` when unknowable.
        Named holds (:meth:`reserve`) are subtracted last."""
        stats = self.live()
        base: Optional[float] = None
        if stats["supported"] and stats["devices"]:
            rooms = [d["limit_bytes"] - d["in_use_bytes"]
                     for d in stats["devices"].values()
                     if d["limit_bytes"] > 0]
            if rooms:
                base = float(min(rooms))
        if base is None and self.capacity_bytes is not None:
            base = float(self.capacity_bytes
                         - self.forecast()["peak_bytes"])
        if base is None:
            return None
        return base - self.reserved_bytes()

    def fits(self, what, *, safety_fraction: float = 0.0) -> dict:
        """Would ``what`` (a byte count, a model dict or an index) fit?
        ``{"fits", "unknown", "required_bytes", "headroom_bytes"}``;
        ``unknown: True`` (and ``fits: True``) when there is no headroom
        source. ``safety_fraction`` keeps that share of the headroom
        free."""
        if isinstance(what, (int, float)):
            required = int(what)
        elif isinstance(what, dict):
            required = int(what.get("resident_bytes", 0))
        else:
            required = int(index_memory_model(what)["resident_bytes"])
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
