"""Tiered (hot/cold) list-major IVF probe scan — the port of
``raft_tpu/ops/tier_scan.py``, the engines of
:mod:`raft_tpu_torch.neighbors.tiered`.

A tiered index splits the padded vector plane in two: ``hot_data
(n_hot, m, d)`` in device memory and ``cold_data (n_cold, m, d)`` in
pinned host memory, with ``hot_slot_map`` / ``cold_slot_map`` (n_lists,)
giving each list's slot in its tier (-1 in the other). The norm and id
planes (``data_norms``, ``indices``) stay resident for every list, so
membership masks and filters never touch the cold tier. The scan's
contract is :func:`raft_tpu_torch.ops.ivf_scan.list_major_scan`'s, and
its results equal the all-device scan's on the same lists bit for bit.

- ``cuda``: the hand-written kernel ``csrc/tier_scan.cu``, which replaces
  the JAX package's Pallas kernel ``_tier_scan_kernel`` with
  ``_cold_dma`` (reached through ``_tier_scan_pallas`` /
  ``tiered_list_major_scan``). The probed cold lists are staged through
  the copy engine: :func:`tier_stage_plan` packs their real rows into a
  device ring in waves (taking turns in its halves when the ring, sized
  from the workspace budget, is smaller than the probed cold set); one C
  call scans the hot lists, copies the waves on a side stream and scans
  each on another once its copies are done, with the all-device scan's
  block body (``csrc/ivf_scan_body.cuh``) and merge. Each probed cold
  list crosses the host link once per request; no kernel reads host
  memory. The bytes staged count into ``tier.cold_bytes_staged``
  (PERF.md).
- ``torch``: the plain version, the twin of the JAX package's
  ``_tier_scan_xla`` (``tier_scan.py:262-310``): the op order of the
  port's ``_scan_torch``, each list's block taken from its tier by
  :func:`tier_block_select` (a probed cold block is copied to the
  queries' device, and only that block). It is what CPU tensors run.

``tiered_list_major_scan.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors.filters import test_filter
from raft_tpu_torch.ops.ivf_scan import (
    CUDA_MAX_K,
    _launch_glue,
    _merge_smallest_id,
    unique_lists,
)

TIER_ENGINES = ("auto", "cuda", "torch")

#: the staging unit of a cold list, in rows: its live rows are copied
#: rounded up to it
STAGE_TILE = 64

#: waves a probed cold set that fits the ring is cut into, so that each
#: wave's scan overlaps the next wave's copies
PIPELINE_WAVES = 4


def resolve_tier_engine(engine: str, *, hot_data=None, filter_words=None,
                        k=None) -> str:
    """Resolve a tiered ``scan_engine`` param to ``cuda`` or ``torch``.

    ``auto`` is the kernel when the hot tier lies on a CUDA device and the
    plain engine otherwise. ``cuda`` goes to ``torch`` where the kernel
    does not apply, as the JAX package sends ``pallas`` to ``xla``:
    per-query (2-D) filter words, k past :data:`CUDA_MAX_K`, and storage
    other than float32 (the tiered path is float32-only). It decides
    before any launch, never after a failure."""
    expect(engine in TIER_ENGINES,
           f"tiered scan_engine must be one of {TIER_ENGINES}, got "
           f"{engine!r}")
    if engine == "auto":
        on_cuda = (hot_data.device.type == "cuda" if hot_data is not None
                   else torch.cuda.is_available())
        engine = "cuda" if on_cuda else "torch"
    if engine != "cuda":
        return engine
    if filter_words is not None and filter_words.ndim == 2:
        return "torch"
    if k is not None and k > CUDA_MAX_K:
        return "torch"
    if hot_data is not None and hot_data.dtype != torch.float32:
        return "torch"
    return engine


def resolve_tier_pq_engine(engine: str, *, hot_codes=None, k=None) -> str:
    """Resolve a tiered IVF-PQ ``scan_engine`` to ``cuda`` or ``torch``,
    before any launch. The tiered engines are list-major: ``auto`` is the
    dual-source LUT scan kernel (``ops/ivf_pq_scan``) when the hot codes
    lie on a CUDA device and the plain engine otherwise; ``cuda`` and
    ``torch`` force one. ``cuda`` goes to ``torch`` only where the
    all-device resolver does too: k past the kernel's 512 (the kernel
    takes shared and per-query filters alike). ``rank`` is refused, as
    the JAX package refuses it: the rank-major scan gathers per (query,
    rank) and has no per-list fetch step to steer through the slot
    maps."""
    expect(engine in TIER_ENGINES,
           "tiered PQ scan_engine must be 'auto', 'cuda' or 'torch' — the "
           "rank-major scan has no per-list fetch step to steer through "
           f"the tier slot maps, got {engine!r}")
    on_cuda = hot_codes is not None and hot_codes.device.type == "cuda"
    if engine == "auto":
        engine = "cuda" if on_cuda else "torch"
    if engine != "cuda":
        return engine
    expect(hot_codes is None or on_cuda,
           "tiered PQ scan_engine='cuda' needs the hot codes on a CUDA "
           "device")
    from raft_tpu_torch.ops.ivf_pq_scan import CUDA_MAX_K as PQ_MAX_K

    if k is not None and k > PQ_MAX_K:
        return "torch"
    return engine


def resolve_tier_bq_engine(engine: str) -> str:
    """Resolve a tiered IVF-BQ ``scan_engine``: ``auto``, ``cuda`` and
    ``torch`` all resolve to the plain fused engine ``torch``, decided
    here before any launch, never after a failure. The JAX package sends
    ``auto``/``pallas`` to ``xla`` the same way: it has no dual-source
    fused BQ kernel, and neither has the port (the card's ``bq_scan``
    reads every list from one device plane; a dual-source variant is
    later work, ROADMAP Queue 2). ``rank`` is refused: the estimate-only
    scan has no per-list fetch step."""
    expect(engine in TIER_ENGINES,
           "tiered BQ scan_engine must be 'auto', 'cuda' or 'torch', got "
           f"{engine!r}")
    return "torch"


def tier_slot_pair(hot_slot_map, cold_slot_map, lidc):
    """One list's (hot_slot, cold_slot) pair: read once per list and
    shared by every plane's :func:`tier_block_select`, so two planes of
    one list cannot come from different tiers. The maps may be tensors
    or host lists."""
    return hot_slot_map[lidc], cold_slot_map[lidc]


def tier_block_select(hot_plane, cold_plane, hs, cs):
    """A list's block from its tier: the cold block ``cs`` when ``cs >=
    0``, else the hot block ``hs``, on the hot plane's device. Only the
    selected tier's block is read, and only it crosses the host link."""
    if cs >= 0:
        return cold_plane[cs].to(hot_plane.device, non_blocking=True)
    return hot_plane[hs]


def tier_fetch_plan(uniq: torch.Tensor, hot_slot_map: torch.Tensor,
                    cold_slot_map: torch.Tensor, n_lists: int):
    """The per-step dual-tier fetch plan of the probed-list union ``uniq``
    (the JAX package's ``tier_fetch_plan``). Returns ``(hot_fetch,
    cold_fetch, cold_seq)``, each (n_steps,) int32:

    - ``hot_fetch[j]``: the hot slot of step j; on cold and sentinel steps
      the most recent hot slot (leading steps 0);
    - ``cold_fetch[j]``: the cold slot of step j, -1 on hot and sentinel
      steps;
    - ``cold_seq[j]``: the number of cold steps before step j.
    """
    uniq = uniq.to(torch.int64)
    lidc = uniq.clamp(max=n_lists - 1)
    live = uniq < n_lists
    neg = torch.full_like(uniq, -1)
    hot_raw = torch.where(live, hot_slot_map.to(torch.int64)[lidc], neg)
    cold_raw = torch.where(live, cold_slot_map.to(torch.int64)[lidc], neg)
    # carry the last hot slot forward: the position of the latest hot
    # step at or before j
    pos = torch.arange(uniq.shape[0], device=uniq.device)
    last = torch.cummax(torch.where(hot_raw >= 0, pos, neg), 0).values
    carried = torch.where(last >= 0, hot_raw[last.clamp(min=0)], neg)
    is_cold = (cold_raw >= 0).to(torch.int64)
    cold_seq = torch.cumsum(is_cold, 0) - is_cold
    return (carried.clamp(min=0).to(torch.int32), cold_raw.to(torch.int32),
            cold_seq.to(torch.int32))


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """Where a request's probed cold lists go in the device ring, longest
    first (:func:`tier_stage_plan`). Per staged list: ``steps`` its
    position in the union, ``slots`` its cold slot, ``rows`` the rows
    copied and ``offsets`` its ring row offset; ``wave_end[w]`` is the end
    of wave w in those arrays, and the ring holds ``ring_rows`` rows."""

    steps: np.ndarray        # (n,) int64
    slots: np.ndarray        # (n,) int32
    rows: np.ndarray         # (n,) int32
    offsets: np.ndarray      # (n,) int64
    wave_end: np.ndarray     # (n_waves,) int32
    ring_rows: int
    reuse: bool              # do waves take turns in two halves?
    row_bytes: int = 0       # bytes of one staged row (0: not given)

    @property
    def n_waves(self) -> int:
        return len(self.wave_end)

    @property
    def staged_bytes(self) -> int:
        """Bytes the plan copies over the host link."""
        return int(self.rows.sum()) * self.row_bytes


def tier_stage_plan(cold_fetch, step_rows, m: int, capacity: int, *,
                    row_bytes: Optional[int] = None) -> StagePlan:
    """The staging plan of one request (host side), for any tiered plane:
    the flat family's float32 rows of width d, the PQ codes' ``pq_dim``
    (or nibble-packed ``pq_dim / 2``) bytes. ``cold_fetch`` is the
    per-step cold slot (-1 on hot and sentinel steps), as
    :func:`tier_fetch_plan` gives it for the probed-list union, or one
    entry a list; ``step_rows`` each step's rows up to its last live one
    (:func:`~raft_tpu_torch.ops.ivf_scan.live_rows`). A cold list stages
    those rows rounded up to :data:`STAGE_TILE`, never past ``m``; the
    scans read a list only up to its last live row. ``capacity`` is the
    ring's budget: in rows, or in bytes when ``row_bytes`` (the plane's
    bytes a row) is given.

    The lists fill waves greedily, longest first (ties in union order):
    the last wave, whose scan nothing overlaps, gets the shortest. When they fit in
    ``capacity_rows`` the ring holds them all, one after the other, in
    waves of about a :data:`PIPELINE_WAVES`-th of them (each wave's scan
    overlaps the next one's copies); otherwise the ring is two halves of
    ``max(capacity_rows // 2, largest list)`` rows (at least two lists,
    the TPU kernel's double buffer), a wave fills a half, and wave w
    reuses half ``w % 2`` (``reuse``)."""
    capacity_rows = (int(capacity) if row_bytes is None
                     else int(capacity) // max(int(row_bytes), 1))
    cold_fetch = np.asarray(cold_fetch, np.int64)
    steps = np.nonzero(cold_fetch >= 0)[0]
    live = np.asarray(step_rows, np.int64)[steps]
    rows = np.minimum(-(-live // STAGE_TILE) * STAGE_TILE, m)
    longest = np.argsort(-rows, kind="stable")
    steps, rows = steps[longest], rows[longest]
    total = int(rows.sum())
    n = len(steps)
    reuse = n > 0 and total > capacity_rows
    biggest = int(rows.max()) if n else 0
    if reuse:
        wave_rows = max(int(capacity_rows) // 2, biggest)
    else:
        wave_rows = max(-(-total // PIPELINE_WAVES), biggest)
    offsets = np.zeros(n, np.int64)
    wave_end, used, start = [], 0, 0
    for i, r in enumerate(rows.tolist()):
        if used + r > wave_rows:
            wave_end.append(i)
            start = (len(wave_end) % 2) * wave_rows if reuse \
                else start + used
            used = 0
        offsets[i] = start + used
        used += r
    if n:
        wave_end.append(n)
    ring_rows = wave_rows * min(len(wave_end), 2) if reuse else total
    return StagePlan(steps=steps.astype(np.int64),
                     slots=cold_fetch[steps].astype(np.int32),
                     rows=rows.astype(np.int32), offsets=offsets,
                     wave_end=np.asarray(wave_end, np.int32),
                     ring_rows=int(ring_rows), reuse=bool(reuse),
                     row_bytes=int(row_bytes or 0))


def count_staging(plan: StagePlan) -> None:
    """Count one request's staging: ``tier.cold_bytes_staged``,
    ``tier.cold_lists_staged`` and ``tier.stage_waves``."""
    tracing.inc_counters({
        "tier.cold_bytes_staged": float(plan.staged_bytes),
        "tier.cold_lists_staged": float(len(plan.steps)),
        "tier.stage_waves": float(plan.n_waves),
    })


def tiered_list_major_scan(qf, hot_data, cold_data, hot_slot_map,
                           cold_slot_map, data_norms, indices, probes,
                           filter_words=None, *, k: int,
                           metric: DistanceType, engine: str = "torch",
                           workspace_bytes: Optional[int] = None):
    """Run the probe scan over a tiered index; returns the pre-epilog
    top-k ``(best_d, best_i)``, (q, k) float32 and int32, in the
    ``list_major_scan`` convention (min-space ``norms - 2 x.y`` for L2
    with +inf pads, raw inner products for IP with -inf pads, ties to the
    smallest id, sentinel probe slots inert). ``engine`` is resolved
    (``cuda`` or ``torch``); a hot tier on the CPU always takes the plain
    engine. ``workspace_bytes`` (the caller's
    ``Resources.workspace_limit_bytes``, that attribute's default when
    None) sizes the kernel's staging ring."""
    expect(engine in ("cuda", "torch"),
           f"tiered_list_major_scan engine must be cuda|torch, got "
           f"{engine!r}")
    args = (qf, hot_data, cold_data, hot_slot_map, cold_slot_map,
            data_norms, indices, probes, filter_words)
    if engine == "torch" or hot_data.device.type == "cpu":
        return _tier_scan_torch(*args, k=k, metric=metric)
    return _tier_scan_cuda(*args, k=k, metric=metric,
                           workspace_bytes=workspace_bytes)


# ---------------------------------------------------------------------------
# plain engine
# ---------------------------------------------------------------------------


def _tier_scan_torch(qf, hot_data, cold_data, hot_slot_map, cold_slot_map,
                     data_norms, indices, probes, filter_words, *, k: int,
                     metric: DistanceType):
    q = qf.shape[0]
    n_lists = indices.shape[0]
    ip_metric = metric == DistanceType.InnerProduct
    qf = qf.to(torch.float32)
    best_d = qf.new_full((q, k), float("inf"))
    best_i = torch.full((q, k), -1, dtype=torch.int32, device=qf.device)
    hot_map, cold_map = hot_slot_map.tolist(), cold_slot_map.tolist()
    for lid in unique_lists(probes, n_lists).tolist():
        if lid >= n_lists:
            continue
        hs, cs = tier_slot_pair(hot_map, cold_map, lid)
        # the one divergence from _scan_torch: the block comes from its tier
        rows = tier_block_select(hot_data, cold_data, hs, cs)
        ip = qf @ rows.to(torch.float32).T                       # (q, m)
        dist = -ip if ip_metric else data_norms[lid][None, :] - 2.0 * ip
        ids_b = indices[lid][None, :].expand(q, -1)
        probed = (probes == lid).any(dim=1)                      # (q,)
        ok = (ids_b >= 0) & probed[:, None]
        if filter_words is not None:
            ok = ok & test_filter(filter_words, ids_b)
        dist = torch.where(ok, dist, torch.full_like(dist, float("inf")))
        best_d, best_i = _merge_smallest_id(best_d, best_i, dist, ids_b, k)
    if ip_metric:
        best_d = -best_d          # inf (unfilled) -> -inf, ip exact
    return best_d, best_i


# ---------------------------------------------------------------------------
# CUDA engine
# ---------------------------------------------------------------------------


_side_streams = {}   # device index -> (copy, scan) streams  # guarded-by: _side_streams_lock
_side_streams_lock = threading.Lock()


def _side_stream_handles(dev: torch.device) -> list:
    """The raw handles of ``dev``'s two side streams: the staged copies'
    and the cold waves' scans'."""
    with _side_streams_lock:
        pair = _side_streams.get(dev.index)
        if pair is None:
            pair = _side_streams[dev.index] = tuple(
                torch.cuda.Stream(device=dev) for _ in range(2))
    return [st.cuda_stream for st in pair]


def _tier_scan_cuda(qf, hot_data, cold_data, hot_slot_map, cold_slot_map,
                    data_norms, indices, probes, filter_words, *, k: int,
                    metric: DistanceType,
                    workspace_bytes: Optional[int] = None):
    dev = hot_data.device
    q, d = qf.shape
    m = hot_data.shape[1]
    n_lists = indices.shape[0]
    p = probes.shape[1]
    expect(all(t.device == dev for t in (qf, hot_slot_map, cold_slot_map,
                                         data_norms, indices, probes)),
           "tiered_list_major_scan: all inputs but the cold tier must be on "
           "the hot tier's device")
    expect(hot_data.dtype == torch.float32
           and cold_data.dtype == torch.float32,
           "tiered_list_major_scan: the kernel takes float32 tiers only")
    expect(cold_data.numel() == 0 or (cold_data.device.type == "cpu"
                                      and cold_data.is_pinned()),
           "tiered_list_major_scan: the cold tier must be pinned host "
           "memory (torch.Tensor.pin_memory()); the kernel stages it with "
           "asynchronous copies, which a pageable plane would serialize")
    expect(hot_data.is_contiguous() and cold_data.is_contiguous()
           and data_norms.is_contiguous() and indices.is_contiguous(),
           "tiered_list_major_scan: tiers, norms and indices must be "
           "contiguous")
    expect(cold_data.shape[1:] == (m, d) and hot_data.shape[2] == d
           and data_norms.shape == (n_lists, m)
           and indices.shape == (n_lists, m)
           and hot_slot_map.shape == (n_lists,)
           and cold_slot_map.shape == (n_lists,),
           "tiered_list_major_scan: shape mismatch")
    expect(0 < k <= CUDA_MAX_K,
           f"tiered_list_major_scan: kernel takes 0 < k <= {CUDA_MAX_K}, "
           f"got {k}")
    expect(filter_words is None or filter_words.ndim == 1,
           "tiered_list_major_scan: kernel takes a shared (1-D) filter only")
    from raft_tpu_torch.ops import _build

    launch = _build.load("tier_scan")
    # seed bounds from hot lists only: their rows need no copy
    g = _launch_glue(qf, indices, probes, filter_words, k,
                     usable=cold_slot_map < 0)
    uniq = g["uniq"]
    cap = uniq.shape[0]
    # the request's one host sync: each union step's list, cold slot, live
    # rows (a filter folded in) and work items, for the staging plan and
    # the launches' grids
    live = uniq < n_lists
    lidc = uniq.clamp(max=n_lists - 1).to(torch.int64)
    cold_fetch = torch.where(live, cold_slot_map.to(torch.int32)[lidc],
                             torch.full_like(uniq, -1))
    uniq_h, cold_h, rows_h, items_h = torch.stack(
        [uniq.to(torch.int64), cold_fetch.to(torch.int64),
         g["live"].to(torch.int64), g["items"]]).cpu().numpy()
    if workspace_bytes is None:
        workspace_bytes = Resources.workspace_limit_bytes
    plan = tier_stage_plan(cold_h, rows_h, m, workspace_bytes,
                           row_bytes=4 * d)
    # the hot steps longest first, as the plan orders the cold ones
    hot_steps = np.nonzero((uniq_h < n_lists) & (cold_h < 0))[0]
    hot_steps = hot_steps[np.argsort(-rows_h[hot_steps], kind="stable")]
    n_hot = len(hot_steps)
    order = np.concatenate([hot_steps, plan.steps]).astype(np.int64)
    item_off = np.zeros(len(order) + 1, np.int64)
    item_off[1:] = np.cumsum(items_h[order])
    ring_off = np.full(cap, -1, np.int64)
    ring_off[plan.steps] = plan.offsets
    # one upload: the steps in launch order, their first items, then each
    # step's ring offset
    tables = torch.from_numpy(np.concatenate(
        [order, item_off, ring_off])).to(dev)
    n_steps = len(order)
    ring = (torch.empty((plan.ring_rows, d), dtype=torch.float32,
                        device=dev) if plan.ring_rows else None)
    wave_end = (plan.wave_end + n_hot).astype(np.int32)
    hot_map = hot_slot_map.to(torch.int32).contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = launch(g["qf"].data_ptr(), hot_data.data_ptr(),
                 cold_data.data_ptr() if cold_data.numel() else None,
                 hot_map.data_ptr(), data_norms.data_ptr(),
                 *(g[n].data_ptr() for n in (
                     "ids_g", "uniq", "offs", "pair_q", "pair_slot", "live",
                     "slot_off")),
                 tables.data_ptr(), tables[n_steps:].data_ptr(),
                 tables[2 * n_steps + 1:].data_ptr(),
                 None if ring is None else ring.data_ptr(),
                 *(g[n].data_ptr() for n in ("seed_step", "bound_d",
                                             "bound_i")), q, p, d, m, k,
                 int(metric == DistanceType.InnerProduct), n_hot,
                 plan.n_waves, int(plan.reuse), item_off.ctypes.data,
                 wave_end.ctypes.data, plan.slots.ctypes.data,
                 plan.offsets.ctypes.data, plan.rows.ctypes.data,
                 *(g[n].data_ptr() for n in ("pd", "pi", "outd", "outi")),
                 stream, *_side_stream_handles(dev))
    _build.check(err, "tiered_list_major_scan")
    tiered_list_major_scan.launches += 1
    count_staging(plan)
    return g["outd"], g["outi"]


tiered_list_major_scan.launches = 0
