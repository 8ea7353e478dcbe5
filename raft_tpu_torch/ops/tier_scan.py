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
  ``tiered_list_major_scan``). It is the all-device scan kernel's block
  body (``csrc/ivf_scan_body.cuh``) with each list's row pointer taken
  from its tier: hot rows from device memory, cold rows read in place
  from pinned host memory over the host link, so the link carries only
  the probed cold lists. On the H100 the cold bytes over PCIe bound it
  (PERF.md).
- ``torch``: the plain version, the twin of the JAX package's
  ``_tier_scan_xla`` (``tier_scan.py:262-310``): the op order of the
  port's ``_scan_torch``, each list's block taken from its tier by
  :func:`tier_block_select` (a probed cold block is copied to the
  queries' device, and only that block). It is what CPU tensors run.

``tiered_list_major_scan.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors.filters import test_filter
from raft_tpu_torch.ops.ivf_scan import (
    _QUERY_GROUP,
    CUDA_MAX_K,
    _launch_glue,
    _merge_smallest_id,
    unique_lists,
)

TIER_ENGINES = ("auto", "cuda", "torch")


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


def tiered_list_major_scan(qf, hot_data, cold_data, hot_slot_map,
                           cold_slot_map, data_norms, indices, probes,
                           filter_words=None, *, k: int,
                           metric: DistanceType, engine: str = "torch"):
    """Run the probe scan over a tiered index; returns the pre-epilog
    top-k ``(best_d, best_i)``, (q, k) float32 and int32, in the
    ``list_major_scan`` convention (min-space ``norms - 2 x.y`` for L2
    with +inf pads, raw inner products for IP with -inf pads, ties to the
    smallest id, sentinel probe slots inert). ``engine`` is resolved
    (``cuda`` or ``torch``); a hot tier on the CPU always takes the plain
    engine."""
    expect(engine in ("cuda", "torch"),
           f"tiered_list_major_scan engine must be cuda|torch, got "
           f"{engine!r}")
    args = (qf, hot_data, cold_data, hot_slot_map, cold_slot_map,
            data_norms, indices, probes, filter_words)
    if engine == "torch" or hot_data.device.type == "cpu":
        return _tier_scan_torch(*args, k=k, metric=metric)
    return _tier_scan_cuda(*args, k=k, metric=metric)


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


def _tier_scan_cuda(qf, hot_data, cold_data, hot_slot_map, cold_slot_map,
                    data_norms, indices, probes, filter_words, *, k: int,
                    metric: DistanceType):
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
           "memory (torch.Tensor.pin_memory()); the kernel reads it in "
           "place and never copies a pageable plane")
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
    (qf, uniq, offs, pair_q, pair_slot, ids_g, pd, pi, outd,
     outi) = _launch_glue(qf, indices, probes, filter_words, k)
    hot_map = hot_slot_map.to(torch.int32).contiguous()
    cold_map = cold_slot_map.to(torch.int32).contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = launch(qf.data_ptr(), hot_data.data_ptr(),
                 cold_data.data_ptr() if cold_data.numel() else None,
                 hot_map.data_ptr(), cold_map.data_ptr(),
                 data_norms.data_ptr(), ids_g.data_ptr(), uniq.data_ptr(),
                 offs.data_ptr(), pair_q.data_ptr(), pair_slot.data_ptr(), q,
                 p, d, m, k, int(metric == DistanceType.InnerProduct),
                 uniq.shape[0], -(-q // _QUERY_GROUP), pd.data_ptr(),
                 pi.data_ptr(), outd.data_ptr(), outi.data_ptr(), stream)
    _build.check(err, "tiered_list_major_scan")
    tiered_list_major_scan.launches += 1
    return outd, outi


tiered_list_major_scan.launches = 0
