"""Tiered IVF-Flat storage — the flat family of
``raft_tpu/neighbors/tiered.py``: an index whose corpus need not fit in
device memory.

:class:`TieredIvf` splits an :class:`~raft_tpu_torch.neighbors.ivf_flat
.IvfFlatIndex`'s padded vector plane by list into a **hot tier** in device
memory (a fixed slot count, sized by :func:`resolve_hot_slots` against
the memory ledger's headroom or a fraction of the lists) and a **cold
tier** in pinned host memory (:func:`host_put`). Centers, norms, ids,
slot maps and list sizes stay resident in device memory, so coarse
selection, membership masks and filters are the all-device index's, and
:func:`search` returns the all-device ``ivf_flat.search``'s results bit
for bit. On the card the probe scan is the staged dual-source kernel
(:mod:`raft_tpu_torch.ops.tier_scan`): each request copies its probed
cold lists once over the host link into a device ring sized from
``Resources.workspace_limit_bytes``, and scores them there.

A placement epoch (:mod:`raft_tpu_torch.serving.placement`) only permutes
which lists occupy the fixed hot slots: :func:`apply_plan` swaps blocks
between the tiers, updating the hot plane and the cold plane **in place**
(``index_copy_`` and per-block copies on the current stream; the JAX
package donates its buffers for the same effect), replaces the slot maps
and bumps ``generation`` under the container's swap lock. The container
is mutable for that reason, unlike the frozen index dataclasses.

The executor (:mod:`raft_tpu_torch.core.executor`) and :func:`search`
both run :func:`_tiered_search_fn` as :func:`serving_plan` sets it up,
one placement generation a dispatch, and its ragged plans
:func:`_tiered_search_ragged_fn`, the same body with a per-row probe
budget; the executor runs both eagerly on the card (the staging plan is
read on the host). Not ported yet: the PQ and BQ tiered families and the
executor hook of ``apply_plan`` (they wait for IVF-PQ).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core import memwatch, tracing
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors import ivf_flat
from raft_tpu_torch.neighbors._batching import tile_queries
from raft_tpu_torch.neighbors.ann_types import SearchParams
from raft_tpu_torch.neighbors.filters import resolve_filter_words
from raft_tpu_torch.neighbors.ivf_flat import (
    IvfFlatIndex,
    coarse_probes,
    metric_epilog,
)
from raft_tpu_torch.ops.ivf_scan import probe_histogram, ragged_probes
from raft_tpu_torch.ops.tier_scan import (
    resolve_tier_engine,
    tiered_list_major_scan,
)


@dataclasses.dataclass(frozen=True)
class TieredSearchParams(SearchParams):
    """Search params of the tiered index. ``scan_engine``: ``"auto"`` is
    the dual-source kernel for a tiered index on a CUDA device and the
    plain engine otherwise; ``"cuda"`` goes to ``"torch"`` where the
    kernel does not apply (``resolve_tier_engine``)."""

    n_probes: int = 20
    coarse_algo: str = "exact"   # "exact" | "approx"
    scan_engine: str = "auto"    # "auto" | "cuda" | "torch"


class _TieredPlanes:
    """Geometry, byte accounting, generation snapshot and layout shared by
    the tiered containers, which declare their (hot, cold) plane names in
    ``_PLANE_PAIRS``."""

    _PLANE_PAIRS = ()          # ((hot_name, cold_name), ...)

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def max_list_size(self) -> int:
        return getattr(self, self._PLANE_PAIRS[0][0]).shape[1]

    @property
    def n_hot(self) -> int:
        return getattr(self, self._PLANE_PAIRS[0][0]).shape[0]

    @property
    def n_cold(self) -> int:
        return getattr(self, self._PLANE_PAIRS[0][1]).shape[0]

    @property
    def block_bytes(self) -> int:
        """Bytes of one list's tiered planes: what a swap moves twice (one
        promotion, one demotion)."""
        total = 0
        for hot_name, _ in self._PLANE_PAIRS:
            a = getattr(self, hot_name)
            total += int(np.prod(a.shape[1:])) * a.element_size()
        return total

    @property
    def hot_bytes(self) -> int:
        return self.n_hot * self.block_bytes

    @property
    def cold_bytes(self) -> int:
        return self.n_cold * self.block_bytes

    def tier_planes(self) -> tuple:
        """``(hot_planes, cold_planes, hot_slot_map, cold_slot_map,
        generation)`` of one placement generation, read under the swap
        lock."""
        with self._swap_lock:
            return (
                tuple(getattr(self, h) for h, _ in self._PLANE_PAIRS),
                tuple(getattr(self, c) for _, c in self._PLANE_PAIRS),
                self.hot_slot_map, self.cold_slot_map, self.generation)

    def layout(self) -> dict:
        """Which lists are hot and which cold, and the byte split, read
        under the swap lock."""
        with self._swap_lock:
            return {
                "n_lists": self.n_lists,
                "n_hot": self.n_hot,
                "n_cold": self.n_cold,
                "hot_lists": [int(x) for x in self.hot_lists],
                "cold_lists": [int(x) for x in self.cold_lists],
                "hot_bytes": self.hot_bytes,
                "cold_bytes": self.cold_bytes,
                "block_bytes": self.block_bytes,
                "host_resident": self.host_resident,
                "generation": self.generation,
            }


@dataclasses.dataclass
class TieredIvf(_TieredPlanes):
    """Hot/cold tiered IVF-Flat container (mutable: placement epochs
    update it in place, at fixed shapes)."""

    centers: torch.Tensor        # (n_lists, d) f32, device
    center_norms: torch.Tensor   # (n_lists,) f32
    data_norms: torch.Tensor     # (n_lists, max_list_size) f32, every list
    indices: torch.Tensor        # (n_lists, max_list_size) int32, every list
    list_sizes: torch.Tensor     # (n_lists,) int32
    hot_data: torch.Tensor       # (n_hot, max_list_size, d) f32, device
    cold_data: torch.Tensor      # (n_cold, max_list_size, d) f32, pinned host
    hot_slot_map: torch.Tensor   # (n_lists,) int32, hot slot or -1  # guarded-by: _swap_lock
    cold_slot_map: torch.Tensor  # (n_lists,) int32, cold slot or -1  # guarded-by: _swap_lock
    hot_lists: np.ndarray        # (n_hot,) list in each hot slot  # guarded-by: _swap_lock
    cold_lists: np.ndarray       # (n_cold,) list in each cold slot  # guarded-by: _swap_lock
    metric: DistanceType
    host_resident: bool          # is the cold tier in pinned host memory?
    generation: int = 0          # apply_plan bumps it  # guarded-by: _swap_lock
    # serializes placement writes against searches. Re-entrant: a search
    # holds it from its snapshot (tier_arrays) through its staged copies
    # and launches, because apply_plan updates the tiers in place, so a
    # search must not copy or launch against a generation other than the
    # one it read. The scan joins its copy stream back into the current
    # stream, so apply_plan's writes there are ordered after its copies.
    _swap_lock: threading.RLock = dataclasses.field(
        default_factory=threading.RLock, repr=False, compare=False)

    _PLANE_PAIRS = (("hot_data", "cold_data"),)

    def tier_arrays(self) -> tuple:
        """``(hot_data, cold_data, hot_slot_map, cold_slot_map)`` of one
        placement generation, read under the swap lock."""
        with self._swap_lock:
            return (self.hot_data, self.cold_data, self.hot_slot_map,
                    self.cold_slot_map)


def host_put(x: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """Commit ``x`` to pinned host memory; returns ``(tensor,
    host_resident)``. A CUDA tensor is copied into page-locked memory
    (``(x.cpu().pin_memory(), True)``), and a failure to pin raises: the
    cold tier is never left in the device memory it exists to vacate. A
    CPU tensor stays as it is, ``(x, False)``: a CPU index has one memory
    pool, as the JAX package's CPU backend does."""
    if x.device.type == "cpu":
        return x, False
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.copy_(x)
    return out, True


def resolve_hot_slots(index, *, hot_slots=None, hot_fraction: float = 0.5,
                      ledger=None, safety_fraction: float = 0.1,
                      block_bytes: Optional[int] = None) -> int:
    """The hot tier's fixed slot count: an explicit ``hot_slots``; else,
    with a :class:`~raft_tpu_torch.core.memwatch.MemoryLedger` whose
    headroom is known, the most blocks that fit ``headroom x (1 -
    safety_fraction)``; else ``hot_fraction`` of the lists. Always in [1,
    n_lists - 1]. ``block_bytes`` overrides the flat block
    (``max_list_size x dim x element size``)."""
    n_lists = index.n_lists
    block = block_bytes if block_bytes is not None else (
        index.max_list_size * index.dim * index.data.element_size())
    if hot_slots is None and ledger is not None:
        headroom = ledger.headroom_bytes()
        if headroom is not None:
            usable = max(float(headroom) * (1.0 - safety_fraction), 0.0)
            hot_slots = int(usable // max(block, 1))
    if hot_slots is None:
        hot_slots = int(n_lists * hot_fraction)
    return max(1, min(int(hot_slots), n_lists - 1))


def _slot_maps(hot_lists: np.ndarray, cold_lists: np.ndarray,
               n_lists: int):
    """The (hot_map, cold_map) int32 planes of one assignment: each
    list's slot in its tier, -1 in the other."""
    hot_map = np.full((n_lists,), -1, np.int32)
    cold_map = np.full((n_lists,), -1, np.int32)
    hot_map[hot_lists] = np.arange(len(hot_lists), dtype=np.int32)
    cold_map[cold_lists] = np.arange(len(cold_lists), dtype=np.int32)
    return hot_map, cold_map


def _split_lists(n_lists: int, h: int, probe_counts):
    """The initial split: the ``h`` lists with the most ``probe_counts``
    go hot (ties to the smaller list id), the rest cold; without counts
    lists 0..h-1 go hot. Both returned sorted."""
    if probe_counts is None:
        counts = np.zeros((n_lists,), np.int64)
    else:
        counts = np.asarray(probe_counts, np.int64)
        expect(counts.shape == (n_lists,),
               "probe_counts must be one count per list")
    order = np.argsort(-counts, kind="stable").astype(np.int32)
    return np.sort(order[:h]), np.sort(order[h:])


def _place(index: IvfFlatIndex, hot_lists, cold_lists) -> TieredIvf:
    """Split ``index``'s vector plane: the hot lists' blocks stay on the
    index's device, the cold lists' blocks go to pinned host memory (their
    device copy is freed once pinned)."""
    expect(index.data.dtype == torch.float32,
           "tiered storage supports f32 list data only")
    n_lists = index.n_lists
    hot_lists = np.asarray(hot_lists, np.int32)
    cold_lists = np.asarray(cold_lists, np.int32)
    expect(np.array_equal(np.sort(np.concatenate([hot_lists, cold_lists])),
                          np.arange(n_lists)),
           "every list must be in exactly one tier")
    dev = index.data.device
    block = index.max_list_size * index.dim * index.data.element_size()
    memwatch.admit(len(hot_lists) * block, "tiered.build_tiered")
    hot_data = index.data.index_select(
        0, torch.from_numpy(hot_lists.astype(np.int64)).to(dev))
    cold_data, host_resident = host_put(index.data.index_select(
        0, torch.from_numpy(cold_lists.astype(np.int64)).to(dev)))
    hot_map, cold_map = _slot_maps(hot_lists, cold_lists, n_lists)
    return TieredIvf(
        centers=index.centers,
        center_norms=index.center_norms,
        data_norms=index.data_norms,
        indices=index.indices,
        list_sizes=index.list_sizes,
        hot_data=hot_data,
        cold_data=cold_data,
        hot_slot_map=torch.from_numpy(hot_map).to(dev),
        cold_slot_map=torch.from_numpy(cold_map).to(dev),
        hot_lists=hot_lists,
        cold_lists=cold_lists,
        metric=index.metric,
        host_resident=host_resident,
    )


def build_tiered(index: IvfFlatIndex, *, hot_slots=None,
                 hot_fraction: float = 0.5, ledger=None,
                 safety_fraction: float = 0.1,
                 probe_counts=None) -> TieredIvf:
    """Split a built :class:`IvfFlatIndex` into the tiered layout.

    ``probe_counts`` (optional per-list traffic) decides the initial
    placement: the most-probed lists go hot (ties to the smaller list
    id); without counts lists 0..H-1 go hot and the first placement
    epoch corrects it. ``ledger`` sizes the hot tier from live headroom
    (:func:`resolve_hot_slots`). Float32 lists only."""
    expect(index.max_list_size > 0, "index is empty — extend() it first")
    h = resolve_hot_slots(index, hot_slots=hot_slots,
                          hot_fraction=hot_fraction, ledger=ledger,
                          safety_fraction=safety_fraction)
    hot_lists, cold_lists = _split_lists(index.n_lists, h, probe_counts)
    return _place(index, hot_lists, cold_lists)


def from_numpy(index_fields: dict, hot_lists, cold_lists,
               res: Optional[Resources] = None) -> TieredIvf:
    """A tiered index from host arrays with a given split: ``index_fields``
    are :func:`raft_tpu_torch.neighbors.ivf_flat.from_numpy`'s arguments
    (e.g. a JAX-built index's ``centers``, ``data``, ``indices``,
    ``list_sizes`` and ``metric``); ``hot_lists`` / ``cold_lists`` name
    the lists of each tier, in slot order."""
    return _place(ivf_flat.from_numpy(**index_fields, res=res), hot_lists,
                  cold_lists)


# ---------------------------------------------------------------------------
# placement execution
# ---------------------------------------------------------------------------


def _promote_blocks(cold_plane, cold_slots, device, staged=None,
                    hot_name: str = "hot_data"):
    """The promoted blocks, (n, ...) on ``device``: rows that ``staged``
    already holds in device memory (``staged.rows[i] >= 0``) come from
    its ``planes[hot_name]``, the rest are copied from the cold plane.
    Returns the blocks and the number of misses (blocks that crossed the
    host link now)."""
    n = len(cold_slots)
    out = torch.empty((n,) + tuple(cold_plane.shape[1:]),
                      dtype=cold_plane.dtype, device=device)
    rows = ([-1] * n if staged is None
            else [int(r) for r in np.asarray(staged.rows)[:n]])
    for i, (cs, r) in enumerate(zip(cold_slots, rows)):
        if r >= 0:
            out[i].copy_(staged.planes[hot_name][r])
        else:
            out[i].copy_(cold_plane[int(cs)], non_blocking=True)
    return out, sum(r < 0 for r in rows)


def apply_plan(tiered, promotions, demotions, width: int,
               staged=None) -> int:
    """Execute a placement plan in place: ``promotions[i]`` (a cold list)
    takes the hot slot ``demotions[i]`` (a hot list) frees, which takes
    the cold slot ``promotions[i]`` frees. Returns the bytes moved, 2 x
    block per pair, and counts ``tier.swaps``, ``tier.swap_bytes`` and
    ``tier.promote_cold_bytes``.

    ``width`` is the fixed swap width of the placement policy
    (``max_swaps_per_epoch``); a plan may not exceed it. The hot plane is
    updated in place with ``index_copy_`` and the cold plane block by
    block, on the current stream, after the demoted blocks were read out;
    the slot maps are replaced and ``generation`` bumps under the swap
    lock, and the call waits for the copies, so the cold tier's host
    bytes are final when it returns. ``staged`` optionally supplies
    promotion blocks already in device memory: ``rows`` (a staged row per
    promotion, -1 for a miss) and ``planes`` (hot plane name -> staged
    (K, ...) storage); only misses count into
    ``tier.promote_cold_bytes``."""
    n = len(promotions)
    expect(n == len(demotions), "promotions/demotions must pair up")
    expect(n <= width, f"plan has {n} swaps, width is {width}")
    if n == 0:
        return 0
    promo = np.asarray(promotions, np.int32)
    demo = np.asarray(demotions, np.int32)
    misses = 0
    with tiered._swap_lock:
        hot_map, cold_map = _slot_maps(tiered.hot_lists, tiered.cold_lists,
                                       tiered.n_lists)
        hot_slots = hot_map[demo]
        cold_slots = cold_map[promo]
        expect(bool((hot_slots >= 0).all()),
               "every demotion must name a currently-hot list")
        expect(bool((cold_slots >= 0).all()),
               "every promotion must name a currently-cold list")
        for hot_name, cold_name in type(tiered)._PLANE_PAIRS:
            hot = getattr(tiered, hot_name)
            cold = getattr(tiered, cold_name)
            hs = torch.from_numpy(hot_slots.astype(np.int64)).to(hot.device)
            demoted = hot.index_select(0, hs)    # before the slots change
            promoted, misses = _promote_blocks(cold, cold_slots, hot.device,
                                               staged, hot_name)
            hot.index_copy_(0, hs, promoted)
            for i, cs in enumerate(cold_slots.tolist()):
                cold[cs].copy_(demoted[i], non_blocking=True)
        hot_lists = tiered.hot_lists.copy()
        cold_lists = tiered.cold_lists.copy()
        hot_lists[hot_slots] = promo
        cold_lists[cold_slots] = demo
        new_hot, new_cold = _slot_maps(hot_lists, cold_lists, tiered.n_lists)
        dev = tiered.hot_slot_map.device
        tiered.hot_slot_map = torch.from_numpy(new_hot).to(dev)
        tiered.cold_slot_map = torch.from_numpy(new_cold).to(dev)
        tiered.hot_lists = hot_lists
        tiered.cold_lists = cold_lists
        tiered.generation += 1
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
    moved = 2 * n * tiered.block_bytes
    tracing.inc_counters({
        "tier.swaps": float(n),
        "tier.swap_bytes": float(moved),
        "tier.promote_cold_bytes": float(misses * tiered.block_bytes),
    })
    return moved


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


def _tiered_search_fn(queries, centers, center_norms, hot_data, cold_data,
                      hot_slot_map, cold_slot_map, data_norms, indices,
                      filter_words, probe_counts=None, n_valid=None,
                      row_probes=None, *, n_probes: int, k: int,
                      metric: DistanceType, coarse_algo: str,
                      scan_engine: str,
                      workspace_bytes: Optional[int] = None):
    """Coarse select + tiered probe scan + metric epilog — the serving
    body, over one placement generation's arrays in the order the
    executor's plan passes them (the caller holds the container's swap
    lock from its :meth:`TieredIvf.tier_arrays` snapshot through this
    call). The coarse stage and epilog are ``ivf_flat.search``'s; only
    the scan is the tiered one, so results equal the all-device index's
    bit for bit. With ``probe_counts`` the (n_lists,) traffic plane is
    returned too, with this batch's probes added (rows at and past
    ``n_valid`` left out). ``row_probes`` is the ragged front's per-row
    probe budget (:func:`_tiered_search_ragged_fn`): slots past a row's
    budget become the sentinel id, which the staging plan and the scan
    skip. ``scan_engine`` arrives resolved; ``workspace_bytes`` sizes the
    kernel's staging ring. The kernel's staging plan is read on the host,
    so the executor runs this body eagerly, never in a CUDA graph."""
    qf = queries.to(torch.float32)
    probes = coarse_probes(qf, centers, center_norms, metric, n_probes,
                           coarse_algo)
    if row_probes is not None:
        probes = ragged_probes(probes, row_probes, centers.shape[0])
        n_valid = None
    best_d, best_i = tiered_list_major_scan(
        qf, hot_data, cold_data, hot_slot_map, cold_slot_map, data_norms,
        indices, probes, filter_words, k=k, metric=metric,
        engine=scan_engine, workspace_bytes=workspace_bytes)
    best_d = metric_epilog(qf, best_d, metric)
    if probe_counts is not None:
        return best_d, best_i, probe_histogram(probes, probe_counts, n_valid)
    return best_d, best_i


def _tiered_search_ragged_fn(queries, row_probes, centers, center_norms,
                             hot_data, cold_data, hot_slot_map,
                             cold_slot_map, data_norms, indices,
                             filter_words, probe_counts=None, n_valid=None,
                             *, n_probes: int, k: int, metric: DistanceType,
                             scan_engine: str,
                             workspace_bytes: Optional[int] = None):
    """The ragged tiered serving body (the packing contract of
    :func:`raft_tpu_torch.neighbors.ivf_flat._search_ragged_fn`): a
    packed tile with each row's probe budget, over one placement
    generation's arrays. It is :func:`_tiered_search_fn` with the budget
    hook on, so each row equals its request's solo tiered search, and
    that the all-device index's. The executor's key holds shapes and
    statics only, so an epoch keeps hitting the same plan entry."""
    del n_valid
    expect(scan_engine in ("cuda", "torch"),
           f"ragged tiered serving needs a tier engine, got {scan_engine!r}")
    return _tiered_search_fn(
        queries, centers, center_norms, hot_data, cold_data, hot_slot_map,
        cold_slot_map, data_norms, indices, filter_words, probe_counts, None,
        row_probes, n_probes=n_probes, k=k, metric=metric,
        coarse_algo="exact", scan_engine=scan_engine,
        workspace_bytes=workspace_bytes)


def serving_plan(params: TieredSearchParams, tiered: TieredIvf, k: int,
                 filter_words=None, workspace_bytes: Optional[int] = None
                 ) -> Tuple[Callable, tuple, dict]:
    """``(fn, arrays, static)``: the body a query block runs, called as
    ``fn(queries, *arrays, filter_words, **static)``, over the placement
    generation :meth:`TieredIvf.tier_arrays` holds now. The caller holds
    ``tiered._swap_lock`` from this call through the last dispatch of the
    plan."""
    expect(tiered.max_list_size > 0, "tiered index is empty")
    expect(params.coarse_algo in ("exact", "approx"),
           f"coarse_algo must be 'exact' or 'approx', got "
           f"{params.coarse_algo!r}")
    hot_data, cold_data, hot_map, cold_map = tiered.tier_arrays()
    engine = resolve_tier_engine(params.scan_engine, hot_data=hot_data,
                                 filter_words=filter_words, k=k)
    static = {"n_probes": min(params.n_probes, tiered.n_lists), "k": k,
              "metric": tiered.metric, "coarse_algo": params.coarse_algo,
              "scan_engine": engine, "workspace_bytes": workspace_bytes}
    arrays = (tiered.centers, tiered.center_norms, hot_data, cold_data,
              hot_map, cold_map, tiered.data_norms, tiered.indices)
    return _tiered_search_fn, arrays, static


def search(res: Optional[Resources], params: TieredSearchParams,
           tiered: TieredIvf, queries, k: int, sample_filter=None,
           query_tile: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """ANN search over the tiered index — ``ivf_flat.search``'s contract,
    and its results bit for bit on the same lists: (distances, indices)
    of shape (q, k), index -1 where no probed candidate filled a slot.
    One placement generation serves the whole call."""
    res = ensure_resources(res)
    queries = res.put(queries)
    expect(queries.ndim == 2 and queries.shape[1] == tiered.dim,
           "queries must be (q, dim)")
    filter_words = resolve_filter_words(sample_filter)
    if filter_words is not None:
        filter_words = filter_words.to(res.device)
    with tiered._swap_lock:
        fn, arrays, static = serving_plan(params, tiered, k, filter_words,
                                          res.workspace_limit_bytes)
        with tracing.range("raft_tpu.tiered.search"):
            return tile_queries(
                lambda qt, fw: fn(qt, *arrays, fw, **static), queries,
                filter_words, query_tile)
