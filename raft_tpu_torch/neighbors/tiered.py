"""Tiered IVF storage — the port of ``raft_tpu/neighbors/tiered.py``: an
index whose corpus need not fit in device memory, for the flat, PQ and
BQ families.

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

:class:`TieredIvfPq` tiers an IVF-PQ index's codes plane the same way:
:func:`search_pq` equals ``ivf_pq.search`` bit for bit, on the card
through the LUT scan kernel's dual-source fetch
(:mod:`raft_tpu_torch.ops.ivf_pq_scan`, the same staging ring).
:class:`TieredIvfBq` tiers an IVF-BQ index's five record planes as one
unit a list: :func:`search_bq` equals ``ivf_bq.search`` through the plain
fused engine (the card's BQ kernel has no dual-source variant).
:func:`from_numpy`, :func:`from_numpy_pq` and :func:`from_numpy_bq` carry
a JAX-built index across with a given split.

A placement epoch (:mod:`raft_tpu_torch.serving.placement`) only permutes
which lists occupy the fixed hot slots: :func:`apply_plan` swaps blocks
between the tiers for every plane pair of the family, updating the hot
planes and the cold planes **in place** (``index_copy_`` and per-block
copies on the current stream; the JAX package donates its buffers for the
same effect), replaces the slot maps and bumps ``generation`` under the
container's swap lock, after the serving executor's lock when it is
given one. The containers are mutable for that reason, unlike the frozen
index dataclasses.

The executor (:mod:`raft_tpu_torch.core.executor`) and the searches run
each family's body as its serving plan sets it up (:func:`serving_plan`,
:func:`serving_plan_pq`, :func:`serving_plan_bq`), one placement
generation a dispatch, and its ragged plans the same body with a per-row
probe budget; the executor runs them eagerly on the card (the staging
plan is read on the host).
"""

from __future__ import annotations

import contextlib
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


@dataclasses.dataclass
class TieredIvfPq(_TieredPlanes):
    """Hot/cold tiered IVF-PQ container: the codes plane, the only plane
    of a PQ index that grows with the corpus, splits by list under
    :class:`TieredIvf`'s fixed-slot contract. Centers, rotation,
    codebooks, ids and list sizes stay resident, so coarse selection, the
    LUT builds, membership masks and probe accounting are the all-device
    index's and :func:`search_pq` returns ``ivf_pq.search``'s results bit
    for bit."""

    centers: torch.Tensor        # (n_lists, dim) f32, device
    rotation: torch.Tensor       # (dim_ext, dim) f32
    codebooks: torch.Tensor      # PQ codebooks, resident
    indices: torch.Tensor        # (n_lists, max_list_size) int32, every list
    list_sizes: torch.Tensor     # (n_lists,) int32
    hot_codes: torch.Tensor      # (n_hot, max_list_size, row_bytes) u8, device
    cold_codes: torch.Tensor     # (n_cold, max_list_size, row_bytes) u8, pinned
    hot_slot_map: torch.Tensor   # guarded-by: _swap_lock
    cold_slot_map: torch.Tensor  # guarded-by: _swap_lock
    hot_lists: np.ndarray        # guarded-by: _swap_lock
    cold_lists: np.ndarray       # guarded-by: _swap_lock
    metric: DistanceType
    codebook_kind: object        # ivf_pq.CodebookKind
    pq_bits: int
    packed: bool
    host_resident: bool
    generation: int = 0          # guarded-by: _swap_lock
    # re-entrant, held by a search from its snapshot through its staged
    # copies and launches (see TieredIvf)
    _swap_lock: threading.RLock = dataclasses.field(
        default_factory=threading.RLock, repr=False, compare=False)

    _PLANE_PAIRS = (("hot_codes", "cold_codes"),)

    @property
    def pq_book_size(self) -> int:
        return 1 << self.pq_bits

    @property
    def pq_len(self) -> int:
        return self.codebooks.shape[2]

    @property
    def pq_dim(self) -> int:
        d = self.hot_codes.shape[2]
        return d * 2 if self.packed else d


@dataclasses.dataclass
class TieredIvfBq(_TieredPlanes):
    """Hot/cold tiered IVF-BQ (RaBitQ) container: the five per-row record
    planes (sign codes, residual norm, per-level scales, error weight and
    the raw rerank vectors) tier as one unit per list, one slot decision
    for all five, so an estimate and its rerank rows never come from
    different tiers. Centers, rotation, ids and the norm plane stay
    resident. Needs the rerank plane (``store_vectors=True``) and float32
    vectors, as the JAX package does."""

    centers: torch.Tensor        # (n_lists, dim) f32, device
    rotation: torch.Tensor       # (dim_ext, dim) f32
    indices: torch.Tensor        # (n_lists, max) int32, every list
    list_sizes: torch.Tensor     # (n_lists,) int32
    data_norms: torch.Tensor     # (n_lists, max) f32, resident
    hot_codes: torch.Tensor      # (n_hot, max, bits * dim_ext / 32) int32
    cold_codes: torch.Tensor
    hot_rnorm: torch.Tensor      # (n_hot, max) f32
    cold_rnorm: torch.Tensor
    hot_cfac: torch.Tensor       # (n_hot, max, bits) f32
    cold_cfac: torch.Tensor
    hot_errw: torch.Tensor       # (n_hot, max) f32
    cold_errw: torch.Tensor
    hot_data: torch.Tensor       # (n_hot, max, dim) f32, the rerank rows
    cold_data: torch.Tensor
    hot_slot_map: torch.Tensor   # guarded-by: _swap_lock
    cold_slot_map: torch.Tensor  # guarded-by: _swap_lock
    hot_lists: np.ndarray        # guarded-by: _swap_lock
    cold_lists: np.ndarray       # guarded-by: _swap_lock
    metric: DistanceType
    host_resident: bool
    generation: int = 0          # guarded-by: _swap_lock
    _swap_lock: threading.RLock = dataclasses.field(
        default_factory=threading.RLock, repr=False, compare=False)

    _PLANE_PAIRS = (
        ("hot_codes", "cold_codes"),
        ("hot_rnorm", "cold_rnorm"),
        ("hot_cfac", "cold_cfac"),
        ("hot_errw", "cold_errw"),
        ("hot_data", "cold_data"),
    )

    @property
    def dim_ext(self) -> int:
        return self.rotation.shape[0]

    @property
    def bits(self) -> int:
        return self.hot_cfac.shape[2]


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


def _block_bytes(planes) -> int:
    """Bytes of one list's block across ``planes`` (each (n_lists, ...))."""
    return sum(int(np.prod(p.shape[1:])) * p.element_size() for p in planes)


def _tier_place(planes, hot_lists, cold_lists, what: str):
    """Split each full ``(n_lists, ...)`` plane by list: the hot lists'
    blocks stay on the plane's device, the cold lists' blocks go to pinned
    host memory (:func:`host_put`; their device copy is freed once
    pinned). Returns ``(hot_lists, cold_lists, hot_planes, cold_planes,
    hot_slot_map, cold_slot_map, host_resident)``; the hot bytes pass the
    capacity gate first."""
    n_lists = planes[0].shape[0]
    hot_lists = np.asarray(hot_lists, np.int32)
    cold_lists = np.asarray(cold_lists, np.int32)
    expect(np.array_equal(np.sort(np.concatenate([hot_lists, cold_lists])),
                          np.arange(n_lists)),
           "every list must be in exactly one tier")
    dev = planes[0].device
    memwatch.admit(len(hot_lists) * _block_bytes(planes), what)
    hl = torch.from_numpy(hot_lists.astype(np.int64)).to(dev)
    cl = torch.from_numpy(cold_lists.astype(np.int64)).to(dev)
    hots = tuple(p.index_select(0, hl) for p in planes)
    colds, resident = [], True
    for p in planes:
        cold, hr = host_put(p.index_select(0, cl))
        colds.append(cold)
        resident = resident and hr
    hot_map, cold_map = _slot_maps(hot_lists, cold_lists, n_lists)
    return (hot_lists, cold_lists, hots, tuple(colds),
            torch.from_numpy(hot_map).to(dev),
            torch.from_numpy(cold_map).to(dev), resident)


def _place(index: IvfFlatIndex, hot_lists, cold_lists) -> TieredIvf:
    """Split ``index``'s vector plane into the two tiers."""
    expect(index.data.dtype == torch.float32,
           "tiered storage supports f32 list data only")
    hot_lists, cold_lists, (hot_data,), (cold_data,), hot_map, cold_map, \
        host_resident = _tier_place((index.data,), hot_lists, cold_lists,
                                    "tiered.build_tiered")
    return TieredIvf(
        centers=index.centers,
        center_norms=index.center_norms,
        data_norms=index.data_norms,
        indices=index.indices,
        list_sizes=index.list_sizes,
        hot_data=hot_data,
        cold_data=cold_data,
        hot_slot_map=hot_map,
        cold_slot_map=cold_map,
        hot_lists=hot_lists,
        cold_lists=cold_lists,
        metric=index.metric,
        host_resident=host_resident,
    )


def _place_pq(index, hot_lists, cold_lists) -> TieredIvfPq:
    """Split an IVF-PQ index's codes plane into the two tiers."""
    hot_lists, cold_lists, (hot_codes,), (cold_codes,), hot_map, cold_map, \
        host_resident = _tier_place((index.codes,), hot_lists, cold_lists,
                                    "tiered.build_tiered_pq")
    return TieredIvfPq(
        centers=index.centers, rotation=index.rotation,
        codebooks=index.codebooks, indices=index.indices,
        list_sizes=index.list_sizes, hot_codes=hot_codes,
        cold_codes=cold_codes, hot_slot_map=hot_map, cold_slot_map=cold_map,
        hot_lists=hot_lists, cold_lists=cold_lists, metric=index.metric,
        codebook_kind=index.codebook_kind, pq_bits=index.pq_bits,
        packed=index.packed, host_resident=host_resident)


def _bq_planes(index) -> tuple:
    expect(index.data is not None and index.data_norms is not None,
           "tiered BQ needs the re-rank plane (build with "
           "store_vectors=True)")
    expect(index.data.dtype == torch.float32,
           "tiered storage supports f32 list data only")
    return (index.codes, index.rnorm, index.cfac, index.errw, index.data)


def _place_bq(index, hot_lists, cold_lists) -> TieredIvfBq:
    """Split an IVF-BQ index's five record planes into the two tiers, one
    slot decision a list for all five."""
    hot_lists, cold_lists, hots, colds, hot_map, cold_map, host_resident = \
        _tier_place(_bq_planes(index), hot_lists, cold_lists,
                    "tiered.build_tiered_bq")
    return TieredIvfBq(
        centers=index.centers, rotation=index.rotation,
        indices=index.indices, list_sizes=index.list_sizes,
        data_norms=index.data_norms,
        hot_codes=hots[0], cold_codes=colds[0],
        hot_rnorm=hots[1], cold_rnorm=colds[1],
        hot_cfac=hots[2], cold_cfac=colds[2],
        hot_errw=hots[3], cold_errw=colds[3],
        hot_data=hots[4], cold_data=colds[4],
        hot_slot_map=hot_map, cold_slot_map=cold_map,
        hot_lists=hot_lists, cold_lists=cold_lists, metric=index.metric,
        host_resident=host_resident)


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


def build_tiered_pq(index, *, hot_slots=None, hot_fraction: float = 0.5,
                    ledger=None, safety_fraction: float = 0.1,
                    probe_counts=None) -> TieredIvfPq:
    """Split a built :class:`~raft_tpu_torch.neighbors.ivf_pq.IvfPqIndex`
    into the tiered layout (:func:`build_tiered`'s contract), tiering the
    codes plane. The hot-slot budget prices a list block at its codes
    bytes, so a ledger-sized hot tier holds the compression ratio more
    lists than the flat family's at the same headroom."""
    expect(index.max_list_size > 0, "index is empty — extend() it first")
    h = resolve_hot_slots(index, hot_slots=hot_slots,
                          hot_fraction=hot_fraction, ledger=ledger,
                          safety_fraction=safety_fraction,
                          block_bytes=_block_bytes((index.codes,)))
    hot_lists, cold_lists = _split_lists(index.n_lists, h, probe_counts)
    return _place_pq(index, hot_lists, cold_lists)


def build_tiered_bq(index, *, hot_slots=None, hot_fraction: float = 0.5,
                    ledger=None, safety_fraction: float = 0.1,
                    probe_counts=None) -> TieredIvfBq:
    """Split a built :class:`~raft_tpu_torch.neighbors.ivf_bq.IvfBqIndex`
    into the tiered layout: the five record planes move as one unit per
    list (:class:`TieredIvfBq`), priced at their summed bytes. Needs the
    rerank plane and float32 vectors."""
    expect(index.max_list_size > 0, "index is empty — extend() it first")
    h = resolve_hot_slots(index, hot_slots=hot_slots,
                          hot_fraction=hot_fraction, ledger=ledger,
                          safety_fraction=safety_fraction,
                          block_bytes=_block_bytes(_bq_planes(index)))
    hot_lists, cold_lists = _split_lists(index.n_lists, h, probe_counts)
    return _place_bq(index, hot_lists, cold_lists)


def from_numpy_pq(index_fields: dict, hot_lists, cold_lists,
                  res: Optional[Resources] = None) -> TieredIvfPq:
    """:func:`from_numpy` for IVF-PQ: ``index_fields`` are
    :func:`raft_tpu_torch.neighbors.ivf_pq.from_numpy`'s arguments (a
    JAX-built index's ``centers``, ``rotation``, ``codebooks``, ``codes``,
    ``indices``, ``list_sizes`` and its metric, codebook kind, bits and
    packing), split by ``hot_lists`` / ``cold_lists`` in slot order."""
    from raft_tpu_torch.neighbors import ivf_pq

    return _place_pq(ivf_pq.from_numpy(**index_fields, res=res), hot_lists,
                     cold_lists)


def from_numpy_bq(index_fields: dict, hot_lists, cold_lists,
                  res: Optional[Resources] = None) -> TieredIvfBq:
    """:func:`from_numpy` for IVF-BQ: ``index_fields`` are
    :func:`raft_tpu_torch.neighbors.ivf_bq.from_numpy`'s arguments, the
    ``data`` plane among them."""
    from raft_tpu_torch.neighbors import ivf_bq

    return _place_bq(ivf_bq.from_numpy(**index_fields, res=res), hot_lists,
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


def apply_plan(tiered, promotions, demotions, width: int, executor=None,
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
    ``tier.promote_cold_bytes``.

    Any tiered family: the plane pairs come from ``_PLANE_PAIRS`` (flat:
    the vectors; PQ: the codes; BQ: all five record planes under one slot
    decision). With the serving ``executor`` (the ``TierManager`` passes
    it) the swap runs under the executor's lock, then the swap lock, the
    order its dispatches take them in (``SearchExecutor._dispatch_lock``):
    no dispatch interleaves with a swap, and each serves one placement
    generation."""
    n = len(promotions)
    expect(n == len(demotions), "promotions/demotions must pair up")
    expect(n <= width, f"plan has {n} swaps, width is {width}")
    if n == 0:
        return 0
    promo = np.asarray(promotions, np.int32)
    demo = np.asarray(demotions, np.int32)
    misses = 0
    ex_lock = (getattr(executor, "_lock", None) if executor is not None
               else None)
    with ex_lock or contextlib.nullcontext(), tiered._swap_lock:
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
    return _search_family(
        res, tiered, queries, k, sample_filter, query_tile,
        lambda r, fw: serving_plan(params, tiered, k, fw,
                                   r.workspace_limit_bytes),
        "raft_tpu.tiered.search")


# ---------------------------------------------------------------------------
# the compressed families
# ---------------------------------------------------------------------------


def _tiered_pq_search_fn(queries, centers, rotation, codebooks, hot_codes,
                         cold_codes, hot_slot_map, cold_slot_map, indices,
                         filter_words, probe_counts=None, n_valid=None,
                         row_probes=None, *, n_probes: int, k: int,
                         metric: DistanceType, codebook_kind, lut_dtype,
                         score_mode: str = "gather", packed: bool = False,
                         coarse_algo: str = "exact",
                         scan_engine: str = "torch",
                         workspace_bytes: Optional[int] = None):
    """The tiered IVF-PQ serving body, over one placement generation's
    arrays: :func:`raft_tpu_torch.neighbors.ivf_pq._search_impl_fn` with
    the codes plane split, so coarse select, residuals, LUTs, sums and
    merge are the all-device body's and only the per-list code fetch
    steers through the slot maps (the plain engine's
    ``tier_block_select``, the kernel's staged dual-source fetch). The
    results equal the all-device index's bit for bit. The caller holds
    the container's swap lock through the call; the kernel's staging
    plan is read on the host, so the executor runs it eagerly."""
    from raft_tpu_torch.neighbors import ivf_pq

    return ivf_pq._search_impl_fn(
        queries, centers, rotation, codebooks, hot_codes, indices,
        filter_words, probe_counts, n_valid, row_probes, cold_codes,
        hot_slot_map, cold_slot_map, n_probes=n_probes, k=k, metric=metric,
        codebook_kind=codebook_kind, lut_dtype=lut_dtype,
        score_mode=score_mode, packed=packed, coarse_algo=coarse_algo,
        scan_engine=scan_engine, workspace_bytes=workspace_bytes)


def _tiered_pq_search_ragged_fn(queries, row_probes, centers, rotation,
                                codebooks, hot_codes, cold_codes,
                                hot_slot_map, cold_slot_map, indices,
                                filter_words, probe_counts=None,
                                n_valid=None, *, n_probes: int, k: int,
                                metric: DistanceType, codebook_kind,
                                lut_dtype, score_mode: str = "gather",
                                packed: bool = False,
                                scan_engine: str = "torch",
                                workspace_bytes: Optional[int] = None):
    """The ragged tiered IVF-PQ body (:func:`_tiered_search_ragged_fn`'s
    contract): :func:`_tiered_pq_search_fn` with each packed row's probe
    budget, list-major engines only."""
    del n_valid
    expect(scan_engine in ("cuda", "torch"),
           "ragged tiered PQ serving needs a list-major engine, got "
           f"{scan_engine!r}")
    return _tiered_pq_search_fn(
        queries, centers, rotation, codebooks, hot_codes, cold_codes,
        hot_slot_map, cold_slot_map, indices, filter_words, probe_counts,
        None, row_probes, n_probes=n_probes, k=k, metric=metric,
        codebook_kind=codebook_kind, lut_dtype=lut_dtype,
        score_mode=score_mode, packed=packed, coarse_algo="exact",
        scan_engine=scan_engine, workspace_bytes=workspace_bytes)


def _tiered_bq_search_fn(queries, centers, rotation, hot_codes, hot_rnorm,
                         hot_cfac, hot_errw, hot_data, cold_codes,
                         cold_rnorm, cold_cfac, cold_errw, cold_data,
                         hot_slot_map, cold_slot_map, indices, data_norms,
                         filter_words, probe_counts=None, n_valid=None,
                         row_probes=None, *, n_probes: int, k: int,
                         metric: DistanceType, coarse_algo: str = "exact",
                         scan_engine: str = "torch", epsilon: float = 3.0,
                         query_bits: int = 0):
    """The tiered IVF-BQ serving body:
    :func:`raft_tpu_torch.neighbors.ivf_bq._search_impl_fn` with the five
    cold record planes live (one slot decision a list covers the
    estimate planes and the rerank rows): the same estimates, prune
    decisions and exact reranks, so the results equal the all-device
    index's bit for bit. The plain fused engine only
    (:func:`~raft_tpu_torch.ops.tier_scan.resolve_tier_bq_engine`)."""
    from raft_tpu_torch.neighbors import ivf_bq

    return ivf_bq._search_impl_fn(
        queries, centers, rotation, hot_codes, hot_rnorm, hot_cfac,
        hot_errw, indices, hot_data, data_norms, filter_words, probe_counts,
        n_valid, row_probes,
        (cold_codes, cold_rnorm, cold_cfac, cold_errw, cold_data),
        hot_slot_map, cold_slot_map, n_probes=n_probes, k=k, metric=metric,
        coarse_algo=coarse_algo, scan_engine=scan_engine, epsilon=epsilon,
        query_bits=query_bits)


def _tiered_bq_search_ragged_fn(queries, row_probes, centers, rotation,
                                hot_codes, hot_rnorm, hot_cfac, hot_errw,
                                hot_data, cold_codes, cold_rnorm, cold_cfac,
                                cold_errw, cold_data, hot_slot_map,
                                cold_slot_map, indices, data_norms,
                                filter_words, probe_counts=None,
                                n_valid=None, *, n_probes: int, k: int,
                                metric: DistanceType,
                                scan_engine: str = "torch",
                                epsilon: float = 3.0, query_bits: int = 0):
    """The ragged tiered IVF-BQ body (:func:`_tiered_search_ragged_fn`'s
    contract; the prune compares each row with its own k-th distance)."""
    del n_valid
    expect(scan_engine == "torch",
           "ragged tiered BQ serving rides the plain fused engine, got "
           f"{scan_engine!r}")
    return _tiered_bq_search_fn(
        queries, centers, rotation, hot_codes, hot_rnorm, hot_cfac,
        hot_errw, hot_data, cold_codes, cold_rnorm, cold_cfac, cold_errw,
        cold_data, hot_slot_map, cold_slot_map, indices, data_norms,
        filter_words, probe_counts, None, row_probes, n_probes=n_probes,
        k=k, metric=metric, coarse_algo="exact", scan_engine=scan_engine,
        epsilon=epsilon, query_bits=query_bits)


def serving_plan_pq(params, tiered: TieredIvfPq, k: int, filter_words=None,
                    workspace_bytes: Optional[int] = None
                    ) -> Tuple[Callable, tuple, dict]:
    """``(fn, arrays, static)`` of a tiered IVF-PQ search (the contract of
    :func:`serving_plan`) with
    :class:`~raft_tpu_torch.neighbors.ivf_pq.IvfPqSearchParams`. The engine
    is :func:`~raft_tpu_torch.ops.tier_scan.resolve_tier_pq_engine`'s: the
    dual-source kernel for a hot tier on the card."""
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops.ivf_pq_scan import LUT_DTYPES
    from raft_tpu_torch.ops.tier_scan import resolve_tier_pq_engine

    del filter_words      # the kernel takes shared and per-query filters
    expect(tiered.max_list_size > 0, "tiered index is empty")
    expect(params.coarse_algo in ("exact", "approx"),
           f"coarse_algo must be 'exact' or 'approx', got "
           f"{params.coarse_algo!r}")
    expect(params.lut_dtype in LUT_DTYPES,
           f"lut_dtype must be float32/bfloat16/float8_e4m3fn/float8_e5m2, "
           f"got {params.lut_dtype}")
    score_mode = ivf_pq.resolve_score_mode(params.score_mode,
                                           tiered.pq_book_size)
    (hot_codes,), (cold_codes,), hot_map, cold_map, _ = tiered.tier_planes()
    engine = resolve_tier_pq_engine(params.scan_engine, hot_codes=hot_codes,
                                    k=k)
    expect(engine != "cuda" or score_mode == "gather",
           f"scan_engine='cuda' scores by gather; score_mode "
           f"{params.score_mode!r} is a plain formulation (use 'torch')")
    static = {"n_probes": min(params.n_probes, tiered.n_lists), "k": k,
              "metric": tiered.metric,
              "codebook_kind": tiered.codebook_kind,
              "lut_dtype": params.lut_dtype, "score_mode": score_mode,
              "packed": tiered.packed, "coarse_algo": params.coarse_algo,
              "scan_engine": engine, "workspace_bytes": workspace_bytes}
    arrays = (tiered.centers, tiered.rotation, tiered.codebooks, hot_codes,
              cold_codes, hot_map, cold_map, tiered.indices)
    return _tiered_pq_search_fn, arrays, static


def serving_plan_bq(params, tiered: TieredIvfBq, k: int, filter_words=None
                    ) -> Tuple[Callable, tuple, dict]:
    """``(fn, arrays, static)`` of a tiered IVF-BQ search with
    :class:`~raft_tpu_torch.neighbors.ivf_bq.IvfBqSearchParams`: the
    plain fused engine (:func:`~raft_tpu_torch.ops.tier_scan
    .resolve_tier_bq_engine`), exact distances."""
    from raft_tpu_torch.ops.bq_scan import auto_query_bits
    from raft_tpu_torch.ops.tier_scan import resolve_tier_bq_engine

    del filter_words       # the plain engine takes both filter kinds
    expect(tiered.max_list_size > 0, "tiered index is empty")
    expect(params.coarse_algo in ("exact", "approx"),
           f"coarse_algo must be 'exact' or 'approx', got "
           f"{params.coarse_algo!r}")
    expect(params.query_bits == 0 or 1 <= params.query_bits <= 8,
           f"query_bits must be 0 (auto) or 1..8, got {params.query_bits}")
    engine = resolve_tier_bq_engine(params.scan_engine)
    hots, colds, hot_map, cold_map, _ = tiered.tier_planes()
    static = {"n_probes": min(params.n_probes, tiered.n_lists), "k": k,
              "metric": tiered.metric, "coarse_algo": params.coarse_algo,
              "scan_engine": engine, "epsilon": params.epsilon,
              "query_bits": params.query_bits or auto_query_bits(
                  tiered.bits)}
    arrays = ((tiered.centers, tiered.rotation) + hots + colds
              + (hot_map, cold_map, tiered.indices, tiered.data_norms))
    return _tiered_bq_search_fn, arrays, static


def _search_family(res, tiered, queries, k, sample_filter, query_tile,
                   plan, what: str):
    """One search of any tiered family: ``plan(res, filter_words)`` gives
    the family's ``(fn, arrays, static)`` under the swap lock, which the
    whole call holds (one placement generation)."""
    res = ensure_resources(res)
    queries = res.put(queries)
    expect(queries.ndim == 2 and queries.shape[1] == tiered.dim,
           "queries must be (q, dim)")
    filter_words = resolve_filter_words(sample_filter)
    if filter_words is not None:
        filter_words = filter_words.to(res.device)
    with tiered._swap_lock:
        fn, arrays, static = plan(res, filter_words)
        with tracing.range(what):
            return tile_queries(
                lambda qt, fw: fn(qt, *arrays, fw, **static), queries,
                filter_words, query_tile)


def search_pq(res: Optional[Resources], params, tiered: TieredIvfPq,
              queries, k: int, sample_filter=None, query_tile: int = 4096
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ANN search over the tiered IVF-PQ index — ``ivf_pq.search``'s
    contract with :class:`~raft_tpu_torch.neighbors.ivf_pq
    .IvfPqSearchParams`, and its results bit for bit on the same lists.
    ``scan_engine``: ``auto`` (the dual-source kernel on the card, the
    plain engine on the CPU), ``cuda`` or ``torch``; ``rank`` raises.
    One placement generation serves the whole call."""
    return _search_family(
        res, tiered, queries, k, sample_filter, query_tile,
        lambda r, fw: serving_plan_pq(params, tiered, k, fw,
                                      r.workspace_limit_bytes),
        "raft_tpu.tiered.search_pq")


def search_bq(res: Optional[Resources], params, tiered: TieredIvfBq,
              queries, k: int, sample_filter=None, query_tile: int = 4096
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ANN search over the tiered IVF-BQ index — ``ivf_bq.search``'s
    contract with :class:`~raft_tpu_torch.neighbors.ivf_bq
    .IvfBqSearchParams` on a store-vectors index, and its results bit for
    bit: exact distances from the plain fused engine, each probed list's
    five record planes taken from its tier."""
    return _search_family(
        res, tiered, queries, k, sample_filter, query_tile,
        lambda r, fw: serving_plan_bq(params, tiered, k, fw),
        "raft_tpu.tiered.search_bq")
