"""IVF-Flat — inverted-file index with raw vectors; port of
``raft_tpu/neighbors/ivf_flat.py`` (reference ``ivf_flat_types.hpp:131``,
build ``detail/ivf_flat_build.cuh:301``, search
``detail/ivf_flat_search-inl.cuh:38-210``).

The layout is the JAX package's: balanced k-means centers, and lists in
ONE padded tensor ``data[n_lists, max_list_size, dim]`` with per-slot
squared norms (+inf on padding) and ids (-1 on padding). Search is a
coarse GEMM + exact top-``n_probes`` over the centers, then the
list-major probe scan (:mod:`raft_tpu_torch.ops.ivf_scan`: the CUDA
kernel on the card, the plain engine on the CPU), then the metric epilog.

The executor (:mod:`raft_tpu_torch.core.executor`) and :func:`search`
both run :func:`_search_impl_fn` as :func:`serving_plan` sets it up; the
executor's ragged plans run :func:`_search_ragged_fn`, the same body
with a per-row probe budget. ``scan_engine="rank"`` runs the legacy
rank-major gather scan instead of the list-major one.
:func:`build_streaming` builds from a dataset file chunk by chunk.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.cluster.kmeans_balanced import (
    KMeansBalancedParams,
    segment_sum,
)
from raft_tpu_torch.core import memwatch, tracing
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.core.serialize import (
    check_version,
    deserialize_array,
    deserialize_scalar,
    open_maybe_path,
    serialize_array,
    serialize_scalar,
)
from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors._batching import coarse_select, tile_queries
from raft_tpu_torch.neighbors._packing import (
    pack_padded_lists,
    padded_extent,
    streaming_ranks,
)
from raft_tpu_torch.neighbors.ann_types import IndexParams, SearchParams
from raft_tpu_torch.neighbors.filters import resolve_filter_words
from raft_tpu_torch.ops.ivf_scan import (
    list_major_scan,
    probe_histogram,
    ragged_probes,
    rank_major_scan,
    resolve_scan_engine,
)

_SERIALIZATION_VERSION = 4  # the JAX package's (and the reference's) v4


@dataclasses.dataclass(frozen=True)
class IvfFlatIndexParams(IndexParams):
    """Mirrors ``ivf_flat::index_params`` (``ivf_flat_types.hpp:49-68``)."""

    n_lists: int = 1024
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    adaptive_centers: bool = False


@dataclasses.dataclass(frozen=True)
class IvfFlatSearchParams(SearchParams):
    """Mirrors ``ivf_flat::search_params``.

    ``scan_engine``: ``"auto"`` is the CUDA kernel for an index on a CUDA
    device and the plain engine otherwise; ``"cuda"``/``"torch"`` force
    one (``cuda`` goes to ``torch`` where the kernel does not apply, see
    ``resolve_scan_engine``); ``"rank"`` is the legacy rank-major gather
    scan (``ops.ivf_scan.rank_major_scan``). ``coarse_algo="approx"`` is
    accepted for parity and runs the exact selection."""

    n_probes: int = 20
    coarse_algo: str = "exact"   # "exact" | "approx"
    scan_engine: str = "auto"    # "auto" | "cuda" | "torch" | "rank"


@dataclasses.dataclass(frozen=True)
class IvfFlatIndex:
    """Padded-dense IVF index (role of ``ivf_flat::index``)."""

    centers: torch.Tensor        # (n_lists, d) float32
    center_norms: torch.Tensor   # (n_lists,) float32 squared norms
    data: torch.Tensor           # (n_lists, max_list_size, d) storage dtype
    data_norms: torch.Tensor     # (n_lists, max_list_size) f32, +inf at padding
    indices: torch.Tensor        # (n_lists, max_list_size) int32, -1 at padding
    list_sizes: torch.Tensor     # (n_lists,) int32
    metric: DistanceType
    adaptive_centers: bool

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def max_list_size(self) -> int:
        return self.data.shape[1]

    @property
    def size(self) -> int:
        return int(self.list_sizes.sum())


def _slot_norms(data: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Per-slot squared norms, +inf on padding so a pad never wins."""
    df = data.to(torch.float32)
    norms = (df * df).sum(dim=2)
    return torch.where(indices >= 0, norms,
                       torch.full_like(norms, float("inf")))


def from_numpy(centers, data, indices, list_sizes,
               metric: DistanceType = DistanceType.L2Expanded,
               adaptive_centers: bool = False,
               res: Optional[Resources] = None) -> IvfFlatIndex:
    """An index from host arrays (e.g. the JAX index's), placed on the
    handle's device; the norm planes are recomputed, as
    ``ivf_flat.load`` does in the JAX package."""
    res = ensure_resources(res)
    centers = res.put(centers, torch.float32)
    data = res.put(data)
    indices = res.put(indices, torch.int32)
    return IvfFlatIndex(
        centers=centers,
        center_norms=(centers * centers).sum(dim=1),
        data=data,
        data_norms=_slot_norms(data, indices),
        indices=indices,
        list_sizes=res.put(list_sizes, torch.int32),
        metric=DistanceType(int(metric)),
        adaptive_centers=bool(adaptive_centers),
    )


# ---------------------------------------------------------------------------
# build / extend
# ---------------------------------------------------------------------------


def _kmeans_metric(metric: DistanceType) -> DistanceType:
    return (DistanceType.InnerProduct if metric == DistanceType.InnerProduct
            else DistanceType.L2Expanded)


def build(res: Optional[Resources], params: IvfFlatIndexParams,
          dataset) -> IvfFlatIndex:
    """Train the coarse quantizer and (optionally) fill the lists —
    ``ivf_flat::build``."""
    res = ensure_resources(res)
    dataset = res.put(dataset)
    expect(dataset.ndim == 2, "dataset must be (n, d)")
    n, d = dataset.shape
    expect(params.n_lists <= n, "n_lists > n_rows")
    expect(
        params.metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
                          DistanceType.InnerProduct),
        f"ivf_flat supports L2Expanded/L2SqrtExpanded/InnerProduct, got "
        f"{params.metric!r}",
    )
    with tracing.range("raft_tpu.ivf_flat.build"):
        # strided trainset subsample (``ivf_pq_build.cuh:1537`` pattern)
        frac = min(max(params.kmeans_trainset_fraction, 0.0), 1.0)
        n_train = max(params.n_lists, int(n * frac))
        if n_train < n:
            trainset = dataset[:: n // n_train][:n_train]
        else:
            trainset = dataset
        km_params = KMeansBalancedParams(
            n_iters=params.kmeans_n_iters,
            metric=_kmeans_metric(params.metric), seed=res.seed)
        centers = kmeans_balanced.fit(res, km_params,
                                      trainset.to(torch.float32),
                                      params.n_lists)
        empty = IvfFlatIndex(
            centers=centers,
            center_norms=(centers * centers).sum(dim=1),
            data=dataset.new_zeros((params.n_lists, 0, d)),
            data_norms=centers.new_zeros((params.n_lists, 0)),
            indices=torch.full((params.n_lists, 0), -1, dtype=torch.int32,
                               device=res.device),
            list_sizes=torch.zeros((params.n_lists,), dtype=torch.int32,
                                   device=res.device),
            metric=DistanceType(params.metric),
            adaptive_centers=params.adaptive_centers,
        )
        if not params.add_data_on_build:
            return empty
        return extend(res, empty, dataset,
                      torch.arange(n, dtype=torch.int32, device=res.device))


def extend(res: Optional[Resources], index: IvfFlatIndex, new_vectors,
           new_indices=None, donate: bool = False) -> IvfFlatIndex:
    """Add vectors to the index — ``ivf_flat::extend``. Returns a new
    index; the old one stays valid unless ``donate=True``.

    When the new rows fit the existing padding they are scattered in —
    O(new) work; with ``donate=True`` that scatter writes the old index's
    tensors in place (the old index object must not be used afterwards).
    Otherwise every row is repacked. Both paths give the same slots.
    With ``adaptive_centers`` the centers move to their lists' means."""
    res = ensure_resources(res)
    new_vectors = res.put(new_vectors)
    expect(new_vectors.ndim == 2 and new_vectors.shape[1] == index.dim,
           "new_vectors must be (n, dim)")
    n_new = new_vectors.shape[0]
    if new_indices is None:
        start = index.size
        new_indices = torch.arange(start, start + n_new, dtype=torch.int32,
                                   device=res.device)
    else:
        new_indices = res.put(new_indices, torch.int32)

    with tracing.range("raft_tpu.ivf_flat.extend"):
        km_params = KMeansBalancedParams(metric=_kmeans_metric(index.metric))
        new_labels = kmeans_balanced.predict(res, km_params, index.centers,
                                             new_vectors.to(torch.float32))
        new_counts = torch.bincount(new_labels.to(torch.int64),
                                    minlength=index.n_lists)

        # incremental path: the new rows fit the existing padding; old
        # rows keep their slots, new rows land at the running fill ranks
        if index.max_list_size > 0 and not index.adaptive_centers:
            sizes_new = (index.list_sizes + new_counts).to(torch.int32)
            if padded_extent(sizes_new) <= index.max_list_size:
                lab_np = new_labels.cpu().numpy()
                fill = index.list_sizes.cpu().numpy().astype(np.int64)
                ranks = torch.from_numpy(
                    streaming_ranks(lab_np, fill, index.n_lists)).to(
                        device=res.device, dtype=torch.int64)
                lists = new_labels.to(torch.int64)
                rows = new_vectors.to(index.data.dtype)
                rf = rows.to(torch.float32)
                data, norms, indices = ((index.data, index.data_norms,
                                         index.indices) if donate else
                                        (index.data.clone(),
                                         index.data_norms.clone(),
                                         index.indices.clone()))
                data[lists, ranks] = rows
                norms[lists, ranks] = (rf * rf).sum(dim=1)
                indices[lists, ranks] = new_indices
                return dataclasses.replace(
                    index, data=data, data_norms=norms, indices=indices,
                    list_sizes=sizes_new)

        # gather existing rows back to flat form and re-pack everything
        if index.max_list_size > 0:
            old_ids = index.indices.reshape(-1)
            keep = old_ids >= 0
            old_rows = index.data.reshape(-1, index.dim)[keep]
            old_labels = torch.arange(
                index.n_lists, dtype=torch.int32, device=res.device
            ).repeat_interleave(index.max_list_size)[keep]
            all_vecs = torch.cat([old_rows, new_vectors.to(old_rows.dtype)])
            all_ids = torch.cat([old_ids[keep], new_indices])
            all_labels = torch.cat([old_labels, new_labels])
        else:
            all_vecs = new_vectors.to(index.data.dtype)
            all_ids, all_labels = new_indices, new_labels

        sizes = torch.bincount(all_labels.to(torch.int64),
                               minlength=index.n_lists).to(torch.int32)
        max_size = padded_extent(sizes)   # one host sync per extend
        # the opt-in capacity gate: the repack is the allocation, so its
        # padded layout is admitted before any tensor is made
        memwatch.admit(
            memwatch.packed_layout_bytes(
                index.n_lists, int(max_size),
                index.dim * all_vecs.element_size()),
            "ivf_flat.extend")
        (data, indices), sizes = pack_padded_lists(
            all_labels, index.n_lists, max_size,
            [(all_vecs, 0), (all_ids, -1)], sizes=sizes)

        centers = index.centers
        if index.adaptive_centers:
            sums = segment_sum(all_vecs.to(torch.float32), all_labels,
                               index.n_lists)
            nonempty = sizes > 0
            centers = torch.where(
                nonempty[:, None],
                sums / torch.clamp(sizes, min=1)[:, None].to(torch.float32),
                centers)
        return IvfFlatIndex(
            centers=centers,
            center_norms=(centers * centers).sum(dim=1),
            data=data,
            data_norms=_slot_norms(data, indices),
            indices=indices,
            list_sizes=sizes,
            metric=index.metric,
            adaptive_centers=index.adaptive_centers,
        )


def build_streaming(res: Optional[Resources], params: IvfFlatIndexParams,
                    source, chunk_rows: int = 1 << 20,
                    train_rows: int = 1 << 18) -> IvfFlatIndex:
    """Build from a dataset that never fully materializes in host memory
    — ``ivf_flat.py:363`` of the JAX package (role of the reference's
    managed-memory trainset spill, ``ivf_pq_build.cuh:1542-1554``, plus
    its batched extend).

    ``source`` is a :class:`raft_tpu_torch.io.BinDataset` (or any object
    with ``n_rows``/``dim``/``iter_chunks``). Three streamed passes:

    1. a strided train sample -> balanced k-means centers;
    2. per-chunk labels (device) + list sizes (host);
    3. per-chunk scatter into the padded float32 list tensor, written in
       place (``index_put_``) after the capacity gate admits it.

    Each chunk is a cancellation point (:mod:`~raft_tpu_torch.core.
    interruptible`). The sample keeps its stride across chunks, so the
    index does not depend on ``chunk_rows``."""
    from raft_tpu_torch.neighbors._streaming import (
        label_pass,
        sample_trainset,
        scatter_pass,
    )

    res = ensure_resources(res)
    n, d = source.n_rows, source.dim
    expect(params.n_lists <= n, "n_lists > n_rows")
    with tracing.range("raft_tpu.ivf_flat.build_streaming"):
        train_rows = max(params.n_lists, min(train_rows, n))
        trainset = sample_trainset(source, train_rows, chunk_rows)
        km = KMeansBalancedParams(n_iters=params.kmeans_n_iters,
                                  metric=_kmeans_metric(params.metric),
                                  seed=res.seed)
        centers = kmeans_balanced.fit(res, km, res.put(trainset),
                                      params.n_lists)
        labels_np, sizes_np = label_pass(res, km, centers, source,
                                         chunk_rows, params.n_lists)
        max_size = padded_extent(sizes_np)
        memwatch.admit(
            memwatch.packed_layout_bytes(params.n_lists, int(max_size),
                                         d * 4),
            "ivf_flat.build_streaming")
        data = torch.zeros((params.n_lists, max_size, d), device=res.device)
        indices = torch.full((params.n_lists, max_size), -1,
                             dtype=torch.int32, device=res.device)

        def scatter(rows, lists, ranks, ids):
            data.index_put_((lists, ranks), rows)
            indices.index_put_((lists, ranks), ids)

        scatter_pass(res, source, labels_np, chunk_rows, params.n_lists,
                     scatter)
        return IvfFlatIndex(
            centers=centers,
            center_norms=(centers * centers).sum(dim=1),
            data=data,
            data_norms=_slot_norms(data, indices),
            indices=indices,
            list_sizes=res.put(sizes_np, torch.int32),
            metric=DistanceType(params.metric),
            adaptive_centers=params.adaptive_centers,
        )


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


def coarse_probes(qf, centers, center_norms, metric: DistanceType,
                  n_probes: int, coarse_algo: str) -> torch.Tensor:
    """The coarse stage, ``select_clusters``: a GEMM against the centers
    and the top-``n_probes`` lists per float32 query, (q, n_probes)
    int32. Shared with the tiered index."""
    ip = qf @ centers.T
    score = (ip if metric == DistanceType.InnerProduct
             else -(center_norms[None, :] - 2.0 * ip))
    return coarse_select(score, n_probes, coarse_algo)


def metric_epilog(qf, best_d, metric: DistanceType) -> torch.Tensor:
    """The scan's min-space top-k to the metric's distances, the epilog
    of ``ivf_flat.py:567-572``: + ||q||^2, clamp at 0, sqrt for
    L2SqrtExpanded; inner products pass through. Shared with the tiered
    index."""
    if metric == DistanceType.InnerProduct:
        return best_d
    q_sq = (qf * qf).sum(dim=1, keepdim=True)
    fin = torch.isfinite(best_d)
    best_d = torch.where(fin, torch.clamp(best_d + q_sq, min=0.0), best_d)
    if metric == DistanceType.L2SqrtExpanded:
        best_d = torch.where(fin, torch.sqrt(best_d), best_d)
    return best_d


def _search_impl_fn(queries, centers, center_norms, data, data_norms,
                    indices, filter_words, probe_counts=None, n_valid=None,
                    row_probes=None, *, n_probes: int, k: int,
                    metric: DistanceType, coarse_algo: str = "exact",
                    scan_engine: str = "torch"):
    """The serving body: coarse select + list-major probe scan + metric
    epilog over the index's arrays, in the order the executor's plan
    passes them.

    ``probe_counts`` optionally provides the (n_lists,) int32 probe
    plane: the batch's selected lists are added to it
    (:func:`raft_tpu_torch.ops.ivf_scan.probe_histogram`, rows at and
    past ``n_valid`` left out) and the new plane is returned as a third
    output. The results never read it. ``row_probes`` (the ragged
    front, :func:`_search_ragged_fn`) is a packed tile's (q,) int32
    per-row probe budget: the coarse stage selects at the class cap
    ``n_probes`` and each row's slots past its own budget become the
    sentinel id (:func:`raft_tpu_torch.ops.ivf_scan.ragged_probes`),
    which the scan skips and the histogram drops, so ``n_valid`` is not
    needed on that path (pad rows have budget 0). ``scan_engine`` arrives
    resolved. On a CUDA index with the ``cuda`` engine the body has no
    host sync, so the executor captures it in a CUDA graph."""
    qf = queries.to(torch.float32)
    probes = coarse_probes(qf, centers, center_norms, metric, n_probes,
                           coarse_algo)
    if row_probes is not None:
        probes = ragged_probes(probes, row_probes, centers.shape[0])
        n_valid = None
    scan = rank_major_scan if scan_engine == "rank" else list_major_scan
    kw = {} if scan_engine == "rank" else {"engine": scan_engine}
    best_d, best_i = scan(qf, data, data_norms, indices, probes,
                          filter_words, k=k, metric=metric, **kw)
    best_d = metric_epilog(qf, best_d, metric)
    if probe_counts is not None:
        return best_d, best_i, probe_histogram(probes, probe_counts, n_valid)
    return best_d, best_i


def _search_ragged_fn(queries, row_probes, centers, center_norms, data,
                      data_norms, indices, filter_words, probe_counts=None,
                      n_valid=None, *, n_probes: int, k: int,
                      metric: DistanceType, scan_engine: str = "torch"):
    """The ragged serving body: a packed ``(tile, dim)`` block of several
    requests' rows (pad rows zero) with its per-row probe budget
    ``row_probes`` (0 on pad rows). ``n_probes`` and ``k`` are the
    params class's caps: the exact coarse top-``n_probes`` is a total
    order, so a row's first ``b`` slots are a solo ``n_probes=b``
    selection, and the class top-``k``'s first ``k_j`` columns are a solo
    top-``k_j``. It is :func:`_search_impl_fn` with the budget hook on,
    so the two paths cannot drift; each row equals its request's solo
    search. Exact coarse selection only (``approx`` has no prefix
    property); ``n_valid`` is accepted for the executor's call and not
    used."""
    del n_valid
    expect(scan_engine in ("cuda", "torch"),
           f"ragged serving needs a list-major engine, got {scan_engine!r}")
    return _search_impl_fn(
        queries, centers, center_norms, data, data_norms, indices,
        filter_words, probe_counts, None, row_probes, n_probes=n_probes,
        k=k, metric=metric, coarse_algo="exact", scan_engine=scan_engine)


def serving_plan(params: IvfFlatSearchParams, index: IvfFlatIndex, k: int,
                 filter_words=None) -> Tuple[Callable, tuple, dict]:
    """``(fn, arrays, static)``: the body a query block runs, called as
    ``fn(queries, *arrays, filter_words, **static)``, with ``n_probes``
    clamped to the index and the scan engine resolved."""
    expect(index.max_list_size > 0, "index is empty — extend() it first")
    expect(params.coarse_algo in ("exact", "approx"),
           f"coarse_algo must be 'exact' or 'approx', got "
           f"{params.coarse_algo!r}")
    engine = resolve_scan_engine(params.scan_engine, data=index.data,
                                 filter_words=filter_words, k=k)
    static = {"n_probes": min(params.n_probes, index.n_lists), "k": k,
              "metric": index.metric, "coarse_algo": params.coarse_algo,
              "scan_engine": engine}
    arrays = (index.centers, index.center_norms, index.data,
              index.data_norms, index.indices)
    return _search_impl_fn, arrays, static


def search(res: Optional[Resources], params: IvfFlatSearchParams,
           index: IvfFlatIndex, queries, k: int, sample_filter=None,
           query_tile: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """ANN search — ``ivf_flat::search``. Returns (distances, indices) of
    shape (q, k); slots no probed candidate filled have index -1."""
    res = ensure_resources(res)
    queries = res.put(queries)
    expect(queries.ndim == 2 and queries.shape[1] == index.dim,
           "queries must be (q, dim)")
    filter_words = resolve_filter_words(sample_filter)
    if filter_words is not None:
        filter_words = filter_words.to(res.device)
    fn, arrays, static = serving_plan(params, index, k, filter_words)
    with tracing.range("raft_tpu.ivf_flat.search"):
        return tile_queries(lambda qt, fw: fn(qt, *arrays, fw, **static),
                            queries, filter_words, query_tile)


# ---------------------------------------------------------------------------
# serialization (versioned npy stream, the JAX package's v4 layout)
# ---------------------------------------------------------------------------


def save(index: IvfFlatIndex, fh_or_path) -> None:
    """``ivf_flat::serialize``."""
    fh, own = open_maybe_path(fh_or_path, "wb")
    try:
        serialize_scalar(fh, _SERIALIZATION_VERSION, np.int32)
        serialize_scalar(fh, int(index.metric), np.int32)
        serialize_scalar(fh, int(index.adaptive_centers), np.int32)
        serialize_array(fh, index.centers)
        serialize_array(fh, index.data)
        serialize_array(fh, index.indices)
        serialize_array(fh, index.list_sizes)
    finally:
        if own:
            fh.close()


def load(res: Optional[Resources], fh_or_path) -> IvfFlatIndex:
    """``ivf_flat::deserialize``."""
    fh, own = open_maybe_path(fh_or_path, "rb")
    try:
        check_version(deserialize_scalar(fh), _SERIALIZATION_VERSION,
                      "ivf_flat")
        metric = DistanceType(int(deserialize_scalar(fh)))
        adaptive = bool(deserialize_scalar(fh))
        centers = deserialize_array(fh)
        data = deserialize_array(fh)
        indices = deserialize_array(fh)
        sizes = deserialize_array(fh)
    finally:
        if own:
            fh.close()
    return from_numpy(centers, data, indices, sizes, metric, adaptive, res)
