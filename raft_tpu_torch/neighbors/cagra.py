"""CAGRA — graph-based ANN; port of ``raft_tpu/neighbors/cagra.py``
(``raft::neighbors::cagra``).

- **build**: an intermediate k-NN graph from cluster-join
  (:mod:`raft_tpu_torch.neighbors.cluster_join`) or NN-descent
  (:mod:`raft_tpu_torch.neighbors.nn_descent`), pruned by
  :func:`optimize` (2-hop detour counting, then reverse edges); the
  IVF-coarse **seed plane** (balanced k-means centers and a -1-padded
  member table); optionally the **BQ record plane** (``bq_bits``: the
  IVF-BQ pinned rotation, RaBitQ codes about the global mean, packed per
  row by :func:`raft_tpu_torch.ops.bq_scan.pack_bq_records`).
  ``BuildAlgo.IVF_PQ`` (the default) builds it by a batched IVF-PQ
  self-search and refine (:func:`build_knn_graph`).
- **search**: seeds from the seed plane (or the strided pool for an
  index without one), then the beam walk. Two engines behind
  ``CagraSearchParams.algo``: ``cuda``, the one-launch kernel
  (:func:`raft_tpu_torch.ops.beam_search.beam_search`; its plain
  version for an index on the CPU), and ``torch``, the twin of the JAX
  package's XLA engine (``_search_batch_fn``: filters, per-row
  ``row_iters``, an early-stopping loop, BQ survivors). ``auto`` takes
  ``cuda`` for an index on a CUDA device when the kernel applies.
- **save/load**: the JAX package's serialization v5, byte for byte.

The executor (:mod:`raft_tpu_torch.core.executor`) serves the index
through :func:`_serving_fn` (the JAX package's ``_serve_impl`` and
``_serving_fn`` in one) and its ragged plans through
:func:`_search_ragged_fn`, the same body with per-row iteration budgets.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.core import tracing
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
from raft_tpu_torch.neighbors import cluster_join, ivf_pq
from raft_tpu_torch.neighbors import nn_descent as nn_descent_mod
from raft_tpu_torch.neighbors._exact import (
    dedup_candidate_mask,
    gathered_distances,
    smallest_k,
)
from raft_tpu_torch.neighbors.filters import resolve_filter_words, test_filter
from raft_tpu_torch.neighbors.ivf_bq import _encode, _pinned_rotation
from raft_tpu_torch.neighbors.nn_descent import _reverse_sample
from raft_tpu_torch.neighbors.refine import refine
from raft_tpu_torch.ops import beam_search as bs
from raft_tpu_torch.ops.bq_scan import (
    _block_estimate,
    auto_query_bits,
    bq_record_geometry,
    pack_bq_records,
)

_SERIALIZATION_VERSION = 5

#: ``CagraSearchParams.algo`` values
SEARCH_ALGOS = ("auto", "cuda", "torch")


class BuildAlgo(enum.Enum):
    """Mirrors ``cagra::graph_build_algo``, plus the JAX package's
    CLUSTER_JOIN graph build."""

    IVF_PQ = "ivf_pq"
    NN_DESCENT = "nn_descent"
    CLUSTER_JOIN = "cluster_join"


@dataclasses.dataclass(frozen=True)
class CagraIndexParams:
    """Mirrors ``cagra::index_params`` (the JAX package's fields)."""

    metric: DistanceType = DistanceType.L2Expanded
    intermediate_graph_degree: int = 128
    graph_degree: int = 64
    build_algo: BuildAlgo = BuildAlgo.IVF_PQ
    nn_descent_niter: int = 20
    # IVF-PQ graph-build knobs (kept for the IVF-PQ graph source)
    ivf_pq_n_lists: int = 0
    ivf_pq_n_probes: int = 0
    refine_rate: float = 2.0
    # dataset storage of the built index: None keeps the input dtype;
    # float32 or bfloat16 (a dtype or its name); build math stays float32
    storage_dtype: Optional[Any] = None
    # lists of the coarse seed plane; 0 -> about sqrt(n), at most 1024
    seed_n_lists: int = 0
    # BQ traversal plane: RaBitQ code bits (1..4); 0 skips the plane
    bq_bits: int = 0


@dataclasses.dataclass(frozen=True)
class CagraSearchParams:
    """Mirrors ``cagra::search_params``: ``itopk_size`` is the buffer,
    ``search_width`` the parents expanded per iteration,
    ``max_iterations`` 0 -> auto. ``seed_pool``, ``seed_mode``,
    ``bq_traversal`` and ``bq_epsilon`` as in the JAX package. ``algo``:
    ``cuda`` (the kernel; its plain version for an index on the CPU),
    ``torch`` (the XLA engine's twin), ``auto`` (``cuda`` on a CUDA
    device where the kernel applies, see :func:`_resolve_search_algo`)."""

    itopk_size: int = 64
    search_width: int = 1
    max_iterations: int = 0
    num_random_samplings: int = 1
    query_tile: int = 256
    seed_pool: int = 0
    seed_mode: str = "auto"
    bq_traversal: str = "auto"
    bq_epsilon: float = 3.0
    algo: str = "auto"


@dataclasses.dataclass(frozen=True)
class CagraIndex:
    """Dataset + fixed-degree neighbor graph (``cagra::index``), with the
    optional seed and BQ planes."""

    dataset: torch.Tensor                   # (n, d)
    graph: torch.Tensor                     # (n, graph_degree) int32
    metric: DistanceType
    seed_centers: Optional[torch.Tensor] = None   # (n_lists, d) f32
    seed_members: Optional[torch.Tensor] = None   # (n_lists, cap) int32
    bq_rotation: Optional[torch.Tensor] = None    # (dim_ext, d) f32
    bq_center_rot: Optional[torch.Tensor] = None  # (1, dim_ext) f32
    bq_records: Optional[torch.Tensor] = None     # (T, PW) int32
    bq_bits: int = 0

    @property
    def size(self) -> int:
        return self.dataset.shape[0]

    @property
    def dim(self) -> int:
        return self.dataset.shape[1]

    @property
    def graph_degree(self) -> int:
        return self.graph.shape[1]


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def build_knn_graph(res, dataset, k: int,
                    metric: DistanceType = DistanceType.L2Expanded,
                    n_lists: int = 0, n_probes: int = 0,
                    refine_rate: float = 2.0, batch: int = 1024):
    """Intermediate k-NN graph by a batched IVF-PQ self-search and refine
    (``detail/cagra/cagra_build.cuh:44-123``, 1024-query batches): 4-bit
    codes at twice the auto ``pq_dim`` (nibble-packed), ``gpu_k = max(k +
    1, (k + 1)·refine_rate)`` candidates a row re-ranked exactly, the
    self-hit dropped and each row stably compacted. Returns (n, k)
    int32."""
    res = ensure_resources(res)
    dataset = res.put(dataset)
    n, dim = dataset.shape
    n_lists = n_lists or max(8, min(n // 39 + 1, int(np.sqrt(n) * 2)))
    n_probes = n_probes or max(8, n_lists // 10)
    gpu_k = max(k + 1, int((k + 1) * refine_rate))
    params = ivf_pq.IvfPqIndexParams(
        metric=metric, n_lists=n_lists, pq_bits=4,
        pq_dim=min(dim, 2 * ivf_pq._auto_pq_dim(dim)),
        kmeans_trainset_fraction=min(1.0, 10240 / max(n, 1) + 0.1))
    index = ivf_pq.build(res, params, dataset)
    sp = ivf_pq.IvfPqSearchParams(n_probes=n_probes)
    out = []
    for start in range(0, n, batch):
        q = dataset[start:start + batch]
        rows = q.shape[0]
        _, cand = ivf_pq.search(res, sp, index, q, gpu_k)
        _, idx = refine(res, dataset, q, cand, k + 1, metric)
        # drop the self-hit and compact each row stably to k entries
        own = torch.arange(start, start + rows, dtype=torch.int32,
                           device=idx.device)[:, None]
        keep = idx != own
        pos = torch.where(keep, torch.cumsum(keep.to(torch.int64), dim=1) - 1,
                          torch.full_like(idx, k + 1, dtype=torch.int64))
        row = torch.full((rows, k + 2), -1, dtype=torch.int32,
                         device=idx.device)
        row.scatter_(1, pos, idx)
        out.append(row[:, :k])
    return torch.cat(out)


def _detour_counts(graph: torch.Tensor, tile: int,
                   method: str = "auto") -> torch.Tensor:
    """2-hop detour count per edge (role of the reference's
    ``kern_prune``): edge (i -> g[i, r]) is detourable through a
    higher-ranked neighbor g[i, l] (l < r) when g[i, r] is in
    ``graph[g[i, l]]``. ``search`` sorts each neighbor row and binary
    searches every edge into it; ``compare`` is the broadcast equality
    the JAX package takes on the TPU. ``auto`` is ``search``, as the JAX
    package picks off the TPU. Equal counts either way."""
    expect(method in ("auto", "search", "compare"),
           f"_detour_counts: method must be auto/search/compare, got "
           f"{method!r}")
    if method == "auto":
        method = "search"
    n, k = graph.shape
    dev = graph.device
    sentinel = torch.iinfo(torch.int32).max
    rank = torch.arange(k, device=dev)
    out = torch.empty((n, k), dtype=torch.int32, device=dev)
    for start in range(0, n, tile):
        g = graph[start:start + tile]                        # (t, k)
        nbrs = graph[g.clamp(min=0).to(torch.int64)]         # (t, k, k)
        nbrs = torch.where((g >= 0)[:, :, None] & (nbrs >= 0), nbrs,
                           torch.full_like(nbrs, sentinel))
        if method == "search":
            snbrs = torch.sort(nbrs, dim=2).values
            gq = g[:, None, :].expand(-1, k, -1).contiguous()
            pos = torch.searchsorted(snbrs, gq)
            hit = torch.gather(snbrs, 2, pos.clamp(max=k - 1)) == gq
            ok = ((rank[None, :, None] < rank[None, None, :])
                  & (g >= 0)[:, None, :])
            out[start:start + tile] = (hit & ok).sum(dim=1)
        else:
            counts = torch.zeros(g.shape, dtype=torch.int32, device=dev)
            for l in range(k):
                match = (nbrs[:, l, :, None] == g[:, None, :]).any(dim=1)
                counts += (match & (g >= 0) & (rank > l)[None, :]).to(
                    torch.int32)
            out[start:start + tile] = counts
    return out


def _select_forward(graph: torch.Tensor, detours: torch.Tensor,
                    fwd_keep: int) -> torch.Tensor:
    """The fwd_keep lowest-detour edges per node, in rank order (ties to
    the closer neighbor)."""
    k = graph.shape[1]
    rank = torch.arange(k, device=graph.device)[None, :]
    score = torch.where(graph >= 0, detours.to(torch.int64) * k + rank,
                        torch.full_like(graph, torch.iinfo(torch.int32).max,
                                        dtype=torch.int64))
    pos = smallest_k(score, fwd_keep)[1]
    return torch.gather(graph, 1, torch.sort(pos, dim=1).values)


def _merge_forward_reverse(graph: torch.Tensor, fwd: torch.Tensor,
                           rev: torch.Tensor,
                           out_degree: int) -> torch.Tensor:
    """Kept forward edges, then reverse edges, then the remaining forward
    edges, repeated ids dropped by priority (role of the reference's
    ``optimize`` + ``kern_make_rev_graph``)."""
    cand = torch.cat([fwd, rev, graph], dim=1)
    c = cand.shape[1]
    prio = torch.arange(c, device=cand.device)[None, :].expand_as(cand)
    prio = torch.where(cand >= 0, prio, torch.full_like(prio, c))
    order = torch.argsort(cand, dim=1, stable=True)
    sid = torch.gather(cand, 1, order)
    sprio = torch.gather(prio, 1, order)
    dup = torch.zeros_like(sid, dtype=torch.bool)
    dup[:, 1:] = sid[:, 1:] == sid[:, :-1]
    sprio = torch.where(dup | (sid < 0), torch.full_like(sprio, c), sprio)
    best = smallest_k(sprio, out_degree)[1]
    keep_ids = torch.gather(sid, 1, best)
    keep_prio = torch.gather(sprio, 1, best)
    reorder = torch.argsort(keep_prio, dim=1, stable=True)
    out = torch.gather(keep_ids, 1, reorder)
    return torch.where(torch.gather(keep_prio, 1, reorder) < c, out,
                       torch.full_like(out, -1)).to(torch.int32)


def optimize(res: Optional[Resources], knn_graph, out_degree: int,
             tile: int = 4096) -> torch.Tensor:
    """Prune an intermediate k-NN graph to a fixed-degree search graph
    (``cagra::optimize``). ``tile`` only bounds the (tile, k, k) detour
    buffer: any tile gives the same graph (the JAX package's default is
    128, a TPU scan step)."""
    res = ensure_resources(res)
    knn_graph = res.put(knn_graph, torch.int32)
    n, k = knn_graph.shape
    expect(out_degree <= k, "out_degree must be <= input graph degree")
    with tracing.range("raft_tpu.cagra.optimize"):
        detours = _detour_counts(knn_graph, tile)
        fwd = _select_forward(knn_graph, detours, out_degree // 2)
        rev = _reverse_sample(fwd, n, out_degree - out_degree // 2)
        return _merge_forward_reverse(knn_graph, fwd, rev, out_degree)


def _auto_seed_lists(n: int) -> int:
    """Default seed-plane list count: about sqrt(n), capped at 1024."""
    return max(1, min(1024, int(round(np.sqrt(max(n, 1))))))


def _build_seed_plane(res: Resources, dataset: torch.Tensor,
                      metric: DistanceType, n_lists: int):
    """Train the IVF-coarse seed plane: balanced k-means centers and the
    -1-padded member table (list -> dataset rows, ascending), empty lists
    dropped (a probe of one would open the beam with nothing)."""
    x = dataset.to(torch.float32)
    n = x.shape[0]
    n_lists = min(n_lists or _auto_seed_lists(n), n)
    km = kmeans_balanced.KMeansBalancedParams(metric=DistanceType(metric),
                                              seed=res.seed)
    centers, labels, sizes = kmeans_balanced.build_clusters(res, km, x,
                                                            n_lists)
    members = cluster_join._pack_cluster_indices(labels, n_lists,
                                                 max(1, int(sizes.max())))
    keep = torch.nonzero(sizes > 0).reshape(-1)
    if keep.numel() < n_lists:
        centers, members = centers[keep], members[keep]
    return centers.to(torch.float32), members


def _build_bq_plane(dataset: torch.Tensor, bits: int, seed: int):
    """The BQ traversal plane: the ivf_bq pinned rotation, the rotated
    global mean, and the packed per-row records of the RaBitQ codes of
    each row about that mean."""
    x = dataset.to(torch.float32)
    d = x.shape[1]
    dim_ext = -(-d // 32) * 32
    rotation = torch.from_numpy(_pinned_rotation(seed, dim_ext, d)).to(
        x.device)
    center = x.mean(dim=0, keepdim=True)
    center_rot = center @ rotation.T
    codes, rnorm, cfac, errw = _encode((x - center) @ rotation.T, bits)
    return rotation, center_rot, pack_bq_records(codes, rnorm, cfac, errw)


def _storage_dtype(spec) -> torch.dtype:
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(
        spec, spec) if isinstance(spec, str) else spec
    expect(dt in (torch.float32, torch.bfloat16),
           f"storage_dtype must be float32/bfloat16, got {spec!r}")
    return dt


def build(res: Optional[Resources], params: CagraIndexParams,
          dataset) -> CagraIndex:
    """k-NN graph + optimize + seed plane (+ BQ plane): ``cagra::build``."""
    res = ensure_resources(res)
    dataset = res.put(dataset)
    expect(dataset.ndim == 2, "dataset must be (n, d)")
    expect(params.metric in bs.SUPPORTED_METRICS,
           f"cagra supports L2/InnerProduct, got {params.metric!r}")
    storage = (None if params.storage_dtype is None
               else _storage_dtype(params.storage_dtype))
    expect(params.bq_bits == 0 or 1 <= params.bq_bits <= 4,
           f"bq_bits must be 0 (off) or 1..4, got {params.bq_bits}")
    n = dataset.shape[0]
    ideg = min(params.intermediate_graph_degree, n - 1)
    odeg = min(params.graph_degree, ideg)

    with tracing.range("raft_tpu.cagra.build"):
        if params.build_algo == BuildAlgo.CLUSTER_JOIN:
            knn_graph = cluster_join.build(res, cluster_join.ClusterJoinParams(
                graph_degree=ideg, metric=params.metric, seed=res.seed),
                dataset)
        elif params.build_algo == BuildAlgo.NN_DESCENT:
            knn_graph = nn_descent_mod.build(res, nn_descent_mod.NNDescentParams(
                graph_degree=ideg,
                intermediate_graph_degree=min(int(ideg * 1.5), n - 1),
                max_iterations=params.nn_descent_niter,
                metric=params.metric, seed=res.seed), dataset)
        else:
            knn_graph = build_knn_graph(
                res, dataset, ideg, params.metric, params.ivf_pq_n_lists,
                params.ivf_pq_n_probes, params.refine_rate)
        graph = optimize(res, knn_graph, odeg)
        seed_centers, seed_members = _build_seed_plane(
            res, dataset, params.metric, params.seed_n_lists)
        bq_rotation = bq_center_rot = bq_records = None
        if params.bq_bits:
            bq_rotation, bq_center_rot, bq_records = _build_bq_plane(
                dataset, params.bq_bits, res.seed)
        stored = dataset if storage is None else dataset.to(storage)
        return CagraIndex(
            dataset=stored.contiguous(), graph=graph.contiguous(),
            metric=DistanceType(params.metric), seed_centers=seed_centers,
            seed_members=seed_members, bq_rotation=bq_rotation,
            bq_center_rot=bq_center_rot, bq_records=bq_records,
            bq_bits=params.bq_bits)


def from_graph(res: Optional[Resources], dataset, graph,
               metric: DistanceType = DistanceType.L2Expanded) -> CagraIndex:
    """An index from a prebuilt graph (no seed or BQ plane)."""
    res = ensure_resources(res)
    return CagraIndex(res.put(dataset).contiguous(),
                      res.put(graph, torch.int32).contiguous(),
                      DistanceType(int(metric)))


def from_numpy(dataset, graph, metric: DistanceType = DistanceType.L2Expanded,
               seed_centers=None, seed_members=None, bq_rotation=None,
               bq_center_rot=None, bq_records=None, bq_bits: int = 0,
               res: Optional[Resources] = None) -> CagraIndex:
    """An index from host arrays (e.g. a JAX index's: dataset, graph,
    seed plane and BQ plane), placed on the handle's device."""
    res = ensure_resources(res)

    def put(a, dtype=None):
        return None if a is None else res.put(a, dtype).contiguous()

    return CagraIndex(
        put(dataset), put(graph, torch.int32), DistanceType(int(metric)),
        seed_centers=put(seed_centers, torch.float32),
        seed_members=put(seed_members, torch.int32),
        bq_rotation=put(bq_rotation, torch.float32),
        bq_center_rot=put(bq_center_rot, torch.float32),
        bq_records=put(bq_records, torch.int32), bq_bits=int(bq_bits))


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


def _buffer_merge(ids, dists, explored, cand_ids, cand_d, L: int):
    """Merge candidates into the itopk buffer: a candidate repeating a
    live buffer id or an earlier candidate is dropped (the buffer copy
    keeps its explored flag), then the L smallest distances, ties to the
    earlier position (``lax.top_k``'s order: a stable sort)."""
    buf_ids = torch.where(ids >= 0, ids, torch.full_like(ids, -2))
    dup = dedup_candidate_mask(cand_ids, buf_ids)
    cd = torch.where(dup | (cand_ids < 0), torch.full_like(cand_d,
                                                           float("inf")),
                     cand_d)
    all_d = torch.cat([dists, cd], dim=1)
    all_i = torch.cat([ids, cand_ids], dim=1)
    all_e = torch.cat([explored, torch.zeros_like(cand_ids,
                                                  dtype=torch.bool)], dim=1)
    vals, pos = smallest_k(all_d, L)
    return (torch.gather(all_i, 1, pos), vals, torch.gather(all_e, 1, pos))


def _pooled_seeds(dataset, queries, pool: int, n_seeds: int,
                  metric: DistanceType):
    """The best ``n_seeds`` of a strided ``pool``-row sample per query."""
    n = dataset.shape[0]
    stride = -(-n // pool)
    cand = ((torch.arange(pool, device=dataset.device) * stride) % n).to(
        torch.int32)
    qf = queries.to(torch.float32)
    d = gathered_distances(qf, dataset, cand.expand(qf.shape[0], pool),
                           metric)
    return cand[smallest_k(d, min(n_seeds, pool))[1]]


def _coarse_seeds(dataset, centers, members, queries, *, n_probes: int,
                  n_seeds: int, metric: DistanceType):
    """IVF-coarse seeding: each query probes its ``n_probes`` nearest
    seed-plane centers and opens from the ``n_seeds`` best of their
    member rows (-1 where fewer are finite). Row-wise: a function of the
    query's content alone."""
    qf = queries.to(torch.float32)
    ip = qf @ centers.T
    if metric == DistanceType.InnerProduct:
        cdist = -ip
    else:
        cdist = (centers * centers).sum(dim=1)[None, :] - 2.0 * ip
    probes = smallest_k(cdist, n_probes)[1]
    cand = members[probes].reshape(qf.shape[0], -1)
    d = gathered_distances(qf, dataset, cand, metric)
    pos = smallest_k(d, n_seeds)[1]
    seeds = torch.gather(cand, 1, pos)
    return torch.where(torch.isfinite(torch.gather(d, 1, pos)), seeds,
                       torch.full_like(seeds, -1))


def derive_search_config(params: CagraSearchParams, index: CagraIndex,
                         k: int) -> dict:
    """The beam shapes (L, w, max_iters, n_seeds), formula for formula
    the JAX package's: the seed count is a multiple of the candidate
    width C = w * graph_degree."""
    L = max(params.itopk_size, k)
    w = max(1, params.search_width)
    c = w * index.graph_degree
    n_seeds = max(L, c) * max(1, params.num_random_samplings)
    n_seeds = -(-n_seeds // c) * c
    return {"k": k, "L": L, "w": w,
            "max_iters": params.max_iterations or (L // w + 24),
            "n_seeds": n_seeds}


def _resolve_seed_mode(params: CagraSearchParams, index: CagraIndex) -> str:
    mode = params.seed_mode
    expect(mode in ("auto", "coarse", "pool"),
           f"seed_mode must be 'auto'/'coarse'/'pool', got {mode!r}")
    if mode == "coarse":
        expect(index.seed_centers is not None,
               "seed_mode='coarse' needs the build-time seed plane "
               "(cagra.build); this index was assembled without one")
        return "coarse"
    if mode == "auto" and index.seed_centers is not None:
        return "coarse"
    return "pool"


def _make_seeds(dataset, seed_centers, seed_members, qt, n_seeds: int,
                metric: DistanceType, seed_mode: str, seed_pool: int):
    """Coarse seeds from the seed plane, or the strided pool; padded to
    ``n_seeds`` by repeating the best (the merge drops repeats)."""
    n = dataset.shape[0]
    pool = seed_pool if seed_pool > 0 else max(256, 4 * n_seeds)
    if seed_mode == "coarse":
        cap = seed_members.shape[1]
        n_probes = max(1, min(-(-pool // cap), seed_centers.shape[0]))
        seeds = _coarse_seeds(dataset, seed_centers, seed_members, qt,
                              n_probes=n_probes,
                              n_seeds=min(n_seeds, n_probes * cap),
                              metric=metric)
    else:
        pool = min(pool, n)
        seeds = _pooled_seeds(dataset, qt, pool, min(n_seeds, pool), metric)
    if seeds.shape[1] < n_seeds:
        reps = -(-n_seeds // seeds.shape[1])
        seeds = seeds.repeat(1, reps)[:, :n_seeds]
    return seeds.to(torch.int32).contiguous()


def _rotate_queries(queries, rotation):
    """Queries in the BQ estimator basis (float32, no TF32)."""
    return queries.to(torch.float32) @ rotation.T


def _resolve_bq_traversal(params: CagraSearchParams,
                          index: CagraIndex) -> bool:
    """``bq_traversal`` against the index's plane. On the card the record
    plane always fits: there is no VMEM rule."""
    mode = params.bq_traversal
    expect(mode in ("auto", "on", "off"),
           f"bq_traversal must be 'auto'/'on'/'off', got {mode!r}")
    if mode == "off":
        return False
    if index.bq_records is None:
        expect(mode != "on",
               "bq_traversal='on' needs an index built with bq_bits >= 1")
        return False
    return True


def _search_batch_fn(dataset, graph, queries, seed_ids, filter_words,
                     row_iters=None, bq_records=None, bq_qrot=None,
                     bq_center_rot=None, *, k: int, L: int, w: int,
                     max_iters: int, metric: DistanceType, bq_bits: int = 0,
                     bq_query_bits: int = 4, bq_epsilon: float = 3.0):
    """The ``torch`` engine, twin of the JAX package's XLA engine: the
    loop stops when no row has an unexplored finite entry left (within
    its ``row_iters``); filtered-out samples never enter the buffer; with
    the BQ plane a candidate is scored only if its estimate survives.
    Returns final-form distances (sqrt / sign applied) and ids."""
    q, dim = queries.shape
    deg = graph.shape[1]
    dev = queries.device
    qf = queries.to(torch.float32)
    ip_metric = metric == DistanceType.InnerProduct
    inf = float("inf")
    use_bq = bq_records is not None

    def score(cand):
        d = gathered_distances(qf, dataset, cand, metric)
        if filter_words is not None:
            d = torch.where(test_filter(filter_words, cand), d,
                            torch.full_like(d, inf))
        return d

    if use_bq:
        dim_ext = -(-dim // 32) * 32
        words = bq_bits * dim_ext // 32
        rows2d = bq_records.reshape(-1, bq_record_geometry(words, bq_bits)[1])

        def bq_survivors(cand, dists):
            r = rows2d[cand.clamp(min=0).to(torch.int64)]   # (q, C, rec_pad)
            scal = r[..., words:words + bq_bits + 2].contiguous().view(
                torch.float32)
            est, margin = _block_estimate(
                bq_qrot, bq_center_rot, scal[..., 0], scal[..., 1 + bq_bits],
                scal[..., 1:1 + bq_bits].permute(2, 0, 1), r[..., :words],
                dim_ext=dim_ext, bits=bq_bits, query_bits=bq_query_bits,
                epsilon=bq_epsilon, ip_metric=ip_metric)
            return ((est - margin) < dists[:, L - 1:L]) & (cand >= 0)

    ids = torch.full((q, L), -1, dtype=torch.int32, device=dev)
    dists = torch.full((q, L), inf, device=dev)
    explored = torch.zeros((q, L), dtype=torch.bool, device=dev)
    if use_bq:
        # seed rounds in C-wide chunks against the evolving L-th distance:
        # the kernel's order
        c = w * deg
        for chunk in range(seed_ids.shape[1] // c):
            cand = seed_ids[:, chunk * c:(chunk + 1) * c]
            cd = torch.where(bq_survivors(cand, dists), score(cand),
                             torch.full(cand.shape, inf, device=dev))
            ids, dists, explored = _buffer_merge(ids, dists, explored, cand,
                                                 cd, L)
    else:
        ids, dists, explored = _buffer_merge(ids, dists, explored, seed_ids,
                                             score(seed_ids), L)

    rows = torch.arange(q, device=dev)[:, None]
    for it in range(max_iters):
        frontier = ~explored & torch.isfinite(dists)
        if row_iters is not None:
            frontier = frontier & (it < row_iters)[:, None]
        if not bool(frontier.any()):
            break
        masked = torch.where(explored | (ids < 0), torch.full_like(dists, inf),
                             dists)
        ppos = smallest_k(masked, w)[1]
        valid = torch.isfinite(torch.gather(masked, 1, ppos))
        if row_iters is not None:
            valid = valid & (it < row_iters)[:, None]
        parents = torch.where(valid, torch.gather(ids, 1, ppos),
                              torch.full_like(ppos, -1, dtype=torch.int32))
        explored[rows, ppos] = explored[rows, ppos] | valid
        cand = graph[parents.clamp(min=0).to(torch.int64)]   # (q, w, deg)
        cand = torch.where((parents >= 0)[:, :, None], cand,
                           torch.full_like(cand, -1)).reshape(q, w * deg)
        cand_d = score(cand)
        if use_bq:
            cand_d = torch.where(bq_survivors(cand, dists), cand_d,
                                 torch.full_like(cand_d, inf))
        ids, dists, explored = _buffer_merge(ids, dists, explored, cand,
                                             cand_d, L)

    out_d = dists[:, :k]
    out_i = torch.where(torch.isfinite(out_d), ids[:, :k],
                        torch.full_like(ids[:, :k], -1))
    return _epilog(out_d, metric), out_i


def _epilog(d: torch.Tensor, metric: DistanceType) -> torch.Tensor:
    """Min-form distances to the metric's own: the sign of inner
    products, the root of L2Sqrt."""
    if metric == DistanceType.InnerProduct:
        return -d
    if metric == DistanceType.L2SqrtExpanded:
        return torch.where(torch.isfinite(d),
                           torch.sqrt(torch.clamp(d, min=0.0)), d)
    return d


def _resolve_search_algo(params: CagraSearchParams, index: CagraIndex,
                         filter_words) -> str:
    """``cuda`` (the beam kernel, or its plain version for an index on the
    CPU) or ``torch`` (the XLA twin).

    The kernel applies to: L2Expanded, L2SqrtExpanded or InnerProduct; no
    sample filter; a float32, bfloat16 or int8 dataset; dim <= 1024 (its
    tree sums hold dim / 32 values per lane; any dim, no lane rule).
    ``auto`` takes ``cuda`` for an index on a CUDA device where all of
    that holds, else ``torch``; ``cuda`` asked for where it does not hold
    raises. The shapes the kernel keeps in shared memory (itopk L <= 512,
    search_width * graph_degree <= 256) are no engine rule: past them
    the kernel's wrapper raises, as the JAX package's ``auto`` has no L
    or C rule either."""
    algo = params.algo
    expect(algo in SEARCH_ALGOS,
           f"algo must be one of {SEARCH_ALGOS}, got {algo!r}")
    if algo == "torch":
        return "torch"
    ok = (index.metric in bs.SUPPORTED_METRICS and filter_words is None
          and index.dataset.dtype in bs.CUDA_DTYPES
          and index.dim <= bs.CUDA_MAX_DIM)
    if algo == "cuda":
        expect(ok, "algo='cuda' needs: L2/IP metric, no sample_filter, "
               "float32/bfloat16/int8 dataset, dim <= 1024 (dim="
               f"{index.dim}, dtype={index.dataset.dtype})")
        return "cuda"
    return "cuda" if ok and index.dataset.device.type == "cuda" else "torch"


def beam_search_args(params: CagraSearchParams, index: CagraIndex,
                     queries: torch.Tensor, k: int) -> Tuple[tuple, dict]:
    """The walk :func:`search` runs for one query tile: the positional
    arguments and keywords of :func:`raft_tpu_torch.ops.beam_search.
    beam_search` (seeds and, with the BQ traversal, the rotated queries).
    The ``torch`` engine walks the same seeds."""
    cfg = derive_search_config(params, index, k)
    seeds = _make_seeds(index.dataset, index.seed_centers,
                        index.seed_members, queries, cfg["n_seeds"],
                        index.metric, _resolve_seed_mode(params, index),
                        params.seed_pool)
    kw = {}
    if _resolve_bq_traversal(params, index):
        kw = dict(bq_records=index.bq_records,
                  bq_qrot=_rotate_queries(queries, index.bq_rotation),
                  bq_crot=index.bq_center_rot, bq_bits=index.bq_bits,
                  bq_query_bits=auto_query_bits(index.bq_bits),
                  bq_epsilon=params.bq_epsilon)
    return (queries, index.dataset, index.graph, seeds, k, cfg["L"],
            cfg["w"], cfg["max_iters"], index.metric), kw


def _serving_fn(queries, dataset, graph, seed_centers, seed_members,
                bq_rotation, bq_center_rot, bq_records, filter_words=None, *,
                query_tile: int, row_iters=None, **static):
    """The serving body: :func:`_serve_tile` over ``query_tile``-row
    tiles of ``queries`` (a per-query filter and the per-row iteration
    budgets ``row_iters`` sliced with them), over the index's arrays in
    the order :func:`serving_plan` passes them (``bq_*`` None without the
    BQ traversal). Seeds are a pure function of each query's content, so
    one plan serves any mix of request blocks and a row's result does not
    depend on the rows beside it or on the tiling. The tiles bound the
    walk's scratch, in a captured graph's pool too. With the ``cuda``
    engine on a CUDA index the body has no host sync, so the executor
    captures it in a CUDA graph; the ``torch`` engine stops its loop on a
    host read and runs eagerly."""
    arrays = (dataset, graph, seed_centers, seed_members, bq_rotation,
              bq_center_rot, bq_records)
    q = queries.shape[0]
    if q <= query_tile:
        return _serve_tile(queries, *arrays, filter_words, row_iters,
                           **static)
    outs_d, outs_i = [], []
    for start in range(0, q, query_tile):
        fw = filter_words
        if fw is not None and fw.ndim == 2:
            fw = fw[start:start + query_tile]
        ri = None if row_iters is None else row_iters[start:start + query_tile]
        d, i = _serve_tile(queries[start:start + query_tile], *arrays, fw,
                           ri, **static)
        outs_d.append(d)
        outs_i.append(i)
    return torch.cat(outs_d), torch.cat(outs_i)


def _search_ragged_fn(queries, row_iters, dataset, graph, seed_centers,
                      seed_members, bq_rotation, bq_center_rot, bq_records,
                      filter_words=None, **static):
    """The ragged serving body: a packed ``(tile, dim)`` block of several
    requests' rows (pad rows zero) with each row's iteration budget
    ``row_iters`` (its request's ``max_iterations``; 0 on pad rows).
    ``max_iters`` and ``k`` are the params class's caps: iterations past
    a row's budget are no-ops in both engines, and the class top-``k``'s
    first ``k_j`` columns are a solo top-``k_j`` (the beam buffer, of
    ``itopk_size`` rows, does not depend on ``k`` while ``k`` stays
    within it), so each row equals its request's solo search. Seeds are
    a pure function of each row, so a zero pad row changes nothing."""
    return _serving_fn(queries, dataset, graph, seed_centers, seed_members,
                       bq_rotation, bq_center_rot, bq_records, filter_words,
                       row_iters=row_iters, **static)


def _serve_tile(queries, dataset, graph, seed_centers, seed_members,
                bq_rotation, bq_center_rot, bq_records, filter_words,
                row_iters=None, *, engine: str, k: int, L: int, w: int,
                max_iters: int, n_seeds: int, metric: DistanceType,
                seed_mode: str, seed_pool: int, bq_bits: int,
                bq_query_bits: int, bq_epsilon: float):
    """Seeds, the beam walk and the metric epilog of one query tile, for
    both engines; ``row_iters`` optionally caps each row's iterations."""
    seeds = _make_seeds(dataset, seed_centers, seed_members, queries,
                        n_seeds, metric, seed_mode, seed_pool)
    use_bq = bq_records is not None
    qrot = _rotate_queries(queries, bq_rotation) if use_bq else None
    if engine == "cuda":
        d, i, _ = bs.beam_search(
            queries, dataset, graph, seeds, k, L, w, max_iters, metric,
            row_iters=row_iters, bq_records=bq_records, bq_qrot=qrot,
            bq_crot=bq_center_rot, bq_bits=bq_bits if use_bq else 0,
            bq_query_bits=bq_query_bits, bq_epsilon=bq_epsilon)
        return _epilog(d, metric), i
    return _search_batch_fn(
        dataset, graph, queries, seeds, filter_words, row_iters, bq_records,
        qrot, bq_center_rot, k=k, L=L, w=w, max_iters=max_iters,
        metric=metric, bq_bits=bq_bits if use_bq else 0,
        bq_query_bits=bq_query_bits, bq_epsilon=bq_epsilon)


def serving_plan(params: CagraSearchParams, index: CagraIndex, k: int,
                 filter_words=None) -> Tuple[Callable, tuple, dict]:
    """``(fn, arrays, static)``: :func:`_serving_fn`, called as
    ``fn(queries, *arrays, filter_words, **static)``, with what it takes
    for ``params`` on ``index``: what :func:`search` runs and what the
    executor's CAGRA plan captures."""
    engine = _resolve_search_algo(params, index, filter_words)
    use_bq = _resolve_bq_traversal(params, index)
    cfg = derive_search_config(params, index, k)
    static = dict(cfg, engine=engine, metric=index.metric,
                  seed_mode=_resolve_seed_mode(params, index),
                  seed_pool=params.seed_pool,
                  bq_bits=index.bq_bits if use_bq else 0,
                  bq_query_bits=(auto_query_bits(index.bq_bits)
                                 if use_bq else 4),
                  bq_epsilon=params.bq_epsilon,
                  query_tile=max(1, params.query_tile))
    arrays = (index.dataset, index.graph, index.seed_centers,
              index.seed_members,
              index.bq_rotation if use_bq else None,
              index.bq_center_rot if use_bq else None,
              index.bq_records if use_bq else None)
    return _serving_fn, arrays, static


def search(res: Optional[Resources], params: CagraSearchParams,
           index: CagraIndex, queries, k: int,
           sample_filter=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Graph beam search (``cagra::search``); with ``sample_filter`` only
    samples whose bit is set may be returned or expanded
    (``cagra::search_with_filtering``, ``torch`` engine)."""
    res = ensure_resources(res)
    queries = res.put(queries)
    expect(queries.ndim == 2 and queries.shape[1] == index.dim,
           "queries must be (q, dim)")
    dev = index.dataset.device
    if queries.shape[0] == 0:
        return (torch.zeros((0, k), device=dev),
                torch.zeros((0, k), dtype=torch.int32, device=dev))
    queries = queries.to(dev)
    filter_words = resolve_filter_words(sample_filter)
    if filter_words is not None:
        filter_words = filter_words.to(dev)
        if filter_words.ndim == 2:
            expect(filter_words.shape[0] == queries.shape[0],
                   "per-query BitmapFilter rows must match the query count")
    fn, arrays, static = serving_plan(params, index, k, filter_words)
    with tracing.range("raft_tpu.cagra.search"):
        return fn(queries, *arrays, filter_words, **static)


# ---------------------------------------------------------------------------
# serialization (the JAX package's v5 layout)
# ---------------------------------------------------------------------------


def save(index: CagraIndex, fh_or_path, include_dataset: bool = True) -> None:
    """``cagra::serialize``."""
    fh, own = open_maybe_path(fh_or_path, "wb")
    try:
        serialize_scalar(fh, _SERIALIZATION_VERSION, np.int32)
        serialize_scalar(fh, int(index.metric), np.int32)
        serialize_scalar(fh, 1 if include_dataset else 0, np.int32)
        serialize_array(fh, index.graph)
        if include_dataset:
            serialize_array(fh, index.dataset)
        has_seed = index.seed_centers is not None
        serialize_scalar(fh, 1 if has_seed else 0, np.int32)
        if has_seed:
            serialize_array(fh, index.seed_centers)
            serialize_array(fh, index.seed_members)
        has_bq = index.bq_records is not None
        serialize_scalar(fh, 1 if has_bq else 0, np.int32)
        if has_bq:
            serialize_scalar(fh, index.bq_bits, np.int32)
            serialize_array(fh, index.bq_rotation)
            serialize_array(fh, index.bq_center_rot)
            serialize_array(fh, index.bq_records)
    finally:
        if own:
            fh.close()


def load(res: Optional[Resources], fh_or_path, dataset=None) -> CagraIndex:
    """Load an index; pass ``dataset`` when it was saved without one."""
    fh, own = open_maybe_path(fh_or_path, "rb")
    try:
        check_version(deserialize_scalar(fh), _SERIALIZATION_VERSION, "cagra")
        metric = DistanceType(int(deserialize_scalar(fh)))
        has_ds = int(deserialize_scalar(fh)) != 0
        graph = deserialize_array(fh)
        if has_ds:
            dataset = deserialize_array(fh)
        seed_centers = seed_members = None
        if int(deserialize_scalar(fh)) != 0:
            seed_centers = deserialize_array(fh)
            seed_members = deserialize_array(fh)
        planes = (None, None, None)
        bq_bits = 0
        if int(deserialize_scalar(fh)) != 0:
            bq_bits = int(deserialize_scalar(fh))
            planes = tuple(deserialize_array(fh) for _ in range(3))
    finally:
        if own:
            fh.close()
    expect(dataset is not None, "index was saved without its dataset")
    return from_numpy(dataset, graph, metric, seed_centers, seed_members,
                      *planes, bq_bits=bq_bits, res=res)
