"""Exact brute-force kNN — analog of ``raft::neighbors::brute_force``
(``neighbors/brute_force-inl.cuh``); port of
``raft_tpu/neighbors/brute_force.py``.

Two routes, as in the JAX package. Small batches on a CUDA device with a
metric the kernel supports go through the hand-written fused kernel
(:func:`raft_tpu_torch.ops.fused_topk.fused_knn`, the ``fusedL2kNN``
analog). Everything else runs the tiled scan: one ``torch.matmul`` per
dataset tile, the tile's top-k, and a running merge (``merge_topk``) —
plain tensor code, as the JAX package leaves that route to XLA.

The index caches the dataset's squared norms
(``brute_force_types.hpp``). The executor (:mod:`raft_tpu_torch.core.
executor`) and :func:`search` both take the route and its body from
:func:`serving_plan`, the executor for a bucket, the search for a query
tile.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

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
from raft_tpu_torch.distance.types import DistanceType, is_min_close
from raft_tpu_torch.matrix.select_k import merge_topk
from raft_tpu_torch.neighbors._batching import tile_queries

_SERIALIZATION_VERSION = 1
_EPS_L2_CLAMP = 1e-4         # the |val| >= 1e-4 rectifier of the l2 epilog
_BROADCAST_ELEMS = 1 << 24   # (rows, tile, d) block of the unexpanded L2


@dataclasses.dataclass(frozen=True)
class BruteForceIndex:
    """Exact-search index: the dataset plus cached norms
    (``brute_force_types.hpp`` ``brute_force::index``)."""

    dataset: torch.Tensor       # (n, d)
    norms: torch.Tensor         # (n,) cached ||y||^2, float32
    metric: DistanceType
    metric_arg: float

    @property
    def size(self) -> int:
        return self.dataset.shape[0]

    @property
    def dim(self) -> int:
        return self.dataset.shape[1]


def from_numpy(dataset, norms=None,
               metric: DistanceType = DistanceType.L2Expanded,
               metric_arg: float = 2.0,
               res: Optional[Resources] = None) -> BruteForceIndex:
    """An index from host arrays (e.g. the JAX index's ``dataset`` and
    ``norms``), placed on the handle's device. ``norms`` is recomputed
    when omitted."""
    res = ensure_resources(res)
    dataset = res.put(dataset)
    if norms is None:
        xf = dataset.to(torch.float32)
        norms = (xf * xf).sum(dim=1)
    return BruteForceIndex(dataset, res.put(norms, torch.float32),
                           DistanceType(int(metric)), float(metric_arg))


def build(
    res: Optional[Resources],
    dataset,
    metric: DistanceType = DistanceType.L2Expanded,
    metric_arg: float = 2.0,
    storage_dtype: Optional[torch.dtype] = None,
) -> BruteForceIndex:
    """Construct the index (norm caching only). ``storage_dtype=
    torch.bfloat16`` stores the dataset half-width; distances stay exact
    for the rounded dataset (bf16 products are exact in float32)."""
    res = ensure_resources(res)
    dataset = res.put(dataset)
    expect(dataset.ndim == 2, "dataset must be (n, d)")
    if storage_dtype is not None:
        dataset = dataset.to(storage_dtype)
    return from_numpy(dataset, None, metric, metric_arg, res)


def _tile_distance(queries: torch.Tensor, yt: torch.Tensor,
                   metric: DistanceType) -> torch.Tensor:
    """(q, t) distances of the expanded-metric family — the JAX
    package's ``pairwise`` forms for the metrics the port has so far."""
    xf = queries.to(torch.float32)
    yf = yt.to(torch.float32)
    if metric in (DistanceType.L2Unexpanded, DistanceType.L2SqrtUnexpanded):
        rows = max(1, _BROADCAST_ELEMS // max(1, yf.shape[0] * yf.shape[1]))
        val = torch.cat([
            torch.square(xf[s : s + rows, None, :] - yf[None]).sum(dim=2)
            for s in range(0, xf.shape[0], rows)])
        return torch.sqrt(val) if metric == DistanceType.L2SqrtUnexpanded \
            else val
    ip = xf @ yf.T
    if metric == DistanceType.InnerProduct:
        return ip
    xn = (xf * xf).sum(dim=1)[:, None]
    yn = (yf * yf).sum(dim=1)[None, :]
    if metric == DistanceType.CosineExpanded:
        return 1.0 - ip / (torch.sqrt(xn) * torch.sqrt(yn))
    if metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded):
        val = xn + yn - 2.0 * ip
        val = val * (torch.abs(val) >= _EPS_L2_CLAMP)
        val = torch.clamp(val, min=0.0)
        return torch.sqrt(val) if metric == DistanceType.L2SqrtExpanded \
            else val
    raise NotImplementedError(
        f"brute_force: metric {metric!r} waits for the port of "
        "distance/pairwise")


def _knn_scan_fn(queries: torch.Tensor, dataset: torch.Tensor, *, k: int,
                 metric: DistanceType, tile: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan dataset tiles, carrying the running top-k (the global-merge
    loop of ``tiled_brute_force_knn``). Each tile's top-k is taken by a
    stable sort, so equal distances keep the lower index first, as
    ``lax.top_k`` does in the JAX package."""
    n = dataset.shape[0]
    q = queries.shape[0]
    select_min = is_min_close(metric)
    pad_val = float("inf") if select_min else float("-inf")
    best_d = queries.new_full((q, k), pad_val, dtype=torch.float32)
    best_i = torch.full((q, k), -1, dtype=torch.int32, device=queries.device)
    for start in range(0, n, tile):
        dist = _tile_distance(queries, dataset[start : start + tile], metric)
        kk = min(k, dist.shape[1])
        tile_d, tile_i = torch.sort(dist, dim=1, descending=not select_min,
                                    stable=True)
        best_d, best_i = merge_topk(best_d, best_i, tile_d[:, :kk],
                                    (start + tile_i[:, :kk]).to(torch.int32),
                                    k, select_min)
    return best_d, best_i


def _fused_entry_fn(queries: torch.Tensor, dataset: torch.Tensor,
                    norms: torch.Tensor, *, k: int, metric: DistanceType
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The serving body of the fused route: the CUDA kernel over the
    index's dataset and cached norms, in the order the executor's plan
    passes them (its plain version for a CPU index)."""
    from raft_tpu_torch.ops.fused_topk import fused_knn

    return fused_knn(queries, dataset, k, metric, dataset_norms=norms)


def _use_fused_kernel(metric: DistanceType, k: int, q: int,
                      device: torch.device) -> bool:
    """Dispatch to the CUDA fused kernel (role of the reference's
    fused-vs-tiled choice, ``detail/knn_brute_force.cuh:324``): a CUDA
    device, a metric the kernel supports, small k (its lists live in
    shared memory) and a batch of at most 512 queries."""
    from raft_tpu_torch.ops.fused_topk import _SUPPORTED_METRICS

    return (device.type == "cuda" and metric in _SUPPORTED_METRICS
            and k <= 64 and q <= 512)


def serving_plan(res: Resources, index: BruteForceIndex, k: int,
                 rows: int, db_tile: int = 32768
                 ) -> Tuple[Callable, tuple, dict]:
    """``(fn, arrays, static)``: the body a block of ``rows`` queries runs,
    called as ``fn(queries, *arrays, **static)``. The fused route where
    :func:`_use_fused_kernel` takes it, else the tiled scan with its
    dataset tile cut to the workspace budget of ``rows`` queries."""
    expect(0 < k <= index.size, f"k must be in (0, {index.size}]")
    if _use_fused_kernel(index.metric, k, rows, index.dataset.device):
        return (_fused_entry_fn, (index.dataset, index.norms),
                {"k": k, "metric": index.metric})
    budget_cols = max(128, res.workspace_limit_bytes // (4 * max(rows, 1)))
    tile = min(db_tile, budget_cols, max(128, index.size))
    return (_knn_scan_fn, (index.dataset,),
            {"k": k, "metric": index.metric, "tile": tile})


def search(
    res: Optional[Resources],
    index: BruteForceIndex,
    queries,
    k: int,
    query_tile: int = 8192,
    db_tile: int = 32768,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN: (distances (q, k) float32, indices (q, k) int32).
    For ``InnerProduct`` the "distances" are similarities sorted
    descending (``is_min_close`` semantics)."""
    res = ensure_resources(res)
    queries = res.put(queries)
    expect(queries.ndim == 2, "queries must be (q, d)")
    expect(queries.shape[1] == index.dim, "query dim mismatch")
    fn, arrays, static = serving_plan(
        res, index, k, min(queries.shape[0], query_tile), db_tile)
    if index.dataset.dtype == torch.bfloat16:
        queries = queries.to(torch.bfloat16)
    with tracing.range("raft_tpu.brute_force.search"):
        return tile_queries(lambda qt, _fw: fn(qt, *arrays, **static),
                            queries, None, query_tile)


def knn(
    res: Optional[Resources],
    dataset,
    queries,
    k: int,
    metric: DistanceType = DistanceType.L2Expanded,
    metric_arg: float = 2.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-shot convenience matching ``brute_force::knn``."""
    index = build(res, dataset, metric, metric_arg)
    return search(res, index, queries, k)


def knn_merge_parts(distances, indices, select_min: bool = True):
    """Merge per-shard kNN results (``detail/knn_merge_parts.cuh``):
    (n_parts, q, k) distances and *global* ids -> merged (q, k)."""
    distances = torch.as_tensor(distances)
    indices = torch.as_tensor(indices)
    n_parts, q, k = distances.shape
    cat_d = distances.permute(1, 0, 2).reshape(q, n_parts * k)
    cat_i = indices.permute(1, 0, 2).reshape(q, n_parts * k)
    return merge_topk(cat_d[:, :k], cat_i[:, :k], cat_d[:, k:], cat_i[:, k:],
                      k, select_min)


# -- serialization ----------------------------------------------------------


def save(index: BruteForceIndex, fh_or_path) -> None:
    """Versioned npy-stream serialization, the JAX package's format."""
    fh, own = open_maybe_path(fh_or_path, "wb")
    try:
        serialize_scalar(fh, _SERIALIZATION_VERSION, np.int32)
        serialize_scalar(fh, int(index.metric), np.int32)
        serialize_scalar(fh, index.metric_arg, np.float32)
        serialize_array(fh, index.dataset)
        serialize_array(fh, index.norms)
    finally:
        if own:
            fh.close()


def load(res: Optional[Resources], fh_or_path) -> BruteForceIndex:
    fh, own = open_maybe_path(fh_or_path, "rb")
    try:
        check_version(deserialize_scalar(fh), _SERIALIZATION_VERSION,
                      "brute_force")
        metric = DistanceType(int(deserialize_scalar(fh)))
        metric_arg = float(deserialize_scalar(fh))
        dataset = deserialize_array(fh)
        norms = deserialize_array(fh)
    finally:
        if own:
            fh.close()
    return from_numpy(dataset, norms, metric, metric_arg, res)
