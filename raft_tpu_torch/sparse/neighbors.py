"""Sparse neighbors — port of ``raft_tpu/sparse/neighbors.py``
(reference ``raft/sparse/neighbors/``: ``brute_force.cuh`` tiled sparse
kNN, ``knn_graph.cuh`` graph construction, ``cross_component_nn.cuh``
MST-component connection).

:func:`knn_graph` takes its neighbors from exact brute force
(:func:`raft_tpu_torch.neighbors.brute_force.knn`): on the card that is
the hand-written ``fused_knn`` kernel (``csrc/fused_knn.cu``) for the
L2, sqrt-L2, inner-product and cosine metrics, on the CPU its plain
version.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.distance.pairwise import _pairwise_distance_impl
from raft_tpu_torch.distance.types import DistanceType, is_min_close
from raft_tpu_torch.matrix.select_k import merge_topk
from raft_tpu_torch.sparse.distance import _tight_row_slice
from raft_tpu_torch.sparse.types import COO, CSR, _segment_min

def brute_force_knn(
    res: Optional[Resources],
    database: CSR,
    queries: CSR,
    k: int,
    metric: DistanceType = DistanceType.L2Expanded,
    metric_arg: float = 2.0,
    tile: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN between sparse row sets (``sparse::neighbors::
    brute_force_knn``): tiled densify + dense distance + running top-k
    merge (the reference's batcher, ``detail/knn.cuh``). Equal distances
    keep the smaller id first."""
    res = ensure_resources(res)
    assert database.shape[1] == queries.shape[1], "column dims must match"
    n = database.shape[0]
    q = queries.shape[0]
    select_min = is_min_close(metric)
    pad_val = math.inf if select_min else -math.inf
    qd = queries.to_dense()
    dip = database.indptr.cpu().numpy()

    with tracing.range("raft_tpu.sparse.brute_force_knn"):
        best_d = torch.full((q, k), pad_val, dtype=torch.float32,
                            device=qd.device)
        best_i = torch.full((q, k), -1, dtype=torch.int32, device=qd.device)
        for start in range(0, n, tile):
            stop = min(start + tile, n)
            bd = _tight_row_slice(database, dip, start, stop).to_dense()
            dist = _pairwise_distance_impl(qd, bd, metric, metric_arg,
                                           "highest",
                                           res.workspace_limit_bytes)
            kk = min(k, stop - start)
            td, ti = torch.sort(dist, dim=1, descending=not select_min,
                                stable=True)
            best_d, best_i = merge_topk(best_d, best_i, td[:, :kk],
                                        (ti[:, :kk] + start).to(torch.int32),
                                        k, select_min)
        return best_d, best_i


def knn_graph(
    res: Optional[Resources],
    x,
    k: int,
    metric: DistanceType = DistanceType.L2Expanded,
) -> COO:
    """k-NN graph over dense rows → COO adjacency
    (``sparse::neighbors::knn_graph``; consumed by single-linkage).
    Self-edges are excluded; edges carry distances."""
    from raft_tpu_torch.neighbors import brute_force  # avoid import cycle

    res = ensure_resources(res)
    x = res.put(x)
    n = x.shape[0]
    with tracing.range("raft_tpu.sparse.knn_graph"):
        d, i = brute_force.knn(res, x, x, k + 1, metric)
        rows2d = torch.arange(n, dtype=torch.int32, device=x.device)[:, None]
        # keep the first k non-self hits per row: with duplicate points the
        # self-match may be displaced out of the top-(k+1), so dropping
        # self-edges alone would leave k+1 edges on some rows
        nonself = (i != rows2d) & (i >= 0)
        rank = torch.cumsum(nonself, dim=1)
        keep = (nonself & (rank <= k)).reshape(-1)
        rows = rows2d.expand(n, k + 1).reshape(-1)
        cols = i.reshape(-1).to(torch.int32)
        vals = d.reshape(-1).to(torch.float32)
        return COO(torch.where(keep, rows, -1),
                   torch.where(keep, cols, 0),
                   torch.where(keep, vals, torch.zeros_like(vals)), (n, n))


def cross_component_nn(
    res: Optional[Resources],
    x,
    labels,
    metric: DistanceType = DistanceType.L2Expanded,
    tile: int = 1024,
) -> COO:
    """Nearest neighbor in a *different* component per component —
    ``sparse::neighbors::cross_component_nn`` (connects MST forests in
    single-linkage). Returns COO edges (one per component: min outgoing,
    ties to the smaller vertex and then the smaller neighbor).
    """
    res = ensure_resources(res)
    x = res.put(x)
    labels = res.put(labels).to(torch.int64)
    n = x.shape[0]
    n_comp = int(labels.max()) + 1

    with tracing.range("raft_tpu.sparse.cross_component_nn"):
        best_d = torch.full((n,), math.inf, dtype=torch.float32,
                            device=x.device)
        best_j = torch.zeros((n,), dtype=torch.int32, device=x.device)
        for start in range(0, n, tile):
            stop = min(start + tile, n)
            dist = _pairwise_distance_impl(x, x[start:stop], metric, 2.0,
                                           "highest",
                                           res.workspace_limit_bytes)
            same = labels[:, None] == labels[None, start:stop]
            dist.masked_fill_(same, math.inf)
            td, tj = torch.min(dist, dim=1)
            upd = td < best_d
            best_d = torch.where(upd, td, best_d)
            best_j = torch.where(upd, tj.to(torch.int32) + start, best_j)
        # reduce per component: min outgoing edge
        comp_min = _segment_min(best_d, labels, n_comp)
        is_min = best_d == comp_min[labels]
        # first vertex achieving the min per component
        ar = torch.arange(n, device=x.device)
        first = _segment_min(torch.where(is_min, ar, n), labels, n_comp)
        src = first.clamp(0, n - 1)
        dst = best_j[src]
        w = best_d[src]
        valid = (first < n) & torch.isfinite(w)
        return COO(torch.where(valid, src.to(torch.int32), -1),
                   torch.where(valid, dst, 0),
                   torch.where(valid, w, torch.zeros_like(w)), (n, n))
