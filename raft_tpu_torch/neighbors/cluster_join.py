"""Cluster-join k-NN-graph construction; port of
``raft_tpu/neighbors/cluster_join.py`` (the JAX package's own graph build,
the CAGRA intermediate-graph source of the ``blobs-1M-128`` config).

1. Partition the points with balanced k-means (clusters of about
   ``target_cluster_size`` rows) and pack each cluster's member ids.
2. Within each cluster, exact brute-force kNN: one float32 product of the
   cluster's rows with themselves and an exact top-k per row through
   ``matrix.select_k`` (AUTO: a row is at most a cluster wide, far below
   the wide-row kernel's 16,384 columns, so TOPK, as the JAX package's
   ``lax.top_k``).
3. Repeat for ``passes`` clusterings with other k-means seeds and merge
   each node's candidates; a true neighbor is lost only if every pass
   separates the pair.
4. Polish with NN-descent rounds seeded from the merged graph.

Cost: :func:`_one_pass` scores each cluster at its own size, not at the
padded ``max_size`` of the JAX package's scan (whose padding is masked:
the result is the same). Balanced k-means leaves the sizes skewed (at
1M rows, ~489 clusters of 2,048 rows on average and a few of twice
that), so a pass costs ``sum(m_c² · d)`` multiply-adds instead of
``C · max_size² · d``, in one product and one selection launch per
cluster.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.cluster.kmeans_balanced import KMeansBalancedParams
from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.matrix.select_k import select_k
from raft_tpu_torch.neighbors import nn_descent as nn_descent_mod
from raft_tpu_torch.neighbors.nn_descent import NNDescentParams, _merge_dedup


@dataclasses.dataclass(frozen=True)
class ClusterJoinParams:
    """Knobs of the cluster-join graph build (the JAX package's)."""

    graph_degree: int = 64
    passes: int = 3
    target_cluster_size: int = 2048
    kmeans_n_iters: int = 8
    kmeans_trainset_fraction: float = 0.25
    polish_rounds: int = 1
    metric: DistanceType = DistanceType.L2Expanded
    seed: int = 0


def _pack_cluster_indices(labels: torch.Tensor, n_clusters: int,
                          max_size: int) -> torch.Tensor:
    """(C, max_size) int32 member ids per cluster in ascending row id,
    -1 padded (the IVF sort-and-rank packing)."""
    dev = labels.device
    n = labels.shape[0]
    labels = labels.to(torch.int64)
    order = torch.argsort(labels, stable=True)
    sorted_labels = labels[order]
    first_pos = torch.searchsorted(sorted_labels,
                                   torch.arange(n_clusters, device=dev),
                                   side="left")
    rank = torch.arange(n, device=dev) - first_pos[sorted_labels]
    flat = torch.full((n_clusters * max_size,), -1, dtype=torch.int32,
                      device=dev)
    flat[sorted_labels * max_size + rank] = order.to(torch.int32)
    return flat.reshape(n_clusters, max_size)


def _one_pass(dataset: torch.Tensor, idx: torch.Tensor, k: int,
              metric: DistanceType, res: Optional[Resources] = None):
    """Within-cluster exact kNN for every cluster: dataset (n, d)
    float32, idx (C, m) member ids (-1 pad, members first). Returns (n,
    k) global neighbor ids (-1 where none) and min-form distances. Ties
    go to the earlier member slot (the JAX package's ``lax.top_k``).
    ``res``: the handle ``select_k`` runs on (one on the dataset's device
    when None)."""
    n = dataset.shape[0]
    dev = dataset.device
    res = Resources(device=dev) if res is None else res
    out_ids = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    out_d = torch.full((n, k), float("inf"), device=dev)
    sizes = (idx >= 0).sum(dim=1).tolist()
    for c, m in enumerate(sizes):
        if m == 0:
            continue
        members = idx[c, :m].to(torch.int64)
        rows = dataset[members]
        ip = rows @ rows.T
        if metric == DistanceType.InnerProduct:
            dist = -ip
        else:
            nr = (rows * rows).sum(dim=1)
            dist = torch.clamp(nr[:, None] + nr[None, :] - 2.0 * ip, min=0.0)
        dist.fill_diagonal_(float("inf"))
        kk = min(k, m)
        nbr_d, pos = select_k(res, dist, kk)
        nbr_ids = torch.where(torch.isfinite(nbr_d),
                              members[pos.to(torch.int64)].to(torch.int32),
                              torch.full_like(pos, -1))
        out_ids[members, :kk] = nbr_ids
        out_d[members, :kk] = nbr_d
    return out_ids, out_d


def build(res: Optional[Resources], params: ClusterJoinParams, dataset,
          return_distances: bool = False):
    """Build an approximate k-NN graph by merged within-cluster
    brute-force passes: (n, graph_degree) int32 (+ distances)."""
    res = ensure_resources(res)
    dataset = res.put(dataset)
    expect(dataset.ndim == 2, "dataset must be (n, d)")
    n = dataset.shape[0]
    k = params.graph_degree
    expect(k < n, "graph_degree must be < n_rows")
    expect(params.metric in (DistanceType.L2Expanded,
                             DistanceType.L2SqrtExpanded,
                             DistanceType.InnerProduct),
           f"cluster_join supports L2/InnerProduct, got {params.metric!r}")
    metric = (DistanceType.InnerProduct
              if params.metric == DistanceType.InnerProduct
              else DistanceType.L2Expanded)
    ds32 = dataset.to(torch.float32)

    with tracing.range("raft_tpu.cluster_join.build"):
        n_clusters = max(1, -(-n // params.target_cluster_size))
        best_ids = best_d = None
        for p in range(params.passes):
            if n_clusters == 1:
                idx = torch.arange(n, dtype=torch.int32,
                                   device=ds32.device)[None, :]
            else:
                km = KMeansBalancedParams(
                    n_iters=params.kmeans_n_iters, metric=metric,
                    seed=params.seed * 31 + p)
                frac = min(max(params.kmeans_trainset_fraction, 0.0), 1.0)
                n_train = min(n, max(n_clusters * 32, int(n * frac)))
                stride = max(1, n // n_train)
                offset = (p * 17) % stride if stride > 1 else 0
                centers = kmeans_balanced.fit(
                    res, km, ds32[offset::stride][:n_train], n_clusters)
                labels = kmeans_balanced.predict(res, km, centers, ds32)
                sizes = torch.bincount(labels.to(torch.int64),
                                       minlength=n_clusters)
                idx = _pack_cluster_indices(labels, n_clusters,
                                            int(sizes.max()))
            pass_ids, pass_d = _one_pass(ds32, idx, k, metric, res)
            if best_ids is None:
                best_ids, best_d = pass_ids, pass_d
            else:
                best_ids, best_d = _merge_dedup(
                    torch.cat([best_ids, pass_ids], dim=1),
                    torch.cat([best_d, pass_d], dim=1), k)
            if n_clusters == 1:
                break  # one pass is exact brute force

        if params.polish_rounds > 0 and n_clusters > 1:
            nnd = NNDescentParams(
                graph_degree=k, intermediate_graph_degree=k,
                max_iterations=params.polish_rounds,
                termination_threshold=0.0, metric=params.metric,
                seed=params.seed)
            return nn_descent_mod.build(res, nnd, ds32,
                                        return_distances=return_distances,
                                        init_graph=best_ids)

        if params.metric == DistanceType.L2SqrtExpanded:
            best_d = torch.sqrt(torch.clamp(best_d, min=0.0))
        elif params.metric == DistanceType.InnerProduct:
            best_d = -best_d
        if return_distances:
            return best_ids, best_d
        return best_ids
