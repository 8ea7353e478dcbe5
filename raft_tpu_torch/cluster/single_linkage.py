"""Single-linkage agglomerative clustering — port of ``raft_tpu/cluster/
single_linkage.py`` (reference ``cluster/single_linkage.cuh`` +
``cluster/detail/{mst,connectivities,agglomerative}.cuh``): kNN-graph
connectivity → MST → dendrogram → flat cut.

Graph construction (the ``fused_knn`` kernel on the card, through
:func:`raft_tpu_torch.sparse.neighbors.knn_graph`), symmetrization and
Borůvka MST run on the handle's device; the dendrogram over the n-1
sorted MST edges is a sequential union-find on the host, as in the JAX
package. Here it is O(n α(n)) (union by size over preallocated arrays)
where the JAX package grows an array a step; the ``children``, ``sizes``
and ``labels`` are the same.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.distance.types import DistanceType


@dataclasses.dataclass
class SingleLinkageOutput:
    """``linkage_output`` analog (``cluster/single_linkage_types.hpp``)."""

    labels: np.ndarray        # (n,) flat cluster assignment
    children: np.ndarray      # (n-1, 2) merged pair per dendrogram step
    deltas: np.ndarray        # (n-1,) merge distances
    sizes: np.ndarray         # (n-1,) size of the merged cluster
    n_clusters: int


def _mst_edges_connected(res, x, k, metric):
    """kNN-graph MST; reconnects forest components with
    cross_component_nn edges until a single tree remains (the reference's
    connect_components loop in ``detail/mst.cuh``). Each connect round
    adds one to the ``cluster.single_linkage.connect_rounds`` counter."""
    from raft_tpu_torch.sparse.convert import coo_to_csr
    from raft_tpu_torch.sparse.linalg import coo_symmetrize
    from raft_tpu_torch.sparse.neighbors import cross_component_nn, knn_graph
    from raft_tpu_torch.sparse.solver import mst
    from raft_tpu_torch.sparse.types import COO

    n = x.shape[0]
    g = knn_graph(res, x, k, metric)
    for _ in range(int(np.ceil(np.log2(max(n, 2)))) + 1):
        sym = coo_symmetrize(g)
        result = mst(res, coo_to_csr(sym))
        # one component left: every vertex carries vertex 0's color
        if bool((result.color == result.color[0]).all()):
            return result
        tracing.inc_counter("cluster.single_linkage.connect_rounds")
        extra = cross_component_nn(res, x, result.color, metric)
        g = COO(
            torch.cat([g.rows, extra.rows]),
            torch.cat([g.cols, extra.cols]),
            torch.cat([g.vals, extra.vals]),
            (n, n),
        )
    raise RuntimeError("single_linkage: could not connect kNN graph")


def _dendrogram(src: np.ndarray, dst: np.ndarray, n: int):
    """(children (n-1, 2), sizes (n-1,)) of merging the edges in order,
    scipy's convention: cluster ids >= n are merged clusters, id =
    n + step, and a step's pair is (smaller id, larger id). A union-find
    over the n points (union by size, path halving) keeps each root's
    cluster id."""
    parent = list(range(n))
    weight = [1] * n          # points under a root
    cluster = list(range(n))  # cluster id of each root
    children = np.empty((n - 1, 2), dtype=np.int64)
    sizes = np.empty(n - 1, dtype=np.int64)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for step, (a, b) in enumerate(zip(src.tolist(), dst.tolist())):
        ra, rb = find(a), find(b)
        ca, cb = cluster[ra], cluster[rb]
        children[step] = (ca, cb) if ca < cb else (cb, ca)
        if weight[ra] < weight[rb]:
            ra, rb = rb, ra
        parent[rb] = ra
        weight[ra] += weight[rb]
        cluster[ra] = n + step
        sizes[step] = weight[ra]
    return children, sizes


def _flat_labels(src: np.ndarray, dst: np.ndarray, n: int,
                 n_clusters: int) -> np.ndarray:
    """The flat cut: components of the first ``n - n_clusters`` merges,
    numbered in the order of their roots under the JAX package's unions
    (``parent[root(a)] = root(b)``, path halving)."""
    keep = n - 1 - (n_clusters - 1)
    parent2 = list(range(n))

    def find2(a):
        while parent2[a] != a:
            parent2[a] = parent2[parent2[a]]
            a = parent2[a]
        return a

    for a, b in zip(src[:keep].tolist(), dst[:keep].tolist()):
        ra, rb = find2(a), find2(b)
        parent2[ra] = rb
    roots = np.array([find2(i) for i in range(n)])
    _, labels = np.unique(roots, return_inverse=True)
    return labels.astype(np.int32)


def single_linkage(
    res: Optional[Resources],
    x,
    n_clusters: int,
    *,
    metric: DistanceType = DistanceType.L2SqrtExpanded,
    k: int = 15,
) -> SingleLinkageOutput:
    """Flat single-linkage clustering — ``cluster::single_linkage``
    (``single_linkage.cuh``; the reference's KNN-graph 'connectivity'
    mode with ``c``-neighborhood = k)."""
    res = ensure_resources(res)
    x = res.put(x)
    n = x.shape[0]
    expect(1 <= n_clusters <= n, "single_linkage: bad n_clusters")

    with tracing.range("raft_tpu.cluster.single_linkage"):
        result = _mst_edges_connected(res, x, k, metric)
        src = result.src.cpu().numpy()
        dst = result.dst.cpu().numpy()
        w = result.weights.cpu().numpy()
        valid = src >= 0
        src, dst, w = src[valid], dst[valid], w[valid]
        order = np.argsort(w, kind="stable")
        src, dst, w = src[order], dst[order], w[order]
        expect(len(src) == n - 1, "single_linkage: MST is not a tree")
        children, sizes = _dendrogram(src, dst, n)
        return SingleLinkageOutput(
            labels=_flat_labels(src, dst, n, n_clusters),
            children=children,
            deltas=w,
            sizes=sizes,
            n_clusters=n_clusters,
        )
