"""Spectral partitioning — port of ``raft_tpu/spectral/partition.py``
(reference ``spectral/partition.cuh``): Laplacian smallest eigenvectors
(Lanczos) → k-means on the embedding; modularity maximization
(``modularity_maximization.cuh``: largest eigenvectors of the modularity
matrix) and partition quality analysis (edge cut / ratio cut /
modularity).

The eigensolver is :func:`raft_tpu_torch.sparse.solver.lanczos_smallest`
and the clusterer :mod:`raft_tpu_torch.cluster.kmeans`. :func:`modularity`
and :func:`analyze_partition` sum over the stored edges, where the JAX
package densifies the adjacency (n² entries: 40 GB at n = 100,000);
:func:`modularity_maximization` forms the modularity matrix densely, as
the JAX package does, for the moderate n it serves.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.cluster import kmeans as _kmeans
from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.sparse.types import CSR, _segment_sum


def fit_embedding(
    res: Optional[Resources],
    adjacency: CSR,
    n_components: int,
    *,
    normalized: bool = True,
    seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spectral embedding: ``n_components`` smallest non-trivial
    Laplacian eigenpairs (drops the constant first eigenvector), the
    reference's ``sparse::spectral::fit_embedding`` path."""
    from raft_tpu_torch.sparse.linalg import laplacian
    from raft_tpu_torch.sparse.solver import lanczos_smallest

    ensure_resources(res)
    with tracing.range("raft_tpu.spectral.fit_embedding"):
        lap = laplacian(adjacency, normalized=normalized)
        evals, evecs = lanczos_smallest(res, lap, n_components + 1, seed=seed)
        return evals[1:], evecs[:, 1:]


def _row_normalized(emb: torch.Tensor) -> torch.Tensor:
    norms = torch.linalg.vector_norm(emb, dim=1, keepdim=True)
    return emb / torch.clamp(norms, min=1e-12)


def partition(
    res: Optional[Resources],
    adjacency: CSR,
    n_clusters: int,
    *,
    n_eigenvectors: Optional[int] = None,
    normalized: bool = True,
    seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Graph partition via Laplacian spectral embedding + k-means —
    ``spectral::partition`` (``partition.cuh``).

    Returns (labels, eigenvalues, eigenvectors)."""
    res = ensure_resources(res)
    k = n_eigenvectors or n_clusters
    with tracing.range("raft_tpu.spectral.partition"):
        evals, emb = fit_embedding(
            res, adjacency, k, normalized=normalized, seed=seed
        )
        # row-normalize the embedding (standard normalized spectral
        # clustering; stabilizes k-means on the eigenvector rows)
        params = _kmeans.KMeansParams(n_clusters=n_clusters, seed=seed)
        _, labels, _, _ = _kmeans.fit_predict(res, params,
                                              _row_normalized(emb))
        return labels, evals, emb


def modularity_maximization(
    res: Optional[Resources],
    adjacency: CSR,
    n_clusters: int,
    *,
    seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cluster by the top eigenvectors of the modularity matrix
    ``B = A - d d^T / 2m`` — ``spectral::modularity_maximization``: a
    dense ``eigh`` of B (exact at the moderate n this API serves; larger
    graphs should use :func:`partition`)."""
    res = ensure_resources(res)
    with tracing.range("raft_tpu.spectral.modularity_maximization"):
        a = adjacency.to_dense().to(torch.float32)
        deg = torch.sum(a, dim=1)
        two_m = torch.clamp(torch.sum(deg), min=1e-12)
        b = a - torch.outer(deg, deg) / two_m
        evals, evecs = torch.linalg.eigh(b)
        emb = evecs[:, -n_clusters:]
        params = _kmeans.KMeansParams(n_clusters=n_clusters, seed=seed)
        _, labels, _, _ = _kmeans.fit_predict(res, params,
                                              _row_normalized(emb))
        return labels, evals[-n_clusters:], emb


def _edges(adjacency: CSR):
    """(row, col, weight) of the stored entries, padding weighing 0."""
    r = adjacency.row_ids()
    valid = r >= 0
    w = torch.where(valid, adjacency.data.to(torch.float32),
                    torch.zeros((), dtype=torch.float32,
                                device=adjacency.device))
    return (r.clamp(min=0).to(torch.int64),
            adjacency.indices.to(torch.int64), w)


def modularity(res: Optional[Resources], adjacency: CSR,
               labels) -> torch.Tensor:
    """Modularity Q of a partition — the quantity
    ``spectral::analyzeModularity`` reports:
    ``Q = (Σ_{same class} a_ij − Σ_c D_c² / 2m) / 2m`` with ``D_c`` the
    degree sum of class c."""
    res = ensure_resources(res)
    labels = res.put(labels)
    r, c, w = _edges(adjacency)
    _, cls = torch.unique(labels, return_inverse=True)
    n_cls = int(cls.max()) + 1 if cls.numel() else 1
    deg = _segment_sum(w, r, adjacency.shape[0])
    two_m = torch.clamp(torch.sum(deg), min=1e-12)
    inside = torch.sum(torch.where(cls[r] == cls[c], w,
                                   torch.zeros_like(w)))
    dc = _segment_sum(deg, cls, n_cls)
    return (inside - torch.sum(dc * dc) / two_m) / two_m


def analyze_partition(
    res: Optional[Resources],
    adjacency: CSR,
    labels,
    n_clusters: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(edge cut, ratio cut cost) of a partition —
    ``spectral::analyzePartition`` (``partition.cuh``). Labels outside
    ``[0, n_clusters)`` belong to no class's size or cut."""
    res = ensure_resources(res)
    labels = res.put(labels).to(torch.int64)
    k = n_clusters or int(labels.max()) + 1
    r, c, w = _edges(adjacency)
    cross = labels[r] != labels[c]
    wc = torch.where(cross, w, torch.zeros_like(w))
    edge_cut = torch.sum(wc) / 2.0
    ok = (labels >= 0) & (labels < k)
    sizes = torch.bincount(torch.where(ok, labels, k),
                           minlength=k + 1)[:k].to(torch.float32)
    # ratio cut: sum_c cut(c, rest) / |c|, each cut edge counted at the
    # class of its column
    lc = labels[c]
    okc = (lc >= 0) & (lc < k)
    per_cluster_cut = _segment_sum(torch.where(okc, wc, torch.zeros_like(wc)),
                                   torch.where(okc, lc, 0), k) / 2.0
    cost = torch.sum(torch.where(
        sizes > 0, 2.0 * per_cluster_cut / torch.clamp(sizes, min=1.0),
        torch.zeros_like(sizes)))
    return edge_cut, cost
