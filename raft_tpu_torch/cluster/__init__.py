"""Clustering (reference ``raft/cluster/``): Lloyd's k-means and balanced
k-means."""

from raft_tpu_torch.cluster import kmeans, kmeans_balanced
from raft_tpu_torch.cluster.kmeans import InitMethod, KMeansParams
from raft_tpu_torch.cluster.kmeans_balanced import KMeansBalancedParams

__all__ = [
    "kmeans",
    "kmeans_balanced",
    "KMeansParams",
    "InitMethod",
    "KMeansBalancedParams",
]
