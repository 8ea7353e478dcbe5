"""Clustering (reference ``raft/cluster/``): Lloyd's k-means, balanced
k-means and single-linkage."""

from raft_tpu_torch.cluster import kmeans, kmeans_balanced
from raft_tpu_torch.cluster.kmeans import InitMethod, KMeansParams
from raft_tpu_torch.cluster.kmeans_balanced import KMeansBalancedParams
from raft_tpu_torch.cluster.single_linkage import (
    SingleLinkageOutput,
    single_linkage,
)

__all__ = [
    "kmeans",
    "kmeans_balanced",
    "KMeansParams",
    "InitMethod",
    "KMeansBalancedParams",
    "SingleLinkageOutput",
    "single_linkage",
]
