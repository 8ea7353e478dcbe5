"""Spectral clustering & graph partitioning — port of
``raft_tpu/spectral`` (reference ``raft/spectral/``: ``partition.cuh``,
``modularity_maximization.cuh``, ``eigen_solvers.cuh``,
``cluster_solvers.cuh``).
"""

from raft_tpu_torch.spectral.partition import (
    analyze_partition,
    fit_embedding,
    modularity,
    modularity_maximization,
    partition,
)

__all__ = [
    "analyze_partition",
    "fit_embedding",
    "modularity",
    "modularity_maximization",
    "partition",
]
