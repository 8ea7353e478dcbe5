"""Distributed algorithms — port of ``raft_tpu/distributed``, the
consumer side of :mod:`raft_tpu_torch.comms` (the reference's raft-dask
MNMG layer).

Two composition patterns, as in the JAX package:

- **SPMD over a mesh of shard slots**: distributed k-means (all-reduced
  M-step), distributed brute-force kNN (per-shard top-k + all-gather
  merge), and the list-sharded IVF-Flat / IVF-PQ / IVF-BQ indexes.
- **index per shard** (host orchestration): any single-device ANN index
  built per shard and merged at query time (:mod:`.sharded_ann`).
"""

from raft_tpu_torch.distributed import bq as ivf_bq
from raft_tpu_torch.distributed import checkpoint
from raft_tpu_torch.distributed import ivf as ivf_flat
from raft_tpu_torch.distributed.bq import DistributedIvfBq
from raft_tpu_torch.distributed.ivf import DistributedIvfFlat, DistributedIvfPq
from raft_tpu_torch.distributed.kmeans import fit as kmeans_fit
from raft_tpu_torch.distributed.knn import brute_force_knn, brute_force_knn_ring
from raft_tpu_torch.distributed.sharded_ann import ShardedIndex, build_sharded

__all__ = [
    "DistributedIvfBq",
    "DistributedIvfFlat",
    "DistributedIvfPq",
    "checkpoint",
    "ivf_bq",
    "ivf_flat",
    "kmeans_fit",
    "brute_force_knn",
    "brute_force_knn_ring",
    "ShardedIndex",
    "build_sharded",
]
