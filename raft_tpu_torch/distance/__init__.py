"""Pairwise distances (all 20 metrics), the k-means nearest-center argmin,
masked L2 nearest neighbour and gram matrices (reference
``raft/distance/``)."""

from raft_tpu_torch.distance.fused_l2_nn import (
    fused_l2_nn_argmin,
    fused_l2_nn_argmin_precomputed,
)
from raft_tpu_torch.distance.kernels import (
    KernelParams,
    KernelType,
    gram_matrix,
)
from raft_tpu_torch.distance.masked_nn import compress_to_bits, masked_l2_nn
from raft_tpu_torch.distance.pairwise import (
    pairwise_distance,
    pairwise_distance_tiled,
)
from raft_tpu_torch.distance.types import (
    EXPANDED_METRICS,
    DistanceType,
    is_min_close,
)

__all__ = [
    "DistanceType",
    "is_min_close",
    "EXPANDED_METRICS",
    "pairwise_distance",
    "pairwise_distance_tiled",
    "fused_l2_nn_argmin",
    "fused_l2_nn_argmin_precomputed",
    "compress_to_bits",
    "masked_l2_nn",
    "KernelType",
    "KernelParams",
    "gram_matrix",
]
