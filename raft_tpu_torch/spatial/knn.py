"""Deprecated forwarding names of the pre-``neighbors`` API
(``raft/spatial/knn/knn.cuh``), as the JAX package keeps them: brute
force, ball cover and int8 quantized kNN. New code imports
:mod:`raft_tpu_torch.neighbors`."""

import warnings

from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors.ball_cover import (  # noqa: F401
    BallCoverIndex,
    build_index as ball_cover_build_index,
    knn_query as ball_cover_knn_query,
)
from raft_tpu_torch.neighbors.brute_force import knn as _bf_knn
from raft_tpu_torch.neighbors.quantized import (  # noqa: F401
    knn as ann_quantized_knn,
)


def brute_force_knn(res, dataset, queries, k, metric=None, metric_arg=2.0):
    """``spatial::knn::brute_force_knn`` -> ``neighbors.brute_force.knn``."""
    warnings.warn("raft_tpu_torch.spatial.knn is deprecated; use "
                  "raft_tpu_torch.neighbors", DeprecationWarning,
                  stacklevel=2)
    metric = DistanceType.L2Expanded if metric is None else metric
    return _bf_knn(res, dataset, queries, k, metric, metric_arg)


knn = brute_force_knn
