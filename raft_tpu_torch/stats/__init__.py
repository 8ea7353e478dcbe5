"""Statistics — port of ``raft_tpu/stats`` (reference ``raft/stats/``):
summary statistics plus ML evaluation metrics, each a PyTorch expression
on the handle's device with the reference's free-function API shape.
"""

from raft_tpu_torch.stats.summary import (
    cov,
    histogram,
    mean,
    mean_center,
    meanvar,
    minmax,
    regression_metrics,
    stddev,
    sum_stat,
    var,
    weighted_mean,
)
from raft_tpu_torch.stats.metrics import (
    accuracy,
    adjusted_rand_index,
    completeness_score,
    contingency_matrix,
    dispersion,
    entropy,
    homogeneity_score,
    information_criterion,
    kl_divergence,
    mutual_info_score,
    r2_score,
    rand_index,
    silhouette_score,
    trustworthiness,
    v_measure,
)

__all__ = [
    "cov",
    "histogram",
    "mean",
    "mean_center",
    "minmax",
    "stddev",
    "sum_stat",
    "var",
    "weighted_mean",
    "accuracy",
    "adjusted_rand_index",
    "completeness_score",
    "contingency_matrix",
    "dispersion",
    "entropy",
    "homogeneity_score",
    "information_criterion",
    "kl_divergence",
    "mutual_info_score",
    "r2_score",
    "rand_index",
    "silhouette_score",
    "trustworthiness",
    "trustworthiness_score",
    "v_measure",
    "meanvar",
    "regression_metrics",
]

# reference naming alias (``stats::trustworthiness_score``)
trustworthiness_score = trustworthiness
