"""Lloyd's k-means — port of ``raft_tpu/cluster/kmeans.py`` (reference
``cluster/kmeans.cuh:88``): fit, predict, fit_predict, transform,
cluster_cost, update_centroids and find_k, with k-means++, random or
given initial centers and convergence on the change of inertia.

The E-step is :func:`~raft_tpu_torch.distance.fused_l2_nn.
fused_l2_nn_argmin_precomputed` (ties to the first center), the M-step
the fixed-order :func:`~raft_tpu_torch.cluster.kmeans_balanced.
segment_sum`, and every k-means++ draw :func:`~raft_tpu_torch.cluster.
kmeans_balanced.draw_by_weight` over integer weights: two fits from one
seed on one device are equal. The draws come from a ``torch.Generator``
seeded with ``params.seed``, so the port and the JAX package seed from
other rows; given the same initial centers (``InitMethod.Array``) they
take the same steps.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Tuple

import torch

from raft_tpu_torch.cluster.kmeans_balanced import draw_by_weight, segment_sum
from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn_argmin_precomputed
from raft_tpu_torch.distance.pairwise import pairwise_distance
from raft_tpu_torch.distance.types import DistanceType

_F32_MAX = torch.finfo(torch.float32).max


class InitMethod(enum.IntEnum):
    """Mirrors ``kmeans_params::InitMethod``."""

    KMeansPlusPlus = 0
    Random = 1
    Array = 2


@dataclasses.dataclass(frozen=True)
class KMeansParams:
    """Mirrors ``raft::cluster::kmeans::KMeansParams``."""

    n_clusters: int = 8
    init: InitMethod = InitMethod.KMeansPlusPlus
    max_iter: int = 300
    tol: float = 1e-4
    metric: DistanceType = DistanceType.L2Expanded
    seed: int = 0
    oversampling_factor: float = 2.0  # kept for API parity (|| init)
    batch_samples: int = 1 << 15      # kept for API parity
    wire_dtype: str = "f32"           # the JAX package's distributed fit's


def _check_metric(params: KMeansParams) -> None:
    expect(params.metric in (DistanceType.L2Expanded,
                             DistanceType.L2SqrtExpanded),
           f"kmeans supports L2Expanded/L2SqrtExpanded, got "
           f"{params.metric!r}")


def _predict_labels(x: torch.Tensor, centroids: torch.Tensor):
    """E-step: (squared distance, label) of each row's nearest center."""
    return fused_l2_nn_argmin_precomputed(
        x, centroids, (centroids * centroids).sum(dim=1))


def _calc_centers_and_sizes(x, labels, n_clusters: int):
    """M-step: per-cluster means and populations (float32)."""
    sums = segment_sum(x, labels, n_clusters)
    sizes = torch.bincount(labels.to(torch.int64),
                           minlength=n_clusters).to(torch.float32)
    return sums / torch.clamp(sizes, min=1.0)[:, None], sizes


def _draw(gen: torch.Generator, w: torch.Tensor, count: int) -> torch.Tensor:
    """``count`` rows drawn with probability proportional to the float
    weights ``w`` (all positive), through integer weights ``w / max(w)``
    scaled to a sum of at most 2^52 (a row below that resolution is not
    drawn)."""
    bits = 52 - max(1, math.ceil(math.log2(w.shape[0])))
    wi = torch.floor(w.to(torch.float64) / w.max().to(torch.float64)
                     * float(1 << bits)).to(torch.int64)
    return draw_by_weight(gen, wi, count)


def _kmeanspp_init(gen: torch.Generator, x: torch.Tensor, n_clusters: int):
    """Greedy k-means++ (``detail/kmeans.cuh`` kmeansPlusPlus): each step
    draws ``2 + ceil(log k)`` candidates in proportion to the current
    squared distance to the nearest center and keeps the one that leaves
    the least total potential."""
    n = x.shape[0]
    n_trials = 2 + int(math.ceil(math.log(max(n_clusters, 2))))
    first = torch.randint(0, n, (1,), generator=gen, device=x.device)
    centers = x.new_zeros((n_clusters, x.shape[1]))
    centers[0] = x[first[0]]
    min_d = torch.square(x - x[first]).sum(dim=1)
    x_sq = (x * x).sum(dim=1)
    for i in range(1, n_clusters):
        cand = _draw(gen, torch.clamp(min_d, min=1e-30), n_trials)
        pts = x[cand]                                        # (L, d)
        d_cand = (x_sq[None, :] - 2.0 * (pts @ x.T)
                  + (pts * pts).sum(dim=1)[:, None])         # (L, n)
        pot = torch.minimum(min_d[None, :], d_cand).sum(dim=1)
        best = torch.argmin(pot)
        centers[i] = pts[best]
        min_d = torch.minimum(min_d, d_cand[best])
    return centers


def _initial_centers(gen, x, params: KMeansParams, init_centroids):
    if params.init == InitMethod.Array:
        expect(init_centroids is not None,
               "InitMethod.Array needs init_centroids")
        c = torch.as_tensor(init_centroids).to(device=x.device,
                                               dtype=torch.float32)
        expect(tuple(c.shape) == (params.n_clusters, x.shape[1]),
               "init_centroids must be (n_clusters, n_features)")
        return c.clone()
    if params.init == InitMethod.Random:
        return x[torch.randperm(x.shape[0], generator=gen,
                                device=x.device)[:params.n_clusters]]
    return _kmeanspp_init(gen, x, params.n_clusters)


def _fit_impl(x: torch.Tensor, params: KMeansParams, init_centroids=None):
    """Lloyd's iterations from the initial centers while fewer than
    ``max_iter`` were taken and the relative change of inertia is above
    ``tol`` (the JAX package's ``while_loop``, its sentinels included);
    then a last E-step. Returns (centroids, labels, inertia, n_iter)."""
    gen = torch.Generator(device=x.device)
    gen.manual_seed(params.seed)
    centroids = _initial_centers(gen, x, params, init_centroids)
    tol = torch.tensor(params.tol, dtype=torch.float32)
    prev = torch.tensor(_F32_MAX, dtype=torch.float32)
    inertia = torch.tensor(_F32_MAX / 4, dtype=torch.float32)
    it = 0
    while it < params.max_iter and bool(
            torch.abs(prev - inertia) / torch.clamp(prev, min=1e-30) > tol):
        dist, labels = _predict_labels(x, centroids)
        prev, inertia = inertia, dist.sum().cpu()
        new, sizes = _calc_centers_and_sizes(x, labels, params.n_clusters)
        centroids = torch.where((sizes > 0)[:, None], new, centroids)
        it += 1
    dist, labels = _predict_labels(x, centroids)
    return centroids, labels, dist.sum(), it


def _rows(res: Resources, x) -> torch.Tensor:
    x = res.put(x, torch.float32)
    expect(x.ndim == 2, "x must be (n_samples, n_features)")
    return x


def fit(res: Optional[Resources], params: KMeansParams, x,
        init_centroids=None) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Train k-means (``kmeans::fit``): ``(centroids (k, d) float32,
    inertia (0-d float32), n_iter)``."""
    res = ensure_resources(res)
    x = _rows(res, x)
    expect(params.n_clusters <= x.shape[0], "n_clusters > n_samples")
    _check_metric(params)
    with tracing.range("raft_tpu.kmeans.fit"):
        centroids, _, inertia, n_iter = _fit_impl(x, params, init_centroids)
    return centroids, inertia, n_iter


def predict(res: Optional[Resources], params: KMeansParams, centroids,
            x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's nearest centroid: ``(labels (n,) int32, inertia)``."""
    res = ensure_resources(res)
    _check_metric(params)
    dist, labels = _predict_labels(_rows(res, x),
                                   res.put(centroids, torch.float32))
    return labels, dist.sum()


def fit_predict(res: Optional[Resources], params: KMeansParams, x,
                init_centroids=None):
    """Train and label in one pass, with the labels of fit's last E-step:
    ``(centroids, labels, inertia, n_iter)``."""
    res = ensure_resources(res)
    x = _rows(res, x)
    expect(params.n_clusters <= x.shape[0], "n_clusters > n_samples")
    _check_metric(params)
    with tracing.range("raft_tpu.kmeans.fit_predict"):
        return _fit_impl(x, params, init_centroids)


def transform(res: Optional[Resources], params: KMeansParams, centroids,
              x) -> torch.Tensor:
    """Distance from every row to every centroid (``kmeans::transform``),
    in ``params.metric``."""
    res = ensure_resources(res)
    return pairwise_distance(res, res.put(x, torch.float32),
                             res.put(centroids, torch.float32),
                             params.metric)


def cluster_cost(res: Optional[Resources], centroids, x) -> torch.Tensor:
    """Sum of squared distances to the nearest centroid."""
    res = ensure_resources(res)
    dist, _ = _predict_labels(_rows(res, x),
                              res.put(centroids, torch.float32))
    return dist.sum()


def update_centroids(res: Optional[Resources], x, centroids,
                     sample_weights=None):
    """One M-step (``compute_new_centroids``): label each row with its
    nearest centroid and return the (weighted) per-cluster means, an
    empty cluster keeping its centroid: ``(new_centroids, labels)``."""
    res = ensure_resources(res)
    x = _rows(res, x)
    centroids = res.put(centroids, torch.float32)
    k = centroids.shape[0]
    _, labels = _predict_labels(x, centroids)
    if sample_weights is None:
        means, sizes = _calc_centers_and_sizes(x, labels, k)
        return torch.where((sizes > 0)[:, None], means, centroids), labels
    w = res.put(sample_weights, torch.float32)
    sums = segment_sum(x * w[:, None], labels, k)
    wsum = segment_sum(w[:, None], labels, k)[:, 0]
    new = torch.where((wsum > 0)[:, None],
                      sums / torch.clamp(wsum, min=1e-30)[:, None], centroids)
    return new, labels


def find_k(res: Optional[Resources], x, k_max: int = 20, k_min: int = 2,
           max_iter: int = 100) -> Tuple[int, Optional[torch.Tensor]]:
    """Choose k (the role of ``detail/kmeans_auto_find_k.cuh``) by the
    Sugar-James jump method on distortion ``d_k = inertia / (n dim)``: the
    k with the largest ``d_k^(-dim/2) - d_{k-1}^(-dim/2)``. Returns
    ``(k, its inertia)``."""
    res = ensure_resources(res)
    x = _rows(res, x)
    n, dim = x.shape
    power = -dim / 2.0
    prev_t = None
    best_k, best_jump, best_inertia = k_min, -float("inf"), None
    for k in range(max(1, k_min - 1), k_max + 1):
        params = KMeansParams(n_clusters=k, max_iter=max_iter, seed=res.seed)
        _, inertia, _ = fit(res, params, x)
        t = max(float(inertia) / (n * dim), 1e-30) ** power
        if prev_t is not None and k >= k_min and t - prev_t > best_jump:
            best_k, best_jump, best_inertia = k, t - prev_t, inertia
        prev_t = t
    return best_k, best_inertia
