"""Balanced k-means — analog of ``raft::cluster::kmeans_balanced``
(``cluster/kmeans_balanced.cuh:76``), the trainer behind the IVF coarse
quantizer. Port of ``raft_tpu/cluster/kmeans_balanced.py``.

EM iterations: predict -> recompute centers -> (from the second
iteration on) the balancing step ``_adjust_centers``, which pulls every
cluster smaller than ``average * 0.25`` toward one random point drawn
from rows of at-least-average clusters, with weight ``min(size, 7)``
against 1 (``detail/kmeans_balanced.cuh:438-483``). InnerProduct-family
metrics normalize the centers every iteration.

The random draws come from a ``torch.Generator`` seeded with
``params.seed`` on the data's device (the JAX package makes
``jax.random.key(params.seed)``): the two packages draw different
numbers from the same seed, so their centers agree in quality (inertia),
not bit for bit. Two fits from one seed on one device are equal: the
center sums and the balancing step's weighted draw take a fixed order
(:func:`segment_sum`, :func:`_weighted_draw`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn_argmin_precomputed
from raft_tpu_torch.distance.types import DistanceType

_ADJUST_CENTERS_WEIGHT = 7.0  # kAdjustCentersWeight
_BALANCING_THRESHOLD = 0.25   # default balancing_threshold
_ROW_BLOCK_ELEMS = 1 << 26    # (rows x n_clusters) floats per IP block
_DRAW_SCALE = 1_000_000       # 1 / the 1e-6 weight of a row in a small cluster

_NORMALIZED_METRICS = (
    DistanceType.InnerProduct,
    DistanceType.CosineExpanded,
    DistanceType.CorrelationExpanded,
)


@dataclasses.dataclass(frozen=True)
class KMeansBalancedParams:
    """Mirrors ``raft::cluster::kmeans_balanced_params``."""

    n_iters: int = 20
    metric: DistanceType = DistanceType.L2Expanded
    seed: int = 0


def _predict_impl(x: torch.Tensor, centroids: torch.Tensor,
                  metric: DistanceType) -> torch.Tensor:
    """Nearest center under L2 or (normalized-center) inner product;
    ties go to the first center."""
    if metric in _NORMALIZED_METRICS:
        rows = max(1, _ROW_BLOCK_ELEMS // max(1, centroids.shape[0]))
        return torch.cat([
            torch.argmax(x[s : s + rows] @ centroids.T, dim=1)
            for s in range(0, x.shape[0], rows)]).to(torch.int32)
    c_sq = (centroids * centroids).sum(dim=1)
    _, labels = fused_l2_nn_argmin_precomputed(x, centroids, c_sq)
    return labels


def segment_sum(x: torch.Tensor, labels: torch.Tensor,
                n_segments: int) -> torch.Tensor:
    """(n_segments, d) row sums of ``x`` by label, each taken in row order
    (``jax.ops.segment_sum``'s). Rows are stably sorted by label, then
    each segment is summed serially: a fixed order on every device, where
    a float ``index_add_`` on CUDA adds through atomics in no fixed order
    and two builds from one seed would differ."""
    lab = labels.to(torch.int64)
    order = torch.argsort(lab, stable=True)
    lengths = torch.bincount(lab, minlength=n_segments)
    return torch.segment_reduce(x[order], "sum", lengths=lengths, axis=0,
                                unsafe=True)


def _calc_centers_and_sizes(x: torch.Tensor, labels: torch.Tensor,
                            n_clusters: int):
    sums = segment_sum(x, labels, n_clusters)
    # exact integer counts in float32
    sizes = torch.bincount(labels.to(torch.int64),
                           minlength=n_clusters).to(x.dtype)
    centers = sums / torch.clamp(sizes, min=1.0)[:, None]
    return centers, sizes


def _normalize_rows(c: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.norm(c, dim=1, keepdim=True)
    return c / torch.clamp(n, min=1e-12)


def draw_by_weight(gen: torch.Generator, w: torch.Tensor,
                   count: int) -> torch.Tensor:
    """``count`` row indices drawn with replacement, row i with
    probability ``w[i] / sum(w)`` for int64 weights ``w`` (their sum
    positive and at most 2^53, exact in float64). Their running sum is an
    integer scan and each draw a search in it, so the draws depend on the
    generator alone. (``torch.multinomial`` on CUDA scans float weights in
    no fixed order: two fits from one seed drew other rows.)"""
    cum = torch.cumsum(w, 0)
    u = torch.rand((count,), generator=gen, device=w.device,
                   dtype=torch.float64)
    target = torch.floor(u * cum[-1].to(torch.float64)).to(torch.int64)
    return torch.searchsorted(cum, target, right=True)


def _weighted_draw(gen: torch.Generator, big: torch.Tensor,
                   count: int) -> torch.Tensor:
    """:func:`draw_by_weight` with a row with ``big`` set (1 + 1e-6) /
    1e-6 times as likely as one without: the weights of
    ``_adjust_centers`` scaled by 1e6 to exact integers."""
    w = torch.where(big, _DRAW_SCALE + 1, 1).to(torch.int64)
    return draw_by_weight(gen, w, count)


def _adjust_centers(gen: torch.Generator, centers, sizes, x, labels,
                    n_clusters: int):
    """Vectorized balancing step (``adjust_centers_kernel``): one
    candidate point per cluster, drawn with weight 1 from rows whose own
    cluster is at least average-sized (1e-6 otherwise)."""
    n = x.shape[0]
    average = n / n_clusters
    small = sizes < average * _BALANCING_THRESHOLD
    cand = _weighted_draw(gen, sizes[labels.to(torch.int64)] >= average,
                          n_clusters)
    points = x[cand]
    wc = torch.clamp(sizes, max=_ADJUST_CENTERS_WEIGHT)[:, None]
    pulled = (wc * centers + points) / (wc + 1.0)
    return torch.where(small[:, None], pulled, centers)


def _fit_impl(x: torch.Tensor, seed: int, n_clusters: int, n_iters: int,
              metric: DistanceType):
    n = x.shape[0]
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    # init: a uniform subsample of the rows, without replacement
    idx = torch.randperm(n, generator=gen, device=x.device)[:n_clusters]
    centers = x[idx]
    if metric in _NORMALIZED_METRICS:
        centers = _normalize_rows(centers)
    sizes = x.new_zeros((n_clusters,))
    labels = torch.zeros((n,), dtype=torch.int32, device=x.device)
    for it in range(n_iters):
        if it > 0:
            centers = _adjust_centers(gen, centers, sizes, x, labels,
                                      n_clusters)
        if metric in _NORMALIZED_METRICS:
            centers = _normalize_rows(centers)
        labels = _predict_impl(x, centers, metric)
        new_centers, sizes = _calc_centers_and_sizes(x, labels, n_clusters)
        centers = torch.where((sizes > 0)[:, None], new_centers, centers)
    if metric in _NORMALIZED_METRICS:
        centers = _normalize_rows(centers)
    return centers, labels, sizes


def fit(res: Optional[Resources], params: KMeansBalancedParams, x,
        n_clusters: int) -> torch.Tensor:
    """Train balanced k-means; returns centroids (n_clusters, d) float32
    on the handle's device."""
    res = ensure_resources(res)
    x = res.put(x, torch.float32)
    expect(x.ndim == 2, "x must be 2-D")
    expect(n_clusters <= x.shape[0], "n_clusters > n_samples")
    with tracing.range("raft_tpu.kmeans_balanced.fit"):
        centers, _, _ = _fit_impl(x, params.seed, n_clusters,
                                  params.n_iters, DistanceType(params.metric))
    return centers


def predict(res: Optional[Resources], params: KMeansBalancedParams,
            centroids, x) -> torch.Tensor:
    """Label each row with its nearest centroid (int32)."""
    res = ensure_resources(res)
    x = res.put(x, torch.float32)
    centroids = res.put(centroids, torch.float32)
    with tracing.range("raft_tpu.kmeans_balanced.predict"):
        return _predict_impl(x, centroids, DistanceType(params.metric))


def fit_predict(res, params: KMeansBalancedParams, x, n_clusters: int):
    centroids = fit(res, params, x, n_clusters)
    return centroids, predict(res, params, centroids, x)


def build_clusters(res: Optional[Resources], params: KMeansBalancedParams,
                   x, n_clusters: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train + label + sizes in one call — the IVF build entry
    (``kmeans_balanced::helpers::build_clusters``)."""
    res = ensure_resources(res)
    x = res.put(x, torch.float32)
    centers, labels, sizes = _fit_impl(x, params.seed, n_clusters,
                                       params.n_iters,
                                       DistanceType(params.metric))
    return centers, labels, sizes.to(torch.int32)


def calc_centers_and_sizes(x, labels, n_clusters: int):
    """``kmeans_balanced::helpers::calc_centers_and_sizes``: per-cluster
    means (float32) and populations (int32)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    labels = torch.as_tensor(labels, device=x.device)
    centers, sizes = _calc_centers_and_sizes(x, labels, n_clusters)
    return centers, sizes.to(torch.int32)
