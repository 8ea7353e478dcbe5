"""Summary statistics — port of ``raft_tpu/stats/summary.py`` (reference
``stats/mean.cuh``, ``var.cuh``, ``stddev.cuh``, ``cov.cuh``,
``histogram.cuh``, ``minmax.cuh``, ``weighted_mean.cuh``, ``sum.cuh``,
``mean_center.cuh``). Float32 on the handle's device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.core.validation import expect


def _f32(res, data) -> torch.Tensor:
    return ensure_resources(res).put(data).to(torch.float32)


def mean(res: Optional[Resources], data, *, along_rows: bool = False):
    """Column means by default (``stats::mean`` reduces over rows of a
    column-major sample matrix; samples are rows here)."""
    axis = 1 if along_rows else 0
    return torch.mean(_f32(res, data), dim=axis)


def sum_stat(res: Optional[Resources], data, *, along_rows: bool = False):
    """``stats::sum``."""
    axis = 1 if along_rows else 0
    return torch.sum(_f32(res, data), dim=axis)


def var(res: Optional[Resources], data, mu=None, *, sample: bool = True):
    """Column variances (``stats::vars``); ``sample=True`` → N-1 norm."""
    x = _f32(res, data)
    mu = torch.mean(x, dim=0) if mu is None else _f32(res, mu)
    n = x.shape[0]
    denom = max(n - 1, 1) if sample else n
    d = x - mu[None, :]
    return torch.sum(d * d, dim=0) / denom


def stddev(res: Optional[Resources], data, mu=None, *, sample: bool = True):
    """``stats::stddev``."""
    return torch.sqrt(var(res, data, mu, sample=sample))


def meanvar(res: Optional[Resources], data, *, sample: bool = True):
    """Mean + variance (``stats/meanvar.cuh``)."""
    x = _f32(res, data)
    mu = torch.mean(x, dim=0)
    return mu, var(res, x, mu, sample=sample)


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median``: the mean of the two middle values of an even count."""
    s = torch.sort(x).values
    n = s.shape[0]
    if n % 2:
        return s[n // 2]
    return 0.5 * (s[n // 2 - 1] + s[n // 2])


def regression_metrics(res: Optional[Resources], predictions, ref):
    """Mean-absolute / mean-squared / median-absolute error
    (``stats/regression_metrics.cuh``). Returns (mae, mse, medae)."""
    p = _f32(res, predictions).reshape(-1)
    r = _f32(res, ref).reshape(-1)
    err = torch.abs(p - r)
    return torch.mean(err), torch.mean((p - r) * (p - r)), _median(err)


def mean_center(res: Optional[Resources], data, mu=None):
    """``stats::meanCenter``: subtract column means."""
    x = _f32(res, data)
    mu = torch.mean(x, dim=0) if mu is None else _f32(res, mu)
    return x - mu[None, :]


def cov(
    res: Optional[Resources],
    data,
    mu=None,
    *,
    sample: bool = True,
):
    """Covariance matrix of row-sample data — ``stats::cov``
    (``stats/cov.cuh``): one centered product, float32 sums."""
    x = mean_center(res, data, mu)
    n = x.shape[0]
    denom = max(n - 1, 1) if sample else n
    return (x.T @ x) / denom


def histogram(
    res: Optional[Resources],
    data,
    n_bins: int,
    *,
    lo: Optional[float] = None,
    hi: Optional[float] = None,
):
    """Per-column histograms — ``stats::histogram``
    (``stats/histogram.cuh``). Returns ``(n_bins, n_cols)`` int32 counts:
    one scatter-add of each entry's bin."""
    x = _f32(res, data)
    if x.ndim == 1:
        x = x[:, None]
    lo_v = torch.amin(x) if lo is None else torch.tensor(
        float(lo), device=x.device)
    hi_v = torch.amax(x) if hi is None else torch.tensor(
        float(hi), device=x.device)
    width = torch.clamp((hi_v - lo_v) / n_bins, min=1e-30)
    idx = torch.clamp(((x - lo_v) / width).to(torch.int32), 0, n_bins - 1)
    cols = x.shape[1]
    flat = (idx.to(torch.int64) * cols
            + torch.arange(cols, device=x.device)[None, :]).reshape(-1)
    counts = torch.zeros(n_bins * cols, dtype=torch.int32, device=x.device)
    counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return counts.reshape(n_bins, cols)


def minmax(
    res: Optional[Resources], data
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column (min, max) — ``stats::minmax`` (``stats/minmax.cuh``)."""
    data = ensure_resources(res).put(data)
    return torch.amin(data, dim=0), torch.amax(data, dim=0)


def weighted_mean(
    res: Optional[Resources],
    data,
    weights,
    *,
    along_rows: bool = True,
):
    """Weighted mean — ``stats::rowWeightedMean`` / ``colWeightedMean``.

    ``along_rows=True`` averages within each row with one weight per
    column (the reference's row-weighted-mean), producing one value per
    row."""
    x = _f32(res, data)
    w = _f32(res, weights)
    wsum = torch.clamp(torch.sum(w), min=1e-30)
    if along_rows:
        expect(w.shape[0] == x.shape[1], "weighted_mean: |weights| != n_cols")
        return x @ w / wsum
    expect(w.shape[0] == x.shape[0], "weighted_mean: |weights| != n_rows")
    return w @ x / wsum
