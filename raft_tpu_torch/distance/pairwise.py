"""Pairwise distance matrices — port of ``raft_tpu/distance/pairwise.py``
(reference ``distance/detail/pairwise_matrix/`` with the per-metric
``distance_ops/``), all 20 metrics of :class:`DistanceType`.

Two families, as in the JAX package, which runs no Pallas kernel here:

- **expanded** metrics: one product (:func:`matmul`, at the handle's
  ``matmul_precision``) and an epilog over row norms or sums, the
  reference's ``core = x*y`` + ``epilog`` split;
- **unexpanded** metrics (L1, Linf, Canberra, ...): a broadcast-reduce
  over ``(rows, cols, d)`` blocks, cut so that one block holds at most
  the handle's ``workspace_limit_bytes`` (:func:`_pairwise_reduce`).

Numerical behaviours kept from the reference: the L2-expanded
``|val| >= 1e-4`` rectifier and clamp at 0, the zero-denominator guards
of Canberra, KL, JensenShannon, Jaccard, Dice and BrayCurtis, Hellinger's
rectify, Hamming's and RusselRao's 1/k, Haversine's 2-D check and Lp's
``p > 0``.
"""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.distance.types import DistanceType

_EPS_L2_CLAMP = 1e-4   # the |val| >= 0.0001 rectifier of the l2_exp epilog

#: ``matmul_precision`` values: full float32, or one bfloat16 pass
_FULL_PRECISION = ("highest", "float32", "default")
_PRECISIONS = _FULL_PRECISION + ("bfloat16",)


def matmul(x: torch.Tensor, y: torch.Tensor,
           precision: str = "highest") -> torch.Tensor:
    """(m, n) float32 ``x @ y.T``, the core of every expanded metric.
    ``"highest"`` (also ``"float32"`` and ``"default"``) is a full float32
    product: PyTorch's float32 matmul takes no TF32 unless the process
    turns it on. ``"bfloat16"`` rounds the operands to bfloat16 first;
    their products are exact in float32, so this is one bfloat16 pass
    with float32 sums."""
    expect(precision in _PRECISIONS,
           f"matmul_precision must be one of {_PRECISIONS}, got "
           f"{precision!r}")
    xf = x.to(torch.float32)
    yf = y.to(torch.float32)
    if precision == "bfloat16":
        xf = xf.to(torch.bfloat16).to(torch.float32)
        yf = yf.to(torch.bfloat16).to(torch.float32)
    return xf @ yf.T


def _sq_norms(x: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    return (xf * xf).sum(dim=1)


def _safe_div(num, den):
    """``num / den`` where ``den != 0``, else 0 (the reference's guard)."""
    ok = den != 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def _xlogy_guarded(a):
    """``a * log(a)`` with 0 where ``a == 0``."""
    zero = a == 0
    return torch.where(zero, torch.zeros_like(a),
                       a * torch.log(torch.where(zero, torch.ones_like(a), a)))


def _log_guarded(a):
    """``log(a)`` with 0 where ``a == 0``."""
    zero = a == 0
    return torch.where(zero, torch.zeros_like(a),
                       torch.log(torch.where(zero, torch.ones_like(a), a)))


# ---------------------------------------------------------------------------
# expanded family: one product + an epilog (reference distance_ops/*.cuh)
# ---------------------------------------------------------------------------


def _l2_expanded(x, y, sqrt: bool, precision):
    """``l2_exp.cuh``: xn + yn - 2 ip, zeroed where |val| < 1e-4, clamped."""
    ip = matmul(x, y, precision)
    val = _sq_norms(x)[:, None] + _sq_norms(y)[None, :] - 2.0 * ip
    val = val * (torch.abs(val) >= _EPS_L2_CLAMP)
    val = torch.clamp(val, min=0.0)
    return torch.sqrt(val) if sqrt else val


def _cosine(x, y, precision):
    """``cosine.cuh``: 1 - ip / (|x| |y|)."""
    ip = matmul(x, y, precision)
    xn = torch.sqrt(_sq_norms(x))[:, None]
    yn = torch.sqrt(_sq_norms(y))[None, :]
    return 1.0 - ip / (xn * yn)


def _correlation(x, y, precision):
    """``correlation.cuh``: 1 - Pearson's r from expanded sums."""
    k = x.shape[1]
    ip = matmul(x, y, precision)
    sx = x.to(torch.float32).sum(dim=1)[:, None]
    sy = y.to(torch.float32).sum(dim=1)[None, :]
    sx2 = _sq_norms(x)[:, None]
    sy2 = _sq_norms(y)[None, :]
    numer = k * ip - sx * sy
    q_denom = k * sx2 - sx * sx
    r_denom = k * sy2 - sy * sy
    return 1.0 - numer / torch.sqrt(q_denom * r_denom)


def _hellinger(x, y, precision):
    """``hellinger.cuh``: inputs square-rooted, then sqrt(rectify(1 - ip))."""
    ip = matmul(torch.sqrt(x.to(torch.float32)),
                torch.sqrt(y.to(torch.float32)), precision)
    return torch.sqrt(torch.clamp(1.0 - ip, min=0.0))


def _russel_rao(x, y, precision):
    """``russel_rao.cuh``: (k - ip) / k over binary data."""
    k = x.shape[1]
    return (k - matmul(x, y, precision)) * (1.0 / k)


def _jaccard(x, y, precision):
    """Expanded Jaccard: 1 - ip / (|x|^2 + |y|^2 - ip), 0 over 0 -> 1."""
    ip = matmul(x, y, precision)
    denom = _sq_norms(x)[:, None] + _sq_norms(y)[None, :] - ip
    return 1.0 - _safe_div(ip, denom)


def _dice(x, y, precision):
    """Expanded Dice-Sørensen: 1 - 2 ip / (|x|^2 + |y|^2)."""
    ip = matmul(x, y, precision)
    denom = _sq_norms(x)[:, None] + _sq_norms(y)[None, :]
    return 1.0 - _safe_div(2.0 * ip, denom)


def _kl_divergence(x, y, precision):
    """``kl_divergence.cuh``: sum x (log x - log y) as
    ``sum x log x - x @ log(y)^T``, with log 0 taken as 0 on both sides."""
    xf = x.to(torch.float32)
    xlogx = _xlogy_guarded(xf).sum(dim=1)
    cross = matmul(xf, _log_guarded(y.to(torch.float32)), precision)
    return xlogx[:, None] - cross


# ---------------------------------------------------------------------------
# unexpanded family: broadcast-reduce over bounded blocks
# ---------------------------------------------------------------------------


def _pairwise_reduce(x, y, elem_fn, workspace_bytes: int, reduce="sum"):
    """``reduce(elem_fn(x_i, y_j))`` over the features of every pair, in
    ``(rows, cols, d)`` float32 blocks of at most ``workspace_bytes``."""
    xf = x.to(torch.float32)
    yf = y.to(torch.float32)
    m, n, d = xf.shape[0], yf.shape[0], max(1, xf.shape[1])
    budget = max(1, workspace_bytes // 4)
    cols = min(n, max(1, budget // d)) if n else 0
    rows = max(1, budget // (max(cols, 1) * d))
    out = xf.new_empty((m, n))
    for r0 in range(0, m, rows):
        a = xf[r0:r0 + rows, None, :]
        for c0 in range(0, n, cols):
            e = elem_fn(a, yf[None, c0:c0 + cols, :])
            out[r0:r0 + rows, c0:c0 + cols] = (
                e.sum(dim=2) if reduce == "sum" else e.amax(dim=2))
    return out


def _abs_diff(a, b):
    return (a - b).abs_()


def _sq_diff(a, b):
    return (a - b).square_()


def _canberra_elem(a, b):
    return _safe_div((a - b).abs_(), a.abs() + b.abs())


def _jensen_shannon_elem(a, b):
    m = 0.5 * (a + b)
    log_m = _log_guarded(m)
    ax = torch.where(a == 0, torch.zeros_like(m), a * (_log_guarded(a) - log_m))
    bx = torch.where(b == 0, torch.zeros_like(m), b * (_log_guarded(b) - log_m))
    return ax + bx


def _ne(a, b):
    return (a != b).to(torch.float32)


def haversine_formula(x1, x2, y1, y2):
    """Great-circle distance between (lat, lon) radians ``(x1, x2)`` and
    ``(y1, y2)``, broadcast (``spatial/knn/detail/haversine_distance.cuh:
    33``)."""
    sin_lat = torch.sin(0.5 * (x1 - y1))
    sin_lon = torch.sin(0.5 * (x2 - y2))
    a = sin_lat ** 2 + torch.cos(x1) * torch.cos(y1) * sin_lon ** 2
    return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))


def _haversine(x, y):
    expect(x.shape[1] == 2, "Haversine requires 2-D (lat, lon) inputs")
    xf = x.to(torch.float32)
    yf = y.to(torch.float32)
    return haversine_formula(xf[:, 0][:, None], xf[:, 1][:, None],
                             yf[:, 0][None, :], yf[:, 1][None, :])


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def _pairwise_distance_impl(x, y, metric: DistanceType, metric_arg: float,
                            precision: str = "highest",
                            workspace_bytes: int = 2 * 1024**3):
    """(m, n) float32 distances of ``metric`` between the rows of ``x`` and
    ``y``: the body that brute force, ball cover and the epsilon
    neighbourhood share."""
    m = DistanceType(int(metric))
    ws = workspace_bytes
    if m == DistanceType.L2Expanded:
        return _l2_expanded(x, y, False, precision)
    if m == DistanceType.L2SqrtExpanded:
        return _l2_expanded(x, y, True, precision)
    if m == DistanceType.CosineExpanded:
        return _cosine(x, y, precision)
    if m == DistanceType.InnerProduct:
        return matmul(x, y, precision)
    if m == DistanceType.CorrelationExpanded:
        return _correlation(x, y, precision)
    if m == DistanceType.HellingerExpanded:
        return _hellinger(x, y, precision)
    if m == DistanceType.RusselRaoExpanded:
        return _russel_rao(x, y, precision)
    if m == DistanceType.JaccardExpanded:
        return _jaccard(x, y, precision)
    if m == DistanceType.DiceExpanded:
        return _dice(x, y, precision)
    if m == DistanceType.KLDivergence:
        return _kl_divergence(x, y, precision)
    if m == DistanceType.L1:
        return _pairwise_reduce(x, y, _abs_diff, ws)
    if m in (DistanceType.L2Unexpanded, DistanceType.L2SqrtUnexpanded):
        d = _pairwise_reduce(x, y, _sq_diff, ws)
        return torch.sqrt(d) if m == DistanceType.L2SqrtUnexpanded else d
    if m == DistanceType.Linf:
        return _pairwise_reduce(x, y, _abs_diff, ws, reduce="max")
    if m == DistanceType.Canberra:
        return _pairwise_reduce(x, y, _canberra_elem, ws)
    if m == DistanceType.LpUnexpanded:
        p = float(metric_arg)
        expect(p > 0, "LpUnexpanded requires metric_arg > 0")
        d = _pairwise_reduce(x, y, lambda a, b: (a - b).abs_().pow_(p), ws)
        return torch.pow(d, 1.0 / p)
    if m == DistanceType.BrayCurtis:
        num = _pairwise_reduce(x, y, _abs_diff, ws)
        den = _pairwise_reduce(x, y, lambda a, b: (a + b).abs_(), ws)
        return _safe_div(num, den)
    if m == DistanceType.JensenShannon:
        return torch.sqrt(0.5 * _pairwise_reduce(x, y, _jensen_shannon_elem,
                                                 ws))
    if m == DistanceType.HammingUnexpanded:
        return _pairwise_reduce(x, y, _ne, ws) / x.shape[1]
    if m == DistanceType.Haversine:
        return _haversine(x, y)
    raise NotImplementedError(f"metric {m!r} not supported by "
                              "pairwise_distance")


def _inputs(res: Resources, x, y):
    x = res.put(x)
    y = res.put(y)
    expect(x.ndim == 2 and y.ndim == 2, "x and y must be 2-D")
    expect(x.shape[1] == y.shape[1],
           f"feature dims differ: {x.shape[1]} vs {y.shape[1]}")
    return x, y


def pairwise_distance(res: Optional[Resources], x, y,
                      metric: DistanceType = DistanceType.L2Expanded,
                      metric_arg: float = 2.0) -> torch.Tensor:
    """The full (m, n) float32 distance matrix, ``distance::
    pairwise_distance`` (``distance/distance-inl.cuh:255``). ``metric_arg``
    is Lp's p. For ``InnerProduct`` larger means closer
    (``is_min_close``); every other metric is a distance."""
    res = ensure_resources(res)
    x, y = _inputs(res, x, y)
    with tracing.range("raft_tpu.pairwise_distance"):
        return _pairwise_distance_impl(x, y, metric, metric_arg,
                                       res.matmul_precision,
                                       res.workspace_limit_bytes)


def pairwise_distance_tiled(res: Optional[Resources], x, y,
                            metric: DistanceType, metric_arg: float = 2.0,
                            row_tile: int = 4096) -> torch.Tensor:
    """:func:`pairwise_distance` computed ``row_tile`` rows of ``x`` at a
    time, so the expanded metrics' temporaries stay ``row_tile x n``."""
    res = ensure_resources(res)
    x, y = _inputs(res, x, y)
    expect(row_tile > 0, "row_tile must be positive")
    with tracing.range("raft_tpu.pairwise_distance"):
        tiles = [_pairwise_distance_impl(x[s:s + row_tile], y, metric,
                                         metric_arg, res.matmul_precision,
                                         res.workspace_limit_bytes)
                 for s in range(0, max(x.shape[0], 1), row_tile)]
        return torch.cat(tiles)
