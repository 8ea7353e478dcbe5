"""Reductions and norms — port of ``raft_tpu/linalg/reduce.py``
(reference ``linalg/reduce.cuh``, ``coalesced_reduction.cuh``,
``strided_reduction.cuh``, ``norm.cuh``, ``normalize.cuh``,
``mean_squared_error.cuh``, ``reduce_rows_by_key.cuh``,
``reduce_cols_by_key.cuh``).

Coalesced and strided reductions are one reduction over ``dim=``. The
key-grouped sums scatter-add rows (``index_add_``) where the JAX package
multiplies by a one-hot matrix; keys outside ``[0, n_keys)`` add to no
group, as a one-hot row of zeros does. A ``reduce_op`` is called as
``reduce_op(x, dim=axis)`` (``torch.sum``, ``torch.amax``...); one that
returns ``(values, indices)`` (``torch.max``) gives its values.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.core.validation import expect

# Norm types mirroring ``raft::linalg::NormType``.
L1Norm = "l1"
L2Norm = "l2"
LinfNorm = "linf"


def _values(out):
    return out[0] if isinstance(out, tuple) else out


def reduce(
    res: Optional[Resources],
    matrix,
    *,
    along_rows: bool = True,
    main_op: Callable = lambda x: x,
    reduce_op: Callable = torch.sum,
    final_op: Callable = lambda x: x,
    init=None,
):
    """General map-reduce over one matrix axis (``linalg::reduce``).

    ``along_rows=True`` reduces each row to a scalar (output length n_rows),
    matching the reference's ``apply_along_rows``. ``init`` seeds the
    accumulator (reference semantics: correct for max/min reductions, not
    an additive bias) — one extra init-valued lane in the reduction.
    """
    res = ensure_resources(res)
    axis = 1 if along_rows else 0
    x = main_op(res.put(matrix))
    if init is not None:
        pad_shape = (x.shape[0], 1) if along_rows else (1, x.shape[1])
        x = torch.cat([x, torch.full(pad_shape, init, dtype=x.dtype,
                                     device=x.device)], dim=axis)
    return final_op(_values(reduce_op(x, dim=axis)))


def coalesced_reduction(res: Optional[Resources], matrix, **kwargs):
    """Row-wise reduction for row-major data (``linalg/coalesced_reduction.cuh``)."""
    return reduce(res, matrix, along_rows=True, **kwargs)


def strided_reduction(res: Optional[Resources], matrix, **kwargs):
    """Column-wise reduction for row-major data (``linalg/strided_reduction.cuh``)."""
    return reduce(res, matrix, along_rows=False, **kwargs)


def map_reduce(
    res: Optional[Resources],
    x,
    map_op: Callable,
    reduce_op: Callable = torch.sum,
):
    """Fused map + full reduction (``linalg::mapThenReduce``)."""
    res = ensure_resources(res)
    return _values(reduce_op(map_op(res.put(x))))


def norm(
    res: Optional[Resources],
    matrix,
    norm_type: str = L2Norm,
    *,
    along_rows: bool = True,
    sqrt: bool = False,
):
    """Row / column norms (``linalg::rowNorm`` / ``colNorm``,
    ``linalg/norm.cuh``). The reference's L2 norm is the *squared* norm
    unless ``sqrt=True`` — matched here."""
    res = ensure_resources(res)
    axis = 1 if along_rows else 0
    x = res.put(matrix).to(torch.float32)
    if norm_type == L1Norm:
        out = torch.sum(torch.abs(x), dim=axis)
    elif norm_type == L2Norm:
        out = torch.sum(x * x, dim=axis)
        if sqrt:
            out = torch.sqrt(out)
        return out
    elif norm_type == LinfNorm:
        out = torch.amax(torch.abs(x), dim=axis)
    else:
        raise ValueError(f"unknown norm type: {norm_type!r}")
    return out


def normalize(
    res: Optional[Resources],
    matrix,
    norm_type: str = L2Norm,
    *,
    eps: float = 1e-10,
):
    """Row-normalize (``linalg::row_normalize``, ``linalg/normalize.cuh``)."""
    res = ensure_resources(res)
    matrix = res.put(matrix)
    if norm_type == L2Norm:
        n = torch.sqrt(norm(res, matrix, L2Norm, along_rows=True))
    else:
        n = norm(res, matrix, norm_type, along_rows=True)
    return matrix / torch.clamp(n, min=eps)[:, None]


def mean_squared_error(res: Optional[Resources], a, b, *, weight: float = 1.0):
    """``linalg::meanSquaredError``: weight * mean((a-b)^2) over all elements."""
    res = ensure_resources(res)
    d = res.put(a).to(torch.float32) - res.put(b).to(torch.float32)
    return weight * torch.mean(d * d)


def _group_sum(x: torch.Tensor, keys: torch.Tensor, n_keys: int
               ) -> torch.Tensor:
    """Sum the rows of ``x`` by key into (n_keys, cols); out-of-range keys
    add nowhere."""
    keys = keys.to(torch.int64)
    ok = (keys >= 0) & (keys < n_keys)
    out = torch.zeros((n_keys + 1, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    out.index_add_(0, torch.where(ok, keys, n_keys), x)
    return out[:n_keys]


def reduce_rows_by_key(
    res: Optional[Resources],
    matrix,
    keys,
    n_keys: int,
    *,
    weights=None,
):
    """Sum rows grouped by per-row key → ``(n_keys, n_cols)``
    (``linalg::reduce_rows_by_key``)."""
    res = ensure_resources(res)
    matrix, keys = res.put(matrix), res.put(keys)
    expect(keys.shape[0] == matrix.shape[0], "reduce_rows_by_key: |keys| != n_rows")
    x = matrix.to(torch.float32)
    if weights is not None:
        x = x * res.put(weights)[:, None]
    return _group_sum(x, keys, n_keys)


def reduce_cols_by_key(
    res: Optional[Resources],
    matrix,
    keys,
    n_keys: int,
):
    """Sum columns grouped by per-column key → ``(n_rows, n_keys)``
    (``linalg::reduce_cols_by_key``)."""
    res = ensure_resources(res)
    matrix, keys = res.put(matrix), res.put(keys)
    expect(keys.shape[0] == matrix.shape[1], "reduce_cols_by_key: |keys| != n_cols")
    return _group_sum(matrix.to(torch.float32).T, keys, n_keys).T
