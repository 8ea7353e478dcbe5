"""Dense matrix operations — port of ``raft_tpu/matrix/ops.py``
(reference ``raft/matrix/*.cuh``: gather/scatter, slice, per-row
argmax/argmin, col-wise sort, linewise op, reverse, triangular, print...).

Each runs where its input tensor lives; an input that is not a tensor
(numpy, a list) goes to the default handle's device (``cuda``), and
:func:`eye` takes ``device=`` (None: that device).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.resources import ensure_resources


def _t(x, like: torch.Tensor = None) -> torch.Tensor:
    """A tensor: itself, or placed beside ``like`` / on the default
    handle's device."""
    if isinstance(x, torch.Tensor):
        return x
    if like is not None:
        return torch.as_tensor(np.asarray(x)).to(like.device)
    return ensure_resources(None).put(x)


def gather(matrix, indices) -> torch.Tensor:
    """Row gather: out[i] = matrix[indices[i]] (``matrix/gather.cuh``)."""
    matrix = _t(matrix)
    return matrix[_t(indices, matrix).to(torch.int64)]


def gather_if(matrix, indices, stencil, pred: Callable) -> torch.Tensor:
    """Conditional row gather (``matrix::gather_if``): rows whose stencil
    fails the predicate are zeroed."""
    out = gather(matrix, indices)
    keep = pred(_t(stencil, out))
    return torch.where(keep[:, None], out, torch.zeros_like(out))


def scatter(matrix, indices, updates) -> torch.Tensor:
    """Row scatter: out[indices[i]] = updates[i] (``matrix/scatter.cuh``)."""
    out = _t(matrix).clone()
    out[_t(indices, out).to(torch.int64)] = _t(updates, out).to(out.dtype)
    return out


def slice(matrix, rows: Tuple[int, int], cols: Tuple[int, int]) -> torch.Tensor:  # noqa: A001
    """Contiguous sub-matrix copy (``matrix/slice.cuh``)."""
    return _t(matrix)[rows[0]: rows[1], cols[0]: cols[1]].clone()


def argmax(matrix, axis: int = 1) -> torch.Tensor:
    """Per-row argmax, the first of equal maxima (``matrix/argmax.cuh``)."""
    return torch.argmax(_t(matrix), dim=axis).to(torch.int32)


def argmin(matrix, axis: int = 1) -> torch.Tensor:
    """Per-row argmin, the first of equal minima (``matrix/argmin.cuh``)."""
    return torch.argmin(_t(matrix), dim=axis).to(torch.int32)


def col_sort(keys, values=None):
    """Sort each row's columns by key, equal keys in column order
    (``matrix/col_wise_sort.cuh``); optionally permute a payload
    alongside."""
    keys = _t(keys)
    sorted_keys, order = torch.sort(keys, dim=1, stable=True)
    if values is None:
        return sorted_keys, order.to(torch.int32)
    return sorted_keys, torch.gather(_t(values, keys), 1, order)


def linewise_op(matrix, vec, along_rows: bool, op: Callable) -> torch.Tensor:
    """Broadcast a vector op along rows or columns
    (``matrix/linewise_op.cuh`` / ``linalg::matrix_vector_op``)."""
    matrix = _t(matrix)
    vec = _t(vec, matrix)
    if along_rows:  # vec has one entry per column
        return op(matrix, vec[None, :])
    return op(matrix, vec[:, None])


def reverse(matrix, axis: int = 1) -> torch.Tensor:
    """Flip rows or columns (``matrix/reverse.cuh``)."""
    return torch.flip(_t(matrix), dims=(axis,))


def triangular_upper(matrix) -> torch.Tensor:
    """Upper-triangular copy (``matrix/triangular.cuh``)."""
    return torch.triu(_t(matrix))


def triangular_lower(matrix) -> torch.Tensor:
    return torch.tril(_t(matrix))


def matrix_print(matrix, name: str = "matrix", max_rows: int = 8, max_cols: int = 8):
    """Host-side pretty print (``matrix/print.cuh``)."""
    arr = _t(matrix).detach().cpu().numpy()
    print(f"{name} shape={arr.shape} dtype={arr.dtype}")  # noqa: print is the op
    print(np.array2string(arr[:max_rows, :max_cols], precision=4))  # noqa


def copy(matrix) -> torch.Tensor:
    """Out-of-place copy (``matrix/copy.cuh``)."""
    return _t(matrix).clone()


def diagonal(matrix) -> torch.Tensor:
    """Extract the main diagonal (``matrix/diagonal.cuh``)."""
    return torch.diagonal(_t(matrix)).clone()


def set_diagonal(matrix, values) -> torch.Tensor:
    """Return a copy with the main diagonal replaced
    (``matrix::set_diagonal``)."""
    out = _t(matrix).clone()
    n = min(out.shape[0], out.shape[1])
    idx = torch.arange(n, device=out.device)
    out[idx, idx] = _t(values, out)[:n].to(out.dtype)
    return out


def fill(matrix, value) -> torch.Tensor:
    """Constant-fill with the input's shape/dtype (``matrix/init.cuh``)."""
    return torch.full_like(_t(matrix), value)


def eye(n: int, dtype=torch.float32, *, device=None) -> torch.Tensor:
    """Identity matrix (``matrix::eye``)."""
    if device is None:
        device = ensure_resources(None).device
    return torch.eye(n, dtype=dtype, device=device)


def power(matrix, exponent) -> torch.Tensor:
    """Elementwise power (``matrix/power.cuh``)."""
    return torch.pow(_t(matrix), exponent)


def sqrt(matrix) -> torch.Tensor:
    """Elementwise square root (``matrix/sqrt.cuh``)."""
    return torch.sqrt(_t(matrix))


def reciprocal(matrix, scalar=1.0, thres: float = 0.0) -> torch.Tensor:
    """``scalar / x`` with small-denominator guard
    (``matrix/reciprocal.cuh``): entries with |x| <= thres map to 0."""
    matrix = _t(matrix)
    out = scalar / matrix
    return torch.where(torch.abs(matrix) <= thres, torch.zeros_like(out), out)


def ratio(matrix) -> torch.Tensor:
    """Normalize so entries sum to one (``matrix/ratio.cuh``)."""
    matrix = _t(matrix)
    return matrix / torch.sum(matrix)


def sign_flip(matrix) -> torch.Tensor:
    """Flip each column's sign so its max-|value| entry is positive —
    deterministic eigenvector orientation (``matrix/sign_flip.cuh``)."""
    matrix = _t(matrix)
    pivot = torch.gather(matrix, 0,
                         torch.argmax(torch.abs(matrix), dim=0)[None, :])
    return matrix * torch.where(pivot < 0, -1.0, 1.0)


def zero_small_values(matrix, thres) -> torch.Tensor:
    """Zero entries whose MAGNITUDE is <= thres (``matrix/threshold.cuh``
    ``zero_small_values``: denoising that keeps large entries of either
    sign)."""
    matrix = _t(matrix)
    return torch.where(torch.abs(matrix) <= thres, torch.zeros_like(matrix),
                       matrix)


# reference alias: the public header is matrix/threshold.cuh
threshold = zero_small_values


def l2_norm(matrix) -> torch.Tensor:
    """Frobenius norm of the whole matrix (``matrix/norm.cuh``
    ``l2_norm``)."""
    x = _t(matrix).to(torch.float32)
    return torch.sqrt(torch.sum(x * x))
