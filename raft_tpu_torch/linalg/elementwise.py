"""Elementwise map family — port of ``raft_tpu/linalg/elementwise.py``
(reference ``linalg/map.cuh`` and the add/subtract/multiply/divide/power/
sqrt headers under ``raft/linalg/``). Each is one PyTorch expression on
the handle's device: the value here is the reference's API surface.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from raft_tpu_torch.core.resources import Resources, ensure_resources


def _put(res, *arrays):
    res = ensure_resources(res)
    return [res.put(a) for a in arrays]


def unary_op(res: Optional[Resources], x, op: Callable):
    """Apply ``op`` elementwise (``linalg::unaryOp``, ``linalg/unary_op.cuh``)."""
    (x,) = _put(res, x)
    return op(x)


def binary_op(res: Optional[Resources], x, y, op: Callable):
    """Apply ``op(x, y)`` elementwise (``linalg::binaryOp``)."""
    return op(*_put(res, x, y))


def ternary_op(res: Optional[Resources], x, y, z, op: Callable):
    """Apply ``op(x, y, z)`` elementwise (``linalg::ternaryOp``)."""
    return op(*_put(res, x, y, z))


def map_offset(res: Optional[Resources], shape, op: Callable,
               dtype=torch.float32):
    """Map over flat element offsets (``linalg::map_offset``,
    ``linalg/map.cuh``): ``out[i] = op(i)`` reshaped to ``shape``."""
    res = ensure_resources(res)
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int32, device=res.device)
    return torch.as_tensor(op(idx)).to(dtype).reshape(tuple(shape))


def map(res: Optional[Resources], op: Callable, *arrays):  # noqa: A001
    """Variadic elementwise map (``linalg::map``, ``linalg/map.cuh``)."""
    return op(*_put(res, *arrays))


def transpose(res: Optional[Resources], x):
    """Matrix transpose (``linalg/transpose.cuh``)."""
    (x,) = _put(res, x)
    return torch.swapaxes(x, -1, -2)


def add(res: Optional[Resources], x, y):
    x, y = _put(res, x, y)
    return x + y


def subtract(res: Optional[Resources], x, y):
    x, y = _put(res, x, y)
    return x - y


def multiply(res: Optional[Resources], x, y):
    x, y = _put(res, x, y)
    return x * y


def divide(res: Optional[Resources], x, y):
    x, y = _put(res, x, y)
    return x / y


def scalar_add(res: Optional[Resources], x, scalar):
    (x,) = _put(res, x)
    return x + scalar


def scalar_multiply(res: Optional[Resources], x, scalar):
    (x,) = _put(res, x)
    return x * scalar


def power(res: Optional[Resources], x, y):
    (x,) = _put(res, x)
    if not isinstance(y, (int, float)):
        (y,) = _put(res, y)
    return torch.pow(x, y)


def sqrt(res: Optional[Resources], x):
    (x,) = _put(res, x)
    return torch.sqrt(x)
