"""BLAS-level ops — port of ``raft_tpu/linalg/blas.py`` (reference
``linalg/gemm.cuh``, ``linalg/detail/cublas_wrappers.hpp``).

Each call is one ``torch.matmul`` on the handle's device with float32
sums; the handle's ``matmul_precision`` picks full float32 (no TF32) or
one bfloat16 pass, as :func:`raft_tpu_torch.distance.pairwise.matmul`.
"""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.core.validation import expect


def _f32(x: torch.Tensor, precision: str) -> torch.Tensor:
    x = x.to(torch.float32)
    if precision == "bfloat16":
        x = x.to(torch.bfloat16).to(torch.float32)
    return x


def gemm(
    res: Optional[Resources],
    a,
    b,
    *,
    alpha: float = 1.0,
    beta: float = 0.0,
    c=None,
    trans_a: bool = False,
    trans_b: bool = False,
):
    """``alpha * op(A) @ op(B) + beta * C`` — analog of ``linalg::gemm``
    (reference ``linalg/gemm.cuh``). Sums in float32."""
    res = ensure_resources(res)
    a, b = res.put(a), res.put(b)
    if trans_a:
        a = a.T
    if trans_b:
        b = b.T
    expect(a.shape[1] == b.shape[0], "gemm: inner dimensions must agree")
    p = res.matmul_precision
    out = alpha * (_f32(a, p) @ _f32(b, p))
    if beta != 0.0:
        expect(c is not None, "gemm: beta != 0 requires C")
        out = out + beta * res.put(c)
    return out.to(a.dtype)


def gemv(
    res: Optional[Resources],
    a,
    x,
    *,
    alpha: float = 1.0,
    beta: float = 0.0,
    y=None,
    trans: bool = False,
):
    """``alpha * op(A) @ x + beta * y`` — analog of the cuBLAS gemv wrapper."""
    res = ensure_resources(res)
    a, x = res.put(a), res.put(x)
    if trans:
        a = a.T
    expect(a.shape[1] == x.shape[0], "gemv: dimensions must agree")
    p = res.matmul_precision
    out = alpha * (_f32(a, p) @ _f32(x, p))
    if beta != 0.0:
        expect(y is not None, "gemv: beta != 0 requires y")
        out = out + beta * res.put(y)
    return out.to(a.dtype)


def axpy(res: Optional[Resources], alpha: float, x, y):
    """``y + alpha * x`` (functional: returns the result)."""
    res = ensure_resources(res)
    return res.put(y) + alpha * res.put(x)


def dot(res: Optional[Resources], x, y):
    """Vector dot product with float32 sums."""
    res = ensure_resources(res)
    x, y = res.put(x), res.put(y)
    return torch.dot(x.to(torch.float32), y.to(torch.float32)).to(x.dtype)
