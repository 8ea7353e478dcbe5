"""Dense factorizations & solvers — port of ``raft_tpu/linalg/
solvers.py`` (reference ``linalg/eig.cuh`` (eigDC / eigJacobi),
``linalg/svd.cuh`` (svdQR), ``linalg/qr.cuh``, ``linalg/rsvd.cuh``,
``linalg/lstsq.cuh``, ``linalg/cholesky_r1_update.cuh``).

The factorizations are ``torch.linalg`` calls, as the JAX package's are
XLA's; their vectors can differ from the JAX package's in sign.
Randomized SVD and the rank-1 Cholesky update are algorithms over them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.random.rng import _key_of


def eig_dc(res: Optional[Resources], a) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric eigendecomposition, ascending eigenvalues —
    analog of ``linalg::eigDC`` (cuSOLVER syevd). Returns (vectors, values)
    with ``vectors[:, i]`` the i-th eigenvector."""
    res = ensure_resources(res)
    w, v = torch.linalg.eigh(res.put(a))
    return v, w


def eig_jacobi(
    res: Optional[Resources], a, *, tol: float = 1e-7, sweeps: int = 15
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Jacobi-method symmetric eigensolver (``linalg::eigJacobi``); the
    same ``eigh`` as :func:`eig_dc` (tol/sweeps accepted for signature
    parity)."""
    del tol, sweeps
    return eig_dc(res, a)


def svd(
    res: Optional[Resources],
    a,
    *,
    full_matrices: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SVD ``A = U S V^T`` — analog of ``linalg::svdQR``. Returns
    (U, S, V) with V (not V^T), matching the reference's output layout."""
    res = ensure_resources(res)
    u, s, vt = torch.linalg.svd(res.put(a), full_matrices=full_matrices)
    return u, s, vt.T


def qr(res: Optional[Resources], a) -> Tuple[torch.Tensor, torch.Tensor]:
    """Thin QR — analog of ``linalg::qrGetQR`` (``linalg/qr.cuh``)."""
    res = ensure_resources(res)
    return torch.linalg.qr(res.put(a), mode="reduced")


def rsvd(
    res: Optional[Resources],
    a,
    k: int,
    *,
    p: int = 10,
    n_iters: int = 2,
    key=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Randomized truncated SVD — analog of ``linalg::rsvd``
    (``linalg/rsvd.cuh``), via Halko-style subspace iteration:
    range-find with a Gaussian sketch (rank k+p), ``n_iters`` power
    iterations with QR re-orthonormalization, then exact SVD of the
    small projected matrix.

    ``key`` is the sketch's generator: a ``torch.Generator`` on the
    handle's device, an int seed or a :class:`raft_tpu_torch.random.
    RngState` (None: the handle's own generator).

    Returns (U, S, V) with k columns/entries.
    """
    res = ensure_resources(res)
    a32 = res.put(a).to(torch.float32)
    m, n = a32.shape
    expect(k >= 1 and k <= min(m, n), "rsvd: k out of range")
    ell = min(k + p, min(m, n))
    g = res.generator if key is None else _key_of(key, res.device)
    omega = torch.randn((n, ell), generator=g, device=res.device)
    y = a32 @ omega
    q, _ = torch.linalg.qr(y)
    for _ in range(n_iters):
        z = a32.T @ q
        q, _ = torch.linalg.qr(z)
        y = a32 @ q
        q, _ = torch.linalg.qr(y)
    b = q.T @ a32  # (ell, n)
    ub, s, vt = torch.linalg.svd(b, full_matrices=False)
    u = q @ ub
    return u[:, :k], s[:k], vt[:k, :].T


def lstsq(res: Optional[Resources], a, b) -> torch.Tensor:
    """Least-squares solve min |Ax - b| — analog of ``linalg::lstsq*``
    (``linalg/lstsq.cuh``): the minimum-norm solution through the SVD,
    singular values under ``eps * max(m, n) * s_max`` dropped (the
    ``jnp.linalg.lstsq`` default), on any device."""
    res = ensure_resources(res)
    a = res.put(a).to(torch.float32)
    b = res.put(b).to(torch.float32)
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    cut = torch.finfo(torch.float32).eps * max(a.shape) * s.amax()
    inv = torch.where(s > cut, 1.0 / torch.where(s > cut, s, 1.0), 0.0)
    vec = b.ndim == 1
    bb = b[:, None] if vec else b
    x = vt.T @ (inv[:, None] * (u.T @ bb))
    return x[:, 0] if vec else x


def cholesky_rank_one_update(
    res: Optional[Resources],
    l_factor,
    x,
    *,
    lower: bool = True,
) -> torch.Tensor:
    """Update Cholesky factor of A to that of ``A + x x^T`` —
    analog of ``linalg::choleskyRank1Update``
    (``linalg/cholesky_r1_update.cuh``).

    Classic hyperbolic-rotation update, one column a step (the loop is
    sequential; each step is vectorized over the trailing rows).
    """
    res = ensure_resources(res)
    lmat = res.put(l_factor).to(torch.float32).clone()
    n = lmat.shape[0]
    xv = res.put(x).to(torch.float32).clone()
    expect(xv.shape[0] == n, "cholesky_rank_one_update: size mismatch")
    if not lower:
        lmat = lmat.T.contiguous()
    ar = torch.arange(n, device=lmat.device)
    for k in range(n):
        lkk = lmat[k, k]
        xk = xv[k]
        r = torch.sqrt(lkk * lkk + xk * xk)
        c = r / lkk
        s = xk / lkk
        col = lmat[:, k]
        mask = (ar > k).to(torch.float32)
        new_col = torch.where(ar == k, r, (col + s * xv) / c)
        new_col = torch.where(ar >= k, new_col, col)
        xv = xv * (1 - mask) + mask * (c * xv - s * new_col)
        lmat[:, k] = new_col
    return lmat if lower else lmat.T
