"""Sparse linear algebra — port of ``raft_tpu/sparse/linalg.py``
(reference ``raft/sparse/linalg/``: ``spmm.cuh``, ``norm.cuh``,
``add.cuh``, ``symmetrize.cuh``, ``transpose.cuh``, the Laplacian of
``linalg/spectral.cuh``).

The reference routes through cuSPARSE; here, as in the JAX package, a
product is a gather of the dense operand's rows by column index, a scale
by the entry, and a segment sum by row (``index_add_``, whose float sums
on the card run in no fixed order).
"""

from __future__ import annotations

import torch

from raft_tpu_torch.sparse.convert import coo_to_csr, csr_to_coo
from raft_tpu_torch.sparse.ops import coo_sort, sum_duplicates
from raft_tpu_torch.sparse.types import COO, CSR, _segment_max, _segment_sum


def _dense(x, like: torch.Tensor) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(like.device)
    return torch.as_tensor(x).to(like.device)


def spmm(csr: CSR, dense, transpose_output: bool = False) -> torch.Tensor:
    """CSR × dense GEMM (``linalg::spmm``): out[m, k] = A @ B for
    B (n, k). Gather B rows per entry, scale, segment-sum by row."""
    dense = _dense(dense, csr.data)
    r = csr.row_ids()
    valid = r >= 0
    gathered = dense[torch.where(valid, csr.indices, 0).to(torch.int64)]
    contrib = gathered * torch.where(valid, csr.data,
                                     torch.zeros_like(csr.data))[:, None]
    out = _segment_sum(contrib, r.clamp(min=0), csr.shape[0])
    return out.T if transpose_output else out


def spgemm(a: CSR, b: CSR) -> CSR:
    """Sparse × sparse → sparse (spgemm via cuSPARSE in the reference):
    the right operand densified, one :func:`spmm`, then re-sparsified, as
    in the JAX package (the product's structure is data-dependent)."""
    from raft_tpu_torch.sparse.convert import csr_to_dense, dense_to_csr

    out = spmm(a, csr_to_dense(b))
    return dense_to_csr(out)


def spmv(csr: CSR, vec) -> torch.Tensor:
    """CSR × vector."""
    return spmm(csr, _dense(vec, csr.data)[:, None])[:, 0]


def row_norm_csr(csr: CSR, norm_type: str = "l2") -> torch.Tensor:
    """``linalg::rowNormCsr``: per-row L1/L2/Linf norms (L2 squared)."""
    r = csr.row_ids()
    valid = r >= 0
    v = torch.where(valid, csr.data, torch.zeros_like(csr.data))
    seg = r.clamp(min=0)
    m = csr.shape[0]
    if norm_type == "l1":
        return _segment_sum(torch.abs(v), seg, m)
    if norm_type == "l2":
        return _segment_sum(v * v, seg, m)
    if norm_type == "linf":
        return _segment_max(torch.abs(v), seg, m)
    raise ValueError(f"unknown norm {norm_type!r}")


def csr_row_normalize(csr: CSR, norm_type: str = "l1") -> CSR:
    """``linalg::csr_row_normalize_l1`` / ``_max``."""
    norms = row_norm_csr(csr, norm_type)
    if norm_type == "l2":
        norms = torch.sqrt(norms)
    r = csr.row_ids()
    denom = norms[r.clamp(min=0).to(torch.int64)]
    data = torch.where((r >= 0) & (denom > 0), csr.data / denom,
                       torch.zeros_like(csr.data))
    return CSR(csr.indptr, csr.indices, data, csr.shape)


def transpose(csr: CSR) -> CSR:
    """``linalg::transpose`` (cuSPARSE csr2csc in the reference): swap
    coordinates and re-sort."""
    coo = csr_to_coo(csr)
    valid = coo.rows >= 0
    t = COO(torch.where(valid, coo.cols, -1),
            torch.where(valid, coo.rows, 0), coo.vals,
            (csr.shape[1], csr.shape[0]))
    return coo_to_csr(coo_sort(t))


def add(a: CSR, b: CSR) -> CSR:
    """``linalg::csr_add_calc_inds``/``csr_add_finalize``: A + B with
    duplicate-coordinate summation; capacity = nnz_a + nnz_b."""
    assert a.shape == b.shape, "shape mismatch"
    ca, cb = csr_to_coo(a), csr_to_coo(b)
    merged = COO(
        torch.cat([ca.rows, cb.rows]),
        torch.cat([ca.cols, cb.cols]),
        torch.cat([ca.vals, cb.vals]),
        a.shape,
    )
    return coo_to_csr(sum_duplicates(merged))


def coo_symmetrize(coo: COO, op=None) -> COO:
    """``linalg::coo_symmetrize``: out = op(A, A^T) with duplicate
    merging; default op sums (then the caller typically halves), matching
    the reference's edge-mean symmetrization of kNN graphs."""
    valid = coo.rows >= 0
    t_rows = torch.where(valid, coo.cols, -1)
    t_cols = torch.where(valid, coo.rows, 0)
    both = COO(
        torch.cat([coo.rows, t_rows]),
        torch.cat([coo.cols, t_cols]),
        torch.cat([coo.vals, coo.vals]),
        coo.shape,
    )
    merged = sum_duplicates(both)
    if op is not None:
        merged = COO(merged.rows, merged.cols, op(merged.vals), merged.shape)
    return merged


def laplacian(csr: CSR, normalized: bool = True) -> CSR:
    """Graph Laplacian L = D - A (or normalized I - D^-1/2 A D^-1/2) —
    the operator ``linalg/spectral.cuh`` feeds to Lanczos."""
    m = csr.shape[0]
    dev = csr.device
    deg = row_norm_csr(csr, "l1")
    r = csr.row_ids()
    valid = r >= 0
    if normalized:
        dinv = torch.where(deg > 0, 1.0 / torch.sqrt(deg),
                           torch.zeros_like(deg))
        off = (-csr.data * dinv[r.clamp(min=0).to(torch.int64)]
               * dinv[csr.indices.clamp(0, m - 1).to(torch.int64)])
        diag_val = torch.ones((m,), dtype=csr.data.dtype, device=dev)
    else:
        off = -csr.data
        diag_val = deg
    off = torch.where(valid, off, torch.zeros_like(off))
    ar = torch.arange(m, dtype=torch.int32, device=dev)
    merged = sum_duplicates(COO(
        torch.cat([torch.where(valid, r, -1), ar]),
        torch.cat([csr.indices, ar]),
        torch.cat([off, diag_val]),
        csr.shape,
    ))
    return coo_to_csr(merged)
