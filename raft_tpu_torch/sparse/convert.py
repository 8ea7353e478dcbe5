"""Sparse format conversions — port of ``raft_tpu/sparse/convert.py``
(reference ``convert/coo.cuh``, ``convert/csr.cuh``, ``convert/dense.cuh``).
The dense→sparse directions count nonzeros (one host read)."""

from __future__ import annotations

import torch

from raft_tpu_torch.sparse.types import COO, CSR, _lexsort, _segment_sum


def coo_to_csr(coo: COO) -> CSR:
    """``convert::sorted_coo_to_csr``: sort by (row, col), build indptr.
    Padding rows (-1) sort to the back."""
    m, n = coo.shape
    row_key = torch.where(coo.rows >= 0, coo.rows, m)
    order = _lexsort((coo.cols, row_key))
    rows = coo.rows[order]
    cols = coo.cols[order]
    vals = coo.vals[order]
    counts = _segment_sum((rows >= 0).to(torch.int32), rows.clamp(min=0), m)
    indptr = torch.zeros(m + 1, dtype=torch.int32, device=coo.device)
    indptr[1:] = torch.cumsum(counts, 0)
    return CSR(indptr, cols, vals, coo.shape)


def csr_to_coo(csr: CSR) -> COO:
    """``convert::csr_to_coo``: expand indptr to row ids."""
    return COO(csr.row_ids(), csr.indices, csr.data, csr.shape)


def dense_to_csr(dense, *, device=None) -> CSR:
    """``convert::dense_to_csr``."""
    return CSR.from_dense(dense, device=device)


def dense_to_coo(dense, *, device=None) -> COO:
    return COO.from_dense(dense, device=device)


def csr_to_dense(csr: CSR) -> torch.Tensor:
    """``convert::csr_to_dense``."""
    return csr.to_dense()


def coo_to_dense(coo: COO) -> torch.Tensor:
    return coo.to_dense()
