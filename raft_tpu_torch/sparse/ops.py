"""Sparse structure operations — port of ``raft_tpu/sparse/ops.py``
(reference ``raft/sparse/op/``: ``sort.cuh``, ``reduce.cuh``
max-duplicate merge, ``filter.cuh`` value filtering, ``slice.cuh`` row
slicing; plus ``linalg/degree.cuh``). Capacities stay fixed: dropped
entries become padding, as in the JAX package."""

from __future__ import annotations

import torch

from raft_tpu_torch.sparse.types import (
    COO,
    CSR,
    _lexsort,
    _segment_max,
    _segment_sum,
)


def coo_sort(coo: COO) -> COO:
    """``op::coo_sort``: order entries by (row, col); padding last."""
    m = coo.shape[0]
    row_key = torch.where(coo.rows >= 0, coo.rows, m)
    order = _lexsort((coo.cols, row_key))
    return COO(coo.rows[order], coo.cols[order], coo.vals[order], coo.shape)


def max_duplicates(coo: COO) -> COO:
    """``op::max_duplicates``: merge duplicate (row, col) entries keeping
    the max value (used when symmetrizing kNN graphs)."""
    return _merge_duplicates(coo, "max")


def sum_duplicates(coo: COO) -> COO:
    """Merge duplicate (row, col) entries by summation (the cuSPARSE
    ``coosort``+reduce idiom the reference leans on)."""
    return _merge_duplicates(coo, "sum")


def _merge_duplicates(coo: COO, how: str) -> COO:
    c = coo_sort(coo)
    nnz = c.nnz
    dev = c.device
    same_prev = (c.rows[1:] == c.rows[:-1]) & (c.cols[1:] == c.cols[:-1])
    is_first = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                          ~same_prev]) & (c.rows >= 0)
    seg = torch.cumsum(is_first, 0) - 1              # group id per entry
    seg = torch.where(c.rows >= 0, seg, nnz)         # padding → drop bucket
    if how == "sum":
        merged = _segment_sum(c.vals, seg, nnz + 1)
    else:
        merged = _segment_max(c.vals, seg, nnz + 1)
    ngroups = torch.sum(is_first)
    # the first entry of each group lands in its group's slot; the rest
    # go to the dummy slot nnz, which is sliced off
    slot = torch.where(is_first, seg, nnz)
    rows = torch.full((nnz + 1,), -1, dtype=torch.int32, device=dev)
    cols = torch.zeros((nnz + 1,), dtype=torch.int32, device=dev)
    rows[slot] = c.rows
    cols[slot] = c.cols
    valid = torch.arange(nnz, device=dev) < ngroups
    vals = torch.where(valid, merged[:nnz], torch.zeros_like(merged[:nnz]))
    return COO(torch.where(valid, rows[:nnz], -1), cols[:nnz], vals,
               coo.shape)


def remove_scalar(coo: COO, scalar) -> COO:
    """``op::coo_remove_scalar``: entries equal to ``scalar`` become
    padding (capacity is fixed, so they are masked, not compacted)."""
    drop = (coo.vals == scalar) | (coo.rows < 0)
    return COO(torch.where(drop, -1, coo.rows), coo.cols,
               torch.where(drop, torch.zeros_like(coo.vals), coo.vals),
               coo.shape)


def remove_zeros(coo: COO) -> COO:
    """``op::coo_remove_zeros``."""
    return remove_scalar(coo, 0)


def row_slice(csr: CSR, start: int, stop: int) -> CSR:
    """``op::csr_row_slice_indptr`` + populate: rows [start, stop).

    The capacity stays the full nnz; entries outside the slice are zeroed
    padding past the new indptr."""
    m = stop - start
    dev = csr.device
    indptr = csr.indptr[start: stop + 1] - csr.indptr[start]
    n_keep = csr.indptr[stop] - csr.indptr[start]
    pos = torch.arange(csr.nnz, device=dev)
    idx = (pos + csr.indptr[start]).clamp(0, csr.nnz - 1)
    valid = pos < n_keep
    indices = torch.where(valid, csr.indices[idx], 0)
    data = torch.where(valid, csr.data[idx], torch.zeros_like(csr.data))
    return CSR(indptr, indices, data, (m, csr.shape[1]))


def degree(coo: COO) -> torch.Tensor:
    """``linalg::coo_degree``: nonzeros per row."""
    valid = coo.rows >= 0
    return _segment_sum(valid.to(torch.int32), coo.rows.clamp(min=0),
                        coo.shape[0])


def csr_row_op(csr: CSR, fn) -> CSR:
    """``op::csr_row_op``: map ``fn(row_id, value)`` over entries."""
    r = csr.row_ids()
    out = fn(r, csr.data)
    return CSR(csr.indptr, csr.indices,
               torch.where(r >= 0, out, torch.zeros_like(out)), csr.shape)
