"""Sparse matrix containers — port of ``raft_tpu/sparse/types.py``
(reference ``core/sparse_types.hpp``, ``core/device_coo_matrix.hpp``,
``core/device_csr_matrix.hpp``, ``sparse/coo.hpp``, ``sparse/csr.hpp``).

Both containers hold fixed-size tensors whose *capacity* (nnz) is their
length, with the JAX package's padding conventions: a COO padding entry
has ``rows == -1``; a CSR's entries past ``indptr[-1]`` are padding with
zero data. ``from_numpy``/``to_numpy`` carry the JAX package's sparse
state (its arrays as numpy) across.

This module also holds the sparse package's device idioms:
``jnp.lexsort`` as a chain of stable sorts from the least significant
key (:func:`_lexsort`), and ``jax.ops.segment_{sum,min,max}`` as a
scatter onto a tensor filled with the op's identity, so an empty segment
holds what JAX puts there: 0, the dtype's max (``inf``), or its min
(``-inf``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.resources import ensure_resources


def _lexsort(keys) -> torch.Tensor:
    """``jnp.lexsort(keys)``: the order that sorts by the LAST key, ties
    by the one before and so on; equal keys keep their positions."""
    order = None
    for key in keys:
        k = key if order is None else key[order]
        o = torch.sort(k, stable=True).indices
        order = o if order is None else order[o]
    return order


def _identity(dtype: torch.dtype, how: str):
    if how == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if how == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if how == "min" else info.min


def _segment(data: torch.Tensor, ids: torch.Tensor, n: int,
             how: str) -> torch.Tensor:
    """``jax.ops.segment_{sum,min,max}(data, ids, num_segments=n)`` for
    ``ids`` in ``[0, n)``."""
    out = torch.full((n,) + tuple(data.shape[1:]), _identity(data.dtype, how),
                     dtype=data.dtype, device=data.device)
    ids = ids.to(torch.int64)
    if how == "sum":
        return out.index_add_(0, ids, data)
    if data.ndim > 1:
        ids = ids.reshape((-1,) + (1,) * (data.ndim - 1)).expand_as(data)
    return out.scatter_reduce_(0, ids, data, "amin" if how == "min"
                               else "amax")


def _segment_sum(data, ids, n):
    return _segment(data, ids, n, "sum")


def _segment_min(data, ids, n):
    return _segment(data, ids, n, "min")


def _segment_max(data, ids, n):
    return _segment(data, ids, n, "max")


def _device(device, like=None) -> torch.device:
    if device is not None:
        return torch.device(device)
    if isinstance(like, torch.Tensor):
        return like.device
    return ensure_resources(None).device


def _tensor(a, dtype, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    arr = np.asarray(a)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.as_tensor(arr).to(device=device, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class COO:
    """Coordinate-format sparse matrix (``raft::sparse::COO``,
    ``sparse/coo.hpp``). Invalid (padding) entries have ``rows == -1``."""

    rows: torch.Tensor   # (nnz,) int32, -1 = padding
    cols: torch.Tensor   # (nnz,) int32
    vals: torch.Tensor   # (nnz,)
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.rows.shape[0]

    @property
    def device(self) -> torch.device:
        return self.rows.device

    def to_dense(self) -> torch.Tensor:
        m, n = self.shape
        valid = self.rows >= 0
        lin = torch.where(valid, self.rows.to(torch.int64) * n + self.cols,
                          m * n)
        out = torch.zeros(m * n + 1, dtype=self.vals.dtype,
                          device=self.device)
        out.index_add_(0, lin, torch.where(valid, self.vals,
                                           torch.zeros_like(self.vals)))
        return out[:m * n].reshape(m, n)

    @classmethod
    def from_dense(cls, dense, nnz: Optional[int] = None, *,
                   device=None) -> "COO":
        dev = _device(device, dense)
        dense = _tensor(dense, None, dev)
        r, c = torch.nonzero(dense, as_tuple=True)
        v = dense[r, c]
        if nnz is None:
            nnz = r.shape[0]
        pad = nnz - r.shape[0]
        if pad < 0:
            raise ValueError(f"nnz capacity {nnz} < actual nonzeros "
                             f"{r.shape[0]}")
        i32 = dict(dtype=torch.int32, device=dev)
        rows = torch.cat([r.to(torch.int32), torch.full((pad,), -1, **i32)])
        cols = torch.cat([c.to(torch.int32), torch.zeros((pad,), **i32)])
        vals = torch.cat([v, torch.zeros((pad,), dtype=dense.dtype,
                                         device=dev)])
        return cls(rows, cols, vals, tuple(dense.shape))

    @classmethod
    def from_scipy(cls, mat, *, device=None) -> "COO":
        coo = mat.tocoo()
        return cls.from_numpy(coo.row, coo.col, coo.data, coo.shape,
                              device=device)

    @classmethod
    def from_numpy(cls, rows, cols, vals, shape, *, device=None) -> "COO":
        """A COO from the JAX package's arrays (numpy), placed on
        ``device`` (None: the default handle's)."""
        dev = _device(device)
        return cls(_tensor(rows, torch.int32, dev),
                   _tensor(cols, torch.int32, dev),
                   _tensor(vals, None, dev), tuple(int(s) for s in shape))

    def to_numpy(self) -> dict:
        """``from_numpy``'s keyword arguments, as host arrays."""
        return dict(rows=self.rows.cpu().numpy(), cols=self.cols.cpu().numpy(),
                    vals=self.vals.cpu().numpy(), shape=self.shape)


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed-sparse-row matrix (``raft::sparse::csr``,
    ``sparse/csr.hpp``). Padding entries (beyond ``indptr[-1]``) hold
    zero values so device math can ignore them."""

    indptr: torch.Tensor   # (m + 1,) int32
    indices: torch.Tensor  # (nnz,) int32
    data: torch.Tensor     # (nnz,)
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.indices.shape[0]

    @property
    def device(self) -> torch.device:
        return self.indices.device

    def row_ids(self) -> torch.Tensor:
        """Expanded (nnz,) int32 row id per entry, -1 for padding — the
        COO view the segment sums consume."""
        pos = torch.arange(self.nnz, device=self.device,
                           dtype=self.indptr.dtype)
        ids = torch.searchsorted(self.indptr[1:].contiguous(), pos,
                                 right=True).to(torch.int32)
        return torch.where(pos < self.indptr[-1], ids, -1)

    def to_dense(self) -> torch.Tensor:
        return COO(self.row_ids(), self.indices, self.data,
                   self.shape).to_dense()

    @classmethod
    def from_dense(cls, dense, *, device=None) -> "CSR":
        dev = _device(device, dense)
        dense = _tensor(dense, None, dev)
        m, n = dense.shape
        r, c = torch.nonzero(dense, as_tuple=True)
        v = dense[r, c]
        counts = torch.bincount(r, minlength=m)
        indptr = torch.zeros(m + 1, dtype=torch.int32, device=dev)
        indptr[1:] = torch.cumsum(counts, 0)
        return cls(indptr, c.to(torch.int32), v, (m, n))

    @classmethod
    def from_scipy(cls, mat, *, device=None) -> "CSR":
        csr = mat.tocsr()
        return cls.from_numpy(csr.indptr, csr.indices, csr.data, csr.shape,
                              device=device)

    @classmethod
    def from_numpy(cls, indptr, indices, data, shape, *,
                   device=None) -> "CSR":
        """A CSR from the JAX package's arrays (numpy), placed on
        ``device`` (None: the default handle's)."""
        dev = _device(device)
        return cls(_tensor(indptr, torch.int32, dev),
                   _tensor(indices, torch.int32, dev),
                   _tensor(data, None, dev), tuple(int(s) for s in shape))

    def to_numpy(self) -> dict:
        """``from_numpy``'s keyword arguments, as host arrays."""
        return dict(indptr=self.indptr.cpu().numpy(),
                    indices=self.indices.cpu().numpy(),
                    data=self.data.cpu().numpy(), shape=self.shape)
