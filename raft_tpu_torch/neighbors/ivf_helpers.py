"""Index-introspection helpers — port of ``raft_tpu/neighbors/
ivf_helpers.py`` (analogs of ``ivf_flat_helpers.cuh`` /
``ivf_pq_helpers.cuh``: pack/unpack list codes, reconstruct vectors,
extract centers). The layouts are dense, so the helpers are thin views
plus the PQ decoder.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.neighbors.ivf_flat import IvfFlatIndex
from raft_tpu_torch.neighbors.ivf_pq import (
    CodebookKind,
    IvfPqIndex,
    _unpack_nibbles,
)


# -- IVF-Flat (``ivf_flat_helpers.cuh`` / ``ivf_flat_codepacker.hpp``) ------


def flat_unpack_list_data(index: IvfFlatIndex,
                          label: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vectors (size, d), source ids (size,)) of one list —
    ``helpers::codepacker::unpack`` without the interleave undo."""
    expect(0 <= label < index.n_lists, "bad list id")
    size = int(index.list_sizes[label])
    return index.data[label, :size], index.indices[label, :size]


def flat_pack_list_data(index: IvfFlatIndex, label: int, vectors,
                        ids) -> IvfFlatIndex:
    """Overwrite one list's contents (``helpers::codepacker::pack``).
    Functional: returns a new index; the old one is unchanged."""
    expect(0 <= label < index.n_lists, "bad list id")
    dev = index.data.device
    vectors = torch.as_tensor(vectors).to(device=dev, dtype=index.data.dtype)
    ids = torch.as_tensor(ids).to(device=dev, dtype=torch.int32)
    m = index.max_list_size
    n_new = vectors.shape[0]
    expect(n_new <= m, "list overflow — extend() instead")
    row_data = torch.nn.functional.pad(vectors, (0, 0, 0, m - n_new))
    row_ids = torch.nn.functional.pad(ids, (0, m - n_new), value=-1)
    norms = torch.square(row_data.to(torch.float32)).sum(dim=1)
    norms = torch.where(row_ids >= 0, norms,
                        torch.full_like(norms, float("inf")))
    data = index.data.clone()
    data[label] = row_data
    indices = index.indices.clone()
    indices[label] = row_ids
    data_norms = index.data_norms.clone()
    data_norms[label] = norms
    sizes = index.list_sizes.clone()
    sizes[label] = n_new
    return dataclasses.replace(index, data=data, data_norms=data_norms,
                               indices=indices, list_sizes=sizes)


# -- IVF-PQ (``ivf_pq_helpers.cuh``) ----------------------------------------


def pq_unpack_list_data(index: IvfPqIndex,
                        label: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes (size, pq_dim) uint8, ids (size,)) of one list —
    ``helpers::codepacker::unpack_list_data``. Nibble-packed 4-bit
    storage is expanded back to one code a byte."""
    expect(0 <= label < index.n_lists, "bad list id")
    size = int(index.list_sizes[label])
    codes = index.codes[label, :size]
    if index.packed:
        codes = _unpack_nibbles(codes)
    return codes, index.indices[label, :size]


def pq_reconstruct_list_data(index: IvfPqIndex, label: int) -> torch.Tensor:
    """Decode one list back to approximate input-space vectors —
    ``helpers::reconstruct_list_data``: ``c + Rᵀ · concat_s
    codebook_s[code_s]`` (R is orthogonal on its range)."""
    codes, _ = pq_unpack_list_data(index, label)
    size = codes.shape[0]
    c = codes.to(torch.int64)
    if index.codebook_kind == CodebookKind.PER_SUBSPACE:
        s = torch.arange(index.pq_dim, device=c.device)
        sub = index.codebooks[s[None, :], c]              # (size, S, L)
    else:
        sub = index.codebooks[label][c]                   # (size, S, L)
    flat = sub.reshape(size, index.pq_dim * index.pq_len)
    resid = flat[:, :index.dim_ext] @ index.rotation
    return index.centers[label][None, :] + resid


def pq_extract_centers(index: IvfPqIndex) -> torch.Tensor:
    """Cluster centers (n_lists, dim) — ``helpers::extract_centers``."""
    return index.centers
