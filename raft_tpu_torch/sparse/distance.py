"""Sparse pairwise distances — port of ``raft_tpu/sparse/distance.py``
(reference ``raft/sparse/distance/``, ``distance/distance.cuh:38-58``
supported-metric set). Two regimes, as in the JAX package:

- **full-width tiles** (default at moderate ``n_cols``): densify row
  tiles of both operands and reuse the dense 20-metric engine
  (``distance.pairwise._pairwise_distance_impl``). Memory is
  ``tile × n_cols``.
- **column-tiled expanded path** (the SPMV role, for text-scale widths):
  the expanded metrics (L2/IP/cosine) are functions of ``x·yᵀ``,
  ``‖x‖²``, ``‖y‖²`` only, so the Gram block accumulates over
  ``col_tile``-wide dense column slabs — memory is ``tile × col_tile``
  regardless of ``n_cols``. Row norms are one segment sum per tile.

Row tiles are sliced tight (``indptr`` read once on the host), so every
densify costs O(tile_nnz). Non-decomposable metrics on very wide inputs
fail loudly with the memory bound (``RAFT_TPU_SPARSE_TILE_MB`` raises it,
the JAX package's variable) instead of allocating ``tile × n_cols``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.distance.pairwise import _pairwise_distance_impl, matmul
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.sparse.types import CSR, _segment_sum

# expanded metrics: computable from (x·yT, |x|^2, |y|^2) alone, hence
# column-tileable. L2Unexpanded equals L2Expanded in exact arithmetic.
_DECOMPOSABLE = (
    DistanceType.InnerProduct,
    DistanceType.L2Expanded,
    DistanceType.L2SqrtExpanded,
    DistanceType.L2Unexpanded,
    DistanceType.L2SqrtUnexpanded,
    DistanceType.CosineExpanded,
)


def _tile_budget_mb() -> int:
    return int(os.environ.get("RAFT_TPU_SPARSE_TILE_MB", "2048"))


def _tight_row_slice(csr: CSR, indptr_host: np.ndarray, s: int,
                     e: int) -> CSR:
    """Rows [s, e) holding exactly their own entries — densifies in
    O(tile_nnz)."""
    o = int(indptr_host[s])
    end = int(indptr_host[e])
    indptr = torch.as_tensor((indptr_host[s:e + 1] - o).astype(np.int32)
                             ).to(csr.device)
    return CSR(indptr, csr.indices[o:end], csr.data[o:end],
               (e - s, csr.shape[1]))


def _dense_cols(csr: CSR, row_ids, cs: int, col_tile: int) -> torch.Tensor:
    """Dense (rows, col_tile) slab of the columns [cs, cs+col_tile) of a
    row-sliced CSR."""
    ind = csr.indices.to(torch.int64)
    valid = (row_ids >= 0) & (ind >= cs) & (ind < cs + col_tile)
    lin = torch.where(valid, row_ids.to(torch.int64) * col_tile + ind - cs,
                      csr.shape[0] * col_tile)
    out = torch.zeros(csr.shape[0] * col_tile + 1, dtype=csr.data.dtype,
                      device=csr.device)
    out.index_add_(0, lin, torch.where(valid, csr.data,
                                       torch.zeros_like(csr.data)))
    return out[:-1].reshape(csr.shape[0], col_tile)


def _row_sq_norms(csr: CSR) -> torch.Tensor:
    """Per-row Σ data² — one segment sum, independent of col tiling."""
    r = csr.row_ids()
    d = csr.data.to(torch.float32)
    sq = torch.where(r >= 0, d * d, torch.zeros_like(d))
    return _segment_sum(sq, r.clamp(min=0), csr.shape[0])


def _expanded_block(xt: CSR, yt: CSR, xn, yn, metric: DistanceType,
                    col_tile: int, n_cols: int) -> torch.Tensor:
    """One (x-tile, y-tile) distance block, Gram-accumulated over dense
    column slabs — never a full-width dense tile. Norms arrive
    precomputed (hoisted out of the slab loop)."""
    xr = xt.row_ids()
    yr = yt.row_ids()
    ip = torch.zeros((xt.shape[0], yt.shape[0]), dtype=torch.float32,
                     device=xt.device)
    for cs in range(0, n_cols, col_tile):
        ip += matmul(_dense_cols(xt, xr, cs, col_tile),
                     _dense_cols(yt, yr, cs, col_tile))
    if metric == DistanceType.InnerProduct:
        return ip
    if metric == DistanceType.CosineExpanded:
        denom = torch.sqrt(torch.clamp(xn[:, None] * yn[None, :], min=1e-30))
        return 1.0 - ip / denom
    d2 = torch.clamp(xn[:, None] + yn[None, :] - 2.0 * ip, min=0.0)
    if metric in (DistanceType.L2SqrtExpanded,
                  DistanceType.L2SqrtUnexpanded):
        return torch.sqrt(d2)
    return d2


def pairwise_distance(
    res: Optional[Resources],
    x: CSR,
    y: CSR,
    metric: DistanceType = DistanceType.L2Expanded,
    metric_arg: float = 2.0,
    tile: int = 2048,
    col_tile: Optional[int] = None,
) -> torch.Tensor:
    """Dense (m, n) distance matrix between CSR row sets —
    ``sparse::distance::pairwiseDistance``.

    ``col_tile`` bounds the dense slab width for the expanded metrics:
    ``None`` auto-enables column tiling (slab width 8192) once a
    full-width tile would exceed the ``RAFT_TPU_SPARSE_TILE_MB`` budget;
    pass an int to force it. Non-decomposable metrics (L1, Hamming, …)
    need full rows and are bounded by the same budget — past it they fail
    with the bound rather than allocate."""
    res = ensure_resources(res)
    assert x.shape[1] == y.shape[1], "column dims must match"
    expect(tile > 0, f"tile must be positive, got {tile}")
    m = x.shape[0]
    n = y.shape[0]
    n_cols = x.shape[1]
    itemsize = x.data.element_size()
    # ceil, not floor: a sub-MB tile must still compare > a 0 MB budget
    full_tile_mb = -(-(min(tile, max(m, n)) * n_cols * itemsize) // (1 << 20))
    decomposable = metric in _DECOMPOSABLE
    if col_tile is None and decomposable and full_tile_mb > _tile_budget_mb():
        col_tile = 8192
    if col_tile is not None:
        expect(col_tile > 0, f"col_tile must be positive, got {col_tile}")
        expect(decomposable,
               f"column tiling needs an expanded metric (got {metric!r}); "
               "L1/Lp/Hamming-family metrics need full rows")
        col_tile = min(col_tile, n_cols)
    else:
        expect(full_tile_mb <= _tile_budget_mb(),
               f"a {tile}×{n_cols} dense tile is ~{full_tile_mb} MB, over "
               f"the {_tile_budget_mb()} MB RAFT_TPU_SPARSE_TILE_MB budget "
               "— use an expanded metric (column-tiled) or shrink `tile`")

    xip = x.indptr.cpu().numpy()
    yip = y.indptr.cpu().numpy()
    ip_metric = metric == DistanceType.InnerProduct
    with tracing.range("raft_tpu.sparse.pairwise_distance"):
        # y tiles (and their norms) are reused across every x tile
        ytiles = [_tight_row_slice(y, yip, ys, min(ys + tile, n))
                  for ys in range(0, n, tile)]
        yns = (None if col_tile is None or ip_metric
               else [_row_sq_norms(yt) for yt in ytiles])
        rows = []
        for xs in range(0, m, tile):
            xe = min(xs + tile, m)
            xt = _tight_row_slice(x, xip, xs, xe)
            if col_tile is not None:
                xn = None if ip_metric else _row_sq_norms(xt)
                cols = [_expanded_block(xt, yt, xn,
                                        None if yns is None else yns[j],
                                        metric, col_tile, n_cols)
                        for j, yt in enumerate(ytiles)]
            else:
                xd = xt.to_dense()
                cols = [_pairwise_distance_impl(
                    xd, yt.to_dense(), metric, metric_arg, "highest",
                    res.workspace_limit_bytes) for yt in ytiles]
            rows.append(cols[0] if len(cols) == 1
                        else torch.cat(cols, dim=1))
        return rows[0] if len(rows) == 1 else torch.cat(rows, dim=0)
