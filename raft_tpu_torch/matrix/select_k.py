"""Batched k-selection — the port of ``raft_tpu/matrix/select_k.py``
(analog of ``matrix::select_k``, ``matrix/select_k.cuh:81``).

The dispatcher chooses among:

- ``TOPK``: exact selection in ``lax.top_k``'s order (equal values keep
  the lower index first), here a stable sort: ``torch.topk`` promises no
  order on ties, so the port never uses it;
- ``SORT``: a full stable sort (the same order);
- ``TILES``: the wide-row selector ``ops.fused_topk.select_k_tiles``,
  the hand-written CUDA kernel ``csrc/select_k.cu`` on the card;
- ``APPROX``: the TPU's approximate top-k unit in the JAX package. The
  card has no such unit: it runs the exact selection, as
  ``coarse_algo="approx"`` does in the IVF searches.

All return (values, indices) of shape (batch, k), indices int32.
"""

from __future__ import annotations

import enum
from typing import Optional, Tuple

import torch

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.core.validation import expect


class SelectAlgo(enum.Enum):
    """Mirrors the JAX package's ``SelectAlgo``."""

    AUTO = "auto"
    TOPK = "topk"          # exact, lower index first on ties
    APPROX = "approx"      # no GPU counterpart: runs exact
    SORT = "sort"          # full stable sort
    TILES = "tiles"        # the wide-row kernel (ops.select_k_tiles)


# TILES routing thresholds (the JAX package's): wide rows, small k
_TILES_MIN_N = 16384
_TILES_MAX_K = 64
_TILES_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _choose_algo(batch: int, n: int, k: int, dtype=torch.float32,
                 device="cpu") -> SelectAlgo:
    """The JAX package's dispatcher with one change: the TILES rule
    reads "values on a CUDA device" where the JAX package reads "the
    backend is a TPU". AUTO always resolves to an exact algorithm.

    - ``k == n`` or ``k > 3n/4``: a stable sort answers directly;
    - wide rows on the card (``n >= 16384``, ``k <= 64``, float32 /
      bfloat16 / float16 values): the wide-row kernel, which reads each
      row once. Caveat it shares with the JAX kernel: a row with fewer
      than k *finite* entries fills the remainder with index -1;
    - otherwise TOPK."""
    del batch
    if k == n or k * 4 > n * 3:
        return SelectAlgo.SORT
    if (n >= _TILES_MIN_N and k <= _TILES_MAX_K and dtype in _TILES_DTYPES
            and torch.device(device).type == "cuda"):
        return SelectAlgo.TILES
    return SelectAlgo.TOPK


def _select_k_impl(values: torch.Tensor, k: int, select_min: bool,
                   algo: SelectAlgo) -> Tuple[torch.Tensor, torch.Tensor]:
    if algo == SelectAlgo.TILES:
        from raft_tpu_torch.ops.fused_topk import select_k_tiles

        vals, idx = select_k_tiles(values, k, select_min)
        # the kernel compares in float32; hand back the caller's dtype
        # (sub-float32 inputs round-trip exactly)
        return vals.to(values.dtype), idx
    # TOPK, SORT and APPROX: lax.top_k's order is a stable sort's
    vals, pos = torch.sort(values, dim=-1, descending=not select_min,
                           stable=True)
    return vals[..., :k], pos[..., :k].to(torch.int32)


def merge_topk(best_d: torch.Tensor, best_i: torch.Tensor,
               cand_d: torch.Tensor, cand_i: torch.Tensor, k: int,
               select_min: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge a running top-k state with a new candidate block — the
    shared streamed-merge step of the tiled scans (role of the warp-level
    merge in ``detail/knn_brute_force.cuh:238-280``).

    Args: (batch, k) running values/ids + (batch, m) candidates.
    Returns merged (batch, k) values/ids. Equal values keep their
    position order (the running state first), as ``lax.top_k`` does:
    hence a stable sort, not ``torch.topk``.
    """
    cat_d = torch.cat([best_d, cand_d], dim=1)
    cat_i = torch.cat([best_i, cand_i], dim=1)
    new_d, pos = torch.sort(cat_d, dim=1, descending=not select_min,
                            stable=True)
    new_d, pos = new_d[:, :k], pos[:, :k]
    return new_d, torch.gather(cat_i, 1, pos)


def select_k(res: Optional[Resources], values, k: int,
             select_min: bool = True, index_values=None,
             algo: SelectAlgo = SelectAlgo.AUTO
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select the k smallest (or largest) entries of each row.

    Args:
      values: (batch, n) float scores, placed on the handle's device.
      k: how many to keep (k <= n).
      select_min: True -> smallest are best.
      index_values: optional (batch, n) int payload; the returned indices
        are gathered from it instead of being 0..n-1 positions.
      algo: force an algorithm, or AUTO for the dispatcher. The JAX
        package's ``recall_target`` (APPROX's knob) is not taken: APPROX
        runs exact here.

    Returns (values (batch, k), indices (batch, k) int32).
    """
    res = ensure_resources(res)
    values = res.put(values)
    expect(values.ndim == 2, "select_k expects (batch, n) values")
    n = values.shape[1]
    expect(0 < k <= n, f"k must be in (0, {n}], got {k}")
    if algo == SelectAlgo.AUTO:
        algo = _choose_algo(values.shape[0], n, k, values.dtype,
                            values.device)
    with tracing.range("raft_tpu.select_k"):
        vals, idx = _select_k_impl(values, k, select_min, algo)
    if index_values is not None:
        index_values = res.put(index_values)
        # a -1 column (a row short of finite values) wraps to the last
        # one, as jnp.take_along_axis reads negative indices
        pos = idx.to(torch.int64)
        idx = torch.gather(index_values, 1, torch.where(pos < 0, pos + n, pos))
    return vals, idx
