"""Masked L2 nearest neighbour — port of ``raft_tpu/distance/masked_nn.py``
(reference ``distance/masked_nn.cuh``): ``masked_l2_nn`` and its bitfield
helper ``compress_to_bits``.

The group mask becomes a ``+inf`` select after each block's product, as
in the JAX package; blocks of rows keep the (rows, n) distance buffer
within the handle's ``workspace_limit_bytes``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.distance.pairwise import matmul


def compress_to_bits(res: Optional[Resources], mask) -> torch.Tensor:
    """Pack a boolean (m, n) matrix into 32-bit words along rows,
    ``distance::compress_to_bits``: ``out[i, w]`` holds bits
    ``[32w, 32w + 32)`` of row i, LSB first — the JAX package's uint32
    layout, returned as int32 with the same bits (as the port's filters
    hold their words)."""
    res = ensure_resources(res)
    mask = res.put(mask).to(torch.bool)
    m, n = mask.shape
    n_words = (n + 31) // 32
    bits = torch.nn.functional.pad(mask.to(torch.int64),
                                   (0, n_words * 32 - n))
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=mask.device),
        torch.arange(32, device=mask.device))
    words = (bits.reshape(m, n_words, 32) * weights).sum(dim=2)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32)


def masked_l2_nn(res: Optional[Resources], x, y, adj, group_idxs, *,
                 sqrt: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """For every row of ``x``, the L2-nearest row of ``y`` among the groups
    ``adj`` enables — ``distance::masked_l2_nn``.

    ``adj`` is (m, n_groups) boolean; ``group_idxs`` (n_groups,) the *end*
    offset of each group in ``y``'s rows (group g spans ``[group_idxs[g -
    1], group_idxs[g])``). Returns ``(min_dists (m,) float32, min_indices
    (m,) int32)``, squared unless ``sqrt``; ties go to the first row, and a
    row with no enabled group gets ``inf`` / ``-1``."""
    res = ensure_resources(res)
    x = res.put(x)
    y = res.put(y)
    adj = res.put(adj).to(torch.bool)
    group_idxs = res.put(group_idxs).to(torch.int64)
    m = x.shape[0]
    n = y.shape[0]
    n_groups = adj.shape[1]
    expect(group_idxs.shape[0] == n_groups,
           "masked_l2_nn: adj and group_idxs disagree on group count")
    group_of_y = torch.searchsorted(
        group_idxs, torch.arange(n, device=y.device), right=True)
    group_of_y = torch.clamp(group_of_y, 0, n_groups - 1)
    rows = max(1, res.workspace_limit_bytes // (4 * max(n, 1)))
    yf = y.to(torch.float32)
    yn = (yf * yf).sum(dim=1)
    with tracing.range("raft_tpu.distance.masked_l2_nn"):
        best_d = x.new_empty((m,), dtype=torch.float32)
        best_i = torch.empty((m,), dtype=torch.int32, device=x.device)
        for s in range(0, m, rows):
            xt = x[s:s + rows].to(torch.float32)
            dist = (xt * xt).sum(dim=1)[:, None] + yn[None, :] \
                - 2.0 * matmul(xt, yf, res.matmul_precision)
            dist = torch.clamp(dist, min=0.0)
            allowed = adj[s:s + rows][:, group_of_y]
            dist = torch.where(allowed, dist,
                               torch.full_like(dist, float("inf")))
            d, i = torch.min(dist, dim=1)
            fin = torch.isfinite(d)
            best_i[s:s + rows] = torch.where(fin, i, -1).to(torch.int32)
            best_d[s:s + rows] = torch.sqrt(d) if sqrt else d
        return best_d, best_i
