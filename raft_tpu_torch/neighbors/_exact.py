"""Shared helpers of the graph indexes (nn_descent, cluster_join, cagra);
port of ``raft_tpu/neighbors/_exact.py``.

One implementation of the clip-gather / float32 inner product /
expanded-L2 pattern, the dedup mask both CAGRA search engines merge
with (so that their visited semantics cannot drift apart), and the
``lax.top_k`` order every selection of these modules keeps.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.distance.types import DistanceType


def dedup_candidate_mask(cand_ids: torch.Tensor,
                         buf_ids: torch.Tensor) -> torch.Tensor:
    """True where a candidate (q, C) duplicates a live buffer id (q, L)
    (the buffer copy wins) or an earlier candidate of its row (the first
    proposal wins). ``buf_ids`` must already carry dead slots as a value
    no candidate takes (-2)."""
    c = cand_ids.shape[1]
    dup_b = (cand_ids[:, :, None] == buf_ids[:, None, :]).any(dim=2)
    eq = cand_ids[:, :, None] == cand_ids[:, None, :]
    earlier = torch.ones((c, c), dtype=torch.bool,
                         device=cand_ids.device).tril(diagonal=-1)
    dup_c = (eq & earlier[None]).any(dim=2)
    return dup_b | dup_c


def gathered_distances(x: torch.Tensor, dataset: torch.Tensor,
                       cand_ids: torch.Tensor,
                       metric: DistanceType) -> torch.Tensor:
    """Distance from each row of ``x`` (t, d) float32 to its candidate
    dataset rows ``cand_ids`` (t, c): squared L2 for the L2 metrics,
    negated inner products for InnerProduct (min-form), +inf at ids < 0.
    The products are full float32 (the JAX package's HIGHEST precision;
    TF32 stays off)."""
    rows = dataset[cand_ids.clamp(min=0).to(torch.int64)].to(torch.float32)
    ip = torch.einsum("td,tcd->tc", x, rows)
    if metric == DistanceType.InnerProduct:
        d = -ip
    else:
        d = ((rows * rows).sum(dim=2) - 2.0 * ip
             + (x * x).sum(dim=1)[:, None])
        d = torch.clamp(d, min=0.0)
    return torch.where(cand_ids >= 0, d, torch.full_like(d, float("inf")))


def smallest_k(values: torch.Tensor, k: int):
    """The k smallest of each row and their positions, ties to the
    earlier position (``lax.top_k`` of the negated row: a stable sort)."""
    vals, pos = torch.sort(values, dim=1, stable=True)
    return vals[:, :k], pos[:, :k]
