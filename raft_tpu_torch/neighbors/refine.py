"""Refinement — exact re-ranking of ANN candidates; port of
``raft_tpu/neighbors/refine.py`` (analog of ``raft::neighbors::refine``,
``neighbors/refine-inl.cuh``).

Gather the candidate rows, one batched product for their exact
distances, and a stable selection of the best k (``lax.top_k``'s order:
equal distances keep the earlier candidate). Plain PyTorch: it is the
rerank a codes-only IVF-BQ search needs after its estimate-only scan.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.distance.types import DistanceType, is_min_close


def _refine_impl(dataset, queries, candidates, k: int, metric: DistanceType):
    select_min = is_min_close(metric)
    pad_val = float("inf") if select_min else float("-inf")
    qf = queries.to(torch.float32)
    rows = dataset[candidates.clamp(min=0).to(torch.int64)].to(
        torch.float32)                                          # (q, c, d)
    ip = torch.einsum("qcd,qd->qc", rows, qf)
    if metric == DistanceType.InnerProduct:
        dist = ip
    else:
        dist = ((rows * rows).sum(dim=2) - 2.0 * ip
                + (qf * qf).sum(dim=1)[:, None])
        dist = torch.clamp(dist, min=0.0)
        if metric == DistanceType.L2SqrtExpanded:
            dist = torch.sqrt(dist)
    dist = torch.where(candidates >= 0, dist, torch.full_like(dist, pad_val))
    vals, pos = torch.sort(dist, dim=1, descending=not select_min,
                           stable=True)
    return vals[:, :k], torch.gather(candidates, 1, pos[:, :k])


def refine(res: Optional[Resources], dataset, queries, candidates, k: int,
           metric: DistanceType = DistanceType.L2Expanded
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-rank ``candidates`` (q, n_cand int32, -1 = missing) by exact
    distance against ``dataset``; return the top k of each row
    (``neighbors::refine(handle, dataset, queries, candidates, k)``)."""
    res = ensure_resources(res)
    dataset = res.put(dataset)
    queries = res.put(queries)
    candidates = res.put(candidates, torch.int32)
    expect(dataset.ndim == 2 and queries.ndim == 2,
           "dataset/queries must be 2-D")
    expect(queries.shape[1] == dataset.shape[1], "dim mismatch")
    expect(candidates.ndim == 2 and candidates.shape[0] == queries.shape[0],
           "candidates must be (n_queries, n_candidates)")
    expect(k <= candidates.shape[1], "k larger than candidate count")
    with tracing.range("raft_tpu.refine"):
        return _refine_impl(dataset, queries, candidates, k,
                            DistanceType(metric))
