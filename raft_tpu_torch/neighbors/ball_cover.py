"""Random ball cover — port of ``raft_tpu/neighbors/ball_cover.py``
(reference ``neighbors/ball_cover-inl.cuh``: ``build_index``,
``knn_query``, ``eps_nn_query``), the landmark kNN for low-dimensional
data, Haversine or L2.

``build_index`` samples ``sqrt(n)`` landmarks with the handle's
generator and files every row under its nearest landmark in a padded
(L, M) table of members, each ball sorted by distance to its landmark.
A query probes its ``n_probes`` nearest balls, gathers their members and
keeps the k nearest: one batched distance, one stable sort (ties to the
earlier candidate, as ``lax.top_k``). :func:`from_landmarks` is the
build's second half for given landmark rows.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.distance.pairwise import (
    _EPS_L2_CLAMP,
    _pairwise_distance_impl,
    haversine_formula,
)
from raft_tpu_torch.distance.types import DistanceType


@dataclasses.dataclass
class BallCoverIndex:
    """``BallCoverIndex`` analog (``ball_cover_types.hpp``)."""

    dataset: torch.Tensor        # (n, d)
    landmarks: torch.Tensor      # (L, d)
    members: torch.Tensor        # (L, M) int32 dataset row ids, -1 padding
    member_dists: torch.Tensor   # (L, M) float32 distance to the landmark
    radii: torch.Tensor          # (L,) float32 largest member distance
    metric: DistanceType

    @property
    def n_landmarks(self) -> int:
        return self.landmarks.shape[0]


def _nearest(res: Resources, x, landmarks, metric):
    """Each row's (distance, index) of its nearest landmark (the first on
    ties), in row blocks of the workspace budget."""
    rows = max(1, res.workspace_limit_bytes // (4 * landmarks.shape[0]))
    dist, own = [], []
    for s in range(0, x.shape[0], rows):
        d, i = torch.min(_pairwise_distance_impl(
            x[s:s + rows], landmarks, metric, 2.0, "highest"), dim=1)
        dist.append(d)
        own.append(i)
    return torch.cat(dist), torch.cat(own)


def from_landmarks(res: Optional[Resources], dataset, landmark_rows,
                   metric: DistanceType = DistanceType.L2SqrtExpanded
                   ) -> BallCoverIndex:
    """The index over ``dataset`` with the given rows as landmarks: each
    row joins its nearest landmark's ball, the balls sorted by (distance,
    row id) and padded to the largest."""
    res = ensure_resources(res)
    x = res.put(dataset)
    perm = res.put(landmark_rows).to(torch.int64)
    L, n = perm.shape[0], x.shape[0]
    landmarks = x[perm]
    dist_own, owner = _nearest(res, x, landmarks, DistanceType(int(metric)))
    # (owner, distance) order: a stable sort by distance, then by owner
    order = torch.sort(dist_own, stable=True).indices
    order = order[torch.sort(owner[order], stable=True).indices]
    counts = torch.bincount(owner, minlength=L)
    M = int(counts.max())
    starts = torch.cumsum(counts, 0) - counts
    rows_sorted = owner[order]
    pos = torch.arange(n, device=x.device) - starts[rows_sorted]
    members = torch.full((L, M), -1, dtype=torch.int32, device=x.device)
    mdists = torch.full((L, M), float("inf"), dtype=torch.float32,
                        device=x.device)
    members[rows_sorted, pos] = order.to(torch.int32)
    mdists[rows_sorted, pos] = dist_own[order]
    radii = torch.full((L,), float("-inf"), dtype=torch.float32,
                       device=x.device).scatter_reduce(
        0, owner, dist_own, "amax")
    return BallCoverIndex(x, landmarks, members, mdists, radii,
                          DistanceType(int(metric)))


def build_index(res: Optional[Resources], dataset,
                metric: DistanceType = DistanceType.L2SqrtExpanded, *,
                n_landmarks: Optional[int] = None) -> BallCoverIndex:
    """Sample ``sqrt(n)`` landmarks (``n_landmarks`` to choose) with the
    handle's generator and bucket every row into its nearest landmark's
    ball — ``ball_cover::build_index``."""
    res = ensure_resources(res)
    x = res.put(dataset)
    n = x.shape[0]
    L = n_landmarks or max(1, int(math.ceil(math.sqrt(n))))
    expect(L <= n, "ball_cover: more landmarks than points")
    with tracing.range("raft_tpu.neighbors.ball_cover.build"):
        perm = torch.randperm(n, generator=res.generator,
                              device=res.device)[:L]
        return from_landmarks(res, x, perm, metric)


def _candidate_distance(queries, cvecs, metric: DistanceType):
    """(q, c) distances of each query to its own (q, c, d) candidates:
    the pairwise module's forms, batched over queries for L2 and
    Haversine, one query at a time otherwise."""
    qf = queries.to(torch.float32)
    cf = cvecs.to(torch.float32)
    if metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded):
        ip = torch.bmm(cf, qf[:, :, None])[:, :, 0]
        val = (qf * qf).sum(dim=1)[:, None] + (cf * cf).sum(dim=2) - 2.0 * ip
        val = torch.clamp(val * (torch.abs(val) >= _EPS_L2_CLAMP), min=0.0)
        return torch.sqrt(val) if metric == DistanceType.L2SqrtExpanded \
            else val
    if metric == DistanceType.Haversine:
        expect(qf.shape[1] == 2, "Haversine requires 2-D (lat, lon) inputs")
        return haversine_formula(qf[:, 0][:, None], qf[:, 1][:, None],
                                 cf[:, :, 0], cf[:, :, 1])
    return torch.stack([
        _pairwise_distance_impl(qf[i:i + 1], cf[i], metric, 2.0,
                                "highest")[0]
        for i in range(qf.shape[0])])


def _query_batch(queries, index: BallCoverIndex, k: int, n_probes: int):
    q = queries.shape[0]
    M = index.members.shape[1]
    d_ql = _pairwise_distance_impl(queries, index.landmarks, index.metric,
                                   2.0, "highest")             # (q, L)
    probe = torch.sort(d_ql, dim=1, stable=True).indices[:, :n_probes]
    cand = index.members[probe].reshape(q, n_probes * M)
    valid = cand >= 0
    cand_safe = torch.where(valid, cand, torch.zeros_like(cand))
    dist = _candidate_distance(queries, index.dataset[cand_safe.to(
        torch.int64)], index.metric)
    dist = torch.where(valid, dist, torch.full_like(dist, float("inf")))
    topd, topi = torch.sort(dist, dim=1, stable=True)
    topd, topi = topd[:, :k], topi[:, :k]
    idx = torch.gather(cand_safe, 1, topi)
    return topd, torch.where(torch.isfinite(topd), idx,
                             torch.full_like(idx, -1))


def knn_query(res: Optional[Resources], index: BallCoverIndex, queries,
              k: int, *, n_probes: int = 0, tile: int = 1024
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest rows of each query (``ball_cover::knn_query``),
    ``(distances (q, k) float32, ids (q, k) int32)``, -1 where fewer
    candidates were found. ``n_probes=0`` probes ``sqrt(L) + k`` balls
    (exact on low-dimensional data as a rule; all L is exhaustive)."""
    res = ensure_resources(res)
    queries = res.put(queries)
    L = index.n_landmarks
    p = min(n_probes or min(L, int(math.ceil(math.sqrt(L))) + k), L)
    expect(k >= 1, "knn_query: k must be >= 1")
    expect(k <= p * index.members.shape[1],
           "knn_query: k exceeds the probed balls' slots")
    with tracing.range("raft_tpu.neighbors.ball_cover.knn"):
        outs = [_query_batch(queries[s:s + tile], index, k, p)
                for s in range(0, queries.shape[0], tile)]
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))


def eps_nn_query(res: Optional[Resources], index: BallCoverIndex, queries,
                 eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every row within radius eps of each query (``ball_cover::
    eps_nn_query``): ``(adjacency (q, n) bool, degrees (q,) int32)``, by
    the dense epsilon pass (:func:`~raft_tpu_torch.neighbors.
    epsilon_neighborhood.eps_neighbors`, squared L2), as the JAX package
    does."""
    from raft_tpu_torch.neighbors.epsilon_neighborhood import eps_neighbors

    return eps_neighbors(res, queries, index.dataset, eps)
