"""Epsilon neighbourhood — port of ``raft_tpu/neighbors/
epsilon_neighborhood.py`` (reference ``epsNeighborhoodL2``): every pair
within radius eps as a dense boolean adjacency, with each row's degree
(the DBSCAN building block)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.distance.pairwise import _pairwise_distance_impl
from raft_tpu_torch.distance.types import DistanceType


def eps_neighbors(res: Optional[Resources], x, y, eps: float, *,
                  tile: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """``adj[i, j] = ||x_i - y_j||^2 <= eps^2`` ((m, n) bool) and the row
    degrees ((m,) int32) — ``eps_neighbors_l2sq``. ``eps`` is the radius;
    the compare is against squared ``L2Expanded`` distances (with its
    1e-4 rectifier), ``tile`` rows of ``x`` at a time."""
    res = ensure_resources(res)
    x = res.put(x)
    y = res.put(y)
    eps_sq = torch.tensor(eps, dtype=torch.float32) ** 2
    with tracing.range("raft_tpu.neighbors.eps_neighbors"):
        adj = torch.cat([
            _pairwise_distance_impl(x[s:s + tile], y, DistanceType.L2Expanded,
                                    2.0, "highest") <= eps_sq.to(x.device)
            for s in range(0, x.shape[0], tile)])
        return adj, adj.sum(dim=1, dtype=torch.int32)
