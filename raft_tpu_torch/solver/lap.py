"""Linear assignment (LAP) — port of ``raft_tpu/solver/lap.py`` (analog
of ``solver::LinearAssignmentProblem``, ``solver/linear_assignment.cuh``,
the batched Date–Nagi Hungarian solver).

As in the JAX package, the **auction algorithm** (Bertsekas) with
ε-scaling: every bidding round is a (n, n) matrix of values, a top-2 per
row and a max per column, exact for integer costs once ε < 1/n. The
JAX package's ``while_loop`` is a Python loop here that reads "any row
unassigned" from the device once every :data:`_CHECK_EVERY` rounds (a
round with every row assigned changes nothing). Ties follow the JAX
package: a row bids for its first best column (``lax.top_k``'s lower
index), and a column goes to its first highest bidder (``argmax``).
Each solve adds its ε-phases and bidding rounds to the counters
``solver.lap.phases`` and ``solver.lap.iterations``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.core.validation import expect

_NEG = -1e30
#: bidding rounds between two reads of "any row unassigned"
_CHECK_EVERY = 8


def _auction_phase(benefit: torch.Tensor, prices: torch.Tensor,
                   eps: float, max_iter: int):
    """One ε-phase of the auction: bid until all rows are assigned (or
    ``max_iter`` rounds). Returns (assignment, prices, the rounds that
    found a row unassigned: the JAX package's iteration count)."""
    n = benefit.shape[0]
    dev = benefit.device
    ar = torch.arange(n, dtype=torch.int32, device=dev)
    ar64 = ar.to(torch.int64)
    assign_row = torch.full((n,), -1, dtype=torch.int32, device=dev)
    owner_col = torch.full((n,), -1, dtype=torch.int32, device=dev)
    eps_t = torch.tensor(eps, dtype=torch.float32, device=dev)
    busy = torch.zeros((), dtype=torch.int64, device=dev)
    it = 0
    while it < max_iter:
        for _ in range(min(_CHECK_EVERY, max_iter - it)):
            unassigned = assign_row < 0                      # (n,)
            busy += unassigned.any()
            vals = benefit - prices[None, :]                 # (n, n)
            # top-2: the first maximum, then the maximum of the rest
            w1, jstar = torch.max(vals, dim=1)
            vals[ar64, jstar] = float("-inf")
            w2 = torch.amax(vals, dim=1)
            bid = prices[jstar] + (w1 - w2) + eps_t          # (n,)
            bid = torch.where(unassigned, bid, _NEG)

            # per column: the highest bid, then its first bidder
            col_best = torch.full((n,), _NEG, dtype=torch.float32,
                                  device=dev).scatter_reduce_(
                0, jstar, bid, "amax")
            top = unassigned & (bid == col_best[jstar])
            col_winner = torch.full((n,), n, dtype=torch.int32,
                                    device=dev).scatter_reduce_(
                0, jstar, torch.where(top, ar, n), "amin")
            has_bid = col_best > _NEG / 2

            prices = torch.where(has_bid, col_best, prices)
            # unassign previous owners of re-auctioned columns (dummy slot
            # n takes the columns without a bid, and is sliced off)
            prev_owner = torch.where(has_bid, owner_col, -1)
            lost = torch.zeros((n + 1,), dtype=torch.bool, device=dev)
            lost[torch.where(prev_owner >= 0, prev_owner, n).to(
                torch.int64)] = True
            assign_row = torch.where(lost[:n], -1, assign_row)
            owner_col = torch.where(has_bid, col_winner, owner_col)
            # winners take their columns
            assign_buf = torch.cat([assign_row, assign_row.new_zeros(1)])
            assign_buf[torch.where(has_bid, col_winner, n).to(
                torch.int64)] = ar
            assign_row = assign_buf[:n]
            it += 1
        if not bool((assign_row < 0).any()):
            break
    return assign_row, prices, int(busy)


def linear_assignment(
    res: Optional[Resources],
    cost,
    *,
    maximize: bool = False,
    eps_scaling_factor: float = 4.0,
    max_iter_per_phase: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve min-cost (or max-benefit) one-to-one assignment on a square
    cost matrix — the ``LinearAssignmentProblem::solve`` API.

    Returns (row_assignment, total_cost) where ``row_assignment[i]`` is
    the column assigned to row i.
    """
    res = ensure_resources(res)
    cost = res.put(cost).to(torch.float32)
    expect(cost.ndim == 2 and cost.shape[0] == cost.shape[1],
           "linear_assignment expects a square cost matrix")
    n = cost.shape[0]
    benefit = cost if maximize else -cost
    max_iter = max_iter_per_phase or (50 * n + 1000)

    with tracing.range("raft_tpu.solver.lap"):
        # ε-scaling: from max|benefit|/2 down past 1/(n+1)
        spread = float(torch.amax(torch.abs(benefit)))
        eps = max(spread / 2.0, 1.0 / (n + 1))
        prices = torch.zeros((n,), dtype=torch.float32, device=res.device)
        phases = rounds = 0
        while True:
            assign, prices, it = _auction_phase(benefit, prices, eps,
                                                max_iter)
            phases += 1
            rounds += it
            if eps <= 1.0 / (n + 1):
                break
            eps = max(eps / eps_scaling_factor, 1.0 / (n + 1))
        tracing.inc_counters({"solver.lap.phases": phases,
                              "solver.lap.iterations": rounds})
        total = torch.sum(torch.gather(
            cost, 1, assign.clamp(min=0).to(torch.int64)[:, None])[:, 0])
        return assign, total


class LinearAssignmentProblem:
    """Object API mirroring ``solver::LinearAssignmentProblem``
    (``solver/linear_assignment.cuh``): batched solve with accessors."""

    def __init__(self, res: Optional[Resources], size: int,
                 batch_size: int = 1):
        self._res = ensure_resources(res)
        self.size = size
        self.batch_size = batch_size
        self._assignments = None
        self._costs = None

    def solve(self, cost_batch):
        """cost_batch: (batch, n, n) or (n, n)."""
        cost_batch = self._res.put(cost_batch).to(torch.float32)
        if cost_batch.ndim == 2:
            cost_batch = cost_batch[None]
        outs = [linear_assignment(self._res, c) for c in cost_batch]
        self._assignments = torch.stack([a for a, _ in outs])
        self._costs = torch.stack([c for _, c in outs])
        return self._assignments

    @property
    def row_assignments(self):
        return self._assignments

    @property
    def objective_values(self):
        return self._costs
