"""Combinatorial solvers — port of ``raft_tpu/solver`` (reference
``raft/solver/`` / ``raft/lap/``: ``solver/linear_assignment.cuh``).
"""

from raft_tpu_torch.solver.lap import LinearAssignmentProblem, linear_assignment

__all__ = ["LinearAssignmentProblem", "linear_assignment"]
