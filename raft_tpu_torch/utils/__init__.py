"""Shared utilities: recall with distance-tie tolerance."""

from raft_tpu_torch.utils.recall import eval_neighbours, eval_recall

__all__ = ["eval_recall", "eval_neighbours"]
