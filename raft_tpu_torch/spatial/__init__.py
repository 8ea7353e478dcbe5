"""The legacy ``spatial.knn`` names (reference ``raft/spatial/knn/
knn.cuh:89,125``), forwarding to :mod:`raft_tpu_torch.neighbors`."""

from raft_tpu_torch.spatial import knn

__all__ = ["knn"]
