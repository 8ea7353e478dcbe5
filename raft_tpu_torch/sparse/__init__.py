"""Sparse primitives — port of ``raft_tpu/sparse`` (reference
``raft/sparse/``): COO/CSR containers, conversions, structure ops,
linalg (spmm/norm/symmetrize/transpose/add/laplacian), pairwise
distances, sparse kNN + kNN-graph construction + cross-component NN,
Borůvka MST and Lanczos.
"""

from raft_tpu_torch.sparse import convert
from raft_tpu_torch.sparse import distance
from raft_tpu_torch.sparse import linalg
from raft_tpu_torch.sparse import neighbors
from raft_tpu_torch.sparse import ops
from raft_tpu_torch.sparse import solver
from raft_tpu_torch.sparse.types import COO, CSR

__all__ = [
    "COO",
    "CSR",
    "convert",
    "distance",
    "linalg",
    "neighbors",
    "ops",
    "solver",
]
