"""Dense linear algebra primitives — port of ``raft_tpu/linalg``
(reference ``raft/linalg/``).

The reference wraps cuBLAS (gemm/gemv/axpy/dot), hand-writes elementwise
/ reduction CUDA kernels, and wraps cuSOLVER for factorizations. Here
the BLAS layer is ``torch.matmul`` with float32 sums, elementwise ops
and reductions are PyTorch expressions, and factorizations are
``torch.linalg`` calls, each on the handle's device. What the package
keeps is the reference's API surface: free functions taking a
``Resources`` handle + arrays, with the same semantics (row/col norms,
strided vs coalesced reductions, key-grouped reductions, rank-1 Cholesky
update, randomized SVD).
"""

from raft_tpu_torch.linalg.blas import axpy, dot, gemm, gemv
from raft_tpu_torch.linalg.elementwise import (
    add,
    binary_op,
    divide,
    map,  # noqa: A004
    map_offset,
    multiply,
    power,
    scalar_add,
    scalar_multiply,
    sqrt,
    subtract,
    ternary_op,
    transpose,
    unary_op,
)
from raft_tpu_torch.linalg.matrix_vector import matrix_vector_op
from raft_tpu_torch.linalg.reduce import (
    L1Norm,
    L2Norm,
    LinfNorm,
    coalesced_reduction,
    map_reduce,
    mean_squared_error,
    norm,
    normalize,
    reduce,
    reduce_cols_by_key,
    reduce_rows_by_key,
    strided_reduction,
)
from raft_tpu_torch.sparse.solver import lanczos_smallest  # noqa: F401  (linalg/lanczos alias)
from raft_tpu_torch.linalg.solvers import (
    cholesky_rank_one_update,
    eig_dc,
    eig_jacobi,
    lstsq,
    qr,
    rsvd,
    svd,
)

__all__ = [
    "axpy",
    "dot",
    "gemm",
    "gemv",
    "add",
    "binary_op",
    "divide",
    # ``map`` stays importable (reference parity: raft/linalg/map.cuh) but is
    # deliberately omitted from __all__ so star-imports don't shadow the
    # Python builtin.
    "map_offset",
    "transpose",
    "multiply",
    "power",
    "scalar_add",
    "scalar_multiply",
    "sqrt",
    "subtract",
    "ternary_op",
    "unary_op",
    "matrix_vector_op",
    "L1Norm",
    "L2Norm",
    "LinfNorm",
    "coalesced_reduction",
    "map_reduce",
    "mean_squared_error",
    "norm",
    "normalize",
    "reduce",
    "reduce_cols_by_key",
    "reduce_rows_by_key",
    "strided_reduction",
    "cholesky_rank_one_update",
    "lanczos_smallest",
    "eig_dc",
    "eig_jacobi",
    "lstsq",
    "qr",
    "rsvd",
    "svd",
]
