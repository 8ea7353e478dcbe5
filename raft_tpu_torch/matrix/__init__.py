"""Matrix primitives (reference ``raft/matrix/``): batched k-selection
and the dense matrix ops of :mod:`raft_tpu_torch.matrix.ops`, exported
here by the JAX package's names. ``select_k`` stays the module
(:mod:`raft_tpu_torch.matrix.select_k`, whose ``select_k`` function and
``merge_topk`` the port's searches use); the JAX package's namespace
names the function there."""

from raft_tpu_torch.matrix.select_k import SelectAlgo
from raft_tpu_torch.matrix.ops import (
    gather,
    gather_if,
    scatter,
    slice,
    argmax,
    argmin,
    col_sort,
    copy,
    diagonal,
    set_diagonal,
    eye,
    fill,
    l2_norm,
    linewise_op,
    power,
    ratio,
    reciprocal,
    reverse,
    sign_flip,
    sqrt,
    threshold,
    zero_small_values,
    triangular_upper,
    triangular_lower,
    matrix_print,
)

__all__ = [
    "SelectAlgo",
    "gather",
    "gather_if",
    "scatter",
    "slice",
    "argmax",
    "argmin",
    "col_sort",
    "copy",
    "diagonal",
    "set_diagonal",
    "eye",
    "fill",
    "l2_norm",
    "linewise_op",
    "power",
    "ratio",
    "reciprocal",
    "reverse",
    "sign_flip",
    "sqrt",
    "threshold",
    "zero_small_values",
    "triangular_upper",
    "triangular_lower",
    "matrix_print",
]
