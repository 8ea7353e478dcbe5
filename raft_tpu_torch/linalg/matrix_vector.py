"""Broadcast matrix ± vector ops — port of ``raft_tpu/linalg/
matrix_vector.py`` (reference ``linalg::matrix_vector_op``,
``linalg/matrix_vector_op.cuh``): one broadcast on the handle's device.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.core.validation import expect


def matrix_vector_op(
    res: Optional[Resources],
    matrix,
    vec,
    op: Callable = torch.add,
    *,
    along_rows: bool = True,
):
    """Apply ``op(matrix, vec)`` broadcasting ``vec`` along rows or columns.

    ``along_rows=True`` broadcasts over the row axis (vec has one entry per
    column), matching the reference's ``bcastAlongRows``.
    """
    res = ensure_resources(res)
    matrix, vec = res.put(matrix), res.put(vec)
    if along_rows:
        expect(vec.shape[0] == matrix.shape[1], "matrix_vector_op: |vec| != n_cols")
        return op(matrix, vec[None, :])
    expect(vec.shape[0] == matrix.shape[0], "matrix_vector_op: |vec| != n_rows")
    return op(matrix, vec[:, None])
