"""Kernel gram matrices — port of ``raft_tpu/distance/kernels.py``
(reference ``distance/detail/kernels/gram_matrix.cuh``): the LINEAR,
POLYNOMIAL, RBF and TANH gram matrices of SVM-style methods, each one
product of :mod:`raft_tpu_torch.distance.pairwise` and an epilog."""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.distance.pairwise import pairwise_distance
from raft_tpu_torch.distance.types import DistanceType


class KernelType(enum.IntEnum):
    LINEAR = 0
    POLYNOMIAL = 1
    RBF = 2
    TANH = 3


@dataclasses.dataclass(frozen=True)
class KernelParams:
    """Mirrors ``raft::distance::kernels::KernelParams``."""

    kernel: KernelType = KernelType.LINEAR
    degree: int = 3
    gamma: float = 1.0
    coef0: float = 0.0


def gram_matrix(res: Optional[Resources], x, y,
                params: KernelParams = KernelParams()) -> torch.Tensor:
    """``K(x_i, y_j)`` for every pair, (m, n) float32. LINEAR: <x,y>;
    POLYNOMIAL: (gamma <x,y> + coef0)^degree; RBF: exp(-gamma |x-y|^2);
    TANH: tanh(gamma <x,y> + coef0)."""
    res = ensure_resources(res)
    if params.kernel == KernelType.RBF:
        sq = pairwise_distance(res, x, y, DistanceType.L2Expanded)
        return torch.exp(-params.gamma * sq)
    ip = pairwise_distance(res, x, y, DistanceType.InnerProduct)
    if params.kernel == KernelType.LINEAR:
        return ip
    if params.kernel == KernelType.POLYNOMIAL:
        return torch.pow(params.gamma * ip + params.coef0, params.degree)
    if params.kernel == KernelType.TANH:
        return torch.tanh(params.gamma * ip + params.coef0)
    raise NotImplementedError(f"kernel {params.kernel!r}")
