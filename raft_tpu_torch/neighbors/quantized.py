"""Scalar-quantized (8-bit) exact kNN — port of
``raft_tpu/neighbors/quantized.py`` (the role of the reference's
``ann_quantized`` wrapper, ``spatial/knn/detail/ann_quantized.cuh``).

An affine int8 quantizer ``x ≈ scale · (code + zero)`` with one global
(scale, zero) pair fitted to the data range. Search takes the
query-dataset inner products as an int8 x int8 -> int32 product and
expands the affine terms:

    <x, y> ≈ s² (<qx, qy> + z·Σqx + z·Σqy + d·z²)

The int8 product is a plain large product, which the JAX package leaves
to XLA: here it is ``torch._int_mm`` on the card and an exact int32
matmul on the CPU, tile by tile, each tile's top-k merged by
``merge_topk`` as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.core.serialize import (
    check_version,
    deserialize_array,
    deserialize_scalar,
    open_maybe_path,
    serialize_array,
    serialize_scalar,
)
from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.matrix.select_k import merge_topk

_SERIALIZATION_VERSION = 1

_SUPPORTED = (
    DistanceType.L2Expanded,
    DistanceType.L2SqrtExpanded,
    DistanceType.InnerProduct,
)


@dataclasses.dataclass(frozen=True)
class QuantizedIndex:
    """int8 codes + affine parameters + cached code row sums."""

    codes: torch.Tensor        # (n, d) int8
    row_sums: torch.Tensor     # (n,) int32  Σ codes per row
    scale: float
    zero: float
    metric: DistanceType

    @property
    def size(self) -> int:
        return self.codes.shape[0]

    @property
    def dim(self) -> int:
        return self.codes.shape[1]


def _quantize(x: torch.Tensor, scale: float, zero: float) -> torch.Tensor:
    """``clip(round(x / scale - zero), -127, 127)`` in float32, the
    division by a tensor (correctly rounded on every device)."""
    s = torch.tensor(scale, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x / s - zero), -127, 127).to(torch.int8)


def build(res: Optional[Resources], dataset,
          metric: DistanceType = DistanceType.L2Expanded) -> QuantizedIndex:
    """Fit the affine quantizer and encode the dataset."""
    res = ensure_resources(res)
    dataset = res.put(dataset, torch.float32)
    expect(dataset.ndim == 2, "dataset must be (n, d)")
    expect(DistanceType(metric) in _SUPPORTED,
           f"quantized knn supports L2/InnerProduct, got {metric!r}")
    with tracing.range("raft_tpu.quantized.build"):
        lo = dataset.min()
        hi = dataset.max()
        scale = float(torch.clamp(hi - lo, min=1e-12)) / 254.0
        zero = float(lo) / scale + 127.0  # maps lo -> -127
        codes = _quantize(dataset, scale, zero)
        row_sums = codes.to(torch.int32).sum(dim=1, dtype=torch.int32)
        return QuantizedIndex(codes, row_sums, scale, zero,
                              DistanceType(metric))


def _gram(q_codes: torch.Tensor, tile: torch.Tensor) -> torch.Tensor:
    """(q, t) int32 ``q_codes @ tile.T``: ``torch._int_mm`` on the card
    (it takes more than 16 rows, an inner width and columns in multiples of
    8, and the second operand column-major: the transpose of the padded
    tile), an exact int32 product otherwise."""
    if q_codes.device.type == "cuda":
        q, d = q_codes.shape
        qp = max(17, q)
        dp = -(-d // 8) * 8
        tp = -(-tile.shape[0] // 8) * 8
        a = torch.nn.functional.pad(q_codes, (0, dp - d, 0, qp - q))
        b = torch.nn.functional.pad(tile, (0, dp - d, 0, tp - tile.shape[0]))
        return torch._int_mm(a, b.T)[:q, :tile.shape[0]]
    return q_codes.to(torch.int32) @ tile.to(torch.int32).T


def _search_impl(q_codes, q_sums, codes, row_sums, scale: float, zero: float,
                 k: int, metric: DistanceType, tile: int):
    nq, d = q_codes.shape
    n = codes.shape[0]
    select_min = metric != DistanceType.InnerProduct
    pad_val = float("inf") if select_min else float("-inf")
    s2 = scale * scale
    z = zero
    # decode is x = scale * (code + zero), so
    # <x, y> = s²(qx·qy + z·Σqx + z·Σqy + d·z²)
    qn = s2 * torch.square(q_codes.to(torch.float32) + z).sum(dim=1)
    best_d = torch.full((nq, k), pad_val, device=codes.device)
    best_i = torch.full((nq, k), -1, dtype=torch.int32, device=codes.device)
    for start in range(0, n, tile):
        ct = codes[start:start + tile]
        st = row_sums[start:start + tile].to(torch.float32)
        gram = _gram(q_codes, ct).to(torch.float32)
        ip = s2 * (gram + z * q_sums.to(torch.float32)[:, None]
                   + z * st[None, :] + d * z * z)
        if select_min:
            yn = s2 * torch.square(ct.to(torch.float32) + z).sum(dim=1)
            dist = torch.clamp(qn[:, None] + yn[None, :] - 2.0 * ip, min=0.0)
        else:
            dist = ip
        kk = min(k, dist.shape[1])
        vals, pos = torch.sort(dist, dim=1, descending=not select_min,
                               stable=True)
        tgi = (pos[:, :kk] + start).to(torch.int32)
        best_d, best_i = merge_topk(best_d, best_i, vals[:, :kk], tgi, k,
                                    select_min)
    if metric == DistanceType.L2SqrtExpanded:
        best_d = torch.where(torch.isfinite(best_d), torch.sqrt(best_d),
                             best_d)
    return best_d, best_i


def search(res: Optional[Resources], index: QuantizedIndex, queries, k: int,
           db_tile: int = 32768) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate kNN over the int8 codes (distances in the de-quantized
    scale)."""
    res = ensure_resources(res)
    queries = res.put(queries, torch.float32)
    expect(queries.ndim == 2 and queries.shape[1] == index.dim,
           "queries must be (q, dim)")
    expect(0 < k <= index.size, f"k must be in (0, {index.size}]")
    with tracing.range("raft_tpu.quantized.search"):
        q_codes = _quantize(queries, index.scale, index.zero)
        q_sums = q_codes.to(torch.int32).sum(dim=1, dtype=torch.int32)
        tile = min(db_tile, max(128, index.size))
        return _search_impl(q_codes, q_sums, index.codes, index.row_sums,
                            index.scale, index.zero, k, index.metric, tile)


def knn(res: Optional[Resources], dataset, queries, k: int,
        metric: DistanceType = DistanceType.L2Expanded
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-shot build + search (the ``ann_quantized`` call shape)."""
    index = build(res, dataset, metric)
    return search(res, index, queries, k)


# -- serialization ----------------------------------------------------------


def save(index: QuantizedIndex, fh_or_path) -> None:
    fh, own = open_maybe_path(fh_or_path, "wb")
    try:
        serialize_scalar(fh, _SERIALIZATION_VERSION, np.int32)
        serialize_scalar(fh, int(index.metric), np.int32)
        serialize_scalar(fh, index.scale, np.float64)
        serialize_scalar(fh, index.zero, np.float64)
        serialize_array(fh, index.codes)
        serialize_array(fh, index.row_sums)
    finally:
        if own:
            fh.close()


def load(res: Optional[Resources], fh_or_path) -> QuantizedIndex:
    res = ensure_resources(res)
    fh, own = open_maybe_path(fh_or_path, "rb")
    try:
        check_version(deserialize_scalar(fh), _SERIALIZATION_VERSION,
                      "quantized")
        metric = DistanceType(int(deserialize_scalar(fh)))
        scale = float(deserialize_scalar(fh))
        zero = float(deserialize_scalar(fh))
        codes = res.put(deserialize_array(fh))
        row_sums = res.put(deserialize_array(fh))
    finally:
        if own:
            fh.close()
    return QuantizedIndex(codes, row_sums, scale, zero, metric)
