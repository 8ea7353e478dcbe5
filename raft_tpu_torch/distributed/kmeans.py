"""Distributed k-means — port of ``raft_tpu/distributed/kmeans.py``: the
all-reduced EM the reference runs MNMG (``calc_centers_and_sizes`` +
allreduce).

Each slot labels its rows against the replicated centers, sums its rows
by label (:func:`raft_tpu_torch.cluster.kmeans_balanced.segment_sum`, a
fixed order on every device), and an all-reduce of the sums and counts
over the comms axis gives the global M-step. The centroid-sum all-reduce
may ride a quantized wire (:func:`~raft_tpu_torch.comms.comms.
allreduce_quantized`); the counts always ride exact int32.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.cluster.kmeans import _kmeanspp_init
from raft_tpu_torch.cluster.kmeans_balanced import segment_sum
from raft_tpu_torch.comms.comms import (
    QUANT_BLOCK,
    REDUCE_WIRE_DTYPES,
    Comms,
    Op,
    P,
    allreduce,
    allreduce_quantized,
)
from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.validation import expect


def collective_payload_model(n_clusters: int, dim: int,
                             wire_dtype: str = "f32",
                             block: int = QUANT_BLOCK) -> dict:
    """Modeled per-EM-iteration wire bytes per shard (``kmeans.py:34``):
    the centroid-sum all-reduce on the chosen wire (int8 adds one f32
    scale per :data:`QUANT_BLOCK` features a centroid) and the exact
    int32 count reduction."""
    itemsize = {"f32": 4, "bf16": 2, "int8": 1}[wire_dtype]
    nb = -(-dim // block)
    scale = n_clusters * nb * 4 if wire_dtype == "int8" else 0
    sums = n_clusters * dim * itemsize + scale
    counts = n_clusters * 4
    return {"sums_bytes": sums, "counts_bytes": counts,
            "iter_bytes": sums + counts, "wire_dtype": wire_dtype}


def resolve_kmeans_wire(wire_dtype: str, n_clusters: int, dim: int) -> str:
    """``"auto"`` argmins the modeled per-iteration bytes over the
    reduce wires (ties prefer the wider wire); others validate."""
    if wire_dtype == "auto":
        return min(REDUCE_WIRE_DTYPES,
                   key=lambda wd: collective_payload_model(
                       n_clusters, dim, wd)["iter_bytes"])
    if wire_dtype not in REDUCE_WIRE_DTYPES:
        raise ValueError(
            f"wire_dtype must be 'auto' or one of {REDUCE_WIRE_DTYPES}, "
            f"got {wire_dtype!r}")
    return wire_dtype


def _sq_dist(x, centers):
    return ((x * x).sum(dim=1)[:, None] - 2.0 * (x @ centers.T)
            + (centers * centers).sum(dim=1)[None, :])


def initial_centers(x: torch.Tensor, n_clusters: int,
                    seed: int) -> torch.Tensor:
    """The fit's seeds: k-means++ on a strided subsample of at least
    ``max(2048, 4k)`` rows, from a generator on ``x``'s device seeded
    with ``seed`` (the reference MNMG k-means seeds on one worker too)."""
    n = x.shape[0]
    sub_size = min(n, max(2048, 4 * n_clusters))
    sub = x[::max(1, n // sub_size)][:sub_size]
    expect(n_clusters <= sub.shape[0], "n_clusters exceeds init subsample")
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    return _kmeanspp_init(gen, sub, n_clusters)


def fit(comms: Comms, x, n_clusters: int, n_iters: int = 20, seed: int = 0,
        wire_dtype: str = "f32", params=None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit k-means over a row-sharded dataset (``kmeans.py:77``). Returns
    (centers (k, d), inertia scalar). k-means++ seeds on a strided
    subsample (:func:`initial_centers`; the JAX package draws other
    numbers from the same seed), then ``n_iters`` all-reduced EM steps. ``params`` (a
    :class:`raft_tpu_torch.cluster.kmeans.KMeansParams`-like object with
    ``wire_dtype``) wins over the keyword."""
    if params is not None and hasattr(params, "wire_dtype"):
        wire_dtype = params.wire_dtype
    dev = comms.mesh.slot_devices()[0]
    x = torch.as_tensor(x).to(device=dev, dtype=torch.float32)
    expect(x.ndim == 2, "x must be (n, d)")
    n, d = x.shape
    wire_dtype = resolve_kmeans_wire(wire_dtype, n_clusters, d)
    expect(n % comms.size == 0,
           "rows must divide the mesh axis (pad the dataset)")
    expect(n_clusters <= n, "n_clusters > n_rows")
    axis = comms.axis
    centers0 = initial_centers(x, n_clusters, seed)

    def body(xs, cs):
        for _ in range(n_iters):
            labels = [torch.argmin(_sq_dist(xl, c), dim=1)
                      for xl, c in zip(xs, cs)]
            sums = [segment_sum(xl, lab, n_clusters)
                    for xl, lab in zip(xs, labels)]
            counts = [torch.bincount(lab, minlength=n_clusters)
                      for lab in labels]
            if wire_dtype == "f32":
                sums = allreduce(sums, Op.SUM, axis)
                counts = [c.to(torch.float32) for c in allreduce(
                    [c.to(torch.float32) for c in counts], Op.SUM, axis)]
            else:
                sums = allreduce_quantized(sums, Op.SUM, axis,
                                           wire_dtype=wire_dtype)
                counts = [c.to(torch.float32) for c in allreduce_quantized(
                    [c.to(torch.int32) for c in counts], Op.SUM, axis)]
            cs = [torch.where((cnt > 0)[:, None],
                              sm / torch.clamp(cnt, min=1.0)[:, None], c)
                  for sm, cnt, c in zip(sums, counts, cs)]
        inertia = allreduce([_sq_dist(xl, c).amin(dim=1).sum()
                             for xl, c in zip(xs, cs)], Op.SUM, axis)
        return cs, inertia

    with tracing.range("raft_tpu.distributed.kmeans_fit"):
        return comms.run(body, x, centers0, in_specs=(P(axis, None), P()),
                         out_specs=(P(), P()))
