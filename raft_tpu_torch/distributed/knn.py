"""Distributed exact kNN — port of ``raft_tpu/distributed/knn.py``:
per-shard top-k + all-gather merge, and a ring-pass variant for sharded
query sets (raft-dask's MNMG pattern: one part per worker, local brute
force, ``knn_merge_parts``, ``detail/knn_merge_parts.cuh``).

The dataset is row-sharded over the comms axis's slots; each slot scans
its rows with the single-device tiled scan
(:func:`raft_tpu_torch.neighbors.brute_force._knn_scan_fn`: the pairwise
module's distances, a stable top-k per tile), the parts are all-gathered
and merged. :func:`brute_force_knn_ring` shards the queries too, and each
query block visits every dataset shard around the ring
(``device_sendrecv``), carrying its running top-k.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.comms.comms import Comms, allgather, device_sendrecv
from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.distance.types import DistanceType, is_min_close
from raft_tpu_torch.matrix.select_k import merge_topk
from raft_tpu_torch.neighbors.brute_force import (
    _knn_scan_fn,
    knn_merge_parts,
)


def _traced_knn_dispatch(family: str, trace_id, q: int, k: int, r: int,
                         axis: str, thunk):
    """Opt-in span recording of the exact-kNN mesh calls through the
    shared :func:`raft_tpu_torch.distributed.ivf.record_dispatch`: no
    coarse phase; the merge span carries each shard's (q, k) pairs."""
    from raft_tpu_torch.distributed.ivf import record_dispatch

    merge_bytes = q * k * 8
    return record_dispatch(
        family, None, trace_id, thunk, axis=axis,
        phases={"scan": {"modeled": True, "wire_bytes": 0},
                "merge": {"modeled": True, "wire_bytes": merge_bytes}},
        modeled_bytes=float(merge_bytes), attrs={"shards": r})


def _as_tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device)


def _local_scan(queries, rows, k, metric, metric_arg, tile, base: int):
    d, i = _knn_scan_fn(queries, rows, k=k, metric=metric, tile=tile,
                        metric_arg=metric_arg)
    return d, torch.where(i >= 0, i + base, i)


def brute_force_knn(comms: Comms, dataset, queries, k: int,
                    metric: DistanceType = DistanceType.L2Expanded,
                    metric_arg: float = 2.0, db_tile: int = 32768,
                    trace_id: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN over a row-sharded dataset (``knn.py:65``): ``dataset``
    (n, d) is sharded over ``comms``'s axis (rows must divide it),
    ``queries`` (q, d) replicated. Returns (distances (q, k), global
    int32 ids (q, k)), single-device ``brute_force.knn``'s up to the order
    of ties."""
    dev = comms.mesh.slot_devices()[0]
    dataset = _as_tensor(dataset, dev)
    queries = _as_tensor(queries, dev)
    expect(dataset.ndim == 2 and queries.ndim == 2, "2-D inputs required")
    expect(dataset.shape[0] % comms.size == 0,
           "dataset rows must divide the mesh axis (pad the dataset)")
    n_local = dataset.shape[0] // comms.size
    expect(0 < k <= n_local, "k must be <= rows per shard")
    select_min = is_min_close(metric)
    tile = min(db_tile, max(128, n_local))
    axis = comms.axis

    def body(ds, qs):
        ranks = [comms.mesh.coord(s, axis) for s in range(len(ds))]
        parts = [_local_scan(q, x, k, metric, metric_arg, tile,
                             r * n_local) for x, q, r in zip(ds, qs, ranks)]
        all_d = allgather([p[0] for p in parts], axis)
        all_i = allgather([p[1] for p in parts], axis)
        merged = [knn_merge_parts(d, i, select_min)
                  for d, i in zip(all_d, all_i)]
        return [m[0] for m in merged], [m[1] for m in merged]

    from raft_tpu_torch.comms.comms import P

    with tracing.range("raft_tpu.distributed.brute_force_knn"):
        return _traced_knn_dispatch(
            "dist_knn", trace_id, queries.shape[0], k, comms.size, axis,
            lambda: comms.run(body, dataset, queries,
                              in_specs=(P(axis, None), P()),
                              out_specs=(P(), P())))


def brute_force_knn_ring(comms: Comms, dataset, queries, k: int,
                         metric: DistanceType = DistanceType.L2Expanded,
                         metric_arg: float = 2.0, db_tile: int = 32768,
                         trace_id: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN with the dataset AND the queries row-sharded
    (``knn.py:126``): R rounds, each a local scan + merge and one ring
    hop of (query block, running top-k); after R hops every block is home
    with its full merge. Returns (distances, global ids) in query order."""
    dev = comms.mesh.slot_devices()[0]
    dataset = _as_tensor(dataset, dev)
    queries = _as_tensor(queries, dev)
    expect(dataset.ndim == 2 and queries.ndim == 2, "2-D inputs required")
    R = comms.size
    expect(dataset.shape[0] % R == 0,
           "dataset rows must divide the mesh axis (pad the dataset)")
    expect(queries.shape[0] % R == 0,
           "query rows must divide the mesh axis (pad the queries)")
    n_local = dataset.shape[0] // R
    expect(0 < k <= n_local, "k must be <= rows per shard")
    select_min = is_min_close(metric)
    tile = min(db_tile, max(128, n_local))
    axis = comms.axis
    perm = [(i, (i + 1) % R) for i in range(R)]
    pad_val = float("inf") if select_min else float("-inf")

    def body(ds, qs):
        ranks = [comms.mesh.coord(s, axis) for s in range(len(ds))]
        state = [(q, q.new_full((q.shape[0], k), pad_val,
                                dtype=torch.float32),
                  torch.full((q.shape[0], k), -1, dtype=torch.int32,
                             device=q.device)) for q in qs]
        for _ in range(R):
            nxt = []
            for (blk, bd, bi), x, r in zip(state, ds, ranks):
                d_loc, i_loc = _local_scan(blk, x, k, metric, metric_arg,
                                           tile, r * n_local)
                bd, bi = merge_topk(bd, bi, d_loc, i_loc, k, select_min)
                nxt.append((blk, bd, bi))
            state = device_sendrecv(nxt, perm, axis)
        return [s[1] for s in state], [s[2] for s in state]

    from raft_tpu_torch.comms.comms import P

    with tracing.range("raft_tpu.distributed.brute_force_knn_ring"):
        return _traced_knn_dispatch(
            "dist_knn_ring", trace_id, queries.shape[0], k, R, axis,
            lambda: comms.run(body, dataset, queries,
                              in_specs=(P(axis, None), P(axis, None)),
                              out_specs=(P(axis, None), P(axis, None))))
