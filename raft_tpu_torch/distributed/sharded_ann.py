"""Index-per-shard ANN — port of ``raft_tpu/distributed/sharded_ann.py``:
raft-dask's MNMG pattern (one index per worker, merged at query time
with ``knn_merge_parts``).

The dataset is split into row shards; any single-device index family
(ivf_flat / ivf_pq / cagra / brute_force) is built per shard on that
shard's device (``Resources(device=...)``); a search fans out to every
shard and merges with the shared top-k merge. On one card every shard
is on ``cuda:0``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.neighbors.brute_force import knn_merge_parts


def _index_device(index) -> Optional[torch.device]:
    """The device of a sub-index's first tensor field, or None."""
    if dataclasses.is_dataclass(index):
        for f in dataclasses.fields(index):
            v = getattr(index, f.name)
            if isinstance(v, torch.Tensor):
                return v.device
    return None


@dataclasses.dataclass
class ShardedIndex:
    """Per-shard sub-indexes and their global row offsets."""

    shards: List[Any]
    offsets: List[int]
    search_fn: Callable  # (res, index, queries, k) -> (dists, ids)
    select_min: bool = True

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def search(self, res: Optional[Resources], queries, k: int,
               trace_id: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fan out to every shard, then merge (``sharded_ann.py:~55``):
        the queries are placed once per shard device, every shard's
        search is enqueued before anything waits, and the (q, k) parts
        come back to the handle's device for one ``knn_merge_parts``,
        offsets applied there. With ``trace_id``, a non-blocking poll
        measures each shard's arrival for the straggler detector
        (:func:`raft_tpu_torch.core.tracing.poll_shard_timings`)."""
        res = ensure_resources(res)
        queries = torch.as_tensor(queries)
        with tracing.range("raft_tpu.distributed.sharded_search"):
            t0 = time.perf_counter()
            devs = [_index_device(ix) for ix in self.shards]
            placed = {d: queries.to(d) for d in dict.fromkeys(devs)
                      if d is not None}
            parts = [self.search_fn(res, index, placed.get(dev, queries), k)
                     for index, dev in zip(self.shards, devs)]
            if trace_id is not None:
                timings = tracing.poll_shard_timings(parts, t0)
                tracing.record_mesh_spans(
                    "sharded_ann", t0, t0 + max(timings),
                    trace_ids=(trace_id,), shard_timings=timings)
            merge_dev = res.device
            parts_d = [d.to(merge_dev) for d, _ in parts]
            parts_i = [torch.where(i >= 0, i + off, i).to(merge_dev)
                       for (_, i), off in zip(parts, self.offsets)]
            return knn_merge_parts(torch.stack(parts_d),
                                   torch.stack(parts_i), self.select_min)


def build_sharded(res: Optional[Resources], build_fn: Callable,
                  search_fn: Callable, dataset, n_shards: Optional[int] = None,
                  devices: Optional[Sequence] = None,
                  select_min: bool = True) -> ShardedIndex:
    """Split ``dataset`` into row shards and build one sub-index each
    (``sharded_ann.py:117``). ``build_fn(res, shard)`` builds a sub-index
    with a handle on shard s's device (``devices[s % len(devices)]``,
    default the handle's device)."""
    res = ensure_resources(res)
    dataset = torch.as_tensor(dataset)
    expect(dataset.ndim == 2, "dataset must be (n, d)")
    if devices is None:
        devices = [res.device] * (n_shards or 1)
    if n_shards is None:
        n_shards = len(devices)
    n = dataset.shape[0]
    expect(n_shards <= n, "more shards than rows")
    bounds = [round(s * n / n_shards) for s in range(n_shards + 1)]
    shards, offsets = [], []
    with tracing.range("raft_tpu.distributed.build_sharded"):
        for s in range(n_shards):
            part = dataset[bounds[s]:bounds[s + 1]]
            dev = torch.device(devices[s % len(devices)])
            shard_res = (res if dev == res.device else Resources(
                device=dev, seed=res.seed,
                matmul_precision=res.matmul_precision,
                workspace_limit_bytes=res.workspace_limit_bytes))
            shards.append(build_fn(shard_res, part.to(dev)))
            offsets.append(bounds[s])
    return ShardedIndex(shards, offsets, search_fn, select_min)
