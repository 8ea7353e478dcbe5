"""Shape-stable serving: bucketed plans replayed as CUDA graphs — the
port of the bucketed half of ``raft_tpu/core/executor.py``.

The JAX package compiles each (index shapes, search params, bucket)
specialization ahead of time and calls the executable from then on. The
card's counterpart is a **CUDA graph**: the plan's whole search body
(coarse GEMM, probe planning, the hand-written kernel, the epilog) is
captured once per bucket and then replayed, so a request costs a query
copy, one replay and two output copies of host work instead of the
136-489 device operations its eager body issues.

- **Bucketing**: a batch is padded up to the smallest power-of-two bucket
  that holds it; every batch size in a bucket runs one plan entry. Pad
  rows repeat the batch's first row: every family's result is row-wise,
  so they cannot change a real row, and a repeat of row 0 adds no probed
  list to an IVF request that its real rows do not probe (a zero row
  would probe the lists nearest the origin), so the IVF work-item plans
  grow by no list. Batches larger than ``max_bucket`` are tiled at
  ``max_bucket``, the ragged tail padded into that bucket.
- **Capture** (``capture=None`` resolves to ``res.device.type ==
  "cuda"``): on a cache miss the plan runs once eagerly on a side stream
  (the kernels build at first use and their launch attributes settle),
  then one run is captured into a ``torch.cuda.CUDAGraph`` with its own
  memory pool, over a static padded query buffer, a static filter buffer
  where the plan takes a filter, and static outputs. A hit copies the
  queries in, replays, and returns **clones** of the static outputs,
  taken before the executor lock is released, so that the next replay
  cannot overwrite a result its caller holds. A capture that fails
  raises: the executor never falls back to eager on a CUDA index.
- **Eager plans**: with ``capture=False`` (the CPU, and the tests) the
  same cache, keys and counters hold eagerly called plan entries. Two
  plans are eager on the card too, decided from the plan and never after
  a failure: the tiered plans, whose staging plan is read on the host
  (``ops/tier_scan.py``) and whose scan waits on copy-stream events, and
  plans whose resolved engine is a plain ``torch`` engine (per-query
  filters, for instance), which loop on host reads.
- **Plans**: each family's ``serving_plan`` (in its ``neighbors``
  module) returns the body, its arrays and its statics (route, engine,
  clamped ``n_probes``, tiles); the family's direct ``search`` calls the
  same function, so the served and the direct results come from one
  decision.
- **Cache key**: shapes, dtypes and statics as in the JAX package, plus,
  for a captured plan, the ``data_ptr()`` of every tensor the graph
  bakes in (the index arrays and the probe plane): two same-shape
  indexes, or an ``extend()`` that returns a new index, never replay
  each other's graph. An entry holds its tensors, so their addresses
  stay valid until LRU eviction.
- **Counters**: ``ExecutorStats.compile_count`` and
  ``serving.compile_count`` count entry builds (captures on the card),
  so the JAX package's zero-steady-state-compile assertions carry over
  by name; ``serving.capture_seconds`` adds the capture time. A replay
  runs no Python, so each captured entry records the kernel launches
  (the wrappers' ``launches``) and the other counters its capture added,
  and every replay adds them again.
- **Probe accounting** (``probe_accounting=True``): an (n_lists,) int32
  plane per index, updated in place inside the captured call (pad rows
  masked by a static valid-row count), read and zeroed only at scrape
  time (:meth:`SearchExecutor.probe_frequencies`).

``executable_costs`` reports each entry's family, bucket, k, capture
seconds, kernel launches per replay and graph-pool bytes (the growth of
reserved device memory across its capture). XLA's modeled flops and
bytes have no counterpart yet.

Not ported yet: the ragged plan family (``ragged_key``,
``ragged_fallback_reason``, ``warmup_ragged``, ``search_ragged``), the
mesh plans, mesh tracing, and the IVF-PQ and tiered PQ/BQ plans (their
indexes are not ported): :meth:`SearchExecutor._plan` raises
``TypeError`` for them, as the JAX package does for an unknown index.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import hashlib
import threading
import time
import weakref
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.core.validation import expect

# counters a capture may add that belong to the request, not to the
# executor's own bookkeeping: replays add these again
_OWN_PREFIXES = ("serving.", "index.")


@dataclasses.dataclass
class ExecutorStats:
    """Serving-path counters (also exported through ``tracing``)."""

    compile_count: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    evictions: int = 0
    warmup_seconds: float = 0.0


@dataclasses.dataclass
class _Plan:
    """One bucket specialization: call order ``fn(queries, *arrays,
    [filter_words], [probe_counts, n_valid], **static)``."""

    key: tuple
    fn: Callable
    static: dict
    arrays: tuple
    device: torch.device
    use_filter: bool = False
    qdtype: torch.dtype = torch.float32
    qdim: int = 0
    # False: eager on the card too (tiered staging, plain engines)
    capturable: bool = True
    # (pkey, n_lists, family, label, index) with probe accounting on
    probe: Any = None


class _Entry:
    """A cached plan entry: eager (``graph`` None), or a captured graph
    with its static buffers, outputs and the tensors it bakes in."""

    __slots__ = ("family", "bucket", "k", "digest", "graph", "static_q",
                 "static_fw", "static_nv", "outputs", "keep", "launches",
                 "counters", "pool_bytes", "capture_seconds")

    def __init__(self, family: str, bucket: int, k: int, digest: str):
        self.family = family
        self.bucket = bucket
        self.k = k
        self.digest = digest
        self.graph = None
        self.static_q = None
        self.static_fw = None
        self.static_nv = None
        self.outputs = None
        self.keep = ()
        self.launches: dict = {}
        self.counters: dict = {}
        self.pool_bytes = 0
        self.capture_seconds = 0.0


def _kernel_wrappers() -> dict:
    """Every kernel wrapper's launch counter: name -> wrapper."""
    from raft_tpu_torch.ops.beam_search import beam_search
    from raft_tpu_torch.ops.bq_scan import bq_list_major_scan
    from raft_tpu_torch.ops.fused_topk import (
        fused_knn,
        select_k_tiles,
        stream_read_sum,
    )
    from raft_tpu_torch.ops.ivf_scan import list_major_scan
    from raft_tpu_torch.ops.tier_scan import tiered_list_major_scan

    return {"fused_knn": fused_knn, "list_major_scan": list_major_scan,
            "bq_scan": bq_list_major_scan, "select_k": select_k_tiles,
            "beam_search": beam_search, "tier_scan": tiered_list_major_scan,
            "stream_read_sum": stream_read_sum}


def _sig(*arrays) -> tuple:
    return tuple((tuple(a.shape), str(a.dtype)) for a in arrays
                 if a is not None)


def _statics(static: dict) -> tuple:
    return tuple(sorted((n, str(v)) for n, v in static.items()))


def _filter_spec(fw) -> tuple:
    if fw is None:
        return ("nofilter",)
    return ("filter", fw.ndim, fw.shape[-1], str(fw.dtype))


def _pad(t: torch.Tensor, rows: int, mode: str) -> torch.Tensor:
    """``t`` padded to ``rows`` along axis 0: repeats of its first row
    (``edge``) or zero rows (``zero``)."""
    q = t.shape[0]
    if q >= rows:
        return t
    if mode == "edge":
        fill = t[:1].expand((rows - q,) + tuple(t.shape[1:]))
    else:
        fill = t.new_zeros((rows - q,) + tuple(t.shape[1:]))
    return torch.cat([t, fill])


def _cost_gauges(digest: str, info: dict) -> dict:
    base = f"serving.executable.{digest}."
    return {base + "pool_bytes": float(info.get("pool_bytes", 0)),
            base + "launches": float(info.get("launches", 0)),
            base + "capture_seconds": info.get("capture_seconds", 0.0)}


class SearchExecutor:
    """Capture-once, replay-after search across the ported index families.

    Example::

        ex = SearchExecutor(res)
        ex.warmup(index, buckets=(8, 16, 32), k=10, params=sp)
        d, i = ex.search(index, queries, 10, params=sp)   # a replay

    Constructor args:
      res: the :class:`Resources` handle (device, workspace budget).
      min_bucket/max_bucket: power-of-two bucket ladder bounds. A batch
        larger than ``max_bucket`` is tiled at ``max_bucket``, its ragged
        tail padded into the same bucket.
      max_entries: LRU capacity of the plan cache (each captured entry
        holds its own graph memory pool).
      probe_accounting: thread an (n_lists,) int32 probe plane per IVF
        index through every dispatch (part of the cache key).
      capture: capture plans as CUDA graphs; None resolves to
        ``res.device.type == "cuda"``. ``True`` on a CPU index raises.
    """

    def __init__(self, res: Optional[Resources] = None, *,
                 min_bucket: int = 8, max_bucket: int = 4096,
                 max_entries: int = 64, probe_accounting: bool = False,
                 capture: Optional[bool] = None):
        self.res = ensure_resources(res)
        expect(0 < min_bucket <= max_bucket,
               f"need 0 < min_bucket <= max_bucket, got "
               f"({min_bucket}, {max_bucket})")
        buckets = []
        b = min_bucket
        while b < max_bucket:
            buckets.append(b)
            b *= 2
        buckets.append(max_bucket)
        self.buckets: Tuple[int, ...] = tuple(buckets)
        self.max_entries = max_entries
        self.probe_accounting = probe_accounting
        if capture is None:
            capture = self.res.device.type == "cuda"
        self.capture = bool(capture)
        # probe planes: pkey -> (n_lists,) int32 device plane (updated in
        # place, so a captured graph's address stays valid), descriptors,
        # host int64 lifetime totals, and pkeys whose index died (GC
        # finalizers only append; the list drains under the lock)
        self._probe_state: dict = {}   # guarded-by: _lock
        self._probe_info: dict = {}    # guarded-by: _lock
        self._probe_totals: dict = {}  # guarded-by: _lock
        self._probe_dead: list = []
        self._memwatch = None
        self.stats = ExecutorStats()
        self._cache: "collections.OrderedDict[tuple, _Entry]" = (  # guarded-by: _lock
            collections.OrderedDict())
        self._cost_table: dict = {}  # guarded-by: _lock
        # one lock serializes the cache, the static buffers of captured
        # entries (copy in, replay, clone out) and the probe planes
        self._lock = threading.RLock()

    # -- bucketing ----------------------------------------------------------

    def bucket_for(self, q: int) -> int:
        """Smallest bucket >= q (the last bucket for anything larger)."""
        for b in self.buckets:
            if q <= b:
                return b
        return self.buckets[-1]

    # -- public API ---------------------------------------------------------

    def warmup(self, index, buckets=None, *, k: int, params=None,
               sample_filter=None, **kw) -> float:
        """Build (capture) the entries for ``buckets`` (default: the whole
        ladder) before traffic arrives, so that the first request is a
        replay. Returns the wall seconds spent (also added to the
        ``serving.warmup_seconds`` counter)."""
        fw = self._resolve_filter(sample_filter)
        t0 = time.perf_counter()
        for b in (buckets if buckets is not None else self.buckets):
            expect(b in self.buckets, f"bucket {b} not in {self.buckets}")
            with self._lock, self._dispatch_lock(index):
                plan = self._plan(index, params, k, b, fw, kw)
                self._get_entry_locked(plan, b, k, fw)
        dt = time.perf_counter() - t0
        self.stats.warmup_seconds += dt
        tracing.inc_counter("serving.warmup_seconds", dt)
        return dt

    def search(self, index, queries, k: int, params=None,
               sample_filter=None, trace_ids: Tuple[int, ...] = (),
               **kw) -> Tuple[torch.Tensor, torch.Tensor]:
        """Bucketed search: (distances (q, k), indices (q, k) int32) on
        the index's device, bit-identical to the family's direct
        ``search``. ``trace_ids`` is accepted for the serving batcher
        (the mesh spans it tags in the JAX package are not ported)."""
        del trace_ids
        expect(len(np.shape(queries)) == 2, "queries must be (q, dim)")
        q = int(np.shape(queries)[0])
        fw = self._resolve_filter(sample_filter)
        if q == 0:
            dev = self._index_device(index)
            return (torch.zeros((0, k), dtype=torch.float32, device=dev),
                    torch.zeros((0, k), dtype=torch.int32, device=dev))
        max_b = self.buckets[-1]
        if q <= max_b:
            return self._run(index, queries, k, params, fw, kw)
        # every tile, the ragged tail too, runs the top bucket's entry
        outs_d, outs_i = [], []
        for start in range(0, q, max_b):
            fwt = fw[start:start + max_b] if (
                fw is not None and fw.ndim == 2) else fw
            d, i = self._run(index, queries[start:start + max_b], k, params,
                             fwt, kw, bucket=max_b)
            outs_d.append(d)
            outs_i.append(i)
        return torch.cat(outs_d), torch.cat(outs_i)

    def coalesce_key(self, index, k: int, params=None, sample_filter=None,
                     **kw) -> tuple:
        """Hashable compatibility key for request coalescing: the plan key
        with the bucket stripped and the index's identity mixed in (two
        indexes with equal shapes must never coalesce)."""
        fw = self._resolve_filter(sample_filter)
        with self._dispatch_lock(index):
            plan = self._plan(index, params, k, self.buckets[0], fw, kw,
                              for_key=True)
        return (id(index), plan.key[0]) + tuple(plan.key[2:])

    def search_blocks(self, index, blocks, k: int, params=None,
                      sample_filter=None, trace_ids: Tuple[int, ...] = (),
                      **kw):
        """Run the per-request query blocks of one coalesced micro-batch
        as one bucketed call and split the results back per block. A 2-D
        ``sample_filter`` is the row-wise concatenation matching the
        blocks. Each block's result equals a direct :meth:`search` of it
        alone: pad rows are inert and every family is row-wise."""
        expect(len(blocks) > 0, "search_blocks needs at least one block")
        sizes = [int(np.shape(b)[0]) for b in blocks]
        if len(blocks) == 1:
            cat = blocks[0]
        elif all(isinstance(b, np.ndarray) for b in blocks):
            cat = np.concatenate(blocks)
        else:
            dev = self._index_device(index)
            cat = torch.cat([torch.as_tensor(b).to(dev) for b in blocks])
        d, i = self.search(index, cat, k, params, sample_filter,
                           trace_ids=trace_ids, **kw)
        out, start = [], 0
        for m in sizes:
            out.append((d[start:start + m], i[start:start + m]))
            start += m
        return out

    # -- dispatch -----------------------------------------------------------

    def _resolve_filter(self, sample_filter):
        if sample_filter is None:
            return None
        from raft_tpu_torch.neighbors.filters import resolve_filter_words

        fw = resolve_filter_words(sample_filter)
        return None if fw is None else fw.to(torch.int32)

    @staticmethod
    def _index_device(index) -> torch.device:
        for name in ("centers", "dataset"):
            t = getattr(index, name, None)
            if isinstance(t, torch.Tensor):
                return t.device
        raise TypeError(f"SearchExecutor does not support {type(index)!r}")

    @staticmethod
    def _dispatch_lock(index):
        """The tiered container's swap lock (one placement generation from
        the plan's snapshot through the dispatch); a no-op otherwise.
        Taken after the executor lock, the order ``apply_plan`` keeps."""
        from raft_tpu_torch.neighbors.tiered import TieredIvf

        if isinstance(index, TieredIvf):
            return index._swap_lock
        return contextlib.nullcontext()

    def _run(self, index, queries, k, params, fw, kw, bucket=None):
        q = int(np.shape(queries)[0])
        bucket = bucket or self.bucket_for(q)
        with self._lock, self._dispatch_lock(index):
            plan = self._plan(index, params, k, bucket, fw, kw)
            expect(int(np.shape(queries)[1]) == plan.qdim,
                   "query dim mismatch")
            qp = self._padded_queries(queries, bucket, plan)
            fwp = None
            if plan.use_filter and fw is not None:
                fwp = fw.to(plan.device)
                if fwp.ndim == 2:
                    fwp = _pad(fwp, bucket, "zero")
            entry = self._get_entry_locked(plan, bucket, k, fw, qp, fwp)
            out_d, out_i = self._execute_locked(plan, entry, qp, fwp, q)
        return out_d, out_i

    def _padded_queries(self, queries, rows: int, plan: _Plan):
        """The (rows, dim) query block on the plan's device and type; a
        numpy block is padded on the host and copied over once."""
        if isinstance(queries, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(queries))
            t = _pad(t.to(plan.qdtype), rows, "edge")
            return t.to(plan.device)
        t = torch.as_tensor(queries).to(device=plan.device,
                                        dtype=plan.qdtype)
        return _pad(t, rows, "edge")

    def _call(self, plan: _Plan, queries, fw, n_valid):
        """One eager call of the plan's body; the probe plane is updated
        in place."""
        args = [queries, *plan.arrays]
        if plan.use_filter:
            args.append(fw)
        if plan.probe is None:
            return plan.fn(*args, **plan.static)
        plane = self._probe_state[plan.probe[0]]
        d, i, counts = plan.fn(*args, probe_counts=plane, n_valid=n_valid,
                               **plan.static)
        plane.copy_(counts)
        return d, i

    def _execute_locked(self, plan: _Plan, entry: _Entry, qp, fwp,
                        q_real: int):
        bucket = qp.shape[0]
        if entry.graph is None:
            d, i = self._call(plan, qp, fwp, q_real)
            out_d, out_i = d[:q_real], i[:q_real]
        else:
            entry.static_q.copy_(qp)
            if entry.static_fw is not None:
                entry.static_fw.copy_(fwp)
            if entry.static_nv is not None:
                entry.static_nv.fill_(q_real)
            entry.graph.replay()
            # clones before the lock is released: the next replay
            # overwrites the static outputs
            out_d = entry.outputs[0][:q_real].clone()
            out_i = entry.outputs[1][:q_real].clone()
            wrappers = _kernel_wrappers()
            for name, n in entry.launches.items():
                wrappers[name].launches += n
            if entry.counters:
                tracing.inc_counters(entry.counters)
        amounts = {"serving.execute.calls": 1.0,
                   "serving.execute.rows": float(q_real),
                   "serving.execute.padded_rows": float(bucket)}
        if plan.probe is not None:
            amounts["index.probe.dispatches"] = 1.0
            amounts["index.probe.rows"] = float(q_real)
        tracing.inc_counters(amounts)
        sample = getattr(self._memwatch, "sample_dispatch", None)
        if sample is not None:
            sample()
        return out_d, out_i

    # -- the plan cache -----------------------------------------------------

    def _get_entry_locked(self, plan: _Plan, bucket: int, k: int, fw,
                          qp=None, fwp=None) -> _Entry:
        ent = self._cache.get(plan.key)
        if ent is not None:
            self._cache.move_to_end(plan.key)
            self.stats.cache_hits += 1
            tracing.inc_counter("serving.cache_hits")
            return ent
        self.stats.cache_misses += 1
        tracing.inc_counter("serving.cache_misses")
        digest = hashlib.sha1(repr(plan.key).encode()).hexdigest()[:12]
        ent = _Entry(plan.key[0], bucket, k, digest)
        t0 = time.perf_counter()
        if self.capture and plan.capturable:
            self._capture_locked(plan, ent, bucket, fw, qp, fwp)
        dt = time.perf_counter() - t0
        self.stats.compile_count += 1
        tracing.inc_counter("serving.compile_count")
        if ent.graph is not None:
            ent.capture_seconds = dt
            tracing.inc_counter("serving.capture_seconds", dt)
        info = {"family": ent.family, "bucket": bucket, "k": k,
                "captured": ent.graph is not None,
                "capture_seconds": ent.capture_seconds,
                "launches": sum(ent.launches.values()),
                "pool_bytes": ent.pool_bytes}
        self._cost_table[digest] = info
        tracing.set_gauges(_cost_gauges(digest, info))
        self._cache[plan.key] = ent
        while len(self._cache) > self.max_entries:
            _, old = self._cache.popitem(last=False)
            self.stats.evictions += 1
            tracing.inc_counter("serving.evictions")
            self._cost_table.pop(old.digest, None)
            tracing.reset_gauges(f"serving.executable.{old.digest}.")
        tracing.set_gauge("serving.executor.cached_executables",
                          float(len(self._cache)))
        return ent

    def _capture_locked(self, plan: _Plan, ent: _Entry, bucket: int, fw,
                        qp, fwp) -> None:
        """Warm the plan eagerly on a side stream, then capture one run
        into a CUDA graph with its own memory pool on the same stream.
        Raises on failure, leaving the thread's stream and the CUDA
        generator as they were."""
        dev = plan.device
        ent.static_q = (torch.zeros((bucket, plan.qdim), dtype=plan.qdtype,
                                    device=dev) if qp is None
                        else qp.clone())
        if plan.use_filter and fw is not None:
            shape = (bucket, fw.shape[1]) if fw.ndim == 2 else fw.shape
            ent.static_fw = (torch.zeros(shape, dtype=torch.int32,
                                         device=dev) if fwp is None
                             else fwp.clone())
        if plan.probe is not None:
            # 0 valid rows: the warm-up run adds nothing to the plane
            ent.static_nv = torch.zeros((), dtype=torch.int32, device=dev)
        ent.keep = tuple(a for a in plan.arrays if a is not None)

        def body():
            return self._call(plan, ent.static_q, ent.static_fw,
                              ent.static_nv)

        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            body()
        current.wait_stream(side)
        torch.cuda.synchronize(dev)
        gc.collect()
        torch.cuda.empty_cache()
        wrappers = _kernel_wrappers()
        launches0 = {n: w.launches for n, w in wrappers.items()}
        counters0 = tracing.counters()
        reserved0 = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = body()
                finally:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        # an invalidated capture (a host sync in the
                        # body) ends before the CUDA generator leaves
                        # capture mode; without a fresh copy of its state
                        # every later random draw on the device raises
                        gen = torch.cuda.default_generators[
                            torch.cuda.current_device() if dev.index is None
                            else dev.index]
                        gen.graphsafe_set_state(gen.clone_state())
                        raise
        finally:
            # what the capture counted was recorded, not run: it is
            # taken back here and added again by every replay
            ent.launches = {n: w.launches - launches0[n]
                            for n, w in wrappers.items()
                            if w.launches != launches0[n]}
            for n, w in wrappers.items():
                w.launches = launches0[n]
            ent.counters = {n: v - counters0.get(n, 0.0)
                            for n, v in tracing.counters().items()
                            if not n.startswith(_OWN_PREFIXES)
                            and v != counters0.get(n, 0.0)}
            tracing.inc_counters({n: -v for n, v in ent.counters.items()})
        ent.pool_bytes = int(torch.cuda.memory_reserved(dev) - reserved0)
        ent.graph = graph
        ent.outputs = out

    # -- introspection ------------------------------------------------------

    def executable_costs(self) -> dict:
        """``{digest: {family, bucket, k, captured, capture_seconds,
        launches, pool_bytes}}`` for every cached entry: kernel launches
        per replay and the bytes its graph pool holds."""
        with self._lock:
            return {d: dict(info) for d, info in self._cost_table.items()}

    def publish_cost_gauges(self) -> None:
        """Re-publish every resident entry's gauges and the cache-size
        gauge (after a ``metrics.reset()`` cleared them)."""
        with self._lock:
            table = {d: dict(info) for d, info in self._cost_table.items()}
            n = len(self._cache)
        vals = {"serving.executor.cached_executables": float(n)}
        for digest, info in table.items():
            vals.update(_cost_gauges(digest, info))
        tracing.set_gauges(vals)

    def attach_memwatch(self, ledger) -> None:
        """Wire a :class:`~raft_tpu_torch.core.memwatch.MemoryLedger`:
        its forecast can read :meth:`memory_reservations`, and a ledger
        with ``sample_dispatch`` is sampled after every dispatch."""
        self._memwatch = ledger

    def memory_reservations(self) -> dict:
        """The executor-owned device bytes, per device ordinal: the graph
        pools of the captured entries (in place of the JAX package's
        compile-time temp bytes) and the probe planes. Host metadata
        only."""
        from raft_tpu_torch.core.memwatch import _ordinal, array_bytes

        pools: dict = {}
        planes: dict = {}
        with self._lock:
            for ent in self._cache.values():
                if ent.graph is not None:
                    o = _ordinal(ent.static_q)
                    pools[o] = pools.get(o, 0) + ent.pool_bytes
            for arr in self._probe_state.values():
                o = _ordinal(arr)
                planes[o] = planes.get(o, 0) + array_bytes(arr)
            max_pool = max((e.pool_bytes for e in self._cache.values()),
                           default=0)
            n = len(self._cache)
        return {"graph_pool_bytes": pools, "probe_plane_bytes": planes,
                "max_pool_bytes": max_pool, "executables": n}

    # -- probe-frequency accounting -----------------------------------------

    def _probe_plumbing(self, index, family: str, key: tuple):
        """(key', probe descriptor): accounting changes the body's
        signature, so it joins the key (before the trailing filter
        spec). No-op when accounting is off."""
        if not self.probe_accounting:
            return key, None
        digest = hashlib.sha1(
            repr((family, id(index))).encode()).hexdigest()[:6]
        key = key[:-1] + ("probe_accounting", key[-1])
        return key, ((id(index), index.n_lists), index.n_lists, family,
                     f"{family}-{digest}", index)

    def _probe_plane_locked(self, probe, device) -> torch.Tensor:
        pkey, n_lists, family, label, index = probe
        plane = self._probe_state.get(pkey)
        if plane is None:
            self._evict_dead_probe_planes_locked()
            plane = torch.zeros((n_lists,), dtype=torch.int32,
                                device=device)
            self._probe_state[pkey] = plane
            self._probe_info[pkey] = {"family": family, "label": label,
                                      "n_lists": n_lists}
            try:
                weakref.finalize(index, self._probe_dead.append, pkey)
            except TypeError:       # an index that takes no weakref
                pass
        return plane

    def _evict_dead_probe_planes_locked(self) -> None:
        while self._probe_dead:
            pkey = self._probe_dead.pop()
            self._probe_state.pop(pkey, None)
            self._probe_info.pop(pkey, None)
            self._probe_totals.pop(pkey, None)

    def probe_frequencies(self) -> dict:
        """``{label: (n_lists,) int64 numpy plane}`` of cumulative probe
        counts per accounted index. This is the one device read of the
        planes: under the lock it claims the window since the last call
        (the plane is zeroed in place), folds it into a host-side int64
        total and bumps ``index.probe_freq.accounted`` once."""
        out = {}
        accounted = 0
        with self._lock:
            self._evict_dead_probe_planes_locked()
            for pkey, plane in self._probe_state.items():
                info = self._probe_info.get(pkey)
                if info is None:
                    continue
                window = plane.cpu().numpy().astype(np.int64)
                if window.any():
                    plane.zero_()
                    accounted += int(window.sum())
                total = self._probe_totals.get(pkey)
                total = window if total is None else total + window
                self._probe_totals[pkey] = total
                out[info["label"]] = total.copy()
        if accounted:
            tracing.inc_counter("index.probe_freq.accounted",
                                float(accounted))
        return out

    def publish_probe_gauges(self, top_n: int = 8,
                             planes: Optional[dict] = None) -> dict:
        """Publish ``index.probe_freq.<label>.*`` gauges (``total``,
        ``probed_fraction``, ``coverage_p01``/``p10`` and the top-``top_n``
        lists) from :func:`tracing.probe_freq_stats` of each plane.
        Returns ``{label: stats}``."""
        if planes is None:
            planes = self.probe_frequencies()
        out = {}
        for label, counts in planes.items():
            stats = tracing.probe_freq_stats(counts, top_n=top_n)
            out[label] = stats
            base = f"index.probe_freq.{label}."
            tracing.reset_gauges(base + "list.")
            vals = {base + "total": float(stats["total"]),
                    base + "probed_fraction": stats["probed_fraction"],
                    base + "coverage_p01": stats["coverage_p01"],
                    base + "coverage_p10": stats["coverage_p10"]}
            for lid, c in stats["top"]:
                vals[f"{base}list.{lid}"] = float(c)
            tracing.set_gauges(vals)
        return out

    def probe_label(self, index) -> Optional[str]:
        """The gauge label of ``index``'s probe plane (None until its
        first accounted dispatch)."""
        with self._lock:
            info = self._probe_info.get((id(index), index.n_lists))
        return info["label"] if info else None

    # -- per-family plans ---------------------------------------------------

    def _plan(self, index, params, k: int, bucket: int, fw, kw,
              for_key: bool = False) -> _Plan:
        from raft_tpu_torch.neighbors.brute_force import BruteForceIndex
        from raft_tpu_torch.neighbors.cagra import CagraIndex
        from raft_tpu_torch.neighbors.ivf_bq import IvfBqIndex
        from raft_tpu_torch.neighbors.ivf_flat import IvfFlatIndex
        from raft_tpu_torch.neighbors.tiered import TieredIvf

        if isinstance(index, BruteForceIndex):
            plan = self._plan_brute_force(index, k, bucket, fw, kw)
        elif isinstance(index, TieredIvf):
            plan = self._plan_tiered(index, params, k, bucket, fw)
        elif isinstance(index, IvfFlatIndex):
            plan = self._plan_ivf_flat(index, params, k, bucket, fw)
        elif isinstance(index, IvfBqIndex):
            plan = self._plan_ivf_bq(index, params, k, bucket, fw)
        elif isinstance(index, CagraIndex):
            plan = self._plan_cagra(index, params, k, bucket, fw)
        else:
            raise TypeError(
                f"SearchExecutor does not support {type(index)!r}")
        expect(not self.capture or plan.device.type == "cuda",
               "SearchExecutor(capture=True) needs an index on a CUDA "
               f"device; this one is on {plan.device}")
        if plan.probe is not None and not for_key:
            with self._lock:
                plane = self._probe_plane_locked(plan.probe, plan.device)
        if self.capture and plan.capturable and not for_key:
            # what the graph bakes in: the index arrays' and the probe
            # plane's addresses
            ptrs = tuple(a.data_ptr() for a in plan.arrays if a is not None)
            if plan.probe is not None:
                ptrs += (plane.data_ptr(),)
            plan.key = plan.key + (("captured",) + ptrs,)
        return plan

    def _plan_brute_force(self, index, k, bucket, fw, kw) -> _Plan:
        from raft_tpu_torch.neighbors import brute_force as m

        expect(fw is None, "brute_force has no sample_filter support")
        # the route is the bucket's, as the direct search's is its tile's
        fn, arrays, static = m.serving_plan(self.res, index, k, bucket,
                                            int(kw.get("db_tile", 32768)))
        fused = fn is m._fused_entry_fn
        qdtype = (index.dataset.dtype if fused
                  or index.dataset.dtype == torch.bfloat16 else torch.float32)
        key = ("bf_fused" if fused else "bf_scan", bucket, _sig(*arrays),
               _statics(static), _filter_spec(None))
        return _Plan(key=key, fn=fn, static=static, arrays=arrays,
                     device=index.dataset.device, qdtype=qdtype,
                     qdim=index.dim)

    def _plan_ivf_flat(self, index, params, k, bucket, fw) -> _Plan:
        from raft_tpu_torch.neighbors import ivf_flat as m

        fn, arrays, static = m.serving_plan(
            params or m.IvfFlatSearchParams(), index, k, fw)
        key = ("ivf_flat", bucket, _sig(*arrays), _statics(static),
               _filter_spec(fw))
        key, probe = self._probe_plumbing(index, "ivf_flat", key)
        return _Plan(key=key, fn=fn, static=static, arrays=arrays,
                     device=index.centers.device, use_filter=True,
                     qdim=index.dim,
                     capturable=static["scan_engine"] == "cuda", probe=probe)

    def _plan_ivf_bq(self, index, params, k, bucket, fw) -> _Plan:
        from raft_tpu_torch.neighbors import ivf_bq as m

        fn, arrays, static = m.serving_plan(
            params or m.IvfBqSearchParams(), index, k, fw)
        key = ("ivf_bq", bucket, _sig(*arrays),
               ("data", index.data is not None), _statics(static),
               _filter_spec(fw))
        key, probe = self._probe_plumbing(index, "ivf_bq", key)
        return _Plan(key=key, fn=fn, static=static, arrays=arrays,
                     device=index.centers.device, use_filter=True,
                     qdim=index.dim,
                     capturable=static["scan_engine"] in ("cuda", "rank"),
                     probe=probe)

    def _plan_cagra(self, index, params, k, bucket, fw) -> _Plan:
        from raft_tpu_torch.neighbors import cagra as m

        fn, arrays, static = m.serving_plan(
            params or m.CagraSearchParams(), index, k, fw)
        kernel = static["engine"] == "cuda"
        key = ("cagra", bucket, _sig(*arrays),
               ("planes", index.seed_centers is not None,
                arrays[-1] is not None),
               _statics(static), _filter_spec(None if kernel else fw))
        return _Plan(key=key, fn=fn, static=static, arrays=arrays,
                     device=index.dataset.device, use_filter=not kernel,
                     qdim=index.dim, capturable=kernel)

    def _plan_tiered(self, index, params, k, bucket, fw) -> _Plan:
        from raft_tpu_torch.neighbors import tiered as m

        # one placement generation: the caller holds the swap lock from
        # this snapshot through the dispatch
        fn, arrays, static = m.serving_plan(
            params or m.TieredSearchParams(), index, k, fw,
            self.res.workspace_limit_bytes)
        # shapes and statics only: an epoch swaps same-shape arrays, so
        # re-placed traffic keeps hitting this entry
        key = ("tiered_ivf", bucket, _sig(*arrays), _statics(static),
               _filter_spec(fw))
        key, probe = self._probe_plumbing(index, "tiered_ivf", key)
        return _Plan(key=key, fn=fn, static=static, arrays=arrays,
                     device=index.centers.device, use_filter=True,
                     qdim=index.dim, capturable=False, probe=probe)
