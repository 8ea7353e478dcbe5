"""Shape-stable serving: bucketed and ragged plans replayed as CUDA
graphs — the port of ``raft_tpu/core/executor.py``.

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
- **Ragged plans** (:meth:`SearchExecutor.search_ragged`): requests
  whose ``n_probes`` (CAGRA: ``max_iterations``) and ``k`` round up to
  one power-of-two *params class* pack adjacently into one fixed
  ``(ragged_tile, dim)`` block, with a ``(tile,)`` int32 budget plane
  (each row's own ``n_probes`` or iteration count; 0 on the zero pad
  rows) as a third static input of the captured graph. One entry per
  (index, class, tile) serves every load shape, where the bucketed path
  holds a ladder; totals past a tile stream through the same entry in
  chunks. The plan derives from the family's bucketed plan at the class
  caps (:meth:`SearchExecutor._plan_ragged`), so route, engine and
  clamps are decided in one place. Each block's result is a column
  slice of the class top-k, equal to a solo search of that block.

- **Mesh plans** (:meth:`SearchExecutor._plan_dist`): one plan builder for
  the list-sharded ``DistributedIvfFlat`` / ``DistributedIvfPq`` /
  ``DistributedIvfBq`` over their shard bodies
  (``distributed/ivf._dist_search_fn``, ``_dist_search_pq_fn``,
  ``distributed/bq._dist_search_bq_fn``). The key carries the mesh
  identity (:func:`_mesh_key`) and the resolved engine and wires, so an
  engine switch or another mesh is a distinct entry; on the card the whole
  slot loop, the collectives between its per-slot loops and the merge are
  captured as one CUDA graph. A ``query_axis`` names a second mesh axis:
  the padded block rounds up to the grid extent x the list-axis size and
  no probe accounting runs. With ``probe_accounting`` the plane is one
  (n_lists,) int32 tensor whose (R, n_local) view hands each slot its
  rows, so it reads in the dist index's own list-id space (the dealt
  order, slot by slot). ``mesh_trace=True`` records the modeled phase
  spans over the dispatch's readiness after every bucketed mesh dispatch
  (:meth:`SearchExecutor._record_mesh_dispatch` says why no slot has a
  readiness of its own).
- **Cost model**: the JAX package reads XLA's ``cost_analysis()``; the
  port has no compiler to ask, so every plan builder models its
  ``flops`` and ``bytes_accessed`` from its statics (:func:`_ivf_cost`
  and the builders): the list rows a bucket's probes can touch, the
  coarse GEMM, codes and LUTs for PQ, planes and reranked rows for BQ,
  and the collective payload of a mesh plan. The graph pool takes the
  place of ``peak_hbm_bytes``. Each dispatch adds the entry's numbers to
  ``serving.execute.modeled_{flops,bytes}``.
- **Correlation**: every entry is named ``rt_<family>_<digest>`` (the
  JAX package's HLO module name, less ``jit_``). While a capture window
  is open (:func:`raft_tpu_torch.core.profiling.capture_window`; every
  profiler session opens one) every replay or eager call runs inside
  ``torch.profiler.record_function`` of that name, and a CUDA entry's
  call is also bracketed by a timing ``torch.cuda.Event`` pair, the
  device seconds :func:`~raft_tpu_torch.core.profiling.attribute` reads;
  with no window open a call is neither named nor timed.
- **Captures and profiler sessions** exclude each other (a CUDA graph
  captured inside a session hung the process on the card): a cache miss
  that meets a session running on another thread releases the
  executor's locks, waits for the session to end and dispatches again
  (:func:`_past_sessions`); on the session's own thread it raises.

``executable_costs`` reports each entry's family, bucket, k, modeled
flops and bytes, ``peak_hbm_bytes`` (its graph pool), the correlation
name (``hlo_module``), capture seconds, kernel launches per replay and
graph-pool bytes (the growth of reserved device memory across its
capture), and a mesh entry's collective payload model.

Tiered plans (IVF-Flat, IVF-PQ, IVF-BQ) snapshot one placement
generation under the container's swap lock, which the dispatch holds
(:meth:`SearchExecutor._dispatch_lock`), and key on shapes and statics
only, so a placement epoch keeps hitting the same entry. With a memory
ledger attached (:meth:`SearchExecutor.attach_memwatch`) every dispatch
samples the device's memory stats on the host, and the ledger's forecast
reads :meth:`SearchExecutor.memory_reservations`.

An index of no supported family raises ``TypeError``, as in the JAX
package.
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

from raft_tpu_torch.core import profiling, tracing
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.core.validation import expect

# counters a capture may add that belong to the request, not to the
# executor's own bookkeeping: replays add these again
_OWN_PREFIXES = ("serving.", "index.")

# the readiness poll quantum of mesh_trace
_MESH_POLL_S = 50e-6


def _past_sessions(fn: Callable):
    """``fn()``, run again after the profiler session it met has ended: a
    capture raises :class:`~raft_tpu_torch.core.profiling.SessionRunning`
    before anything is dispatched or counted, and ``fn`` has released the
    executor's locks by the time this waits."""
    while True:
        try:
            return fn()
        except profiling.SessionRunning:
            profiling.wait_for_session()


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
    # a ragged plan: called as fn(queries, budgets, *arrays, ...)
    ragged: bool = False
    # a mesh plan: its slot count (the probe plane's view), the padded
    # rows of a 2-D plan (None: the bucket) and its payload model maker
    slots: int = 0
    rows: Optional[int] = None
    payload: Any = None
    # modeled {"flops", "bytes_accessed"} of one call, made when an entry
    # is built
    cost: Optional[Callable[[], dict]] = None


class _Entry:
    """A cached plan entry: eager (``graph`` None), or a captured graph
    with its static buffers, outputs and the tensors it bakes in."""

    __slots__ = ("family", "bucket", "k", "digest", "module", "cost",
                 "payload_model", "graph", "static_q", "static_fw",
                 "static_nv", "static_b", "outputs", "keep", "launches",
                 "counters", "pool_bytes", "capture_seconds")

    def __init__(self, family: str, bucket: int, k: int, digest: str):
        self.family = family
        self.bucket = bucket
        self.k = k
        self.digest = digest
        self.module = f"rt_{family}_{digest}"
        self.cost: dict = {}
        self.payload_model = None
        self.graph = None
        self.static_q = None
        self.static_fw = None
        self.static_nv = None
        self.static_b = None
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
    from raft_tpu_torch.ops.ivf_pq_scan import ivf_pq_scan
    from raft_tpu_torch.ops.ivf_scan import list_major_scan
    from raft_tpu_torch.ops.tier_scan import tiered_list_major_scan

    return {"fused_knn": fused_knn, "list_major_scan": list_major_scan,
            "bq_scan": bq_list_major_scan, "select_k": select_k_tiles,
            "beam_search": beam_search, "tier_scan": tiered_list_major_scan,
            "stream_read_sum": stream_read_sum, "ivf_pq_scan": ivf_pq_scan}


def _flat(arrays):
    """The tensors of a plan's arrays: a mesh plan's per-slot lists are
    flattened, None entries dropped."""
    for a in arrays:
        if isinstance(a, (list, tuple)):
            yield from _flat(a)
        elif a is not None:
            yield a


def _sig(*arrays) -> tuple:
    return tuple((tuple(a.shape), str(a.dtype)) for a in _flat(arrays))


def _mesh_key(comms) -> tuple:
    """The cache-key part that names a mesh precisely: its axis, axis
    names, grid shape and every slot's device, so a transposed, re-axed or
    re-placed grid never reuses another's entry (``executor.py:312``)."""
    mesh = comms.mesh
    return ("mesh", comms.axis, tuple(mesh.axis_names),
            tuple(mesh.devices.shape),
            tuple(str(d) for d in mesh.slot_devices()))


def _ivf_cost(rows: int, k: int, dim: int, n_lists: int, n_probes: int,
              live_rows: int, row_bytes: int, row_flops: int,
              extra_bytes: float = 0.0, extra_flops: float = 0.0) -> dict:
    """The modeled work of one IVF call over ``rows`` queries: the queries
    and centers read, the coarse GEMM, the live list rows the bucket's
    probes can touch (``min(rows * n_probes, n_lists)`` lists of the mean
    ``live_rows / n_lists`` rows, ``row_bytes`` each, read once) and
    scanned at ``row_flops`` a (query, probed row), and the (rows, k)
    results written. ``extra_*`` add a family's own terms (LUTs,
    reranked rows, collective payloads)."""
    mean_rows = live_rows / max(n_lists, 1)
    touched = min(rows * n_probes, n_lists)
    return {
        "flops": float(2 * rows * n_lists * dim
                       + rows * n_probes * mean_rows * row_flops
                       + extra_flops),
        "bytes_accessed": float(4 * rows * dim + 4 * n_lists * (dim + 1)
                                + touched * mean_rows * row_bytes
                                + 8 * rows * k + extra_bytes),
    }


def _live_rows(index) -> int:
    """The rows an index holds (a host read of its list sizes, made once
    an entry is built)."""
    sizes = index.list_sizes
    if isinstance(sizes, list):
        return sum(int(s.sum()) for s in sizes)
    return int(sizes.sum())


def _row_bytes(*planes) -> int:
    """Bytes one list row holds across (n_lists, extent, ...) planes."""
    return sum(int(np.prod(p.shape[2:], dtype=np.int64)) * p.element_size()
               for p in planes if p is not None)


def _statics(static: dict) -> tuple:
    return tuple(sorted((n, str(v)) for n, v in static.items()))


def _pow2_at_least(n: int, floor: int) -> int:
    """Smallest power-of-two multiple of ``floor`` at or above ``n``: the
    ragged params-class rounding."""
    b = floor
    while b < n:
        b *= 2
    return b


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
    return {base + "flops": info.get("flops", 0.0),
            base + "bytes_accessed": info.get("bytes_accessed", 0.0),
            base + "peak_hbm_bytes": info.get("peak_hbm_bytes", 0.0),
            base + "pool_bytes": float(info.get("pool_bytes", 0)),
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
      ragged_tile: rows of the ragged plans' packed block
        (:meth:`search_ragged`): one plan entry per (index, params class)
        serves every load shape.
      ragged_tile_small: an optional smaller tile beside it: a packed
        batch whose rows fit it runs through its own entry, which cuts
        the pad of partial tiles at light load. Both tiles share one
        :meth:`ragged_key`; the tile is chosen at dispatch.
      mesh_trace: after every bucketed mesh dispatch, wait for its
        outputs and record the ``serving.mesh.{coarse_select,scan,merge}``
        spans (modeled bytes from the entry's payload model) over the
        dispatch's readiness. No ``serving.mesh.shard`` span or straggler
        gauge is recorded: the executor sees only the merged outputs
        (:meth:`_record_mesh_dispatch`). The calling thread waits out the
        poll, so the tiles of an oversized batch serialize; nothing is
        captured differently. Ragged mesh dispatches skip it.
    """

    def __init__(self, res: Optional[Resources] = None, *,
                 min_bucket: int = 8, max_bucket: int = 4096,
                 max_entries: int = 64, probe_accounting: bool = False,
                 capture: Optional[bool] = None, ragged_tile: int = 256,
                 ragged_tile_small: Optional[int] = None,
                 mesh_trace: bool = False):
        self.res = ensure_resources(res)
        expect(0 < min_bucket <= max_bucket,
               f"need 0 < min_bucket <= max_bucket, got "
               f"({min_bucket}, {max_bucket})")
        expect(ragged_tile > 0, "ragged_tile must be > 0")
        expect(ragged_tile_small is None
               or 0 < ragged_tile_small < ragged_tile,
               "ragged_tile_small must be in (0, ragged_tile)")
        self.ragged_tile = ragged_tile
        self.ragged_tile_small = ragged_tile_small
        buckets = []
        b = min_bucket
        while b < max_bucket:
            buckets.append(b)
            b *= 2
        buckets.append(max_bucket)
        self.buckets: Tuple[int, ...] = tuple(buckets)
        self.max_entries = max_entries
        self.probe_accounting = probe_accounting
        self.mesh_trace = mesh_trace
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
            _past_sessions(lambda: self._warm_bucket(index, params, k, b,
                                                     fw, kw))
        dt = time.perf_counter() - t0
        self.stats.warmup_seconds += dt
        tracing.inc_counter("serving.warmup_seconds", dt)
        return dt

    def _warm_bucket(self, index, params, k: int, b: int, fw, kw) -> None:
        with self._lock, self._dispatch_lock(index):
            plan = self._plan(index, params, k, b, fw, kw)
            self._get_entry_locked(plan, plan.rows or b, k, fw)

    def search(self, index, queries, k: int, params=None,
               sample_filter=None, trace_ids: Tuple[int, ...] = (),
               **kw) -> Tuple[torch.Tensor, torch.Tensor]:
        """Bucketed search: (distances (q, k), indices (q, k) int32) on
        the index's device, bit-identical to the family's direct
        ``search``. ``trace_ids`` tag the mesh spans of a mesh dispatch
        under ``mesh_trace`` (the serving batcher passes its members')."""
        expect(len(np.shape(queries)) == 2, "queries must be (q, dim)")
        q = int(np.shape(queries)[0])
        fw = self._resolve_filter(sample_filter)
        if q == 0:
            dev = self._index_device(index)
            return (torch.zeros((0, k), dtype=torch.float32, device=dev),
                    torch.zeros((0, k), dtype=torch.int32, device=dev))
        max_b = self.buckets[-1]
        if q <= max_b:
            return self._run(index, queries, k, params, fw, kw,
                             trace_ids=trace_ids)
        # every tile, the ragged tail too, runs the top bucket's entry
        outs_d, outs_i = [], []
        for start in range(0, q, max_b):
            fwt = fw[start:start + max_b] if (
                fw is not None and fw.ndim == 2) else fw
            d, i = self._run(index, queries[start:start + max_b], k, params,
                             fwt, kw, bucket=max_b, trace_ids=trace_ids)
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

    # -- the ragged plan family ---------------------------------------------

    def ragged_key(self, index, k: int, params=None, sample_filter=None,
                   **kw) -> Optional[tuple]:
        """Hashable packing key of the ragged path, or None where this
        (index, params, k) must stay on the bucketed path
        (:meth:`ragged_fallback_reason` says why). Two submissions may
        share one packed batch iff their keys are equal. ``n_probes``
        (CAGRA: ``max_iterations``) and ``k`` enter only through their
        power-of-two params class; every other static of the class plan
        (engine, epsilon, itopk, ...) enters as it is, so requests that
        differ in anything but their budgets and ``k`` never share a
        packed call. The tile is not part of the key."""
        fw = self._resolve_filter(sample_filter)
        spec, _ = self._ragged_resolve(index, k, params, fw, kw)
        if spec is None:
            return None
        return (id(index), spec["family"] + "_ragged", spec["statics"],
                _filter_spec(fw),
                tuple(sorted((n, str(v)) for n, v in kw.items())))

    def ragged_fallback_reason(self, index, k: int, params=None,
                               sample_filter=None, **kw) -> Optional[str]:
        """Why this (index, params, k) is not servable by the ragged plan
        family (None when it is): one of :data:`_RAGGED_RESIDUE`'s
        strings, the JAX package's own."""
        fw = self._resolve_filter(sample_filter)
        return self._ragged_resolve(index, k, params, fw, kw)[1]

    def warmup_ragged(self, index, *, k: int, params=None,
                      sample_filter=None, **kw) -> float:
        """Build (capture) the ragged entries of this (index, params
        class): one per configured tile. Raises where :meth:`ragged_key`
        would refuse. Returns the wall seconds spent."""
        fw = self._resolve_filter(sample_filter)
        spec, reason = self._ragged_resolve(index, k, params, fw, kw)
        expect(spec is not None,
               "index/params combination is not servable by the ragged "
               f"plan family: {reason}")
        t0 = time.perf_counter()
        for tile in self._ragged_tiles():
            _past_sessions(lambda: self._warm_tile(index, fw, spec, tile))
        dt = time.perf_counter() - t0
        self.stats.warmup_seconds += dt
        tracing.inc_counter("serving.warmup_seconds", dt)
        return dt

    def _warm_tile(self, index, fw, spec: dict, tile: int) -> None:
        with self._lock, self._dispatch_lock(index):
            plan = self._plan_ragged(index, fw, spec, tile)
            self._get_entry_locked(plan, tile, spec["k_class"], fw)

    def _ragged_tiles(self) -> Tuple[int, ...]:
        """The configured tiles, small first."""
        if self.ragged_tile_small is not None:
            return (self.ragged_tile_small, self.ragged_tile)
        return (self.ragged_tile,)

    def _ragged_tile_for(self, total: int) -> int:
        """The small tile iff the whole packed batch fits it."""
        small = self.ragged_tile_small
        if small is not None and total <= small:
            return small
        return self.ragged_tile

    def search_ragged(self, index, blocks, ks, params_list=None,
                      sample_filter=None, trace_ids: Tuple[int, ...] = (),
                      **kw):
        """Run several requests' query blocks, each with its own ``k``
        and params (``n_probes``, CAGRA's ``max_iterations``) under one
        params class, as packed ``(tile, dim)`` calls of one plan entry,
        and split the results back per block.

        ``blocks`` are (m_j, dim) arrays or tensors; ``ks`` and
        ``params_list`` give each block's ``k`` and params (one value is
        shared by all). Every block must agree on :meth:`ragged_key`: the
        serving batcher groups by it. A 2-D ``sample_filter`` is the
        row-wise concatenation matching the blocks. Blocks pack
        adjacently, the tail padded with zero rows of budget 0; totals
        past one tile run through the same entry in tile-sized chunks,
        all enqueued before any result is used. Returns per-block
        ``(distances (m_j, k_j), indices (m_j, k_j))`` tensors on the
        index's device: column slices of the class top-k, each equal to
        a bucketed :meth:`search` of that block alone."""
        del trace_ids
        expect(len(blocks) > 0, "search_ragged needs at least one block")
        n = len(blocks)
        if not isinstance(ks, (list, tuple)):
            ks = [ks] * n
        if not isinstance(params_list, (list, tuple)):
            params_list = [params_list] * n
        expect(len(ks) == n and len(params_list) == n,
               "ks/params_list must match blocks")
        fw = self._resolve_filter(sample_filter)
        # blocks repeat few (params, k) pairs, and each resolution builds
        # a plan: resolve each distinct pair once
        memo: dict = {}
        specs = []
        for kj, pj in zip(ks, params_list):
            mk = (pj, kj)
            if mk not in memo:
                memo[mk] = self._ragged_resolve(index, kj, pj, fw, kw)
            spec, reason = memo[mk]
            expect(spec is not None, "a block is not servable by the "
                   f"ragged plan family: {reason}")
            specs.append(spec)
        expect(len({(s["family"], s["statics"]) for s in specs}) == 1,
               "blocks must agree on the ragged params class: group "
               "submissions by SearchExecutor.ragged_key")
        spec = specs[0]
        sizes = [int(np.shape(b)[0]) for b in blocks]
        for b in blocks:
            expect(len(np.shape(b)) == 2 and int(np.shape(b)[1]) == index.dim,
                   "query dim mismatch")
        total = sum(sizes)
        dev = self._index_device(index)
        if total == 0:
            return [(torch.zeros((0, kj), dtype=torch.float32, device=dev),
                     torch.zeros((0, kj), dtype=torch.int32, device=dev))
                    for kj in ks]
        if fw is not None and fw.ndim == 2:
            expect(int(fw.shape[0]) == total,
                   "2-D filter rows must match the packed query rows")
        tile = self._ragged_tile_for(total)
        padded_total = -(-total // tile) * tile
        from raft_tpu_torch.ops.ivf_scan import ragged_row_probes

        budgets = torch.from_numpy(ragged_row_probes(
            sizes, [s["n_probes"] for s in specs], padded_total)).to(dev)
        packed = self._pack(blocks, sizes, padded_total, dev)
        split = f"p{spec['np_class']}.t{tile}"

        def dispatch():
            # every tile runs one entry, so a capture can only happen
            # before the first tile dispatches
            fwp = None
            parts_d, parts_i = [], []
            with self._lock, self._dispatch_lock(index):
                plan = self._plan_ragged(index, fw, spec, tile)
                if plan.use_filter and fw is not None:
                    fwp = fw.to(plan.device)
                    if fwp.ndim == 2:
                        fwp = _pad(fwp, padded_total, "zero")
                for start in range(0, padded_total, tile):
                    q_real = min(total - start, tile)
                    qt = packed[start:start + tile]
                    bt = budgets[start:start + tile]
                    fwt = fwp
                    if fwp is not None and fwp.ndim == 2:
                        fwt = fwp[start:start + tile]
                    entry = self._get_entry_locked(
                        plan, tile, spec["k_class"], fw, qt, fwt, bt)
                    d, i = self._execute_locked(plan, entry, qt, fwt,
                                                q_real, bt)
                    parts_d.append(d)
                    parts_i.append(i)
                    tracing.inc_counters({
                        f"serving.execute.rows.{split}": float(q_real),
                        f"serving.execute.padded_rows.{split}":
                            float(tile)})
            return parts_d, parts_i

        parts_d, parts_i = _past_sessions(dispatch)
        d_all = parts_d[0] if len(parts_d) == 1 else torch.cat(parts_d)
        i_all = parts_i[0] if len(parts_i) == 1 else torch.cat(parts_i)
        out, row = [], 0
        for m, kj in zip(sizes, ks):
            # the merge is a total order: the first k_j columns of the
            # class top-k are the solo top-k_j
            out.append((d_all[row:row + m, :kj], i_all[row:row + m, :kj]))
            row += m
        return out

    @staticmethod
    def _pack(blocks, sizes, rows: int, dev) -> torch.Tensor:
        """The blocks stacked into a (rows, dim) float32 block on ``dev``,
        zero past their rows: numpy blocks are packed on the host and
        copied over once."""
        if all(isinstance(b, np.ndarray) for b in blocks):
            packed = np.zeros((rows, int(np.shape(blocks[0])[1])),
                              np.float32)
            r = 0
            for b, m in zip(blocks, sizes):
                packed[r:r + m] = b
                r += m
            return torch.from_numpy(packed).to(dev)
        cat = torch.cat([torch.as_tensor(b).to(device=dev,
                                               dtype=torch.float32)
                         for b in blocks])
        return _pad(cat, rows, "zero")

    # the non-raggable residue as the JAX package's reason strings (test
    # surface): what ragged_fallback_reason returns
    _RAGGED_RESIDUE = {
        "cagra_k": "cagra: the k class cap exceeds itopk_size, so the "
                   "class executable's beam buffer would differ from "
                   "the solo run's — bucketed path",
        "brute_force": "brute_force: no probe plane to budget per "
                       "row — bucketed path",
        "approx": "coarse_algo='approx' has no prefix property at "
                  "the class cap — bucketed path",
        "rank": "scan_engine resolved to the rank-major scan, which "
                "has no membership mask — bucketed path",
        "kw": "family-specific kwargs stay on the bucketed path",
        "empty": "empty index or k <= 0 — bucketed path",
        "query_axis": "query_axis grids serve through the bucketed "
                      "2-D plans (zero-recompile, scatter-merged) — "
                      "no ragged front yet",
        "dist_filter": "distributed searches have no sample_filter "
                       "support",
        "family": "index family has no ragged front — bucketed path",
    }

    def _ragged_resolve(self, index, k: int, params, fw, kw):
        """``(spec, None)``: the family tag, resolved engine, class caps,
        the request's own budget and the class plan's statics; or
        ``(None, reason)`` where the request stays bucketed. The engine
        comes from the family's bucketed plan at the class caps, so the
        raggability decision and the plan cannot disagree."""
        from raft_tpu_torch.distributed.bq import DistributedIvfBq
        from raft_tpu_torch.distributed.ivf import (
            DistributedIvfFlat,
            DistributedIvfPq,
        )
        from raft_tpu_torch.neighbors import ivf_bq, ivf_flat, ivf_pq, tiered
        from raft_tpu_torch.neighbors.brute_force import BruteForceIndex
        from raft_tpu_torch.neighbors.cagra import CagraIndex

        reasons = self._RAGGED_RESIDUE
        families = (
            (tiered.TieredIvf, "tiered_ivf", tiered.TieredSearchParams),
            (tiered.TieredIvfPq, "tiered_ivf_pq", ivf_pq.IvfPqSearchParams),
            (tiered.TieredIvfBq, "tiered_ivf_bq", ivf_bq.IvfBqSearchParams),
            (DistributedIvfFlat, "dist_ivf_flat",
             ivf_flat.IvfFlatSearchParams),
            (DistributedIvfPq, "dist_ivf_pq", ivf_pq.IvfPqSearchParams),
            (DistributedIvfBq, "dist_ivf_bq", ivf_bq.IvfBqSearchParams),
            (ivf_flat.IvfFlatIndex, "ivf_flat",
             ivf_flat.IvfFlatSearchParams),
            (ivf_bq.IvfBqIndex, "ivf_bq", ivf_bq.IvfBqSearchParams),
            (ivf_pq.IvfPqIndex, "ivf_pq", ivf_pq.IvfPqSearchParams),
        )
        for typ, family, params_type in families:
            if isinstance(index, typ):
                break
        else:
            if isinstance(index, CagraIndex):
                return self._ragged_resolve_cagra(index, k, params, fw, kw)
            if isinstance(index, BruteForceIndex):
                return None, reasons["brute_force"]
            return None, reasons["family"]
        if family.startswith("dist_"):
            if kw.get("query_axis") is not None:
                return None, reasons["query_axis"]
            if not set(kw) <= {"probe_mode", "wire_dtype",
                               "probe_wire_dtype"}:
                return None, reasons["kw"]
            if fw is not None:
                return None, reasons["dist_filter"]
        elif kw:
            return None, reasons["kw"]
        params = params or params_type()
        if params.coarse_algo != "exact":
            return None, reasons["approx"]
        if params.scan_engine == "rank":
            return None, reasons["rank"]
        # a mesh IVF-BQ index has no max_list_size; its codes' extent
        # plays the same role
        extent = getattr(index, "max_list_size", None)
        if extent is None:
            extent = index.codes[0].shape[1]
        if extent <= 0 or k <= 0:
            return None, reasons["empty"]
        n_probes = min(params.n_probes, index.n_lists)
        np_class = min(_pow2_at_least(n_probes, 8), index.n_lists)
        params_cls = dataclasses.replace(params, n_probes=np_class)
        return self._ragged_spec(index, family, params_cls, k, n_probes,
                                 np_class, "scan_engine", fw, kw)

    def _ragged_resolve_cagra(self, index, k: int, params, fw, kw):
        """CAGRA onto the ragged plan family: seeds are a pure function of
        each row, the budget plane carries each request's iteration
        count, and the class rounds ``max_iterations``. A ``k`` class cap
        past ``itopk_size`` would change the beam buffer itself."""
        from raft_tpu_torch.neighbors import cagra as m

        reasons = self._RAGGED_RESIDUE
        if kw:
            return None, reasons["kw"]
        params = params or m.CagraSearchParams()
        if index.graph.shape[0] == 0 or k <= 0:
            return None, reasons["empty"]
        if _pow2_at_least(k, 8) > params.itopk_size:
            return None, reasons["cagra_k"]
        iters = m.derive_search_config(params, index, k)["max_iters"]
        iters_class = _pow2_at_least(iters, 8)
        params_cls = dataclasses.replace(params, max_iterations=iters_class)
        return self._ragged_spec(index, "cagra", params_cls, k, iters,
                                 iters_class, "engine", fw, kw)

    def _ragged_spec(self, index, family, params_cls, k, budget, np_class,
                     engine_key, fw, kw):
        """The spec of a raggable request: its family's plan at the class
        caps (``params_cls``, ``k`` rounded) decides the engine, and its
        statics (the class caps among them) are the packing key's."""
        k_class = _pow2_at_least(k, 8)
        with self._dispatch_lock(index):
            base = self._plan(index, params_cls, k_class, self.buckets[0],
                              fw, kw, for_key=True)
        engine = base.static[engine_key]
        if engine not in ("cuda", "torch"):
            return None, self._RAGGED_RESIDUE["rank"]
        return {"family": family, "engine": engine, "np_class": np_class,
                "k_class": k_class, "n_probes": budget,
                "params_cls": params_cls, "kw": kw,
                "statics": _statics(base.static)}, None

    # family tag -> (module, attribute) of the family's ragged serving
    # body: the bucketed body with its per-row budget hook on
    _RAGGED_FNS = {
        "ivf_flat": ("raft_tpu_torch.neighbors.ivf_flat",
                     "_search_ragged_fn"),
        "ivf_bq": ("raft_tpu_torch.neighbors.ivf_bq", "_search_ragged_fn"),
        "ivf_pq": ("raft_tpu_torch.neighbors.ivf_pq", "_search_ragged_fn"),
        "tiered_ivf": ("raft_tpu_torch.neighbors.tiered",
                       "_tiered_search_ragged_fn"),
        "tiered_ivf_pq": ("raft_tpu_torch.neighbors.tiered",
                          "_tiered_pq_search_ragged_fn"),
        "tiered_ivf_bq": ("raft_tpu_torch.neighbors.tiered",
                          "_tiered_bq_search_ragged_fn"),
        "cagra": ("raft_tpu_torch.neighbors.cagra", "_search_ragged_fn"),
        "dist_ivf_flat": ("raft_tpu_torch.distributed.ivf",
                          "_dist_search_ragged_fn"),
        "dist_ivf_pq": ("raft_tpu_torch.distributed.ivf",
                        "_dist_search_ragged_pq_fn"),
        "dist_ivf_bq": ("raft_tpu_torch.distributed.bq",
                        "_dist_search_ragged_bq_fn"),
    }

    def _ragged_fn(self, family: str) -> Callable:
        import importlib

        module, attr = self._RAGGED_FNS[family]
        return getattr(importlib.import_module(module), attr)

    def _plan_ragged(self, index, fw, spec, tile: int) -> _Plan:
        """The ragged plan, derived from the family's bucketed plan at the
        class caps for a ``tile``-row bucket: the same arrays, statics
        (less the pinned-exact ``coarse_algo`` and a mesh plan's
        ``query_axis``, None here), capturability and probe
        plane (shared with the bucketed plans), with the family's ragged
        body and the family tag marked ``_ragged``. The caller holds the
        executor lock and the index's dispatch lock."""
        base = self._plan(index, spec["params_cls"], spec["k_class"], tile,
                          fw, spec["kw"])
        statics = {n: v for n, v in base.static.items()
                   if n not in ("coarse_algo", "query_axis")}
        key = (base.key[0] + "_ragged",) + base.key[1:]
        return dataclasses.replace(base, key=key,
                                   fn=self._ragged_fn(base.key[0]),
                                   static=statics, ragged=True)

    def ragged_executables(self, family: Optional[str] = None) -> int:
        """Resident ragged plan entries (at most one per (index, params
        class) per configured tile); ``family`` filters to one family
        tag (``"ivf_flat"``, ``"ivf_bq"``, ``"ivf_pq"``, ``"cagra"``,
        ``"tiered_ivf"``, ``"tiered_ivf_pq"``, ``"tiered_ivf_bq"``)."""
        with self._lock:
            return sum(1 for key in self._cache
                       if key[0].endswith("_ragged")
                       and (family is None or key[0] == family + "_ragged"))

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
            if isinstance(t, list) and t:
                t = t[0]
            if isinstance(t, torch.Tensor):
                return t.device
        raise TypeError(f"SearchExecutor does not support {type(index)!r}")

    @staticmethod
    def _dispatch_lock(index):
        """A tiered container's swap lock, of any family (one placement
        generation from the plan's snapshot through the dispatch); a no-op
        otherwise. Taken after the executor lock, the order ``apply_plan``
        keeps."""
        from raft_tpu_torch.neighbors.tiered import _TieredPlanes

        if isinstance(index, _TieredPlanes):
            return index._swap_lock
        return contextlib.nullcontext()

    def _run(self, index, queries, k, params, fw, kw, bucket=None,
             trace_ids: Tuple[int, ...] = ()):
        return _past_sessions(lambda: self._run_once(
            index, queries, k, params, fw, kw, bucket, trace_ids))

    def _run_once(self, index, queries, k, params, fw, kw, bucket,
                  trace_ids: Tuple[int, ...]):
        q = int(np.shape(queries)[0])
        bucket = bucket or self.bucket_for(q)
        with self._lock, self._dispatch_lock(index):
            plan = self._plan(index, params, k, bucket, fw, kw)
            expect(int(np.shape(queries)[1]) == plan.qdim,
                   "query dim mismatch")
            # a 2-D mesh plan pads to the grid extent, every other to the
            # bucket
            rows = plan.rows or bucket
            qp = self._padded_queries(queries, rows, plan)
            fwp = None
            if plan.use_filter and fw is not None:
                fwp = fw.to(plan.device)
                if fwp.ndim == 2:
                    fwp = _pad(fwp, rows, "zero")
            entry = self._get_entry_locked(plan, rows, k, fw, qp, fwp)
            t0 = time.perf_counter()
            out_d, out_i = self._execute_locked(plan, entry, qp, fwp, q)
        # after the lock: the readiness poll lasts as long as the slowest
        # slot, and other threads' searches and scrapes must not wait on
        # it
        if plan.slots and self.mesh_trace:
            self._record_mesh_dispatch(entry, plan, out_d, out_i, t0,
                                       trace_ids)
        return out_d, out_i

    def _record_mesh_dispatch(self, entry: _Entry, plan: _Plan, out_d,
                              out_i, t0: float,
                              trace_ids: Tuple[int, ...]) -> None:
        """The mesh spans of one sharded dispatch (``executor.py:1288``):
        the three modeled phase spans (bytes from the entry's payload
        model) from ``t0`` to the merged outputs' readiness, read by
        :func:`~raft_tpu_torch.core.tracing.poll_shard_timings`, and one
        ``serving.mesh.dispatches``.

        The JAX package polls each output shard and reduces the offsets
        into ``serving.mesh.shard`` spans and the straggler gauges. Here
        the dispatch returns only the merged outputs, one (q, k) pair
        behind every slot's work (on one card the slots run one after
        another on one stream), so there is one reading and no slot has
        a readiness of its own: the per-slot spans and the
        ``serving.mesh.shard_*`` / ``slowest_shard`` gauges stay unset
        rather than publish R copies of it."""
        from raft_tpu_torch.distributed.ivf import mesh_phases

        (ready,) = tracing.poll_shard_timings([(out_d, out_i)], t0,
                                              poll_s=_MESH_POLL_S)
        phases = (mesh_phases(entry.payload_model)
                  if entry.payload_model is not None else None)
        tracing.record_mesh_spans(entry.family, t0, t0 + ready,
                                  trace_ids=trace_ids, phases=phases)
        tracing.inc_counter("serving.mesh.dispatches")

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

    def _call(self, plan: _Plan, queries, fw, n_valid, budgets=None):
        """One eager call of the plan's body (a ragged plan's with its
        budget plane); the probe plane is updated in place."""
        args = [queries] + ([budgets] if plan.ragged else []) + list(
            plan.arrays)
        if plan.use_filter:
            args.append(fw)
        if plan.probe is None:
            return plan.fn(*args, **plan.static)
        plane = self._probe_state[plan.probe[0]]
        if plan.slots:
            # a mesh plan: each slot counts its own lists, the slot-s rows
            # of the (R, n_local) view (the dealt order)
            views = list(plane.view(plan.slots, -1))
            d, i, counts = plan.fn(*args, probe_counts=views,
                                   n_valid=n_valid, **plan.static)
            for v, c in zip(views, counts):
                v.copy_(c)
            return d, i
        d, i, counts = plan.fn(*args, probe_counts=plane, n_valid=n_valid,
                               **plan.static)
        plane.copy_(counts)
        return d, i

    def _execute_locked(self, plan: _Plan, entry: _Entry, qp, fwp,
                        q_real: int, budgets=None):
        bucket = qp.shape[0]
        named = profiling.window_open()
        timed = named and plan.device.type == "cuda"
        if timed:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        with (torch.profiler.record_function(entry.module) if named
              else contextlib.nullcontext()):
            if entry.graph is None:
                d, i = self._call(plan, qp, fwp, q_real, budgets)
                out_d, out_i = d[:q_real], i[:q_real]
            else:
                entry.static_q.copy_(qp)
                if entry.static_b is not None:
                    entry.static_b.copy_(budgets)
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
        if timed:
            ev1.record()
            profiling.note_call(entry.module, ev0, ev1)
        amounts = {"serving.execute.calls": 1.0,
                   "serving.execute.rows": float(q_real),
                   "serving.execute.padded_rows": float(bucket),
                   "serving.execute.modeled_flops":
                       entry.cost.get("flops", 0.0),
                   "serving.execute.modeled_bytes":
                       entry.cost.get("bytes_accessed", 0.0)}
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
                          qp=None, fwp=None, budgets=None) -> _Entry:
        ent = self._cache.get(plan.key)
        if ent is not None:
            self._cache.move_to_end(plan.key)
            self.stats.cache_hits += 1
            tracing.inc_counter("serving.cache_hits")
            return ent
        capture = self.capture and plan.capturable
        # before anything is counted: a miss that meets a profiler session
        # leaves here and is dispatched again after it
        with (profiling.graph_capture() if capture
              else contextlib.nullcontext()):
            self.stats.cache_misses += 1
            tracing.inc_counter("serving.cache_misses")
            digest = hashlib.sha1(repr(plan.key).encode()).hexdigest()[:12]
            ent = _Entry(plan.key[0], bucket, k, digest)
            ent.cost = dict(plan.cost()) if plan.cost is not None else {}
            t0 = time.perf_counter()
            if capture:
                self._capture_locked(plan, ent, bucket, fw, qp, fwp,
                                     budgets)
            dt = time.perf_counter() - t0
        self.stats.compile_count += 1
        tracing.inc_counter("serving.compile_count")
        if ent.graph is not None:
            ent.capture_seconds = dt
            tracing.inc_counter("serving.capture_seconds", dt)
        info = {"family": ent.family, "bucket": bucket, "k": k,
                "hlo_module": ent.module,
                "flops": ent.cost.get("flops", 0.0),
                "bytes_accessed": ent.cost.get("bytes_accessed", 0.0),
                "peak_hbm_bytes": float(ent.pool_bytes),
                "captured": ent.graph is not None,
                "capture_seconds": ent.capture_seconds,
                "launches": sum(ent.launches.values()),
                "pool_bytes": ent.pool_bytes}
        if plan.payload is not None:
            from raft_tpu_torch.distributed.ivf import publish_payload_gauges

            family, model_fn = plan.payload
            ent.payload_model = dict(model_fn())
            info["collective_family"] = family
            info["collective_payload"] = ent.payload_model
            publish_payload_gauges(family, ent.payload_model)
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
                        qp, fwp, budgets=None) -> None:
        """Warm the plan eagerly on a side stream, then capture one run
        into a CUDA graph with its own memory pool on the same stream.
        Raises on failure, leaving the thread's stream and the CUDA
        generator as they were."""
        dev = plan.device
        ent.static_q = (torch.zeros((bucket, plan.qdim), dtype=plan.qdtype,
                                    device=dev) if qp is None
                        else qp.clone())
        if plan.ragged:
            # a warmup's plane is all 0: the warm-up run probes nothing
            ent.static_b = (torch.zeros((bucket,), dtype=torch.int32,
                                        device=dev) if budgets is None
                            else budgets.clone())
        if plan.use_filter and fw is not None:
            shape = (bucket, fw.shape[1]) if fw.ndim == 2 else fw.shape
            ent.static_fw = (torch.zeros(shape, dtype=torch.int32,
                                         device=dev) if fwp is None
                             else fwp.clone())
        if plan.probe is not None:
            # 0 valid rows: the warm-up run adds nothing to the plane
            ent.static_nv = torch.zeros((), dtype=torch.int32, device=dev)
        ent.keep = tuple(_flat(plan.arrays))

        def body():
            return self._call(plan, ent.static_q, ent.static_fw,
                              ent.static_nv, ent.static_b)

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
        """``{digest: {family, bucket, k, hlo_module, flops,
        bytes_accessed, peak_hbm_bytes, captured, capture_seconds,
        launches, pool_bytes[, collective_family, collective_payload]}}``
        for every cached entry: the modeled work of one call, the
        correlation name of its profiler annotation, kernel launches per
        replay and the bytes its graph pool holds."""
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
            if "collective_payload" in info:
                from raft_tpu_torch.distributed.ivf import (
                    publish_payload_gauges,
                )

                publish_payload_gauges(info["collective_family"],
                                       info["collective_payload"])
        tracing.set_gauges(vals)

    def attach_memwatch(self, ledger) -> None:
        """Wire a :class:`~raft_tpu_torch.core.memwatch.MemoryLedger`:
        its forecast can read :meth:`memory_reservations`, and a ledger
        with ``sample_dispatch`` is sampled after every dispatch."""
        self._memwatch = ledger

    def memory_reservations(self) -> dict:
        """The executor-owned terms of the memory ledger's forecast, per
        device ordinal, in the JAX package's names with the port's
        meanings: ``donated_state_bytes`` the static input buffers of
        every captured entry (what a replay reads in place, beside the
        JAX package's donated state; its outputs live in its graph pool),
        ``probe_plane_bytes``
        the probe planes, ``max_temp_bytes`` the largest graph pool (in
        place of XLA's compile-time temp bytes: any replay may be the one
        that peaks), and ``graph_pool_bytes`` every captured entry's pool.
        Host metadata only."""
        from raft_tpu_torch.core.memwatch import _ordinal, array_bytes

        pools: dict = {}
        static: dict = {}
        planes: dict = {}

        def add(into, arr):
            o = _ordinal(arr)
            into[o] = into.get(o, 0) + array_bytes(arr)

        with self._lock:
            for ent in self._cache.values():
                if ent.graph is None:
                    continue
                o = _ordinal(ent.static_q)
                pools[o] = pools.get(o, 0) + ent.pool_bytes
                for arr in (ent.static_q, ent.static_fw, ent.static_nv,
                            ent.static_b):
                    if arr is not None:
                        add(static, arr)
            for arr in self._probe_state.values():
                add(planes, arr)
            max_pool = max((e.pool_bytes for e in self._cache.values()),
                           default=0)
            n = len(self._cache)
        return {"donated_state_bytes": static, "probe_plane_bytes": planes,
                "max_temp_bytes": float(max_pool), "graph_pool_bytes": pools,
                "executables": n}

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
        from raft_tpu_torch.distributed.bq import DistributedIvfBq
        from raft_tpu_torch.distributed.ivf import (
            DistributedIvfFlat,
            DistributedIvfPq,
        )
        from raft_tpu_torch.neighbors.brute_force import BruteForceIndex
        from raft_tpu_torch.neighbors.cagra import CagraIndex
        from raft_tpu_torch.neighbors.ivf_bq import IvfBqIndex
        from raft_tpu_torch.neighbors.ivf_flat import IvfFlatIndex
        from raft_tpu_torch.neighbors.ivf_pq import IvfPqIndex
        from raft_tpu_torch.neighbors.tiered import (
            TieredIvf,
            TieredIvfBq,
            TieredIvfPq,
        )

        if isinstance(index, BruteForceIndex):
            plan = self._plan_brute_force(index, k, bucket, fw, kw)
        elif isinstance(index, TieredIvf):
            plan = self._plan_tiered(index, params, k, bucket, fw)
        elif isinstance(index, TieredIvfPq):
            plan = self._plan_tiered_pq(index, params, k, bucket, fw)
        elif isinstance(index, TieredIvfBq):
            plan = self._plan_tiered_bq(index, params, k, bucket, fw)
        elif isinstance(index, IvfFlatIndex):
            plan = self._plan_ivf_flat(index, params, k, bucket, fw)
        elif isinstance(index, IvfBqIndex):
            plan = self._plan_ivf_bq(index, params, k, bucket, fw)
        elif isinstance(index, IvfPqIndex):
            plan = self._plan_ivf_pq(index, params, k, bucket, fw)
        elif isinstance(index, CagraIndex):
            plan = self._plan_cagra(index, params, k, bucket, fw)
        elif isinstance(index, (DistributedIvfFlat, DistributedIvfPq,
                                DistributedIvfBq)):
            plan = self._plan_dist(index, params, k, bucket, fw, kw)
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
            ptrs = tuple(a.data_ptr() for a in _flat(plan.arrays))
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
        n = index.dataset.shape[0]

        def cost():
            return {"flops": float(2 * bucket * n * index.dim),
                    "bytes_accessed": float(
                        sum(a.numel() * a.element_size()
                            for a in _flat(arrays))
                        + 4 * bucket * index.dim + 8 * bucket * k)}

        return _Plan(key=key, fn=fn, static=static, arrays=arrays,
                     device=index.dataset.device, qdtype=qdtype,
                     qdim=index.dim, cost=cost)

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
                     capturable=static["scan_engine"] == "cuda", probe=probe,
                     cost=lambda: self._flat_cost(index, bucket, k,
                                                  static["n_probes"]))

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
                     probe=probe,
                     cost=lambda: self._bq_cost(index, bucket, k,
                                                static["n_probes"]))

    def _plan_ivf_pq(self, index, params, k, bucket, fw) -> _Plan:
        from raft_tpu_torch.neighbors import ivf_pq as m

        fn, arrays, static = m.serving_plan(
            params or m.IvfPqSearchParams(), index, k, fw)
        key = ("ivf_pq", bucket, _sig(*arrays), _statics(static),
               _filter_spec(fw))
        key, probe = self._probe_plumbing(index, "ivf_pq", key)
        return _Plan(key=key, fn=fn, static=static, arrays=arrays,
                     device=index.centers.device, use_filter=True,
                     qdim=index.dim,
                     capturable=static["scan_engine"] == "cuda", probe=probe,
                     cost=lambda: self._pq_cost(
                         index, bucket, k, static["n_probes"],
                         static.get("lut_dtype")))

    def _plan_cagra(self, index, params, k, bucket, fw) -> _Plan:
        from raft_tpu_torch.neighbors import cagra as m

        fn, arrays, static = m.serving_plan(
            params or m.CagraSearchParams(), index, k, fw)
        kernel = static["engine"] == "cuda"
        key = ("cagra", bucket, _sig(*arrays),
               ("planes", index.seed_centers is not None,
                arrays[-1] is not None),
               _statics(static), _filter_spec(None if kernel else fw))
        # the walk's modeled work: every iteration expands w parents of
        # graph_degree neighbours a query, each a distance over dim
        visits = (bucket * static["max_iters"] * static["w"]
                  * index.graph.shape[1])

        def cost():
            return {"flops": float(2 * visits * index.dim),
                    "bytes_accessed": float(
                        visits * (index.dim * index.dataset.element_size()
                                  + 4)
                        + 4 * bucket * index.dim + 8 * bucket * k)}

        return _Plan(key=key, fn=fn, static=static, arrays=arrays,
                     device=index.dataset.device, use_filter=not kernel,
                     qdim=index.dim, capturable=kernel, cost=cost)

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
                     qdim=index.dim, capturable=False, probe=probe,
                     cost=lambda: self._tiered_cost(index, bucket, k,
                                                    static["n_probes"],
                                                    2 * index.dim))

    def _plan_tiered_pq(self, index, params, k, bucket, fw) -> _Plan:
        """The tiered IVF-PQ plan: ``_plan_ivf_pq``'s statics over one
        placement generation's codes planes (the caller holds the swap
        lock), keyed on shapes and statics only, so epochs keep hitting
        the entry; eager on the card too (the kernel's staging plan is
        read on the host)."""
        from raft_tpu_torch.neighbors import ivf_pq
        from raft_tpu_torch.neighbors import tiered as m

        fn, arrays, static = m.serving_plan_pq(
            params or ivf_pq.IvfPqSearchParams(), index, k, fw,
            self.res.workspace_limit_bytes)
        key = ("tiered_ivf_pq", bucket, _sig(*arrays), _statics(static),
               _filter_spec(fw))
        key, probe = self._probe_plumbing(index, "tiered_ivf_pq", key)
        return _Plan(key=key, fn=fn, static=static, arrays=arrays,
                     device=index.centers.device, use_filter=True,
                     qdim=index.dim, capturable=False, probe=probe,
                     cost=lambda: self._pq_cost(
                         index, bucket, k, static["n_probes"],
                         static.get("lut_dtype"), codes=index.hot_codes))

    def _plan_tiered_bq(self, index, params, k, bucket, fw) -> _Plan:
        """The tiered IVF-BQ plan: ``_plan_ivf_bq``'s statics over one
        placement generation's five record plane pairs; the plain fused
        engine, eager."""
        from raft_tpu_torch.neighbors import ivf_bq
        from raft_tpu_torch.neighbors import tiered as m

        fn, arrays, static = m.serving_plan_bq(
            params or ivf_bq.IvfBqSearchParams(), index, k, fw)
        key = ("tiered_ivf_bq", bucket, _sig(*arrays), _statics(static),
               _filter_spec(fw))
        key, probe = self._probe_plumbing(index, "tiered_ivf_bq", key)
        return _Plan(key=key, fn=fn, static=static, arrays=arrays,
                     device=index.centers.device, use_filter=True,
                     qdim=index.dim, capturable=False, probe=probe,
                     cost=lambda: self._tiered_cost(
                         index, bucket, k, static["n_probes"],
                         2 * index.dim_ext // 32 + 8))

    # -- modeled costs ------------------------------------------------------

    @staticmethod
    def _flat_cost(index, rows: int, k: int, n_probes: int,
                   data=None, norms=None, ids=None) -> dict:
        """IVF-Flat: each probed row is read whole (vector, norm, id) and
        costs a multiply-add a dimension."""
        data = index.data if data is None else data
        norms = index.data_norms if norms is None else norms
        ids = index.indices if ids is None else ids
        return _ivf_cost(rows, k, index.dim, index.n_lists, n_probes,
                         _live_rows(index), _row_bytes(data, norms, ids),
                         2 * index.dim)

    @staticmethod
    def _tiered_cost(index, rows: int, k: int, n_probes: int,
                     row_flops: int) -> dict:
        """A tiered container: a probed row is its share of a list's
        tiered planes (:attr:`block_bytes`) and its id, wherever the list
        lives."""
        ext = max(index.max_list_size, 1)
        return _ivf_cost(rows, k, index.dim, index.n_lists, n_probes,
                         _live_rows(index), index.block_bytes // ext + 4,
                         row_flops)

    @staticmethod
    def _pq_cost(index, rows: int, k: int, n_probes: int, lut_dtype,
                 codes=None, ids=None) -> dict:
        """IVF-PQ: a probed row is its codes and id, scored by one LUT add
        a subspace; each (query, probe) builds its LUT (a rotated residual,
        then 2^bits entries a subspace over pq_len) and reads it once."""
        codes = index.codes if codes is None else codes
        ids = index.indices if ids is None else ids
        pq_dim = int(index.pq_dim)
        book = 1 << int(index.pq_bits)
        pq_len = int(index.pq_len)
        item = torch.empty((), dtype=lut_dtype or torch.float32
                           ).element_size()
        pairs = rows * n_probes
        return _ivf_cost(
            rows, k, index.dim, index.n_lists, n_probes, _live_rows(index),
            _row_bytes(codes, ids), pq_dim,
            extra_bytes=pairs * pq_dim * book * item,
            extra_flops=pairs * (2 * index.dim * pq_dim * pq_len
                                 + 3 * pq_dim * book * pq_len))

    @staticmethod
    def _bq_cost(index, rows: int, k: int, n_probes: int,
                 planes=None, data=None) -> dict:
        """IVF-BQ: a probed row is its code and correction planes, scored
        by a popcount estimate a code word; the survivors reranked exactly
        are modeled as ``k`` full rows a query (the least a fused search
        reads)."""
        if planes is None:
            planes = (index.codes, index.rnorm, index.cfac, index.errw,
                      index.indices)
        data = index.data if data is None else data
        dim_ext = int(index.dim_ext)
        rerank = 0
        if data is not None:
            rerank = rows * k * (index.dim * data.element_size() + 4)
        return _ivf_cost(rows, k, index.dim, index.n_lists, n_probes,
                         _live_rows(index), _row_bytes(*planes),
                         2 * dim_ext // 32 + 8,
                         extra_bytes=rerank,
                         extra_flops=2 * rows * k * index.dim)

    # -- the mesh plans -----------------------------------------------------

    def _dist_statics(self, index, kw) -> tuple:
        """The shared mesh-plan pieces ``(comms, probe_mode, wire_dtype,
        probe_wire_dtype, query_axis)``, validated (``executor.py:1702``).
        ``"auto"`` wires resolve in :meth:`_plan_dist` once the probe
        budget is known."""
        from raft_tpu_torch.comms.comms import (
            resolve_probe_wire_dtype,
            resolve_wire_dtype,
        )

        comms = index.comms
        probe_mode = kw.get("probe_mode", "global")
        wire_dtype = kw.get("wire_dtype", "f32")
        probe_wire_dtype = kw.get("probe_wire_dtype", "f32")
        query_axis = kw.get("query_axis")
        expect(probe_mode in ("global", "local"),
               f"probe_mode must be 'global' or 'local', got {probe_mode!r}")
        if wire_dtype != "auto":
            resolve_wire_dtype(wire_dtype)
        if probe_wire_dtype != "auto":
            resolve_probe_wire_dtype(probe_wire_dtype)
        if query_axis is not None:
            expect(query_axis in comms.mesh.axis_names
                   and query_axis != comms.axis,
                   f"query_axis {query_axis!r} must be another mesh axis")
        return comms, probe_mode, wire_dtype, probe_wire_dtype, query_axis

    def _plan_dist(self, index, params, k, bucket, fw, kw) -> _Plan:
        """One plan builder for the three list-sharded families
        (``executor.py:1735``): the probe budget, engine and wires as the
        direct searches resolve them, the family's statics and per-slot
        arrays, the mesh key, the slot-viewed probe plane and the payload
        model. The ragged plans derive from it (:meth:`_plan_ragged`)."""
        from raft_tpu_torch.distributed import bq as dist_bq
        from raft_tpu_torch.distributed import ivf as dist_ivf
        from raft_tpu_torch.neighbors import ivf_bq, ivf_flat, ivf_pq

        expect(fw is None,
               "distributed searches have no sample_filter support")
        (comms, probe_mode, wire_dtype, probe_wire_dtype,
         query_axis) = self._dist_statics(index, kw)
        r = comms.size
        rows = bucket
        if query_axis is not None:
            # whole query shards, each a whole scatter-merge slice per
            # list shard: a multiple of the grid extent
            grid = comms.mesh.shape[query_axis] * r
            rows = -(-bucket // grid) * grid
        if isinstance(index, dist_ivf.DistributedIvfFlat):
            family, fn = "dist_ivf_flat", dist_ivf._dist_search_fn
            params = params or ivf_flat.IvfFlatSearchParams()
            engine = dist_ivf.resolve_flat_engine(params, index, k)
            extra, key_extra = {}, ()
            arrays = (index.centers, index.center_norms, index.data,
                      index.data_norms, index.indices)
        elif isinstance(index, dist_ivf.DistributedIvfPq):
            family, fn = "dist_ivf_pq", dist_ivf._dist_search_pq_fn
            params = params or ivf_pq.IvfPqSearchParams()
            engine, score_mode = dist_ivf.resolve_pq_engine(params, index, k)
            extra = {"codebook_kind": index.codebook_kind,
                     "score_mode": score_mode,
                     "lut_dtype": params.lut_dtype}
            key_extra = ()
            arrays = (index.centers, index.center_norms, index.rotation,
                      index.codebooks, index.codes, index.indices)
        else:
            family, fn = "dist_ivf_bq", dist_bq._dist_search_bq_fn
            params = params or ivf_bq.IvfBqSearchParams()
            engine = dist_bq.resolve_bq_serving_engine(params, index, k)
            extra = {"epsilon": params.epsilon,
                     "query_bits": params.query_bits}
            key_extra = (("data", index.data is not None),)
            arrays = (index.centers, index.center_norms, index.centers_rot,
                      index.rotation, index.codes, index.rnorm, index.cfac,
                      index.errw, index.indices, index.data,
                      index.data_norms)
        expect(params.coarse_algo in ("exact", "approx"),
               f"coarse_algo must be 'exact' or 'approx', got "
               f"{params.coarse_algo!r}")
        n_probes = dist_ivf.resolve_probe_budget(
            params.n_probes, index.n_lists, r, probe_mode)
        wire_dtype, probe_wire_dtype = dist_ivf.resolve_auto_wires(
            rows, k, n_probes, index.n_lists, r, wire_dtype, probe_mode,
            probe_wire_dtype)
        static = {"comms": comms, "n_probes": n_probes, "k": k,
                  "metric": index.metric, "probe_mode": probe_mode,
                  "coarse_algo": params.coarse_algo, "scan_engine": engine,
                  "wire_dtype": wire_dtype,
                  "probe_wire_dtype": probe_wire_dtype,
                  "query_axis": query_axis, **extra}
        key = ((family, rows, _mesh_key(comms), _sig(*arrays)) + key_extra
               + (_statics({n: v for n, v in static.items()
                            if n != "comms"}), _filter_spec(None)))
        probe, slots = None, r
        if query_axis is None:
            key, probe = self._probe_plumbing(index, family, key)
            devs = set(map(str, comms.mesh.slot_devices()))
            expect(probe is None or len(devs) == 1,
                   "mesh probe accounting needs every slot on one device")
        model = lambda: dist_ivf.collective_payload_model(  # noqa: E731
            rows, k, n_probes, index.n_lists, r, wire_dtype, probe_mode,
            probe_wire_dtype)
        cost = lambda: self._dist_cost(  # noqa: E731
            index, family, rows, k, n_probes, params, model())
        return _Plan(key=key, fn=fn, static=static, arrays=arrays,
                     device=comms.mesh.slot_devices()[0], qdim=index.dim,
                     capturable=engine == "cuda", probe=probe, slots=slots,
                     rows=rows if query_axis is not None else None,
                     payload=(family, model), cost=cost)

    def _dist_cost(self, index, family, rows, k, n_probes, params,
                   payload: dict) -> dict:
        """A mesh plan's modeled work: its family's over all lists (a
        shard's planes stand for every shard's, the lists being dealt
        whole), plus every slot's collective payload."""
        r = index.comms.size
        if family == "dist_ivf_flat":
            cost = self._flat_cost(index, rows, k, n_probes,
                                   data=index.data[0],
                                   norms=index.data_norms[0],
                                   ids=index.indices[0])
        elif family == "dist_ivf_pq":
            cost = self._pq_cost(index, rows, k, n_probes, params.lut_dtype,
                                 codes=index.codes[0], ids=index.indices[0])
        else:
            cost = self._bq_cost(
                index, rows, k, n_probes,
                planes=(index.codes[0], index.rnorm[0], index.cfac[0],
                        index.errw[0], index.indices[0]),
                data=index.data[0] if index.data is not None else None)
        wire = r * (payload["coarse_bytes"] + payload["merge_bytes"])
        cost["bytes_accessed"] += float(wire)
        return cost
