"""Background dynamic micro-batcher — the port of
``raft_tpu/serving/batcher.py``.

Small requests coalesce into the executor's power-of-two buckets, under
a **dual trigger**: a micro-batch dispatches when its group's query rows
reach ``full_batch_rows`` (bucket-full) or when its oldest request has
waited ``max_wait_s`` (timer), whichever comes first. p99 latency is
therefore bounded by ``max_wait_s`` plus one device execute, while
bursts fill whole buckets.

Requests coalesce only within a compatibility group, the executor's
:meth:`~raft_tpu_torch.core.executor.SearchExecutor.coalesce_key`, and
the assembled batch runs through
:meth:`~raft_tpu_torch.core.executor.SearchExecutor.search_blocks`: on
the card, a replay of the bucket's captured CUDA graph. Results are
bit-identical to direct executor calls, because pad rows are inert and
every row's result is independent. The batcher waits for a batch's
results on a CUDA event recorded after its dispatch before completing
the handles.

Scheduling is :class:`~raft_tpu_torch.serving.admission.AdmissionQueue`'s
(bounded with backpressure, EDF within priority, expired requests shed
before dispatch). The batcher is stdlib threading: one daemon worker,
one condition variable, an injectable clock; the fault harness
(:mod:`raft_tpu_torch.serving.harness`) drives it deterministically with
``start=False`` + :meth:`DynamicBatcher.pump` and a manual clock.

**Ragged continuous batching** (``BatcherConfig(ragged=True)``): raggable
submissions group by the executor's
:meth:`~raft_tpu_torch.core.executor.SearchExecutor.ragged_key`, so
requests with different ``n_probes``/``k`` under one params class share
one packed call; they fill the open packed tile continuously and split
at its edge instead of waiting for a tile they fit whole (the dual
trigger becomes tile-full or max-wait; a split remainder keeps its order
key). The tile runs through
:meth:`~raft_tpu_torch.core.executor.SearchExecutor.search_ragged`, and a
split request completes once, when its last slice lands. Everything else
(brute force, approximate coarse selection, codes-only IVF-BQ, CAGRA at
a ``k`` class past ``itopk_size``) falls back to the bucketed path.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.serving import metrics
from raft_tpu_torch.serving.admission import AdmissionQueue, LoadShed
from raft_tpu_torch.serving.request import (
    Overloaded,
    ResultHandle,
    SearchRequest,
    ShutDown,
)


def _wait_for(results) -> None:
    """Wait until a dispatch's results are on their device: a CUDA event
    recorded on the current stream after the dispatch, waited on by this
    thread alone (never ``torch.cuda.synchronize()``, which would wait
    for other threads' work too). CPU results are ready already."""
    for d, i in results:
        if isinstance(d, torch.Tensor) and d.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(d.device))
            ev.synchronize()
            return


class MonotonicClock:
    """Production clock: ``time.monotonic`` + plain condition waits."""

    def now(self) -> float:
        return time.monotonic()

    def wait(self, cond: threading.Condition, timeout: Optional[float]):
        """Block on ``cond`` (caller holds it) until notified or
        ``timeout`` elapses. Manual clocks override this to make the
        wait a deterministic rendezvous instead of a real sleep."""
        cond.wait(timeout)


@dataclasses.dataclass(frozen=True)
class AdaptiveWait:
    """Control law for the adaptive ``max_wait_s``: map the admission
    queue's EWMA arrival rate (``serving.admission.arrival_rate_hz``) to
    a bounded effective max-wait. High rate → shrink toward ``min_wait_s`` (bursts fill
    buckets fast; extra waiting only adds latency); idle → grow toward
    the configured ``max_wait_s`` cap (a lone request may as well wait
    the full budget for company). Linear interpolation between the two
    rate knees, so the manual-clock tests pin the output exactly; the
    rate itself is clock-domain (EWMA over ``req.arrival`` gaps), so
    the whole loop stays deterministic under the fault harness. Off by
    default — see :attr:`BatcherConfig.adaptive_wait`."""

    low_rate_hz: float = 50.0
    high_rate_hz: float = 2000.0
    min_wait_s: float = 0.0

    def wait_for(self, rate_hz: float, max_wait_s: float) -> float:
        """Effective max-wait for the observed arrival rate (0.0 rate
        — nothing measured yet — gets the full configured cap)."""
        if rate_hz <= self.low_rate_hz:
            return max_wait_s
        if rate_hz >= self.high_rate_hz:
            return self.min_wait_s
        frac = ((rate_hz - self.low_rate_hz)
                / (self.high_rate_hz - self.low_rate_hz))
        return max_wait_s + (self.min_wait_s - max_wait_s) * frac


@dataclasses.dataclass(frozen=True)
class BatcherConfig:
    """Tuning knobs of :class:`DynamicBatcher`.

    ``max_wait_s`` bounds the batching delay any request can be charged
    (the timer half of the dual trigger); ``full_batch_rows`` is the
    bucket-full half and the cap on rows per micro-batch (an oversized
    single request still dispatches alone; the executor tiles it).
    ``capacity`` bounds the admission queue; ``default_timeout_s``
    applies a deadline to requests that carry none (None: no deadline).
    ``shed`` is the degradation ladder. ``slo`` configures the
    deadline-attainment burn-rate window (None disables it);
    ``multiburn`` swaps in the paired short and long window alert.
    ``adaptive_wait`` (off by default) enables the arrival-rate to
    max-wait control law; the ladder's rung 1 (wait 0) takes precedence.
    ``group_budget`` caps consecutive dispatches from one compatibility
    group while another group is dispatch-ready (0 disables); the wait of
    the groups passed over is the ``serving.batcher.group_starvation_s``
    gauge.

    ``ragged`` (off by default) routes raggable submissions onto the
    executor's packed-batch plans: they group by ``executor.ragged_key``,
    fill ``executor.ragged_tile`` rows (the tile-full half of the dual
    trigger; an executor with a small tile picks it at dispatch) and
    split at the tile's edge. The rest stay bucketed."""

    max_wait_s: float = 0.002
    full_batch_rows: int = 256
    capacity: int = 1024
    default_timeout_s: Optional[float] = None
    shed: LoadShed = dataclasses.field(default_factory=LoadShed)
    slo: Optional[metrics.SloConfig] = dataclasses.field(
        default_factory=metrics.SloConfig)
    multiburn: Optional[metrics.MultiBurnConfig] = None
    adaptive_wait: Optional[AdaptiveWait] = None
    ragged: bool = False
    group_budget: int = 8


class DynamicBatcher:
    """Async dynamic micro-batcher in front of a ``SearchExecutor``.

    Example::

        ex = SearchExecutor(res)
        ex.warmup(index, k=10)
        b = DynamicBatcher(ex)
        h = b.submit(index, queries, 10, timeout_s=0.050)
        d, i = h.result()          # typed ServingError on failure
        b.close()

    ``submit`` never blocks on device work: it admits (or rejects with
    typed ``Overloaded``), wakes the worker, and returns a
    :class:`~raft_tpu_torch.serving.request.ResultHandle`. With
    ``start=False`` no thread runs and :meth:`pump` processes ready
    work synchronously — the deterministic mode the fault-injection
    suite drives with a manual clock."""

    def __init__(self, executor, config: Optional[BatcherConfig] = None,
                 *, clock=None, start: bool = True):
        self.executor = executor
        self.config = config or BatcherConfig()
        expect(self.config.max_wait_s >= 0.0, "max_wait_s must be >= 0")
        expect(self.config.full_batch_rows > 0,
               "full_batch_rows must be > 0")
        self._clock = clock or MonotonicClock()
        # multiburn (paired windows + alert) and the single window are
        # duck-type equivalent on the completion paths: record/publish
        if self.config.multiburn is not None:
            self._slo = metrics.MultiBurnAlert(self.config.multiburn)
        else:
            self._slo = (metrics.SloWindow(self.config.slo)
                         if self.config.slo is not None else None)
        # the queue records deadline-shed requests as SLO misses (they
        # are pruned inside its lock, where the batcher never sees them)
        self._queue = AdmissionQueue(self.config.capacity,
                                     self.config.shed, slo=self._slo)
        self._cond = threading.Condition()
        self._closing = False   # guarded-by: _cond
        # fairness bookkeeping: the group served last and its streak
        self._last_key = None   # guarded-by: _cond
        self._consecutive = 0   # guarded-by: _cond
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._loop, name="raft-tpu-batcher", daemon=True)
            self._thread.start()

    # -- caller side --------------------------------------------------------

    def submit(self, index, queries, k: int, params=None, *,
               timeout_s: Optional[float] = None,
               deadline: Optional[float] = None, priority: int = 0,
               sample_filter=None, **kw) -> ResultHandle:
        """Enqueue one search. ``timeout_s`` (relative) or ``deadline``
        (absolute, clock domain) bound its queue life; expired requests
        are shed before device dispatch. A 2-D (per-row) filter rides
        the request and is re-concatenated at dispatch; a 1-D (shared)
        filter coalesces by words-array identity — pass the same
        filter object for requests that should share a call. Raises
        typed ``Overloaded`` on a full queue and ``ShutDown`` after
        :meth:`close`; unsupported index/params/filter combinations
        fail here, synchronously."""
        # a racy fast-fail: the check that decides re-runs under _cond
        if self._closing:  # graftlint: disable=R8(benign racy fast-fail; the authoritative check re-runs under _cond before enqueue)
            raise ShutDown("batcher is closed")
        now = self._clock.now()
        if deadline is None:
            t = (timeout_s if timeout_s is not None
                 else self.config.default_timeout_s)
            deadline = now + t if t is not None else None
        shed = self.config.shed
        degrade_events = ()
        if (shed.params_override is not None
                and self._queue.shed_level() >= 2):
            params = shed.params_override(params)
            tracing.inc_counter("serving.batcher.shed_degraded_params")
            degrade_events = ((now, "degraded_params",
                               {"reason": "shed_rung_2"}),)
        # resolve the filter to its words ONCE (wrapper types carry no
        # row info themselves); the executor's coalesce key validates
        # the plan up front but carries only the filter's spec, so 1-D
        # (shared) words additionally key by array identity — two
        # different bitsets of equal shape must never share a call
        from raft_tpu_torch.neighbors.filters import resolve_filter_words

        fw = resolve_filter_words(sample_filter)
        # ragged: raggable submissions group by the packing key (the
        # ladder's params override is already applied, so a degraded
        # submission packs like any other bearer of those params); the
        # rest fall back to the bucketed coalesce key
        ragged = False
        compat_key = None
        if self.config.ragged:
            compat_key = self.executor.ragged_key(
                index, k, params=params, sample_filter=fw, **kw)
            ragged = compat_key is not None
        if compat_key is None:
            compat_key = self.executor.coalesce_key(
                index, k, params=params, sample_filter=fw, **kw)
        if fw is not None:
            if fw.ndim == 1:
                compat_key = compat_key + (id(fw),)
            else:
                expect(fw.shape[0] == int(np.shape(queries)[0]),
                       "2-D filter rows must match query rows")
        req = SearchRequest(index=index, queries=queries, k=k,
                            params=params, deadline=deadline,
                            priority=priority,
                            sample_filter=fw, kw=dict(kw),
                            compat_key=compat_key, arrival=now,
                            ragged=ragged)
        # admission happens under the scheduler lock: a submit racing
        # close() either lands before the final drain (and is drained)
        # or sees _closing and fails typed — never a stranded handle
        with self._cond:
            if self._closing:
                raise ShutDown("batcher is closed")
            try:
                self._queue.push(req)  # typed Overloaded on overflow
            except Overloaded:
                # a rejected deadline-carrying request IS an SLO miss:
                # under total overload the window must fill with misses,
                # not sit empty reading burn_rate = 0 during the outage
                if self._slo is not None and req.deadline is not None:
                    self._slo.record(now, False)
                raise
            self._cond.notify_all()
        tracing.record_span(
            "serving.admission", now, self._clock.now(),
            trace_ids=(req.trace_id,),
            attrs={"rows": req.rows, "priority": priority,
                   "deadline": deadline},
            events=degrade_events)
        return req.handle

    def pump(self) -> int:
        """Synchronously dispatch every micro-batch that is ready at
        the current clock time (deterministic mode; also usable as a
        flush with a running worker). Returns batches dispatched."""
        n = 0
        while True:
            batch = self._poll()
            if not batch:
                return n
            self._dispatch_any(*batch)
            n += 1

    def close(self, drain: bool = True) -> None:
        """Shut down. ``drain=True`` dispatches everything still queued
        (in-flight batches complete normally); ``drain=False`` fails
        queued requests with typed ``ShutDown``. Idempotent; joins the
        worker thread, so no threads or pending futures leak."""
        def _shutdown_shed(reqs):
            now = self._clock.now()
            for r in reqs:
                if r.handle._set_exception(
                        ShutDown("batcher closed before dispatch")):
                    tracing.inc_counter("serving.batcher.shutdown_shed")
                    tracing.span_event(
                        "serving.shed", now, trace_ids=(r.trace_id,),
                        attrs={"reason": "shutdown"})

        with self._cond:
            if self._closing:
                self._cond.notify_all()
            self._closing = True
            if not drain:
                _shutdown_shed(self._queue.drain())
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        elif drain:
            self.pump()            # threadless mode drains inline
        # anything left (e.g. raced submits) fails typed rather than
        # hanging its caller forever
        _shutdown_shed(self._queue.drain())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- worker -------------------------------------------------------------

    def publish_slo_gauges(self) -> None:
        """Re-publish the SLO burn-rate gauges as of the batcher
        clock's now — the exporter's scrape-time refresh, so misses age
        out of the window even while no new requests complete."""
        if self._slo is not None:
            self._slo.publish(self._clock.now())

    def _effective_max_wait(self) -> float:
        """Ladder rung 1: above ``shrink_wait_at`` occupancy the timer
        trigger collapses to 0 — drain beats batching delay. Below it,
        the optional :class:`AdaptiveWait` control law maps the
        observed arrival rate into [min_wait, max_wait] (published as
        the ``serving.batcher.effective_max_wait_s`` gauge)."""
        if self._queue.shed_level() >= 1:
            return 0.0
        aw = self.config.adaptive_wait
        if aw is None:
            return self.config.max_wait_s
        wait = aw.wait_for(self._queue.arrival_rate(),
                           self.config.max_wait_s)
        tracing.set_gauge("serving.batcher.effective_max_wait_s", wait)
        return wait

    def _poll(self):
        """One non-blocking scheduling decision: the next ready
        micro-batch as ``(key, items, ragged)`` (items are requests, or
        ``(request, start, stop)`` row slices when ragged), or ``()``
        when nothing is ready yet."""
        with self._cond:
            return self._select(block=False)

    def _pick_fair(self, ready):
        """Most urgent dispatch-ready group, except when one group has
        held the worker ``group_budget`` consecutive dispatches while
        another group is also ready — then the most urgent OTHER ready
        group is served (cross-index fairness: a slow family's group
        cannot monopolize the loop). Pure selection: the streak only
        advances in :meth:`_record_pick`, once the pop actually yields
        a dispatch — a cancel-race empty pop must not burn budget the
        picked group never used."""
        pick = ready[0]
        budget = self.config.group_budget
        if (budget and len(ready) > 1 and pick.key == self._last_key
                and self._consecutive >= budget):
            pick = ready[1]
        return pick

    def _record_pick(self, pick, ready, now: float) -> None:
        """Account one real dispatch to the fairness streak and
        publish the ``serving.batcher.group_starvation_s`` gauge: the
        longest any passed-over ready group has waited."""
        if pick.key == self._last_key:
            self._consecutive += 1
        else:
            self._last_key = pick.key
            self._consecutive = 1
        starve = max((now - h.arrival for h in ready
                      if h.key != pick.key), default=0.0)
        tracing.set_gauge("serving.batcher.group_starvation_s", starve)

    def _tile_rows(self, head) -> int:
        """The row cap of one micro-batch of this group: the executor's
        packed tile when ragged, else ``full_batch_rows``."""
        if head.ragged:
            return int(self.executor.ragged_tile)
        return self.config.full_batch_rows

    def _select(self, block: bool):
        """Core of the dual trigger (caller holds ``self._cond``)."""
        while True:
            now = self._clock.now()
            heads = self._queue.group_heads(now)
            if not heads:
                if self._closing or not block:
                    return None if self._closing else ()
                self._clock.wait(self._cond, None)
                continue
            wait = self._effective_max_wait()
            # every group's trigger is evaluated (not only the most
            # urgent group's): a tile-full group is never stuck behind
            # a more-urgent group still waiting out its timer
            ready = [h for h in heads
                     if h.rows >= self._tile_rows(h)
                     or now >= h.arrival + wait or self._closing]
            if ready:
                pick = self._pick_fair(ready)
                pop = (self._queue.pop_rows if pick.ragged
                       else self._queue.pop_group)
                items = pop(pick.key, self._tile_rows(pick), now)
                if not items:      # cancels won every race — rescan
                    continue
                self._record_pick(pick, ready, now)
                return (pick.key, items, pick.ragged)
            if not block:
                return ()
            soonest = min(h.arrival + wait for h in heads)
            self._clock.wait(self._cond, soonest - now)

    def _loop(self) -> None:
        while True:
            with self._cond:
                batch = self._select(block=True)
            if batch is None:
                return             # closed and drained
            if batch:
                self._dispatch_any(*batch)

    def _dispatch_any(self, key, items, ragged: bool) -> None:
        if ragged:
            self._dispatch_ragged(key, items)
        else:
            self._dispatch(key, items)

    def _dispatch(self, key, reqs) -> None:
        """Assemble one micro-batch, execute, split results back.

        Each stage records a span into the flight recorder carrying
        every member request's ``trace_id`` — pure host-side deque
        appends in the batcher clock's domain, so the device dispatch
        sequence (and its zero-recompile guarantee) is untouched."""
        t0 = self._clock.now()
        ids = tuple(r.trace_id for r in reqs)
        for r in reqs:
            metrics.observe_stage(metrics.QUEUE_WAIT, t0 - r.arrival)
        rep = reqs[0]
        blocks = [r.queries for r in reqs]
        n_rows = sum(r.rows for r in reqs)
        # requests carry RESOLVED filter words (see submit): 1-D words
        # are shared by coalesce-key construction, 2-D (per-row) words
        # concatenate to match the concatenated query rows
        fw = rep.sample_filter
        if fw is not None and fw.ndim == 2 and len(reqs) > 1:
            parts = [r.sample_filter for r in reqs]
            if all(isinstance(p, np.ndarray) for p in parts):
                fw = np.concatenate(parts)
            else:
                fw = torch.cat([torch.as_tensor(p) for p in parts])
        t1 = self._clock.now()
        metrics.observe_stage(metrics.ASSEMBLY, t1 - t0)
        tracing.record_span("serving.assembly", t0, t1, trace_ids=ids,
                            attrs={"requests": len(reqs), "rows": n_rows})
        try:
            results = self.executor.search_blocks(
                rep.index, blocks, rep.k, params=rep.params,
                sample_filter=fw, trace_ids=ids, **rep.kw)
            _wait_for(results)
        except Exception as e:  # noqa: BLE001 — fail the handles, not the worker
            t_fail = self._clock.now()
            for r in reqs:
                performed = r.handle._set_exception(e)
                # a failed deadline-carrying request is an SLO miss: a
                # wedged executor must drive the burn rate up, not
                # starve the window into a healthy-looking 0.0. Keyed
                # on the handle transition so a shutdown-drained
                # request (already completed, exempt by contract) is
                # not recorded a second time.
                if performed and self._slo is not None \
                        and r.deadline is not None:
                    self._slo.record(t_fail, False)
            tracing.inc_counter("serving.batcher.failed_batches")
            tracing.record_span(
                "serving.execute", t1, t_fail, trace_ids=ids,
                attrs={"requests": len(reqs), "rows": n_rows},
                events=((t_fail, "failed",
                         {"error": type(e).__name__}),))
            return
        t2 = self._clock.now()
        metrics.observe_stage(metrics.EXECUTE, t2 - t1)
        # per-params-class latency: a coalesced batch shares one params
        # object, so one observation covers the batch
        cls = metrics.params_class(rep.params)
        if cls is not None:
            metrics.observe_execute_class(cls, t2 - t1)
        tracing.record_span("serving.execute", t1, t2, trace_ids=ids,
                            attrs={"requests": len(reqs), "rows": n_rows})
        delivered = [r.handle._set_result(d, i)
                     for r, (d, i) in zip(reqs, results)]
        t3 = self._clock.now()
        metrics.observe_stage(metrics.SPLIT, t3 - t2)
        tracing.record_span("serving.split", t2, t3, trace_ids=ids,
                            attrs={"requests": len(reqs)})
        for r, ok in zip(reqs, delivered):
            metrics.observe_stage(metrics.E2E, t3 - r.arrival)
            tracing.record_span("serving.request", r.arrival, t3,
                                trace_ids=(r.trace_id,),
                                attrs={"rows": r.rows})
            # SLO attainment: a deadline-carrying request that completed
            # is attained iff its result landed before the deadline (a
            # late completion is a miss even though the caller gets a
            # result — the deadline-shed path records its misses inside
            # the admission queue). Keyed on the handle transition
            # (``ok``) so a request something else already completed —
            # the shutdown drain — lands exactly one outcome.
            if ok and self._slo is not None and r.deadline is not None:
                self._slo.record(t3, t3 <= r.deadline)
        metrics.batch_dispatched(len(reqs), n_rows)

    def _dispatch_ragged(self, key, slices) -> None:
        """Assemble one packed tile from ``(request, start, stop)`` row
        slices, run it through ``executor.search_ragged``, wait for it on
        a CUDA event, and complete every request whose last slice landed:
        a split request's earlier slices gather on the request, and its
        result, SLO outcome and ``serving.request`` span come exactly
        once. Stage spans mirror :meth:`_dispatch`'s."""
        t0 = self._clock.now()
        ids = tuple(dict.fromkeys(r.trace_id for r, _, _ in slices))
        n_rows = sum(stop - start for _, start, stop in slices)
        blocks, ks, params_list, fw2 = [], [], [], []
        rep = slices[0][0]
        for r, start, stop in slices:
            if start == 0:
                metrics.observe_stage(metrics.QUEUE_WAIT, t0 - r.arrival)
            blocks.append(r.queries[start:stop])
            ks.append(r.k)
            params_list.append(r.params)
            if r.sample_filter is not None and r.sample_filter.ndim == 2:
                fw2.append(r.sample_filter[start:stop])
        # 1-D words are shared by key construction (their identity joins
        # the key); 2-D per-row words concatenate to the packed rows
        fw = rep.sample_filter
        if fw2:
            if all(isinstance(p, np.ndarray) for p in fw2):
                fw = np.concatenate(fw2)
            else:
                fw = torch.cat([torch.as_tensor(p) for p in fw2])
        t1 = self._clock.now()
        metrics.observe_stage(metrics.ASSEMBLY, t1 - t0)
        tracing.record_span(
            "serving.assembly", t0, t1, trace_ids=ids,
            attrs={"requests": len(ids), "slices": len(slices),
                   "rows": n_rows, "ragged": True})
        try:
            results = self.executor.search_ragged(
                rep.index, blocks, ks, params_list=params_list,
                sample_filter=fw, trace_ids=ids, **rep.kw)
            _wait_for(results)
        except Exception as e:  # noqa: BLE001 — fail the handles, not the worker
            t_fail = self._clock.now()
            for r in {id(r): r for r, _, _ in slices}.values():
                performed = r.handle._set_exception(e)
                if performed and self._slo is not None \
                        and r.deadline is not None:
                    self._slo.record(t_fail, False)
            tracing.inc_counter("serving.batcher.failed_batches")
            tracing.record_span(
                "serving.execute", t1, t_fail, trace_ids=ids,
                attrs={"requests": len(ids), "rows": n_rows,
                       "ragged": True},
                events=((t_fail, "failed",
                         {"error": type(e).__name__}),))
            return
        t2 = self._clock.now()
        metrics.observe_stage(metrics.EXECUTE, t2 - t1)
        # a packed tile mixes params: its execute latency lands once in
        # each distinct params class present
        for cls in dict.fromkeys(
                metrics.params_class(p) for p in params_list):
            if cls is not None:
                metrics.observe_execute_class(cls, t2 - t1)
        tracing.record_span("serving.execute", t1, t2, trace_ids=ids,
                            attrs={"requests": len(ids), "rows": n_rows,
                                   "ragged": True})
        finished = []
        for (r, start, stop), (d, i) in zip(slices, results):
            if start == 0 and stop == r.rows:
                finished.append((r, d, i))       # unsplit
            elif r.add_part(start, d, i):
                fd, fi = r.assemble()
                finished.append((r, fd, fi))
        delivered = [(r, r.handle._set_result(d, i))
                     for r, d, i in finished]
        t3 = self._clock.now()
        metrics.observe_stage(metrics.SPLIT, t3 - t2)
        tracing.record_span("serving.split", t2, t3, trace_ids=ids,
                            attrs={"requests": len(finished)})
        for r, ok in delivered:
            metrics.observe_stage(metrics.E2E, t3 - r.arrival)
            tracing.record_span("serving.request", r.arrival, t3,
                                trace_ids=(r.trace_id,),
                                attrs={"rows": r.rows, "ragged": True})
            if ok and self._slo is not None and r.deadline is not None:
                self._slo.record(t3, t3 <= r.deadline)
        metrics.batch_dispatched(len(finished), n_rows)
