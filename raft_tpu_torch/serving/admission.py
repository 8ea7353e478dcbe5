"""Admission control — the port of ``raft_tpu/serving/admission.py``:
bounded queue, deadline-aware scheduling, and the graceful-degradation
ladder.

- **Bounded with backpressure**: ``push`` raises
  :class:`~raft_tpu_torch.serving.request.Overloaded` once ``capacity``
  requests are queued.
- **Deadline-aware**: requests order by (priority class, earliest
  deadline, arrival); expired requests are shed before any device work
  and complete with
  :class:`~raft_tpu_torch.serving.request.DeadlineExceeded`.
- **Coalescing-aware**: requests group by their executor
  ``coalesce_key``; the batcher pops one *group* at a time, so a
  micro-batch only holds requests that may share one plan entry.

The degradation ladder (:class:`LoadShed`), mildest first:

====  ==========================  =========================================
rung  trigger (occupancy >=)      action
====  ==========================  =========================================
0     —                           normal: dual-trigger batching
1     ``shrink_wait_at``          max-wait shrinks to 0; background-class
                                  submissions (priority >=
                                  ``background_priority``) reject from
                                  ``background_reject_at``
2     ``degrade_params_at``       the load-shed params override applies to
                                  NEW submissions (part of the coalesce
                                  key, so warm it up ahead of time)
3     queue full                  reject with typed ``Overloaded``
====  ==========================  =========================================

Not ported yet: ``pop_rows``, the ragged path's row claims (with the
ragged plan family).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, NamedTuple, Optional

from raft_tpu_torch.core import tracing
from raft_tpu_torch.serving.request import Overloaded, SearchRequest


class GroupHead(NamedTuple):
    """One compatibility group's scheduling summary (see
    :meth:`AdmissionQueue.group_heads`): its key, the oldest member's
    arrival (the dual trigger's timer anchor), the queued row count and
    the most-urgent member's order key."""

    key: Any
    arrival: float
    rows: int
    urgent: tuple


@dataclasses.dataclass(frozen=True)
class LoadShed:
    """Degradation-ladder configuration (see module docstring).

    ``params_override`` is a callable ``params -> params`` applied to
    new submissions at rung 2+ (e.g. ``lambda p: dataclasses.replace(p,
    n_probes=min(p.n_probes, 8))``). It must be deterministic: the
    overridden params join the coalesce key, and a warmup of the
    degraded specialization keeps rung 2 zero-recompile too.

    ``background_priority`` declares a background request class:
    priorities at or above it are the ladder's first casualty. Once
    occupancy reaches ``background_reject_at`` the queue rejects
    background submissions with typed ``Overloaded`` while live traffic
    still admits."""

    shrink_wait_at: float = 0.5
    degrade_params_at: float = 0.75
    params_override: Optional[Any] = None
    background_priority: Optional[int] = None
    background_reject_at: float = 0.5


# EWMA smoothing for the arrival-rate gauge: each inter-arrival gap
# contributes 20% — a few bursts move the estimate, one outlier doesn't
_EWMA_ALPHA = 0.2

# instantaneous-rate floor: two arrivals at the SAME clock tick (bursts
# under a manual clock) read as one inter-arrival of this, not 1/0
_MIN_GAP_S = 1e-6


class AdmissionQueue:
    """Bounded, priority + EDF, coalescing-aware request queue.

    Exports live gauges: ``serving.admission
    .queue_depth``, ``.shed_level``, and ``.arrival_rate_hz`` — an
    EWMA over inter-arrival gaps in the *batcher clock's* domain (the
    timestamps come in on ``req.arrival``, so the queue itself never
    reads a clock and the manual-clock harness stays deterministic).
    The rate gauge is the measurement half of the planned adaptive
    ``max_wait_s`` control loop."""

    def __init__(self, capacity: int = 1024,
                 shed: Optional[LoadShed] = None, slo=None):
        self.capacity = capacity
        self.shed = shed or LoadShed()
        # optional SloWindow: deadline sheds are SLO misses, and they
        # happen here (lazy pruning) — the batcher injects its window
        # so both completion paths feed one burn-rate ledger
        self._slo = slo
        self._lock = threading.Lock()
        self._groups: Dict[Any, List[SearchRequest]] = {}  # guarded-by: _lock
        self._n = 0                                        # guarded-by: _lock
        self._rate = 0.0                                   # guarded-by: _lock
        self._last_arrival: Optional[float] = None         # guarded-by: _lock

    # -- state --------------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return self._n

    def occupancy(self) -> float:
        """Queued fraction of capacity (the ladder's trigger signal)."""
        with self._lock:
            return self._n / self.capacity if self.capacity else 1.0

    def _level_for(self, occ: float) -> int:
        if occ >= 1.0:
            return 3
        if occ >= self.shed.degrade_params_at:
            return 2
        if occ >= self.shed.shrink_wait_at:
            return 1
        return 0

    def shed_level(self) -> int:
        """Current degradation rung (0–3) from queue occupancy."""
        return self._level_for(self.occupancy())

    def arrival_rate(self) -> float:
        """EWMA arrival rate (requests/s, clock domain); 0.0 before the
        second arrival."""
        with self._lock:
            return self._rate

    def publish_gauges(self) -> None:
        """Re-publish the admission gauges from current state — the
        exporter's scrape-time refresh, so a quiet service (no
        admission events since the last scrape) still reads current
        depth, rung, and rate from the one place that defines them."""
        with self._lock:
            n, rate = self._n, self._rate
        self._publish_gauges(n, rate)

    def _publish_gauges(self, n: int, rate: float) -> None:
        occ = n / self.capacity if self.capacity else 1.0
        tracing.set_gauges({
            "serving.admission.queue_depth": float(n),
            "serving.admission.shed_level": float(self._level_for(occ)),
            "serving.admission.arrival_rate_hz": rate,
        })

    # -- producer side ------------------------------------------------------

    def push(self, req: SearchRequest) -> None:
        """Admit or raise typed :class:`Overloaded` (backpressure)."""
        with self._lock:
            # arrival-rate EWMA ticks on every offered request —
            # rejected ones are load too
            if self._last_arrival is not None:
                gap = max(req.arrival - self._last_arrival, _MIN_GAP_S)
                sample = 1.0 / gap
                self._rate = (_EWMA_ALPHA * sample
                              + (1.0 - _EWMA_ALPHA) * self._rate
                              if self._rate else sample)
            self._last_arrival = req.arrival
            rate = self._rate
            shed = self.shed
            if (shed.background_priority is not None
                    and req.priority >= shed.background_priority
                    and (self._n / self.capacity if self.capacity
                         else 1.0) >= shed.background_reject_at):
                # background class (shadow queries, compaction) is the
                # ladder's first casualty — rejected while live
                # traffic still admits
                tracing.inc_counter(
                    "serving.admission.rejected_background")
                self._publish_gauges(self._n, rate)
                tracing.span_event(
                    "serving.rejected", req.arrival,
                    trace_ids=(req.trace_id,),
                    attrs={"reason": "background_shed",
                           "priority": req.priority})
                raise Overloaded(
                    "background-class request rejected at occupancy >= "
                    f"{shed.background_reject_at} (ladder sheds "
                    "background work first)")
            if self._n >= self.capacity:
                tracing.inc_counter("serving.admission.rejected")
                self._publish_gauges(self._n, rate)
                tracing.span_event(
                    "serving.rejected", req.arrival,
                    trace_ids=(req.trace_id,),
                    attrs={"reason": "queue_full",
                           "capacity": self.capacity})
                raise Overloaded(
                    f"admission queue full ({self.capacity} requests); "
                    "retry with backoff or raise capacity")
            self._groups.setdefault(req.compat_key, []).append(req)
            self._n += 1
            n = self._n
        tracing.inc_counter("serving.admission.accepted")
        self._publish_gauges(n, rate)

    # -- consumer (batcher) side --------------------------------------------

    def next_deadline_group(self, now: float):
        """(compat_key, oldest-arrival, rows, most-urgent order_key) of
        the most urgent group, or None when empty — the single-group
        view of :meth:`group_heads`, kept for callers that only need
        the head of the line."""
        heads = self.group_heads(now)
        if not heads:
            return None
        h = heads[0]
        return (h.key, h.arrival, h.rows, h.urgent)

    def group_heads(self, now: float) -> List[GroupHead]:
        """Every queued group's :class:`GroupHead`, most urgent first —
        the batcher's full scheduling view, so a dispatch-ready group
        is never invisible behind a more-urgent one still waiting out
        its timer, and the fairness budget can pick the most urgent
        *other* group. Cancelled/expired requests are pruned lazily
        here, completing expired ones with ``DeadlineExceeded``
        *before* dispatch."""
        from raft_tpu_torch.serving.request import DeadlineExceeded

        shed: List[SearchRequest] = []
        cancelled: List[SearchRequest] = []
        heads: List[GroupHead] = []
        with self._lock:
            for key, group in list(self._groups.items()):
                keep = []
                for r in group:
                    if r.handle.done():
                        # completed before dispatch: caller cancellation
                        # (or shutdown) won while the request was queued
                        tracing.inc_counter("serving.batcher.cancelled")
                        cancelled.append(r)
                        continue
                    if r.expired(now):
                        shed.append(r)
                        continue
                    keep.append(r)
                self._n -= len(group) - len(keep)
                if keep:
                    self._groups[key] = keep
                    heads.append(GroupHead(
                        key=key,
                        arrival=min(r.arrival for r in keep),
                        rows=sum(r.rows for r in keep),
                        urgent=min(r.order_key() for r in keep)))
                else:
                    del self._groups[key]
            n, rate = self._n, self._rate
        for r in cancelled:
            tracing.span_event("serving.cancelled", now,
                               trace_ids=(r.trace_id,),
                               attrs={"reason": "cancelled_in_queue"})
        for r in shed:
            if r.handle._set_exception(DeadlineExceeded(
                    f"deadline passed {now - r.deadline:.6f}s before "
                    "dispatch; shed from queue")):
                tracing.inc_counter("serving.batcher.shed_deadline")
                tracing.span_event(
                    "serving.shed", now, trace_ids=(r.trace_id,),
                    attrs={"reason": "deadline",
                           "late_s": now - r.deadline})
                if self._slo is not None:
                    self._slo.record(now, False)
        if shed or cancelled:
            self._publish_gauges(n, rate)
        heads.sort(key=lambda h: h.urgent)
        return heads

    def pop_group(self, key, max_rows: int,
                  now: float = 0.0) -> List[SearchRequest]:
        """Claim up to ``max_rows`` query rows from the group, most
        urgent first (EDF within priority). Requests whose handle is no
        longer pending (cancel won the race) are skipped; claimed
        handles transition to *running* atomically, so a later cancel
        returns False. ``now`` only timestamps the cancellation
        markers in the span recorder."""
        out: List[SearchRequest] = []
        cancelled: List[SearchRequest] = []
        with self._lock:
            group = self._groups.get(key, [])
            group.sort(key=SearchRequest.order_key)
            rest: List[SearchRequest] = []
            rows = 0
            for r in group:
                if out and rows + r.rows > max_rows:
                    rest.append(r)
                    continue
                if not r.handle._try_start():
                    self._n -= 1
                    tracing.inc_counter("serving.batcher.cancelled")
                    cancelled.append(r)
                    continue
                out.append(r)
                rows += r.rows
                self._n -= 1
            if rest:
                self._groups[key] = rest
            else:
                self._groups.pop(key, None)
            n, rate = self._n, self._rate
        for r in cancelled:
            tracing.span_event("serving.cancelled", now,
                               trace_ids=(r.trace_id,),
                               attrs={"reason": "cancelled_at_assembly"})
        self._publish_gauges(n, rate)
        return out

    def drain(self) -> List[SearchRequest]:
        """Remove and return every queued request (shutdown path)."""
        with self._lock:
            all_reqs = [r for g in self._groups.values() for r in g]
            self._groups.clear()
            self._n = 0
            rate = self._rate
        self._publish_gauges(0, rate)
        return all_reqs
