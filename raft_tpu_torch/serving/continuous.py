"""Continuous attribution (the port of ``raft_tpu/serving/continuous.py``)
— the steady-state half
of the observability plane.

graftflight made device-measured attribution real, but only at
incident time: between SLO pages the freshest device evidence in the
process is whatever the LAST incident captured, and the TPU-KNN
roofline methodology (PAPERS.md) only pays off when achieved GB/s is
observed continuously against the compiled-in byte accounting — not
reconstructed after a page. :class:`ContinuousCapture` closes that
gap: a low-duty-cycle scheduler takes periodic short (~100 ms)
``torch.profiler`` captures under a configurable duty-cycle budget
(default ≤ 1% of wall time on the profiler), attributes each window
against the executor's cost table
(:func:`raft_tpu_torch.core.profiling.attribute`), publishes it (measured
supersedes modeled, exactly as an incident would), and folds it into
the :class:`~raft_tpu_torch.core.profiling.RollingAttribution` EWMA state —
so ``serving.attribution.rolling.*`` and ``metrics.derived()`` carry
a continuously-fresh measured number next to the wall-clock one.

Lock discipline (shared with graftflight): only one profiler capture
may run process-wide, and the continuous tick is the LOWEST-priority
customer — an operator's ``/profile`` capture or an incident capture
holding the exporter's profile lock makes the tick DEFER (counted in
``continuous.deferred``, the period stamp untouched, so the very next
tick retries) rather than queue behind it. Elapsed periods never
stack: however long the scheduler was deferred or simply not ticked,
at most ONE capture runs when it next fires.

Accounting contract (ManualClock-pinned):

- ``continuous.ticks`` — every evaluation.
- ``continuous.captures`` — windows actually captured + folded.
- ``continuous.deferred`` — ticks that yielded to a busier capture.
- ``continuous.skipped`` — due ticks the cumulative duty-cycle budget
  refused (capture seconds spent would exceed ``duty_cycle_budget``
  of elapsed time) — the budget is a hard ceiling, not advisory.
- ``continuous.empty`` / ``continuous.errors`` — captures that wrote
  no attributable window / raised (both still charge the budget: the
  profiler time was spent).

Clock discipline (graftlint R7): every timestamp comes from the
injected clock; the capture itself sleeps wall-clock via
:func:`raft_tpu_torch.serving.flight.timed_capture` (a duration, not a
clock read — the documented exemption).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional

from raft_tpu_torch.core import profiling, tracing
from raft_tpu_torch.serving.batcher import MonotonicClock
from raft_tpu_torch.serving.flight import timed_capture

TICKS = "continuous.ticks"
CAPTURES = "continuous.captures"
DEFERRED = "continuous.deferred"
SKIPPED = "continuous.skipped"
EMPTY = "continuous.empty"
ERRORS = "continuous.errors"

GAUGE_PREFIX = "serving.continuous."


@dataclasses.dataclass(frozen=True)
class ContinuousConfig:
    """Tuning knobs for :class:`ContinuousCapture`.

    ``period_s`` is the capture cadence; ``capture_seconds`` the
    window length — deliberately short (~100 ms holds several
    dispatches under load, which is what the per-dispatch invocation
    windows make usable). ``duty_cycle_budget`` caps the fraction of
    wall time spent inside the profiler (captured seconds over
    elapsed clock time, cumulative) — the default pairing (0.1 s
    every 15 s ≈ 0.67%) sits under the 1% ceiling, and a
    misconfigured period can only trigger budget SKIPS, never a
    budget breach. ``alpha`` is the rolling-attribution EWMA weight
    per window."""

    period_s: float = 15.0
    capture_seconds: float = 0.1
    duty_cycle_budget: float = 0.01
    alpha: float = 0.3


class ContinuousCapture:
    """Low-duty-cycle capture scheduler feeding the rolling
    attribution.

    ``executor`` contributes the cost table (and its ``hlo_module``
    correlation identities); ``clock`` defaults to the production
    monotonic clock (tests inject a ManualClock); ``profile_dir``
    arms the real ``torch.profiler`` capture; ``capture_fn`` overrides
    the capture entirely (tests — and the live round-trip test, which
    runs real traffic under a real capture inside it; it may return a
    trace source for :func:`raft_tpu_torch.core.profiling.load_ops` or
    None). The exporter's scrape refresh drives :meth:`tick`, so an
    armed service needs no extra thread — with the default 15 s
    scrape interval of a Prometheus deployment the cadence IS the
    scrape cadence; a sidecar loop can drive it instead.

    Example::

        cc = ContinuousCapture(executor=ex, profile_dir="/tmp/prof")
        exp = MetricsExporter(executor=ex, continuous=cc)
        # every scrape now keeps serving.attribution.rolling.* fresh
    """

    def __init__(self, executor=None, *,
                 config: Optional[ContinuousConfig] = None, clock=None,
                 profile_dir: Optional[str] = None,
                 capture_fn: Optional[Callable] = None,
                 rolling: Optional[profiling.RollingAttribution] = None):
        self.executor = executor
        self.config = config or ContinuousConfig()
        self._clock = clock if clock is not None else MonotonicClock()
        self.profile_dir = profile_dir
        self.capture_fn = capture_fn
        self.rolling = (rolling if rolling is not None
                        else profiling.RollingAttribution(
                            alpha=self.config.alpha))
        # wired by MetricsExporter(continuous=...): the shared
        # one-capture-at-a-time lock — /profile and incident captures
        # always win; a busy lock defers the tick
        self.profile_lock: Optional[threading.Lock] = None
        self._lock = threading.Lock()
        self._armed_at: Optional[float] = None  # guarded-by: _lock
        self._last: Optional[float] = None      # guarded-by: _lock
        self._captured_s = 0.0                  # guarded-by: _lock

    def _budget_ok_locked(self, now: float) -> bool:
        """Is the cumulative profiler time ALREADY spent within
        ``duty_cycle_budget`` of elapsed time? Retrospective
        accounting: the first capture is always admissible (nothing
        spent yet — a scheduler that can never start collects no
        evidence), each subsequent one only once the spent fraction
        has amortized back under budget, so a misconfigured period
        degrades to the budget's own cadence
        (``capture_seconds / budget``) instead of breaching it."""
        budget = self.config.duty_cycle_budget
        if budget <= 0:
            return False
        elapsed = max(now - (self._armed_at if self._armed_at
                             is not None else now), 0.0)
        # the epsilon keeps exact-boundary cadences (period equal to
        # capture_seconds / budget) deterministic across float noise
        return self._captured_s <= budget * elapsed + 1e-9

    def duty_cycle(self, now: Optional[float] = None) -> float:
        """Measured fraction of elapsed clock time spent capturing."""
        if now is None:
            now = self._clock.now()
        with self._lock:
            if self._armed_at is None or now <= self._armed_at:
                return 0.0
            return self._captured_s / (now - self._armed_at)

    def _capture(self):
        if self.capture_fn is not None:
            return self.capture_fn()
        if self.profile_dir is None:
            return None
        return timed_capture(self.profile_dir,
                             self.config.capture_seconds)

    def tick(self, now: Optional[float] = None) -> Optional[dict]:
        """Evaluate the schedule at clock time ``now``; when a capture
        is due, within budget, and the profiler is free: capture →
        attribute → publish → fold. Returns the rolling snapshot for
        a captured-and-folded window, else None (not due / budget
        skip / deferred / empty window — each counted)."""
        if now is None:
            now = self._clock.now()
        with self._lock:
            tracing.inc_counter(TICKS)
            if self._armed_at is None:
                self._armed_at = now
            due = (self._last is None
                   or now - self._last >= self.config.period_s)
            if not due:
                return None
            if not self._budget_ok_locked(now):
                tracing.inc_counter(SKIPPED)
                return None
            if (self.profile_lock is not None
                    and not self.profile_lock.acquire(blocking=False)):
                # an operator/incident capture owns the profiler:
                # defer WITHOUT advancing the period stamp — the next
                # tick retries immediately; elapsed periods never
                # stack into more than one capture
                tracing.inc_counter(DEFERRED)
                return None
            # advance the stamp BEFORE the capture so a concurrent
            # scrape's tick sees the cadence taken, however many
            # periods elapsed while quiet (never stacked)
            self._last = now
            self._captured_s += self.config.capture_seconds
        snap = None
        err = None
        try:
            source = self._capture()
            if source is not None and self.executor is not None \
                    and hasattr(self.executor, "executable_costs"):
                attr = profiling.attribute(
                    source, self.executor.executable_costs())
                if attr.modules:
                    # measured supersedes modeled, continuously: the
                    # same publication an incident performs, then the
                    # EWMA fold that makes it rolling
                    profiling.publish(attr)
                    snap = self.rolling.fold(attr)
        except Exception as e:  # noqa: BLE001 — a failed capture must
            # not take the scrape (or a sidecar loop) down; the budget
            # charge stands — the profiler time was spent
            err = e
        finally:
            if self.profile_lock is not None:
                self.profile_lock.release()
        if err is not None:
            tracing.inc_counter(ERRORS)
            return None
        if snap is None:
            tracing.inc_counter(EMPTY)
            return None
        tracing.inc_counter(CAPTURES)
        tracing.set_gauges({
            GAUGE_PREFIX + "duty_cycle": self.duty_cycle(now),
            GAUGE_PREFIX + "last_capture": now,
            GAUGE_PREFIX + "windows": float(snap["windows"]),
        })
        return snap
