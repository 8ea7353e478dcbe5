"""Incident capture — the flight recorder that fires itself; the port
of ``raft_tpu/serving/flight.py``.

graftscope gave the serving plane a span ring, SLO burn-rate windows,
and a gated ``/profile`` capture — but an operator had to be watching
at the moment of an incident to use any of it: by the time a page
fires, the interesting spans have aged out of the ring and the device
behavior that caused the miss is gone. :class:`FlightRecorder` closes
that gap: the :class:`~raft_tpu_torch.serving.metrics.MultiBurnAlert`
and a windowed latency-anomaly check ARM a short, rate-limited
automatic profiler capture, and the result — the parsed device-truth
attribution (:mod:`raft_tpu_torch.core.profiling`), a span-ring snapshot,
the metrics snapshot, the executable cost table, and the live shed
rung — lands as an on-disk **incident bundle** and is retrievable at
the exporter's ``/incident.json`` endpoint (404 while none exists).

Triggers (evaluated by :meth:`FlightRecorder.check`, which the
exporter's scrape refresh drives):

- **multiburn_alert** — the ``serving.slo.alert`` gauge is firing
  (both burn-rate windows over budget — the SRE page condition).
- **latency_anomaly** — the e2e latency histogram's p99 over the
  window SINCE THE LAST CHECK exceeds the configured threshold (delta
  of the cumulative bucket counts, so a long-healthy service's history
  cannot mask a fresh stall, and the check is a pure function of the
  histogram snapshots — ManualClock tests pin it exactly).
- **low_headroom** (graftledger) — an attached
  :class:`~raft_tpu_torch.core.memwatch.MemoryLedger` reports device
  headroom at/below ``FlightConfig.low_headroom_bytes``: the replica
  is drifting toward an OOM, and the incident evidence worth having
  is the one from BEFORE the crash. The bundle then also carries the
  full memory snapshot (model, live stats, forecast, divergence).

Rate limiting: at most one bundle per ``cooldown_s`` (clock domain —
the batcher's injectable clock, so the manual-clock tests pin the
window exactly); suppressed triggers count into
``incident.suppressed``. Clock discipline (graftlint R7): every
timestamp comes from the injected clock; the only wall-time touch is
the capture's ``time.sleep`` (a duration, not a clock read — same
exemption as ``/profile``).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading
import time
from typing import Callable, List, Optional

from raft_tpu_torch.core import profiling, tracing
from raft_tpu_torch.serving import metrics as serving_metrics
from raft_tpu_torch.serving.batcher import MonotonicClock

# lifetime counters (ci/bench_compare.py snapshot floors): bundles
# actually produced, and triggers the cooldown swallowed
INCIDENT_BUNDLES = "incident.bundles"
INCIDENT_SUPPRESSED = "incident.suppressed"


def timed_capture(profile_dir: str, seconds: float) -> Optional[str]:
    """One short ``torch.profiler`` capture into ``profile_dir``;
    returns the trace file THIS capture produced, or None when it
    wrote none (before/after mtime diff — falling back to "newest in
    the dir" would republish a previous capture's device timings as
    current evidence). Shared by the flight recorder's incident
    capture and the continuous low-duty-cycle scheduler
    (:mod:`raft_tpu_torch.serving.continuous`); callers own the one-capture-
    at-a-time lock discipline. ``time.sleep`` is a duration, not a
    clock read — the R7 exemption ``/profile`` documents."""
    before = profiling.trace_snapshot(profile_dir)
    with tracing.capture(profile_dir):
        time.sleep(seconds)
    return profiling.fresh_trace_file(profile_dir, before)


def window_quantile(bounds, cum_window, q: float) -> float:
    """Quantile estimate over a WINDOW histogram given as cumulative
    per-bucket counts (the delta of two
    :meth:`~raft_tpu_torch.core.tracing.Histogram.snapshot` cumulative
    vectors is itself cumulative) — the same linear-in-bucket
    interpolation the live histograms use, as a pure function so the
    anomaly check is pinned by scripted observations. ``bounds`` has
    one entry fewer than ``cum_window`` (the last bucket is
    overflow, estimated inside ``(last, 2*last]``)."""
    total = cum_window[-1] if cum_window else 0
    if total <= 0:
        return 0.0
    target = q * total
    prev = 0
    for i, cum in enumerate(cum_window):
        c = cum - prev
        if cum >= target and c > 0:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = (bounds[i] if i < len(bounds) else bounds[-1] * 2.0)
            return lo + (hi - lo) * (target - prev) / c
        prev = cum
    return bounds[-1] * 2.0 if bounds else 0.0


@dataclasses.dataclass(frozen=True)
class LatencyAnomaly:
    """Latency-anomaly trigger policy: fire when the named histogram's
    p99 over the window since the last check reaches
    ``p99_threshold_s``, provided the window saw at least
    ``min_count`` observations (a single slow request in an idle
    window is noise, not an incident)."""

    histogram: str = serving_metrics.E2E
    p99_threshold_s: float = 1.0
    min_count: int = 8


@dataclasses.dataclass(frozen=True)
class FlightConfig:
    """Tuning knobs for :class:`FlightRecorder`.

    ``cooldown_s`` rate-limits bundle production (clock domain);
    ``capture_seconds`` is the automatic profiler capture's length —
    deliberately short: the device behavior that is missing deadlines
    RIGHT NOW is the evidence, not a leisurely profile. ``bundle_dir``
    persists bundles as ``incident_<n>.json`` (None keeps them
    in-memory only — ``/incident.json`` still serves the latest);
    ``max_bundles`` bounds the in-memory ring. ``latency`` configures
    the anomaly trigger (None disables it; the multiburn trigger is
    always live when the gauge exists). ``low_headroom_bytes`` arms
    the graftledger memory trigger: an attached
    :class:`~raft_tpu_torch.core.memwatch.MemoryLedger` reporting headroom
    at/below this many bytes is an incident (None keeps it off — and
    a ledger that cannot measure headroom, e.g. on CPU, never
    fires)."""

    cooldown_s: float = 300.0
    capture_seconds: float = 0.5
    bundle_dir: Optional[str] = None
    max_bundles: int = 16
    latency: Optional[LatencyAnomaly] = dataclasses.field(
        default_factory=LatencyAnomaly)
    low_headroom_bytes: Optional[float] = None


class FlightRecorder:
    """SLO-triggered incident capture over the live registries.

    ``executor``/``batcher`` contribute the cost table (and its
    ``hlo_module`` correlation identities) and the live shed rung;
    ``clock`` defaults to the batcher's injectable clock so every
    bundle timestamp and the cooldown window live in the serving
    clock domain. ``profile_dir`` arms the automatic ``torch.profiler``
    capture (None skips it — bundles then carry no attribution);
    ``capture_fn`` overrides the capture entirely (tests inject a
    fixture trace; it may return a trace file path, a parsed
    Chrome-trace dict, or None).

    Example::

        flight = FlightRecorder(executor=ex, batcher=b,
                                profile_dir="/var/tmp/prof",
                                config=FlightConfig(cooldown_s=60.0))
        exp = MetricsExporter(executor=ex, batcher=b, flight=flight)
        # every scrape now evaluates the triggers; incidents land at
        # /incident.json and under bundle_dir
    """

    def __init__(self, executor=None, batcher=None, *,
                 config: Optional[FlightConfig] = None, clock=None,
                 profile_dir: Optional[str] = None,
                 capture_fn: Optional[Callable] = None,
                 memory=None):
        self.executor = executor
        self.batcher = batcher
        # graftledger: a MemoryLedger arms the low_headroom
        # trigger and contributes the memory snapshot to every bundle
        self.memory = memory
        self.config = config or FlightConfig()
        if clock is None:
            clock = (batcher._clock if batcher is not None
                     else MonotonicClock())
        self._clock = clock
        self.profile_dir = profile_dir
        self.capture_fn = capture_fn
        # shared with the exporter's /profile endpoint when attached
        # (MetricsExporter wires its _profile_lock in): only one
        # profiler capture may run process-wide — torch.profiler raises
        # on a second start_trace, which would strip the incident of
        # its attribution exactly when an operator is already
        # investigating. A busy lock DEFERS the incident to the next
        # check instead of consuming the cooldown on a doomed capture.
        self.profile_lock: Optional[threading.Lock] = None
        self._lock = threading.Lock()
        self._bundles: "collections.deque" = collections.deque(  # guarded-by: _lock
            maxlen=max(int(self.config.max_bundles), 1))
        self._seq = 0  # guarded-by: _lock
        self._last_capture: Optional[float] = None  # guarded-by: _lock
        # latency-window baseline: primed at construction so the first
        # check's window starts HERE, not at process start (a service
        # attaching a recorder mid-life must not re-judge its history)
        self._last_cum: Optional[list] = None  # guarded-by: _lock
        if self.config.latency is not None:
            self._last_cum = tracing.get_histogram(
                self.config.latency.histogram).snapshot()["bucket_counts"]

    # -- triggers -----------------------------------------------------------

    def _latency_window(self) -> tuple:
        """(window p99, window count) since the last check — a delta
        of cumulative bucket counts, advancing the baseline. Called
        under the lock; advances on EVERY check (also rate-limited
        ones), so each observation is judged exactly once."""
        lat = self.config.latency
        snap = tracing.get_histogram(lat.histogram).snapshot()
        cum = snap["bucket_counts"]
        prev = self._last_cum
        self._last_cum = cum
        if prev is None or len(prev) != len(cum):
            prev = [0] * len(cum)
        window = [c - p for c, p in zip(cum, prev)]
        count = window[-1] if window else 0
        return window_quantile(snap["bucket_bounds"], window, 0.99), count

    def _triggers_locked(self) -> List[str]:
        reasons = []
        if tracing.get_gauge(serving_metrics.SLO_ALERT) >= 1.0:
            reasons.append("multiburn_alert")
        if self.config.latency is not None:
            p99, count = self._latency_window()
            if (count >= self.config.latency.min_count
                    and p99 >= self.config.latency.p99_threshold_s):
                reasons.append("latency_anomaly")
        if (self.memory is not None
                and self.config.low_headroom_bytes is not None):
            # a ledger that cannot measure headroom (None — no live
            # stats, no configured capacity) never fires: ignorance
            # is not an incident. The exporter's refresh publishes
            # the ledger right before this check runs — read that
            # snapshot instead of recomputing the same truth; only a
            # recorder driven with no publish at all (standalone
            # check() callers) pays the fresh read.
            snap = getattr(self.memory, "last_snapshot", None)
            room = (snap["headroom_bytes"] if snap is not None
                    else self.memory.headroom_bytes())
            if room is not None and \
                    room <= self.config.low_headroom_bytes:
                reasons.append("low_headroom")
        return reasons

    # -- capture ------------------------------------------------------------

    def _capture(self):
        """One short profiler capture; returns a trace source
        (:func:`raft_tpu_torch.core.profiling.load_trace` input) or None.
        Only a file THIS capture produced is returned (before/after
        diff of the capture dir) — falling back to "newest in the
        dir" would republish a previous incident's device timings as
        current evidence when the fresh capture writes no chrome
        trace. ``time.sleep`` is a duration, not a clock read — the
        same R7 exemption the ``/profile`` endpoint documents."""
        if self.capture_fn is not None:
            return self.capture_fn()
        if self.profile_dir is None:
            return None
        return timed_capture(self.profile_dir,
                             self.config.capture_seconds)

    def _build_bundle(self, now: float, reasons: List[str],
                      seq: int) -> dict:
        attribution = None
        trace_file = None
        error = None
        try:
            source = self._capture()
            if source is not None and self.executor is not None \
                    and hasattr(self.executor, "executable_costs"):
                attr = profiling.attribute(
                    source, self.executor.executable_costs())
                # measured supersedes modeled at the moment it matters:
                # the incident's spans/gauges re-emit device truth
                profiling.publish(attr)
                attribution = attr.to_dict()
                trace_file = attr.trace_file
            elif isinstance(source, (str, os.PathLike)):
                trace_file = os.fspath(source)
        except Exception as e:  # noqa: BLE001 — a failed capture must not
            # fail the incident: a bundle without attribution still
            # carries the span ring and metrics the post-mortem needs
            error = f"{type(e).__name__}: {e}"
        rec = tracing.span_recorder()
        bundle = {
            "incident": seq,
            "time": now,
            "triggers": list(reasons),
            "slo": tracing.gauges("serving.slo."),
            "metrics": serving_metrics.snapshot(),
            "spans": rec.to_chrome_trace(),
            "span_ring": {"recorded": len(rec), "dropped": rec.dropped,
                          "capacity": rec.capacity},
            "attribution": attribution,
            "trace_file": trace_file,
        }
        if error is not None:
            bundle["capture_error"] = error
        if self.executor is not None and hasattr(self.executor,
                                                 "executable_costs"):
            bundle["executables"] = self.executor.executable_costs()
        if self.memory is not None:
            # the graftledger snapshot at the moment of the incident:
            # for a low_headroom trigger this IS the evidence; for
            # any other trigger it rules memory pressure in or out
            bundle["memory"] = self.memory.snapshot()
        if self.batcher is not None:
            q = self.batcher._queue
            bundle["shed_level"] = q.shed_level()
            bundle["queue_depth"] = len(q)
        return bundle

    def _persist(self, bundle: dict) -> Optional[str]:
        if self.config.bundle_dir is None:
            return None
        os.makedirs(self.config.bundle_dir, exist_ok=True)
        path = os.path.join(self.config.bundle_dir,
                            f"incident_{bundle['incident']:04d}.json")
        with open(path, "w") as f:
            json.dump(bundle, f, indent=2, sort_keys=True, default=str)
            f.write("\n")
        return path

    # -- public API ---------------------------------------------------------

    def check(self, now: Optional[float] = None) -> Optional[dict]:
        """Evaluate the triggers at clock time ``now`` and, when one
        fires outside the cooldown, capture → attribute → bundle.
        Returns the new bundle, or None (quiet, or rate-limited — the
        latter counted in ``incident.suppressed``). The exporter's
        scrape refresh calls this, so an armed service needs no extra
        thread; it can also be driven directly (tests, a sidecar
        loop)."""
        if now is None:
            now = self._clock.now()
        with self._lock:
            reasons = self._triggers_locked()
            if not reasons:
                return None
            for r in reasons:
                tracing.inc_counter(f"incident.trigger.{r}")
            if (self._last_capture is not None
                    and now - self._last_capture < self.config.cooldown_s):
                tracing.inc_counter(INCIDENT_SUPPRESSED)
                return None
            if (self.profile_lock is not None
                    and not self.profile_lock.acquire(blocking=False)):
                # an operator's /profile capture owns the profiler:
                # DEFER (cooldown untouched) rather than burn the one
                # rate-limited incident on a capture that cannot run
                tracing.inc_counter("incident.deferred")
                return None
            self._last_capture = now
            self._seq += 1
            seq = self._seq
        # the capture itself runs OUTSIDE the lock: it sleeps
        # capture_seconds, and a concurrent scrape's check() must see
        # the advanced cooldown stamp instead of blocking behind it
        # (the held profile_lock meanwhile 409s /profile — the same
        # one-capture-at-a-time contract, both directions)
        try:
            bundle = self._build_bundle(now, reasons, seq)
        finally:
            if self.profile_lock is not None:
                self.profile_lock.release()
        path = self._persist(bundle)
        if path is not None:
            bundle["bundle_path"] = path
        with self._lock:
            self._bundles.append(bundle)
            n = len(self._bundles)
        tracing.inc_counter(INCIDENT_BUNDLES)
        tracing.set_gauges({"incident.count": float(n),
                            "incident.last_time": now})
        return bundle

    def latest(self) -> Optional[dict]:
        """The most recent incident bundle (``/incident.json``'s body),
        or None when nothing has fired."""
        with self._lock:
            return self._bundles[-1] if self._bundles else None

    def bundles(self) -> List[dict]:
        """All retained bundles, oldest first."""
        with self._lock:
            return list(self._bundles)
