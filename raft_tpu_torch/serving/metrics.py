"""Serving-frontend metrics — the port of ``raft_tpu/serving/metrics.py``,
exported through :mod:`raft_tpu_torch.core.tracing`.

Per-stage latency **histograms** (log2 buckets, p50/p95/p99 estimates):

- ``serving.batcher.queue_wait_seconds``   — admission -> batch assembly
- ``serving.batcher.assembly_seconds``     — group pop + block concat
- ``serving.batcher.execute_seconds``      — device execute (waited on)
- ``serving.batcher.split_seconds``        — result re-split + handle set
- ``serving.batcher.e2e_seconds``          — admission -> handle complete
- ``serving.batcher.execute_seconds.p<NP>`` — per-params-class execute
  latency (:func:`params_class`, at most :data:`EXECUTE_CLASS_CAP`)

**Counters**: ``serving.admission.accepted`` / ``.rejected`` /
``.rejected_background``; ``serving.batcher.requests`` / ``.rows`` /
``.batches`` / ``.shed_deadline`` / ``.cancelled`` / ``.shutdown_shed``
/ ``.failed_batches`` / ``.shed_degraded_params``; the executor's
``serving.execute.calls`` / ``.rows`` / ``.padded_rows`` (and, per
ragged params class and tile, ``.rows.p<NP>.t<T>`` /
``.padded_rows.p<NP>.t<T>``),
``serving.compile_count`` (plan entries built: CUDA-graph captures on
the card), ``serving.capture_seconds``, ``serving.cache_hits`` /
``.cache_misses`` / ``.evictions``, ``serving.warmup_seconds``.

**Gauges**: ``serving.admission.queue_depth`` / ``.shed_level`` /
``.arrival_rate_hz``; ``serving.batcher.effective_max_wait_s`` and
``.group_starvation_s``; ``serving.executor.cached_executables`` and the
per-entry ``serving.executable.<digest>.{pool_bytes,launches,
capture_seconds}``; the SLO window's ``serving.slo.burn_rate`` /
``.window_total`` / ``.window_missed`` (labeled per window under the
multiwindow alert, with ``serving.slo.alert``).

**SLO surface** (batcher clock domain): ``serving.slo.attained`` /
``.missed``: every deadline-carrying request that reaches ``submit()``
lands as exactly one of the two (an on-time result is attained; a late
completion, an expiry shed, an admission reject or a failed batch is a
miss; the shutdown drain and a cancellation that wins before dispatch
are exempt).

Batch **occupancy** is derived from one counters read
(:func:`occupancy`), as are the executor's cache hit-rate and the
pad-waste fraction, overall and per ragged (class, tile)
(:func:`derived`).

The executor's modeled work (``serving.execute.modeled_flops`` /
``.modeled_bytes``: each entry's flops and bytes from the port's own cost
model, :mod:`raft_tpu_torch.core.executor`) over the measured execute
seconds gives ``achieved_gbps`` / ``achieved_gflops``; the same over the
device seconds a profiler capture attributed
(:mod:`raft_tpu_torch.core.profiling`: ``serving.attribution.*``) gives
``device_achieved_gbps`` / ``gflops``, and the continuous scheduler's
rolling attribution the ``rolling_*`` fields (:func:`derived`).
"""

from __future__ import annotations

import collections
import dataclasses
import re
import threading
from typing import Optional

from raft_tpu_torch.core import profiling, tracing

PREFIX = "serving.batcher."

QUEUE_WAIT = PREFIX + "queue_wait_seconds"
ASSEMBLY = PREFIX + "assembly_seconds"
EXECUTE = PREFIX + "execute_seconds"
SPLIT = PREFIX + "split_seconds"
E2E = PREFIX + "e2e_seconds"

SLO_ATTAINED = "serving.slo.attained"
SLO_MISSED = "serving.slo.missed"
SLO_BURN_RATE = "serving.slo.burn_rate"
SLO_ALERT = "serving.slo.alert"


@dataclasses.dataclass(frozen=True)
class SloConfig:
    """Deadline-SLO definition for the burn-rate window.

    ``target`` is the attainment objective (0.999 = "99.9% of
    deadline-carrying requests complete on time"); its complement is
    the error budget the burn rate is normalized by. ``window_s`` is
    the sliding window (batcher clock domain) the rate is computed
    over — short windows catch fast burns, long windows catch slow
    leaks; run one exporter-side recording per deployment and let the
    alerting layer combine windows."""

    window_s: float = 60.0
    target: float = 0.999


class SloWindow:
    """Deadline-attainment accounting in the batcher clock's domain.

    :meth:`record` counts one deadline-carrying request's outcome into
    the monotone ``serving.slo.{attained,missed}`` counters AND a
    sliding window of (timestamp, attained) events; the **burn rate**
    — window miss fraction ÷ error budget, the standard SRE
    multiwindow-alerting quantity — publishes as the
    ``serving.slo.burn_rate`` gauge. Everything is keyed to caller
    timestamps (``clock.now()`` / the batcher's stage times), so the
    window never reads a wall clock and the manual-clock tests pin it
    exactly. Thread-safe: one lock, O(events-in-window) memory; the
    miss count is maintained incrementally on append/prune, so every
    operation is O(events-pruned), not O(window) — record() sits on
    the per-request completion path.

    ``label`` suffixes the published gauge names
    (``serving.slo.burn_rate.<label>``) so several windows over the
    same outcome stream — the multiburn alert's 5 m + 1 h pair —
    publish side by side; unlabeled keeps the original flat names.
    ``prefix`` relocates the whole gauge family (default
    ``serving.slo.`` — the fleet aggregator's federated windows
    publish under ``fleet.slo.`` so a replica-local and a fleet-wide
    burn rate can coexist in one registry)."""

    def __init__(self, config: Optional[SloConfig] = None, *,
                 label: Optional[str] = None,
                 prefix: str = "serving.slo."):
        self.config = config or SloConfig()
        self.label = label
        self.prefix = prefix
        self._suffix = f".{label}" if label else ""
        self._lock = threading.Lock()
        # events are (timestamp, attained, n): n > 1 carries a BATCH
        # of same-outcome outcomes in one entry — the federation path
        # folds per-merge deltas of fleet counter sums, and appending
        # thousands of unit events per merge would make the window
        # O(fleet traffic) instead of O(merges)
        self._events: "collections.deque" = collections.deque()  # guarded-by: _lock
        self._total = 0   # guarded-by: _lock
        self._missed = 0  # guarded-by: _lock

    def _prune_locked(self, now: float) -> None:
        horizon = now - self.config.window_s
        while self._events and self._events[0][0] <= horizon:
            _, ok, n = self._events.popleft()
            self._total -= n
            if not ok:
                self._missed -= n

    def _counts(self, now: float):
        with self._lock:
            self._prune_locked(now)
            return self._total, self._missed

    def _append(self, now: float, attained: bool, n: int = 1) -> None:
        """Window bookkeeping only — no counter bump, no publish. The
        multiburn alert fans one outcome into several windows and must
        bump the process-wide attained/missed counters exactly once."""
        if n <= 0:
            return
        with self._lock:
            self._events.append((now, attained, n))
            self._total += n
            if not attained:
                self._missed += n

    def record_batch(self, now: float, attained_n: int,
                     missed_n: int) -> None:
        """Fold a BATCH of outcomes into the window WITHOUT bumping
        the process-wide attained/missed counters — the federation
        path: the outcomes already counted in their replica processes,
        and the aggregator only needs them windowed. Publishes."""
        self._append(now, True, int(attained_n))
        self._append(now, False, int(missed_n))
        self.publish(now)

    def record(self, now: float, attained: bool) -> None:
        """Count one outcome at clock time ``now`` and re-publish."""
        tracing.inc_counter(SLO_ATTAINED if attained else SLO_MISSED)
        self._append(now, attained)
        self.publish(now)

    def burn_rate(self, now: float) -> float:
        """Window miss fraction over the error budget at ``now`` (0.0
        for an empty window — no traffic burns no budget)."""
        total, missed = self._counts(now)
        if total == 0:
            return 0.0
        budget = max(1.0 - self.config.target, 1e-9)
        return (missed / total) / budget

    def publish(self, now: float) -> None:
        """Re-publish the window gauges as of ``now`` — called on every
        record and by the exporter's scrape-time refresh, so a quiet
        service's burn rate decays as its misses age out of the
        window."""
        total, missed = self._counts(now)
        budget = max(1.0 - self.config.target, 1e-9)
        tracing.set_gauges({
            self.prefix + "burn_rate" + self._suffix:
                (missed / total) / budget if total else 0.0,
            self.prefix + "window_total" + self._suffix: float(total),
            self.prefix + "window_missed" + self._suffix: float(missed),
        })


@dataclasses.dataclass(frozen=True)
class MultiBurnConfig:
    """Multiwindow burn-rate alert policy (the SRE multiburn pattern):
    a short window catches fast burns, a long window confirms they are
    sustained, and the alert fires only when BOTH burn past
    ``alert_burn`` — a short spike that the long window absorbs, or a
    slow leak the short window has already recovered from, pages
    nobody. Defaults pair 5 m + 1 h at burn 1.0 (consuming error
    budget exactly as provisioned)."""

    short: SloConfig = SloConfig(window_s=300.0)
    long: SloConfig = SloConfig(window_s=3600.0)
    short_label: str = "5m"
    long_label: str = "1h"
    alert_burn: float = 1.0


class MultiBurnAlert:
    """Paired :class:`SloWindow` recorder + the ``serving.slo.alert``
    gauge. Batcher-facing duck type of a single ``SloWindow``
    (``record(now, attained)`` / ``publish(now)``), so
    ``BatcherConfig.multiburn`` swaps it in without touching any
    completion path; each outcome bumps the process-wide
    attained/missed counters exactly once and lands in both windows.
    All timestamps are caller-clock-domain — the ManualClock tests pin
    window arithmetic and the alert transition exactly."""

    def __init__(self, config: Optional[MultiBurnConfig] = None, *,
                 prefix: str = "serving.slo."):
        self.config = config or MultiBurnConfig()
        self.prefix = prefix
        self.windows = (
            SloWindow(self.config.short, label=self.config.short_label,
                      prefix=prefix),
            SloWindow(self.config.long, label=self.config.long_label,
                      prefix=prefix),
        )

    def record(self, now: float, attained: bool) -> None:
        """One outcome → both windows; counters bumped once."""
        tracing.inc_counter(SLO_ATTAINED if attained else SLO_MISSED)
        for w in self.windows:
            w._append(now, attained)
        self.publish(now)

    def record_batch(self, now: float, attained_n: int,
                     missed_n: int) -> None:
        """Batched outcomes → both windows, NO process-counter bumps
        — the federation path (see :meth:`SloWindow.record_batch`):
        the fleet aggregator folds per-merge deltas of the summed
        replica attained/missed counters, whose unit outcomes were
        already counted where they happened."""
        for w in self.windows:
            w._append(now, True, int(attained_n))
            w._append(now, False, int(missed_n))
        self.publish(now)

    def burn_rates(self, now: float) -> tuple:
        return tuple(w.burn_rate(now) for w in self.windows)

    def alert(self, now: float) -> bool:
        """True iff EVERY window burns at/above the policy threshold."""
        return all(r >= self.config.alert_burn
                   for r in self.burn_rates(now))

    def publish(self, now: float) -> None:
        """Re-publish each window's labeled gauges plus the combined
        ``serving.slo.alert`` (1.0 firing / 0.0 quiet) — scrape-time
        refresh decays both windows and may clear the alert."""
        for w in self.windows:
            w.publish(now)
        tracing.set_gauge(self.prefix + "alert",
                          1.0 if self.alert(now) else 0.0)


def observe_stage(name: str, seconds: float) -> None:
    """Record one stage latency into its histogram."""
    tracing.observe(name, seconds)


def params_class(params) -> Optional[str]:
    """The latency label of a request's search params — ``p<NP>`` for
    params carrying ``n_probes``, the spelling of the JAX package's
    params-sweep recall gauges (``index.recall.sweep.p<NP>``). None for
    params with no
    ``n_probes`` knob (brute force, CAGRA) — those observe only the
    unlabeled family."""
    n_probes = getattr(params, "n_probes", None)
    if n_probes is None:
        return None
    return f"p{int(n_probes)}"


# label-cardinality bound for the per-params-class histograms:
# n_probes is client-supplied, and histograms are process-lifetime —
# without a cap, a client sweeping arbitrary values (an autotuner)
# would grow the registry without bound. 32 distinct classes covers any realistic sweep; overflow is counted,
# not silent.
EXECUTE_CLASS_CAP = 32
_execute_classes: set = set()  # guarded-by: _execute_classes_lock
_execute_classes_lock = threading.Lock()


def observe_execute_class(label: str, seconds: float) -> None:
    """Record one dispatch's execute latency into the per-params-class
    histogram (``serving.batcher.execute_seconds.<label>`` — rendered
    by the exporter as the labeled
    ``serving_batcher_execute_seconds{params_class="<label>"}``
    Prometheus family next to the unlabeled aggregate). At most
    :data:`EXECUTE_CLASS_CAP` distinct labels materialize per process;
    past the cap a new label's observation lands only in the unlabeled
    aggregate and bumps ``serving.batcher.execute_class_dropped``."""
    with _execute_classes_lock:
        if label not in _execute_classes:
            if len(_execute_classes) >= EXECUTE_CLASS_CAP:
                tracing.inc_counter(PREFIX + "execute_class_dropped")
                return
            _execute_classes.add(label)
    tracing.observe(f"{EXECUTE}.{label}", seconds)


def batch_dispatched(n_requests: int, n_rows: int) -> None:
    """Count one dispatched micro-batch."""
    tracing.inc_counter(PREFIX + "batches")
    tracing.inc_counter(PREFIX + "requests", n_requests)
    tracing.inc_counter(PREFIX + "rows", n_rows)


def occupancy() -> dict:
    """Derived batch-occupancy stats: mean requests and rows per
    dispatched micro-batch (1.0 requests/batch == no coalescing)."""
    batches = tracing.get_counter(PREFIX + "batches")
    if batches == 0:
        return {"batches": 0, "requests_per_batch": 0.0,
                "rows_per_batch": 0.0}
    return {
        "batches": int(batches),
        "requests_per_batch":
            tracing.get_counter(PREFIX + "requests") / batches,
        "rows_per_batch": tracing.get_counter(PREFIX + "rows") / batches,
    }


def derived() -> dict:
    """Metrics computed from one counters read: the executor's cache
    hit-rate, the measured execute seconds, the pad-waste fraction (the
    share of dispatched row capacity that was bucket or tile pad), the
    same per ragged params class and tile (``pad_waste_by_class``:
    ``{"p<NP>.t<T>": fraction}``, which says whether a small tile earns
    its entry at the observed load), the seconds spent capturing CUDA
    graphs, the modeled work and its achieved rates over the execute
    seconds, and the device-measured and rolling counterparts
    (the JAX package's names, ``metrics.py:446``)."""
    hits = tracing.get_counter("serving.cache_hits")
    misses = tracing.get_counter("serving.cache_misses")
    exec_s = tracing.get_histogram(EXECUTE).snapshot()["sum"]
    rows = tracing.get_counter("serving.execute.rows")
    padded = tracing.get_counter("serving.execute.padded_rows")
    by_class = {}
    base = "serving.execute.padded_rows."
    for name, pad in tracing.counters(base).items():
        label = name[len(base):]
        if pad:
            by_class[label] = 1.0 - tracing.get_counter(
                "serving.execute.rows." + label) / pad
    out = {
        "cache_hit_rate": hits / (hits + misses) if hits + misses else 0.0,
        "execute_seconds_total": exec_s,
        "pad_waste_fraction": 1.0 - rows / padded if padded else 0.0,
        "pad_waste_by_class": by_class,
        "capture_seconds_total":
            tracing.get_counter("serving.capture_seconds"),
        "modeled_bytes_total":
            tracing.get_counter("serving.execute.modeled_bytes"),
        "modeled_flops_total":
            tracing.get_counter("serving.execute.modeled_flops"),
    }
    out["achieved_gbps"] = (
        out["modeled_bytes_total"] / exec_s / 1e9 if exec_s > 0 else 0.0)
    out["achieved_gflops"] = (
        out["modeled_flops_total"] / exec_s / 1e9 if exec_s > 0 else 0.0)
    att_s = tracing.get_counter(profiling.ATTRIBUTED_SECONDS)
    out["measured_device_seconds_total"] = att_s
    out["device_achieved_gbps"] = (
        tracing.get_counter(profiling.ATTRIBUTED_BYTES) / att_s / 1e9
        if att_s > 0 else 0.0)
    out["device_achieved_gflops"] = (
        tracing.get_counter(profiling.ATTRIBUTED_FLOPS) / att_s / 1e9
        if att_s > 0 else 0.0)
    rp = profiling.ROLLING_PREFIX
    out["rolling_windows"] = tracing.get_gauge(rp + "windows")
    out["rolling_device_seconds"] = tracing.get_gauge(
        rp + "device_seconds")
    out["rolling_gbps"] = tracing.get_gauge(rp + "gbps")
    out["rolling_gflops"] = tracing.get_gauge(rp + "gflops")
    # each entry's measured view, from the attribution's gauges
    measured: dict = {}
    pat = re.compile(
        r"^serving\.executable\.([0-9a-f]+)\.measured_([a-z_]+)$")
    for name, v in tracing.gauges("serving.executable.").items():
        m = pat.match(name)
        if m:
            measured.setdefault(m.group(1), {})[m.group(2)] = v
    out["measured_executables"] = measured
    return out


def snapshot() -> dict:
    """One scrape of the whole serving surface: counters + gauges +
    per-stage histogram summaries + derived occupancy and achieved
    bandwidth (the bench rider's, the exporter's, and any monitoring
    agent's single entry point)."""
    return {
        "counters": tracing.counters("serving."),
        "gauges": tracing.gauges("serving."),
        "histograms": tracing.histograms(PREFIX),
        "occupancy": occupancy(),
        "derived": derived(),
    }


def reset() -> None:
    """Zero every serving, index and memory counter and gauge, the
    serving histograms and the span ring (test isolation; counters fold
    into the lifetime ledger)."""
    tracing.reset_counters("serving.")
    tracing.reset_gauges("serving.")
    tracing.reset_counters("index.")
    tracing.reset_gauges("index.")
    tracing.reset_counters("memory.")
    tracing.reset_gauges("memory.")
    tracing.reset_histograms(PREFIX)
    # the class-label cap tracks the histograms it guards
    with _execute_classes_lock:
        _execute_classes.clear()
    tracing.reset_spans()
