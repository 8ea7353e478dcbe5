"""Profiling ranges (``common::nvtx::range``) and the process-wide
metrics registry: counters, gauges, histograms and request spans.

The span names are the JAX package's (``raft_tpu.ivf_flat.search``, ...),
so a ``torch.profiler`` trace of the port lines up with a trace of the
reference. Counters, gauges, histograms and spans keep the JAX package's
names and semantics (``raft_tpu/core/tracing.py``): counters only grow
(the tiered swap counts ``tier.swaps``, ``tier.swap_bytes``,
``tier.promote_cold_bytes``; the tiered scan's staging counts
``tier.cold_bytes_staged``, ``tier.cold_lists_staged`` and
``tier.stage_waves``, the port's own; the capacity gate
``memory.gate.*``; the executor and the serving frontend ``serving.*``),
and a reset folds them into the process-lifetime ledger
(:func:`lifetime_counters`); gauges hold the last value set; histograms
are log2-bucketed latency distributions; spans are host-side stage
timings with trace ids in a bounded ring (:class:`SpanRecorder`), with
a Chrome trace-event export. The mesh helpers (``poll_shard_timings``,
``record_mesh_spans``, ``straggler_stats``), the index-health statistics
and the drift divergence (``index_health``, ``probe_freq_stats``,
``js_divergence``) are pure reductions. :func:`capture` is a
``torch.profiler`` session that writes a Chrome trace.

Two names have no counterpart: ``start_server`` (``torch.profiler`` has
no remote-capture server: it raises, and capture on demand from outside
the process is the exporter's ``/profile``) and the XLA compile listener
(the executor counts its CUDA-graph captures itself).
"""

from __future__ import annotations

import builtins
import collections
import contextlib
import dataclasses
import functools
import itertools
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


@contextlib.contextmanager
def range(name: str, *fmt_args):  # noqa: A001 - mirrors the reference name
    """A named span in ``torch.profiler`` traces (``name % fmt_args``
    when arguments are given)."""
    label = name % fmt_args if fmt_args else name
    with torch.profiler.record_function(label):
        yield


def annotated(name: str):
    """Decorator form of :func:`range`, used on public entry points."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with range(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


@contextlib.contextmanager
def capture(log_dir: str):
    """A ``torch.profiler`` session over the enclosed block, its Chrome
    trace (with the executor's timed calls) written into ``log_dir``
    (:func:`raft_tpu_torch.core.profiling.session`)::

        with tracing.capture("/tmp/trace"):
            index = ivf_flat.build(res, params, dataset)
    """
    from raft_tpu_torch.core import profiling

    with profiling.session(log_dir) as cap:
        yield cap


# graftlint: disable=R0(no counterpart by design: torch.profiler has no remote-capture server)
def start_server(port: int = 9999):
    """No counterpart: ``torch.profiler`` has no remote-capture server.
    Capture from outside the process through the exporter's ``/profile``
    endpoint."""
    raise NotImplementedError(
        "torch.profiler has no remote-capture server; capture on demand "
        "through MetricsExporter's /profile endpoint")


_counters: Dict[str, float] = {}  # guarded-by: _counters_lock
# what reset_counters folded away: the lifetime ledger
_counters_lifetime: Dict[str, float] = {}  # guarded-by: _counters_lock
_gauges: Dict[str, float] = {}    # guarded-by: _counters_lock
_counters_lock = threading.Lock()


def inc_counter(name: str, amount: float = 1.0) -> None:
    """Add ``amount`` to a named process-wide counter (creates it at 0)."""
    with _counters_lock:
        _counters[name] = _counters.get(name, 0.0) + amount


def inc_counters(amounts: Dict[str, float]) -> None:
    """Add several counters under one lock acquisition."""
    with _counters_lock:
        for name, amount in amounts.items():
            _counters[name] = _counters.get(name, 0.0) + amount


def max_counter(name: str, value: float) -> None:
    """Raise a named counter to ``value`` if it is below it (creates it
    at ``value``): high-water marks such as peak bytes."""
    with _counters_lock:
        _counters[name] = max(_counters.get(name, float("-inf")), value)


def get_counter(name: str) -> float:
    """Current value of a counter (0.0 if never incremented)."""
    with _counters_lock:
        return _counters.get(name, 0.0)


def counters(prefix: str = "") -> dict:
    """Snapshot of all counters whose name starts with ``prefix``."""
    with _counters_lock:
        return {k: v for k, v in _counters.items() if k.startswith(prefix)}


def reset_counters(prefix: str = "") -> None:
    """Remove the counters matching ``prefix`` (test isolation). Their
    counts fold into the process-lifetime ledger first."""
    with _counters_lock:
        for k in [k for k in _counters if k.startswith(prefix)]:
            _counters_lifetime[k] = (
                _counters_lifetime.get(k, 0.0) + _counters.pop(k))


def lifetime_counters(prefix: str = "") -> dict:
    """Process-lifetime totals: the live counters plus every count a
    :func:`reset_counters` folded away (an is-it-alive ledger, not a
    metric surface: ``max_counter`` values sum across resets here)."""
    with _counters_lock:
        out = {k: v for k, v in _counters_lifetime.items()
               if k.startswith(prefix)}
        for k, v in _counters.items():
            if k.startswith(prefix):
                out[k] = out.get(k, 0.0) + v
        return out


def set_gauge(name: str, value: float) -> None:
    """Set a named process-wide gauge to ``value`` (last write wins)."""
    with _counters_lock:
        _gauges[name] = value


def set_gauges(values: Dict[str, float]) -> None:
    """Set several gauges under one lock acquisition."""
    with _counters_lock:
        _gauges.update(values)


def get_gauge(name: str, default: float = 0.0) -> float:
    """Current value of a gauge (``default`` if never set)."""
    with _counters_lock:
        return _gauges.get(name, default)


def gauges(prefix: str = "") -> dict:
    """Snapshot of all gauges whose name starts with ``prefix``."""
    with _counters_lock:
        return {k: v for k, v in _gauges.items() if k.startswith(prefix)}


def reset_gauges(prefix: str = "") -> None:
    """Drop gauges matching ``prefix``."""
    with _counters_lock:
        for k in [k for k in _gauges if k.startswith(prefix)]:
            del _gauges[k]


# ---------------------------------------------------------------------------
# histograms: per-stage latency distributions of the serving frontend
# ---------------------------------------------------------------------------

# log2-spaced bucket upper bounds from 1 us to ~67 s
_HIST_BOUNDS = tuple(1e-6 * (2.0 ** i) for i in builtins.range(27))

_histograms: dict = {}  # guarded-by: _counters_lock


class Histogram:
    """Fixed-bound latency histogram (seconds, log2-spaced bounds).

    ``quantile`` interpolates linearly inside the selected bucket (the
    Prometheus-style estimate); values past the last bound land in an
    overflow bucket whose estimate is pinned at ``2 * bounds[-1]``. Each
    instance has its own lock: :func:`get_histogram` hands out live
    objects."""

    __slots__ = ("bounds", "counts", "count", "sum", "_lock")

    def __init__(self, bounds=_HIST_BOUNDS):
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)  # guarded-by: _lock
        self.count = 0   # guarded-by: _lock
        self.sum = 0.0   # guarded-by: _lock
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        lo, hi = 0, len(self.bounds)
        while lo < hi:
            mid = (lo + hi) // 2
            if value <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        with self._lock:
            self.counts[lo] += 1
            self.count += 1
            self.sum += value

    def _quantile(self, q: float, counts, count) -> float:
        if count == 0:
            return 0.0
        target = q * count
        seen = 0
        for i, c in enumerate(counts):
            if seen + c >= target and c > 0:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = (self.bounds[i] if i < len(self.bounds)
                      else self.bounds[-1] * 2.0)
                frac = (target - seen) / c
                return lo + (hi - lo) * frac
            seen += c
        return self.bounds[-1] * 2.0

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0 <= q <= 1); 0.0 when empty."""
        with self._lock:
            counts, count = list(self.counts), self.count
        return self._quantile(q, counts, count)

    def snapshot(self) -> dict:
        """count, sum, p50/p95/p99, the bounds and the CUMULATIVE bucket
        counts (the last, the overflow bucket, equals ``count``)."""
        with self._lock:
            counts, count, total = list(self.counts), self.count, self.sum
        return {
            "count": count,
            "sum": total,
            "p50": self._quantile(0.50, counts, count),
            "p95": self._quantile(0.95, counts, count),
            "p99": self._quantile(0.99, counts, count),
            "bucket_bounds": list(self.bounds),
            "bucket_counts": list(itertools.accumulate(counts)),
        }


def observe(name: str, value: float) -> None:
    """Record ``value`` (seconds) into the named histogram."""
    with _counters_lock:
        h = _histograms.get(name)
        if h is None:
            h = _histograms[name] = Histogram()
    h.observe(value)


def get_histogram(name: str) -> Histogram:
    """The named histogram (an empty one if never observed)."""
    with _counters_lock:
        h = _histograms.get(name)
        if h is None:
            h = _histograms[name] = Histogram()
        return h


def histograms(prefix: str = "") -> dict:
    """``{name: snapshot}`` of the histograms matching ``prefix``."""
    with _counters_lock:
        live = {k: h for k, h in _histograms.items() if k.startswith(prefix)}
    return {k: h.snapshot() for k, h in live.items()}


def reset_histograms(prefix: str = "") -> None:
    """Drop the histograms matching ``prefix``."""
    with _counters_lock:
        for k in [k for k in _histograms if k.startswith(prefix)]:
            del _histograms[k]


# ---------------------------------------------------------------------------
# request spans: host-side stage timing with trace ids
# ---------------------------------------------------------------------------

_trace_ids = itertools.count(1)


def new_trace_id() -> int:
    """A process-unique trace id (a growing int): one is stamped on each
    ``SearchRequest`` and rides every stage span it touches."""
    return next(_trace_ids)


@dataclasses.dataclass(frozen=True)
class Span:
    """One completed host-side span, in the recording clock's seconds.
    A zero-duration span is an instant marker; ``events`` holds
    ``(ts, name, attrs)`` marks inside the span."""

    name: str
    start: float
    end: float
    trace_ids: Tuple[int, ...] = ()
    attrs: Any = dataclasses.field(default_factory=dict)
    events: tuple = ()
    tid: int = 0

    @property
    def duration(self) -> float:
        return self.end - self.start


class SpanRecorder:
    """Bounded span ring (the flight recorder): the newest ``capacity``
    spans; overwrites are counted in :attr:`dropped`."""

    def __init__(self, capacity: int = 8192):
        self._lock = threading.Lock()
        self._buf: "collections.deque[Span]" = collections.deque(  # guarded-by: _lock
            maxlen=max(int(capacity), 1))
        self._dropped = 0  # guarded-by: _lock

    @property
    def capacity(self) -> int:
        return self._buf.maxlen  # graftlint: disable=R8(deque reference never rebinds; maxlen is immutable)

    @property
    def dropped(self) -> int:
        """Spans overwritten since the last :meth:`clear`."""
        with self._lock:
            return self._dropped

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def record(self, name: str, start: float, end: float, *,
               trace_ids: Tuple[int, ...] = (), attrs: Optional[dict] = None,
               events: tuple = ()) -> Span:
        """Record one completed span."""
        span = Span(name=name, start=start, end=end,
                    trace_ids=tuple(trace_ids), attrs=dict(attrs or {}),
                    events=tuple(events), tid=threading.get_ident())
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self._dropped += 1
            self._buf.append(span)
        return span

    def event(self, name: str, ts: float, *,
              trace_ids: Tuple[int, ...] = (),
              attrs: Optional[dict] = None) -> Span:
        """An instant marker (shed, cancel and reject reasons)."""
        return self.record(name, ts, ts, trace_ids=trace_ids, attrs=attrs)

    def spans(self, trace_id: Optional[int] = None,
              name: Optional[str] = None) -> list:
        """The recorded spans, oldest first, optionally those carrying
        ``trace_id`` and/or named ``name``."""
        with self._lock:
            out = list(self._buf)
        if trace_id is not None:
            out = [s for s in out if trace_id in s.trace_ids]
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._dropped = 0

    def to_chrome_trace(self, pid: int = 0,
                        trace_id: Optional[int] = None) -> dict:
        """The ring as Chrome trace-event JSON: ``"X"`` duration events
        (us), ``"i"`` marks for span events and zero-duration spans; the
        exact seconds ride in ``args`` (``t0_s``/``t1_s``) so that
        :meth:`from_chrome_trace` is an exact round trip."""
        events = []
        for s in self.spans(trace_id=trace_id):
            args = dict(s.attrs)
            args.update({
                "trace_ids": list(s.trace_ids), "t0_s": s.start,
                "t1_s": s.end,
                "events": [[ts, name, dict(attrs)]
                           for ts, name, attrs in s.events]})
            events.append({
                "name": s.name, "ph": "X", "pid": pid, "tid": s.tid,
                "ts": s.start * 1e6,
                "dur": max(s.end - s.start, 0.0) * 1e6, "args": args})
            for ts, name, attrs in s.events:
                events.append({
                    "name": f"{s.name}.{name}", "ph": "i", "s": "t",
                    "pid": pid, "tid": s.tid, "ts": ts * 1e6,
                    "args": dict(attrs)})
            if s.end == s.start:
                events.append({
                    "name": s.name, "ph": "i", "s": "t", "pid": pid,
                    "tid": s.tid, "ts": s.start * 1e6,
                    "args": dict(s.attrs)})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    @staticmethod
    def from_chrome_trace(data: dict) -> list:
        """The span list back from :meth:`to_chrome_trace` output."""
        out = []
        for ev in data.get("traceEvents", []):
            if ev.get("ph") != "X":
                continue
            args = dict(ev.get("args", {}))
            trace_ids = tuple(args.pop("trace_ids", ()))
            start = args.pop("t0_s", ev.get("ts", 0.0) / 1e6)
            end = args.pop("t1_s",
                           (ev.get("ts", 0.0) + ev.get("dur", 0.0)) / 1e6)
            events = tuple((ts, name, dict(attrs))
                           for ts, name, attrs in args.pop("events", []))
            out.append(Span(name=ev.get("name", ""), start=start, end=end,
                            trace_ids=trace_ids, attrs=args, events=events,
                            tid=ev.get("tid", 0)))
        return out


_span_recorder = SpanRecorder()


def span_recorder() -> SpanRecorder:
    """The process-wide span ring."""
    return _span_recorder


def record_span(name: str, start: float, end: float, *,
                trace_ids: Tuple[int, ...] = (),
                attrs: Optional[dict] = None,
                events: tuple = ()) -> Span:
    """Record into the process-wide ring."""
    return _span_recorder.record(name, start, end, trace_ids=trace_ids,
                                 attrs=attrs, events=events)


def span_event(name: str, ts: float, *, trace_ids: Tuple[int, ...] = (),
               attrs: Optional[dict] = None) -> Span:
    """An instant marker in the process-wide ring."""
    return _span_recorder.event(name, ts, trace_ids=trace_ids, attrs=attrs)


def reset_spans() -> None:
    """Drop every recorded span."""
    _span_recorder.clear()


@contextlib.contextmanager
def host_span(name: str, *, trace_ids: Tuple[int, ...] = (),
              attrs: Optional[dict] = None):
    """Record a wall-clock host span around the block (build paths and
    scripts; the serving stack records its own clock's timestamps)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record_span(name, t0, time.perf_counter(),
                    trace_ids=trace_ids, attrs=attrs)


# ---------------------------------------------------------------------------
# pure reductions
# ---------------------------------------------------------------------------


def sample_quantile(samples, q: float) -> float:
    """Linear-interpolated q-quantile of a host-side sample list
    (numpy's default method); 0.0 when empty."""
    ts = sorted(float(s) for s in samples)
    if not ts:
        return 0.0
    if len(ts) == 1:
        return ts[0]
    pos = q * (len(ts) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(ts) - 1)
    return ts[lo] + (ts[hi] - ts[lo]) * (pos - lo)


# straggler gauges of the mesh layer (the JAX package's names)
MESH_SHARD_SKEW = "serving.mesh.shard_skew"
MESH_SLOWEST_SHARD = "serving.mesh.slowest_shard"
MESH_SHARD_TIME_MAX = "serving.mesh.shard_time_max_s"
MESH_SHARD_TIME_MEAN = "serving.mesh.shard_time_mean_s"
MESH_SHARD_SKEW_P50 = "serving.mesh.shard_skew_p50"
MESH_SHARD_SKEW_P99 = "serving.mesh.shard_skew_p99"


def straggler_stats(timings) -> dict:
    """Reduce per-shard timings (seconds, index = shard ordinal) into
    straggler attribution (``raft_tpu/core/tracing.py:584``):
    ``slowest_shard`` (argmax), ``shard_skew`` (max - min), max and
    mean."""
    ts = [float(t) for t in timings]
    if not ts:
        return {"shards": 0, "shard_skew": 0.0, "slowest_shard": -1,
                "max_s": 0.0, "mean_s": 0.0}
    mx = max(ts)
    return {"shards": len(ts), "shard_skew": mx - min(ts),
            "slowest_shard": ts.index(mx), "max_s": mx,
            "mean_s": sum(ts) / len(ts)}


def poll_shard_timings(parts, t0: float, *, poll_s: float = 50e-6) -> list:
    """Per-shard arrival offsets (seconds after ``t0``) from a
    non-blocking poll over ``parts``, a sequence of ``(distances,
    indices)`` pairs, one per shard ordinal (``raft_tpu/core/
    tracing.py:606``). A CUDA tensor is ready when a CUDA event recorded
    behind it on its device's current stream has completed (the poll
    records one event a shard, up front); a CPU tensor is ready at once.
    Polling instead of blocking shard by shard keeps an early straggler
    from dragging every later reading up to its own."""
    events = []
    for d, i in parts:
        dev = d.device if isinstance(d, torch.Tensor) else None
        if dev is not None and dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            events.append(ev)
        else:
            events.append(None)
    timings = [0.0] * len(parts)
    pending = set(builtins.range(len(parts)))
    while pending:
        for s in tuple(pending):
            ev = events[s]
            if ev is None or ev.query():
                timings[s] = time.perf_counter() - t0
                pending.discard(s)
        if pending:
            time.sleep(poll_s)
    return timings


def record_mesh_spans(family: str, t0: float, t1: float, *,
                      trace_ids: Tuple[int, ...] = (),
                      phases: Optional[dict] = None, shard_timings=None,
                      shard_attrs: Optional[dict] = None,
                      skew_samples=None,
                      count_dispatch: bool = True) -> dict:
    """Record one mesh dispatch (``raft_tpu/core/tracing.py:656``): a
    ``serving.mesh.<phase>`` span per entry of ``phases`` over the
    dispatch window (attrs carry the modeled per-phase bytes), a
    ``serving.mesh.shard`` span per entry of ``shard_timings`` (seconds
    after ``t0`` at which that shard's output was ready), the straggler
    gauges, and ``serving.mesh.shard_skew_p50/_p99`` from
    ``skew_samples`` (one skew per dispatch). Returns the straggler
    stats."""
    for phase, attrs in (phases or {}).items():
        a = dict(attrs or {})
        a["family"] = family
        record_span(f"serving.mesh.{phase}", t0, t1, trace_ids=trace_ids,
                    attrs=a)
    stats = straggler_stats(shard_timings or ())
    if shard_timings:
        for s, dt in enumerate(shard_timings):
            a = {"family": family, "shard": s}
            if shard_attrs:
                a.update(shard_attrs)
            record_span("serving.mesh.shard", t0, t0 + float(dt),
                        trace_ids=trace_ids, attrs=a)
        set_gauges({
            MESH_SHARD_SKEW: stats["shard_skew"],
            MESH_SLOWEST_SHARD: float(stats["slowest_shard"]),
            MESH_SHARD_TIME_MAX: stats["max_s"],
            MESH_SHARD_TIME_MEAN: stats["mean_s"],
        })
        if count_dispatch:
            inc_counter("serving.mesh.dispatches")
    if skew_samples:
        stats["shard_skew_p50"] = sample_quantile(skew_samples, 0.50)
        stats["shard_skew_p99"] = sample_quantile(skew_samples, 0.99)
        set_gauges({MESH_SHARD_SKEW_P50: stats["shard_skew_p50"],
                    MESH_SHARD_SKEW_P99: stats["shard_skew_p99"]})
    return stats


# the flat (unlabeled) drift/recall gauge names of the index gauge
DRIFT_SCORE = "index.drift.score"
RECALL_ESTIMATE = "index.recall.estimate"


def index_health(list_sizes, max_list_size: Optional[int] = None,
                 shards: int = 0) -> dict:
    """One index's per-list populations reduced into its health stats
    (``tracing.py:723``): occupancy skew (``max``/``mean``/``p99`` list
    size, the Gini coefficient), ``dead_lists`` (empty), ``overflow_lists``
    (at the padded capacity ``max_list_size``), ``fill_fraction`` of the
    padded planes and, with ``shards`` > 1, the per-shard row totals'
    ``shard_imbalance`` (max/mean)."""
    sizes = np.asarray(list_sizes, dtype=np.int64)
    n = int(sizes.size)
    total = int(sizes.sum())
    out = {
        "n_lists": n,
        "rows": total,
        "max_list_size": int(sizes.max()) if n else 0,
        "mean_list_size": total / n if n else 0.0,
        "p99_list_size": float(np.percentile(sizes, 99)) if n else 0.0,
        "dead_lists": int((sizes == 0).sum()),
        "overflow_lists": 0,
        "fill_fraction": 0.0,
        "gini": 0.0,
        "shard_imbalance": 1.0,
    }
    if max_list_size:
        out["overflow_lists"] = int((sizes >= max_list_size).sum())
        out["fill_fraction"] = (total / (n * max_list_size)
                                if n * max_list_size else 0.0)
    if total > 0 and n > 1:
        s = np.sort(sizes)
        cum = np.cumsum(s, dtype=np.float64)
        out["gini"] = float(
            (n + 1 - 2.0 * (cum.sum() / cum[-1])) / n)
    if shards > 1 and n % shards == 0:
        per_shard = sizes.reshape(shards, n // shards).sum(axis=1)
        mean = per_shard.mean()
        out["shard_imbalance"] = (float(per_shard.max() / mean)
                                  if mean > 0 else 1.0)
    return out


def js_divergence(p, q) -> float:
    """Jensen-Shannon divergence (base 2, in [0, 1]) between two count
    histograms (``tracing.py:804``): a zero histogram against a non-zero
    one scores 1.0, two zero histograms 0.0."""
    pa = np.asarray(p, dtype=np.float64)
    qa = np.asarray(q, dtype=np.float64)
    ps, qs = pa.sum(), qa.sum()
    if ps == 0 and qs == 0:
        return 0.0
    if ps == 0 or qs == 0:
        return 1.0
    pa, qa = pa / ps, qa / qs
    m = 0.5 * (pa + qa)

    def kl(a, b):
        mask = a > 0
        return float(np.sum(a[mask] * np.log2(a[mask] / b[mask])))

    return 0.5 * kl(pa, m) + 0.5 * kl(qa, m)


def probe_freq_stats(counts, top_n: int = 8) -> dict:
    """One cumulative probe-frequency plane's traffic stats: ``total``
    probes, ``probed_fraction`` (share of lists ever probed), the shares
    of all probes the hottest 1% / 10% of lists took (``coverage_p01``,
    ``coverage_p10``) and the ``top_n`` hottest ``(list_id, count)``."""
    c = np.asarray(counts, dtype=np.int64)
    n = int(c.size)
    total = int(c.sum())
    if n == 0 or total == 0:
        return {"n_lists": n, "total": total, "probed_fraction": 0.0,
                "coverage_p01": 0.0, "coverage_p10": 0.0, "top": []}
    order = np.argsort(-c, kind="stable")
    sorted_c = c[order]
    cum = np.cumsum(sorted_c, dtype=np.float64)

    def coverage(frac: float) -> float:
        k = max(1, int(np.ceil(n * frac)))
        return float(cum[k - 1] / total)

    top = [(int(order[i]), int(sorted_c[i]))
           for i in builtins.range(min(top_n, n)) if sorted_c[i] > 0]
    return {"n_lists": n, "total": total,
            "probed_fraction": float((c > 0).sum() / n),
            "coverage_p01": coverage(0.01),
            "coverage_p10": coverage(0.10), "top": top}
