"""The index-health half of observability — the port of
``raft_tpu/serving/gauge.py``.

The serving metrics made the *serving path* legible; this module makes
the *index itself* legible. Four connected pieces, all publishing
through the :mod:`raft_tpu_torch.core.tracing` registries so the existing
exporter scrapes them like everything else:

- **Probe-frequency accounting** lives in the executor
  (``SearchExecutor(probe_accounting=True)`` — a donated device-side
  counter plane per index, fetched once per scrape); this module's
  :class:`IndexGauge` drives its publication and shares the one fetch
  with drift detection.
- **Index health** (:func:`raft_tpu_torch.core.tracing.index_health`) —
  list-occupancy skew, dead/overflow lists, per-shard imbalance —
  published as ``index.health.<name>.*`` gauges per watched index.
- **Online recall estimation** (:class:`ShadowSampler` /
  :class:`RecallWindow`) — a seeded fraction of live requests is
  re-run through an exact (brute-force) index as *background-class*
  work riding the normal admission ladder, so overload sheds shadow
  queries first; completed pairs feed a windowed recall estimate with
  a Wilson binomial confidence interval
  (``index.recall.estimate`` / ``.ci_low`` / ``.ci_high``).
- **Query-drift detection** (:class:`DriftDetector`) — the live
  centroid-assignment histogram (per-scrape deltas of the probe
  counters, EWMA-smoothed) against a build-time baseline snapshot via
  a streaming Jensen-Shannon divergence (``index.drift.score``), so a
  stale-index alert fires before recall visibly degrades.

Clock discipline (graftlint R7): every timestamp here comes from the
batcher's injectable clock, so the whole surface is deterministic
under the manual-clock fault harness. Host-sync discipline (R5): the
recall comparison and health fetches only touch handles that already
completed and index metadata — nothing here runs on the dispatch path.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
from typing import Any, Dict, Optional

import numpy as np

from raft_tpu_torch.core import tracing
from raft_tpu_torch.serving.request import Overloaded, ShutDown


def _host(a) -> np.ndarray:
    """A result tensor (any device) or array on the host."""
    if hasattr(a, "cpu"):
        a = a.cpu()
    return np.asarray(a)


def host_list_sizes(index) -> np.ndarray:
    """``index.list_sizes`` on the host: one tensor, or a mesh index's
    per-slot list concatenated in slot order (its own list-id space)."""
    sizes = index.list_sizes
    if isinstance(sizes, (list, tuple)):
        return np.concatenate([np.asarray(s.cpu()) for s in sizes])
    if hasattr(sizes, "cpu"):
        sizes = sizes.cpu()
    return np.asarray(sizes)

# counters: the shadow-query lifecycle ledger
SHADOW_SUBMITTED = "index.recall.shadow_submitted"
SHADOW_COMPLETED = "index.recall.shadow_completed"
SHADOW_SHED = "index.recall.shadow_shed"
SHADOW_DROPPED = "index.recall.shadow_dropped"
SHADOW_SKIPPED = "index.recall.shadow_skipped"


def wilson_interval(hits: int, trials: int,
                    z: float = 1.96) -> tuple:
    """Wilson score interval for a binomial proportion — the standard
    small-sample-honest CI (never escapes [0, 1], sane at p near 0/1
    where the normal approximation lies). Returns ``(low, high)``;
    an empty sample is maximally uncertain: ``(0, 1)``."""
    if trials <= 0:
        return (0.0, 1.0)
    p = hits / trials
    z2 = z * z
    denom = 1.0 + z2 / trials
    center = (p + z2 / (2.0 * trials)) / denom
    half = (z * math.sqrt(p * (1.0 - p) / trials
                          + z2 / (4.0 * trials * trials)) / denom)
    return (max(0.0, center - half), min(1.0, center + half))


class RecallWindow:
    """Sliding-window recall@k accounting in the batcher clock domain.

    Each completed (live, shadow) pair contributes ``hits`` matched
    neighbors out of ``trials = rows * k`` — a binomial sample, so the
    windowed estimate carries a Wilson interval. Same discipline as
    :class:`~raft_tpu_torch.serving.metrics.SloWindow`: caller timestamps
    only, one lock, O(pairs-pruned) per operation."""

    def __init__(self, window_s: float = 300.0, z: float = 1.96,
                 decay_half_life_s: Optional[float] = None,
                 gauge_prefix: str = "index.recall"):
        self.window_s = window_s
        self.z = z
        # the published gauge family; a params-sweep leg publishes
        # under "index.recall.sweep.p<NP>" so the operating point and
        # the frontier samples stay separate scrape families
        self.gauge_prefix = gauge_prefix
        # exponential-decay weighting (follow-on): a uniform
        # window reacts to sudden index staleness only as old pairs
        # age out; with a half-life each pair's weight is
        # 0.5**(age/half_life), so fresh evidence dominates within a
        # couple of half-lives while the window still bounds memory.
        # None (default) keeps the original uniform weighting.
        self.decay_half_life_s = decay_half_life_s
        self._lock = threading.Lock()
        self._events: "collections.deque" = collections.deque()  # guarded-by: _lock
        self._hits = 0    # guarded-by: _lock
        self._trials = 0  # guarded-by: _lock
        # decay path: running sums of event weights, anchored at
        # ``_anchor`` — scaling both sums by the elapsed decay factor
        # on access keeps record/estimate O(events-pruned), never
        # O(window); record() sits on the shadow-completion path
        self._wh = 0.0  # guarded-by: _lock
        self._wt = 0.0  # guarded-by: _lock
        self._anchor: Optional[float] = None  # guarded-by: _lock

    def _decay_to_locked(self, now: float) -> None:
        if self._anchor is None:
            self._anchor = now
        elif now > self._anchor:
            f = 0.5 ** ((now - self._anchor) / self.decay_half_life_s)
            self._wh *= f
            self._wt *= f
            self._anchor = now

    def _prune_locked(self, now: float) -> None:
        horizon = now - self.window_s
        while self._events and self._events[0][0] <= horizon:
            t, h, n = self._events.popleft()
            self._hits -= h
            self._trials -= n
            if self.decay_half_life_s is not None:
                # the event's CURRENT weight (sums sit at _anchor)
                w = 0.5 ** ((self._anchor - t)
                            / self.decay_half_life_s)
                self._wh -= w * h
                self._wt -= w * n

    def record(self, now: float, hits: int, trials: int) -> None:
        """Count one shadow pair's outcome and re-publish."""
        with self._lock:
            self._events.append((now, int(hits), int(trials)))
            self._hits += int(hits)
            self._trials += int(trials)
            if self.decay_half_life_s is not None:
                self._decay_to_locked(now)
                self._wh += int(hits)
                self._wt += int(trials)
        self.publish(now)

    def estimate(self, now: float) -> dict:
        """Windowed recall estimate + Wilson CI as of ``now``. With
        ``decay_half_life_s`` set, hits and trials are
        exponential-decay weighted by age; the CI then uses the
        weighted trial mass as its sample size — less than the raw
        count, so decay honestly WIDENS the interval as evidence
        ages."""
        with self._lock:
            if self.decay_half_life_s is not None:
                self._decay_to_locked(now)
            self._prune_locked(now)
            if self.decay_half_life_s is None:
                hits, trials = float(self._hits), float(self._trials)
            else:
                # float-subtraction residue from pruning stays tiny;
                # clamp so an emptied window reads exactly no evidence
                hits = self._wh if self._events else 0.0
                trials = self._wt if self._events else 0.0
                hits, trials = max(hits, 0.0), max(trials, 0.0)
            pairs = len(self._events)
        est = hits / trials if trials else 0.0
        lo, hi = wilson_interval(hits, trials, self.z)
        return {"estimate": est, "ci_low": lo, "ci_high": hi,
                "pairs": pairs, "trials": trials}

    def raw(self, now: float) -> dict:
        """The window's UNWEIGHTED hit/trial counts as of ``now`` —
        the federation payload : replicas pool raw trials
        and the fleet aggregator applies the Wilson interval to the
        POOLED sample, which is strictly tighter than any combination
        of per-replica intervals."""
        with self._lock:
            self._prune_locked(now)
            return {"hits": int(self._hits),
                    "trials": int(self._trials),
                    "pairs": len(self._events)}

    def publish(self, now: float) -> dict:
        """Re-publish the ``index.recall.*`` gauges as of ``now`` —
        called on every record and by the scrape-time refresh, so the
        estimate's window slides even while no shadows complete."""
        e = self.estimate(now)
        p = self.gauge_prefix
        tracing.set_gauges({
            f"{p}.estimate": e["estimate"],
            f"{p}.ci_low": e["ci_low"],
            f"{p}.ci_high": e["ci_high"],
            f"{p}.window_pairs": float(e["pairs"]),
            f"{p}.window_trials": float(e["trials"]),
        })
        return e


@dataclasses.dataclass(frozen=True)
class ShadowConfig:
    """Shadow-query sampling policy.

    ``fraction`` of live submissions re-run through the exact index;
    the sampler's RNG is seeded (``seed``) so the sampled subset — and
    therefore every downstream recall/drift number — is deterministic
    for a given submission sequence. Shadow requests ride the normal
    admission ladder as the *background class*: ``priority`` should
    sit at/above the batcher's ``LoadShed.background_priority`` so the
    ladder rejects shadow work first under load, and ``timeout_s``
    bounds how long a queued shadow may wait before the expiry shed
    reclaims it — live traffic never waits on shadow work.
    ``max_pending`` bounds the unresolved-pair buffer (overflow drops
    the oldest pair, counted in ``index.recall.shadow_dropped`` — as
    is a pair whose LIVE leg failed, so every submitted pair resolves
    into the ledger: submitted == completed + shed-after-admission +
    dropped; ``shadow_shed`` additionally counts admission-rejected
    shadows that never became pairs)."""

    fraction: float = 0.01
    seed: int = 0
    priority: int = 1 << 16
    timeout_s: Optional[float] = 1.0
    window_s: float = 300.0
    max_pending: int = 256
    # params-sweep shadow sampling (follow-on): alternative
    # n_probes values to re-run sampled submissions at, as EXTRA
    # background-class legs paired against the same exact truth —
    # ``index.recall.sweep.p<NP>.*`` then maps the live
    # recall/latency frontier instead of just the operating point.
    # Values rotate round-robin across sampled submissions (seeded
    # sampling keeps the rotation deterministic); () disables.
    sweep_probes: tuple = ()


class ShadowSampler:
    """Online recall estimation by shadow re-execution.

    Wraps a :class:`~raft_tpu_torch.serving.batcher.DynamicBatcher`:
    :meth:`submit` forwards the live request untouched and, for a
    seeded ``fraction`` of submissions, also enqueues the same query
    block against ``exact_index`` (the existing brute-force family) as
    a background-class request. :meth:`pump` — called from the
    exporter's scrape refresh, or directly in tests — resolves
    completed pairs into the :class:`RecallWindow`. Shadow failures of
    any typed serving kind count as sheds, never as errors: shedding
    shadow work under load is the design, and the recall gauge simply
    loses samples (its widening Wilson interval says so honestly).

    Example::

        exact = brute_force.build(res, BruteForceIndexParams(), dataset)
        sampler = ShadowSampler(batcher, exact,
                                ShadowConfig(fraction=0.05))
        handle = sampler.submit(index, queries, k=10, params=p)
    """

    def __init__(self, batcher, exact_index,
                 config: Optional[ShadowConfig] = None):
        import random

        self.batcher = batcher
        self.exact_index = exact_index
        self.config = config or ShadowConfig()
        self._clock = batcher._clock
        self._rng = random.Random(self.config.seed)
        self._lock = threading.Lock()
        self._pending: "collections.deque" = collections.deque()  # guarded-by: _lock
        self.window = RecallWindow(window_s=self.config.window_s)
        # params-sweep legs: one window per swept n_probes, published
        # as its own gauge family — together they sample the live
        # recall side of the recall/latency frontier
        self.sweep_windows = {
            int(p): RecallWindow(
                window_s=self.config.window_s,
                gauge_prefix=f"index.recall.sweep.p{int(p)}")
            for p in self.config.sweep_probes}
        self._sweep_cursor = 0  # guarded-by: _lock

    def submit(self, index, queries, k: int, params=None, **kw):
        """Submit one live request (exactly ``batcher.submit``) and
        maybe tag it with a shadow. Returns the LIVE handle; the
        shadow's lifecycle is the sampler's business alone. A shadow
        rejected at admission (the background class is the ladder's
        first casualty) is counted shed and the live path is
        unaffected.

        FILTERED requests are never shadowed: recall must compare the
        ANN result against the exact truth over the SAME candidate
        set, and the brute-force family has no filter support — so a
        filtered pair would score healthy traffic against the wrong
        (unfiltered) truth and read as permanent staleness. Such
        submissions count ``index.recall.shadow_skipped`` and the
        estimate honestly covers unfiltered traffic only.

        With ``sweep_probes`` configured, a sampled submission also
        re-runs at ONE alternative ``n_probes`` (round-robin over the
        sweep values) as an extra background-class leg scored against
        the same exact truth — the per-value
        ``index.recall.sweep.p<NP>.*`` windows then map the live
        recall frontier, not just the operating point. The sweep leg
        shares the shadow's shed-first discipline; a submission whose
        ``params`` has no ``n_probes`` knob simply sweeps nothing."""
        handle = self.batcher.submit(index, queries, k, params=params,
                                     **kw)
        with self._lock:
            sampled = self._rng.random() < self.config.fraction
        if not sampled:
            return handle
        if kw.get("sample_filter") is not None:
            tracing.inc_counter(SHADOW_SKIPPED)
            return handle
        try:
            shadow = self.batcher.submit(
                self.exact_index, queries, k,
                priority=self.config.priority,
                timeout_s=self.config.timeout_s)
        except (Overloaded, ShutDown):
            tracing.inc_counter(SHADOW_SHED)
            return handle
        tracing.inc_counter(SHADOW_SUBMITTED)
        with self._lock:
            self._pending.append((handle, shadow, k, None))
            while len(self._pending) > self.config.max_pending:
                self._pending.popleft()
                tracing.inc_counter(SHADOW_DROPPED)
        if self.sweep_windows and hasattr(params, "n_probes"):
            with self._lock:
                order = sorted(self.sweep_windows)
                probes = order[self._sweep_cursor % len(order)]
                self._sweep_cursor += 1
            sweep_params = dataclasses.replace(params, n_probes=probes)
            try:
                leg = self.batcher.submit(
                    index, queries, k, params=sweep_params,
                    priority=self.config.priority,
                    timeout_s=self.config.timeout_s)
            except (Overloaded, ShutDown):
                tracing.inc_counter(SHADOW_SHED)
                return handle
            tracing.inc_counter(SHADOW_SUBMITTED)
            with self._lock:
                self._pending.append((leg, shadow, k, probes))
                while len(self._pending) > self.config.max_pending:
                    self._pending.popleft()
                    tracing.inc_counter(SHADOW_DROPPED)
        return handle

    @staticmethod
    def _pair_hits(live_ids, exact_ids, k: int) -> tuple:
        """(hits, trials) of one completed pair: per-row overlap of
        the ANN ids with the exact ids — recall@k counted over
        ``rows * k`` binomial trials. Host arrays only (both handles
        completed, so the batcher already blocked on the device)."""
        a = _host(live_ids)
        e = _host(exact_ids)
        hits = 0
        for r in range(a.shape[0]):
            truth = e[r][e[r] >= 0]
            hits += int(np.isin(a[r], truth).sum())
        return hits, a.shape[0] * k

    def pump(self) -> int:
        """Resolve every pair whose handles both completed; returns
        pairs folded into the window. Unfinished pairs stay queued —
        this never blocks on a handle."""
        now = self._clock.now()
        done = []
        with self._lock:
            keep = collections.deque()
            for pair in self._pending:
                if pair[0].done() and pair[1].done():
                    done.append(pair)
                else:
                    keep.append(pair)
            self._pending = keep
        resolved = 0
        for live, shadow, k, probes in done:
            if shadow.exception(timeout=0) is not None:
                # expiry-shed / ladder-rejected / shutdown shadow —
                # the designed overload behavior, not an error
                tracing.inc_counter(SHADOW_SHED)
                continue
            if live.exception(timeout=0) is not None:
                # the LIVE (or sweep) leg failed (shed/cancelled) —
                # the pair is unscorable; count it dropped so the
                # lifecycle ledger keeps summing:
                # submitted == completed + shed + dropped
                tracing.inc_counter(SHADOW_DROPPED)
                continue
            hits, trials = self._pair_hits(
                live.result()[1], shadow.result()[1], k)
            window = (self.window if probes is None
                      else self.sweep_windows[probes])
            window.record(now, hits, trials)
            tracing.inc_counter(SHADOW_COMPLETED)
            resolved += 1
        return resolved

    def publish(self) -> dict:
        """Scrape-time refresh: resolve finished pairs and re-publish
        the recall gauges (operating point + every sweep window) at
        the clock's now."""
        self.pump()
        now = self._clock.now()
        for w in self.sweep_windows.values():
            w.publish(now)
        return self.window.publish(now)


class DriftDetector:
    """Streaming divergence of live traffic from a build-time baseline.

    ``baseline`` is the build-time centroid-assignment histogram — the
    index's ``list_sizes`` plane is exactly that (each stored row was
    assigned to its nearest center), so
    :meth:`from_index` snapshots it at attach time. :meth:`update`
    takes the *cumulative* live probe plane (the executor's counter
    fetch), diffs it against the previous scrape into a per-window
    assignment histogram, folds it into an EWMA (``alpha`` per
    scrape), and scores the smoothed histogram against the baseline
    with the bounded Jensen-Shannon divergence
    (:func:`raft_tpu_torch.core.tracing.js_divergence`). Deterministic:
    pure function of the scrape sequence, no clock, no RNG — the
    fixed-seed shadow tests pin the score exactly. One lock serializes
    :meth:`update`: the exporter's HTTP server is threaded, and two
    concurrent scrapes racing the ``_last`` diff would double-fold the
    same traffic window into the EWMA."""

    def __init__(self, baseline, *, alpha: float = 0.2,
                 alert_threshold: float = 0.15):
        self.baseline = np.asarray(baseline, dtype=np.float64)
        self.alpha = alpha
        self.alert_threshold = alert_threshold
        self._lock = threading.Lock()
        self._last: Optional[np.ndarray] = None  # guarded-by: _lock
        self._ewma: Optional[np.ndarray] = None  # guarded-by: _lock
        # EWMA of per-window probe traffic (same alpha): the weight a
        # fleet aggregator scales this replica's normalized live
        # histogram by — without it, pooling would weigh an idle
        # replica the same as one carrying 99% of fleet traffic
        self._traffic = 0.0  # guarded-by: _lock
        # identity watch (follow-on): which index object this
        # baseline was snapshotted from. extend()/rebuild returns a NEW
        # index whose list_sizes shifted — scoring live traffic against
        # the stale build-time histogram would read as permanent drift,
        # so the scrape-time publisher rebaselines when the watched
        # identity (or the plane shape) changes.
        self._watched = None
        self.score = 0.0
        self.updates = 0
        self.rebaselines = 0

    @classmethod
    def from_index(cls, index, **kw) -> "DriftDetector":
        """Snapshot ``index.list_sizes`` as the baseline (one fetch,
        at attach time — never on the dispatch path) and watch the
        index's identity for automatic rebaselining."""
        det = cls(host_list_sizes(index), **kw)
        det.watch(index)
        return det

    def watch(self, index) -> None:
        """Pair this detector's baseline with ``index``'s identity (a
        weakref — the detector must not keep a replaced index alive)."""
        import weakref

        try:
            self._watched = weakref.ref(index)
        except TypeError:            # non-weakref-able index objects
            self._watched = None

    def matches(self, index) -> bool:
        """Whether the current baseline still describes ``index``: the
        plane shapes agree AND (when an identity is watched) the index
        is the very object the baseline came from. A detector built
        from a raw baseline array matches any shape-compatible index
        until it is first watched."""
        n = int(getattr(index, "n_lists", self.baseline.shape[0]))
        if self.baseline.shape[0] != n:
            return False
        return self._watched is None or self._watched() is index

    def rebaseline(self, index) -> None:
        """Re-snapshot the baseline from (a rebuilt/extended)
        ``index`` and reset the streaming state — the smoothed live
        histogram and the last-scrape plane describe traffic scored
        against the OLD baseline (and may even be the wrong length),
        so both restart; the score holds at 0 until fresh traffic
        accumulates. Counted in ``rebaselines`` (published per watched
        index by :class:`IndexGauge`)."""
        sizes = host_list_sizes(index).astype(np.float64)
        with self._lock:
            self.baseline = sizes
            self._last = None
            self._ewma = None
            self._traffic = 0.0
            self.score = 0.0
            self.updates = 0         # folds against the NEW baseline
            self.rebaselines += 1
        self.watch(index)

    @property
    def alert(self) -> bool:
        return self.score >= self.alert_threshold

    def state(self) -> dict:
        """The streaming state as plain lists — the federation
        payload : the fleet aggregator pools replicas'
        smoothed live histograms and baselines and re-scores the
        POOLED traffic. ``traffic`` (the EWMA of per-window probe
        counts) is the pooling weight: the live histogram is
        NORMALIZED per replica, so without it a drifted replica
        carrying 99% of fleet traffic would be averaged away by idle
        undrifted peers."""
        with self._lock:
            return {
                "baseline": [float(v) for v in self.baseline],
                "live": ([float(v) for v in self._ewma]
                         if self._ewma is not None else None),
                "traffic": self._traffic,
                "score": self.score,
                "updates": self.updates,
            }

    def update(self, cumulative_counts) -> float:
        """Fold one scrape's cumulative probe plane into the score."""
        c = np.asarray(cumulative_counts, dtype=np.float64)
        with self._lock:
            delta = c if self._last is None else np.maximum(
                c - self._last, 0.0)
            self._last = c
            if delta.sum() <= 0:
                return self.score    # no new traffic — score holds
            hist = delta / delta.sum()
            self._ewma = (hist if self._ewma is None
                          else self.alpha * hist
                          + (1.0 - self.alpha) * self._ewma)
            self._traffic = (float(delta.sum()) if self.updates == 0
                             else self.alpha * float(delta.sum())
                             + (1.0 - self.alpha) * self._traffic)
            self.score = tracing.js_divergence(self._ewma,
                                               self.baseline)
            self.updates += 1
            return self.score


class IndexGauge:
    """One scrape-time publisher tying graftgauge together.

    Attach it to the exporter (``MetricsExporter(index_gauge=...)``)
    and every ``/metrics`` scrape refreshes — with ONE probe-plane
    fetch shared between probe-frequency gauges and drift scoring —
    while ``/index.json`` serves the full structured view.

    ``indexes`` maps gauge names to served index objects (their
    ``list_sizes`` reduce through ``index_health`` each scrape — a
    small metadata fetch); ``drift`` maps the same names to
    :class:`DriftDetector` instances (paired with the live probe plane
    via ``executor.probe_label``); ``sampler`` is the optional
    :class:`ShadowSampler`."""

    def __init__(self, executor=None,
                 indexes: Optional[Dict[str, Any]] = None,
                 sampler: Optional[ShadowSampler] = None,
                 drift: Optional[Dict[str, DriftDetector]] = None,
                 top_n: int = 8):
        self.executor = executor
        self.indexes = dict(indexes or {})
        self.sampler = sampler
        self.drift = dict(drift or {})
        self.top_n = top_n

    def _health(self, name: str, index) -> dict:
        sizes = host_list_sizes(index)
        shards = getattr(getattr(index, "comms", None), "size", 0)
        extent = getattr(index, "max_list_size", None)
        if extent is None:      # a mesh IVF-BQ index: its codes' extent
            extent = index.codes[0].shape[1]
        stats = tracing.index_health(
            sizes, max_list_size=extent, shards=shards)
        base = f"index.health.{name}."
        tracing.set_gauges({base + k: float(v)
                            for k, v in stats.items()})
        return stats

    def publish(self) -> dict:
        """Refresh every graftgauge surface; returns the
        ``/index.json`` body. One probe-plane fetch, one ``list_sizes``
        fetch per watched index — per scrape, never per dispatch."""
        out: dict = {"health": {}, "probe_freq": {}, "drift": {},
                     "recall": None}
        planes: dict = {}
        if self.executor is not None and hasattr(self.executor,
                                                 "probe_frequencies"):
            planes = self.executor.probe_frequencies()
            out["probe_freq"] = self.executor.publish_probe_gauges(
                top_n=self.top_n, planes=planes)
        for name, index in self.indexes.items():
            out["health"][name] = self._health(name, index)
        worst = 0.0
        for name, det in self.drift.items():
            index = self.indexes.get(name)
            if index is not None and not det.matches(index):
                # the watched index was rebuilt/extended (new identity
                # or a new list count): refresh the baseline instead of
                # scoring live traffic against the stale build-time
                # histogram
                det.rebaseline(index)
            elif index is not None:
                det.watch(index)     # adopt raw-baseline detectors
            label = (self.executor.probe_label(index)
                     if self.executor is not None and index is not None
                     else None)
            if label is not None and label in planes:
                det.update(planes[label])
            tracing.set_gauges({
                f"index.drift.{name}.score": det.score,
                f"index.drift.{name}.alert": float(det.alert),
                f"index.drift.{name}.rebaselines":
                    float(det.rebaselines),
            })
            worst = max(worst, det.score)
            out["drift"][name] = {"score": det.score,
                                  "alert": det.alert,
                                  "updates": det.updates,
                                  "rebaselines": det.rebaselines}
        if self.drift:
            tracing.set_gauge(tracing.DRIFT_SCORE, worst)
        if self.sampler is not None:
            out["recall"] = self.sampler.publish()
        return out

    def federation_payload(self) -> dict:
        """The type-correct merge inputs a fleet aggregator needs
        beyond the metric registries  — shipped inside
        ``/snapshot.json`` when an :class:`IndexGauge` is attached:

        - ``probe_planes`` — the FULL cumulative per-list probe
          plane per label (the top-N gauge samples are a rendering,
          not a mergeable plane; fleet hot/cold coverage needs every
          list's count so replica sums land exactly),
        - ``recall`` — raw windowed hit/trial counts per window
          (operating point + each sweep leg), pooled fleet-side
          BEFORE the Wilson interval,
        - ``drift`` — per watched index the smoothed live histogram
          and baseline, re-scored fleet-side on the pooled traffic.

        One probe-plane fetch, at scrape time — never per dispatch."""
        out: dict = {"probe_planes": {}, "recall": {}, "drift": {}}
        if self.executor is not None and hasattr(self.executor,
                                                 "probe_frequencies"):
            out["probe_planes"] = {
                label: [int(v) for v in plane]
                for label, plane in
                self.executor.probe_frequencies().items()}
        if self.sampler is not None:
            now = self.sampler._clock.now()
            out["recall"]["live"] = self.sampler.window.raw(now)
            for probes, w in self.sampler.sweep_windows.items():
                out["recall"][f"sweep.p{probes}"] = w.raw(now)
        for name, det in self.drift.items():
            out["drift"][name] = det.state()
        return out
