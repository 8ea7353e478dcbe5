"""Metric federation — N replicas, one truth; the port of
``raft_tpu/serving/federation.py``.

Every gauge plane of the serving stack — probe frequency,
recall windows, drift, SLO burn, attribution — is per-executor-
process: a deployment serving millions of users across N replicas has
N disconnected truths. :class:`FleetAggregator` closes that gap the
Prometheus-federation way: it scrapes each replica's
``/snapshot.json`` (stdlib urllib, bounded staleness, per-replica
health) and merges them with TYPE-CORRECT semantics — summing a gauge
that doesn't sum, or Wilson-intervaling per-replica estimates, would
produce confident nonsense:

- **Counters** sum from the **lifetime ledger**
  (``counters_lifetime`` — :func:`raft_tpu_torch.core.tracing
  .lifetime_counters`), not the resettable live registries: a
  replica's mid-scrape ``reset_counters()`` folds into its ledger
  instead of vanishing, and the aggregator additionally holds a
  per-(replica, counter) high-water mark so a fleet counter can NEVER
  go backwards (regressions are clamped and counted in
  ``fleet.monotonicity_violations`` — a restarted replica resets its
  ledger legitimately; the fleet total must still be monotone).
- **Histograms** merge bucket-wise (same log2 bounds across the repo;
  cumulative bucket vectors sum elementwise) and the fleet quantiles
  recompute from the MERGED distribution — never averaged p99s.
- **Probe-frequency planes** sum per list into fleet hot/cold
  coverage (:func:`raft_tpu_torch.core.tracing.probe_freq_stats` over the
  summed plane) — the tiered-storage placement signal at deployment
  scope, not per replica.
- **Recall windows** pool raw trials across replicas BEFORE the
  Wilson interval — strictly tighter than any combination of
  per-replica intervals.
- **Drift** re-scores the POOLED live histogram against the pooled
  baseline, so a drifted replica weighs by its traffic share.
- **Memory** (graftledger): per-replica ``memory`` blocks merge
  as resident-bytes SUM (each replica holds its own copy) and
  headroom MIN over replicas that measured one — the placement
  question is "where does the hot tier still fit", answered by the
  worst-off replica, never an average. Replicas without the block
  (older builds, no ledger attached) are skipped and counted in
  ``replicas_reporting`` — missing data must not read as zero bytes
  or infinite room.

Two additions close the follow-ons: **push mode**
(:meth:`FleetAggregator.push` / the exporter's ``POST /push``) lets a
replica behind NAT deliver the same ``/snapshot.json`` body the
scraper would have fetched — it enters the same clamped-counter merge
path and the same staleness contract; and **fleet-level multiburn
alerting** (``FleetConfig(multiburn=...)``) folds each merge's delta
of the summed attained/missed counters into a 5 m + 1 h
:class:`~raft_tpu_torch.serving.metrics.MultiBurnAlert` pair published as
``fleet.slo.burn_rate.{5m,1h}`` / ``fleet.slo.alert`` — the page
condition at deployment scope, where one burning replica hides inside
N−1 healthy peers' averages.

Staleness contract: a replica whose scrape fails keeps serving its
last snapshot until ``staleness_s``, then drops unhealthy. CUMULATIVE
surfaces (counters, probe planes) retain the stale replica's
last-known values — they are monotone lower bounds on truth, and
dropping them would make fleet counters jump backwards. WINDOWED and
instantaneous surfaces (recall, drift, admission gauges, histograms)
come from healthy replicas only — stale window contents are not
current state.

The merged view serves as ``/fleet.json`` plus a ``replica=``-labeled
and fleet-aggregate Prometheus exposition through the aggregator's
own :class:`~raft_tpu_torch.serving.exporter.MetricsExporter`
(``MetricsExporter(fleet=...)``). Clock discipline (graftlint R7):
staleness ages come from the injected clock; host-sync discipline
(R5): everything here is urllib + dict work — no device anywhere.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import re
import threading
import urllib.request
from typing import Dict, List, Optional, Tuple

from raft_tpu_torch.core import tracing
from raft_tpu_torch.serving.batcher import MonotonicClock
from raft_tpu_torch.serving.flight import window_quantile
from raft_tpu_torch.serving.gauge import wilson_interval
from raft_tpu_torch.serving.metrics import MultiBurnAlert, MultiBurnConfig

SCRAPES = "fleet.scrapes"
SCRAPE_ERRORS = "fleet.scrape_errors"
MONOTONICITY_VIOLATIONS = "fleet.monotonicity_violations"
BOUND_MISMATCHES = "fleet.histogram_bound_mismatches"
PUSHES = "fleet.pushes"

# names/labels that reach gauge registry names (and from there
# Prometheus label values) must stay one dot-free segment of safe
# characters — push names and pushed memory labels arrive off the
# network, where a quote or newline in a label value is an exposition
# forgery, not a spelling (same discipline as MemoryLedger.watch)
_LABEL_SUB = re.compile(r"[^A-Za-z0-9_:-]").sub
_LABEL_MAX = 64

# at most this many pushed/merged per-index memory labels publish as
# fleet gauges per merge (largest residents win): gauges are
# process-lifetime, so unbounded label cardinality from ONE replica's
# snapshot body would grow every exposition forever (the same leak
# the top-N probe gauges and the params-class cap close)
MEMORY_LABEL_CAP = 32


def _safe_label(name: str) -> str:
    return _LABEL_SUB("-", str(name))[:_LABEL_MAX] or "unnamed"


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """``staleness_s`` bounds how long a failed replica's last
    snapshot keeps representing it; ``timeout_s`` is the per-replica
    HTTP fetch timeout (a hung replica must not stall the whole fleet
    scrape past it). ``multiburn`` arms fleet-level burn-rate
    alerting: per merge, the deltas of the summed replica
    attained/missed counters fold into a 5 m + 1 h
    :class:`~raft_tpu_torch.serving.metrics.MultiBurnAlert` pair published
    under ``fleet.slo.*`` — the page condition at deployment scope,
    where one replica's burn can hide inside N−1 healthy peers'
    averages (None keeps fleet alerting off)."""

    staleness_s: float = 60.0
    timeout_s: float = 2.0
    multiburn: Optional[MultiBurnConfig] = None
    # push mode auto-registers unseen replica names; the endpoint is
    # network-reachable, so the registry must be bounded — a client
    # minting a fresh name per request would otherwise grow the
    # aggregator (and every merge/exposition walk) without limit
    max_push_replicas: int = 64


@dataclasses.dataclass
class ReplicaState:
    """One replica's scrape bookkeeping (all timestamps clock-domain).
    ``push: True`` marks a push-mode replica: it is never
    fetched — its snapshots arrive via ``POST /push`` — but ages,
    merges, and goes stale exactly like a scraped one."""

    name: str
    url: str
    snapshot: Optional[dict] = None
    scraped_at: Optional[float] = None
    scrapes: int = 0
    errors: int = 0
    last_error: Optional[str] = None
    push: bool = False

    def age_s(self, now: float) -> float:
        return (float("inf") if self.scraped_at is None
                else now - self.scraped_at)

    def healthy(self, now: float, staleness_s: float) -> bool:
        return self.snapshot is not None and \
            self.age_s(now) <= staleness_s


@dataclasses.dataclass(frozen=True)
class ProbePlaneView:
    """One merged probe plane, typed (graftroute's planner input —
    the planner must never parse the ``/fleet.json`` dict by string
    key). ``counts`` is the elementwise sum over every replica that
    ever reported the label (stale last-known retained — the plane
    is cumulative, like the counters); ``stale_replicas`` names the
    contributors whose snapshot is past the staleness horizon."""

    label: str
    counts: Tuple[int, ...]
    replicas: Tuple[str, ...]
    stale_replicas: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class ReplicaHeadroom:
    """One replica's memory headroom, typed, with the staleness
    metadata a planner needs to discount it. ``headroom_bytes`` is
    None when the replica is stale or reported no (finite) headroom
    — absence of evidence, never a guessed number."""

    name: str
    headroom_bytes: Optional[float]
    age_s: Optional[float]
    healthy: bool
    push: bool


def _http_fetch(url: str, timeout: float) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode())


def merge_histograms(snaps: List[dict]) -> Optional[dict]:
    """Bucket-wise merge of same-bounds histogram snapshots (the
    :meth:`~raft_tpu_torch.core.tracing.Histogram.snapshot` shape):
    cumulative bucket vectors sum elementwise, quantiles recompute
    from the merged distribution. None when no snapshot matches the
    first one's bounds (callers count the mismatch)."""
    snaps = [s for s in snaps if s and s.get("bucket_bounds")]
    if not snaps:
        return None
    bounds = list(snaps[0]["bucket_bounds"])
    merged = [s for s in snaps if list(s["bucket_bounds"]) == bounds]
    cum = [0] * (len(bounds) + 1)
    count, total = 0, 0.0
    for s in merged:
        for i, c in enumerate(s["bucket_counts"]):
            cum[i] += c
        count += s["count"]
        total += s["sum"]
    return {
        "count": count,
        "sum": total,
        "p50": window_quantile(bounds, cum, 0.50),
        "p95": window_quantile(bounds, cum, 0.95),
        "p99": window_quantile(bounds, cum, 0.99),
        "bucket_bounds": bounds,
        "bucket_counts": cum,
        "replicas": len(merged),
        "dropped_bound_mismatch": len(snaps) - len(merged),
    }


class FleetAggregator:
    """Scrape-and-merge federation over N replica exporters.

    ``replicas`` maps replica names to their ``/snapshot.json`` URLs
    (a bare base URL gets the path appended); a plain list of URLs
    auto-names them ``r0..rN``. ``fetch`` overrides the HTTP fetch
    (tests and fixtures inject ``fetch(url, timeout) -> dict``).

    Example::

        agg = FleetAggregator({"a": "http://10.0.0.1:9100",
                               "b": "http://10.0.0.2:9100"})
        exp = MetricsExporter(fleet=agg, port=9200)
        # curl :9200/fleet.json   — the merged fleet view
        # curl :9200/metrics      — replica=-labeled + fleet families
    """

    def __init__(self, replicas, *,
                 config: Optional[FleetConfig] = None, clock=None,
                 fetch=None):
        self.config = config or FleetConfig()
        self._clock = clock if clock is not None else MonotonicClock()
        self._fetch = fetch if fetch is not None else _http_fetch
        if not isinstance(replicas, dict):
            replicas = {f"r{i}": u for i, u in enumerate(replicas)}
        self._lock = threading.Lock()
        self._states: Dict[str, ReplicaState] = {}  # guarded-by: _lock
        for name, url in replicas.items():
            if not url.endswith(".json"):
                url = url.rstrip("/") + "/snapshot.json"
            self._states[name] = ReplicaState(name=name, url=url)
        # per-(replica, counter) high-water marks: the monotonicity
        # assertion — a fleet counter can never go backwards, however
        # a replica's registries were reset mid-scrape
        self._high: Dict[str, Dict[str, float]] = {  # guarded-by: _lock
            name: {} for name in self._states}
        # the last merged view (set by merge()): the exposition path
        # renders from it instead of re-running the whole merge —
        # /metrics already merged once in fleet_snapshot()
        self._last_merged: Optional[dict] = None  # guarded-by: _lock
        # fleet-level multiburn alerting: the merged
        # attained/missed sums' last-seen values, and the paired
        # windows the per-merge deltas fold into. The fleet sums are
        # monotone by construction (high-water clamped), so the
        # deltas are non-negative however replicas restart.
        self._burn: Optional[MultiBurnAlert] = None
        self._burn_prev: Optional[Dict[str, float]] = None
        if self.config.multiburn is not None:
            self._burn = MultiBurnAlert(self.config.multiburn,
                                        prefix="fleet.slo.")

    # -- scraping -----------------------------------------------------------

    def _clamp_counters_locked(self, name: str, snap: dict) -> None:
        """Fold one snapshot's lifetime counters into the replica's
        high-water marks. The LIFETIME ledger is the source — the
        resettable live ``counters`` view is only a fallback for
        payloads predating it — and any regression (replica restart)
        clamps to the mark rather than dragging the fleet sum down."""
        counters = snap.get("counters_lifetime")
        if not isinstance(counters, dict):
            counters = snap.get("counters") or {}
        high = self._high[name]
        for cname, v in counters.items():
            try:
                v = float(v)
            except (TypeError, ValueError):
                continue
            if not math.isfinite(v):
                # JSON `1e999` parses to inf: ratcheting a high-water
                # mark to inf (or NaN) would poison every future
                # fleet sum — and the multiburn delta's int() —
                # irreversibly. Off the network, non-finite is
                # garbage, not a measurement.
                continue
            prev = high.get(cname, 0.0)
            if v < prev:
                tracing.inc_counter(MONOTONICITY_VIOLATIONS)
            high[cname] = max(prev, v)

    def scrape(self, now: Optional[float] = None) -> int:
        """Fetch every replica's snapshot once — CONCURRENTLY, so N
        hung replicas stall the whole scrape by ~one ``timeout_s``,
        not N of them stacked (the scrape runs inside the exporter's
        ``/metrics`` handler; a partial outage must not push the
        aggregator's own exposition past the Prometheus scrape
        timeout exactly when the fleet view matters most). Returns
        the healthy count. A failed fetch keeps the replica's
        previous snapshot (bounded by ``staleness_s`` at merge time)
        and counts into its error tally + ``fleet.scrape_errors``."""
        if now is None:
            now = self._clock.now()
        tracing.inc_counter(SCRAPES)
        # push-mode replicas are never fetched — their snapshots
        # arrive through push(); they still count into health below.
        # snapshot the replica list under the lock: a concurrent
        # push() registering a new replica mutates the dict
        with self._lock:
            states = [s for s in self._states.values() if not s.push]
            all_states = list(self._states.values())
        if not states:
            results = []
        elif len(states) == 1:
            results = [self._fetch_one(states[0])]
        else:
            with concurrent.futures.ThreadPoolExecutor(
                    max_workers=min(8, len(states))) as pool:
                results = list(pool.map(self._fetch_one, states))
        healthy = 0
        for state, (snap, err) in zip(states, results):
            if err is not None:
                state.errors += 1
                state.last_error = err
                tracing.inc_counter(SCRAPE_ERRORS)
                continue
            with self._lock:
                state.snapshot = snap
                state.scraped_at = now
                state.scrapes += 1
                self._clamp_counters_locked(state.name, snap)
        for state in all_states:
            if state.healthy(now, self.config.staleness_s):
                healthy += 1
        return healthy

    def push(self, name: str, snapshot: dict,
             now: Optional[float] = None) -> None:
        """Accept one pushed snapshot from replica ``name`` (the
        ``POST /push`` body — the same JSON the replica would serve
        at ``/snapshot.json``). Unknown names auto-register as
        push-mode replicas; a pushed snapshot enters the SAME
        clamped-counter bookkeeping a scrape does, so every merge
        semantic — lifetime-ledger sums, monotonicity, staleness —
        applies unchanged. A NAT replica that stops pushing simply
        goes stale after ``staleness_s``. At most
        ``config.max_push_replicas`` push-mode names may register
        (``ValueError`` past the cap — the endpoint is network-
        reachable, and an unbounded registry would let one
        name-minting client grow every merge walk forever)."""
        if not isinstance(snapshot, dict):
            raise ValueError(
                f"push for {name!r} got {type(snapshot).__name__}, "
                "not a snapshot dict")
        # the name reaches gauge registry names and Prometheus label
        # values — sanitize it the way MemoryLedger.watch does (a
        # quote/newline off the network is exposition forgery)
        name = _safe_label(name)
        if now is None:
            now = self._clock.now()
        with self._lock:
            state = self._states.get(name)
            if state is not None and not state.push:
                # an unauthenticated push must never impersonate a
                # configured scrape replica: overwriting its snapshot
                # would ratchet its monotone high-water counters with
                # whatever the pusher claims, irreversibly
                raise ValueError(
                    f"replica {name!r} is scrape-mode: refusing a "
                    "pushed snapshot for it")
            if state is None:
                pushed = sum(1 for s in self._states.values() if s.push)
                if pushed >= self.config.max_push_replicas:
                    raise ValueError(
                        f"push replica limit reached "
                        f"({self.config.max_push_replicas}): refusing "
                        f"to register {name!r}")
                state = ReplicaState(name=name, url=f"push:{name}",
                                     push=True)
                self._states[name] = state
                self._high.setdefault(name, {})
            tracing.inc_counter(PUSHES)
            state.snapshot = snapshot
            state.scraped_at = now
            state.scrapes += 1
            self._clamp_counters_locked(name, snapshot)

    def _fetch_one(self, state: ReplicaState) -> tuple:
        """(snapshot, None) or (None, error-text) — one replica's
        fetch, exception-safe (one dead replica must not fail the
        fleet scrape; pool.map would re-raise)."""
        try:
            snap = self._fetch(state.url, self.config.timeout_s)
            if not isinstance(snap, dict):
                raise ValueError(
                    f"replica {state.name} returned "
                    f"{type(snap).__name__}, not a snapshot dict")
            return snap, None
        except Exception as e:  # noqa: BLE001
            return None, f"{type(e).__name__}: {e}"

    # -- merging (pure functions of the scraped state) ----------------------

    def _merge_locked(self, now: float) -> dict:
        cfg = self.config
        states = list(self._states.values())
        healthy = [s for s in states
                   if s.healthy(now, cfg.staleness_s)]
        out: dict = {
            "size": len(states),
            "healthy": len(healthy),
            "replicas": {
                s.name: {
                    "url": s.url,
                    "healthy": s.healthy(now, cfg.staleness_s),
                    "age_s": (None if s.scraped_at is None
                              else now - s.scraped_at),
                    "scrapes": s.scrapes,
                    "errors": s.errors,
                    "last_error": s.last_error,
                } for s in states},
        }
        # counters: lifetime-ledger sums over the high-water marks —
        # stale replicas retain their last-known (monotone lower
        # bound) contribution; see the module docstring
        counters: Dict[str, float] = {}
        for name, high in self._high.items():
            for cname, v in high.items():
                counters[cname] = counters.get(cname, 0.0) + v
        out["counters"] = counters
        # tiering (graftcast): the placement + prefetch
        # counters already entered the monotone clamped sums above —
        # restate them as one structured block (the /fleet.json
        # surface an operator reads for fleet-wide tier behaviour),
        # with the derived prefetch hit rate. A replica predating
        # tiering simply contributes zeros.
        tier = {
            "epochs": counters.get("tier.epochs", 0.0),
            "promotions": counters.get("tier.promotions", 0.0),
            "demotions": counters.get("tier.demotions", 0.0),
            "prefetch": {
                k: counters.get(f"tier.prefetch.{k}", 0.0)
                for k in ("issued", "hits", "misses", "cancelled")},
        }
        pf_total = (tier["prefetch"]["hits"]
                    + tier["prefetch"]["misses"])
        tier["prefetch"]["hit_rate"] = (
            tier["prefetch"]["hits"] / pf_total if pf_total else None)
        out["tier"] = tier
        # histograms: bucket-wise merge over HEALTHY replicas
        names: set = set()
        for s in healthy:
            names.update((s.snapshot.get("histograms") or {}))
        hists = {}
        for hname in sorted(names):
            snaps = [(s.snapshot.get("histograms") or {}).get(hname)
                     for s in healthy]
            merged = merge_histograms([h for h in snaps if h])
            if merged is None:
                continue
            if merged.pop("dropped_bound_mismatch", 0):
                tracing.inc_counter(BOUND_MISMATCHES)
            hists[hname] = merged
        out["histograms"] = hists
        # probe planes: elementwise sums (stale last-known retained —
        # cumulative, like the counters) -> fleet hot/cold coverage
        planes: Dict[str, List[int]] = {}
        for s in states:
            if s.snapshot is None:
                continue
            fed = s.snapshot.get("federation") or {}
            for label, plane in (fed.get("probe_planes") or {}).items():
                acc = planes.setdefault(label, [0] * len(plane))
                if len(acc) != len(plane):
                    continue
                for i, v in enumerate(plane):
                    acc[i] += int(v)
        out["probe_freq"] = {
            label: tracing.probe_freq_stats(plane)
            for label, plane in planes.items()}
        # recall: pool raw trials over healthy replicas, THEN Wilson
        pooled: Dict[str, Dict[str, int]] = {}
        for s in healthy:
            fed = s.snapshot.get("federation") or {}
            for key, raw in (fed.get("recall") or {}).items():
                acc = pooled.setdefault(
                    key, {"hits": 0, "trials": 0, "pairs": 0})
                for k in acc:
                    acc[k] += int(raw.get(k, 0))
        recall = {}
        for key, acc in pooled.items():
            lo, hi = wilson_interval(acc["hits"], acc["trials"])
            recall[key] = {
                **acc,
                "estimate": (acc["hits"] / acc["trials"]
                             if acc["trials"] else 0.0),
                "ci_low": lo, "ci_high": hi,
            }
        out["recall"] = recall
        # drift: re-score the pooled live histogram vs pooled
        # baseline. Each replica's live histogram is NORMALIZED (its
        # DriftDetector EWMA-folds per-window distributions), so it
        # must be scaled by the replica's ``traffic`` weight before
        # summing — otherwise an idle replica weighs the same as one
        # carrying 99% of fleet traffic and a heavily-drifted busy
        # replica gets averaged away by quiet healthy peers. Payloads
        # predating the weight fall back to 1.0 (equal weight).
        drift_live: Dict[str, List[float]] = {}
        drift_base: Dict[str, List[float]] = {}
        for s in healthy:
            fed = s.snapshot.get("federation") or {}
            for iname, st in (fed.get("drift") or {}).items():
                base = st.get("baseline") or []
                live = st.get("live")
                acc_b = drift_base.setdefault(iname, [0.0] * len(base))
                if len(acc_b) == len(base):
                    for i, v in enumerate(base):
                        acc_b[i] += float(v)
                if live is not None:
                    w = float(st.get("traffic", 1.0)) or 1.0
                    acc_l = drift_live.setdefault(
                        iname, [0.0] * len(live))
                    if len(acc_l) == len(live):
                        for i, v in enumerate(live):
                            acc_l[i] += w * float(v)
        out["drift"] = {
            iname: {
                "score": tracing.js_divergence(
                    drift_live.get(iname, []), base),
                "replicas": sum(
                    1 for s in healthy
                    if iname in ((s.snapshot.get("federation") or {})
                                 .get("drift") or {})),
            }
            for iname, base in drift_base.items()}
        # admission: depth/rate sum (fleet-wide queue pressure), shed
        # level is a rung — the fleet's worst rung is the signal
        depth = rate = 0.0
        shed = 0
        for s in healthy:
            adm = s.snapshot.get("admission") or {}
            depth += float(adm.get("queue_depth", 0))
            rate += float(adm.get("arrival_rate_hz", 0.0))
            shed = max(shed, int(adm.get("shed_level", 0)))
        out["admission"] = {"queue_depth": depth,
                            "arrival_rate_hz": rate,
                            "max_shed_level": shed}
        # memory (graftledger): instantaneous state, so healthy
        # replicas only. Resident bytes SUM (each replica holds its
        # own copy — the fleet figure is what the deployment spends);
        # headroom takes the MIN over replicas that measured one
        # (null headroom = no live stats; ignorance must not read as
        # infinite room). Replicas predating the memory block — or
        # running without a ledger — are skipped and counted, never
        # guessed at.
        # every field is validated per value, like the counter clamp:
        # snapshots arrive from scrapes AND the network-reachable
        # POST /push — one replica's malformed memory block must cost
        # that replica's contribution, never the whole fleet merge
        def _num(v, default=None):
            try:
                v = float(v)
            except (TypeError, ValueError):
                return default
            # non-finite values (JSON 1e999 -> inf) would poison the
            # sums, break the label-cap sort (NaN is unordered), and
            # corrupt headroom_min — garbage, not a measurement
            return v if math.isfinite(v) else default

        mem_resident: Dict[str, float] = {}
        mem_total = 0.0
        replica_headroom: Dict[str, float] = {}
        forecast_max = 0.0
        reporting = 0
        for s in healthy:
            mem = s.snapshot.get("memory")
            if not isinstance(mem, dict):
                continue
            reporting += 1
            mem_total += _num(mem.get("resident_total_bytes"), 0.0)
            resident = mem.get("resident")
            if isinstance(resident, dict):
                for label, b in resident.items():
                    b = _num(b)
                    if b is not None:
                        label = _safe_label(label)
                        mem_resident[label] = \
                            mem_resident.get(label, 0.0) + b
            forecast_max = max(
                forecast_max, _num(mem.get("forecast_peak_bytes"), 0.0))
            room = _num(mem.get("headroom_bytes"))
            if room is not None:
                replica_headroom[s.name] = room
        headroom_min_replica = (
            min(replica_headroom, key=replica_headroom.get)
            if replica_headroom else None)
        out["memory"] = {
            "replicas_reporting": reporting,
            "resident_bytes": mem_total,
            "resident": mem_resident,
            "forecast_peak_max_bytes": forecast_max,
            "headroom_min_bytes": (
                replica_headroom[headroom_min_replica]
                if headroom_min_replica is not None else None),
            "headroom_min_replica": headroom_min_replica,
            "replica_headroom_bytes": replica_headroom,
        }
        return out

    def merge(self, now: Optional[float] = None) -> dict:
        """The merged fleet view from the current scraped state (no
        fetches) — pure of everything but the stored snapshots, so
        the fixture tests pin it exactly."""
        if now is None:
            now = self._clock.now()
        with self._lock:
            out = self._merge_locked(now)
            self._last_merged = out
            delta = None
            if self._burn is not None:
                # fleet-level multiburn: claim this merge's
                # delta of the summed attained/missed counters UNDER
                # the lock — concurrent merges (ThreadingHTTPServer
                # serves /metrics and /fleet.json in parallel) must
                # each fold a DISJOINT slice, or the same outcomes
                # enter the windows twice and inflate the burn rate.
                # The fleet sums are high-water clamped, so deltas are
                # non-negative however replicas restart; the outcomes
                # were counted in their replica processes —
                # record_batch windows them without re-counting.
                cur = {k: out["counters"].get(k, 0.0)
                       for k in ("serving.slo.attained",
                                 "serving.slo.missed")}
                prev = self._burn_prev or {k: cur[k] for k in cur}
                self._burn_prev = cur
                delta = (int(cur["serving.slo.attained"]
                             - prev["serving.slo.attained"]),
                         int(cur["serving.slo.missed"]
                             - prev["serving.slo.missed"]))
        if self._burn is not None:
            # the fold itself runs outside the aggregator lock (the
            # windows carry their own locks; disjoint deltas compose)
            self._burn.record_batch(now, *delta)
            out["slo"] = {
                "burn_rates": dict(zip(
                    (self.config.multiburn.short_label,
                     self.config.multiburn.long_label),
                    self._burn.burn_rates(now))),
                "alert": self._burn.alert(now),
            }
        self._publish(out)
        return out

    def _publish(self, merged: dict) -> None:
        """Re-publish the fleet gauges into the aggregator process's
        own registries (its exporter renders them labeled). Stale
        per-replica and memory gauges retire FIRST: a replica that
        stopped reporting (or was dropped) must not keep advertising
        its last headroom — that is exactly the stale room an
        operator would place the hot tier on."""
        tracing.reset_gauges("fleet.replica.")
        tracing.reset_gauges("fleet.memory.")
        vals = {
            "fleet.replicas": float(merged["size"]),
            "fleet.replicas_healthy": float(merged["healthy"]),
        }
        for name, r in merged["replicas"].items():
            base = f"fleet.replica.{name}."
            vals[base + "healthy"] = 1.0 if r["healthy"] else 0.0
            vals[base + "age_s"] = (-1.0 if r["age_s"] is None
                                    else r["age_s"])
            vals[base + "errors"] = float(r["errors"])
        for label, stats in merged["probe_freq"].items():
            base = f"fleet.probe_freq.{label}."
            for k in ("total", "probed_fraction", "coverage_p01",
                      "coverage_p10"):
                vals[base + k] = float(stats[k])
        live = merged["recall"].get("live")
        if live:
            vals.update({
                "fleet.recall.estimate": live["estimate"],
                "fleet.recall.ci_low": live["ci_low"],
                "fleet.recall.ci_high": live["ci_high"],
                "fleet.recall.trials": float(live["trials"]),
            })
        for iname, d in merged["drift"].items():
            vals[f"fleet.drift.{iname}.score"] = d["score"]
        tier = merged.get("tier") or {}
        pf = tier.get("prefetch") or {}
        if tier.get("epochs") or pf.get("issued"):
            for k in ("epochs", "promotions", "demotions"):
                vals[f"fleet.tier.{k}"] = float(tier[k])
            for k in ("issued", "hits", "misses", "cancelled"):
                vals[f"fleet.tier.prefetch.{k}"] = float(pf[k])
            if pf.get("hit_rate") is not None:
                vals["fleet.tier.prefetch.hit_rate"] = pf["hit_rate"]
        mem = merged.get("memory") or {}
        if mem.get("replicas_reporting"):
            vals["fleet.memory.replicas_reporting"] = float(
                mem["replicas_reporting"])
            vals["fleet.memory.resident_bytes"] = mem["resident_bytes"]
            vals["fleet.memory.forecast_peak_max_bytes"] = \
                mem["forecast_peak_max_bytes"]
            if mem.get("headroom_min_bytes") is not None:
                vals["fleet.memory.headroom_min_bytes"] = \
                    mem["headroom_min_bytes"]
            # per-index gauges: at most MEMORY_LABEL_CAP publish
            # (largest residents win) — gauges are process-lifetime,
            # and label cardinality here is replica-supplied (see the
            # cap's comment above; stale labels retired by the
            # fleet.memory. reset above)
            resident = sorted(mem.get("resident", {}).items(),
                              key=lambda kv: -kv[1])
            for label, b in resident[:MEMORY_LABEL_CAP]:
                vals[f"fleet.memory.index.{label}.resident_bytes"] = b
            # per-replica headroom rides the existing replica=-labeled
            # family machinery (fleet.replica.<name>.<field>)
            for rname, room in mem.get("replica_headroom_bytes",
                                       {}).items():
                vals[f"fleet.replica.{rname}.headroom_bytes"] = room
        tracing.set_gauges(vals)

    def fleet_snapshot(self, now: Optional[float] = None) -> dict:
        """One scrape + merge — the ``/fleet.json`` body."""
        if now is None:
            now = self._clock.now()
        self.scrape(now)
        return self.merge(now)

    # -- typed accessors (graftroute planner inputs) -------------------------

    def merged_probe_plane(self, label: str,
                           now: Optional[float] = None
                           ) -> ProbePlaneView:
        """The merged probe plane for ``label``, typed — same
        elementwise-sum semantics as the ``/fleet.json`` merge
        (stale last-known retained; the plane is cumulative), read
        from the STORED snapshots (no fetch). Raises ``LookupError``
        when no replica ever reported the label."""
        if now is None:
            now = self._clock.now()
        stale_s = self.config.staleness_s
        acc: Optional[List[int]] = None
        contrib: List[str] = []
        stale: List[str] = []
        with self._lock:
            states = sorted(self._states.values(),
                            key=lambda s: s.name)
            for s in states:
                if s.snapshot is None:
                    continue
                fed = s.snapshot.get("federation") or {}
                plane = (fed.get("probe_planes") or {}).get(label)
                if plane is None:
                    continue
                if acc is None:
                    acc = [0] * len(plane)
                if len(acc) != len(plane):
                    continue
                for i, v in enumerate(plane):
                    acc[i] += int(v)
                contrib.append(s.name)
                if not s.healthy(now, stale_s):
                    stale.append(s.name)
        if acc is None:
            raise LookupError(
                f"no replica reported probe plane {label!r}")
        return ProbePlaneView(label=label, counts=tuple(acc),
                              replicas=tuple(contrib),
                              stale_replicas=tuple(stale))

    def probe_plane_labels(self) -> Tuple[str, ...]:
        """Every probe-plane label any replica ever reported."""
        labels: set = set()
        with self._lock:
            for s in self._states.values():
                if s.snapshot is None:
                    continue
                fed = s.snapshot.get("federation") or {}
                labels.update(fed.get("probe_planes") or {})
        return tuple(sorted(labels))

    def replica_headroom(self, now: Optional[float] = None
                         ) -> Tuple[ReplicaHeadroom, ...]:
        """Per-replica memory headroom, typed, sorted by name — one
        entry per REGISTERED replica (unreported/stale headroom is
        None with the staleness metadata attached, so a planner can
        tell 'no room' from 'no evidence')."""
        if now is None:
            now = self._clock.now()
        stale_s = self.config.staleness_s
        out: List[ReplicaHeadroom] = []
        with self._lock:
            states = sorted(self._states.values(),
                            key=lambda s: s.name)
            for s in states:
                ok = s.healthy(now, stale_s)
                room = None
                if ok:
                    mem = s.snapshot.get("memory")
                    if isinstance(mem, dict):
                        v = mem.get("headroom_bytes")
                        try:
                            v = float(v)
                        except (TypeError, ValueError):
                            v = None
                        if v is not None and math.isfinite(v):
                            room = v
                age = None if s.scraped_at is None \
                    else now - s.scraped_at
                out.append(ReplicaHeadroom(
                    name=s.name, headroom_bytes=room, age_s=age,
                    healthy=ok, push=s.push))
        return tuple(out)

    def replica_health(self, now: Optional[float] = None
                       ) -> Dict[str, bool]:
        """Replica name → healthy (the router's steer gate)."""
        if now is None:
            now = self._clock.now()
        stale_s = self.config.staleness_s
        with self._lock:
            return {s.name: s.healthy(now, stale_s)
                    for s in self._states.values()}

    # -- Prometheus exposition ----------------------------------------------

    def prometheus_text(self, now: Optional[float] = None) -> str:
        """``replica=``-labeled and fleet-aggregate exposition of the
        federated counters and histograms (appended to the attached
        exporter's ``/metrics`` body; the fleet gauges themselves ride
        the normal registry rendering). Every federated family is
        ``fleet_``-prefixed so it can never collide with a same-named
        family of the aggregator process's OWN registries in one
        exposition body. Per family: one sample per replica carrying
        its clamped lifetime value, plus the ``replica="fleet"`` sum —
        so dashboards slice per replica or fleet-wide with one PromQL
        label matcher."""
        from raft_tpu_torch.serving.exporter import _fmt, help_text, prom_name

        if now is None:
            now = self._clock.now()
        with self._lock:
            # reuse the merge the preceding fleet_snapshot() already
            # ran (the exporter calls them back to back) — merging
            # every histogram twice per scrape doubles the handler's
            # blocking work for nothing; standalone callers without a
            # prior merge still get a fresh one
            merged = (self._last_merged if self._last_merged is not None
                      else self._merge_locked(now))
            per_replica = {name: dict(high)
                           for name, high in self._high.items()}
            healthy = [s.name for s in self._states.values()
                       if s.healthy(now, self.config.staleness_s)]
            rep_hists = {
                s.name: dict(s.snapshot.get("histograms") or {})
                for s in self._states.values()
                if s.name in healthy}
        lines = []
        for cname in sorted(merged["counters"]):
            pn = "fleet_" + prom_name(cname)
            lines.append(f"# HELP {pn} {help_text(cname)}")
            lines.append(f"# TYPE {pn} counter")
            for rname in sorted(per_replica):
                v = per_replica[rname].get(cname)
                if v is not None:
                    lines.append(f'{pn}{{replica="{rname}"}} {_fmt(v)}')
            lines.append(f'{pn}{{replica="fleet"}} '
                         f'{_fmt(merged["counters"][cname])}')
        for hname in sorted(merged["histograms"]):
            pn = "fleet_" + prom_name(hname)
            lines.append(f"# HELP {pn} {help_text(hname)}")
            lines.append(f"# TYPE {pn} histogram")
            samples = [(rname, rep_hists[rname][hname])
                       for rname in sorted(rep_hists)
                       if hname in rep_hists[rname]]
            samples.append(("fleet", merged["histograms"][hname]))
            for rname, snap in samples:
                pre = f'replica="{rname}",'
                for le, c in zip(snap.get("bucket_bounds", []),
                                 snap.get("bucket_counts", [])):
                    lines.append(
                        f'{pn}_bucket{{{pre}le="{_fmt(le)}"}} {c}')
                lines.append(f'{pn}_bucket{{{pre}le="+Inf"}} '
                             f'{snap["count"]}')
                lines.append(f'{pn}_sum{{replica="{rname}"}} '
                             f'{_fmt(snap["sum"])}')
                lines.append(f'{pn}_count{{replica="{rname}"}} '
                             f'{snap["count"]}')
        return "\n".join(lines) + "\n" if lines else ""
