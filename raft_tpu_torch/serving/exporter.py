"""Pull-based export surface — the port of
``raft_tpu/serving/exporter.py``: one stdlib ``http.server`` port serving
every observability signal in the process. Device-free: it reads the
registries and the attached objects.

Endpoints:

- ``/metrics`` — Prometheus text exposition (version 0.0.4): every
  :mod:`raft_tpu_torch.core.tracing` counter and gauge, plus the latency
  histograms with CUMULATIVE bucket counts (``*_bucket{le="..."}`` /
  ``*_sum`` / ``*_count``) — scrapeable by any Prometheus-compatible
  agent. Metric names are the registry names with non-identifier
  characters folded to ``_`` (``serving.batcher.e2e_seconds`` →
  ``serving_batcher_e2e_seconds``).
- ``/snapshot.json`` — the JSON view: ``serving.metrics.snapshot()``
  (counters, gauges, histograms, occupancy, derived achieved GB/s),
  the attached executor's per-executable cost table, the attached
  batcher's degradation-ladder rung, and flight-recorder stats.
- ``/trace.json`` — the span ring as Chrome trace-event JSON; load it
  into Perfetto next to a ``torch.profiler`` capture to overlay host
  stage spans on the device timeline. ``?trace_id=N`` restricts
  the dump to one request's journey — per-request fetches stop paying
  for the whole ring; an unknown id returns an empty (valid) trace.
- ``/profile?seconds=N`` — on-demand ``torch.profiler`` capture:
  gated on a ``profile_dir`` configured at construction (403 when
  absent — a scraper must not be able to write the service's disk), one
  capture at a time (409 while busy), N outside [0, 60] rejected with
  400 (no silent clamping — an operator asking for 120 s should learn
  the cap, not get a shorter capture than requested). Fetch
  ``/trace.json`` for the same window and open both in Perfetto — the
  automated version of the overlay recipe. The response carries the
  capture's ``trace_file`` path, so graftflight and operators
  can find what was just captured.
- ``/incident.json`` — the latest graftflight incident bundle:
  parsed device-truth attribution + span-ring snapshot + metrics
  snapshot + cost table + live shed rung, produced automatically when
  the multiburn alert or the latency-anomaly check fires (404 while no
  incident has been captured, or no :class:`~raft_tpu_torch.serving.flight
  .FlightRecorder` is attached).
- ``/fleet.json`` — the merged multi-replica view (graftfleet):
  with a :class:`~raft_tpu_torch.serving.federation.FleetAggregator`
  attached, one scrape-and-merge over every replica's
  ``/snapshot.json`` — lifetime-ledger counter sums, bucket-merged
  histograms, fleet probe coverage, pooled-Wilson recall, pooled
  drift, per-replica health (404 when no aggregator is attached).
  The federated families also append to ``/metrics`` as
  ``replica=``-labeled + fleet-aggregate samples.
- ``/memory.json`` — the graftledger memory truth: with a
  :class:`~raft_tpu_torch.core.memwatch.MemoryLedger` attached, the
  per-index resident-bytes model, live ``device.memory_stats()``
  truth (honest ``supported: false`` on backends without it), the
  reservation forecast, headroom, and the modeled-vs-live divergence
  (404 when no ledger is attached).
- ``/memory_profile`` — a gated snapshot of the caching allocator,
  ``torch.cuda.memory._snapshot()`` (pickled; an empty snapshot without
  a card), written into ``profile_dir``. The first request turns on
  ``torch.cuda.memory._record_memory_history``, so later snapshots name
  each allocation's site; :meth:`MetricsExporter.close` turns it off.
  Same gate (403 unarmed) and the same
  one-capture-at-a-time lock as ``/profile`` (409 while any capture
  runs, either direction). ``?diff=<seq>`` additionally
  parses THIS capture against the earlier sequence-numbered capture
  ``<seq>`` and returns the per-buffer-group byte deltas
  (:func:`raft_tpu_torch.core.memwatch.diff_memory_profiles`) — two
  captures bracketing a window attribute the divergence gauge to
  buffers instead of the whole process (400 on an unknown or
  malformed sequence number).
- ``/tier.json`` — the grafttier placement truth: with a
  :class:`~raft_tpu_torch.serving.placement.TierManager` attached, the
  live hot/cold layout, the last placement epoch's plan + evidence
  (window total, hot-window fraction) and the policy config (404
  when no manager is attached). The scrape also drives the
  manager's epoch pacing (``tick``), exactly like graftfleet's
  continuous capture.
- ``/route.json`` and ``POST /push?route=1`` — the routing table of an
  attached router (any object with the JAX package's ``snapshot`` /
  ``apply_table`` method names; 404 with none attached).
- ``POST /push?replica=<name>`` — federation push mode: with
  a :class:`~raft_tpu_torch.serving.federation.FleetAggregator` attached,
  a replica behind NAT POSTs its own ``/snapshot.json`` body here
  instead of being scraped; the snapshot enters the SAME type-correct
  merge path (400 without a replica name or a JSON-object body, 404
  without an aggregator).
- ``/healthz`` — liveness probe.

Prometheus label support: the per-executable cost gauges render
as ONE metric family per field with a ``digest`` label
(``serving_executable_peak_hbm_bytes{digest="..."}``) instead of a
metric name per executable, and the modeled collective payloads label
by ``family``/``wire``/``probe_wire`` — so dashboards aggregate across
executables with plain PromQL. The old flat names — the sha1-embedded
``serving_executable_<digest>_*`` AND the dotted
``serving_collective_<family>_<wire>_<probe_wire>_*`` spellings — are
kept for one release behind ``legacy_executable_metrics=True``
(deprecated; emitted *in addition* to the labeled families).

The exporter holds NO state of its own: every request re-reads the
live registries, so a scrape is always current and costs the serving
path nothing (the registries are the same dicts the hot path already
writes; the scrape takes the same short locks any reader takes). The
server runs on a daemon thread; ``port=0`` binds an ephemeral port
(tests), a fixed port is the production deployment.

Example::

    exp = MetricsExporter(executor=ex, batcher=b)
    port = exp.start()
    # curl http://127.0.0.1:<port>/metrics
    exp.close()
"""

from __future__ import annotations

import http.server
import json
import re
import threading
import time
import urllib.parse
from typing import Optional

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.validation import RaftError
from raft_tpu_torch.serving import metrics as serving_metrics

_NAME_SUB = re.compile(r"[^a-zA-Z0-9_:]").sub

# registry names that render as LABELED Prometheus families:
# one family per field, one sample per digest / wire combination
_EXEC_GAUGE = re.compile(
    r"^serving\.executable\.([0-9a-f]+)\.([a-z_]+)$")
_COLLECTIVE_GAUGE = re.compile(
    r"^serving\.collective\.([^.]+)\.([^.]+)\.([^.]+)\.([a-z_]+)$")
# graftgauge labeled families: per-index probe-frequency
# top-N samples + summary fields, index-health stats, drift scores —
# the label value is the dot-free <label>/<name> segment
_PROBE_LIST_GAUGE = re.compile(
    r"^index\.probe_freq\.([^.]+)\.list\.([0-9]+)$")
_PROBE_GAUGE = re.compile(
    r"^index\.probe_freq\.([^.]+)\.([a-z0-9_]+)$")
_HEALTH_GAUGE = re.compile(
    r"^index\.health\.([^.]+)\.([a-z0-9_]+)$")
_DRIFT_GAUGE = re.compile(
    r"^index\.drift\.([^.]+)\.(score|alert|rebaselines)$")
# graftfleet labeled families: per-replica health gauges the
# aggregator publishes, fleet probe coverage + drift per index
_FLEET_REPLICA_GAUGE = re.compile(
    r"^fleet\.replica\.([^.]+)\.([a-z0-9_]+)$")
_FLEET_PROBE_GAUGE = re.compile(
    r"^fleet\.probe_freq\.([^.]+)\.([a-z0-9_]+)$")
_FLEET_DRIFT_GAUGE = re.compile(
    r"^fleet\.drift\.([^.]+)\.(score)$")
# graftledger labeled families: per-index resident-bytes
# model samples and per-device live memory truth
_MEM_INDEX_GAUGE = re.compile(
    r"^memory\.index\.([^.]+)\.([a-z0-9_]+)$")
_MEM_DEVICE_GAUGE = re.compile(
    r"^memory\.device\.([0-9]+)\.([a-z0-9_]+)$")
_FLEET_MEM_INDEX_GAUGE = re.compile(
    r"^fleet\.memory\.index\.([^.]+)\.(resident_bytes)$")
# graftroute labeled families: per-replica steer counts and planned
# hot-set sizes
_ROUTE_REPLICA_GAUGE = re.compile(
    r"^fleet\.route\.replica\.([^.]+)\.([a-z0-9_]+)$")
_PLAN_REPLICA_GAUGE = re.compile(
    r"^fleet\.plan\.replica\.([^.]+)\.([a-z0-9_]+)$")
# per-params-class latency histograms (graftflight satellite):
# serving.batcher.execute_seconds.p<NP> renders as the base family
# with a params_class label, pairing the sweep recall gauges
# (index.recall.sweep.p<NP>) with a latency axis
_HIST_CLASS = re.compile(
    r"^(serving\.batcher\.[a-z0-9_]+_seconds)\.(p[0-9]+)$")
# per-(params class, tile) pad-waste split counters :
# serving.execute.{rows,padded_rows}.p<NP>.t<TILE> render as labeled
# families DISTINCT from the flat aggregates (suffix _split — one
# family must not carry two HELP/TYPE headers), attributing pad waste
# to the small-vs-large dual-tile choice
_PAD_SPLIT = re.compile(
    r"^serving\.execute\.(rows|padded_rows)\.(p[0-9]+)\.t([0-9]+)$")

# HELP text per family prefix (longest match wins; the generic
# fallback keeps every family carrying *a* HELP line — the exposition
# satellite's parse-check requires one per family)
_HELP_PREFIXES = (
    ("serving.executable.", "per-executable compile-time cost analysis"),
    ("serving.collective.", "modeled mesh collective payload bytes"),
    ("serving.admission.", "admission-control state"),
    ("serving.batcher.", "dynamic micro-batcher stage metric"),
    ("serving.execute.", "executor dispatch accounting"),
    ("serving.mesh.", "mesh straggler attribution"),
    ("serving.slo.", "deadline-SLO attainment and burn rate"),
    ("serving.attribution.rolling.", "graftfleet rolling device-truth "
                                     "attribution (EWMA over "
                                     "continuous capture windows)"),
    ("serving.attribution.", "graftflight measured device-time "
                             "attribution totals"),
    ("serving.continuous.", "graftfleet continuous low-duty-cycle "
                            "capture scheduler"),
    ("serving.", "serving-path metric"),
    ("profiling.", "graftflight profiler-trace ingestion"),
    ("incident.", "graftflight incident-capture flight recorder"),
    ("continuous.", "graftfleet continuous-capture scheduling "
                    "accounting"),
    ("fleet.memory.", "graftledger federated memory view (headroom "
                      "min, resident sum)"),
    ("fleet.slo.", "graftledger fleet-level multiburn alert over the "
                   "merged SLO windows"),
    ("fleet.route.", "graftroute query routing (steer coverage, "
                     "fan-out, table lifecycle)"),
    ("fleet.plan.", "graftroute fleet placement planning"),
    ("fleet.", "graftfleet multi-replica federation"),
    ("memory.", "graftledger device-memory truth (resident model, "
                "live stats, reservation forecast)"),
    ("tier.", "grafttier hot/cold placement (layout, epoch policy, "
              "swap accounting)"),
    ("index.probe_freq.", "graftgauge per-list probe-frequency "
                          "accounting"),
    ("index.probe.", "graftgauge probe-accounting dispatch heartbeat"),
    ("index.health.", "graftgauge index-health stat"),
    ("index.recall.", "graftgauge online recall estimation"),
    ("index.drift.", "graftgauge query-drift detection"),
    ("xla.", "XLA backend compile accounting"),
)


def help_text(name: str) -> str:
    """One-line ``# HELP`` text for a registry (or family) name."""
    for prefix, text in _HELP_PREFIXES:
        if name.startswith(prefix):
            return text
    return "raft_tpu registry metric"


def prom_name(name: str) -> str:
    """Registry name → valid Prometheus metric name."""
    out = _NAME_SUB("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _fmt(v: float) -> str:
    """Shortest float text that round-trips (Prometheus accepts
    scientific notation); integral values render as integers."""
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_prometheus(counters: dict, gauges: dict, histograms: dict,
                      legacy_executable_metrics: bool = False) -> str:
    """Render registry snapshots as Prometheus text exposition.

    ``histograms`` maps name → :meth:`Histogram.snapshot` dicts (the
    shape with ``bucket_bounds`` + cumulative ``bucket_counts``;
    the final overflow bucket becomes ``le="+Inf"``).

    Every family — flat counters/gauges, LABELED families, histograms
    — carries ``# HELP`` and ``# TYPE`` lines (closed the gap
    where only flat families were annotated; the scrape test
    parse-checks the pairing line by line).

    Labeled families: per-executable cost gauges
    (``serving_executable_<field>{digest=...}``), modeled collective
    payloads (``serving_collective_<field>{family=,wire=,probe_wire=}``)
    and the graftgauge index surface —
    ``index_probe_freq_count{index=,list=}`` top-N samples,
    ``index_probe_freq_<field>{index=}`` summaries,
    ``index_health_<field>{index=}`` and ``index_drift_<field>{index=}``.
    ``legacy_executable_metrics=True`` ADDITIONALLY emits the
    deprecated flat names (both the sha1-embedded executable spellings
    and the dotted collective ones) for one release of overlap."""
    lines = []

    def emit_family(pn: str, mtype: str, help_name: str) -> None:
        lines.append(f"# HELP {pn} {help_text(help_name)}")
        lines.append(f"# TYPE {pn} {mtype}")

    # labeled counter families (graftragged pad-waste split): the
    # samples fold into ONE `_split`-suffixed family per base counter
    # — reusing the flat aggregate's name would emit its HELP/TYPE
    # header twice, which the exposition grammar forbids
    labeled_counters: dict = {}
    for name in sorted(counters):
        m = _PAD_SPLIT.match(name)
        if m:
            fam = f"serving_execute_{m.group(1)}_split"
            labeled_counters.setdefault(fam, []).append(
                (f'params_class="{m.group(2)}",tile="{m.group(3)}"',
                 counters[name]))
            continue
        pn = prom_name(name)
        emit_family(pn, "counter", name)
        lines.append(f"{pn} {_fmt(counters[name])}")
    for pn in sorted(labeled_counters):
        emit_family(pn, "counter", "serving.execute.")
        for labels, v in sorted(labeled_counters[pn]):
            lines.append(f"{pn}{{{labels}}} {_fmt(v)}")

    # family prom-name -> {"help": registry prefix, "samples": [...]}
    labeled: dict = {}

    def add_labeled(pn: str, help_name: str, labels: str, v) -> None:
        fam = labeled.setdefault(pn, {"help": help_name, "samples": []})
        fam["samples"].append((labels, v))

    for name in sorted(gauges):
        v = gauges[name]
        m = _EXEC_GAUGE.match(name)
        if m:
            add_labeled(f"serving_executable_{prom_name(m.group(2))}",
                        "serving.executable.",
                        f'digest="{m.group(1)}"', v)
            if not legacy_executable_metrics:
                continue
        else:
            m = _COLLECTIVE_GAUGE.match(name)
            if m:
                add_labeled(
                    f"serving_collective_{prom_name(m.group(4))}",
                    "serving.collective.",
                    f'family="{m.group(1)}",wire="{m.group(2)}",'
                    f'probe_wire="{m.group(3)}"', v)
                if not legacy_executable_metrics:
                    continue
            else:
                # graftgauge index families are labeled-only (they
                # were born in — no legacy flat spelling to keep)
                m = _PROBE_LIST_GAUGE.match(name)
                if m:
                    add_labeled("index_probe_freq_count",
                                "index.probe_freq.",
                                f'index="{m.group(1)}",'
                                f'list="{m.group(2)}"', v)
                    continue
                m = _PROBE_GAUGE.match(name)
                if m:
                    add_labeled(
                        f"index_probe_freq_{prom_name(m.group(2))}",
                        "index.probe_freq.",
                        f'index="{m.group(1)}"', v)
                    continue
                m = _HEALTH_GAUGE.match(name)
                if m:
                    add_labeled(
                        f"index_health_{prom_name(m.group(2))}",
                        "index.health.", f'index="{m.group(1)}"', v)
                    continue
                m = _DRIFT_GAUGE.match(name)
                if m:
                    add_labeled(
                        f"index_drift_{prom_name(m.group(2))}",
                        "index.drift.", f'index="{m.group(1)}"', v)
                    continue
                m = _ROUTE_REPLICA_GAUGE.match(name)
                if m:
                    add_labeled(
                        f"fleet_route_replica_{prom_name(m.group(2))}",
                        "fleet.route.", f'replica="{m.group(1)}"', v)
                    continue
                m = _PLAN_REPLICA_GAUGE.match(name)
                if m:
                    add_labeled(
                        f"fleet_plan_replica_{prom_name(m.group(2))}",
                        "fleet.plan.", f'replica="{m.group(1)}"', v)
                    continue
                m = _FLEET_REPLICA_GAUGE.match(name)
                if m:
                    add_labeled(
                        f"fleet_replica_{prom_name(m.group(2))}",
                        "fleet.", f'replica="{m.group(1)}"', v)
                    continue
                m = _FLEET_PROBE_GAUGE.match(name)
                if m:
                    add_labeled(
                        f"fleet_probe_freq_{prom_name(m.group(2))}",
                        "fleet.", f'index="{m.group(1)}"', v)
                    continue
                m = _FLEET_DRIFT_GAUGE.match(name)
                if m:
                    add_labeled("fleet_drift_score", "fleet.",
                                f'index="{m.group(1)}"', v)
                    continue
                m = _MEM_INDEX_GAUGE.match(name)
                if m:
                    add_labeled(
                        f"memory_index_{prom_name(m.group(2))}",
                        "memory.", f'index="{m.group(1)}"', v)
                    continue
                m = _MEM_DEVICE_GAUGE.match(name)
                if m:
                    add_labeled(
                        f"memory_device_{prom_name(m.group(2))}",
                        "memory.", f'device="{m.group(1)}"', v)
                    continue
                m = _FLEET_MEM_INDEX_GAUGE.match(name)
                if m:
                    add_labeled("fleet_memory_index_resident_bytes",
                                "fleet.memory.",
                                f'index="{m.group(1)}"', v)
                    continue
        pn = prom_name(name)
        emit_family(pn, "gauge", name)
        lines.append(f"{pn} {_fmt(v)}")
    for pn in sorted(labeled):
        fam = labeled[pn]
        emit_family(pn, "gauge", fam["help"])
        for labels, v in sorted(fam["samples"]):
            lines.append(f"{pn}{{{labels}}} {_fmt(v)}")
    # histograms group into families first: a params-class variant
    # (serving.batcher.execute_seconds.p<NP>) becomes a LABELED sample
    # set of its base family — HELP/TYPE must be emitted once per
    # family, never once per label value (the exposition grammar the
    # line-by-line scrape test enforces)
    hist_fams: dict = {}
    for name in sorted(histograms):
        m = _HIST_CLASS.match(name)
        if m:
            base, labels = m.group(1), f'params_class="{m.group(2)}"'
        else:
            base, labels = name, ""
        fam = hist_fams.setdefault(prom_name(base),
                                   {"help": base, "samples": []})
        fam["samples"].append((labels, histograms[name]))
    for pn in sorted(hist_fams):
        fam = hist_fams[pn]
        emit_family(pn, "histogram", fam["help"])
        for labels, snap in sorted(fam["samples"], key=lambda s: s[0]):
            pre = labels + "," if labels else ""
            suf = f"{{{labels}}}" if labels else ""
            bounds = snap.get("bucket_bounds", [])
            cumulative = snap.get("bucket_counts", [])
            for le, c in zip(bounds, cumulative):
                lines.append(f'{pn}_bucket{{{pre}le="{_fmt(le)}"}} {c}')
            lines.append(f'{pn}_bucket{{{pre}le="+Inf"}} {snap["count"]}')
            lines.append(f"{pn}_sum{suf} {_fmt(snap['sum'])}")
            lines.append(f"{pn}_count{suf} {snap['count']}")
    return "\n".join(lines) + "\n"


def _memory_snapshot_bytes() -> bytes:
    """The caching allocator's snapshot, pickled: ``torch.cuda.memory.
    _snapshot()`` with allocation-site recording on from the first call
    (:func:`_record_history`), or an empty snapshot without a card."""
    import pickle

    import torch

    if not torch.cuda.is_available():
        return pickle.dumps({"segments": [], "device_traces": []})
    _record_history(True)
    return pickle.dumps(torch.cuda.memory._snapshot())


_history_on = False  # guarded-by: _history_lock
_history_lock = threading.Lock()


def _record_history(on: bool) -> None:
    """Turn the allocator's allocation-site recording on or off (a
    no-op when it already is)."""
    global _history_on
    import torch

    with _history_lock:
        if on == _history_on or not torch.cuda.is_available():
            return
        torch.cuda.memory._record_memory_history(
            "all" if on else None, stacks="python")
        _history_on = on


class MetricsExporter:
    """HTTP pull endpoint for the whole observability surface.

    ``executor`` (optional) contributes its per-executable cost table
    to ``/snapshot.json``; ``batcher`` (optional) contributes the live
    degradation rung and queue depth (polled at scrape time, so the
    rung is current even while the event-driven gauges are quiet).
    ``profile_dir`` arms ``/profile`` (None keeps it 403-disabled);
    ``legacy_executable_metrics`` additionally emits the deprecated
    flat per-executable AND per-collective gauge names next to the
    labeled families."""

    def __init__(self, executor=None, batcher=None, *,
                 host: str = "127.0.0.1", port: int = 0,
                 profile_dir: Optional[str] = None,
                 legacy_executable_metrics: bool = False,
                 index_gauge=None, flight=None, continuous=None,
                 fleet=None, memory=None, tier=None, route=None):
        self.executor = executor
        self.batcher = batcher
        self.host = host
        self.port = port
        self.profile_dir = profile_dir
        self.legacy_executable_metrics = legacy_executable_metrics
        # graftgauge: an IndexGauge refreshes the index-health /
        # probe-frequency / recall / drift surface per scrape and backs
        # the /index.json endpoint (404 when not attached)
        self.index_gauge = index_gauge
        # graftflight: a FlightRecorder evaluates its incident
        # triggers per scrape and backs /incident.json (404 while no
        # incident has been captured — or no recorder is attached)
        self.flight = flight
        # graftfleet: a ContinuousCapture ticks per scrape —
        # its low-duty-cycle captures keep the rolling attribution
        # fresh — and a FleetAggregator backs /fleet.json plus the
        # replica=-labeled exposition appended to /metrics
        self.continuous = continuous
        self.fleet = fleet
        # graftledger: a MemoryLedger publishes the memory.*
        # gauge surface per scrape, backs /memory.json, and ships the
        # federation "memory" block inside /snapshot.json
        self.memory = memory
        # grafttier: a TierManager backs /tier.json and its
        # placement epochs pace off the scrape (tick), like the
        # continuous capture — the exporter is the one periodic pulse
        # every serving process already has
        self.tier = tier
        # graftroute: a QueryRouter backs /route.json, refreshes the
        # fleet.route.* gauges per scrape, and accepts routing-table
        # delivery on the same POST /push channel the federation uses
        # (?route=1 — NAT-bound replicas can't be scraped OR pushed to,
        # so the control plane pushes the table through the exporter
        # they already reach)
        self.route = route
        self._profile_lock = threading.Lock()
        # /memory_profile capture sequence — a counter, not a clock
        # read (R7): the file name only needs to be unique per process
        self._memprof_seq = 0
        # seq -> capture path, for ?diff=<seq> (restart-safe: a seq
        # from a previous process resolves through the file name)
        self._memprof_paths: dict = {}
        for owner in (flight, continuous):
            if owner is not None and getattr(owner, "profile_lock",
                                             None) is None:
                # one profiler capture at a time, ALL directions: the
                # recorder's automatic capture defers while /profile
                # runs, /profile 409s while an incident is being
                # captured, and the continuous tick — the lowest-
                # priority customer — defers to both
                owner.profile_lock = self._profile_lock
        self._server: Optional[http.server.ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- payloads (usable without the HTTP server, e.g. in tests) -----------

    def prometheus_text(self) -> str:
        """The ``/metrics`` body: full registries, freshly read; with
        a :class:`~raft_tpu_torch.serving.federation.FleetAggregator`
        attached, the ``replica=``-labeled + fleet-aggregate federated
        families append after the local ones."""
        self._refresh()
        if self.fleet is not None:
            # one scrape-and-merge per exposition: refreshes the
            # fleet.* gauges BEFORE the local registries render, so
            # the health/coverage families below are current
            self.fleet.fleet_snapshot()
        text = render_prometheus(
            tracing.counters(), tracing.gauges(), tracing.histograms(),
            legacy_executable_metrics=self.legacy_executable_metrics)
        if self.fleet is not None:
            text += self.fleet.prometheus_text()
        return text

    def snapshot(self) -> dict:
        """The ``/snapshot.json`` body. Since it also carries
        the federation inputs a :class:`~raft_tpu_torch.serving.federation
        .FleetAggregator` merges: ``counters_lifetime`` (the
        reset-proof ledger fleet counters sum from — the live
        ``counters`` view can go backwards across a
        ``reset_counters()``, the ledger cannot) and, when an
        :class:`~raft_tpu_torch.serving.gauge.IndexGauge` is attached, the
        ``federation`` block (full probe planes, raw recall trials,
        drift state)."""
        self._refresh()
        out = dict(serving_metrics.snapshot())
        out["xla"] = tracing.counters("xla.")
        out["counters_lifetime"] = tracing.lifetime_counters()
        if self.executor is not None and hasattr(self.executor,
                                                 "executable_costs"):
            out["executables"] = self.executor.executable_costs()
        if self.batcher is not None:
            q = self.batcher._queue
            out["admission"] = {
                "queue_depth": len(q),
                "shed_level": q.shed_level(),
                "arrival_rate_hz": q.arrival_rate(),
            }
        if self.index_gauge is not None and hasattr(
                self.index_gauge, "federation_payload"):
            out["federation"] = self.index_gauge.federation_payload()
        if self.memory is not None:
            # graftledger: the memory block a FleetAggregator merges
            # (headroom min, resident sum) — shipped like the
            # graftgauge federation block, absent when no ledger is
            # attached (the aggregator must tolerate that)
            out["memory"] = self.memory.federation_payload()
        rec = tracing.span_recorder()
        out["spans"] = {"recorded": len(rec), "dropped": rec.dropped,
                        "capacity": rec.capacity}
        return out

    def chrome_trace(self, trace_id: Optional[int] = None) -> dict:
        """The ``/trace.json`` body (Perfetto overlay input);
        ``trace_id`` restricts it to one request's spans — an unknown
        id yields an empty trace, not an error (the id may simply have
        aged out of the ring)."""
        return tracing.span_recorder().to_chrome_trace(
            trace_id=trace_id)

    def profile(self, seconds: float) -> dict:
        """Run one gated ``torch.profiler`` capture of ``seconds`` into
        ``profile_dir`` and return ``{"log_dir", "seconds"}``.
        Raises ``PermissionError`` when no ``profile_dir`` was
        configured and ``RuntimeError`` when a capture is already in
        flight — the HTTP layer maps these to 403/409. The capture
        sleeps wall-clock (no clock *read* — R7-clean): profiling
        windows are a wall-time concern, not a batcher-clock one."""
        if self.profile_dir is None:
            raise PermissionError(
                "profiling is disabled: construct MetricsExporter with "
                "profile_dir=... to arm /profile")
        if not self._profile_lock.acquire(blocking=False):
            raise RuntimeError("a profiler capture is already running")
        # the capture's trace file rides in the response so the
        # flight recorder — and operators — can find what was just captured without globbing profile_dir.
        # Only a file THIS capture produced qualifies (before/after
        # diff): "newest in the dir" would name a previous capture's
        # file — stale data presented as fresh — whenever the current
        # one writes no chrome-trace sidecar; null is the honest
        # answer then.
        from raft_tpu_torch.core import profiling

        before = profiling.trace_snapshot(self.profile_dir)
        try:
            with tracing.capture(self.profile_dir):
                time.sleep(seconds)
        finally:
            self._profile_lock.release()
        return {"log_dir": self.profile_dir, "seconds": seconds,
                "trace_file": profiling.fresh_trace_file(
                    self.profile_dir, before)}

    def memory_snapshot(self) -> dict:
        """The ``/memory.json`` body: the attached
        :class:`~raft_tpu_torch.core.memwatch.MemoryLedger`'s full
        structured view (resident model, live device truth, forecast,
        headroom, divergence, watermarks), freshly published. Raises
        ``LookupError`` when no ledger is attached — the HTTP layer
        maps it to 404."""
        if self.memory is None:
            raise LookupError(
                "no MemoryLedger attached: construct MetricsExporter "
                "with memory=... to arm /memory.json")
        return self.memory.publish()

    def memory_profile(self, diff_seq: Optional[int] = None) -> dict:
        """One gated allocator snapshot (:func:`_memory_snapshot_bytes`)
        — the per-allocation device-memory breakdown the live gauges
        summarize. Shares the ``/profile`` lock (one
        profiler customer at a time, all directions) and its gate:
        ``PermissionError`` without a configured ``profile_dir``
        (403), ``RuntimeError`` while any capture runs (409). The
        pickled snapshot lands in ``profile_dir`` as
        ``memory_profile_<n>.pickle`` (sequence-numbered — no clock
        read) and the response carries the path and sequence number.

        ``diff_seq`` additionally
        parses this capture against the earlier capture ``<seq>`` —
        two sequence-numbered captures bracketing a window — and
        returns the per-buffer-group byte deltas
        (:func:`raft_tpu_torch.core.memwatch.diff_memory_profiles`), so
        the divergence gauge's growth attributes to buffer groups
        instead of the whole process. An unknown sequence number
        raises ``ValueError`` (400 over HTTP); a restarted process
        can diff against a previous run's on-disk capture by its
        number."""
        if self.profile_dir is None:
            raise PermissionError(
                "profiling is disabled: construct MetricsExporter with "
                "profile_dir=... to arm /memory_profile")
        import os

        before_path = None
        if diff_seq is not None:
            before_path = self._memprof_paths.get(int(diff_seq))
            if before_path is None:
                # restart-safe: resolve a previous process's capture
                # through the deterministic file name
                cand = os.path.join(
                    self.profile_dir,
                    f"memory_profile_{int(diff_seq):04d}.pickle")
                if os.path.exists(cand):
                    before_path = cand
            if before_path is None or not os.path.exists(before_path):
                raise ValueError(
                    f"no memory profile with sequence number "
                    f"{diff_seq} exists to diff against")
        if not self._profile_lock.acquire(blocking=False):
            raise RuntimeError("a profiler capture is already running")
        try:
            data = _memory_snapshot_bytes()
            os.makedirs(self.profile_dir, exist_ok=True)
            # the sequence restarts with the process: skip names that
            # already exist so a restarted service can never overwrite
            # a previous run's capture — which may be the pre-crash
            # evidence an operator is about to read
            while True:
                self._memprof_seq += 1
                path = os.path.join(
                    self.profile_dir,
                    f"memory_profile_{self._memprof_seq:04d}.pickle")
                if not os.path.exists(path):
                    break
            with open(path, "wb") as f:
                f.write(data)
            # captured into a local INSIDE the lock: a concurrent
            # capture bumps _memprof_seq the moment we release, and
            # the response (and diff.to_seq) must name THIS capture
            seq = self._memprof_seq
            self._memprof_paths[seq] = path
        finally:
            self._profile_lock.release()
        out = {"path": path, "bytes": len(data), "seq": seq}
        if before_path is not None:
            from raft_tpu_torch.core import memwatch

            with open(before_path, "rb") as f:
                before = memwatch.parse_memory_profile(f.read())
            after = memwatch.parse_memory_profile(data)
            out["diff"] = dict(
                memwatch.diff_memory_profiles(before, after),
                from_seq=int(diff_seq), to_seq=seq)
        return out

    def tier_snapshot(self) -> dict:
        """The ``/tier.json`` body: the attached
        :class:`~raft_tpu_torch.serving.placement.TierManager`'s layout +
        last-plan view. Raises ``LookupError`` when no manager is
        attached — the HTTP layer maps it to 404."""
        if self.tier is None:
            raise LookupError(
                "no TierManager attached: construct MetricsExporter "
                "with tier=... to arm /tier.json")
        return self.tier.snapshot()

    def route_snapshot(self) -> dict:
        """The ``/route.json`` body: the attached
        router's (the JAX package's ``fleet/router.QueryRouter`` interface) live routing
        table + router view. Raises ``LookupError`` when no router
        is attached (or none applied a table yet) — the HTTP layer
        maps it to 404."""
        if self.route is None:
            raise LookupError(
                "no QueryRouter attached: construct MetricsExporter "
                "with route=... to arm /route.json")
        return self.route.snapshot()

    def _refresh(self) -> None:
        """Re-publish the poll-style gauges from the attached executor
        and batcher so a scrape of a quiet service (or one taken after
        ``metrics.reset()``) still reads current state. Both delegate
        to the owning object — the gauge names and derivations live in
        one place each."""
        if self.executor is not None and hasattr(self.executor,
                                                 "publish_cost_gauges"):
            self.executor.publish_cost_gauges()
        if self.batcher is not None:
            self.batcher._queue.publish_gauges()
            if hasattr(self.batcher, "publish_slo_gauges"):
                # burn rate decays as misses age out of the window —
                # re-evaluated at the batcher clock's now per scrape
                self.batcher.publish_slo_gauges()
        if self.index_gauge is not None:
            # graftgauge: one probe-plane fetch shared across the
            # probe-frequency gauges and drift scoring, plus health
            # stats and the shadow-recall window refresh
            self.index_gauge.publish()
        if self.memory is not None:
            # graftledger: re-publish the memory truth (model + live
            # stats + forecast) — BEFORE the flight check below, so a
            # low-headroom trigger evaluates this scrape's numbers
            self.memory.publish()
        if self.tier is not None:
            # grafttier: refresh the layout gauges and pace the
            # placement epochs off the scrape (the manager's injected
            # clock decides whether an epoch is due — one tick runs
            # at most one epoch, like the continuous capture)
            self.tier.publish_gauges()
            self.tier.tick()
        if self.route is not None:
            # graftroute: refresh the coverage/fan-out/table-age
            # gauges from the router's counters (scrape-driven, like
            # the tier layout gauges)
            self.route.publish_gauges()
        if self.flight is not None:
            # graftflight: evaluate the incident triggers — a firing
            # multiburn alert / latency anomaly captures here, rate
            # limited by the recorder's cooldown (a triggered scrape
            # blocks for the short capture; that is the design — the
            # incident evidence is worth one slow scrape)
            self.flight.check()
        if self.continuous is not None:
            # graftfleet: the continuous tick runs AFTER the incident
            # check — incident captures grab the shared profile lock
            # first and the tick defers to them (and to /profile); a
            # due tick costs the scrape one short capture, the
            # duty-cycle budget bounds how often
            self.continuous.tick()

    def index_snapshot(self) -> dict:
        """The ``/index.json`` body: the attached
        :class:`~raft_tpu_torch.serving.gauge.IndexGauge`'s full structured
        view (health, probe-frequency stats, drift, recall), freshly
        published. Raises ``LookupError`` when no gauge is attached —
        the HTTP layer maps it to 404."""
        if self.index_gauge is None:
            raise LookupError(
                "no IndexGauge attached: construct MetricsExporter "
                "with index_gauge=... to arm /index.json")
        return self.index_gauge.publish()

    # -- server lifecycle ---------------------------------------------------

    def start(self) -> int:
        """Bind and serve on a daemon thread; returns the bound port.
        With a ``profile_dir``, the profiler's CUDA side is initialised
        here, on the starting thread, so that captures run on request
        threads record the device (:func:`raft_tpu_torch.core.profiling
        .prime`)."""
        if self._server is not None:
            return self.port
        if self.profile_dir is not None:
            from raft_tpu_torch.core import profiling

            profiling.prime()
        exporter = self

        class Handler(http.server.BaseHTTPRequestHandler):
            # the serving process logs through its own logger; default
            # BaseHTTPRequestHandler stderr chatter is noise
            def log_message(self, fmt, *args):  # noqa: ARG002
                pass

            def _send(self, body: bytes, ctype: str, code: int = 200):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — http.server API
                path, _, query = self.path.partition("?")
                # keep_blank_values: '?trace_id=' must surface as a
                # present-but-empty param and 400 below, not silently
                # vanish and dump the whole ring / default-capture
                qs = urllib.parse.parse_qs(query,
                                           keep_blank_values=True)
                if path == "/metrics":
                    self._send(exporter.prometheus_text().encode(),
                               "text/plain; version=0.0.4; "
                               "charset=utf-8")
                elif path == "/snapshot.json":
                    self._send(
                        json.dumps(exporter.snapshot(),
                                   default=str).encode(),
                        "application/json")
                elif path == "/index.json":
                    try:
                        out = exporter.index_snapshot()
                    except LookupError as e:
                        self._send(f"{e}\n".encode(), "text/plain", 404)
                        return
                    self._send(json.dumps(out, default=str).encode(),
                               "application/json")
                elif path == "/fleet.json":
                    if exporter.fleet is None:
                        self._send(b"no FleetAggregator attached\n",
                                   "text/plain", 404)
                        return
                    self._send(
                        json.dumps(exporter.fleet.fleet_snapshot(),
                                   default=str).encode(),
                        "application/json")
                elif path == "/memory.json":
                    try:
                        out = exporter.memory_snapshot()
                    except LookupError as e:
                        self._send(f"{e}\n".encode(), "text/plain", 404)
                        return
                    self._send(json.dumps(out, default=str).encode(),
                               "application/json")
                elif path == "/tier.json":
                    try:
                        out = exporter.tier_snapshot()
                    except LookupError as e:
                        self._send(f"{e}\n".encode(), "text/plain", 404)
                        return
                    self._send(json.dumps(out, default=str).encode(),
                               "application/json")
                elif path == "/route.json":
                    try:
                        out = exporter.route_snapshot()
                    except LookupError as e:
                        self._send(f"{e}\n".encode(), "text/plain", 404)
                        return
                    self._send(json.dumps(out, default=str).encode(),
                               "application/json")
                elif path == "/memory_profile":
                    diff_seq = None
                    if "diff" in qs:
                        try:
                            diff_seq = int(qs["diff"][0])
                        except ValueError:
                            self._send(
                                b"diff must be a capture sequence "
                                b"number\n", "text/plain", 400)
                            return
                    try:
                        out = exporter.memory_profile(diff_seq=diff_seq)
                    except ValueError as e:
                        self._send(f"{e}\n".encode(), "text/plain", 400)
                        return
                    except PermissionError as e:
                        self._send(f"{e}\n".encode(), "text/plain", 403)
                        return
                    except RuntimeError as e:
                        self._send(f"{e}\n".encode(), "text/plain", 409)
                        return
                    except Exception as e:  # noqa: BLE001 — report, don't die
                        self._send(f"capture failed: {e}\n".encode(),
                                   "text/plain", 500)
                        return
                    self._send(json.dumps(out).encode(),
                               "application/json")
                elif path == "/incident.json":
                    bundle = (exporter.flight.latest()
                              if exporter.flight is not None else None)
                    if bundle is None:
                        self._send(b"no incident captured\n",
                                   "text/plain", 404)
                        return
                    self._send(json.dumps(bundle, default=str).encode(),
                               "application/json")
                elif path == "/trace.json":
                    trace_id = None
                    if "trace_id" in qs:
                        try:
                            trace_id = int(qs["trace_id"][0])
                        except ValueError:
                            self._send(b"trace_id must be an integer\n",
                                       "text/plain", 400)
                            return
                    self._send(
                        json.dumps(exporter.chrome_trace(
                            trace_id=trace_id)).encode(),
                        "application/json")
                elif path == "/profile":
                    try:
                        seconds = float(qs.get("seconds", ["1.0"])[0])
                    except ValueError:
                        seconds = -1.0
                    if not 0.0 <= seconds <= 60.0:
                        self._send(b"seconds must be in [0, 60]\n",
                                   "text/plain", 400)
                        return
                    try:
                        out = exporter.profile(seconds)
                    except PermissionError as e:
                        self._send(f"{e}\n".encode(), "text/plain", 403)
                        return
                    except RuntimeError as e:
                        self._send(f"{e}\n".encode(), "text/plain", 409)
                        return
                    except Exception as e:  # noqa: BLE001 — report, don't die
                        self._send(f"capture failed: {e}\n".encode(),
                                   "text/plain", 500)
                        return
                    self._send(json.dumps(out).encode(),
                               "application/json")
                elif path == "/healthz":
                    self._send(b"ok\n", "text/plain")
                else:
                    self._send(b"not found\n", "text/plain", 404)

            def do_POST(self):  # noqa: N802 — http.server API
                path, _, query = self.path.partition("?")
                qs = urllib.parse.parse_qs(query,
                                           keep_blank_values=True)
                if path != "/push":
                    self._send(b"not found\n", "text/plain", 404)
                    return
                if "route" in qs:
                    # graftroute table delivery: the control plane
                    # pushes a fresh routing table over the channel
                    # a NAT-bound replica already exposes; version
                    # gating makes out-of-order delivery harmless
                    # (stale -> 409, the pusher's signal to re-read
                    # /route.json before trying again)
                    if exporter.route is None:
                        self._send(b"no QueryRouter attached\n",
                                   "text/plain", 404)
                        return
                    try:
                        length = int(
                            self.headers.get("Content-Length", 0))
                        if length > 8 * 1024 * 1024:
                            self._send(b"table body too large\n",
                                       "text/plain", 413)
                            return
                        doc = json.loads(
                            self.rfile.read(length).decode())
                        applied = exporter.route.apply_table(doc)
                    except (ValueError, UnicodeDecodeError,
                            RaftError) as e:
                        self._send(f"bad routing table: {e}\n"
                                   .encode(), "text/plain", 400)
                        return
                    if not applied:
                        self._send(b"stale table version\n",
                                   "text/plain", 409)
                        return
                    self._send(json.dumps({"applied": True}).encode(),
                               "application/json")
                    return
                # federation push mode: replicas behind NAT
                # POST the same body they would serve at
                # /snapshot.json; it enters the aggregator through
                # the SAME type-correct merge path a scrape feeds
                if exporter.fleet is None or not hasattr(
                        exporter.fleet, "push"):
                    self._send(b"no FleetAggregator attached\n",
                               "text/plain", 404)
                    return
                replica = qs.get("replica", [""])[0]
                if not replica:
                    self._send(b"replica query parameter required\n",
                               "text/plain", 400)
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    # a snapshot body is a few MB at the very most —
                    # an unbounded read would let one request buffer
                    # arbitrary bytes into the aggregator process
                    if length > 8 * 1024 * 1024:
                        self._send(b"snapshot body too large\n",
                                   "text/plain", 413)
                        return
                    snap = json.loads(
                        self.rfile.read(length).decode())
                    if not isinstance(snap, dict):
                        raise ValueError("snapshot body must be a "
                                         "JSON object")
                except (ValueError, UnicodeDecodeError) as e:
                    self._send(f"bad snapshot body: {e}\n".encode(),
                               "text/plain", 400)
                    return
                try:
                    exporter.fleet.push(replica, snap)
                except ValueError as e:
                    # the push-replica registry cap: refuse loudly —
                    # 429 tells a legitimate replica to back off and
                    # an operator that the registry is full
                    self._send(f"{e}\n".encode(), "text/plain", 429)
                    return
                self._send(json.dumps({"accepted": replica}).encode(),
                           "application/json")

        self._server = http.server.ThreadingHTTPServer(
            (self.host, self.port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="raft-tpu-metrics-exporter", daemon=True)
        self._thread.start()
        return self.port

    def url(self, path: str = "/metrics") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def close(self) -> None:
        """Stop serving and join the server thread (idempotent)."""
        if self._server is None:
            return
        _record_history(False)
        self._server.shutdown()
        self._server.server_close()
        self._server = None
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()
