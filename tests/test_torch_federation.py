"""The port's metric federation against the JAX package's tests
(``tests/test_federation.py``): the fixture-pinned type-correct merge
(counter sums of lifetime ledgers, bucket-merged histograms, probe
coverage, pooled Wilson recall, pooled drift), health and high-water
marks under a ManualClock, push mode and the exporter's fleet surface.
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from raft_tpu_torch.core import tracing
from raft_tpu_torch.serving import (
    DriftDetector,
    FleetAggregator,
    FleetConfig,
    IndexGauge,
    MetricsExporter,
)
from raft_tpu_torch.serving import federation as fed_mod
from raft_tpu_torch.serving import metrics
from raft_tpu_torch.serving.gauge import wilson_interval
from raft_tpu_torch.serving.harness import ManualClock

DATA = os.path.join(os.path.dirname(__file__), "data")


def load_replica(name):
    with open(os.path.join(DATA, f"fleet_replica_{name}.json")) as f:
        return json.load(f)


def fixture_fetch(url, timeout):
    for name in ("r0", "r1", "r2"):
        if f"//{name}/" in url:
            return load_replica(name)
    raise ValueError(f"unknown fixture url {url!r}")


def fixture_aggregator(clock=None, **kw):
    return FleetAggregator(
        {n: f"http://{n}/snapshot.json" for n in ("r0", "r1", "r2")},
        clock=clock or ManualClock(), fetch=fixture_fetch, **kw)


class TestFixturePinnedMerge:
    def setup_method(self):
        metrics.reset()
        tracing.reset_gauges("fleet.")

    def merged(self):
        agg = fixture_aggregator()
        scrapes0 = tracing.get_counter(fed_mod.SCRAPES)
        out = agg.fleet_snapshot()
        assert tracing.get_counter(fed_mod.SCRAPES) == scrapes0 + 1
        return out

    def test_replica_health(self):
        out = self.merged()
        assert out["size"] == 3 and out["healthy"] == 3
        for name in ("r0", "r1", "r2"):
            r = out["replicas"][name]
            assert r["healthy"] and r["errors"] == 0
            assert r["age_s"] == 0.0

    def test_fleet_counter_sums_from_lifetime_ledger(self):
        out = self.merged()
        c = out["counters"]
        # the LIFETIME values sum (r0's live view says 10 — a
        # mid-session reset folded 90 into its ledger; the fleet
        # number must be the reset-proof 100 + 200 + 50)
        assert c["serving.execute.calls"] == 350.0
        assert c["serving.slo.missed"] == 6.0
        assert c["index.probe.dispatches"] == 60.0

    def test_tier_block_sums_and_hit_rate(self):
        """graftcast: the tier placement + prefetch counters merge
        like every lifetime counter (monotone clamped sums) and
        restate as the structured ``tier`` block — r2 predates
        tiering and contributes zeros, never an error."""
        out = self.merged()
        t = out["tier"]
        assert t["epochs"] == 7.0          # 4 + 3 + 0
        assert t["promotions"] == 14.0
        assert t["demotions"] == 14.0
        pf = t["prefetch"]
        assert pf["issued"] == 11.0        # 6 + 5
        assert pf["hits"] == 7.0 and pf["misses"] == 4.0
        assert pf["cancelled"] == 1.0
        assert pf["hit_rate"] == pytest.approx(7.0 / 11.0)
        assert tracing.get_gauge("fleet.tier.epochs") == 7.0
        assert tracing.get_gauge(
            "fleet.tier.prefetch.hits") == 7.0
        assert tracing.get_gauge(
            "fleet.tier.prefetch.hit_rate") == \
            pytest.approx(7.0 / 11.0)

    def test_histograms_merge_bucket_wise(self):
        h = self.merged()["histograms"]["serving.batcher.e2e_seconds"]
        assert h["count"] == 9
        assert h["sum"] == pytest.approx(0.5105)
        assert h["bucket_counts"] == [3, 6, 8, 9]
        assert h["replicas"] == 3
        # quantiles recompute from the MERGED distribution — never
        # averaged per-replica quantiles
        assert h["p50"] == pytest.approx(0.0055)
        assert h["p95"] == pytest.approx(0.155)
        assert h["p99"] == pytest.approx(0.191)

    def test_fleet_probe_coverage_exact(self):
        pf = self.merged()["probe_freq"]["ivf:0"]
        # summed plane [100, 5, 5, 0, 10, 0, 0, 5]
        assert pf["total"] == 125
        assert pf["probed_fraction"] == pytest.approx(5 / 8)
        assert pf["coverage_p01"] == pytest.approx(0.8)
        assert pf["coverage_p10"] == pytest.approx(0.8)
        assert pf["top"][0] == (0, 100)
        assert tracing.get_gauge(
            "fleet.probe_freq.ivf:0.coverage_p01") == \
            pytest.approx(0.8)

    def test_recall_pools_trials_before_wilson(self):
        rec = self.merged()["recall"]
        live = rec["live"]
        assert (live["hits"], live["trials"], live["pairs"]) == \
            (315, 350, 32)
        assert live["estimate"] == pytest.approx(0.9)
        lo, hi = wilson_interval(315, 350)
        assert live["ci_low"] == pytest.approx(lo)
        assert live["ci_high"] == pytest.approx(hi)
        # pooling strictly tightens: the fleet CI is narrower than
        # the smallest replica's own window could support
        lo2, hi2 = wilson_interval(45, 50)
        assert hi - lo < hi2 - lo2
        # a sweep leg present on one replica still federates
        assert rec["sweep.p8"]["trials"] == 10
        assert tracing.get_gauge("fleet.recall.estimate") == \
            pytest.approx(0.9)

    def test_drift_rescores_pooled_histogram(self):
        drift = self.merged()["drift"]
        # traffic-weighted pooled live (40x + 20x uniform) is EXACTLY
        # proportional to the pooled baseline [30,30,30,30]: zero
        # drift however each replica's own window wiggled
        assert drift["main"]["score"] == pytest.approx(0.0)
        assert drift["main"]["replicas"] == 3
        # every replica skewed the same way: whatever the traffic
        # weights, the pooled distribution is [1, 0] and the score is
        # the JSD of it vs the pooled baseline [30, 30]
        expect = tracing.js_divergence([24.0, 0.0], [30.0, 30.0])
        assert drift["skew"]["score"] == pytest.approx(expect)
        assert drift["skew"]["score"] == pytest.approx(0.311278,
                                                       abs=1e-6)

    def test_drift_pooling_weighs_by_traffic_share(self):
        # a drifted replica carrying 99% of fleet traffic must NOT be
        # averaged away by an idle healthy peer: each replica's live
        # histogram is normalized, so the pool scales by ``traffic``
        def snap(live, traffic):
            return {"federation": {"drift": {"ix": {
                "baseline": [50, 50], "live": live,
                "traffic": traffic, "score": 0.0, "updates": 1}}}}

        payload = {"http://busy/snapshot.json": snap([1.0, 0.0], 99.0),
                   "http://idle/snapshot.json": snap([0.5, 0.5], 1.0)}
        agg = FleetAggregator({"busy": "http://busy/",
                               "idle": "http://idle/"},
                              clock=ManualClock(),
                              fetch=lambda url, t: payload[url])
        score = agg.fleet_snapshot()["drift"]["ix"]["score"]
        assert score == pytest.approx(
            tracing.js_divergence([99.5, 0.5], [100.0, 100.0]))
        # equal-weight fallback for payloads predating the weight
        for s in payload.values():
            del s["federation"]["drift"]["ix"]["traffic"]
        agg2 = FleetAggregator({"busy": "http://busy/",
                                "idle": "http://idle/"},
                               clock=ManualClock(),
                               fetch=lambda url, t: payload[url])
        score2 = agg2.fleet_snapshot()["drift"]["ix"]["score"]
        assert score2 == pytest.approx(
            tracing.js_divergence([1.5, 0.5], [100.0, 100.0]))
        # traffic weighting makes the busy drifted replica dominate:
        # MORE fleet drift detected than the averaged-away pool shows
        assert score > score2

    def test_admission_rollup(self):
        adm = self.merged()["admission"]
        assert adm["queue_depth"] == 5.0
        assert adm["arrival_rate_hz"] == 15.0
        assert adm["max_shed_level"] == 1


class TestMonotonicity:
    def setup_method(self):
        metrics.reset()

    def test_mid_scrape_reset_cannot_regress_fleet_counter(self):
        payloads = [
            {"counters_lifetime": {"serving.execute.calls": 100.0}},
            # a replica restart zeroed its ledger mid-scrape
            {"counters_lifetime": {"serving.execute.calls": 40.0}},
            {"counters_lifetime": {"serving.execute.calls": 60.0}},
        ]
        seq = iter(payloads)
        agg = FleetAggregator(["http://a"], clock=ManualClock(),
                              fetch=lambda url, t: next(seq))
        v0 = tracing.get_counter(fed_mod.MONOTONICITY_VIOLATIONS)
        assert agg.fleet_snapshot()["counters"][
            "serving.execute.calls"] == 100.0
        out = agg.fleet_snapshot()
        # clamped to the high-water mark — asserted monotone — and
        # the violation is counted, not silent
        assert out["counters"]["serving.execute.calls"] == 100.0
        assert tracing.get_counter(
            fed_mod.MONOTONICITY_VIOLATIONS) == v0 + 1
        # recovery below the mark still cannot move the fleet down
        assert agg.fleet_snapshot()["counters"][
            "serving.execute.calls"] == 100.0

    def test_live_counters_fallback_for_old_payloads(self):
        agg = FleetAggregator(
            ["http://a"], clock=ManualClock(),
            fetch=lambda url, t: {"counters": {"x": 7.0}})
        assert agg.fleet_snapshot()["counters"]["x"] == 7.0


class TestStaleness:
    def setup_method(self):
        metrics.reset()
        tracing.reset_gauges("fleet.")

    def test_stale_replica_drops_from_windowed_surfaces(self):
        clock = ManualClock()
        alive = {"r0": True, "r1": True}

        def fetch(url, timeout):
            name = "r0" if "//r0/" in url else "r1"
            if not alive[name]:
                raise urllib.error.URLError("connection refused")
            return load_replica(name)

        agg = FleetAggregator(
            {"r0": "http://r0/", "r1": "http://r1/"},
            config=FleetConfig(staleness_s=30.0), clock=clock,
            fetch=fetch)
        out = agg.fleet_snapshot()
        assert out["healthy"] == 2
        h2 = out["histograms"]["serving.batcher.e2e_seconds"]
        assert h2["count"] == 8                  # r0 (4) + r1 (4)
        alive["r1"] = False
        # within the staleness bound the last snapshot still counts
        clock.advance(10.0)
        out = agg.fleet_snapshot()
        assert out["healthy"] == 2
        assert out["replicas"]["r1"]["errors"] == 1
        # past it the replica drops unhealthy: windowed surfaces
        # (histograms, recall) exclude it...
        clock.advance(30.0)
        errs0 = tracing.get_counter(fed_mod.SCRAPE_ERRORS)
        out = agg.fleet_snapshot()
        assert out["healthy"] == 1
        assert not out["replicas"]["r1"]["healthy"]
        assert tracing.get_counter(fed_mod.SCRAPE_ERRORS) == errs0 + 1
        assert out["histograms"][
            "serving.batcher.e2e_seconds"]["count"] == 4
        assert out["recall"]["live"]["trials"] == 100   # r0 only
        # ...while CUMULATIVE surfaces retain its last-known (monotone
        # lower-bound) contribution — fleet counters cannot regress
        assert out["counters"]["serving.execute.calls"] == 300.0
        plane_total = out["probe_freq"]["ivf:0"]["total"]
        assert plane_total == 100                # 60 (r0) + 40 (r1)
        assert tracing.get_gauge("fleet.replica.r1.healthy") == 0.0
        assert tracing.get_gauge("fleet.replicas_healthy") == 1.0


class TestFleetHTTP:
    """The served surface: /fleet.json and the replica=-labeled +
    fleet-aggregate exposition, over real HTTP."""

    def setup_method(self):
        metrics.reset()
        tracing.reset_gauges("fleet.")

    def _get(self, url):
        try:
            with urllib.request.urlopen(url, timeout=30) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    def test_fleet_json_serves_merged_view(self):
        agg = fixture_aggregator()
        with MetricsExporter(fleet=agg) as exp:
            code, body = self._get(exp.url("/fleet.json"))
            assert code == 200
            out = json.loads(body)
            assert out["healthy"] == 3
            assert out["counters"]["serving.execute.calls"] == 350.0
            assert out["recall"]["live"]["estimate"] == \
                pytest.approx(0.9)
            assert out["probe_freq"]["ivf:0"]["coverage_p01"] == \
                pytest.approx(0.8)

    def test_fleet_json_404_without_aggregator(self):
        with MetricsExporter() as exp:
            code, _ = self._get(exp.url("/fleet.json"))
            assert code == 404

    def test_labeled_exposition(self):
        import re

        agg = fixture_aggregator()
        with MetricsExporter(fleet=agg) as exp:
            code, text = self._get(exp.url("/metrics"))
        assert code == 200
        # per-replica lifetime samples + the fleet aggregate, in ONE
        # fleet_-prefixed family (no collision with local families)
        assert ('fleet_serving_execute_calls{replica="r0"} 100'
                in text)
        assert ('fleet_serving_execute_calls{replica="r1"} 200'
                in text)
        assert ('fleet_serving_execute_calls{replica="fleet"} 350'
                in text)
        assert text.count(
            "# TYPE fleet_serving_execute_calls counter") == 1
        # the merged histogram renders per replica and fleet-wide
        assert re.search(
            r'fleet_serving_batcher_e2e_seconds_bucket'
            r'\{replica="fleet",le="[^"]+"\} \d+', text)
        assert ('fleet_serving_batcher_e2e_seconds_count'
                '{replica="fleet"} 9') in text
        # the aggregator's own health gauges render as labeled
        # families through the normal registry path
        assert 'fleet_replica_healthy{replica="r0"} 1' in text
        assert re.search(
            r'fleet_probe_freq_coverage_p01\{index="ivf:0"\}', text)
        # every non-comment line still parses against the exposition
        # grammar (label values may carry ':' — quoted, so legal)
        sample_re = re.compile(
            r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
            r'(\{[a-zA-Z_]+="[^"]*"(,[a-zA-Z_]+="[^"]*")*\})? '
            r"[-+0-9.e]+$")
        for line in text.strip().splitlines():
            if not line.startswith("#"):
                assert sample_re.match(line), line


class FakePlaneExecutor:
    def probe_frequencies(self):
        return {"ivf:0": np.array([3, 0, 2, 0], dtype=np.int64)}

    def publish_probe_gauges(self, top_n=8, planes=None):
        return {}


class TestSnapshotFederationPayload:
    """The replica side: /snapshot.json must carry the merge inputs —
    the lifetime ledger and (with an IndexGauge) the federation
    block."""

    def setup_method(self):
        metrics.reset()

    def test_snapshot_carries_lifetime_ledger(self):
        tracing.inc_counter("serving.execute.calls", 5.0)
        tracing.reset_counters("serving.")     # mid-scrape reset
        tracing.inc_counter("serving.execute.calls", 2.0)
        exp = MetricsExporter()
        snap = exp.snapshot()
        # the live view regressed to 2; the ledger the fleet sums
        # from still carries the full 7
        assert snap["counters"]["serving.execute.calls"] == 2.0
        assert snap["counters_lifetime"][
            "serving.execute.calls"] >= 7.0

    def test_federation_block_with_index_gauge(self):
        det = DriftDetector(np.array([1.0, 2.0, 3.0, 4.0]))
        det.update(np.array([1, 0, 1, 0]))
        gauge = IndexGauge(executor=FakePlaneExecutor(),
                           drift={"main": det})
        exp = MetricsExporter(index_gauge=gauge)
        fed = exp.snapshot()["federation"]
        assert fed["probe_planes"]["ivf:0"] == [3, 0, 2, 0]
        assert fed["drift"]["main"]["baseline"] == [1.0, 2.0, 3.0, 4.0]
        assert fed["drift"]["main"]["live"] is not None
        # the pooling weight: an EWMA (alpha=0.2) of per-window
        # traffic — first window seeds, the second folds
        assert fed["drift"]["main"]["traffic"] == pytest.approx(2.0)
        det.update(np.array([7, 2, 1, 0]))      # delta sum 8
        assert det.state()["traffic"] == pytest.approx(
            0.2 * 8.0 + 0.8 * 2.0)
        # JSON-serializable end to end (the payload ships over HTTP)
        json.dumps(fed)

    def test_recall_raw_pools(self):
        from raft_tpu_torch.serving import RecallWindow

        w = RecallWindow(window_s=60.0)
        w.record(0.0, 8, 10)
        w.record(10.0, 9, 10)
        assert w.raw(10.0) == {"hits": 17, "trials": 20, "pairs": 2}
        # pruned pairs leave the raw counts with the window
        assert w.raw(65.0) == {"hits": 9, "trials": 10, "pairs": 1}


class TestMemoryMerge:
    """Memory federation: per-replica memory blocks merge
    as resident SUM + headroom MIN; a replica missing the block (r2 —
    older build, no ledger) is skipped and counted, never guessed at."""

    def setup_method(self):
        metrics.reset()
        tracing.reset_gauges("fleet.")

    def merged(self):
        return fixture_aggregator().fleet_snapshot()

    def test_resident_sum_and_headroom_min(self):
        mem = self.merged()["memory"]
        # r0 and r1 report; r2 has no memory block
        assert mem["replicas_reporting"] == 2
        assert mem["resident_bytes"] == 9_000_000.0
        # per-index resident sums across replicas holding a copy
        assert mem["resident"]["ivf:0"] == 8_000_000.0
        assert mem["resident"]["pq:0"] == 1_000_000.0
        # headroom is the MIN over measured replicas — r1's 1.5 MB,
        # not an average, and r2's absence is not infinite room
        assert mem["headroom_min_bytes"] == 1_500_000.0
        assert mem["headroom_min_replica"] == "r1"
        assert mem["forecast_peak_max_bytes"] == 6_000_000.0

    def test_memory_gauges_published(self):
        self.merged()
        assert tracing.get_gauge(
            "fleet.memory.resident_bytes") == 9_000_000.0
        assert tracing.get_gauge(
            "fleet.memory.headroom_min_bytes") == 1_500_000.0
        assert tracing.get_gauge(
            "fleet.memory.replicas_reporting") == 2.0
        assert tracing.get_gauge(
            "fleet.replica.r0.headroom_bytes") == 2_000_000.0
        assert tracing.get_gauge(
            "fleet.memory.index.ivf:0.resident_bytes") == 8_000_000.0

    def test_no_replica_reporting(self):
        """A fleet of memory-block-free replicas merges to an honest
        zero-reporting block — no gauges invented."""
        agg = FleetAggregator({"r2": "http://r2/snapshot.json"},
                              clock=ManualClock(), fetch=fixture_fetch)
        mem = agg.fleet_snapshot()["memory"]
        assert mem["replicas_reporting"] == 0
        assert mem["headroom_min_bytes"] is None
        assert tracing.get_gauge(
            "fleet.memory.resident_bytes", -1.0) == -1.0

    def test_stale_replica_drops_from_memory(self):
        """Memory is instantaneous state: a stale replica's block
        leaves the merge (unlike its cumulative counters)."""
        clock = ManualClock()
        agg = fixture_aggregator(clock=clock)
        agg.fleet_snapshot()
        # r0 keeps scraping; r1 and r2 go dark past staleness
        working = dict(agg._states)
        def flaky(url, timeout):
            if "//r0/" in url:
                return load_replica("r0")
            raise OSError("down")
        agg._fetch = flaky
        clock.advance(agg.config.staleness_s + 1.0)
        mem = agg.fleet_snapshot()["memory"]
        assert mem["replicas_reporting"] == 1
        assert mem["headroom_min_bytes"] == 2_000_000.0
        assert mem["headroom_min_replica"] == "r0"

    def test_labeled_memory_exposition(self):
        """fleet_memory_index_resident_bytes renders {index=}-labeled
        through the exporter (the exposition parse-check satellite)."""
        agg = fixture_aggregator()
        exp = MetricsExporter(fleet=agg)
        text = exp.prometheus_text()
        assert ('fleet_memory_index_resident_bytes{index="ivf:0"} '
                "8000000") in text
        assert "# TYPE fleet_memory_index_resident_bytes gauge" in text
        assert 'fleet_replica_headroom_bytes{replica="r1"} 1500000' \
            in text


class TestPushMode:
    """Federation push mode: replicas behind NAT POST their
    /snapshot.json body; it enters the SAME type-correct merge path."""

    def setup_method(self):
        metrics.reset()
        tracing.reset_gauges("fleet.")

    def test_push_auto_registers_and_merges(self):
        clock = ManualClock()
        agg = FleetAggregator({}, clock=clock, fetch=fixture_fetch)
        agg.push("nat0", load_replica("r0"))
        out = agg.merge()
        assert out["size"] == 1 and out["healthy"] == 1
        assert out["replicas"]["nat0"]["healthy"]
        # the merge path is the shared one: lifetime-ledger counters
        assert out["counters"]["serving.execute.calls"] == 100.0
        assert out["memory"]["replicas_reporting"] == 1

    def test_push_replicas_are_never_fetched(self):
        fetched = []
        def spy(url, timeout):
            fetched.append(url)
            return fixture_fetch(url, timeout)
        agg = FleetAggregator({"r0": "http://r0/snapshot.json"},
                              clock=ManualClock(), fetch=spy)
        pushes0 = tracing.get_counter(fed_mod.PUSHES)
        agg.push("nat0", load_replica("r1"))
        agg.fleet_snapshot()
        assert fetched == ["http://r0/snapshot.json"]
        assert tracing.get_counter(fed_mod.PUSHES) == pushes0 + 1.0

    def test_pushed_counters_stay_monotone(self):
        """A pushed restart (ledger regression) clamps exactly like a
        scraped one — one merge path, one monotonicity contract."""
        clock = ManualClock()
        agg = FleetAggregator({}, clock=clock, fetch=fixture_fetch)
        agg.push("nat0", {"counters_lifetime":
                          {"serving.execute.calls": 100.0}})
        assert agg.merge()["counters"][
            "serving.execute.calls"] == 100.0
        v0 = tracing.get_counter(fed_mod.MONOTONICITY_VIOLATIONS)
        agg.push("nat0", {"counters_lifetime":
                          {"serving.execute.calls": 10.0}})
        assert agg.merge()["counters"][
            "serving.execute.calls"] == 100.0     # clamped
        assert tracing.get_counter(
            fed_mod.MONOTONICITY_VIOLATIONS) == v0 + 1

    def test_push_goes_stale_without_refresh(self):
        clock = ManualClock()
        agg = FleetAggregator({}, clock=clock, fetch=fixture_fetch)
        agg.push("nat0", load_replica("r0"))
        assert agg.merge()["healthy"] == 1
        clock.advance(agg.config.staleness_s + 1.0)
        out = agg.merge()
        assert out["healthy"] == 0
        # cumulative surfaces retain the stale lower bound
        assert out["counters"]["serving.execute.calls"] == 100.0

    def test_http_push_endpoint(self):
        import urllib.request as ur

        agg = FleetAggregator({}, clock=ManualClock(),
                              fetch=fixture_fetch)
        with MetricsExporter(fleet=agg) as exp:
            body = json.dumps(load_replica("r0")).encode()
            req = ur.Request(exp.url("/push?replica=nat0"), data=body,
                             method="POST")
            out = json.loads(ur.urlopen(req, timeout=10).read())
            assert out == {"accepted": "nat0"}
            # 400: no replica name
            req = ur.Request(exp.url("/push"), data=body,
                             method="POST")
            with pytest.raises(urllib.error.HTTPError) as e:
                ur.urlopen(req, timeout=10)
            assert e.value.code == 400
            # 400: body not a JSON object
            req = ur.Request(exp.url("/push?replica=nat0"),
                             data=b"[1,2]", method="POST")
            with pytest.raises(urllib.error.HTTPError) as e:
                ur.urlopen(req, timeout=10)
            assert e.value.code == 400
        assert agg.merge()["replicas"]["nat0"]["scrapes"] == 1

    def test_malformed_push_memory_block_costs_only_that_replica(self):
        """Review hardening: a pushed snapshot with garbage memory
        fields (null totals, list-typed resident map) must not poison
        the fleet merge for the staleness window — the bad replica's
        contribution drops, everyone else's survives."""
        clock = ManualClock()
        agg = FleetAggregator({}, clock=clock, fetch=fixture_fetch)
        agg.push("good", load_replica("r0"))
        agg.push("bad", {"counters_lifetime": {},
                         "memory": {"resident_total_bytes": None,
                                    "resident": [1, 2],
                                    "forecast_peak_bytes": "nan?",
                                    "headroom_bytes": "x"}})
        mem = agg.merge()["memory"]          # must not raise
        assert mem["replicas_reporting"] == 2
        assert mem["resident_bytes"] == 4_000_000.0   # r0 only
        assert mem["headroom_min_replica"] == "good"

    def test_push_registry_is_bounded(self):
        """Review hardening: the network-reachable push endpoint
        cannot grow the replica registry without bound."""
        import urllib.request as ur

        cfg = fed_mod.FleetConfig(max_push_replicas=2)
        agg = FleetAggregator({}, clock=ManualClock(),
                              fetch=fixture_fetch, config=cfg)
        agg.push("a", {"counters_lifetime": {}})
        agg.push("b", {"counters_lifetime": {}})
        agg.push("a", {"counters_lifetime": {}})    # re-push is fine
        with pytest.raises(ValueError, match="limit"):
            agg.push("c", {"counters_lifetime": {}})
        assert set(agg._states) == {"a", "b"}
        # over HTTP the refusal is a 429, telling the replica to back
        # off rather than silently dropping its snapshot
        with MetricsExporter(fleet=agg) as exp:
            req = ur.Request(exp.url("/push?replica=c"), data=b"{}",
                             method="POST")
            with pytest.raises(urllib.error.HTTPError) as e:
                ur.urlopen(req, timeout=10)
            assert e.value.code == 429

    def test_push_cannot_impersonate_scrape_replica(self):
        """Review hardening: an unauthenticated push must never
        overwrite a configured scrape replica's snapshot — that would
        ratchet its monotone high-water counters with whatever the
        pusher claims."""
        agg = fixture_aggregator()
        agg.fleet_snapshot()
        with pytest.raises(ValueError, match="scrape-mode"):
            agg.push("r0", {"counters_lifetime":
                            {"serving.slo.missed": 1e15}})
        # the real replica's clamped counters are untouched
        assert agg.merge()["counters"]["serving.slo.missed"] == 6.0

    def test_push_names_and_labels_sanitized(self):
        """Review hardening: network-supplied names/labels reach
        gauge registry names and Prometheus label values — quotes and
        newlines must never survive into the exposition."""
        agg = FleetAggregator({}, clock=ManualClock(),
                              fetch=fixture_fetch)
        agg.push('evil"}x\nup 1', {
            "counters_lifetime": {},
            "memory": {"resident_total_bytes": 10,
                       "resident": {'bad"label\n': 10},
                       "headroom_bytes": 5.0}})
        out = agg.merge()
        assert list(out["replicas"]) == ["evil--x-up-1"]
        assert list(out["memory"]["resident"]) == ["bad-label-"]
        text = MetricsExporter(fleet=agg).prometheus_text()
        for line in text.splitlines():
            assert '"}x' not in line and "up 1\"" not in line

    def test_memory_label_cardinality_bounded(self):
        """Review hardening: one replica's snapshot cannot mint
        unbounded per-index fleet gauges — top-N largest publish,
        stale labels retire."""
        agg = FleetAggregator({}, clock=ManualClock(),
                              fetch=fixture_fetch)
        resident = {f"idx{i}": float(i) for i in range(100)}
        agg.push("a", {"counters_lifetime": {},
                       "memory": {"resident_total_bytes": 1,
                                  "resident": resident}})
        agg.merge()
        published = tracing.gauges("fleet.memory.index.")
        assert len(published) == fed_mod.MEMORY_LABEL_CAP
        # largest residents won
        assert "fleet.memory.index.idx99.resident_bytes" in published
        assert "fleet.memory.index.idx0.resident_bytes" not in published
        # a later merge with fewer labels retires the stale ones
        agg.push("a", {"counters_lifetime": {},
                       "memory": {"resident_total_bytes": 1,
                                  "resident": {"only": 5.0}}})
        agg.merge()
        assert list(tracing.gauges("fleet.memory.index.")) == \
            ["fleet.memory.index.only.resident_bytes"]

    def test_nonfinite_pushed_values_are_garbage_not_measurements(self):
        """Review hardening: JSON ``1e999`` parses to inf — a pushed
        infinity must neither ratchet the monotone counter marks
        (which would crash the multiburn int() delta on every later
        merge) nor poison the fleet memory sums."""
        from raft_tpu_torch.serving import MultiBurnConfig
        from raft_tpu_torch.serving.metrics import SloConfig

        clock = ManualClock()
        agg = FleetAggregator(
            {}, clock=clock, fetch=fixture_fetch,
            config=fed_mod.FleetConfig(multiburn=MultiBurnConfig(
                short=SloConfig(window_s=300.0),
                long=SloConfig(window_s=3600.0))))
        agg.push("x", json.loads(
            '{"counters_lifetime": {"serving.slo.attained": 1e999,'
            ' "serving.execute.calls": 7.0},'
            ' "memory": {"resident_total_bytes": 1e999,'
            ' "resident": {"a": 1e999, "b": 5.0},'
            ' "headroom_bytes": 1e999}}'))
        out = agg.merge()                      # must not raise
        assert "serving.slo.attained" not in out["counters"]
        assert out["counters"]["serving.execute.calls"] == 7.0
        mem = out["memory"]
        assert mem["resident_bytes"] == 0.0    # inf dropped, honest 0
        assert mem["resident"] == {"a": 0.0, "b": 5.0} or \
            mem["resident"] == {"b": 5.0}
        assert mem["headroom_min_bytes"] is None
        # merges keep working afterwards (the poison would have been
        # permanent)
        clock.advance(1.0)
        agg.merge()

    def test_stale_memory_and_replica_gauges_retire(self):
        """Review hardening: a replica that stops reporting memory
        (or drops entirely) must not keep advertising its last
        headroom — stale room is what an operator would place the hot
        tier on."""
        clock = ManualClock()
        agg = FleetAggregator({}, clock=clock, fetch=fixture_fetch)
        agg.push("a", {"counters_lifetime": {},
                       "memory": {"resident_total_bytes": 10,
                                  "resident": {"i": 10},
                                  "headroom_bytes": 8e9}})
        agg.merge()
        assert tracing.get_gauge(
            "fleet.replica.a.headroom_bytes") == 8e9
        # the replica goes stale -> memory and headroom gauges retire
        clock.advance(agg.config.staleness_s + 1.0)
        agg.merge()
        assert tracing.get_gauge(
            "fleet.replica.a.headroom_bytes", -1.0) == -1.0
        assert tracing.get_gauge(
            "fleet.memory.resident_bytes", -1.0) == -1.0
        assert tracing.gauges("fleet.memory.index.") == {}
        # the replica itself is still listed (unhealthy), so its
        # health gauge re-publishes
        assert tracing.get_gauge("fleet.replica.a.healthy") == 0.0

    def test_http_push_404_without_aggregator(self):
        import urllib.request as ur

        with MetricsExporter() as exp:
            req = ur.Request(exp.url("/push?replica=x"), data=b"{}",
                             method="POST")
            with pytest.raises(urllib.error.HTTPError) as e:
                ur.urlopen(req, timeout=10)
            assert e.value.code == 404


class TestFleetBurnAlert:
    """Fleet-level multiburn alerting: per-merge deltas of the summed attained/missed fleet
    counters fold into a 5m+1h MultiBurnAlert pair under fleet.slo.*,
    ManualClock-pinned."""

    def setup_method(self):
        metrics.reset()
        tracing.reset_gauges("fleet.")

    def make(self, clock, short_s=300.0, long_s=3600.0):
        from raft_tpu_torch.serving import MultiBurnConfig
        from raft_tpu_torch.serving.metrics import SloConfig

        return FleetAggregator(
            {}, clock=clock, fetch=fixture_fetch,
            config=fed_mod.FleetConfig(multiburn=MultiBurnConfig(
                short=SloConfig(window_s=short_s, target=0.9),
                long=SloConfig(window_s=long_s, target=0.9))))

    def push_counts(self, agg, attained, missed):
        agg.push("a", {"counters_lifetime": {
            "serving.slo.attained": float(attained),
            "serving.slo.missed": float(missed)}})

    def test_first_merge_primes_baseline(self):
        """History predating the aggregator is not re-judged: the
        first merge seeds the delta baseline and records nothing."""
        clock = ManualClock()
        agg = self.make(clock)
        self.push_counts(agg, 1000, 500)
        out = agg.merge()
        assert out["slo"]["burn_rates"] == {"5m": 0.0, "1h": 0.0}
        assert out["slo"]["alert"] is False
        assert tracing.get_gauge("fleet.slo.alert") == 0.0

    def test_alert_fires_when_both_windows_burn(self):
        clock = ManualClock()
        agg = self.make(clock)
        self.push_counts(agg, 100, 0)
        agg.merge()
        # 50% misses over the next merge window: burn 0.5/0.1 = 5.0
        clock.advance(10.0)
        self.push_counts(agg, 110, 10)
        out = agg.merge()
        assert out["slo"]["burn_rates"]["5m"] == pytest.approx(5.0)
        assert out["slo"]["burn_rates"]["1h"] == pytest.approx(5.0)
        assert out["slo"]["alert"] is True
        assert tracing.get_gauge("fleet.slo.alert") == 1.0
        assert tracing.get_gauge(
            "fleet.slo.burn_rate.5m") == pytest.approx(5.0)

    def test_short_window_recovery_clears_alert(self):
        """The multiburn pattern at fleet scope: after the misses age
        out of the SHORT window, healthy merges clear the alert even
        while the long window still burns."""
        clock = ManualClock()
        agg = self.make(clock, short_s=60.0, long_s=3600.0)
        self.push_counts(agg, 100, 0)
        agg.merge()
        clock.advance(10.0)
        self.push_counts(agg, 100, 20)       # a burst of misses
        assert agg.merge()["slo"]["alert"] is True
        # an hour of healthy traffic later: short window clean, long
        # window still carries the burst
        clock.advance(120.0)
        self.push_counts(agg, 400, 20)
        out = agg.merge()
        assert out["slo"]["burn_rates"]["5m"] == 0.0
        assert out["slo"]["burn_rates"]["1h"] > 0.0
        assert out["slo"]["alert"] is False

    def test_no_multiburn_config_no_slo_block(self):
        agg = fixture_aggregator()
        assert "slo" not in agg.fleet_snapshot()
