"""The port's index gauge against the JAX package's tests
(``tests/test_gauge.py``): online recall from shadow queries through the
brute-force index, calibrated against exact recall; shadow work shed
first under overload; deterministic drift scores; ``IndexGauge`` and the
exporter's ``/index.json``. ManualClock, seeded sampler, threadless
batcher, on the CPU (``Resources(device="cpu")``).
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from raft_tpu_torch import Resources, SearchExecutor
from raft_tpu_torch.core import tracing
from raft_tpu_torch.neighbors import brute_force, ivf_flat
from raft_tpu_torch.serving import (
    BatcherConfig,
    DriftDetector,
    DynamicBatcher,
    IndexGauge,
    LoadShed,
    MetricsExporter,
    RecallWindow,
    ShadowConfig,
    ShadowSampler,
)
from raft_tpu_torch.serving import metrics
from raft_tpu_torch.serving.gauge import wilson_interval
from raft_tpu_torch.serving.harness import FakeExecutor, ManualClock

RES = Resources(device="cpu")


@pytest.fixture(scope="module")
def corpus():
    """Calibration corpus: big enough that n_probes=2/8 visibly
    misses, with a brute-force twin as ground truth."""
    rng = np.random.default_rng(42)
    x = rng.standard_normal((2000, 24)).astype(np.float32)
    q = rng.standard_normal((48, 24)).astype(np.float32)
    return {
        "x": x, "q": q,
        "ivf": ivf_flat.build(
            RES, ivf_flat.IvfFlatIndexParams(n_lists=16), x),
        "bf": brute_force.build(RES, x),
    }


def exact_recall(ivf_index, bf_index, q, k, params):
    """Host-side ground truth: recall@k of the ANN result against the
    brute-force ids over the SAME query block."""
    _, ann = ivf_flat.search(RES, params, ivf_index, q, k)
    _, truth = brute_force.search(RES, bf_index, q, k)
    ann, truth = np.asarray(ann), np.asarray(truth)
    hits = sum(int(np.isin(ann[r], truth[r][truth[r] >= 0]).sum())
               for r in range(ann.shape[0]))
    return hits / (ann.shape[0] * k)


class TestWilsonInterval:
    def test_edges(self):
        assert wilson_interval(0, 0) == (0.0, 1.0)
        lo, hi = wilson_interval(10, 10)
        assert lo < 1.0 and hi == 1.0
        lo, hi = wilson_interval(0, 10)
        assert lo == 0.0 and hi > 0.0

    def test_narrows_with_trials(self):
        lo1, hi1 = wilson_interval(8, 10)
        lo2, hi2 = wilson_interval(800, 1000)
        assert (hi2 - lo2) < (hi1 - lo1)
        assert lo2 < 0.8 < hi2


class TestRecallWindow:
    def test_estimate_and_slide(self):
        metrics.reset()
        w = RecallWindow(window_s=10.0)
        w.record(0.0, hits=9, trials=10)
        w.record(5.0, hits=5, trials=10)
        e = w.estimate(5.0)
        assert e["estimate"] == pytest.approx(14 / 20)
        assert e["pairs"] == 2
        assert tracing.get_gauge(tracing.RECALL_ESTIMATE) == (
            pytest.approx(14 / 20))
        # the first pair ages out of the window
        e = w.estimate(10.5)
        assert e["estimate"] == pytest.approx(5 / 10)
        assert e["pairs"] == 1
        # empty window is maximally uncertain, not confidently zero
        e = w.estimate(100.0)
        assert e["estimate"] == 0.0
        assert (e["ci_low"], e["ci_high"]) == (0.0, 1.0)


class TestShadowSampler:
    def _serve(self, corpus, fraction, seed, n_probes=2, k=10,
               rounds=6, rows=8):
        """Drive the live+shadow loop threadless; returns the sampler
        after all pairs resolve."""
        ex = SearchExecutor(RES)
        clock = ManualClock()
        b = DynamicBatcher(
            ex, BatcherConfig(max_wait_s=0.0,
                              shed=LoadShed(background_priority=100)),
            clock=clock, start=False)
        sampler = ShadowSampler(
            b, corpus["bf"],
            ShadowConfig(fraction=fraction, seed=seed, priority=100,
                         timeout_s=None, window_s=1e9))
        p = ivf_flat.IvfFlatSearchParams(n_probes=n_probes)
        q = corpus["q"]
        for r in range(rounds):
            block = q[(r * rows) % 40:(r * rows) % 40 + rows]
            sampler.submit(corpus["ivf"], block, k, params=p)
            while b.pump():
                pass
        sampler.pump()
        b.close()
        return sampler

    def test_estimate_calibrated_within_002(self, corpus):
        """Acceptance: with every shadow completing, the windowed
        estimate lands within ±0.02 of exact recall on the SAME
        queries (here it is exactly equal — same pairs, same
        arithmetic — so the band is pure safety margin)."""
        metrics.reset()
        p = ivf_flat.IvfFlatSearchParams(n_probes=2)
        sampler = self._serve(corpus, fraction=1.0, seed=3)
        e = sampler.window.estimate(sampler._clock.now())
        assert e["pairs"] == 6
        truth = exact_recall(corpus["ivf"], corpus["bf"],
                             corpus["q"][:40], 10, p)
        assert 0.2 < truth < 0.999      # the corpus really misses
        assert abs(e["estimate"] - truth) <= 0.02
        assert e["ci_low"] <= e["estimate"] <= e["ci_high"]
        assert tracing.get_counter(
            "index.recall.shadow_completed") == 6

    def test_sampled_subset_is_seed_deterministic(self, corpus):
        metrics.reset()
        s1 = self._serve(corpus, fraction=0.5, seed=11)
        n1 = tracing.get_counter("index.recall.shadow_submitted")
        e1 = s1.window.estimate(s1._clock.now())
        metrics.reset()
        s2 = self._serve(corpus, fraction=0.5, seed=11)
        n2 = tracing.get_counter("index.recall.shadow_submitted")
        e2 = s2.window.estimate(s2._clock.now())
        assert n1 == n2 > 0
        assert e1 == e2

    def test_shadow_sheds_first_under_overload(self):
        """Injected overload: occupancy >= background_reject_at makes
        the queue reject SHADOW submissions with typed Overloaded
        while the live path still admits — the recall estimator
        degrades (fewer samples) before any live request queues behind
        shadow work."""
        metrics.reset()
        ex = FakeExecutor()
        clock = ManualClock()
        b = DynamicBatcher(
            ex,
            BatcherConfig(max_wait_s=1.0, capacity=8,
                          shed=LoadShed(background_priority=100,
                                        background_reject_at=0.5)),
            clock=clock, start=False)

        class _Idx:
            pass

        live_idx, exact_idx = _Idx(), _Idx()
        sampler = ShadowSampler(b, exact_idx,
                                ShadowConfig(fraction=1.0, seed=0,
                                             priority=100))
        blk = np.zeros((1, 4), np.float32)
        # fill to occupancy 0.5 without pumping
        for _ in range(4):
            b.submit(live_idx, blk, 3)
        h = sampler.submit(live_idx, blk, 3)
        # live admitted (queue depth grew), shadow rejected + counted
        assert tracing.get_counter("index.recall.shadow_shed") == 1
        assert tracing.get_counter(
            "serving.admission.rejected_background") == 1
        assert tracing.get_counter(
            "index.recall.shadow_submitted") == 0
        clock.advance(1.0)
        while b.pump():
            pass
        assert h.result(timeout=0) is not None   # live unharmed
        b.close()

    def test_shadow_below_threshold_admits(self):
        metrics.reset()
        b = DynamicBatcher(
            FakeExecutor(),
            BatcherConfig(max_wait_s=1.0, capacity=8,
                          shed=LoadShed(background_priority=100,
                                        background_reject_at=0.5)),
            clock=ManualClock(), start=False)

        class _Idx:
            pass

        sampler = ShadowSampler(b, _Idx(),
                                ShadowConfig(fraction=1.0, seed=0,
                                             priority=100))
        sampler.submit(_Idx(), np.zeros((1, 4), np.float32), 3)
        assert tracing.get_counter(
            "index.recall.shadow_submitted") == 1
        assert tracing.get_counter("index.recall.shadow_shed") == 0
        b.close()


class TestDriftDetector:
    def test_score_rises_with_shifted_traffic_and_holds_quiet(self):
        baseline = np.full(16, 100.0)       # even build-time histogram
        det = DriftDetector(baseline, alpha=1.0, alert_threshold=0.3)
        assert det.score == 0.0 and not det.alert
        # live traffic matching the baseline: no drift
        cum = np.full(16, 5.0)
        assert det.update(cum) == pytest.approx(0.0)
        # traffic collapses onto 2 of 16 lists: strong drift
        cum2 = cum.copy()
        cum2[:2] += 500.0
        s = det.update(cum2)
        assert s > 0.3 and det.alert
        # a quiet scrape (no new probes) holds the score
        assert det.update(cum2) == s
        assert det.updates == 2

    def test_ewma_smooths_single_scrape_spike(self):
        baseline = np.full(8, 10.0)
        det = DriftDetector(baseline, alpha=0.2)
        even = np.full(8, 10.0)
        det.update(even)
        spike = even + np.eye(8)[0] * 1000.0
        s_smooth = det.update(spike)
        det2 = DriftDetector(baseline, alpha=1.0)
        det2.update(even)
        s_raw = det2.update(spike)
        assert 0.0 < s_smooth < s_raw

    def test_deterministic_sequence(self):
        rng = np.random.default_rng(5)
        baseline = rng.integers(1, 50, size=32)
        cums = np.cumsum(rng.integers(0, 9, size=(6, 32)), axis=0)
        runs = []
        for _ in range(2):
            det = DriftDetector(baseline)
            runs.append([det.update(c) for c in cums])
        assert runs[0] == runs[1]          # bit-equal, not approx


class TestIndexGauge:
    def test_publish_and_index_json(self, corpus):
        metrics.reset()
        ex = SearchExecutor(RES, probe_accounting=True)
        clock = ManualClock()
        b = DynamicBatcher(ex, BatcherConfig(max_wait_s=0.0),
                           clock=clock, start=False)
        sampler = ShadowSampler(
            b, corpus["bf"], ShadowConfig(fraction=1.0, seed=1,
                                          timeout_s=None))
        p = ivf_flat.IvfFlatSearchParams(n_probes=4)
        sampler.submit(corpus["ivf"], corpus["q"][:8], 5, params=p)
        while b.pump():
            pass
        det = DriftDetector.from_index(corpus["ivf"])
        gauge = IndexGauge(executor=ex, indexes={"main": corpus["ivf"]},
                           sampler=sampler, drift={"main": det})
        with MetricsExporter(executor=ex, batcher=b,
                             index_gauge=gauge) as exp:
            body = json.loads(urllib.request.urlopen(
                exp.url("/index.json"), timeout=10).read())
            assert body["health"]["main"]["n_lists"] == 16
            assert body["health"]["main"]["rows"] == 2000
            assert body["recall"]["pairs"] == 1
            assert body["drift"]["main"]["updates"] == 1
            label = ex.probe_label(corpus["ivf"])
            assert body["probe_freq"][label]["total"] == 8 * 4
            # gauges landed for every surface
            assert tracing.get_gauge(
                "index.health.main.dead_lists") >= 0.0
            assert tracing.get_gauge(
                f"index.probe_freq.{label}.total") == 8 * 4
            assert tracing.gauges("index.drift.main.")
            # and the scrape exposes them as LABELED prom families
            text = urllib.request.urlopen(
                exp.url("/metrics"), timeout=10).read().decode()
            assert f'index_probe_freq_total{{index="{label}"}}' in text
            assert 'index_health_rows{index="main"} 2000' in text
            assert 'index_drift_score{index="main"}' in text
        b.close()

    def test_index_json_404_when_unattached(self):
        with MetricsExporter() as exp:
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(exp.url("/index.json"),
                                       timeout=10)
            assert ei.value.code == 404

    def test_drift_pairs_with_live_plane_via_probe_label(self, corpus):
        """The detector watches the executor's REAL probe plane: live
        traffic matching the build distribution scores near zero;
        after the baseline is skewed away, the same traffic alerts."""
        metrics.reset()
        ex = SearchExecutor(RES, probe_accounting=True)
        p = ivf_flat.IvfFlatSearchParams(n_probes=4)
        ex.search(corpus["ivf"], corpus["q"], 5, params=p)
        det = DriftDetector.from_index(corpus["ivf"],
                                       alert_threshold=0.5)
        gauge = IndexGauge(executor=ex,
                           indexes={"main": corpus["ivf"]},
                           drift={"main": det})
        gauge.publish()
        assert det.updates == 1
        low = det.score
        assert 0.0 <= low < 0.5
        skewed = np.zeros(16)
        skewed[0] = 1.0                      # everything in one list
        det2 = DriftDetector(skewed)
        gauge2 = IndexGauge(executor=ex,
                            indexes={"main": corpus["ivf"]},
                            drift={"main": det2})
        ex.search(corpus["ivf"], corpus["q"], 5, params=p)
        gauge2.publish()
        assert det2.score > low
        assert tracing.get_gauge(tracing.DRIFT_SCORE) == det2.score


class TestReviewHardening:
    """Hardening cases: filtered requests, failed live legs, window resets, dead indexes."""

    def test_filtered_requests_are_never_shadowed(self, corpus):
        """Recall must compare ANN against exact truth over the SAME
        candidate set; the brute-force shadow leg has no filter
        support, so a filtered pair would score healthy traffic
        against the unfiltered truth and read permanently stale.
        Filtered submissions skip shadowing (counted) instead."""
        from raft_tpu_torch.core.bitset import Bitset
        from raft_tpu_torch.neighbors.filters import BitsetFilter

        metrics.reset()
        n = corpus["x"].shape[0]
        keep = np.zeros(n, bool)
        keep[: n // 2] = True              # exclude half the corpus
        filt = BitsetFilter(Bitset.from_mask(keep))
        ex = SearchExecutor(RES)
        clock = ManualClock()
        b = DynamicBatcher(ex, BatcherConfig(max_wait_s=0.0),
                           clock=clock, start=False)
        sampler = ShadowSampler(
            b, corpus["bf"], ShadowConfig(fraction=1.0, seed=2,
                                          timeout_s=None))
        p = ivf_flat.IvfFlatSearchParams(n_probes=4)
        q = corpus["q"][:16]
        h = sampler.submit(corpus["ivf"], q, 10, params=p,
                           sample_filter=filt)
        while b.pump():
            pass
        # the live (filtered) leg served normally...
        _, ids = h.result(timeout=0)
        assert (np.asarray(ids) < n // 2).all()   # filter honored
        # ...but no pair formed: skipped, not mis-scored
        assert sampler.pump() == 0
        assert tracing.get_counter(
            "index.recall.shadow_skipped") == 1
        assert tracing.get_counter(
            "index.recall.shadow_submitted") == 0
        assert sampler.window.estimate(clock.now())["pairs"] == 0
        b.close()

    def test_live_failure_balances_shadow_ledger(self):
        """A pair whose LIVE leg was shed still resolves into the
        lifecycle ledger (dropped), so submitted == completed +
        shed-after-admission + dropped."""
        metrics.reset()
        clock = ManualClock()
        b = DynamicBatcher(FakeExecutor(),
                           BatcherConfig(max_wait_s=0.05),
                           clock=clock, start=False)

        class _Idx:
            pass

        sampler = ShadowSampler(b, _Idx(),
                                ShadowConfig(fraction=1.0, seed=0,
                                             timeout_s=None))
        # live expires in-queue; the (no-deadline) shadow completes
        sampler.submit(_Idx(), np.zeros((1, 4), np.float32), 3,
                       timeout_s=0.01)
        clock.advance(0.1)
        while b.pump():
            pass
        assert sampler.pump() == 0
        assert tracing.get_counter("index.recall.shadow_dropped") == 1
        submitted = tracing.get_counter("index.recall.shadow_submitted")
        resolved = (tracing.get_counter("index.recall.shadow_completed")
                    + tracing.get_counter("index.recall.shadow_shed")
                    + tracing.get_counter("index.recall.shadow_dropped"))
        assert submitted == resolved == 1
        b.close()

    def test_probe_window_reset_keeps_totals_monotone(self, corpus):
        """Each scrape claims its window (device plane resets to
        zero; totals accumulate host-side in int64) — repeated quiet
        scrapes change nothing and never double-count."""
        metrics.reset()
        ex = SearchExecutor(RES, probe_accounting=True)
        p = ivf_flat.IvfFlatSearchParams(n_probes=4)
        ex.search(corpus["ivf"], corpus["q"][:16], 5, params=p)
        (t1,) = ex.probe_frequencies().values()
        assert t1.dtype == np.int64 and t1.sum() == 16 * 4
        assert tracing.get_counter(
            "index.probe_freq.accounted") == 16 * 4
        # quiet scrapes: totals identical, accounted unmoved
        (t2,) = ex.probe_frequencies().values()
        np.testing.assert_array_equal(t1, t2)
        assert tracing.get_counter(
            "index.probe_freq.accounted") == 16 * 4
        # more traffic accumulates on top
        ex.search(corpus["ivf"], corpus["q"][:16], 5, params=p)
        (t3,) = ex.probe_frequencies().values()
        assert t3.sum() == 2 * 16 * 4
        np.testing.assert_array_equal(t3, 2 * t1)

    def test_dead_index_plane_evicted(self):
        """A garbage-collected index's plane (and label) must not be
        inherited by a new index reusing its address."""
        import gc

        rng = np.random.default_rng(0)
        x = rng.standard_normal((400, 8)).astype(np.float32)
        q = rng.standard_normal((8, 8)).astype(np.float32)
        ex = SearchExecutor(RES, probe_accounting=True)
        p = ivf_flat.IvfFlatSearchParams(n_probes=2)
        idx = ivf_flat.build(
            RES, ivf_flat.IvfFlatIndexParams(n_lists=8), x)
        ex.search(idx, q, 5, params=p)
        assert len(ex.probe_frequencies()) == 1
        del idx
        gc.collect()
        assert ex.probe_frequencies() == {}


class TestRecallWindowDecay:
    """Exponential-decay weighting: recent pairs dominate, so
    the estimate reacts to sudden staleness within a couple of
    half-lives; default (uniform) behavior unchanged."""

    def test_decay_weights_pinned(self):
        metrics.reset()
        w = RecallWindow(window_s=100.0, decay_half_life_s=10.0)
        w.record(0.0, hits=10, trials=10)   # perfect recall, old
        w.record(10.0, hits=0, trials=10)   # total miss, fresh
        # at t=10 the old pair weighs 0.5: est = 5 / 15
        e = w.estimate(10.0)
        assert e["estimate"] == pytest.approx(5.0 / 15.0)
        # uniform window would read 0.5 — decay reacts faster
        u = RecallWindow(window_s=100.0)
        u.record(0.0, hits=10, trials=10)
        u.record(10.0, hits=0, trials=10)
        assert u.estimate(10.0)["estimate"] == pytest.approx(0.5)
        # aging both pairs equally preserves their weight RATIO — the
        # estimate holds until newer evidence (or the window) moves it
        e = w.estimate(30.0)
        assert e["estimate"] == pytest.approx(5.0 / 15.0)

    def test_decay_widens_ci_as_evidence_ages(self):
        w = RecallWindow(window_s=1000.0, decay_half_life_s=10.0)
        w.record(0.0, hits=90, trials=100)
        fresh = w.estimate(0.0)
        old = w.estimate(50.0)
        assert old["estimate"] == pytest.approx(fresh["estimate"])
        assert (old["ci_high"] - old["ci_low"]) > (
            fresh["ci_high"] - fresh["ci_low"])

    def test_window_prune_still_applies(self):
        w = RecallWindow(window_s=10.0, decay_half_life_s=5.0)
        w.record(0.0, hits=10, trials=10)
        assert w.estimate(11.0)["pairs"] == 0


class TestDriftRebaseline:
    """extend()/rebuild shifts ``list_sizes`` — the detector must
    refresh its baseline when the watched index changes identity or
    shape, not score live traffic against the stale histogram."""

    def _corpus(self, n_lists=8, n=400, seed=0):
        rng = np.random.default_rng(seed)
        x = rng.standard_normal((n, 8)).astype(np.float32)
        q = rng.standard_normal((8, 8)).astype(np.float32)
        idx = ivf_flat.build(
            RES, ivf_flat.IvfFlatIndexParams(n_lists=n_lists), x)
        return x, q, idx

    def test_matches_and_watch(self):
        _, _, idx = self._corpus()
        det = DriftDetector.from_index(idx)
        assert det.matches(idx)
        _, _, other = self._corpus(seed=1)
        assert not det.matches(other)      # different identity
        raw = DriftDetector(np.ones(8))
        assert raw.matches(idx)            # raw baseline adopts shape
        assert not raw.matches(
            ivf_flat.build(RES, ivf_flat.IvfFlatIndexParams(
                n_lists=4), np.random.default_rng(2).standard_normal(
                    (64, 8)).astype(np.float32)))

    def test_extend_triggers_rebaseline_via_gauge(self):
        x, q, idx = self._corpus()
        ex = SearchExecutor(RES, probe_accounting=True)
        p = ivf_flat.IvfFlatSearchParams(n_probes=2)
        det = DriftDetector.from_index(idx)
        gauge = IndexGauge(executor=ex, indexes={"main": idx},
                           drift={"main": det})
        ex.search(idx, q, 5, params=p)
        out = gauge.publish()
        assert out["drift"]["main"]["rebaselines"] == 0
        base0 = det.baseline.copy()
        # extend returns a NEW index object with shifted list_sizes
        rng = np.random.default_rng(3)
        new_rows = rng.standard_normal((150, 8)).astype(np.float32)
        idx2 = ivf_flat.extend(RES, idx, new_rows)
        gauge.indexes["main"] = idx2
        ex.search(idx2, q, 5, params=p)
        out = gauge.publish()
        assert out["drift"]["main"]["rebaselines"] == 1
        assert det.matches(idx2)
        assert not np.array_equal(det.baseline, base0)
        np.testing.assert_array_equal(
            det.baseline, np.asarray(idx2.list_sizes, dtype=np.float64))
        # the same scrape then scores the NEW index's (fresh) plane
        # against the fresh baseline — only post-rebaseline traffic,
        # never the old index's history
        assert det.updates == 1
        assert tracing.get_gauge("index.drift.main.rebaselines") == 1.0
        # further scrapes with the SAME index do not rebaseline again
        ex.search(idx2, q, 5, params=p)
        out = gauge.publish()
        assert out["drift"]["main"]["rebaselines"] == 1

    def test_shape_change_rebaselines_and_scores_clean(self):
        """A rebuilt index with a different n_lists must swap baseline
        AND streaming state (stale planes would be the wrong
        length)."""
        x, q, idx = self._corpus(n_lists=8)
        det = DriftDetector.from_index(idx)
        det.update(np.arange(8, dtype=np.float64))   # some history
        x2 = np.random.default_rng(4).standard_normal(
            (400, 8)).astype(np.float32)
        idx2 = ivf_flat.build(
            RES, ivf_flat.IvfFlatIndexParams(n_lists=16), x2)
        assert not det.matches(idx2)
        det.rebaseline(idx2)
        assert det.baseline.shape == (16,)
        assert det.score == 0.0 and det.rebaselines == 1
        # the next update scores against the fresh baseline cleanly
        det.update(np.asarray(idx2.list_sizes, dtype=np.float64))
        assert det.score == pytest.approx(0.0, abs=1e-9)


class TestParamsSweepShadow:
    """Params-sweep shadow sampling: sampled
    submissions re-run at alternative n_probes as extra background
    legs against the same exact truth, so the recall gauges map the
    live recall frontier, not just the operating point. ManualClock +
    seeded sampler + threadless batcher = fully deterministic."""

    def _serve_sweep(self, corpus, sweep, rounds=6, rows=8, k=10):
        ex = SearchExecutor(RES)
        clock = ManualClock()
        b = DynamicBatcher(
            ex, BatcherConfig(max_wait_s=0.0,
                              shed=LoadShed(background_priority=100)),
            clock=clock, start=False)
        sampler = ShadowSampler(
            b, corpus["bf"],
            ShadowConfig(fraction=1.0, seed=3, priority=100,
                         timeout_s=None, window_s=1e9,
                         sweep_probes=sweep))
        p = ivf_flat.IvfFlatSearchParams(n_probes=2)
        q = corpus["q"]
        for r in range(rounds):
            block = q[(r * rows) % 40:(r * rows) % 40 + rows]
            sampler.submit(corpus["ivf"], block, k, params=p)
            while b.pump():
                pass
        sampler.publish()
        b.close()
        return sampler

    def test_sweep_windows_map_the_frontier(self, corpus):
        metrics.reset()
        sampler = self._serve_sweep(corpus, sweep=(4, 16))
        now = sampler._clock.now()
        # legs rotate round-robin: 6 sampled rounds -> 3 pairs each
        e4 = sampler.sweep_windows[4].estimate(now)
        e16 = sampler.sweep_windows[16].estimate(now)
        assert e4["pairs"] == 3 and e16["pairs"] == 3
        # deeper probes -> higher recall, and both bracket the
        # operating point (n_probes=2) from above
        e_op = sampler.window.estimate(now)
        assert e_op["pairs"] == 6
        assert e_op["estimate"] < e4["estimate"] <= e16["estimate"], (
            e_op["estimate"], e4["estimate"], e16["estimate"])
        # each sweep window's estimate matches exact recall at ITS
        # n_probes on ITS sampled blocks (same pairs, same arithmetic)
        q = corpus["q"]
        for probes, est, blocks in ((4, e4, (0, 2, 4)),
                                    (16, e16, (1, 3, 5))):
            hits = trials = 0
            pp = ivf_flat.IvfFlatSearchParams(n_probes=probes)
            for r in blocks:
                block = q[(r * 8) % 40:(r * 8) % 40 + 8]
                truth = exact_recall(corpus["ivf"], corpus["bf"],
                                     block, 10, pp)
                hits += truth * 8 * 10
                trials += 8 * 10
            assert abs(est["estimate"] - hits / trials) <= 0.02

    def test_sweep_gauges_published(self, corpus):
        metrics.reset()
        self._serve_sweep(corpus, sweep=(4,))
        assert tracing.get_gauge(
            "index.recall.sweep.p4.estimate") > 0.0
        # a single sweep value gets every sampled round: 6 pairs
        assert tracing.get_gauge(
            "index.recall.sweep.p4.window_pairs") == 6.0
        # the operating-point family is untouched by the sweep legs
        assert tracing.get_gauge("index.recall.window_pairs") == 6.0
        # lifecycle ledger still sums per PAIR (live + sweep legs)
        assert tracing.get_counter("index.recall.shadow_submitted") \
            == tracing.get_counter("index.recall.shadow_completed") == 12

    def test_sweep_is_deterministic(self, corpus):
        metrics.reset()
        s1 = self._serve_sweep(corpus, sweep=(4, 16))
        e1 = s1.sweep_windows[4].estimate(s1._clock.now())
        metrics.reset()
        s2 = self._serve_sweep(corpus, sweep=(4, 16))
        e2 = s2.sweep_windows[4].estimate(s2._clock.now())
        assert e1 == e2

    def test_paramsless_submission_sweeps_nothing(self, corpus):
        """A submission without an n_probes knob (params=None) takes
        the plain shadow path — no sweep leg, no crash."""
        metrics.reset()
        ex = SearchExecutor(RES)
        b = DynamicBatcher(
            ex, BatcherConfig(max_wait_s=0.0,
                              shed=LoadShed(background_priority=100)),
            clock=ManualClock(), start=False)
        sampler = ShadowSampler(
            b, corpus["bf"],
            ShadowConfig(fraction=1.0, seed=3, priority=100,
                         timeout_s=None, sweep_probes=(4,)))
        sampler.submit(corpus["bf"], corpus["q"][:8], 10)
        while b.pump():
            pass
        sampler.pump()
        b.close()
        assert tracing.get_counter("index.recall.shadow_submitted") == 1
