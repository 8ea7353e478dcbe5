"""The port's observability functions against the JAX package's on the
same inputs, and the exporter's endpoints on the port.

- Pure functions: ``render_prometheus`` over the same registry
  snapshots, ``help_text`` / ``prom_name``, ``wilson_interval``,
  ``window_quantile``, ``merge_histograms``, ``index_health``,
  ``probe_freq_stats``, ``js_divergence`` and the straggler reductions
  give the JAX functions' outputs.
- ``MetricsExporter`` bound on ``127.0.0.1`` port 0 over the port's
  executor and batcher: ``/metrics``, ``/snapshot.json``, ``/trace.json
  ?trace_id=``, ``/profile`` (403 without ``profile_dir``, 400 outside
  [0, 60], 409 while busy, a trace written), ``/memory_profile``,
  ``/memory.json``, ``/tier.json``, ``/index.json``, ``/fleet.json``,
  ``/route.json`` and ``POST /push`` (404 with nothing attached; any
  object with the JAX method names otherwise) and ``/healthz``.
- The mirrored reducer cases of ``tests/test_tracing.py``.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import raft_tpu.core.tracing as j_tracing
import raft_tpu.serving.exporter as j_exporter
import raft_tpu.serving.federation as j_federation
import raft_tpu.serving.flight as j_flight
import raft_tpu.serving.gauge as j_gauge
from raft_tpu_torch import Resources, SearchExecutor
from raft_tpu_torch.core import memwatch, tracing
from raft_tpu_torch.neighbors import ivf_flat
from raft_tpu_torch.serving import (
    BatcherConfig,
    DynamicBatcher,
    MetricsExporter,
    metrics,
)
from raft_tpu_torch.serving import exporter as t_exporter
from raft_tpu_torch.serving import federation as t_federation
from raft_tpu_torch.serving import flight as t_flight
from raft_tpu_torch.serving import gauge as t_gauge
from raft_tpu_torch.serving.harness import ManualClock

RES = Resources(device="cpu")


def _registry(mod, seed):
    """Fill one package's registries with the same seeded values."""
    rng = np.random.default_rng(seed)
    mod.reset_counters("")
    mod.reset_gauges("")
    mod.reset_histograms("")
    mod.inc_counters({"serving.execute.calls": 12.0,
                      "serving.execute.rows.p8.t256": 40.0,
                      "serving.execute.padded_rows.p8.t256": 64.0,
                      "comms.allgather.calls": 3.0,
                      "index.probe_freq.accounted": 96.0})
    mod.set_gauges({
        "serving.executable.abcdef012345.flops": 2e6,
        "serving.executable.abcdef012345.bytes_accessed": 5e5,
        "serving.executable.abcdef012345.measured_gbps": 1.5,
        "serving.collective.dist_ivf_flat.f32.int8.merge_bytes": 640.0,
        "index.probe_freq.ivf_flat-abc123.total": 96.0,
        "index.probe_freq.ivf_flat-abc123.list.7": 11.0,
        "index.health.main.gini": 0.25,
        "index.drift.main.score": 0.1,
        "memory.index.main.resident_bytes": 1e6,
        "serving.mesh.shard_skew": 1e-4,
        "fleet.replica.r0.healthy": 1.0,
    })
    for v in rng.exponential(1e-3, 40):
        mod.observe("serving.batcher.e2e_seconds", float(v))
    for v in rng.exponential(2e-3, 10):
        mod.observe("serving.batcher.execute_seconds.p8", float(v))
    return (mod.counters(""), mod.gauges(""), mod.histograms(""))


@pytest.mark.parametrize("legacy", [False, True])
def test_render_prometheus_equals_jax(legacy):
    ours = _registry(tracing, 1)
    theirs = _registry(j_tracing, 1)
    assert ours == theirs
    assert t_exporter.render_prometheus(*ours, legacy) == \
        j_exporter.render_prometheus(*theirs, legacy)


@pytest.mark.parametrize("name", [
    "serving.batcher.e2e_seconds", "index.probe_freq.x.total",
    "fleet.route.replica.r1.steered", "memory.hbm.headroom_bytes",
    "comms.allgather.calls", "tier.swaps", "something.else"])
def test_help_and_prom_names_equal_jax(name):
    assert t_exporter.help_text(name) == j_exporter.help_text(name)
    assert t_exporter.prom_name(name) == j_exporter.prom_name(name)


@pytest.mark.parametrize("hits,trials", [(0, 0), (0, 10), (10, 10),
                                         (37, 50), (912, 1000)])
@pytest.mark.parametrize("z", [1.0, 1.96, 2.58])
def test_wilson_interval_equals_jax(hits, trials, z):
    assert t_gauge.wilson_interval(hits, trials, z) == \
        j_gauge.wilson_interval(hits, trials, z)


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("q", [0.5, 0.9, 0.99])
def test_window_quantile_equals_jax(seed, q):
    rng = np.random.default_rng(seed)
    bounds = [1e-6 * 2.0 ** i for i in range(12)]
    cum = np.cumsum(rng.integers(0, 5, len(bounds) + 1)).tolist()
    assert t_flight.window_quantile(bounds, cum, q) == \
        j_flight.window_quantile(bounds, cum, q)


def _hist_snap(seed):
    h = tracing.Histogram()
    for v in np.random.default_rng(seed).exponential(1e-3, 30):
        h.observe(float(v))
    return h.snapshot()


def test_merge_histograms_equals_jax():
    snaps = [_hist_snap(s) for s in range(3)]
    assert t_federation.merge_histograms(snaps) == \
        j_federation.merge_histograms(snaps)
    assert t_federation.merge_histograms([]) == \
        j_federation.merge_histograms([])


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("shards", [0, 2, 4])
def test_index_health_and_probe_stats_equal_jax(seed, shards):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 50, 16)
    sizes[rng.integers(0, 16)] = 0
    assert tracing.index_health(sizes, 48, shards) == \
        j_tracing.index_health(sizes, 48, shards)
    counts = rng.integers(0, 9, 16)
    assert tracing.probe_freq_stats(counts, 4) == \
        j_tracing.probe_freq_stats(counts, 4)


@pytest.mark.parametrize("seed", range(4))
def test_js_divergence_equals_jax(seed):
    rng = np.random.default_rng(seed)
    p, q = rng.integers(0, 20, 16), rng.integers(0, 20, 16)
    assert tracing.js_divergence(p, q) == j_tracing.js_divergence(p, q)
    assert tracing.js_divergence(p, np.zeros(16)) == 1.0
    assert tracing.js_divergence(np.zeros(4), np.zeros(4)) == 0.0


class TestMirroredReducers:
    """``tests/test_tracing.py``'s ``TestGraftgaugeReducers``."""

    def test_index_health_exact(self):
        h = tracing.index_health([0, 2, 2, 4], max_list_size=4, shards=2)
        assert h["rows"] == 8 and h["dead_lists"] == 1
        assert h["overflow_lists"] == 1
        assert h["fill_fraction"] == pytest.approx(0.5)
        assert h["shard_imbalance"] == pytest.approx(6 / 4)
        assert h["max_list_size"] == 4

    def test_index_health_gini_edges(self):
        assert tracing.index_health([5, 5, 5, 5])["gini"] == \
            pytest.approx(0.0)
        assert tracing.index_health([0, 0, 0, 8])["gini"] == \
            pytest.approx(0.75)

    def test_js_divergence_properties(self):
        p = np.array([1.0, 2.0, 3.0])
        assert tracing.js_divergence(p, p) == pytest.approx(0.0, abs=1e-12)
        assert tracing.js_divergence([1, 0], [0, 1]) == pytest.approx(1.0)
        a = tracing.js_divergence([1, 2, 3], [3, 2, 1])
        assert a == pytest.approx(tracing.js_divergence([3, 2, 1],
                                                        [1, 2, 3]))
        assert 0.0 < a < 1.0


# ---------------------------------------------------------------------------
# the exporter on the port
# ---------------------------------------------------------------------------


def _get(url, data=None):
    req = urllib.request.Request(url, data=data,
                                 method="POST" if data is not None
                                 else "GET")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture(scope="module")
def served():
    """A port executor with one IVF-Flat entry and a threadless batcher
    that served one traced request."""
    rng = np.random.default_rng(5)
    x = rng.integers(-4, 5, (800, 8)).astype(np.float32)
    idx = ivf_flat.build(RES, ivf_flat.IvfFlatIndexParams(n_lists=8), x)
    ex = SearchExecutor(RES, probe_accounting=True)
    clock = ManualClock()
    b = DynamicBatcher(ex, BatcherConfig(max_wait_s=0.0), clock=clock,
                       start=False)
    return {"x": x, "idx": idx, "ex": ex, "b": b, "clock": clock}


def _serve_one(served):
    metrics.reset()
    sp = ivf_flat.IvfFlatSearchParams(n_probes=3)
    h = served["b"].submit(served["idx"], served["x"][:4], 5, params=sp)
    served["b"].pump()
    return h


class TestExporter:
    def test_metrics_snapshot_and_trace(self, served):
        h = _serve_one(served)
        h.result(timeout=0)
        with MetricsExporter(executor=served["ex"],
                             batcher=served["b"]) as exp:
            code, body = _get(exp.url("/metrics"))
            assert code == 200
            text = body.decode()
            assert 'serving_batcher_e2e_seconds_bucket{le="+Inf"} 1' in text
            assert "serving_executable_bytes_accessed{digest=" in text
            code, body = _get(exp.url("/snapshot.json"))
            snap = json.loads(body)
            assert code == 200
            (info,) = snap["executables"].values()
            assert info["hlo_module"].startswith("rt_ivf_flat_")
            assert snap["derived"]["modeled_bytes_total"] == \
                info["bytes_accessed"]
            (span,) = tracing.span_recorder().spans(
                name="serving.admission")
            tid = span.trace_ids[0]
            code, body = _get(exp.url(f"/trace.json?trace_id={tid}"))
            events = json.loads(body)["traceEvents"]
            assert code == 200 and events
            assert all(tid in e["args"]["trace_ids"] for e in events
                       if e.get("ph") == "X")
            code, body = _get(exp.url("/trace.json?trace_id=999999999"))
            assert code == 200
            assert json.loads(body)["traceEvents"] == [] or all(
                e.get("ph") != "X" for e in json.loads(body)["traceEvents"])
            assert _get(exp.url("/healthz"))[0] == 200
            assert _get(exp.url("/nope"))[0] == 404

    def test_unattached_surfaces_are_404(self):
        with MetricsExporter() as exp:
            for path in ("/incident.json", "/memory.json", "/tier.json",
                         "/index.json", "/fleet.json", "/route.json"):
                assert _get(exp.url(path))[0] == 404, path
            assert _get(exp.url("/push?route=1"), b"{}")[0] == 404
            assert _get(exp.url("/push?replica=a"), b"{}")[0] == 404

    def test_profile_gate(self, tmp_path):
        with MetricsExporter() as exp:
            assert _get(exp.url("/profile?seconds=0"))[0] == 403
            assert _get(exp.url("/memory_profile"))[0] == 403
        with MetricsExporter(profile_dir=str(tmp_path)) as exp:
            assert _get(exp.url("/profile?seconds=61"))[0] == 400
            assert _get(exp.url("/profile?seconds=-1"))[0] == 400
            assert _get(exp.url("/profile?seconds=abc"))[0] == 400
            with exp._profile_lock:
                assert _get(exp.url("/profile?seconds=0"))[0] == 409
                assert _get(exp.url("/memory_profile"))[0] == 409
            code, body = _get(exp.url("/profile?seconds=0.01"))
            assert code == 200
            out = json.loads(body)
            assert set(out) == {"log_dir", "seconds", "trace_file"}
            assert out["trace_file"].startswith(str(tmp_path))

    def test_memory_profile_sequence_and_diff(self, tmp_path):
        with MetricsExporter(profile_dir=str(tmp_path)) as exp:
            code, body = _get(exp.url("/memory_profile"))
            assert code == 200
            first = json.loads(body)
            assert first["seq"] == 1 and first["path"].endswith(".pickle")
            code, body = _get(exp.url(f"/memory_profile?diff={first['seq']}"))
            out = json.loads(body)
            assert out["seq"] == 2
            assert out["diff"]["from_seq"] == 1 and out["diff"]["to_seq"] == 2
            # no card here: the snapshots are empty and so is the diff
            assert out["diff"]["deltas"] == []
            assert _get(exp.url("/memory_profile?diff=77"))[0] == 400

    def test_memory_and_index_surfaces(self, served):
        from raft_tpu_torch.serving import IndexGauge

        _serve_one(served)
        ledger = memwatch.MemoryLedger(executor=served["ex"])
        ledger.watch("main", served["idx"])
        gauge = IndexGauge(executor=served["ex"],
                           indexes={"main": served["idx"]})
        with MetricsExporter(executor=served["ex"], memory=ledger,
                             index_gauge=gauge) as exp:
            code, body = _get(exp.url("/memory.json"))
            assert code == 200
            mem = json.loads(body)
            assert mem["indexes"]["main"]["resident_bytes"] > 0
            code, body = _get(exp.url("/index.json"))
            assert code == 200
            out = json.loads(body)
            assert out["health"]["main"]["rows"] == 800
            (plane,) = out["probe_freq"].values()
            # lifetime totals: every 4-row request at 3 probes served
            # so far by the module's executor
            assert plane["total"] >= 4 * 3 and plane["total"] % 12 == 0
            text = _get(exp.url("/metrics"))[1].decode()
            assert 'index_health_rows{index="main"} 800' in text

    def test_route_endpoints_take_any_router(self):
        class Router:
            def __init__(self):
                self.version = 0

            def snapshot(self):
                return {"version": self.version}

            def apply_table(self, doc):
                if doc.get("version", 0) <= self.version:
                    return False
                self.version = doc["version"]
                return True

        r = Router()
        with MetricsExporter(route=r) as exp:
            assert json.loads(_get(exp.url("/route.json"))[1]) == {
                "version": 0}
            code, body = _get(exp.url("/push?route=1"),
                              json.dumps({"version": 2}).encode())
            assert code == 200 and json.loads(body) == {"applied": True}
            assert _get(exp.url("/push?route=1"),
                        json.dumps({"version": 2}).encode())[0] == 409
            assert _get(exp.url("/push?route=1"), b"not json")[0] == 400
            assert json.loads(_get(exp.url("/route.json"))[1]) == {
                "version": 2}

    def test_concurrent_scrapes_and_serving(self, served):
        """Scrapes while the batcher serves on another thread: every
        scrape answers, nothing raises."""
        errors = []
        with MetricsExporter(executor=served["ex"],
                             batcher=served["b"]) as exp:
            def scrape():
                for _ in range(5):
                    try:
                        assert _get(exp.url("/metrics"))[0] == 200
                    except Exception as e:  # noqa: BLE001
                        errors.append(e)

            t = threading.Thread(target=scrape)
            t.start()
            for _ in range(5):
                _serve_one(served).result(timeout=0)
            t.join()
        assert errors == []


class TestMeshSpansViaShim:
    """``tests/test_serving.py``'s ``TestMeshSpansViaShim``: the shim's
    scripted shard timings drive the straggler gauges through the
    batcher."""

    @staticmethod
    def _block(v):
        b = np.zeros((1, 4), np.float32)
        b[0, 0] = v
        return b

    def test_scripted_shard_skew_gauges_exact(self):
        from raft_tpu_torch.serving.harness import FakeExecutor, ShimExecutor

        metrics.reset()
        clock = ManualClock()
        shim = ShimExecutor(FakeExecutor(), clock=clock,
                            shard_times=[0.003, 0.011, 0.005, 0.004])
        b = DynamicBatcher(shim, BatcherConfig(max_wait_s=0.0),
                           clock=clock, start=False)
        idx = object()
        h1 = b.submit(idx, self._block(1), 3, timeout_s=5.0)
        h2 = b.submit(idx, self._block(2), 3, timeout_s=5.0)
        b.pump()
        assert h1.done() and h2.done()
        assert tracing.get_gauge(tracing.MESH_SHARD_SKEW) == \
            pytest.approx(0.008)
        assert tracing.get_gauge(tracing.MESH_SLOWEST_SHARD) == 1.0
        shards = tracing.span_recorder().spans(name="serving.mesh.shard")
        assert len(shards) == 4
        assert all(len(s.trace_ids) == 2 for s in shards)
        b.close()

    def test_per_call_scripts_by_ordinal(self):
        from raft_tpu_torch.serving.harness import FakeExecutor, ShimExecutor

        metrics.reset()
        clock = ManualClock()
        shim = ShimExecutor(FakeExecutor(), clock=clock,
                            shard_times={1: [0.002, 0.009]})
        b = DynamicBatcher(shim, BatcherConfig(max_wait_s=0.0),
                           clock=clock, start=False)
        idx = object()
        b.submit(idx, self._block(1), 3)
        b.pump()
        assert not tracing.span_recorder().spans(name="serving.mesh.shard")
        b.submit(idx, self._block(2), 3)
        b.pump()
        assert tracing.get_gauge(tracing.MESH_SHARD_SKEW) == \
            pytest.approx(0.007)
        b.close()
