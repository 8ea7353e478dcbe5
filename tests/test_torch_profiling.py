"""The port's device-truth attribution (``core/profiling``) and incident
capture (``serving/flight``) against the JAX package's
``tests/test_profiling.py``.

- The fixture is the JAX package's committed capture recast as a
  ``torch.profiler`` trace (``tests/data/torch_profiler_capture.trace
  .json``, equal to :func:`kineto_from_jax` of the JAX fixture): every
  device op a ``kernel`` on its device's track inside
  ``gpu_user_annotation`` ranges named after its entry and scope path.
  Its correlation, invocation windows, publication and rolling folds are
  pinned by the JAX package's own numbers, and equal the JAX functions'
  on the same ``DeviceOp`` lists.
- A hand-written trace shaped like Kineto's (kernels, a memcpy and a
  memset launched from ``user_annotation`` ranges on a CPU thread, a
  ``cudaGraphLaunch`` whose replay shows only part of its kernels, a
  kernel outside every entry) pins the parser, and the timed calls of a
  capture window supply an entry's device seconds and invocations.
- The flight recorder, the exporter's ``/incident.json`` and
  ``/profile`` and the per-params-class latency histograms, ManualClock-
  pinned, as in the JAX package.
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

import raft_tpu.core.profiling as j_profiling
import raft_tpu.core.tracing as j_tracing
from raft_tpu_torch import Resources, SearchExecutor
from raft_tpu_torch.core import profiling, tracing
from raft_tpu_torch.neighbors import ivf_flat
from raft_tpu_torch.serving import (
    BatcherConfig,
    DynamicBatcher,
    FlightConfig,
    FlightRecorder,
    LatencyAnomaly,
    MetricsExporter,
    MultiBurnConfig,
    SloConfig,
)
from raft_tpu_torch.serving import flight as flight_mod
from raft_tpu_torch.serving import metrics
from raft_tpu_torch.serving.harness import FakeExecutor, ManualClock

RES = Resources(device="cpu")
DATA = os.path.join(os.path.dirname(__file__), "data")
JAX_FIXTURE = os.path.join(DATA, "graftflight_capture.trace.json")
FIXTURE = os.path.join(DATA, "torch_profiler_capture.trace.json")


def kineto_from_jax(path):
    """A ``torch.profiler``-shaped Chrome trace carrying the same device
    ops as a JAX capture: each ``hlo_module`` event becomes a ``kernel``
    on its device's track, enclosed by ``gpu_user_annotation`` ranges
    named after its module (``jit_rt_*`` -> ``rt_*``, the port's entry
    names) and its scope path."""
    with open(path) as f:
        data = json.load(f)
    out = [ev for ev in data["traceEvents"]
           if ev.get("ph") == "M" and ev.get("name") == "process_name"]
    for ev in data["traceEvents"]:
        args = ev.get("args") or {}
        if ev.get("ph") != "X" or not args.get("hlo_module"):
            continue
        module = args["hlo_module"]
        if module.startswith("jit_"):
            module = module[len("jit_"):]
        scope = ""
        for key in ("tf_op", "long_name", "op_name", "scope"):
            if args.get(key):
                scope = str(args[key])
                break
        names = [module] + [p for p in scope.split("/") if p]
        base = {"ph": "X", "pid": ev["pid"], "tid": 7, "ts": ev["ts"],
                "dur": ev["dur"]}
        for name in names:
            out.append(dict(base, cat="gpu_user_annotation", name=name))
        out.append(dict(base, cat="kernel",
                        name=args.get("hlo_op", ev.get("name", "")),
                        args={"correlation": -1}))
    return {"traceEvents": out}


# the cost table the fixture's modules correlate against — the shape
# SearchExecutor.executable_costs() produces, with round numbers so
# the measured achieved GB/s pins exactly:
#   single-chip: 270 kB/call x 3 invocations / 810 us = 1.0 GB/s
#   mesh:        1.3 MB/call x 2 invocations / 2600 us = 1.0 GB/s
FIXTURE_COSTS = {
    "aaaa01aaaa01": {
        "hlo_module": "rt_ivf_flat_aaaa01aaaa01",
        "family": "ivf_flat", "bucket": 8, "k": 5,
        "bytes_accessed": 270_000.0, "flops": 540_000.0,
    },
    "bbbb02bbbb02": {
        "hlo_module": "rt_dist_ivf_flat_bbbb02bbbb02",
        "family": "dist_ivf_flat", "bucket": 16, "k": 5,
        "bytes_accessed": 1_300_000.0, "flops": 2_600_000.0,
        "collective_payload": {
            "coarse_bytes": 2048, "dense_coarse_bytes": 8192,
            "merge_bytes": 512, "wire_dtype": "f32",
            "probe_wire_dtype": "f32"},
    },
}


def fixture_attr():
    return profiling.attribute(FIXTURE, FIXTURE_COSTS)


class TestCorrelation:
    def test_fixture_pinned(self):
        attr = fixture_attr()
        assert set(attr.modules) == set(FIXTURE_COSTS)
        a = attr.modules["aaaa01aaaa01"]
        # 100+200+300 (dot) + 3x50 (fusion) + 6x10 (loop-body) us
        assert a.device_seconds == pytest.approx(810e-6, rel=1e-9)
        # min per-(device, op) count: the loop-body op appears 6x but
        # the module ran 3x — max would read 6 and inflate GB/s
        assert a.invocations == 3
        assert a.shard_seconds == {
            "/host:CPU": pytest.approx(810e-6, rel=1e-9)}
        assert not a.mesh
        b = attr.modules["bbbb02bbbb02"]
        assert b.invocations == 2
        assert b.mesh
        assert b.phase_seconds == {
            "coarse_select": pytest.approx(400e-6, rel=1e-9),
            "scan": pytest.approx(2000e-6, rel=1e-9),
            "merge": pytest.approx(200e-6, rel=1e-9),
        }
        assert b.shard_seconds == {
            "/device:TPU:0": pytest.approx(1100e-6, rel=1e-9),
            "/device:TPU:1": pytest.approx(1500e-6, rel=1e-9),
        }
        assert b.window == (pytest.approx(1000e-6), pytest.approx(2750e-6))
        # measured roofline: modeled bytes x invocations / device time
        assert a.measured_gbps() == pytest.approx(1.0, rel=1e-6)
        assert a.measured_gflops() == pytest.approx(2.0, rel=1e-6)
        assert b.measured_gbps() == pytest.approx(1.0, rel=1e-6)
        # the result-slice micro-program matched nothing and says so
        # (ops no entry's annotation encloses carry module "")
        assert attr.unmatched_modules == {
            "": pytest.approx(5e-6, rel=1e-9)}
        # per-dispatch invocation windows: the gap-clustering
        # found exactly one window per dispatch, and each mesh
        # window's per-device busy time yields a PER-DISPATCH skew
        assert len(a.windows) == 3 and len(b.windows) == 2
        assert a.skew_samples() == []          # single-device module
        assert b.skew_samples() == [
            pytest.approx(200e-6, rel=1e-9)] * 2

    def test_attribute_bumps_ingestion_counters(self):
        before = tracing.get_counter(profiling.CAPTURES)
        ops_before = tracing.get_counter(profiling.DEVICE_OPS)
        fixture_attr()
        assert tracing.get_counter(profiling.CAPTURES) == before + 1
        assert tracing.get_counter(profiling.DEVICE_OPS) == \
            ops_before + 25

    def test_trace_file_recorded_from_path_source(self):
        attr = fixture_attr()
        assert attr.trace_file == FIXTURE
        assert attr.to_dict()["trace_file"] == FIXTURE


class TestInvocationWindows:
    """graftfleet: gap-clustering determinism + edge cases.
    The fixture pins the real shapes; the synthetic cases pin the
    boundary rules."""

    def ops(self, module="aaaa01aaaa01"):
        all_ops = profiling.parse_chrome_trace(
            profiling.load_trace(FIXTURE))
        return [o for o in all_ops if o.module.endswith(module)]

    def test_fixture_windows_pinned(self):
        wins = profiling.invocation_windows(self.ops())
        assert len(wins) == 3
        assert [w.start_s for w in wins] == [
            pytest.approx(t, rel=1e-9)
            for t in (3000e-6, 4000e-6, 5000e-6)]
        # per-window phase/device totals partition the capture totals
        assert sum(w.device_seconds for w in wins) == \
            pytest.approx(810e-6, rel=1e-9)
        assert all(w.ops == 4 for w in wins)

    def test_overlapping_devices_merge_into_shared_windows(self):
        # the mesh module's two devices overlap in time: one device's
        # intra-dispatch idle is covered by the other's ops, so the
        # merged timeline yields exactly one window per DISPATCH
        wins = profiling.invocation_windows(self.ops("bbbb02bbbb02"))
        assert len(wins) == 2
        for w in wins:
            assert set(w.shard_seconds) == {"/device:TPU:0",
                                            "/device:TPU:1"}
            assert w.shard_seconds["/device:TPU:0"] == \
                pytest.approx(550e-6, rel=1e-9)
            assert w.shard_seconds["/device:TPU:1"] == \
                pytest.approx(750e-6, rel=1e-9)
            assert w.skew == pytest.approx(200e-6, rel=1e-9)
            assert w.phase_seconds["scan"] == pytest.approx(
                1000e-6, rel=1e-9)

    def test_single_dispatch_yields_one_window(self):
        # every op ran once (n_min == n_max == 1): whatever idle gaps
        # the events carry, nothing may split
        ops = [profiling.DeviceOp("d", "m", f"op{i}", "",
                                  i * 1e-3, 1e-5)
               for i in range(4)]
        wins = profiling.invocation_windows(ops)
        assert len(wins) == 1
        assert wins[0].ops == 4

    def test_empty_capture(self):
        assert profiling.invocation_windows([]) == []

    def test_explicit_gap_threshold(self):
        wins = profiling.invocation_windows(self.ops(), gap_s=300e-6)
        assert len(wins) == 3
        # an explicit threshold above every gap keeps one window
        wins = profiling.invocation_windows(self.ops(), gap_s=1.0)
        assert len(wins) == 1

    def test_deterministic(self):
        a = profiling.invocation_windows(self.ops("bbbb02bbbb02"))
        b = profiling.invocation_windows(self.ops("bbbb02bbbb02"))
        assert [w.to_dict() for w in a] == [w.to_dict() for w in b]

    def test_back_to_back_dispatches_fall_back_to_count_floor(self):
        # two dispatches with ZERO idle between them: clustering
        # cannot separate, correlate() falls back to the op-count
        # floor for the invocation count
        ops = []
        for k in range(2):
            t = k * 200e-6
            ops.append(profiling.DeviceOp("d", "m", "dot", "",
                                          t, 100e-6))
            ops.append(profiling.DeviceOp("d", "m", "sort", "",
                                          t + 100e-6, 100e-6))
        assert len(profiling.invocation_windows(ops)) == 1
        attr = profiling.correlate(ops, {
            "x1": {"hlo_module": "m", "family": "f"}})
        assert attr.modules["x1"].invocations == 2


class TestMeasuredSupersedesModeled:
    """The acceptance criterion: with a capture present, mesh
    phase/shard spans re-emit ``modeled: False`` with device-measured
    windows, straggler gauges recompute from device timings, and
    ``metrics.derived()`` divides per-executable achieved GB/s by
    measured device time — pinned by the committed fixture."""

    def publish_fixture(self):
        metrics.reset()
        tracing.reset_gauges("serving.mesh.")
        return profiling.publish(fixture_attr())

    def test_mesh_spans_reemit_measured(self):
        self.publish_fixture()
        rec = tracing.span_recorder()
        (cs,) = rec.spans(name="serving.mesh.coarse_select")
        assert cs.attrs["modeled"] is False
        assert cs.attrs["source"] == "profiler"
        assert cs.attrs["family"] == "dist_ivf_flat"
        # device-measured window: mean per-invocation phase duration,
        # laid out from the capture window's start
        assert cs.start == pytest.approx(1000e-6, rel=1e-9)
        assert cs.duration == pytest.approx(200e-6, rel=1e-9)
        # the modeled wire bytes still ride along, over MEASURED time
        assert cs.attrs["wire_bytes"] == 2048
        (sc,) = rec.spans(name="serving.mesh.scan")
        assert sc.attrs["modeled"] is False
        assert sc.duration == pytest.approx(1000e-6, rel=1e-9)
        (mg,) = rec.spans(name="serving.mesh.merge")
        assert mg.attrs["wire_bytes"] == 512
        assert mg.duration == pytest.approx(100e-6, rel=1e-9)

    def test_shard_spans_and_straggler_gauges_from_device_time(self):
        dispatches = tracing.get_counter("serving.mesh.dispatches")
        self.publish_fixture()
        rec = tracing.span_recorder()
        shards = rec.spans(name="serving.mesh.shard")
        assert len(shards) == 2
        assert all(s.attrs["modeled"] is False for s in shards)
        assert all(s.attrs["source"] == "profiler" for s in shards)
        # mean per-invocation busy seconds per device: 550 / 750 us
        assert shards[0].duration == pytest.approx(550e-6, rel=1e-9)
        assert shards[1].duration == pytest.approx(750e-6, rel=1e-9)
        assert tracing.get_gauge(
            tracing.MESH_SHARD_SKEW) == pytest.approx(200e-6, rel=1e-9)
        assert tracing.get_gauge(tracing.MESH_SLOWEST_SHARD) == 1.0
        assert tracing.get_gauge(
            tracing.MESH_SHARD_TIME_MAX) == pytest.approx(750e-6,
                                                          rel=1e-9)
        # a re-attribution is not a new dispatch
        assert tracing.get_counter(
            "serving.mesh.dispatches") == dispatches
        # per-dispatch skew distribution: both fixture
        # dispatches skew by exactly 200 us, so p50 == p99 == 200 us
        assert tracing.get_gauge(
            tracing.MESH_SHARD_SKEW_P99) == pytest.approx(200e-6,
                                                          rel=1e-9)
        assert tracing.get_gauge(
            tracing.MESH_SHARD_SKEW_P50) == pytest.approx(200e-6,
                                                          rel=1e-9)

    def test_derived_measured_columns(self):
        self.publish_fixture()
        d = metrics.derived()
        # totals: 810 us + 2600 us device time; 810 kB + 2.6 MB
        # modeled bytes over it -> exactly 1.0 GB/s device-truth
        assert d["measured_device_seconds_total"] == pytest.approx(
            3410e-6, rel=1e-9)
        assert d["device_achieved_gbps"] == pytest.approx(1.0, rel=1e-6)
        assert d["device_achieved_gflops"] == pytest.approx(2.0,
                                                            rel=1e-6)
        # per-executable measured view: achieved GB/s divides by THIS
        # executable's measured device seconds
        me = d["measured_executables"]
        assert me["aaaa01aaaa01"]["gbps"] == pytest.approx(1.0,
                                                           rel=1e-6)
        assert me["aaaa01aaaa01"]["device_seconds"] == pytest.approx(
            810e-6, rel=1e-9)
        assert me["aaaa01aaaa01"]["invocations"] == 3.0
        assert me["bbbb02bbbb02"]["gflops"] == pytest.approx(2.0,
                                                             rel=1e-6)
        # the wall-clock-derived numbers still sit next to them (zero
        # here — no execute histogram observations in this test), so
        # the two accountings are visibly separate surfaces
        assert "achieved_gbps" in d

    def test_publish_returns_stats_and_gauges(self):
        out = self.publish_fixture()
        assert out["bbbb02bbbb02"]["invocations"] == 2
        g = tracing.gauges("serving.executable.aaaa01aaaa01.")
        assert g["serving.executable.aaaa01aaaa01.measured_gbps"] == \
            pytest.approx(1.0, rel=1e-6)
        assert g["serving.executable.aaaa01aaaa01"
                 ".measured_device_seconds"] == pytest.approx(810e-6,
                                                              rel=1e-9)


def burning_alert(clock, windows=(10.0, 100.0)):
    """A MultiBurnAlert driven into the firing state at the clock's
    now (all misses in both windows -> serving.slo.alert = 1)."""
    alert = metrics.MultiBurnAlert(MultiBurnConfig(
        short=SloConfig(window_s=windows[0]),
        long=SloConfig(window_s=windows[1])))
    for _ in range(5):
        alert.record(clock.now(), False)
    return alert


class TestFlightRecorder:
    def setup_method(self):
        metrics.reset()

    def test_multiburn_produces_exactly_one_rate_limited_bundle(self):
        clock = ManualClock()
        alert = burning_alert(clock)
        assert tracing.get_gauge(metrics.SLO_ALERT) == 1.0
        bundles0 = tracing.get_counter(flight_mod.INCIDENT_BUNDLES)
        fr = FlightRecorder(
            config=FlightConfig(cooldown_s=60.0, latency=None),
            clock=clock, capture_fn=lambda: None)
        b1 = fr.check()
        assert b1 is not None
        assert b1["triggers"] == ["multiburn_alert"]
        # still firing, but inside the cooldown: suppressed, counted
        sup0 = tracing.get_counter(flight_mod.INCIDENT_SUPPRESSED)
        clock.advance(1.0)
        assert fr.check() is None
        assert fr.check() is None
        assert tracing.get_counter(
            flight_mod.INCIDENT_SUPPRESSED) == sup0 + 2
        assert tracing.get_counter(
            flight_mod.INCIDENT_BUNDLES) == bundles0 + 1
        assert fr.latest() is b1
        # past the cooldown, with the outage still burning (fresh
        # misses keep both windows over budget), a second incident
        # may capture
        clock.advance(60.0)
        for _ in range(5):
            alert.record(clock.now(), False)
        assert tracing.get_gauge(metrics.SLO_ALERT) == 1.0
        b2 = fr.check()
        assert b2 is not None and b2["incident"] == 2
        assert len(fr.bundles()) == 2

    def test_quiet_service_never_triggers(self):
        clock = ManualClock()
        fr = FlightRecorder(config=FlightConfig(latency=None),
                            clock=clock, capture_fn=lambda: None)
        assert fr.check() is None
        assert fr.latest() is None

    def test_latency_anomaly_windowed(self):
        clock = ManualClock()
        cfg = FlightConfig(
            cooldown_s=30.0,
            latency=LatencyAnomaly(p99_threshold_s=0.5, min_count=4))
        # histogram history BEFORE the recorder attaches must not be
        # re-judged: the baseline primes at construction
        for _ in range(10):
            metrics.observe_stage(metrics.E2E, 2.0)
        fr = FlightRecorder(config=cfg, clock=clock,
                            capture_fn=lambda: None)
        assert fr.check() is None
        # a fresh stall: 6 slow observations in the window
        for _ in range(6):
            metrics.observe_stage(metrics.E2E, 1.0)
        b = fr.check()
        assert b is not None and b["triggers"] == ["latency_anomaly"]
        # the window advanced: the SAME observations are judged once
        clock.advance(31.0)
        assert fr.check() is None
        # below min_count: a lone slow request is noise, not a page
        metrics.observe_stage(metrics.E2E, 5.0)
        assert fr.check() is None
        # fast traffic dominating the window keeps p99 low
        for _ in range(100):
            metrics.observe_stage(metrics.E2E, 0.001)
        assert fr.check() is None

    def test_window_quantile_pure(self):
        bounds = [0.001, 0.01, 0.1]
        # 10 obs in bucket 0, 0, 0 -> all mass at/below 1 ms
        assert flight_mod.window_quantile(
            bounds, [10, 10, 10, 10], 0.99) <= 0.001
        # all mass in the overflow bucket -> estimated in (0.1, 0.2]
        v = flight_mod.window_quantile(bounds, [0, 0, 0, 5], 0.99)
        assert 0.1 < v <= 0.2
        assert flight_mod.window_quantile(bounds, [0, 0, 0, 0],
                                          0.99) == 0.0

    def test_bundle_contents_and_disk_persistence(self, tmp_path):
        clock = ManualClock()
        burning_alert(clock)
        fake = FakeExecutor()
        b = DynamicBatcher(fake, BatcherConfig(max_wait_s=0.0),
                           clock=clock, start=False)
        ex = SearchExecutor(RES)
        fr = FlightRecorder(
            executor=ex, batcher=b,
            config=FlightConfig(cooldown_s=60.0, latency=None,
                                bundle_dir=str(tmp_path)),
            clock=clock,
            capture_fn=lambda: profiling.load_trace(FIXTURE))
        bundle = fr.check()
        b.close()
        assert bundle is not None
        # the bundle carries everything the post-mortem needs
        for key in ("incident", "time", "triggers", "slo", "metrics",
                    "spans", "span_ring", "attribution", "executables",
                    "shed_level", "queue_depth"):
            assert key in bundle, key
        assert bundle["time"] == clock.now()
        assert bundle["shed_level"] == 0
        # the injected fixture capture was parsed; no resident
        # executable matches it, so modules is empty but the unmatched
        # accounting says what the trace held
        assert bundle["attribution"] is not None
        assert bundle["attribution"]["unmatched_modules"]
        # persisted to disk as JSON, path recorded in the bundle
        path = bundle["bundle_path"]
        assert os.path.dirname(path) == str(tmp_path)
        with open(path) as f:
            on_disk = json.load(f)
        assert on_disk["incident"] == bundle["incident"]
        assert on_disk["triggers"] == ["multiburn_alert"]

    def test_busy_profiler_defers_without_burning_cooldown(self):
        import threading

        clock = ManualClock()
        burning_alert(clock)
        fr = FlightRecorder(
            config=FlightConfig(cooldown_s=60.0, latency=None),
            clock=clock, capture_fn=lambda: None)
        # an operator's /profile capture owns the profiler (the
        # exporter wires its _profile_lock into the recorder)
        fr.profile_lock = threading.Lock()
        deferred0 = tracing.get_counter("incident.trigger"
                                        ".multiburn_alert")
        with fr.profile_lock:
            assert fr.check() is None          # deferred, not burned
        assert tracing.get_counter("incident.deferred") >= 1
        # the cooldown was NOT consumed: the very next check captures
        bundle = fr.check()
        assert bundle is not None and bundle["incident"] == 1
        assert deferred0 >= 0  # trigger counters kept counting

    def test_capture_without_fresh_trace_yields_no_source(
            self, tmp_path, monkeypatch):
        import contextlib
        import shutil

        # a STALE capture already sits in profile_dir; the incident's
        # own capture writes nothing — the recorder must not attribute
        # the stale file as current evidence
        run = tmp_path / "plugins" / "profile" / "old"
        run.mkdir(parents=True)
        shutil.copyfile(FIXTURE, str(run / "host.trace.json"))

        @contextlib.contextmanager
        def empty_capture(log_dir):
            yield                              # no trace written

        monkeypatch.setattr(tracing, "capture", empty_capture)
        clock = ManualClock()
        burning_alert(clock)
        fr = FlightRecorder(
            executor=SearchExecutor(RES),
            config=FlightConfig(cooldown_s=60.0, latency=None),
            clock=clock, profile_dir=str(tmp_path))
        bundle = fr.check()
        assert bundle is not None
        assert bundle["attribution"] is None
        assert bundle["trace_file"] is None

    def test_capture_failure_still_bundles(self):
        clock = ManualClock()
        burning_alert(clock)

        def bad_capture():
            raise RuntimeError("profiler unavailable")

        fr = FlightRecorder(
            config=FlightConfig(cooldown_s=60.0, latency=None),
            clock=clock, capture_fn=bad_capture)
        bundle = fr.check()
        assert bundle is not None
        assert bundle["attribution"] is None
        assert "profiler unavailable" in bundle["capture_error"]


class TestExporterFlight:
    """Exporter hardening satellite: /incident.json + /profile
    responses parse-checked, and the scrape refresh drives the
    recorder's triggers."""

    def setup_method(self):
        metrics.reset()

    def _get(self, url):
        # generous timeout: /profile runs a real profiler capture
        try:
            with urllib.request.urlopen(url, timeout=120) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    def test_incident_endpoint_404_then_bundle(self):
        clock = ManualClock()
        fr = FlightRecorder(
            config=FlightConfig(cooldown_s=60.0, latency=None),
            clock=clock, capture_fn=lambda: None)
        with MetricsExporter(flight=fr) as exp:
            code, _ = self._get(exp.url("/incident.json"))
            assert code == 404
            burning_alert(clock)
            # the scrape refresh evaluates the triggers: one /metrics
            # pull arms and captures the incident...
            code, _ = self._get(exp.url("/metrics"))
            assert code == 200
            code, body = self._get(exp.url("/incident.json"))
            assert code == 200
            bundle = json.loads(body)
            # ...and the response parses field by field
            assert bundle["incident"] == 1
            assert bundle["triggers"] == ["multiburn_alert"]
            assert isinstance(bundle["metrics"], dict)
            assert "counters" in bundle["metrics"]
            assert isinstance(bundle["spans"], dict)
            assert "traceEvents" in bundle["spans"]
            assert bundle["span_ring"]["capacity"] > 0
            # exactly ONE bundle however many scrapes raced the alert
            self._get(exp.url("/metrics"))
            code, body2 = self._get(exp.url("/incident.json"))
            assert json.loads(body2)["incident"] == 1

    def test_no_flight_attached_404(self):
        with MetricsExporter() as exp:
            code, _ = self._get(exp.url("/incident.json"))
            assert code == 404

    def test_profile_returns_trace_file(self, tmp_path, monkeypatch):
        import contextlib
        import shutil

        # a layout-faithful fake capture: jax.profiler's stop_trace
        # serializes session-accumulated state, which costs ~a minute
        # late in a full test session — the REAL capture is proven by
        # TestRealExecutorAttribution (direct) and the core capture
        # smoke; this test pins OUR plumbing (trace-file resolution +
        # the response contract) against the profiler's disk layout
        @contextlib.contextmanager
        def fake_capture(log_dir):
            run = os.path.join(log_dir, "plugins", "profile", "r1")
            os.makedirs(run, exist_ok=True)
            shutil.copyfile(FIXTURE,
                            os.path.join(run, "host.trace.json"))
            yield

        monkeypatch.setattr(tracing, "capture", fake_capture)
        with MetricsExporter(profile_dir=str(tmp_path)) as exp:
            code, body = self._get(exp.url("/profile?seconds=0.05"))
            assert code == 200
            out = json.loads(body)
            assert set(out) == {"log_dir", "seconds", "trace_file"}
            assert out["log_dir"] == str(tmp_path)
            assert out["seconds"] == 0.05
            # the path points at the capture that was just written,
            # inside profile_dir — exactly what graftflight ingests
            assert out["trace_file"] is not None
            assert os.path.exists(out["trace_file"])
            assert out["trace_file"].startswith(str(tmp_path))
            assert profiling.parse_chrome_trace(
                profiling.load_trace(out["trace_file"]))


class TestParamsClassLatency:
    """Per-params-class latency labels (graftgauge carried follow-on):
    serving.execute histograms gain a params-class label pairing the
    params-sweep recall gauges with a latency axis."""

    def setup_method(self):
        metrics.reset()

    def test_params_class_label(self):
        assert metrics.params_class(
            ivf_flat.IvfFlatSearchParams(n_probes=12)) == "p12"
        assert metrics.params_class(None) is None
        assert metrics.params_class(object()) is None

    def test_dispatch_observes_class_histogram(self):
        clock = ManualClock()
        fake = FakeExecutor()
        b = DynamicBatcher(fake, BatcherConfig(max_wait_s=0.0),
                           clock=clock, start=False)
        idx = object()
        p = ivf_flat.IvfFlatSearchParams(n_probes=6)
        qb = np.zeros((2, 4), np.float32)
        b.submit(idx, qb, 3, params=p)
        b.pump()
        b.submit(idx, qb, 3)            # no params -> unlabeled only
        b.pump()
        b.close()
        h = tracing.histograms(metrics.EXECUTE)
        assert h[metrics.EXECUTE]["count"] == 2
        assert h[f"{metrics.EXECUTE}.p6"]["count"] == 1

    def test_class_label_cardinality_capped(self):
        # n_probes is client-supplied: past the cap a NEW label lands
        # only in the unlabeled aggregate (counted), so an autotuner
        # sweeping arbitrary values cannot grow /metrics unboundedly
        for i in range(metrics.EXECUTE_CLASS_CAP + 5):
            metrics.observe_execute_class(f"p{i + 1}", 0.001)
        h = tracing.histograms(metrics.EXECUTE + ".")
        assert len(h) == metrics.EXECUTE_CLASS_CAP
        assert tracing.get_counter(
            metrics.PREFIX + "execute_class_dropped") == 5.0
        # known labels keep observing past the cap
        metrics.observe_execute_class("p1", 0.002)
        assert tracing.get_histogram(
            f"{metrics.EXECUTE}.p1").snapshot()["count"] == 2
        # reset() clears the cap set along with the histograms
        metrics.reset()
        metrics.observe_execute_class("p99", 0.001)
        assert tracing.get_histogram(
            f"{metrics.EXECUTE}.p99").snapshot()["count"] == 1

    def test_ragged_dispatch_observes_each_class_once(self):
        clock = ManualClock()
        fake = FakeExecutor(ragged_tile=8)
        b = DynamicBatcher(fake, BatcherConfig(max_wait_s=0.0,
                                               ragged=True),
                           clock=clock, start=False)
        idx = object()
        qb = np.zeros((2, 4), np.float32)
        # two requests with DIFFERENT n_probes pack into one tile;
        # the shared execute latency lands once per distinct class
        b.submit(idx, qb, 3,
                 params=ivf_flat.IvfFlatSearchParams(n_probes=4))
        b.submit(idx, qb, 3,
                 params=ivf_flat.IvfFlatSearchParams(n_probes=8))
        b.pump()
        b.close()
        h = tracing.histograms(metrics.EXECUTE)
        assert h[f"{metrics.EXECUTE}.p4"]["count"] == 1
        assert h[f"{metrics.EXECUTE}.p8"]["count"] == 1

    def test_exposition_renders_labeled_histogram_family(self):
        import re

        clock = ManualClock()
        fake = FakeExecutor()
        b = DynamicBatcher(fake, BatcherConfig(max_wait_s=0.0),
                           clock=clock, start=False)
        b.submit(object(), np.zeros((2, 4), np.float32), 3,
                 params=ivf_flat.IvfFlatSearchParams(n_probes=6))
        b.pump()
        exp = MetricsExporter(batcher=b)
        text = exp.prometheus_text()
        b.close()
        # ONE family declaration, labeled AND unlabeled samples in it
        assert text.count(
            "# TYPE serving_batcher_execute_seconds histogram") == 1
        assert re.search(
            r'serving_batcher_execute_seconds_bucket'
            r'\{params_class="p6",le="[^"]+"\} \d+', text)
        assert ('serving_batcher_execute_seconds_count'
                '{params_class="p6"} 1') in text
        assert re.search(
            r"^serving_batcher_execute_seconds_count 1$", text,
            flags=re.M)
        # every line still parses against the exposition grammar
        sample_re = re.compile(
            r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
            r'(\{[a-zA-Z_]+="[^"]*"(,[a-zA-Z_]+="[^"]*")*\})? '
            r"[-+0-9.e]+$")
        for line in text.strip().splitlines():
            if not line.startswith("#"):
                assert sample_re.match(line), line


# ---------------------------------------------------------------------------
# the port's own trace shape and timed calls
# ---------------------------------------------------------------------------


def test_fixture_is_the_jax_capture_recast():
    assert profiling.load_trace(FIXTURE) == kineto_from_jax(JAX_FIXTURE)


def _kineto_trace():
    """A trace shaped like ``torch.profiler``'s export: CPU pid 10 (the
    batcher thread 11), GPU pid 0 (stream 7). Entry ``rt_ivf_flat_e1``
    ran eagerly (two kernels under a nested ``coarse_select`` range, a
    memcpy); entry ``rt_dist_ivf_flat_e2`` replayed a graph twice, the
    profiler recording two of its kernels for the first replay and one
    for the second; one kernel was launched outside every entry."""
    ev = [
        {"ph": "M", "name": "process_name", "pid": 10,
         "args": {"name": "python"}},
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "GPU 0"}},
        # entry 1, eager: annotation, nested phase range, launches
        {"ph": "X", "cat": "user_annotation", "name": "rt_ivf_flat_e1",
         "pid": 10, "tid": 11, "ts": 100.0, "dur": 50.0},
        {"ph": "X", "cat": "user_annotation", "name": "coarse_select",
         "pid": 10, "tid": 11, "ts": 101.0, "dur": 10.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 10, "tid": 11, "ts": 102.0, "dur": 2.0,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 10, "tid": 11, "ts": 120.0, "dur": 2.0,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "pid": 10, "tid": 11, "ts": 130.0, "dur": 2.0,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "gemm", "pid": 0, "tid": 7,
         "ts": 105.0, "dur": 20.0, "args": {"correlation": 1,
                                            "device": 0}},
        {"ph": "X", "cat": "kernel", "name": "list_major_scan",
         "pid": 0, "tid": 7, "ts": 126.0, "dur": 30.0,
         "args": {"correlation": 2, "device": 0}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
         "pid": 0, "tid": 7, "ts": 157.0, "dur": 3.0,
         "args": {"correlation": 3, "device": 0}},
        # entry 2: two graph replays
        {"ph": "X", "cat": "user_annotation",
         "name": "rt_dist_ivf_flat_e2", "pid": 10, "tid": 11,
         "ts": 200.0, "dur": 10.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
         "pid": 10, "tid": 11, "ts": 202.0, "dur": 5.0,
         "args": {"correlation": 4}},
        {"ph": "X", "cat": "user_annotation",
         "name": "rt_dist_ivf_flat_e2", "pid": 10, "tid": 11,
         "ts": 400.0, "dur": 10.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
         "pid": 10, "tid": 11, "ts": 402.0, "dur": 5.0,
         "args": {"correlation": 5}},
        {"ph": "X", "cat": "kernel", "name": "list_major_scan",
         "pid": 0, "tid": 7, "ts": 210.0, "dur": 40.0,
         "args": {"correlation": 4, "device": 0}},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
         "pid": 0, "tid": 7, "ts": 251.0, "dur": 1.0,
         "args": {"correlation": 4, "device": 0}},
        {"ph": "X", "cat": "kernel", "name": "merge_partials",
         "pid": 0, "tid": 7, "ts": 410.0, "dur": 5.0,
         "args": {"correlation": 5, "device": 0}},
        # outside every entry
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 10, "tid": 11, "ts": 500.0, "dur": 2.0,
         "args": {"correlation": 6}},
        {"ph": "X", "cat": "kernel", "name": "copy", "pid": 0, "tid": 7,
         "ts": 503.0, "dur": 2.0, "args": {"correlation": 6,
                                           "device": 0}},
        # host events that are not device work
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 10,
         "tid": 11, "ts": 101.5, "dur": 3.0},
    ]
    return {"traceEvents": ev}


KINETO_COSTS = {
    "e1": {"hlo_module": "rt_ivf_flat_e1", "family": "ivf_flat",
           "bytes_accessed": 1e6, "flops": 2e6},
    "e2": {"hlo_module": "rt_dist_ivf_flat_e2", "family": "dist_ivf_flat",
           "bytes_accessed": 4e6, "flops": 8e6},
    "e3": {"hlo_module": "rt_ivf_pq_e3", "family": "ivf_pq",
           "bytes_accessed": 3e6, "flops": 1e6},
}


class TestKinetoTrace:
    def test_device_ops_modules_and_scopes(self):
        ops = profiling.parse_chrome_trace(_kineto_trace())
        assert [(o.op, o.module, o.scope, o.device) for o in ops] == [
            ("gemm", "rt_ivf_flat_e1", "rt_ivf_flat_e1/coarse_select",
             "GPU 0"),
            ("list_major_scan", "rt_ivf_flat_e1", "rt_ivf_flat_e1",
             "GPU 0"),
            ("Memcpy DtoH", "rt_ivf_flat_e1", "rt_ivf_flat_e1", "GPU 0"),
            ("list_major_scan", "rt_dist_ivf_flat_e2",
             "rt_dist_ivf_flat_e2", "GPU 0"),
            ("Memset (Device)", "rt_dist_ivf_flat_e2",
             "rt_dist_ivf_flat_e2", "GPU 0"),
            ("merge_partials", "rt_dist_ivf_flat_e2",
             "rt_dist_ivf_flat_e2", "GPU 0"),
            ("copy", "", "", "GPU 0")]
        assert ops[0].phase == "coarse_select"
        assert ops[0].start_s == pytest.approx(105e-6)
        assert ops[0].dur_s == pytest.approx(20e-6)

    def test_gpu_annotation_when_the_launch_is_unseen(self):
        data = {"traceEvents": [
            {"ph": "X", "cat": "gpu_user_annotation", "name": "rt_x_1",
             "pid": 0, "tid": 9, "ts": 10.0, "dur": 10.0},
            {"ph": "X", "cat": "kernel", "name": "k", "pid": 0, "tid": 7,
             "ts": 12.0, "dur": 3.0, "args": {"correlation": 99}},
            {"ph": "X", "cat": "kernel", "name": "k", "pid": 0, "tid": 7,
             "ts": 20.0, "dur": 3.0, "args": {"correlation": 98}}]}
        ops = profiling.parse_chrome_trace(data)
        assert [o.module for o in ops] == ["rt_x_1", ""]
        assert ops[0].device == "pid:0"

    def test_without_timed_calls_the_trace_decides(self):
        attr = profiling.correlate(
            profiling.parse_chrome_trace(_kineto_trace()), KINETO_COSTS)
        e1, e2 = attr.modules["e1"], attr.modules["e2"]
        assert e1.device_seconds == pytest.approx(53e-6)
        assert e1.invocations == 1 and e1.timed_calls == 0
        assert e1.phase_seconds == {
            "coarse_select": pytest.approx(20e-6),
            "unattributed": pytest.approx(33e-6)}
        # the trace alone undercounts a partly recorded replay: each
        # kernel it saw ran once, so the clustering sees one dispatch
        # and the device seconds are the seen kernels' only
        assert e2.device_seconds == pytest.approx(46e-6)
        assert e2.invocations == 1
        assert attr.unmatched_modules == {"": pytest.approx(2e-6)}
        assert "e3" not in attr.modules

    def test_timed_calls_supply_device_seconds(self):
        calls = [{"module": "rt_dist_ivf_flat_e2", "start_s": 1.0,
                  "dur_s": 60e-6},
                 {"module": "rt_dist_ivf_flat_e2", "start_s": 2.0,
                  "dur_s": 58e-6},
                 {"module": "rt_ivf_pq_e3", "start_s": 3.0,
                  "dur_s": 25e-6},
                 {"module": "rt_not_resident", "start_s": 4.0,
                  "dur_s": 1.0}]
        attr = profiling.correlate(
            profiling.parse_chrome_trace(_kineto_trace()), KINETO_COSTS,
            calls)
        e2 = attr.modules["e2"]
        assert e2.timed_calls == 2 and e2.invocations == 2
        assert e2.device_seconds == pytest.approx(118e-6)
        # the trace's view of the same entry, kept beside it
        assert e2.trace_seconds == pytest.approx(46e-6)
        assert e2.kernel_seconds == {
            "list_major_scan": pytest.approx(40e-6),
            "Memset (Device)": pytest.approx(1e-6),
            "merge_partials": pytest.approx(5e-6)}
        assert e2.measured_gbps() == pytest.approx(
            4e6 * 2 / 118e-6 / 1e9)
        # an entry whose kernels the trace never saw is attributed from
        # its calls alone
        e3 = attr.modules["e3"]
        assert e3.device_seconds == pytest.approx(25e-6)
        assert e3.invocations == 1 and e3.trace_seconds == 0.0
        assert e3.window == (pytest.approx(3.0), pytest.approx(3.0 + 25e-6))
        # an entry without calls keeps the trace's numbers
        assert attr.modules["e1"].device_seconds == pytest.approx(53e-6)

    def test_attribute_reads_the_calls_stored_in_the_trace(self, tmp_path):
        data = _kineto_trace()
        data[profiling.CALLS_KEY] = [
            {"module": "rt_ivf_flat_e1", "start_s": 0.0, "dur_s": 70e-6}]
        path = tmp_path / "host.1.pt.trace.json"
        path.write_text(json.dumps(data))
        attr = profiling.attribute(str(tmp_path), KINETO_COSTS)
        assert attr.trace_file == str(path)
        assert attr.modules["e1"].device_seconds == pytest.approx(70e-6)
        assert attr.modules["e1"].timed_calls == 1

    def test_no_window_means_no_timed_calls(self):
        assert not profiling.window_open()
        with profiling.capture_window() as w:
            assert profiling.window_open()
            assert w.timings() == []
        assert not profiling.window_open()


class TestSessionOnTheCpu:
    def test_capture_writes_a_trace_with_the_entry_annotations(
            self, tmp_path):
        rng = np.random.default_rng(3)
        x = rng.integers(-4, 5, (600, 8)).astype(np.float32)
        idx = ivf_flat.build(RES, ivf_flat.IvfFlatIndexParams(n_lists=8), x)
        ex = SearchExecutor(RES)
        sp = ivf_flat.IvfFlatSearchParams(n_probes=3)
        ex.search(idx, x[:5], 4, params=sp)
        before = profiling.trace_snapshot(str(tmp_path))
        with tracing.capture(str(tmp_path)) as cap:
            ex.search(idx, x[:5], 4, params=sp)
        path = profiling.fresh_trace_file(str(tmp_path), before)
        assert path == cap.path and os.path.exists(path)
        data = profiling.load_trace(path)
        # a CPU entry is never timed: its device seconds would be host
        # seconds
        assert data[profiling.CALLS_KEY] == []
        (info,) = ex.executable_costs().values()
        names = {e.get("name") for e in data["traceEvents"]
                 if e.get("cat") == "user_annotation"}
        assert info["hlo_module"] in names
        # no device ops on the CPU: nothing to attribute
        attr = profiling.attribute(path, ex.executable_costs())
        assert attr.modules == {}

    def test_start_server_has_no_counterpart(self):
        with pytest.raises(NotImplementedError, match="/profile"):
            tracing.start_server()

    def test_annotated_names_a_range(self):
        @tracing.annotated("raft_tpu.test.fn")
        def fn(a, b=1):
            return a + b

        assert fn(1, b=2) == 3 and fn.__name__ == "fn"


# ---------------------------------------------------------------------------
# the same DeviceOp lists through both packages
# ---------------------------------------------------------------------------


class TestCapturesAndSessionsExclude:
    """A CUDA graph capture and a profiler session never overlap: a
    capture inside a session hung the process on the card."""

    @staticmethod
    def _session_thread(tmp_path, release):
        import threading

        opened = threading.Event()

        def run():
            with tracing.capture(str(tmp_path)):
                opened.set()
                release.wait(30)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        assert opened.wait(30)
        return t

    def test_capture_on_the_session_thread_raises(self, tmp_path):
        with tracing.capture(str(tmp_path)):
            with pytest.raises(RuntimeError, match="same thread"):
                with profiling.graph_capture():
                    pass
        with profiling.graph_capture():
            pass

    def test_capture_meets_a_session_on_another_thread(self, tmp_path):
        import threading

        release = threading.Event()
        t = self._session_thread(tmp_path, release)
        with pytest.raises(profiling.SessionRunning):
            with profiling.graph_capture():
                pass
        # a second session is refused while the first runs
        with pytest.raises(RuntimeError, match="already running"):
            with profiling.session(str(tmp_path)):
                pass
        release.set()
        profiling.wait_for_session()
        t.join(30)
        assert not t.is_alive()
        with profiling.graph_capture():
            pass

    def test_session_waits_for_a_capture_under_way(self, tmp_path):
        import threading
        import time

        inside, times = threading.Event(), {}

        def capture():
            with profiling.graph_capture():
                inside.set()
                time.sleep(0.3)
                times["capture_end"] = time.perf_counter()

        t = threading.Thread(target=capture, daemon=True)
        t.start()
        assert inside.wait(30)
        with tracing.capture(str(tmp_path)):
            times["session_start"] = time.perf_counter()
        t.join(30)
        assert times["session_start"] >= times["capture_end"]

    def test_a_dispatch_that_met_a_session_runs_again_after_it(
            self, tmp_path):
        import threading

        from raft_tpu_torch.core.executor import _past_sessions

        release = threading.Event()
        t = self._session_thread(tmp_path, release)
        calls = []

        def dispatch():
            calls.append(profiling.window_open())
            with profiling.graph_capture():
                return "served"

        threading.Timer(0.2, release.set).start()
        assert _past_sessions(dispatch) == "served"
        t.join(30)
        # the first call met the session's window; the second ran after
        assert calls == [True, False]


def _both_ops(rows):
    return ([profiling.DeviceOp(*r) for r in rows],
            [j_profiling.DeviceOp(*r) for r in rows])


def _random_rows(seed, n_dispatch=6):
    rng = np.random.default_rng(seed)
    rows, t = [], 0.0
    for _ in range(n_dispatch):
        for dev in ("GPU 0", "GPU 1"):
            s = t
            for op in ("gemm", "scan", "scan", "merge"):
                d = float(rng.uniform(1e-6, 40e-6))
                scope = f"m/{op if op != 'gemm' else 'coarse_select'}"
                rows.append((dev, "m", op, scope, s, d))
                s += d + float(rng.uniform(0, 2e-6))
        t = max(r[4] + r[5] for r in rows) + float(rng.uniform(5e-6,
                                                                200e-6))
    return rows


def _strip(d: dict) -> dict:
    d = dict(d)
    for key in ("timed_calls", "trace_seconds", "kernel_seconds"):
        d.pop(key, None)
    return d


@pytest.mark.parametrize("seed", range(6))
def test_invocation_windows_equal_jax(seed):
    ours, theirs = _both_ops(_random_rows(seed))
    for gap in (None, 30e-6):
        a = profiling.invocation_windows(ours, gap_s=gap)
        b = j_profiling.invocation_windows(theirs, gap_s=gap)
        assert [w.to_dict() for w in a] == [w.to_dict() for w in b]


@pytest.mark.parametrize("seed", range(4))
def test_correlate_equals_jax(seed):
    rows = _random_rows(seed) + [("GPU 0", "other", "k", "", 1.0, 1e-6)]
    ours, theirs = _both_ops(rows)
    costs = {"d1": {"hlo_module": "m", "family": "dist_ivf_flat",
                    "bytes_accessed": 5e5, "flops": 1e6,
                    "collective_payload": {"coarse_bytes": 64,
                                           "merge_bytes": 32}}}
    a = profiling.correlate(ours, costs).to_dict()
    b = j_profiling.correlate(theirs, costs).to_dict()
    assert a["unmatched_modules"] == b["unmatched_modules"]
    assert _strip(a["modules"]["d1"]) == b["modules"]["d1"]


def test_fixture_attribution_equals_jax():
    jax_costs = {d: dict(info, hlo_module="jit_" + info["hlo_module"])
                 for d, info in FIXTURE_COSTS.items()}
    a = profiling.attribute(FIXTURE, FIXTURE_COSTS).to_dict()["modules"]
    b = j_profiling.attribute(JAX_FIXTURE, jax_costs).to_dict()["modules"]
    assert set(a) == set(b)
    for d in a:
        x, y = _strip(a[d]), dict(b[d])
        assert x.pop("module") == y.pop("module")[len("jit_"):]
        assert x == y


def test_publish_and_rolling_equal_jax():
    jax_costs = {d: dict(info, hlo_module="jit_" + info["hlo_module"])
                 for d, info in FIXTURE_COSTS.items()}
    a = profiling.attribute(FIXTURE, FIXTURE_COSTS)
    b = j_profiling.attribute(JAX_FIXTURE, jax_costs)
    metrics.reset()
    tracing.reset_gauges("serving.")
    j_tracing.reset_gauges("serving.")
    assert profiling.publish(a) == j_profiling.publish(b)
    assert tracing.gauges("serving.executable.") == j_tracing.gauges(
        "serving.executable.")
    assert tracing.gauges("serving.mesh.") == j_tracing.gauges(
        "serving.mesh.")
    ra, rb = profiling.RollingAttribution(0.4), \
        j_profiling.RollingAttribution(0.4)
    for _ in range(3):
        assert ra.fold(a) == rb.fold(b)
    assert ra.snapshot() == rb.snapshot()
