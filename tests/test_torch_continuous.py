"""The port's continuous attribution against the JAX package's tests
(``tests/test_continuous.py``): the low-duty-cycle capture scheduler and
the rolling EWMA attribution, ManualClock-pinned and device-free. The
injected capture is the JAX package's committed chrome fixture recast as
a ``torch.profiler`` trace (:func:`kineto_from_jax`), whose ops attribute
exactly as the JAX ops do.
"""

import json
import os
import threading

import pytest

from raft_tpu_torch.core import profiling, tracing
from raft_tpu_torch.serving import (
    ContinuousCapture,
    ContinuousConfig,
    MetricsExporter,
)
from raft_tpu_torch.serving import continuous as cont_mod
from raft_tpu_torch.serving import metrics
from raft_tpu_torch.serving.harness import ManualClock

JAX_FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                           "graftflight_capture.trace.json")


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


FIXTURE = kineto_from_jax(JAX_FIXTURE)

COSTS = {
    "aaaa01aaaa01": {
        "hlo_module": "rt_ivf_flat_aaaa01aaaa01",
        "family": "ivf_flat", "bucket": 8, "k": 5,
        "bytes_accessed": 270_000.0, "flops": 540_000.0,
    },
    "bbbb02bbbb02": {
        "hlo_module": "rt_dist_ivf_flat_bbbb02bbbb02",
        "family": "dist_ivf_flat", "bucket": 16, "k": 5,
        "bytes_accessed": 1_300_000.0, "flops": 2_600_000.0,
        "collective_payload": {"coarse_bytes": 2048,
                               "merge_bytes": 512},
    },
}


class StubExecutor:
    def executable_costs(self):
        return dict(COSTS)


def counting_capture(calls):
    def capture():
        calls.append(1)
        return profiling.load_trace(FIXTURE)
    return capture


def make_cc(clock, config=None, capture=None, executor=None):
    return ContinuousCapture(
        executor=executor or StubExecutor(),
        config=config or ContinuousConfig(),
        clock=clock,
        capture_fn=capture or (lambda: profiling.load_trace(FIXTURE)))


class TestDutyCycleSchedule:
    def setup_method(self):
        metrics.reset()

    def test_first_tick_captures_then_period_gates(self):
        clock = ManualClock()
        calls = []
        cc = make_cc(clock, ContinuousConfig(period_s=10.0,
                                             capture_seconds=0.05),
                     capture=counting_capture(calls))
        caps0 = tracing.get_counter(cont_mod.CAPTURES)
        assert cc.tick() is not None          # first tick captures
        clock.advance(5.0)
        assert cc.tick() is None              # mid-period: quiet
        assert len(calls) == 1
        clock.advance(5.0)
        assert cc.tick() is not None          # period elapsed
        assert len(calls) == 2
        assert tracing.get_counter(cont_mod.CAPTURES) == caps0 + 2
        assert tracing.get_counter(cont_mod.TICKS) >= 3

    def test_elapsed_periods_never_stack(self):
        clock = ManualClock()
        calls = []
        cc = make_cc(clock, ContinuousConfig(period_s=10.0,
                                             capture_seconds=0.05),
                     capture=counting_capture(calls))
        cc.tick()
        # a long quiet stretch (scrapes stopped, service idle): ten
        # periods elapsed, but the next tick runs exactly ONE capture
        clock.advance(100.0)
        assert cc.tick() is not None
        assert cc.tick() is None
        assert len(calls) == 2

    def test_budget_skips_due_ticks(self):
        # a misconfigured cadence (10% duty asked, 1% budget): the
        # budget is a hard ceiling — due ticks SKIP (counted) until
        # the cumulative duty cycle re-enters the budget
        clock = ManualClock()
        calls = []
        cc = make_cc(clock, ContinuousConfig(
            period_s=1.0, capture_seconds=0.1,
            duty_cycle_budget=0.01), capture=counting_capture(calls))
        skipped0 = tracing.get_counter(cont_mod.SKIPPED)
        assert cc.tick() is not None          # first capture admits
        for _ in range(9):
            clock.advance(1.0)
            cc.tick()
        # 0.1 s spent amortizes back under the 1% budget only at
        # t = 10 s: every due tick before that SKIPS, counted
        assert len(calls) == 1
        assert tracing.get_counter(cont_mod.SKIPPED) == skipped0 + 9
        clock.advance(1.0)                    # t = 10 = 0.1 / 0.01
        assert cc.tick() is not None
        assert len(calls) == 2
        assert cc.duty_cycle() == pytest.approx(0.2 / 10.0)
        # the long-run cadence settles at capture_seconds / budget —
        # the budget's own period — not the misconfigured 1 s one
        skipped1 = tracing.get_counter(cont_mod.SKIPPED)
        for _ in range(9):
            clock.advance(1.0)
            cc.tick()
        assert len(calls) == 2
        assert tracing.get_counter(cont_mod.SKIPPED) == skipped1 + 9
        clock.advance(1.0)                    # t = 20 = 0.2 / 0.01
        assert cc.tick() is not None
        assert len(calls) == 3

    def test_default_config_respects_one_percent(self):
        cfg = ContinuousConfig()
        assert cfg.capture_seconds / cfg.period_s <= \
            cfg.duty_cycle_budget
        clock = ManualClock()
        calls = []
        cc = make_cc(clock, cfg, capture=counting_capture(calls))
        skipped0 = tracing.get_counter(cont_mod.SKIPPED)
        for _ in range(20):
            cc.tick()
            clock.advance(cfg.period_s)
        # the default cadence never trips the budget guard
        assert tracing.get_counter(cont_mod.SKIPPED) == skipped0
        assert len(calls) == 20
        assert cc.duty_cycle() <= cfg.duty_cycle_budget + 1e-12

    def test_busy_profiler_defers_without_consuming_period(self):
        clock = ManualClock()
        calls = []
        cc = make_cc(clock, ContinuousConfig(period_s=10.0),
                     capture=counting_capture(calls))
        # an operator /profile (or incident) capture owns the lock
        cc.profile_lock = threading.Lock()
        def0 = tracing.get_counter(cont_mod.DEFERRED)
        with cc.profile_lock:
            assert cc.tick() is None
            assert cc.tick() is None
        assert tracing.get_counter(cont_mod.DEFERRED) == def0 + 2
        assert not calls
        # the period stamp was NOT advanced: the freed lock lets the
        # very next tick capture without waiting another period
        assert cc.tick() is not None
        assert len(calls) == 1

    def test_capture_error_counted_not_raised(self):
        clock = ManualClock()

        def bad():
            raise RuntimeError("profiler unavailable")

        cc = make_cc(clock, ContinuousConfig(period_s=1.0,
                                             capture_seconds=0.001),
                     capture=bad)
        err0 = tracing.get_counter(cont_mod.ERRORS)
        assert cc.tick() is None
        assert tracing.get_counter(cont_mod.ERRORS) == err0 + 1
        # the scheduler survives: a later (working) tick captures
        cc.capture_fn = lambda: profiling.load_trace(FIXTURE)
        clock.advance(1.0)
        assert cc.tick() is not None

    def test_empty_capture_counted(self):
        clock = ManualClock()
        cc = make_cc(clock, ContinuousConfig(period_s=1.0,
                                             capture_seconds=0.001),
                     capture=lambda: None)
        empty0 = tracing.get_counter(cont_mod.EMPTY)
        assert cc.tick() is None
        assert tracing.get_counter(cont_mod.EMPTY) == empty0 + 1


def scripted_attr(secs, bytes_, flops=0.0, digest="dddd01",
                  skews=()):
    """A minimal Attribution with one module — the EWMA fold's input."""
    windows = [profiling.InvocationWindow(
        start_s=0.0, end_s=secs, ops=1, device_seconds=secs,
        phase_seconds={}, shard_seconds={"a": 0.0, "b": sk})
        for sk in skews]
    mod = profiling.ModuleAttribution(
        digest=digest, module=f"rt_x_{digest}", family="x",
        device_seconds=secs, invocations=1,
        phase_seconds={"scan": secs}, shard_seconds={},
        window=(0.0, secs), modeled_bytes_per_call=bytes_,
        modeled_flops_per_call=flops, windows=windows)
    return profiling.Attribution(modules={digest: mod},
                                 unmatched_modules={})


class TestRollingAttribution:
    def setup_method(self):
        metrics.reset()

    def test_ewma_fold_pinned(self):
        r = profiling.RollingAttribution(alpha=0.5)
        folds0 = tracing.get_counter(profiling.ROLLING_FOLDS)
        s1 = r.fold(scripted_attr(1.0, 10e9))
        assert s1["windows"] == 1
        assert s1["gbps"] == pytest.approx(10.0)
        s2 = r.fold(scripted_attr(1.0, 20e9))
        # bytes EWMA 0.5*20 + 0.5*10 = 15 GB over seconds EWMA 1.0
        assert s2["windows"] == 2
        assert s2["device_seconds"] == pytest.approx(1.0)
        assert s2["gbps"] == pytest.approx(15.0)
        assert s2["phase_seconds"]["scan"] == pytest.approx(1.0)
        assert tracing.get_counter(profiling.ROLLING_FOLDS) == \
            folds0 + 2
        g = tracing.gauges(profiling.ROLLING_PREFIX)
        assert g[profiling.ROLLING_PREFIX + "windows"] == 2.0
        assert g[profiling.ROLLING_PREFIX + "gbps"] == \
            pytest.approx(15.0)
        # the per-executable labeled family rides along
        assert tracing.get_gauge(
            "serving.executable.dddd01.rolling_gbps") == \
            pytest.approx(15.0)

    def test_absent_executable_holds_its_value(self):
        r = profiling.RollingAttribution(alpha=0.5)
        r.fold(scripted_attr(1.0, 10e9, digest="aaaa01"))
        r.fold(scripted_attr(2.0, 30e9, digest="cccc02"))
        snap = r.snapshot()
        # a window that did not overlap aaaa01's traffic is no
        # evidence it changed: its per-exec state holds
        assert snap["executables"]["aaaa01"]["gbps"] == \
            pytest.approx(10.0)
        assert snap["executables"]["cccc02"]["gbps"] == \
            pytest.approx(15.0)
        # totals fold what each window measured
        assert snap["device_seconds"] == pytest.approx(
            0.5 * 2.0 + 0.5 * 1.0)

    def test_empty_attribution_is_not_evidence(self):
        r = profiling.RollingAttribution()
        assert r.fold(profiling.Attribution(modules={},
                                            unmatched_modules={})) \
            is None
        assert r.snapshot()["windows"] == 0

    def test_skew_p99_folds(self):
        r = profiling.RollingAttribution(alpha=0.5)
        s1 = r.fold(scripted_attr(1.0, 1e9, skews=(100e-6, 300e-6)))
        assert s1["shard_skew_p99"] == pytest.approx(298e-6)
        s2 = r.fold(scripted_attr(1.0, 1e9, skews=(100e-6,)))
        assert s2["shard_skew_p99"] == pytest.approx(
            0.5 * 100e-6 + 0.5 * 298e-6)

    def test_derived_carries_rolling_columns(self):
        r = profiling.RollingAttribution(alpha=0.5)
        r.fold(scripted_attr(1.0, 10e9, flops=5e9))
        d = metrics.derived()
        assert d["rolling_windows"] == 1.0
        assert d["rolling_gbps"] == pytest.approx(10.0)
        assert d["rolling_gflops"] == pytest.approx(5.0)
        assert d["rolling_device_seconds"] == pytest.approx(1.0)

    def test_publish_restores_gauges_after_reset(self):
        r = profiling.RollingAttribution()
        r.fold(scripted_attr(1.0, 10e9))
        metrics.reset()
        assert tracing.get_gauge(
            profiling.ROLLING_PREFIX + "gbps") == 0.0
        r.publish()
        assert tracing.get_gauge(
            profiling.ROLLING_PREFIX + "gbps") == pytest.approx(10.0)


class TestSchedulerFeedsRolling:
    def setup_method(self):
        metrics.reset()

    def test_two_windows_populate_rolling_gauges(self):
        clock = ManualClock()
        cc = make_cc(clock, ContinuousConfig(period_s=15.0))
        assert cc.tick() is not None
        clock.advance(15.0)
        snap = cc.tick()
        assert snap["windows"] == 2
        # the fixture's round numbers: both executables at 1.0 GB/s
        assert snap["gbps"] == pytest.approx(1.0, rel=1e-6)
        g = tracing.gauges(profiling.ROLLING_PREFIX)
        assert g[profiling.ROLLING_PREFIX + "windows"] == 2.0
        assert g[profiling.ROLLING_PREFIX + "gbps"] == \
            pytest.approx(1.0, rel=1e-6)
        # measured-supersedes-modeled ran per window too (publish):
        # the per-capture measured gauges are fresh
        assert tracing.get_gauge(
            "serving.executable.aaaa01aaaa01.measured_gbps") == \
            pytest.approx(1.0, rel=1e-6)
        assert tracing.get_gauge(
            cont_mod.GAUGE_PREFIX + "windows") == 2.0
        # two 0.1 s windows over 15 s elapsed: the measured duty cycle
        # transiently overshoots 1% right after a capture and
        # amortizes back under it — the gauge reports honestly
        assert tracing.get_gauge(
            cont_mod.GAUGE_PREFIX + "duty_cycle") == \
            pytest.approx(0.2 / 15.0)

    def test_exporter_scrape_drives_tick_and_wires_lock(self):
        clock = ManualClock()
        cc = make_cc(clock, ContinuousConfig(period_s=15.0))
        exp = MetricsExporter(continuous=cc)
        # the shared one-capture-at-a-time lock is wired at attach
        assert cc.profile_lock is exp._profile_lock
        ticks0 = tracing.get_counter(cont_mod.TICKS)
        caps0 = tracing.get_counter(cont_mod.CAPTURES)
        text = exp.prometheus_text()
        assert tracing.get_counter(cont_mod.TICKS) == ticks0 + 1
        assert tracing.get_counter(cont_mod.CAPTURES) == caps0 + 1
        assert "serving_attribution_rolling_gbps" in text
        # while /profile holds the lock, the scrape's tick defers
        clock.advance(15.0)
        def0 = tracing.get_counter(cont_mod.DEFERRED)
        with exp._profile_lock:
            exp.prometheus_text()
        assert tracing.get_counter(cont_mod.DEFERRED) == def0 + 1
