"""The port's metrics registry (``raft_tpu_torch.core.tracing``) against
the JAX package's (``raft_tpu.core.tracing``): the same observations give
the same histogram snapshots and quantiles, the same reductions
(``sample_quantile``, ``probe_freq_stats``), the same lifetime ledger
after resets, and span rings whose Chrome trace exports agree and round
trip exactly."""

from __future__ import annotations

import numpy as np
import pytest

from raft_tpu.core import tracing as jt
from raft_tpu_torch.core import tracing as tt


def _values(seed):
    rng = np.random.default_rng(seed)
    return list(np.exp(rng.uniform(np.log(1e-7), np.log(200.0), 300)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_snapshots_equal(seed):
    jh, th = jt.Histogram(), tt.Histogram()
    for v in _values(seed):
        jh.observe(float(v))
        th.observe(float(v))
    assert th.snapshot() == jh.snapshot()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert th.quantile(q) == jh.quantile(q)


def test_named_histograms_and_reset():
    name = "test.torch_tracing.h"
    tt.reset_histograms(name)
    jt.reset_histograms(name)
    for v in (0.001, 0.002, 0.5):
        tt.observe(name, v)
        jt.observe(name, v)
    assert tt.histograms(name) == jt.histograms(name)
    assert tt.get_histogram(name).count == 3
    tt.reset_histograms(name)
    assert tt.histograms(name) == {}
    assert tt.get_histogram(name).count == 0


@pytest.mark.parametrize("samples", [[], [3.0], [5, 1, 4, 2], _values(4)])
@pytest.mark.parametrize("q", [0.0, 0.5, 0.99])
def test_sample_quantile_equal(samples, q):
    assert tt.sample_quantile(samples, q) == jt.sample_quantile(samples, q)


@pytest.mark.parametrize("case", ["zeros", "skewed", "uniform", "empty"])
def test_probe_freq_stats_equal(case):
    rng = np.random.default_rng(9)
    counts = {"zeros": np.zeros(64, np.int64),
              "skewed": (rng.zipf(1.5, 300) % 300).astype(np.int64),
              "uniform": np.full(50, 7, np.int64),
              "empty": np.zeros(0, np.int64)}[case]
    for top_n in (1, 8):
        assert (tt.probe_freq_stats(counts, top_n=top_n)
                == jt.probe_freq_stats(counts, top_n=top_n))


def test_counter_ledger_equal():
    pre = "test.torch_tracing.c."
    for mod in (tt, jt):
        mod.reset_counters(pre)
        mod.inc_counter(pre + "a", 2.0)
        mod.inc_counters({pre + "a": 1.0, pre + "b": 4.0})
        mod.max_counter(pre + "peak", 3.0)
        mod.max_counter(pre + "peak", 1.0)
    assert tt.counters(pre) == jt.counters(pre)
    before_t = tt.lifetime_counters(pre)
    before_j = jt.lifetime_counters(pre)
    tt.reset_counters(pre)
    jt.reset_counters(pre)
    assert tt.counters(pre) == {} == jt.counters(pre)
    tt.inc_counter(pre + "a")
    jt.inc_counter(pre + "a")
    lt = tt.lifetime_counters(pre)
    assert lt == {k: v - before_j[k] + before_t[k]
                  for k, v in jt.lifetime_counters(pre).items()}
    assert lt[pre + "a"] >= 4.0 and lt[pre + "peak"] >= 3.0


def test_gauges_equal():
    pre = "test.torch_tracing.g."
    for mod in (tt, jt):
        mod.reset_gauges(pre)
        mod.set_gauges({pre + "x": 1.5, pre + "y": -2.0})
        mod.set_gauge(pre + "x", 4.0)
    assert tt.gauges(pre) == jt.gauges(pre)
    assert tt.get_gauge(pre + "x") == jt.get_gauge(pre + "x") == 4.0
    assert tt.get_gauge(pre + "none", 7.0) == 7.0


def _fill(mod, rec):
    a, b = mod.new_trace_id(), mod.new_trace_id()
    assert b > a
    rec.record("serving.admission", 1.0, 1.0005, trace_ids=(a,),
               attrs={"rows": 3})
    rec.record("serving.execute", 2.0, 2.25, trace_ids=(a, b),
               attrs={"requests": 2},
               events=((2.1, "failed", {"error": "X"}),))
    rec.event("serving.shed", 3.0, trace_ids=(b,),
              attrs={"reason": "deadline"})
    return a, b


def test_span_ring_and_chrome_trace_equal():
    trec, jrec = tt.SpanRecorder(capacity=2), jt.SpanRecorder(capacity=2)
    ta, tb = _fill(tt, trec)
    ja, jb = _fill(jt, jrec)
    assert len(trec) == len(jrec) == 2
    assert trec.dropped == jrec.dropped == 1
    assert [s.name for s in trec.spans(trace_id=tb)] == \
        [s.name for s in jrec.spans(trace_id=jb)]

    def strip(trace, ids):
        # trace ids and thread ids differ between the two registries
        for ev in trace["traceEvents"]:
            ev.pop("tid")
            if "trace_ids" in ev["args"]:
                ev["args"]["trace_ids"] = [ids[t] for t in
                                           ev["args"]["trace_ids"]]
        return trace

    got = strip(trec.to_chrome_trace(), {ta: 0, tb: 1})
    want = strip(jrec.to_chrome_trace(), {ja: 0, jb: 1})
    assert got == want
    back = tt.SpanRecorder.from_chrome_trace(trec.to_chrome_trace())
    assert back == trec.spans()
    assert tt.SpanRecorder.from_chrome_trace(
        trec.to_chrome_trace(trace_id=-5)) == []


def test_process_ring_and_host_span():
    tt.reset_spans()
    tt.record_span("a", 0.0, 1.0, trace_ids=(1,))
    tt.span_event("b", 2.0)
    with tt.host_span("c", attrs={"k": 1}):
        pass
    names = [s.name for s in tt.span_recorder().spans()]
    assert names == ["a", "b", "c"]
    c = tt.span_recorder().spans(name="c")[0]
    assert c.duration >= 0.0 and c.attrs == {"k": 1}
    tt.reset_spans()
    assert len(tt.span_recorder()) == 0
