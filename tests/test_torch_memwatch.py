"""The port's memory truth against the JAX package's on the CPU: the byte
model of one index (the JAX index and its port copy hold the same
arrays), the planned-layout bytes, and a capacity-configured ledger's
forecast, headroom, verdicts, holds and gate, step by step on both.
Plus the counter registry they count through (``core.tracing``)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from raft_tpu.core import memwatch as j_memwatch
from raft_tpu.core import tracing as j_tracing
from raft_tpu.neighbors import ivf_flat as j_ivf
from raft_tpu_torch import Resources
from raft_tpu_torch.core import memwatch, tracing
from raft_tpu_torch.neighbors import ivf_flat

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

RES = Resources(device="cpu")


@pytest.fixture(scope="module")
def indexes():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1500, 24)).astype(np.float32)
    jidx = j_ivf.build(None, j_ivf.IvfFlatIndexParams(n_lists=10), x)
    pidx = ivf_flat.from_numpy(
        np.array(jidx.centers), np.array(jidx.data), np.array(jidx.indices),
        np.array(jidx.list_sizes), res=RES)
    return jidx, pidx


def test_index_memory_model_matches_reference(indexes):
    jidx, pidx = indexes
    want = j_memwatch.index_memory_model(jidx)
    got = memwatch.index_memory_model(pidx)
    assert got["family"] == want["family"] == "IvfFlatIndex"
    assert set(got["components"]) == set(want["components"])
    for name, comp in got["components"].items():
        ref = want["components"][name]
        assert (comp["bytes"], comp["shape"], comp["tier"]) == (
            ref["bytes"], ref["shape"], ref["tier"])
    for key in ("resident_bytes", "host_resident_bytes", "per_device_bytes"):
        assert got[key] == want[key]


def test_array_bytes_and_memory_tier():
    a = np.zeros((3, 5), np.int16)
    t = torch.zeros((3, 5), dtype=torch.bfloat16)
    assert memwatch.array_bytes(a) == j_memwatch.array_bytes(a) == 30
    assert memwatch.array_bytes(t) == 30
    assert memwatch.memory_tier(a) == j_memwatch.memory_tier(a) == "host"
    # a CPU tensor that is not pinned is the CPU index's one pool
    assert memwatch.memory_tier(t) == "device"


@pytest.mark.parametrize("kw", [{}, {"norms": False},
                                {"indices": False, "norms": False}])
def test_packed_layout_bytes_matches_reference(kw):
    for shape in ((1024, 4020, 512), (7, 0, 96), (3, 13, 1)):
        assert (memwatch.packed_layout_bytes(*shape, **kw)
                == j_memwatch.packed_layout_bytes(*shape, **kw))


def test_device_stats_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert memwatch.device_memory_stats() == {"supported": False,
                                              "devices": {}}
    assert memwatch.MemoryLedger().headroom_bytes() is None


def test_ledger_matches_reference_step_by_step(indexes):
    jidx, pidx = indexes
    cap = 3 * memwatch.index_memory_model(pidx)["resident_bytes"]
    jl = j_memwatch.MemoryLedger(capacity_bytes=cap)
    pl = memwatch.MemoryLedger(capacity_bytes=cap)
    assert jl.watch("sift flat", jidx) == pl.watch("sift flat", pidx)

    def same(fn):
        want, got = fn(jl), fn(pl)
        assert got == want
        return got

    fc = pl.forecast()
    assert fc["resident_bytes"] == jl.forecast()["resident_bytes"]
    assert fc["peak_bytes"] == jl.forecast()["peak_bytes"]
    room = same(lambda led: led.headroom_bytes())
    assert room == cap - fc["resident_bytes"]
    same(lambda led: led.fits(int(room) - 1))
    same(lambda led: led.fits(int(room) + 1))
    same(lambda led: led.fits(int(room), safety_fraction=0.5))
    same(lambda led: led.reserve("prefetch", int(room) // 2))
    same(lambda led: led.reserved_bytes())
    same(lambda led: led.headroom_bytes())
    # growth past the headroom is refused and the prior hold is kept
    for led, exc in ((jl, j_memwatch.CapacityExceeded),
                     (pl, memwatch.CapacityExceeded)):
        with pytest.raises(exc):
            led.reserve("prefetch", 2 * int(room))
    same(lambda led: led.reserved_bytes())
    same(lambda led: led.reserve("prefetch", 0))
    same(lambda led: led.reserved_bytes())
    same(lambda led: led.release("prefetch"))
    assert set(pl.resident()) == {"sift-flat"}
    pl.unwatch("sift-flat")
    assert pl.resident() == {} and pl.forecast()["peak_bytes"] == 0.0


def test_gate_admits_and_refuses_and_counts():
    for mw, tr in ((j_memwatch, j_tracing), (memwatch, tracing)):
        ledger = mw.MemoryLedger(capacity_bytes=1000)
        mw.admit(10**9, "no gate installed: a no-op")
        mw.install_gate(ledger)
        try:
            assert mw.gate() is ledger
            admitted = tr.get_counter("memory.gate.admitted")
            refused = tr.get_counter("memory.gate.refused")
            mw.admit(999, "fits")
            with pytest.raises(mw.CapacityExceeded) as e:
                mw.admit(1001, "too big")
            assert (e.value.required_bytes, e.value.headroom_bytes) == (
                1001, 1000.0)
            assert tr.get_counter("memory.gate.admitted") == admitted + 1
            assert tr.get_counter("memory.gate.refused") == refused + 1
        finally:
            mw.remove_gate()
        assert mw.gate() is None


def test_counters_and_gauges():
    tracing.inc_counter("test.torch.a")
    tracing.inc_counters({"test.torch.a": 2.0, "test.torch.b": 0.5})
    assert tracing.get_counter("test.torch.a") == 3.0
    assert tracing.counters("test.torch.") == {"test.torch.a": 3.0,
                                               "test.torch.b": 0.5}
    assert tracing.get_counter("test.torch.never") == 0.0
    tracing.set_gauge("test.torch.g", 4.0)
    tracing.set_gauge("test.torch.g", 2.0)
    assert tracing.gauges("test.torch.") == {"test.torch.g": 2.0}
    tracing.reset_gauges("test.torch.")
    assert tracing.gauges("test.torch.") == {}
