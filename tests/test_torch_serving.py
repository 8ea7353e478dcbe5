"""The port's serving frontend (``raft_tpu_torch.serving``) on the CPU:
dynamic batcher coalescing and re-split, dual-trigger timing, admission
control, the load-shed ladder and the fault-injection suite (deadline
expiry mid-queue, overflow -> typed Overloaded, cancellation before and
after batch assembly, shutdown drain), all deterministic through the
manual clock and the executor shims; then the port's real
``SearchExecutor`` behind the batcher: results bit-identical to direct
executor calls under coalescing, and no plan entry built in steady state
(``compile_count``). Mirrors the ManualClock suites of
``tests/test_serving.py``; the real-executor cases also hold the
batcher's results to the JAX package's executor (integer-valued data:
ids equal, distances to rtol 1e-5)."""

import dataclasses
import io
import threading

import numpy as np
import pytest

import torch

from raft_tpu import SearchExecutor as JExecutor
from raft_tpu.neighbors import ivf_flat as j_ivf
from raft_tpu_torch import Resources, SearchExecutor
from raft_tpu_torch.core import tracing
from raft_tpu_torch.neighbors import brute_force, ivf_flat
from raft_tpu_torch.serving import (
    BatcherConfig,
    Cancelled,
    DeadlineExceeded,
    DynamicBatcher,
    LoadShed,
    Overloaded,
    ShutDown,
)
from raft_tpu_torch.serving import metrics
from raft_tpu_torch.serving.harness import (
    FakeExecutor,
    ManualClock,
    ShimExecutor,
    burst_schedule,
    drive_open_loop,
)

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)


CPU = Resources(device="cpu")


class _Index:
    """Opaque index token for FakeExecutor tests."""


def q_block(ids, dim=4):
    """Query block whose first column encodes per-row ids (the
    FakeExecutor reflects them into results)."""
    b = np.zeros((len(ids), dim), np.float32)
    b[:, 0] = ids
    return b


def manual_batcher(executor=None, **cfg):
    clock = ManualClock()
    ex = executor or FakeExecutor()
    b = DynamicBatcher(ex, BatcherConfig(**cfg), clock=clock,
                       start=False)
    return b, ex, clock


class TestCoalescing:
    def test_batches_and_splits_per_request(self):
        b, ex, clock = manual_batcher(max_wait_s=0.01)
        idx = _Index()
        h1 = b.submit(idx, q_block([1, 2]), 3)
        h2 = b.submit(idx, q_block([7]), 3)
        h3 = b.submit(idx, q_block([4, 5, 6]), 3)
        assert b.pump() == 0          # neither trigger armed yet
        clock.advance(0.01)           # max-wait timer fires
        assert b.pump() == 1
        assert ex.calls == [(3, 6)]   # ONE coalesced executor call
        d1, i1 = h1.result(timeout=0)
        np.testing.assert_array_equal(i1[:, 0], [1 * 3, 2 * 3])
        _, i2 = h2.result(timeout=0)
        np.testing.assert_array_equal(i2[:, 0], [7 * 3])
        _, i3 = h3.result(timeout=0)
        np.testing.assert_array_equal(i3[:, 0], [4 * 3, 5 * 3, 6 * 3])
        assert d1.shape == (2, 3)
        b.close()

    def test_incompatible_requests_do_not_coalesce(self):
        b, ex, clock = manual_batcher(max_wait_s=0.01)
        idx, idx2 = _Index(), _Index()
        b.submit(idx, q_block([1]), 3)
        b.submit(idx, q_block([2]), 5)      # different k
        b.submit(idx2, q_block([3]), 3)     # different index identity
        clock.advance(0.01)
        assert b.pump() == 3
        assert sorted(ex.calls) == [(1, 1)] * 3
        b.close()

    def test_bucket_full_dispatches_without_wait(self):
        b, ex, clock = manual_batcher(max_wait_s=10.0, full_batch_rows=4)
        idx = _Index()
        b.submit(idx, q_block([1, 2]), 3)
        b.submit(idx, q_block([3, 4]), 3)
        # rows == full_batch_rows: dispatches with NO time advance
        assert b.pump() == 1
        assert ex.calls == [(2, 4)]
        b.close()

    def test_oversized_request_dispatches_alone(self):
        b, ex, clock = manual_batcher(max_wait_s=10.0, full_batch_rows=4)
        idx = _Index()
        h = b.submit(idx, q_block(list(range(10))), 2)
        assert b.pump() == 1           # 10 rows >= full -> immediate
        assert ex.calls == [(1, 10)]
        _, i = h.result(timeout=0)
        assert i.shape == (10, 2)
        b.close()

    def test_max_rows_splits_across_micro_batches(self):
        b, ex, clock = manual_batcher(max_wait_s=0.0, full_batch_rows=4)
        idx = _Index()
        for i in range(3):
            b.submit(idx, q_block([i, i + 10, i + 20]), 2)  # 3 rows each
        assert b.pump() >= 2
        assert sum(r for _, r in ex.calls) == 9
        assert all(r <= 4 for _, r in ex.calls)
        b.close()


class TestScheduling:
    def test_edf_within_priority(self):
        b, ex, clock = manual_batcher(max_wait_s=0.0, full_batch_rows=2)
        late, soon = _Index(), _Index()
        b.submit(late, q_block([1]), 3, timeout_s=100.0)
        b.submit(soon, q_block([2]), 3, timeout_s=1.0)
        b.pump()
        # the earlier-deadline group dispatched first
        assert ex.calls and ex.calls[0] == (1, 1)
        b.close()

    def test_priority_beats_deadline(self):
        b, ex, clock = manual_batcher(max_wait_s=0.0)
        lo, hi = _Index(), _Index()
        h_lo = b.submit(lo, q_block([1]), 3, timeout_s=1.0, priority=1)
        h_hi = b.submit(hi, q_block([2, 3]), 3, priority=0)  # no deadline
        b.pump()
        assert ex.calls[0] == (1, 2)   # priority-0 group first
        assert h_lo.done() and h_hi.done()
        b.close()


class TestFaultPaths:
    """The deterministic fault-injection suite."""

    def test_deadline_expiry_mid_queue_sheds_before_dispatch(self):
        metrics.reset()
        b, ex, clock = manual_batcher(max_wait_s=1.0)
        idx = _Index()
        h = b.submit(idx, q_block([1]), 3, timeout_s=0.5)
        clock.advance(0.75)            # past deadline, before max-wait
        assert b.pump() == 0
        with pytest.raises(DeadlineExceeded):
            h.result(timeout=0)
        assert ex.calls == []          # NO device work was spent
        assert tracing.get_counter("serving.batcher.shed_deadline") == 1
        b.close()

    def test_queue_overflow_raises_typed_overloaded(self):
        b, ex, clock = manual_batcher(max_wait_s=10.0, capacity=2)
        idx = _Index()
        b.submit(idx, q_block([1]), 3)
        b.submit(idx, q_block([2]), 3)
        with pytest.raises(Overloaded):
            b.submit(idx, q_block([3]), 3)
        b.close()

    def test_cancellation_before_assembly(self):
        metrics.reset()
        b, ex, clock = manual_batcher(max_wait_s=0.01)
        idx = _Index()
        h1 = b.submit(idx, q_block([1]), 3)
        h2 = b.submit(idx, q_block([2]), 3)
        assert h1.cancel() is True
        assert h1.cancelled()
        with pytest.raises(Cancelled):
            h1.result(timeout=0)
        clock.advance(0.01)
        b.pump()
        assert ex.calls == [(1, 1)]    # only the live request ran
        assert h2.result(timeout=0)[1][0, 0] == 2 * 3
        assert tracing.get_counter("serving.batcher.cancelled") == 1
        b.close()

    def test_cancellation_after_assembly_fails(self):
        b, ex, clock = manual_batcher(max_wait_s=0.0)
        idx = _Index()
        h = b.submit(idx, q_block([5]), 3)
        b.pump()                       # assembled + completed
        assert h.cancel() is False     # too late — result stands
        assert h.result(timeout=0)[1][0, 0] == 5 * 3
        b.close()

    def test_shutdown_drains_in_flight(self):
        b, ex, clock = manual_batcher(max_wait_s=100.0)
        idx = _Index()
        hs = [b.submit(idx, q_block([i]), 3) for i in range(4)]
        b.close(drain=True)            # dispatches despite max-wait
        for i, h in enumerate(hs):
            assert h.result(timeout=0)[1][0, 0] == i * 3
        assert ex.calls == [(4, 4)]

    def test_shutdown_without_drain_fails_typed(self):
        metrics.reset()
        b, ex, clock = manual_batcher(max_wait_s=100.0)
        idx = _Index()
        h = b.submit(idx, q_block([1]), 3)
        b.close(drain=False)
        with pytest.raises(ShutDown):
            h.result(timeout=0)
        assert ex.calls == []
        with pytest.raises(ShutDown):
            b.submit(idx, q_block([2]), 3)
        assert tracing.get_counter("serving.batcher.shutdown_shed") == 1

    def test_executor_failure_fails_the_batch_not_the_worker(self):
        inner = FakeExecutor()
        clock = ManualClock()
        shim = ShimExecutor(inner, fail_on={0: RuntimeError("boom")})
        b = DynamicBatcher(shim, BatcherConfig(max_wait_s=0.0),
                           clock=clock, start=False)
        idx = _Index()
        h1 = b.submit(idx, q_block([1]), 3)
        b.pump()
        assert isinstance(h1.exception(timeout=0), RuntimeError)
        h2 = b.submit(idx, q_block([2]), 3)   # worker survives
        b.pump()
        assert h2.result(timeout=0)[1][0, 0] == 2 * 3
        b.close()

    def test_slow_executor_piles_queue_deterministically(self):
        inner = FakeExecutor()
        clock = ManualClock()
        shim = ShimExecutor(inner, delay_s=0.5, clock=clock)
        b = DynamicBatcher(shim, BatcherConfig(max_wait_s=0.0),
                           clock=clock, start=False)
        idx = _Index()
        h1 = b.submit(idx, q_block([1]), 3, timeout_s=0.1)
        b.pump()                        # executes; clock += 0.5
        h2 = b.submit(idx, q_block([2]), 3, timeout_s=0.1)
        clock.advance(0.2)              # h2 expires while "device busy"
        b.pump()
        assert h1.result(timeout=0)[1][0, 0] == 3
        with pytest.raises(DeadlineExceeded):
            h2.result(timeout=0)
        b.close()


class TestLoadShedLadder:
    def test_rung1_shrinks_max_wait(self):
        b, ex, clock = manual_batcher(max_wait_s=100.0, capacity=10)
        idx = _Index()
        for i in range(5):             # occupancy 0.5 -> rung 1
            b.submit(idx, q_block([i]), 3)
        assert b.pump() == 1           # dispatched with NO time advance
        b.close()

    def test_rung2_applies_params_override(self):
        shed = LoadShed(degrade_params_at=0.5,
                        params_override=lambda p: "degraded")
        clock = ManualClock()
        ex = FakeExecutor()
        b = DynamicBatcher(
            ex, BatcherConfig(max_wait_s=0.0, capacity=4, shed=shed),
            clock=clock, start=False)
        idx = _Index()
        b.submit(idx, q_block([1]), 3)
        b.submit(idx, q_block([2]), 3)          # occupancy hits 0.5
        h = b.submit(idx, q_block([3]), 3)      # rung 2: override applies
        assert tracing.get_counter(
            "serving.batcher.shed_degraded_params") >= 1
        b.pump()
        assert h.done()
        b.close()

    def test_rung3_is_typed_overload(self):
        b, ex, clock = manual_batcher(max_wait_s=100.0, capacity=1)
        idx = _Index()
        b.submit(idx, q_block([1]), 3)
        with pytest.raises(Overloaded):
            b.submit(idx, q_block([2]), 3)
        b.close()


class TestOpenLoopLoad:
    def test_bursty_load_coalesces(self):
        metrics.reset()
        b, ex, clock = manual_batcher(max_wait_s=0.005,
                                      full_batch_rows=64)
        idx = _Index()

        def submit(ordinal, t):
            return b.submit(idx, q_block([ordinal]), 3, timeout_s=1.0)

        sched = burst_schedule(n_bursts=5, burst_size=8, period_s=0.01)
        handles = drive_open_loop(submit, sched, clock, pump=b.pump)
        clock.advance(0.01)
        b.pump()
        assert all(h.done() for h in handles)
        occ = metrics.occupancy()
        # bursts coalesce: well above one request per executor call
        assert occ["requests_per_batch"] >= 2.0
        assert tracing.get_counter("serving.batcher.requests") == 40
        b.close()


class TestThreadedMode:
    """Real worker thread + real clock: liveness and leak checks (all
    waits are event-based with bounded timeouts, not sleeps)."""

    def test_background_thread_serves_and_joins(self):
        ex = FakeExecutor()
        b = DynamicBatcher(ex, BatcherConfig(max_wait_s=0.001))
        idx = _Index()
        hs = [b.submit(idx, q_block([i, i + 50]), 4) for i in range(8)]
        for i, h in enumerate(hs):
            _, ii = h.result(timeout=10.0)
            np.testing.assert_array_equal(ii[:, 0], [i * 4, (i + 50) * 4])
        t = b._thread
        b.close()
        assert b._thread is None and not t.is_alive()

    def test_no_leaked_threads_or_futures(self):
        before = threading.active_count()
        for _ in range(3):
            b = DynamicBatcher(FakeExecutor(),
                               BatcherConfig(max_wait_s=0.001))
            h = b.submit(_Index(), q_block([1]), 2)
            h.result(timeout=10.0)
            b.close()
        assert threading.active_count() == before

    def test_concurrent_submitters(self):
        ex = FakeExecutor()
        b = DynamicBatcher(ex, BatcherConfig(max_wait_s=0.001))
        idx = _Index()
        results = {}

        def worker(base):
            h = b.submit(idx, q_block([base]), 2)
            results[base] = h.result(timeout=10.0)

        ts = [threading.Thread(target=worker, args=(i,))
              for i in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        b.close()
        for base, (_, ii) in results.items():
            assert ii[0, 0] == base * 2


@pytest.fixture(scope="module")
def real_setup():
    """Integer-valued data (exact products); the IVF-Flat index is built
    by the JAX package and loaded into the port."""
    rng = np.random.default_rng(3)
    x = rng.integers(-4, 5, (400, 16)).astype(np.float32)
    q = rng.integers(-4, 5, (24, 16)).astype(np.float32)
    jivf = j_ivf.build(None, j_ivf.IvfFlatIndexParams(n_lists=8), x)
    buf = io.BytesIO()
    j_ivf.save(jivf, buf)
    buf.seek(0)
    return {
        "x": x, "q": q, "jivf": jivf,
        "bf": brute_force.build(CPU, x),
        "ivf": ivf_flat.load(CPU, buf),
    }


def _cat(handles, col):
    return torch.cat([h.result(timeout=0)[col] for h in handles])


class TestRealExecutor:
    """Acceptance criteria against the port's real serving path."""

    @pytest.mark.parametrize("name", ["bf", "ivf"])
    def test_bit_identical_to_direct_executor(self, real_setup, name):
        ex = SearchExecutor(CPU)
        clock = ManualClock()
        b = DynamicBatcher(ex, BatcherConfig(max_wait_s=0.01),
                           clock=clock, start=False)
        q = real_setup["q"]
        params = (ivf_flat.IvfFlatSearchParams(n_probes=4)
                  if name == "ivf" else None)
        index = real_setup[name]
        want_d, want_i = ex.search(index, q, 5, params=params)
        # three requests coalesce into one call, then re-split
        h1 = b.submit(index, q[:7], 5, params=params)
        h2 = b.submit(index, q[7:10], 5, params=params)
        h3 = b.submit(index, q[10:], 5, params=params)
        clock.advance(0.01)
        assert b.pump() == 1
        hs = (h1, h2, h3)
        assert torch.equal(_cat(hs, 1), want_i)
        assert torch.equal(_cat(hs, 0), want_d)
        if name == "ivf":
            jd, ji = JExecutor().search(
                real_setup["jivf"], q, 5,
                params=j_ivf.IvfFlatSearchParams(n_probes=4))
            np.testing.assert_array_equal(_cat(hs, 1).numpy(),
                                          np.asarray(ji))
            np.testing.assert_allclose(_cat(hs, 0).numpy(), np.asarray(jd),
                                       rtol=1e-5)
        b.close()

    def test_steady_state_zero_recompile(self, real_setup):
        ex = SearchExecutor(CPU)
        clock = ManualClock()
        b = DynamicBatcher(ex, BatcherConfig(max_wait_s=0.01),
                           clock=clock, start=False)
        index, q = real_setup["bf"], real_setup["q"]

        def roundtrip(sizes):
            hs, at = [], 0
            for m in sizes:
                hs.append(b.submit(index, q[at:at + m], 5))
                at += m
            clock.advance(0.01)
            b.pump()
            return [h.result(timeout=0) for h in hs]

        roundtrip([7, 3, 6])           # prime: the bucket's entry
        compiles0 = ex.stats.compile_count
        base = tracing.get_counter("serving.compile_count")
        for sizes in ([7, 3, 6], [5, 5, 6], [16], [7, 3, 6]):
            roundtrip(sizes)
        assert ex.stats.compile_count == compiles0 == 1
        assert tracing.get_counter("serving.compile_count") == base
        b.close()

    def test_degraded_params_stay_zero_recompile_after_warmup(
            self, real_setup):
        """Rung 2's override is part of the coalesce key; warming the
        degraded specialization keeps the whole ladder entry-free."""
        index, q = real_setup["ivf"], real_setup["q"]
        p = ivf_flat.IvfFlatSearchParams(n_probes=8)
        p_shed = dataclasses.replace(p, n_probes=2)
        ex = SearchExecutor(CPU)
        shed = LoadShed(degrade_params_at=0.4,
                        params_override=lambda _: p_shed)
        clock = ManualClock()
        b = DynamicBatcher(
            ex, BatcherConfig(max_wait_s=0.0, capacity=10, shed=shed),
            clock=clock, start=False)
        for params in (p, p_shed):
            hs = [b.submit(index, q[:8], 5, params=params)
                  for _ in range(5)]
            b.pump()
            for h in hs:
                h.result(timeout=0)
        compiles0 = ex.stats.compile_count
        hs = [b.submit(index, q[:8], 5, params=p) for _ in range(5)]
        b.pump()
        for h in hs:
            h.result(timeout=0)
        assert ex.stats.compile_count == compiles0
        assert tracing.get_counter(
            "serving.batcher.shed_degraded_params") >= 1
        b.close()

    def test_ragged_mode_waits_for_the_ragged_family(self, real_setup):
        """``BatcherConfig(ragged=True)`` sends a raggable submission
        (IVF-Flat) through the executor's ragged family
        (``search_ragged``) and a non-raggable one (brute force) through
        ``search_blocks``; both equal their direct searches."""
        ex = SearchExecutor(CPU, ragged_tile=16)
        shim = ShimExecutor(ex)
        calls = []
        for name in ("search_ragged", "search_blocks"):
            def spy(*a, _name=name, **kw):
                calls.append(_name)
                return getattr(ShimExecutor, _name)(shim, *a, **kw)
            setattr(shim, name, spy)
        clock = ManualClock()
        b = DynamicBatcher(shim, BatcherConfig(ragged=True, max_wait_s=0.01),
                           clock=clock, start=False)
        q = real_setup["q"]
        p = ivf_flat.IvfFlatSearchParams(n_probes=4)
        h_ivf = b.submit(real_setup["ivf"], q[:5], 5, params=p)
        h_bf = b.submit(real_setup["bf"], q[5:9], 5)
        clock.advance(0.01)
        assert b.pump() == 2
        assert sorted(calls) == ["search_blocks", "search_ragged"]
        assert ex.ragged_executables() == 1
        for h, want in ((h_ivf, ex.search(real_setup["ivf"], q[:5], 5,
                                          params=p)),
                        (h_bf, ex.search(real_setup["bf"], q[5:9], 5))):
            d, i = h.result(timeout=0)
            assert torch.equal(i, want[1]) and torch.equal(d, want[0])
        b.close()


class TestFiltersAndCagra:
    """Filters coalesce safely (or not at all), and CAGRA keeps per-block
    bit-identity while coalescing: its seeds are a function of each
    query's content, so concatenated blocks cannot perturb each other."""

    def test_distinct_shared_filters_never_coalesce(self, real_setup):
        from raft_tpu_torch.core.bitset import Bitset
        from raft_tpu_torch.neighbors.filters import BitsetFilter

        x, q = real_setup["x"], real_setup["q"]
        index = real_setup["ivf"]
        p = ivf_flat.IvfFlatSearchParams(n_probes=8)
        m1 = np.ones(x.shape[0], bool)
        m1[::2] = False
        m2 = np.ones(x.shape[0], bool)
        m2[1::2] = False
        f1 = BitsetFilter(Bitset.from_mask(torch.from_numpy(m1)))
        f2 = BitsetFilter(Bitset.from_mask(torch.from_numpy(m2)))
        ex = SearchExecutor(CPU)
        want1 = ex.search(index, q[:8], 5, params=p, sample_filter=f1)[1]
        want2 = ex.search(index, q[8:16], 5, params=p, sample_filter=f2)[1]
        clock = ManualClock()
        b = DynamicBatcher(ex, BatcherConfig(max_wait_s=0.01),
                           clock=clock, start=False)
        h1 = b.submit(index, q[:8], 5, params=p, sample_filter=f1)
        h2 = b.submit(index, q[8:16], 5, params=p, sample_filter=f2)
        clock.advance(0.01)
        assert b.pump() == 2    # equal specs, different words: 2 calls
        assert torch.equal(h1.result(timeout=0)[1], want1)
        assert torch.equal(h2.result(timeout=0)[1], want2)
        b.close()

    def test_per_row_bitmap_filters_coalesce_and_resplit(self,
                                                         real_setup):
        from raft_tpu_torch.neighbors.filters import BitmapFilter

        x, q = real_setup["x"], real_setup["q"]
        index = real_setup["ivf"]
        p = ivf_flat.IvfFlatSearchParams(n_probes=8)
        rng = np.random.default_rng(5)
        mask = rng.random((16, x.shape[0])) > 0.3
        bm1 = BitmapFilter.from_mask(mask[:9])
        bm2 = BitmapFilter.from_mask(mask[9:])
        ex = SearchExecutor(CPU)
        want1 = ex.search(index, q[:9], 5, params=p, sample_filter=bm1)[1]
        want2 = ex.search(index, q[9:16], 5, params=p,
                          sample_filter=bm2)[1]
        clock = ManualClock()
        b = DynamicBatcher(ex, BatcherConfig(max_wait_s=0.01),
                           clock=clock, start=False)
        h1 = b.submit(index, q[:9], 5, params=p, sample_filter=bm1)
        h2 = b.submit(index, q[9:16], 5, params=p, sample_filter=bm2)
        clock.advance(0.01)
        assert b.pump() == 1    # per-row words concatenate: ONE call
        assert torch.equal(h1.result(timeout=0)[1], want1)
        assert torch.equal(h2.result(timeout=0)[1], want2)
        b.close()

    @pytest.mark.parametrize("algo", ["cuda", "torch"])
    def test_cagra_blocks_keep_solo_bit_identity(self, real_setup, algo):
        from raft_tpu_torch.neighbors import cagra

        x, q = real_setup["x"], real_setup["q"]
        index = cagra.build(CPU, cagra.CagraIndexParams(
            graph_degree=8, intermediate_graph_degree=16,
            build_algo=cagra.BuildAlgo.NN_DESCENT), x)
        p = cagra.CagraSearchParams(algo=algo)
        ex = SearchExecutor(CPU)
        spans = ((0, 7), (7, 12), (12, 24))
        want = [ex.search(index, q[lo:hi], 5, params=p)[1]
                for lo, hi in spans]
        clock = ManualClock()
        b = DynamicBatcher(ex, BatcherConfig(max_wait_s=0.01),
                           clock=clock, start=False)
        hs = [b.submit(index, q[lo:hi], 5, params=p) for lo, hi in spans]
        clock.advance(0.01)
        assert b.pump() == 1
        for h, w in zip(hs, want):
            assert torch.equal(h.result(timeout=0)[1], w)
        b.close()


class TestHistograms:
    def test_stage_histograms_populate(self):
        metrics.reset()
        b, ex, clock = manual_batcher(max_wait_s=0.0)
        idx = _Index()
        for i in range(4):
            b.submit(idx, q_block([i]), 3)
            b.pump()
        b.close()
        hist = tracing.histograms(metrics.PREFIX)
        for name in (metrics.QUEUE_WAIT, metrics.EXECUTE, metrics.E2E):
            assert hist[name]["count"] == 4, name

    def test_quantile_estimates(self):
        h = tracing.Histogram()
        for v in [0.001] * 90 + [0.1] * 10:
            h.observe(v)
        assert h.count == 100
        assert h.quantile(0.5) <= 0.002
        assert h.quantile(0.99) >= 0.05
        assert h.quantile(0.5) <= h.quantile(0.95) <= h.quantile(0.99)


