"""The port's ragged continuous batching on the CPU: the request's row-split
state, ``AdmissionQueue.pop_rows``, ``BatcherConfig(ragged=True)`` over
the fake and shim executors (ManualClock, deterministic), and the port's
real ``SearchExecutor`` behind a ragged batcher: every request equal bit
for bit to its direct bucketed search, ids equal to the JAX package's
executor on integer-valued data, no plan entry built after the one
warmup, and the pad waste of a packed tile against the bucketed path's.
Mirrors ``tests/test_serving.py``'s ``TestRaggedBatcher``,
``TestRaggedRealExecutor`` and ``TestGroupFairness``."""

import io
import threading

import numpy as np
import pytest
import torch

from raft_tpu import SearchExecutor as JExecutor
from raft_tpu.neighbors import cagra as j_cagra
from raft_tpu.neighbors import ivf_flat as j_ivf
from raft_tpu_torch import Resources, SearchExecutor
from raft_tpu_torch.core import tracing
from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat
from raft_tpu_torch.neighbors.filters import BitmapFilter
from raft_tpu_torch.serving import (
    BatcherConfig,
    DeadlineExceeded,
    DynamicBatcher,
    SearchRequest,
    metrics,
)
from raft_tpu_torch.serving.admission import AdmissionQueue
from raft_tpu_torch.serving.harness import (
    FakeExecutor,
    ManualClock,
    ShimExecutor,
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


def ragged_batcher(executor=None, tile=4, **cfg):
    clock = ManualClock()
    ex = executor or FakeExecutor(ragged_tile=tile)
    cfg.setdefault("max_wait_s", 0.01)
    b = DynamicBatcher(ex, BatcherConfig(ragged=True, **cfg), clock=clock,
                       start=False)
    return b, ex, clock


def _request(rows, key="g", order=0):
    r = SearchRequest(index=None, queries=q_block(list(range(rows))), k=2,
                      compat_key=key, ragged=True)
    r.seq = order
    return r


class TestRowSplitState:
    def test_take_and_rows_left(self):
        r = _request(5)
        assert r.rows_left == 5
        assert r.take(3) == (0, 3) and r.rows_left == 2
        assert r.take(2) == (3, 5) and r.rows_left == 0

    def test_parts_assemble_once_in_row_order(self):
        r = _request(5)
        d = np.arange(10, dtype=np.float32).reshape(5, 2)
        i = np.arange(10, dtype=np.int32).reshape(5, 2)
        assert not r.add_part(3, d[3:], i[3:])
        assert r.add_part(0, d[:3], i[:3])
        ad, ai = r.assemble()
        np.testing.assert_array_equal(ad, d)
        np.testing.assert_array_equal(ai, i)

    def test_tensor_parts_assemble_with_torch(self):
        r = _request(4)
        d = torch.arange(8, dtype=torch.float32).reshape(4, 2)
        r.add_part(2, d[2:], d[2:].int())
        assert r.add_part(0, d[:2], d[:2].int())
        ad, ai = r.assemble()
        assert torch.equal(ad, d) and ai.dtype == torch.int32

    def test_concurrent_slices_elect_one_assembler(self):
        r = _request(64)
        d = np.zeros((1, 2), np.float32)
        wins = []

        def deliver(row):
            wins.append(r.add_part(row, d, d.astype(np.int32)))

        ts = [threading.Thread(target=deliver, args=(j,))
              for j in range(64)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert sum(wins) == 1


class TestPopRows:
    def test_splits_the_boundary_request(self):
        q = AdmissionQueue()
        a, b = _request(3, order=0), _request(4, order=1)
        q.push(a)
        q.push(b)
        out = q.pop_rows("g", 5)
        assert [(r is a, s, e) for r, s, e in out] == [(True, 0, 3),
                                                       (False, 0, 2)]
        assert len(q) == 1                # b's remainder stays queued
        (head,) = q.group_heads(0.0)
        assert head.rows == 2 and head.ragged
        out = q.pop_rows("g", 5)
        assert [(r is b, s, e) for r, s, e in out] == [(True, 2, 4)]
        assert len(q) == 0

    def test_cancelled_request_is_skipped(self):
        q = AdmissionQueue()
        a, b = _request(2, order=0), _request(2, order=1)
        q.push(a)
        q.push(b)
        assert a.handle.cancel()
        out = q.pop_rows("g", 8)
        assert [r for r, _, _ in out] == [b]
        assert tracing.get_counter("serving.batcher.cancelled") >= 1

    def test_failed_remainder_is_dropped_uncounted(self):
        q = AdmissionQueue()
        a = _request(6)
        q.push(a)
        q.pop_rows("g", 4)
        a.handle._set_exception(RuntimeError("slice failed"))
        before = tracing.get_counter("serving.batcher.cancelled")
        assert q.group_heads(0.0) == []
        assert len(q) == 0
        assert tracing.get_counter("serving.batcher.cancelled") == before

    def test_started_remainder_is_not_shed_at_its_deadline(self):
        q = AdmissionQueue()
        a = _request(6)
        a.deadline = 1.0
        q.push(a)
        q.pop_rows("g", 4)
        (head,) = q.group_heads(5.0)      # past the deadline
        assert head.rows == 2 and not a.handle.done()


class TestRaggedBatcher:
    """One packed tile admits continuously, requests split at the tile's
    edge, and what is not raggable falls back to the bucketed path."""

    def test_continuous_packing_dual_trigger(self):
        b, ex, clock = ragged_batcher(tile=4)
        idx = _Index()
        h1 = b.submit(idx, q_block([1, 2, 3]), 3)
        h2 = b.submit(idx, q_block([7, 8]), 2)
        h3 = b.submit(idx, q_block([4, 5, 6, 9]), 3)
        # two full tiles go at once (tile-full trigger)
        assert b.pump() == 2
        assert ex.ragged_calls == [(2, 4), (2, 4)]
        assert not h3.done()
        clock.advance(0.01)               # the timer flushes the rest
        assert b.pump() == 1
        np.testing.assert_array_equal(h1.result(timeout=0)[1][:, 0],
                                      [3, 6, 9])
        np.testing.assert_array_equal(h2.result(timeout=0)[1][:, 0],
                                      [14, 16])
        _, i3 = h3.result(timeout=0)
        assert i3.shape == (4, 3)
        np.testing.assert_array_equal(i3[:, 0], [12, 15, 18, 27])
        b.close()

    def test_tile_overflow_split_reassembles(self):
        b, ex, clock = ragged_batcher(tile=4)
        ids = list(range(10))
        h = b.submit(_Index(), q_block(ids), 2)
        assert b.pump() == 2
        assert not h.done()
        clock.advance(0.01)
        assert b.pump() == 1
        _, i = h.result(timeout=0)
        assert i.shape == (10, 2)
        np.testing.assert_array_equal(i[:, 0], [v * 2 for v in ids])
        b.close()

    def test_mixed_k_packs_into_one_call(self):
        b, ex, _ = ragged_batcher(tile=4)
        idx = _Index()
        h1 = b.submit(idx, q_block([1, 2]), 3)
        h2 = b.submit(idx, q_block([5, 6]), 7)
        assert b.pump() == 1
        assert ex.ragged_calls == [(2, 4)]
        assert h1.result(timeout=0)[1].shape == (2, 3)
        assert h2.result(timeout=0)[1].shape == (2, 7)
        b.close()

    def test_empty_after_shed_batch(self):
        b, ex, clock = ragged_batcher(tile=8)
        idx = _Index()
        h1 = b.submit(idx, q_block([1]), 2, timeout_s=0.005)
        h2 = b.submit(idx, q_block([2, 3]), 2, timeout_s=0.005)
        clock.advance(0.02)
        assert b.pump() == 0
        assert not ex.ragged_calls and not ex.calls
        for h in (h1, h2):
            with pytest.raises(DeadlineExceeded):
                h.result(timeout=0)
        b.close()

    def test_edf_order_preserved(self):
        b, ex, _ = ragged_batcher(tile=2, max_wait_s=0.0)
        late, soon = _Index(), _Index()
        b.submit(late, q_block([1]), 3, timeout_s=100.0)
        b.submit(soon, q_block([2]), 3, timeout_s=1.0)
        b.pump()
        assert ex.ragged_calls and ex.ragged_calls[0] == (1, 1)
        b.close()

    def test_cancel_before_first_slice(self):
        b, ex, clock = ragged_batcher(tile=4)
        h = b.submit(_Index(), q_block([1, 2]), 2)
        assert h.cancel()
        clock.advance(0.01)
        assert b.pump() == 0
        assert not ex.ragged_calls
        b.close()

    def test_shutdown_drains_split_requests(self):
        b, _, _ = ragged_batcher(tile=4)
        h = b.submit(_Index(), q_block(list(range(6))), 2)
        assert b.pump() == 1              # 4 of 6 rows
        b.close(drain=True)
        _, i = h.result(timeout=0)
        np.testing.assert_array_equal(i[:, 0], [0, 2, 4, 6, 8, 10])

    def test_failed_tile_fails_split_request_once(self):
        clock = ManualClock()
        shim = ShimExecutor(FakeExecutor(ragged_tile=4),
                            fail_on={0: RuntimeError("boom")}, clock=clock)
        b = DynamicBatcher(shim, BatcherConfig(ragged=True, max_wait_s=0.0),
                           clock=clock, start=False)
        before = tracing.get_counter("serving.batcher.failed_batches")
        h = b.submit(_Index(), q_block(list(range(6))), 2)
        b.pump()
        assert isinstance(h.exception(timeout=0), RuntimeError)
        assert tracing.get_counter(
            "serving.batcher.failed_batches") == before + 1
        assert shim.calls == [(1, 4)]     # the remainder never ran
        b.close()

    def test_bucketed_only_index_falls_back(self):
        b, ex, clock = ragged_batcher(tile=4)
        idx = _Index()
        idx.bucketed_only = True
        h = b.submit(idx, q_block([5]), 2)
        clock.advance(0.01)
        assert b.pump() == 1
        assert ex.calls == [(1, 1)] and not ex.ragged_calls
        np.testing.assert_array_equal(h.result(timeout=0)[1][:, 0], [10])
        b.close()

    def test_shim_charges_ragged_calls_to_the_clock(self):
        clock = ManualClock()
        shim = ShimExecutor(FakeExecutor(ragged_tile=4), delay_s=0.5,
                            clock=clock)
        assert shim.ragged_tile == 4
        assert shim.ragged_key(_Index(), 2) is not None
        b = DynamicBatcher(shim, BatcherConfig(ragged=True, max_wait_s=0.0),
                           clock=clock, start=False)
        h = b.submit(_Index(), q_block([1, 2]), 2)
        b.pump()
        assert h.done() and clock.now() == 0.5
        b.close()

    def test_threaded_ragged_mode_serves_and_joins(self):
        ex = FakeExecutor(ragged_tile=4)
        b = DynamicBatcher(ex, BatcherConfig(ragged=True, max_wait_s=0.001))
        idx = _Index()
        hs = [b.submit(idx, q_block([i, i + 50, i + 100]), 2)
              for i in range(10)]
        for i, h in enumerate(hs):
            _, ii = h.result(timeout=10.0)
            np.testing.assert_array_equal(ii[:, 0],
                                          [2 * i, 2 * (i + 50),
                                           2 * (i + 100)])
        b.close()
        assert sum(rows for _, rows in ex.ragged_calls) == 30


class TestGroupFairness:
    def test_budget_forces_other_ready_group(self):
        clock = ManualClock()
        ex = FakeExecutor(ragged_tile=2)
        b = DynamicBatcher(ex, BatcherConfig(ragged=True, max_wait_s=0.0,
                                             group_budget=2),
                           clock=clock, start=False)
        a, other = _Index(), _Index()
        for i in range(8):
            b.submit(a, q_block([i]), 2)
        hb = b.submit(other, q_block([99]), 2)
        clock.advance(0.01)
        order = []
        while True:
            got = b._poll()
            if not got:
                break
            key, items, ragged = got
            assert ragged
            order.append("B" if items[0][0].queries[0, 0] == 99 else "A")
            b._dispatch_ragged(key, items)
        assert order == ["A", "A", "B", "A", "A"]
        assert hb.done()
        b.close()


@pytest.fixture(scope="module")
def real_setup():
    """Integer-valued data (exact products); the IVF-Flat and CAGRA indexes
    are built by the JAX package and loaded into the port."""
    rng = np.random.default_rng(3)
    x = rng.integers(-4, 5, (400, 16)).astype(np.float32)
    q = rng.integers(-4, 5, (24, 16)).astype(np.float32)
    jivf = j_ivf.build(None, j_ivf.IvfFlatIndexParams(n_lists=8), x)
    jcg = j_cagra.build(None, j_cagra.CagraIndexParams(
        graph_degree=8, intermediate_graph_degree=16,
        build_algo=j_cagra.BuildAlgo.NN_DESCENT), x)
    out = {"x": x, "q": q, "jivf": jivf, "jcg": jcg,
           "bf": brute_force.build(CPU, x)}
    for name, mod, jmod, jidx in (("ivf", ivf_flat, j_ivf, jivf),
                                  ("cg", cagra, j_cagra, jcg)):
        buf = io.BytesIO()
        jmod.save(jidx, buf)
        buf.seek(0)
        out[name] = mod.load(CPU, buf)
    return out


class TestRaggedRealExecutor:
    def test_bit_identity_and_no_entry_after_warmup(self, real_setup):
        ex = SearchExecutor(CPU, ragged_tile=16)
        clock = ManualClock()
        b = DynamicBatcher(ex, BatcherConfig(max_wait_s=0.01, ragged=True),
                           clock=clock, start=False)
        q, index = real_setup["q"], real_setup["ivf"]
        p1 = ivf_flat.IvfFlatSearchParams(n_probes=4)
        p2 = ivf_flat.IvfFlatSearchParams(n_probes=7)
        ex.warmup_ragged(index, k=5, params=p1)
        assert ex.ragged_executables() == 1
        built = ex.stats.compile_count
        reqs = [(q[:7], 5, p1, 4), (q[7:10], 3, p2, 7), (q[10:], 8, p1, 4)]
        for _ in range(2):
            hs = [b.submit(index, blk, k, params=p)
                  for blk, k, p, _ in reqs]
            clock.advance(0.01)
            b.pump()
        assert ex.stats.compile_count == built
        assert ex.ragged_executables() == 1
        jex = JExecutor()
        for h, (blk, k, p, n_probes) in zip(hs, reqs):
            d, i = h.result(timeout=0)
            dd, ii = ex.search(index, blk, k, params=p)
            assert torch.equal(i, ii) and torch.equal(d, dd)
            jd, ji = jex.search(real_setup["jivf"], blk, k,
                                params=j_ivf.IvfFlatSearchParams(
                                    n_probes=n_probes))
            np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
            np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5)
        b.close()

    def test_pad_waste_collapses_vs_bucketed(self, real_setup):
        q, index = real_setup["q"], real_setup["ivf"]
        p = ivf_flat.IvfFlatSearchParams(n_probes=4)
        blocks = [q[:3], q[3:6], q[6:11], q[11:16]]     # 16 rows
        ex = SearchExecutor(CPU, ragged_tile=16)
        metrics.reset()
        ex.search_ragged(index, blocks, 5, params_list=p)
        derived = metrics.derived()
        assert derived["pad_waste_fraction"] == 0.0
        assert derived["pad_waste_by_class"] == {"p8.t16": 0.0}
        metrics.reset()
        for blk in blocks:              # bucketed: 3->8, 3->8, 5->8, 5->8
            ex.search(index, blk, 5, params=p)
        assert metrics.derived()["pad_waste_fraction"] == 0.5
        assert metrics.derived()["pad_waste_by_class"] == {}

    def test_cagra_packs_through_ragged_family(self, real_setup):
        q, index = real_setup["q"], real_setup["cg"]
        ex = SearchExecutor(CPU, ragged_tile=16)
        clock = ManualClock()
        b = DynamicBatcher(ex, BatcherConfig(max_wait_s=0.01, ragged=True),
                           clock=clock, start=False)
        p = cagra.CagraSearchParams(itopk_size=16, max_iterations=12)
        p2 = cagra.CagraSearchParams(itopk_size=16, max_iterations=10)
        assert ex.ragged_key(index, 4, params=p) == ex.ragged_key(
            index, 6, params=p2)
        h1 = b.submit(index, q[:5], 4, params=p)
        h2 = b.submit(index, q[5:9], 6, params=p2)
        clock.advance(0.01)
        assert b.pump() == 1
        assert ex.ragged_executables(family="cagra") == 1
        jex = JExecutor()
        for h, blk, k, pp, iters in ((h1, q[:5], 4, p, 12),
                                     (h2, q[5:9], 6, p2, 10)):
            d, i = h.result(timeout=0)
            dd, ii = ex.search(index, blk, k, params=pp)
            assert torch.equal(i, ii) and torch.equal(d, dd)
            _, ji = jex.search(real_setup["jcg"], blk, k,
                               params=j_cagra.CagraSearchParams(
                                   itopk_size=16, max_iterations=iters))
            np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        b.close()

    def test_2d_filter_slices_ride_the_split(self, real_setup):
        x, q, index = real_setup["x"], real_setup["q"], real_setup["ivf"]
        rng = np.random.default_rng(9)
        ex = SearchExecutor(CPU, ragged_tile=8)
        clock = ManualClock()
        b = DynamicBatcher(ex, BatcherConfig(max_wait_s=0.01, ragged=True),
                           clock=clock, start=False)
        p = ivf_flat.IvfFlatSearchParams(n_probes=8)
        bm = BitmapFilter.from_mask(rng.random((12, len(x))) < 0.5)
        h = b.submit(index, q[:12], 5, params=p, sample_filter=bm)
        clock.advance(0.01)
        assert b.pump() == 2              # 12 rows through an 8-row tile
        d, i = h.result(timeout=0)
        dd, ii = ex.search(index, q[:12], 5, params=p, sample_filter=bm)
        assert torch.equal(i, ii) and torch.equal(d, dd)
        b.close()

    def test_brute_force_stays_bucketed(self, real_setup):
        q = real_setup["q"]
        ex = SearchExecutor(CPU, ragged_tile=16)
        clock = ManualClock()
        b = DynamicBatcher(ex, BatcherConfig(max_wait_s=0.01, ragged=True),
                           clock=clock, start=False)
        h = b.submit(real_setup["bf"], q[:5], 4)
        clock.advance(0.01)
        assert b.pump() == 1
        assert ex.ragged_executables() == 0
        d, i = h.result(timeout=0)
        dd, ii = ex.search(real_setup["bf"], q[:5], 4)
        assert torch.equal(i, ii) and torch.equal(d, dd)
        b.close()
