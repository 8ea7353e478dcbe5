"""The port's TierManager against the JAX package's placement, on the CPU.

The manager's window is the delta of a probe-accounting executor's
lifetime ledger: a read-only peek never advances it, a scraper claiming
device windows in between loses no probe, and racing ``epoch()`` calls
fold each window once. Its plans equal the JAX package's ``plan_epoch``
on the same windows, its pacing follows a ``ManualClock``, and its gauge
names and ``/tier.json`` keys equal those of a JAX ``TierManager`` over
the same container (the JAX manager reads attributes only). Searches
stay bit-identical to the all-device index across epochs, also while
epochs race searches through the executor on a tiered IVF-PQ index.
The JAX index is built once with integer-valued data and crosses into
the port with ``from_numpy``; the tiered containers are split with numpy
(the JAX package's own containers do not place their cold planes
under jax 0.9 on the CPU).
"""

from __future__ import annotations

import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core import tracing as j_tracing
from raft_tpu.distance.types import DistanceType as JD
from raft_tpu.neighbors import ivf_flat as j_ivf
from raft_tpu.neighbors import ivf_pq as j_pq
from raft_tpu.serving import placement as j_placement
from raft_tpu.serving import prefetch as j_prefetch
from raft_tpu_torch import Resources
from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.executor import SearchExecutor
from raft_tpu_torch.core.validation import RaftError
from raft_tpu_torch.neighbors import ivf_flat, ivf_pq, tiered
from raft_tpu_torch.ops.ivf_scan import probe_histogram
from raft_tpu_torch.serving.harness import ManualClock
from raft_tpu_torch.serving.placement import PlacementConfig, TierManager

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

CPU = Resources(device="cpu")
N_LISTS, N, D = 16, 2000, 16
SP = ivf_flat.IvfFlatSearchParams(n_probes=3)
TP = tiered.TieredSearchParams(n_probes=3)


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(21)
    x = rng.integers(-4, 5, (N, D)).astype(np.float32)
    jidx = j_ivf.build(None, j_ivf.IvfFlatIndexParams(n_lists=N_LISTS), x)
    fields = dict(centers=np.array(jidx.centers), data=np.array(jidx.data),
                  indices=np.array(jidx.indices),
                  list_sizes=np.array(jidx.list_sizes))
    return fields, ivf_flat.from_numpy(**fields, res=CPU)


def _tiered(fields):
    return tiered.from_numpy(fields, np.arange(8), np.arange(8, N_LISTS),
                             res=CPU)


def _cold_traffic(t, flat, n=40, seed=0):
    """Queries at the centers of two cold lists (integer-valued, so the
    executor's results equal the direct search's), and the window they
    probe, from the coarse stage on its own."""
    lists = [int(t.cold_lists[0]), int(t.cold_lists[3])]
    rng = np.random.default_rng(seed)
    c = flat.centers.numpy()[np.array(lists)[rng.integers(0, 2, n)]]
    q = np.round(c + rng.integers(-1, 2, c.shape)).astype(np.float32)
    probes = ivf_flat.coarse_probes(torch.from_numpy(q), flat.centers,
                                    flat.center_norms, flat.metric, 3,
                                    "exact")
    window = probe_histogram(probes, torch.zeros(N_LISTS, dtype=torch.int32))
    return q, window.numpy().astype(np.int64)


def _manager(t, ex, **kw):
    cfg = PlacementConfig(epoch_every_s=60.0, max_swaps_per_epoch=4,
                          min_heat_ratio=1.5, prefetch_lead_s=10.0)
    return TierManager(t, ex, config=cfg, clock=kw.pop("clock", None)
                       or ManualClock(), **kw)


def test_needs_a_probe_accounting_executor(built):
    fields, _ = built
    with pytest.raises(RaftError, match="probe-accounting"):
        TierManager(_tiered(fields), SearchExecutor(CPU))


def test_windows_are_ledger_deltas_and_a_peek_never_advances(built):
    fields, flat = built
    t = _tiered(fields)
    ex = SearchExecutor(CPU, probe_accounting=True)
    mgr = _manager(t, ex)
    q1, w1 = _cold_traffic(t, flat, seed=1)
    q2, w2 = _cold_traffic(t, flat, seed=2)
    ex.search(t, q1, 10, params=TP)
    for _ in range(2):
        with mgr._lock:
            np.testing.assert_array_equal(mgr._peek_window_locked(), w1)
    ex.probe_frequencies()            # a scraper's claim loses nothing
    plan = mgr.epoch()
    assert plan.window_total == int(w1.sum()) == 40 * 3
    ex.search(t, q2, 10, params=TP)
    ex.probe_frequencies()
    with mgr._lock:
        np.testing.assert_array_equal(mgr._peek_window_locked(), w2)
    assert mgr.epoch().window_total == int(w2.sum())
    assert mgr.epoch().window_total == 0          # nothing new


def test_plans_equal_jax_plan_epoch_and_results_hold(built):
    fields, flat = built
    t = _tiered(fields)
    ex = SearchExecutor(CPU, probe_accounting=True)
    mgr = _manager(t, ex)
    probe_q = np.asarray(np.random.default_rng(9).integers(-4, 5, (25, D)),
                         np.float32)
    want = ivf_flat.search(CPU, SP, flat, probe_q, 10)
    promoted = 0
    for epoch in range(4):
        q, window = _cold_traffic(t, flat, seed=10 + epoch)
        hot, cold = t.hot_lists.copy(), t.cold_lists.copy()
        ex.search(t, q, 10, params=TP)
        plan = mgr.epoch()
        ref = j_placement.plan_epoch(window, hot, cold, max_swaps=4,
                                     min_heat_ratio=1.5)
        assert dataclasses.astuple(plan) == dataclasses.astuple(ref)
        promoted += len(plan.promotions)
        assert set(plan.promotions) <= set(t.hot_lists)
        got = tiered.search(CPU, TP, t, probe_q, 10)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert promoted >= 2 and t.generation >= 1
    assert tracing.get_counter("tier.epochs") >= 4


def test_tick_paces_on_the_manual_clock(built):
    fields, flat = built
    t = _tiered(fields)
    ex = SearchExecutor(CPU, probe_accounting=True)
    clock = ManualClock()
    mgr = _manager(t, ex, clock=clock)
    assert mgr.tick() is None                     # the baseline
    clock.advance(59.0)
    assert mgr.tick() is None
    q, _ = _cold_traffic(t, flat)
    ex.search(t, q, 10, params=TP)
    clock.advance(1.0)
    plan = mgr.tick()
    assert plan is not None and plan.window_total == 120
    clock.advance(600.0)                          # ten periods: one epoch
    assert mgr.tick() is not None
    assert mgr.tick() is None
    assert mgr.snapshot()["epochs"] == 2


def test_lead_tick_prefetches_once_per_epoch_window(built):
    fields, flat = built
    t = _tiered(fields)
    ex = SearchExecutor(CPU, probe_accounting=True)
    clock = ManualClock()
    mgr = _manager(t, ex, clock=clock)
    pf = mgr.enable_prefetch()
    assert pf.capacity == 4
    mgr.tick()
    q, _ = _cold_traffic(t, flat)
    ex.search(t, q, 10, params=TP)
    issued0 = tracing.get_counter("tier.prefetch.issued")
    clock.advance(49.0)
    mgr.tick()                                    # before the lead
    assert tracing.get_counter("tier.prefetch.issued") == issued0
    clock.advance(2.0)
    mgr.tick()                                    # in the lead: stages
    issued = tracing.get_counter("tier.prefetch.issued") - issued0
    assert issued >= 1
    clock.advance(1.0)
    mgr.tick()                                    # spent for this window
    assert tracing.get_counter("tier.prefetch.issued") - issued0 == issued
    hits0 = tracing.get_counter("tier.prefetch.hits")
    clock.advance(10.0)
    plan = mgr.tick()
    assert plan is not None and len(plan.promotions) >= 1
    assert tracing.get_counter("tier.prefetch.hits") - hits0 >= 1


class _JaxSideExecutor:
    """What a JAX TierManager reads of an executor, with no traffic."""

    probe_accounting = True

    @staticmethod
    def probe_label(index):
        return None


def test_gauge_and_snapshot_names_equal_the_jax_ones(built):
    fields, _ = built
    t = _tiered(fields)
    ex = SearchExecutor(CPU, probe_accounting=True)
    mgr = _manager(t, ex)
    mgr.enable_prefetch()
    jmgr = j_placement.TierManager(
        t, _JaxSideExecutor(), config=j_placement.PlacementConfig())
    jmgr.enable_prefetch(config=j_prefetch.PrefetchConfig(capacity=0))
    tracing.reset_gauges("tier.")
    j_tracing.reset_gauges("tier.")
    mgr.epoch()
    mgr.publish_gauges()
    jmgr.publish_gauges()
    assert set(tracing.gauges("tier.")) == set(j_tracing.gauges("tier."))

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) else None
                for k, v in d.items()}

    snap, jsnap = mgr.snapshot(), jmgr.snapshot()
    assert snap["last_plan"] is not None and jsnap["last_plan"] is None
    jsnap["last_plan"] = snap["last_plan"]
    assert keys(snap) == keys(jsnap)
    assert snap["layout"] == jsnap["layout"]


def test_racing_epochs_fold_a_window_once(built):
    """Two threads call epoch() at once after one burst of traffic: one
    claims the whole window and the other an empty one (the manager's
    lock holds the claim and its plan together)."""
    fields, flat = built
    t = _tiered(fields)
    ex = SearchExecutor(CPU, probe_accounting=True)
    mgr = _manager(t, ex)
    q, window = _cold_traffic(t, flat)
    ex.search(t, q, 10, params=TP)
    go = threading.Barrier(2)
    plans = [None, None]

    def run(i):
        go.wait()
        plans[i] = mgr.epoch()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    totals = sorted(p.window_total for p in plans)
    assert totals == [0, int(window.sum())]
    assert mgr.snapshot()["epochs"] == 2


def _pq_pair():
    """An integer-valued JAX IVF-PQ index (identity rotation) and its port
    copy, all-device and tiered (half the lists cold)."""
    rng = np.random.default_rng(3)
    empty = j_pq.IvfPqIndex(
        centers=jnp.asarray(rng.integers(-6, 7, (8, 16)), jnp.float32),
        rotation=jnp.eye(16, dtype=jnp.float32),
        codebooks=jnp.asarray(rng.integers(-3, 4, (8, 256, 2)),
                              jnp.float32),
        codes=jnp.zeros((8, 0, 8), jnp.uint8),
        indices=jnp.full((8, 0), -1, jnp.int32),
        list_sizes=jnp.zeros((8,), jnp.int32),
        metric=JD.L2Expanded, codebook_kind=j_pq.CodebookKind.PER_SUBSPACE,
        pq_bits=8)
    ji = j_pq.extend(None, empty, rng.integers(-8, 9, (600, 16)).astype(
        np.float32))
    fields = {f: np.asarray(getattr(ji, f)) for f in (
        "centers", "rotation", "codebooks", "codes", "indices",
        "list_sizes")}
    fields.update(pq_bits=8)
    flat = ivf_pq.from_numpy(**fields, res=CPU)
    t = tiered.from_numpy_pq(fields, [0, 1, 2, 3], [4, 5, 6, 7], res=CPU)
    return flat, t


def test_epochs_racing_searches_serve_one_generation_each():
    """Epochs (apply_plan under the executor's lock, then the swap lock)
    race three threads searching a tiered IVF-PQ index through the
    executor: every result equals the all-device answer, which no
    placement generation changes, and the epochs did swap."""
    flat, t = _pq_pair()
    ex = SearchExecutor(CPU, probe_accounting=True)
    mgr = TierManager(t, ex, config=PlacementConfig(max_swaps_per_epoch=2,
                                                    min_heat_ratio=1.0))
    sp = ivf_pq.IvfPqSearchParams(n_probes=2, scan_engine="torch")
    rng = np.random.default_rng(5)
    c = flat.centers.numpy()
    blocks = []
    for i in range(6):
        lists = np.array([4, 5, 6, 7, 0, 1])[rng.integers(0, 6, 12)]
        blocks.append(np.round(c[lists] + rng.integers(-1, 2, (12, 16)))
                      .astype(np.float32))
    wants = [ivf_pq.search(CPU, sp, flat, b, 10) for b in blocks]
    errors, stop = [], threading.Event()

    def searcher(seed):
        r = np.random.default_rng(seed)
        try:
            for _ in range(25):
                i = int(r.integers(0, len(blocks)))
                got = ex.search(t, blocks[i], 10, params=sp)
                if not (torch.equal(got[1], wants[i][1])
                        and torch.equal(got[0], wants[i][0])):
                    errors.append(i)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    def epochs():
        while not stop.is_set():
            mgr.epoch()

    threads = [threading.Thread(target=searcher, args=(s,))
               for s in range(3)]
    placer = threading.Thread(target=epochs)
    placer.start()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    stop.set()
    placer.join()
    assert errors == []
    assert t.generation >= 1
    assert sorted(list(t.hot_lists) + list(t.cold_lists)) == list(range(8))
    for b, w in zip(blocks, wants):
        got = tiered.search_pq(CPU, sp, t, b, 10)
        assert torch.equal(got[1], w[1]) and torch.equal(got[0], w[0])


def test_dispatch_lock_covers_every_tiered_family():
    flat, t = _pq_pair()
    lock = SearchExecutor._dispatch_lock(t)
    assert lock is t._swap_lock
    assert isinstance(SearchExecutor._dispatch_lock(flat),
                      type(SearchExecutor._dispatch_lock(object())))
    # apply_plan with the executor takes its lock first: held elsewhere,
    # the swap waits
    ex = SearchExecutor(CPU)
    done = threading.Event()
    with ex._lock:
        th = threading.Thread(target=lambda: (tiered.apply_plan(
            t, [4], [0], width=1, executor=ex), done.set()))
        th.start()
        assert not done.wait(0.2)
        assert t.generation == 0
    th.join()
    assert done.is_set() and t.generation == 1
