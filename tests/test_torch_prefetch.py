"""The port's tier prefetcher against the JAX package's forecast, on the
CPU: ``forecast_plan`` equals the JAX package's on seeded windows; staged
rows hold the cold blocks, a hit promotes from them and a miss from the
cold tier, with the search still bit-identical to the all-device index;
rows of an older placement generation are cancelled, never served; the
capacity follows a memory ledger's headroom, a stage the ledger refuses
degrades to the reactive path, ``maintain`` evicts the least recently
staged rows; and only misses count into ``tier.promote_cold_bytes``.
The containers are split with numpy from a JAX-built, integer-valued
IVF-Flat index (``tiered.from_numpy``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from raft_tpu.neighbors import ivf_flat as j_ivf
from raft_tpu.serving import prefetch as j_prefetch
from raft_tpu_torch import Resources
from raft_tpu_torch.core import memwatch, tracing
from raft_tpu_torch.neighbors import ivf_flat, tiered
from raft_tpu_torch.serving.prefetch import (
    PrefetchConfig,
    TierPrefetcher,
    forecast_plan,
)

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

CPU = Resources(device="cpu")
N_LISTS, N, D = 16, 1600, 8
TP = tiered.TieredSearchParams(n_probes=4)


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(8)
    x = rng.integers(-4, 5, (N, D)).astype(np.float32)
    jidx = j_ivf.build(None, j_ivf.IvfFlatIndexParams(n_lists=N_LISTS), x)
    fields = dict(centers=np.array(jidx.centers), data=np.array(jidx.data),
                  indices=np.array(jidx.indices),
                  list_sizes=np.array(jidx.list_sizes))
    q = rng.integers(-4, 5, (30, D)).astype(np.float32)
    return fields, ivf_flat.from_numpy(**fields, res=CPU), q


def _tiered(fields):
    return tiered.from_numpy(fields, np.arange(8), np.arange(8, N_LISTS),
                             res=CPU)


def _window(hot_lists=(), cold_lists=(), heat=50):
    w = np.zeros(N_LISTS, np.int64)
    w[list(cold_lists)] = heat
    w[list(hot_lists)] = 1
    return w


@pytest.mark.parametrize("seed", range(6))
def test_forecast_plan_equals_the_jax_forecast(seed):
    rng = np.random.default_rng(seed)
    lists = rng.permutation(N_LISTS)
    hot, cold = np.sort(lists[:7]), np.sort(lists[7:])
    ewma = rng.random(N_LISTS) * rng.integers(0, 40)
    window = rng.integers(0, 30, N_LISTS) * (rng.random(N_LISTS) < 0.6)
    for kw in (dict(window=None), dict(window=window),
               dict(window=window, prior_weight=0.0, min_heat_ratio=1.0)):
        got = forecast_plan(ewma, hot, cold, max_swaps=4, **kw)
        want = j_prefetch.forecast_plan(ewma, hot, cold, max_swaps=4, **kw)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_stage_hits_misses_and_results(built):
    fields, flat, q = built
    t = _tiered(fields)
    want = ivf_flat.search(CPU, ivf_flat.IvfFlatSearchParams(n_probes=4),
                           flat, q, 10)
    pf = TierPrefetcher(t, width=4)
    assert pf.enabled and pf.capacity == 4
    assert pf.planes["hot_data"].shape == (4,) + tuple(t.hot_data.shape[1:])
    pf.observe(_window(cold_lists=[9, 12]))
    issued0 = tracing.get_counter("tier.prefetch.issued")
    assert pf.prefetch(max_swaps=4) == 2
    assert tracing.get_counter("tier.prefetch.issued") - issued0 == 2
    cold_map = t.cold_slot_map.tolist()
    for lid in (9, 12):
        row = pf._find_row_locked(lid, t.generation)
        assert torch.equal(pf.planes["hot_data"][row],
                           t.cold_data[cold_map[lid]])
    assert pf.prefetch(max_swaps=4) == 0          # already staged, fresh
    hits0 = tracing.get_counter("tier.prefetch.hits")
    misses0 = tracing.get_counter("tier.prefetch.misses")
    staged = pf.take([9, 12, 14], t.generation)
    assert list(staged.rows >= 0) == [True, True, False]
    assert tracing.get_counter("tier.prefetch.hits") - hits0 == 2
    assert tracing.get_counter("tier.prefetch.misses") - misses0 == 1
    cold0 = tracing.get_counter("tier.promote_cold_bytes")
    tiered.apply_plan(t, [9, 12, 14], [0, 1, 2], width=4, staged=staged)
    # only the miss crossed the host link at the epoch
    assert (tracing.get_counter("tier.promote_cold_bytes") - cold0
            == t.block_bytes)
    got = tiered.search(CPU, TP, t, q, 10)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert pf.snapshot()["staged"] == 0           # hits were consumed


def test_a_stale_generation_is_cancelled(built):
    fields, _, _ = built
    t = _tiered(fields)
    pf = TierPrefetcher(t, width=2)
    pf.observe(_window(cold_lists=[10, 11]))
    assert pf.prefetch(max_swaps=2) == 2
    tiered.apply_plan(t, [15], [0], width=2)      # another epoch moved first
    cancelled0 = tracing.get_counter("tier.prefetch.cancelled")
    assert pf.take([10, 11], t.generation) is None
    assert tracing.get_counter("tier.prefetch.cancelled") - cancelled0 == 2
    assert pf.snapshot()["staged"] == 0


def test_capacity_follows_the_ledger_headroom(built):
    fields, _, _ = built
    t = _tiered(fields)
    block = t.block_bytes
    ledger = memwatch.MemoryLedger(capacity_bytes=3 * block / 0.75 + 10)
    assert ledger.headroom_bytes() == pytest.approx(3 * block / 0.75 + 10)
    pf = TierPrefetcher(t, width=8, ledger=ledger)
    assert pf.capacity == 3
    pf.observe(_window(cold_lists=[8, 9]))
    assert pf.prefetch(max_swaps=8) == 2
    assert ledger.reserved_bytes() == 2 * block
    # an explicit capacity, clamped by the cold tier's size
    assert TierPrefetcher(t, width=4, config=PrefetchConfig(
        capacity=100)).capacity == t.n_cold
    assert not TierPrefetcher(t, width=0).enabled
    assert TierPrefetcher(t, width=0).take([8], 0) is None


def test_capacity_exceeded_degrades_to_the_reactive_path(built):
    fields, flat, q = built
    t = _tiered(fields)
    block = t.block_bytes
    ledger = memwatch.MemoryLedger(capacity_bytes=4 * block / 0.75)
    pf = TierPrefetcher(t, width=4, ledger=ledger)
    assert pf.capacity == 4
    ledger.capacity_bytes = 1.5 * block           # headroom shrank
    pf.observe(_window(cold_lists=[8, 9, 10]))
    cancelled0 = tracing.get_counter("tier.prefetch.cancelled")
    refused0 = tracing.get_counter(memwatch.GATE_REFUSED)
    assert pf.prefetch(max_swaps=4) == 1          # one fits, then refused
    assert tracing.get_counter(memwatch.GATE_REFUSED) - refused0 == 1
    assert tracing.get_counter("tier.prefetch.cancelled") - cancelled0 == 1
    assert ledger.reserved_bytes() == block
    staged = pf.take([8, 9, 10], t.generation)
    assert int((staged.rows >= 0).sum()) == 1
    tiered.apply_plan(t, [8, 9, 10], [0, 1, 2], width=4, staged=staged)
    want = ivf_flat.search(CPU, ivf_flat.IvfFlatSearchParams(n_probes=4),
                           flat, q, 10)
    got = tiered.search(CPU, TP, t, q, 10)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_maintain_evicts_the_least_recently_staged_rows(built):
    fields, _, _ = built
    t = _tiered(fields)
    block = t.block_bytes
    ledger = memwatch.MemoryLedger(capacity_bytes=100 * block)
    pf = TierPrefetcher(t, width=3, ledger=ledger)
    for lid in (8, 9, 10):                        # staged in this order
        assert pf.prefetch(max_swaps=1, window=_window(cold_lists=[lid])) \
            == 1
    assert pf.snapshot()["staged"] == 3
    assert pf.maintain() == 0                     # headroom holds them
    # the headroom already subtracts the hold: (headroom + active) x 0.75
    # is capacity x 0.75, room for one block
    ledger.capacity_bytes = 2 * block
    assert pf.maintain() == 2
    kept = {int(x) for x in pf._row_list if x >= 0}
    assert kept == {10}
    assert ledger.reserved_bytes() == block
