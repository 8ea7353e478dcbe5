"""Tiered IVF-Flat storage in the port against the all-device index and the
JAX package, on the CPU.

The JAX package builds the index; its arrays cross into the port with
``ivf_flat.from_numpy`` and, split with numpy, with ``tiered.from_numpy``.
The tiered search equals the port's own ``ivf_flat.search`` bit for bit
(same coarse stage, same blocks, same op order), before and after a
placement epoch; on integer-valued data its ids equal the JAX package's
``ivf_flat.search`` exactly and its distances to float32 rounding (rtol
1e-6). The split helpers (``_slot_maps``, ``_split_lists``,
``resolve_hot_slots``) equal the JAX package's on the same inputs.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from raft_tpu.core import memwatch as j_memwatch
from raft_tpu.distance.types import DistanceType as JD
from raft_tpu.neighbors import ivf_flat as j_ivf
from raft_tpu.neighbors import tiered as j_tiered
from raft_tpu_torch import Resources
from raft_tpu_torch.core import memwatch, tracing
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.validation import RaftError
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors import ivf_flat, tiered
from raft_tpu_torch.ops.ivf_scan import probe_histogram
from raft_tpu_torch.serving.placement import plan_epoch

N_LISTS, N, D = 16, 2000, 16
RES = Resources(device="cpu")
METRICS = [DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
           DistanceType.InnerProduct]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    x = rng.integers(-4, 5, (N, D)).astype(np.float32)
    q = rng.integers(-4, 5, (40, D)).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def jax_indexes(data):
    x, _ = data
    return {m: j_ivf.build(None, j_ivf.IvfFlatIndexParams(
        n_lists=N_LISTS, metric=JD(int(m))), x) for m in METRICS}


def _fields(jidx):
    return dict(centers=np.array(jidx.centers), data=np.array(jidx.data),
                indices=np.array(jidx.indices),
                list_sizes=np.array(jidx.list_sizes),
                metric=DistanceType(int(jidx.metric)))


SPLITS = {
    "alternate": (np.arange(0, N_LISTS, 2), np.arange(1, N_LISTS, 2)),
    "one-cold": (np.arange(1, N_LISTS), np.array([0])),
    "one-hot": (np.array([3]), np.delete(np.arange(N_LISTS), 3)),
}


def _pair(jidx, split):
    hot_lists, cold_lists = SPLITS[split]
    fields = _fields(jidx)
    return (ivf_flat.from_numpy(**fields, res=RES),
            tiered.from_numpy(fields, hot_lists, cold_lists, res=RES))


def _equal(a, b):
    assert torch.equal(a[1], b[1])
    assert torch.equal(a[0], b[0])


@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.name)
def test_search_equals_ivf_flat_and_reference(data, jax_indexes, metric,
                                              split):
    _, q = data
    jidx = jax_indexes[metric]
    flat, t = _pair(jidx, split)
    assert not t.host_resident and t.n_hot == len(SPLITS[split][0])
    want = ivf_flat.search(RES, ivf_flat.IvfFlatSearchParams(n_probes=5),
                           flat, q, 10)
    got = tiered.search(RES, tiered.TieredSearchParams(n_probes=5), t, q, 10)
    _equal(got, want)
    jd, ji = j_ivf.search(None, j_ivf.IvfFlatSearchParams(n_probes=5), jidx,
                          q, 10)
    assert np.array_equal(got[1].numpy(), np.asarray(ji))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)


def test_filters_through_cold_blocks(data, jax_indexes):
    _, q = data
    flat, t = _pair(jax_indexes[DistanceType.L2Expanded], "alternate")
    rng = np.random.default_rng(6)
    shared = Bitset.from_mask(rng.random(N) < 0.6)
    per_row = torch.from_numpy(np.stack([
        np.asarray(Bitset.from_mask(rng.random(N) < 0.6).words)
        for _ in range(q.shape[0])]))
    for flt in (shared, per_row):
        for query_tile in (4096, 16):           # one tile, then three
            want = ivf_flat.search(RES, ivf_flat.IvfFlatSearchParams(
                n_probes=6), flat, q, 10, sample_filter=flt,
                query_tile=query_tile)
            got = tiered.search(RES, tiered.TieredSearchParams(n_probes=6),
                                t, q, 10, sample_filter=flt,
                                query_tile=query_tile)
            _equal(got, want)


def test_placement_epoch_moves_hot_traffic_and_keeps_results(data,
                                                            jax_indexes):
    """Traffic at the centers of two cold lists: the window puts them on
    top, the epoch promotes both, the swap counts 2 x n x block bytes and
    the searches stay bit-identical, to the JAX package's ids too."""
    _, q = data
    jidx = jax_indexes[DistanceType.L2Expanded]
    flat, t = _pair(jidx, "alternate")
    targets = [int(t.cold_lists[1]), int(t.cold_lists[4])]
    traffic = flat.centers[targets].repeat(20, 1)
    window = torch.zeros(N_LISTS, dtype=torch.int32)
    fn, arrays, static = tiered.serving_plan(
        tiered.TieredSearchParams(n_probes=1, scan_engine="torch"), t, 10)
    _, _, window = fn(traffic, *arrays, None, window, **static)
    assert int(window.sum()) == traffic.shape[0]
    plan = plan_epoch(window.numpy(), t.hot_lists, t.cold_lists,
                      max_swaps=4)
    assert sorted(plan.promotions) == sorted(targets)
    before = tracing.counters("tier.")
    moved = tiered.apply_plan(t, plan.promotions, plan.demotions, width=4)
    after = tracing.counters("tier.")
    assert moved == 2 * 2 * t.block_bytes
    assert after["tier.swaps"] - before.get("tier.swaps", 0.0) == 2
    assert (after["tier.swap_bytes"] - before.get("tier.swap_bytes", 0.0)
            == moved)
    assert (after["tier.promote_cold_bytes"]
            - before.get("tier.promote_cold_bytes", 0.0)
            == 2 * t.block_bytes)
    assert set(targets) <= set(t.hot_lists.tolist())
    assert t.generation == 1
    lay = t.layout()
    assert sorted(lay["hot_lists"] + lay["cold_lists"]) == list(
        range(N_LISTS))
    # every list's block sits where the new maps say
    for lid in range(N_LISTS):
        hs, cs = int(t.hot_slot_map[lid]), int(t.cold_slot_map[lid])
        blk = t.cold_data[cs] if cs >= 0 else t.hot_data[hs]
        assert (hs >= 0) != (cs >= 0)
        assert torch.equal(blk, flat.data[lid])
    sp = tiered.TieredSearchParams(n_probes=5)
    got = tiered.search(RES, sp, t, q, 10)
    _equal(got, ivf_flat.search(RES, ivf_flat.IvfFlatSearchParams(
        n_probes=5), flat, q, 10))
    _, ji = j_ivf.search(None, j_ivf.IvfFlatSearchParams(n_probes=5), jidx,
                         q, 10)
    assert np.array_equal(got[1].numpy(), np.asarray(ji))


def test_staged_promotions_count_only_misses(jax_indexes):
    flat, t = _pair(jax_indexes[DistanceType.L2Expanded], "alternate")
    promo = [int(t.cold_lists[0]), int(t.cold_lists[2])]
    demo = [int(t.hot_lists[0]), int(t.hot_lists[1])]
    staged = types.SimpleNamespace(
        rows=[0, -1], planes={"hot_data": flat.data[promo[:1]].clone()})
    before = tracing.get_counter("tier.promote_cold_bytes")
    tiered.apply_plan(t, promo, demo, width=2, staged=staged)
    assert (tracing.get_counter("tier.promote_cold_bytes") - before
            == t.block_bytes)
    for lid in promo:
        assert torch.equal(t.hot_data[int(t.hot_slot_map[lid])],
                           flat.data[lid])


def test_apply_plan_rejects_bad_plans_and_empty_is_a_noop(jax_indexes):
    _, t = _pair(jax_indexes[DistanceType.L2Expanded], "alternate")
    hot0, cold0 = int(t.hot_lists[0]), int(t.cold_lists[0])
    snapshot = (t.hot_data.clone(), t.cold_data.clone(),
                t.hot_slot_map.clone(), t.generation)
    for promo, demo, msg in (([hot0], [hot0], "currently-cold"),
                             ([cold0], [cold0], "currently-hot"),
                             ([cold0], [], "pair up")):
        with pytest.raises(RaftError, match=msg):
            tiered.apply_plan(t, promo, demo, width=4)
    with pytest.raises(RaftError, match="width"):
        tiered.apply_plan(t, list(t.cold_lists[:3]), list(t.hot_lists[:3]),
                          width=2)
    before = tracing.counters("tier.")
    assert tiered.apply_plan(t, [], [], width=4) == 0
    assert tracing.counters("tier.") == before
    assert torch.equal(t.hot_data, snapshot[0])
    assert torch.equal(t.cold_data, snapshot[1])
    assert torch.equal(t.hot_slot_map, snapshot[2])
    assert t.generation == snapshot[3]


def test_slot_maps_and_split_lists_match_reference():
    rng = np.random.default_rng(7)
    counts = rng.integers(0, 4, N_LISTS)        # many ties
    for h in (1, 5, N_LISTS - 1):
        for pc in (None, counts):
            want = j_tiered._split_lists(N_LISTS, h, pc)
            got = tiered._split_lists(N_LISTS, h, pc)
            for g, w in zip(got, want):
                assert np.array_equal(g, w) and g.dtype == w.dtype
            for g, w in zip(tiered._slot_maps(*got, N_LISTS),
                            j_tiered._slot_maps(*want, N_LISTS)):
                assert np.array_equal(g, w) and g.dtype == w.dtype


def test_resolve_hot_slots_matches_reference(jax_indexes):
    jidx = jax_indexes[DistanceType.L2Expanded]
    pidx = ivf_flat.from_numpy(**_fields(jidx), res=RES)
    block = jidx.max_list_size * D * 4
    cases = [dict(), dict(hot_slots=3), dict(hot_slots=0),
             dict(hot_slots=99), dict(hot_fraction=0.25),
             dict(block_bytes=block // 2, hot_fraction=0.9)]
    for cap in (0, 3.5 * block, 40 * block):
        cases.append(dict(capacity=cap))
        cases.append(dict(capacity=cap, safety_fraction=0.5))
    for case in cases:
        kw = dict(case)
        cap = kw.pop("capacity", None)
        jl = pl = None
        if cap is not None:
            jl = j_memwatch.MemoryLedger(capacity_bytes=cap)
            pl = memwatch.MemoryLedger(capacity_bytes=cap)
        want = j_tiered.resolve_hot_slots(jidx, ledger=jl, **kw)
        got = tiered.resolve_hot_slots(pidx, ledger=pl, **kw)
        assert got == want, case


def test_build_tiered_on_the_cpu(jax_indexes):
    flat = ivf_flat.from_numpy(
        **_fields(jax_indexes[DistanceType.L2Expanded]), res=RES)
    counts = np.zeros(N_LISTS, np.int64)
    counts[[3, 9, 12]] = [5, 7, 7]
    t = tiered.build_tiered(flat, hot_slots=3, probe_counts=counts)
    assert t.hot_lists.tolist() == [3, 9, 12]
    assert t.block_bytes == flat.max_list_size * D * 4
    assert (t.hot_bytes, t.cold_bytes) == (3 * t.block_bytes,
                                           13 * t.block_bytes)
    # a CPU index keeps one pool: the cold tier is not pinned, and the
    # memory model counts it with the device tensors
    cold, resident = tiered.host_put(flat.data)
    assert cold is flat.data and resident is False
    model = memwatch.index_memory_model(t)
    assert model["components"]["cold_data"]["tier"] == "device"
    assert model["host_resident_bytes"] == (t.hot_lists.nbytes
                                            + t.cold_lists.nbytes)
    fields = _fields(jax_indexes[DistanceType.L2Expanded])
    fields["data"] = fields["data"].astype(np.float16)
    with pytest.raises(RaftError, match="f32"):
        tiered.build_tiered(ivf_flat.from_numpy(**fields, res=RES))


def test_capacity_gate_refuses_the_hot_tier(jax_indexes):
    flat = ivf_flat.from_numpy(
        **_fields(jax_indexes[DistanceType.L2Expanded]), res=RES)
    ledger = memwatch.MemoryLedger(capacity_bytes=flat.max_list_size * D * 4)
    memwatch.install_gate(ledger)
    try:
        with pytest.raises(memwatch.CapacityExceeded):
            tiered.build_tiered(flat, hot_slots=4)
        assert tiered.build_tiered(flat, hot_slots=1).n_hot == 1
    finally:
        memwatch.remove_gate()


def test_probe_histogram_window_of_the_serving_body(data, jax_indexes):
    _, q = data
    flat, t = _pair(jax_indexes[DistanceType.L2Expanded], "alternate")
    fn, arrays, static = tiered.serving_plan(
        tiered.TieredSearchParams(n_probes=4, scan_engine="torch"), t, 10)
    counts = torch.zeros(N_LISTS, dtype=torch.int32)
    *_, counts = fn(torch.from_numpy(q), *arrays, None, counts, n_valid=30,
                    **static)
    probes = ivf_flat.coarse_probes(torch.from_numpy(q[:30]), flat.centers,
                                    flat.center_norms, flat.metric, 4,
                                    "exact")
    want = probe_histogram(probes, torch.zeros(N_LISTS, dtype=torch.int32))
    assert torch.equal(counts, want) and int(counts.sum()) == 120


def test_concurrent_epochs_and_searches(data, jax_indexes):
    """Six threads search while the main thread runs 30 placement epochs
    (a short switch interval forces interleaving): every search equals
    the all-device index's, since a search holds the swap lock from its
    snapshot through its scan and the epochs update the tiers in place."""
    import sys
    import threading

    _, q = data
    flat, t = _pair(jax_indexes[DistanceType.L2Expanded], "alternate")
    sp = tiered.TieredSearchParams(n_probes=5)
    want = ivf_flat.search(RES, ivf_flat.IvfFlatSearchParams(n_probes=5),
                           flat, q, 10)
    bad, done = [], threading.Event()

    def searcher():
        while not done.is_set():
            d, i = tiered.search(RES, sp, t, q, 10)
            if not (torch.equal(d, want[0]) and torch.equal(i, want[1])):
                bad.append(t.generation)

    rng = np.random.default_rng(8)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=searcher) for _ in range(6)]
    try:
        for th in threads:
            th.start()
        for _ in range(30):
            n = int(rng.integers(1, 4))
            tiered.apply_plan(t, rng.choice(t.cold_lists, n, replace=False),
                              rng.choice(t.hot_lists, n, replace=False),
                              width=4)
    finally:
        done.set()
        for th in threads:
            th.join(timeout=60)
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not bad and t.generation == 30
