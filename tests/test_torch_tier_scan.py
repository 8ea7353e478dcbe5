"""The port's tiered probe scan against the JAX package's engines on the
same split planes: ``xla`` and ``pallas`` (interpret mode).

The hot/cold split is made with numpy and handed to both packages as
plain arrays. Integer-valued data makes every product exact, so ids are
compared EXACTLY (smallest id first on the duplicate rows) and distances
to float32 rounding (rtol 1e-6). On the un-split planes the port's tiered
plain engine equals its all-device plain engine bit for bit, on Gaussian
data too: it scores the same blocks in the same op order.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core.bitset import Bitset as JBitset
from raft_tpu.distance.types import DistanceType as JD
from raft_tpu.neighbors import ivf_flat as j_ivf
from raft_tpu.ops import tier_scan as j_tier
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.validation import RaftError
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors import tiered as t_tiered
from raft_tpu_torch.ops import ivf_scan as t_scan
from raft_tpu_torch.ops import tier_scan as t_tier

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

N_LISTS, N, D, Q = 12, 900, 16, 21
METRICS = [DistanceType.L2Expanded, DistanceType.InnerProduct]


def _splits():
    lists = np.arange(N_LISTS)
    return {
        "alternate": (lists[::2], lists[1::2]),
        "one-cold": (lists[lists != 5], np.array([5])),
        "one-hot": (np.array([7]), lists[lists != 7]),
    }


SPLITS = _splits()


def _packed(x, seed, integer: bool):
    """A JAX-built IVF-Flat index's planes, queries and probes."""
    rng = np.random.default_rng(seed)
    idx = j_ivf.build(None, j_ivf.IvfFlatIndexParams(n_lists=N_LISTS), x)
    arrays = {name: np.array(getattr(idx, name)) for name in
              ("data", "data_norms", "indices")}
    q = (rng.integers(-4, 5, (Q, D)) if integer
         else rng.standard_normal((Q, D))).astype(np.float32)
    q[0] = x[3]
    probes = rng.integers(0, N_LISTS, (Q, 5)).astype(np.int32)
    probes[2, 3:] = N_LISTS      # sentinel (masked) probe slots
    probes[5, :] = N_LISTS       # a row that probes nothing
    probes[6, 1] = probes[6, 0]  # a repeated probe counts once
    probes[0, 0] = int(np.nonzero(arrays["indices"] == 3)[0][0])
    words = np.array(JBitset.from_mask(rng.random(N) < 0.7).words)
    return arrays, q, probes, words


@pytest.fixture(scope="module")
def int_planes():
    rng = np.random.default_rng(0)
    x = rng.integers(-4, 5, (N, D)).astype(np.float32)
    x[400] = x[3]                # exact duplicates of one row
    x[800] = x[3]
    return _packed(x, 0, integer=True)


@pytest.fixture(scope="module")
def gauss_planes():
    rng = np.random.default_rng(1)
    return _packed(rng.standard_normal((N, D)).astype(np.float32), 1,
                   integer=False)


def _split(arrays, split):
    hot_lists, cold_lists = SPLITS[split]
    hot_map, cold_map = t_tiered._slot_maps(hot_lists, cold_lists, N_LISTS)
    return (arrays["data"][hot_lists], arrays["data"][cold_lists], hot_map,
            cold_map)


def _port(arrays, split, q, probes, fw, k, metric, engine="torch"):
    hot, cold, hmap, cmap = _split(arrays, split)
    t = torch.from_numpy
    tw = None if fw is None else t(fw.view(np.int32))
    return t_tier.tiered_list_major_scan(
        t(q), t(hot), t(cold), t(hmap), t(cmap), t(arrays["data_norms"]),
        t(arrays["indices"]), t(probes), tw, k=k, metric=metric,
        engine=engine)


def _reference(arrays, split, q, probes, fw, k, metric, engine):
    hot, cold, hmap, cmap = _split(arrays, split)
    a = jnp.asarray
    return j_tier.tiered_list_major_scan(
        a(q), a(hot), a(cold), a(hmap), a(cmap), a(arrays["data_norms"]),
        a(arrays["indices"]), a(probes), None if fw is None else a(fw),
        k=k, metric=JD(int(metric)), engine=engine, interpret=True)


def _filter(words, kind):
    if kind == "none":
        return None
    if kind == "1d":
        return words
    return np.tile(words[None], (Q, 1))       # per-query (2-D) words


CASES = (
    [("xla", m, f, s) for m in METRICS for f in ("none", "1d", "2d")
     for s in SPLITS]
    + [("pallas", m, f, "alternate") for m in METRICS for f in ("none", "1d")]
    + [("pallas", DistanceType.L2Expanded, "none", s)
       for s in ("one-cold", "one-hot")])


@pytest.mark.parametrize("engine,metric,fkind,split", CASES,
                         ids=lambda v: getattr(v, "name", str(v)))
def test_plain_engine_matches_reference(int_planes, engine, metric, fkind,
                                        split):
    arrays, q, probes, words = int_planes
    fw = _filter(words, fkind)
    wd, wi = _reference(arrays, split, q, probes, fw, 10, metric, engine)
    gd, gi = _port(arrays, split, q, probes, fw, 10, metric)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-6, atol=0)
    assert (gi[5] == -1).all()             # probed nothing: all empty
    if fkind == "none":
        # the duplicates' list is probed by query 0: smallest id first
        assert gi[0, :3].tolist() == [3, 400, 800]


@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.name)
def test_plain_engine_equals_unsplit_scan(gauss_planes, metric, split, k):
    arrays, q, probes, words = gauss_planes
    t = torch.from_numpy
    for fw in (None, words):
        tw = None if fw is None else t(fw.view(np.int32))
        want = t_scan.list_major_scan(
            t(q), t(arrays["data"]), t(arrays["data_norms"]),
            t(arrays["indices"]), t(probes), tw, k=k, metric=metric,
            engine="torch")
        got = _port(arrays, split, q, probes, fw, k, metric)
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0], want[0])


def test_tier_fetch_plan_matches_reference():
    rng = np.random.default_rng(2)
    n_lists = 10
    hot_lists = np.array([1, 4, 5, 8])
    cold_lists = np.setdiff1d(np.arange(n_lists), hot_lists)
    hmap, cmap = t_tiered._slot_maps(hot_lists, cold_lists, n_lists)
    for uniq in (np.array([0, 2, 3, 4, 6, 9, 10, 10]),     # leading cold
                 np.sort(rng.choice(n_lists, 7, replace=False)),
                 np.array([10, 10, 10])):                   # all sentinel
        uniq = uniq.astype(np.int32)
        want = j_tier.tier_fetch_plan(jnp.asarray(uniq), jnp.asarray(hmap),
                                      jnp.asarray(cmap), n_lists)
        got = t_tier.tier_fetch_plan(torch.from_numpy(uniq),
                                     torch.from_numpy(hmap),
                                     torch.from_numpy(cmap), n_lists)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            assert np.array_equal(g.numpy(), np.asarray(w))


def test_slot_pair_and_block_select():
    hot = torch.arange(24.0).reshape(2, 3, 4)
    cold = -torch.arange(36.0).reshape(3, 3, 4)
    hmap, cmap = [1, -1, 0, -1, -1], [-1, 2, -1, 0, 1]
    for lid in range(5):
        hs, cs = t_tier.tier_slot_pair(hmap, cmap, lid)
        blk = t_tier.tier_block_select(hot, cold, hs, cs)
        assert torch.equal(blk, cold[cs] if cs >= 0 else hot[hs])


def test_resolve_tier_engine():
    hot = torch.zeros((2, 8, 4))
    r = t_tier.resolve_tier_engine
    assert r("auto", hot_data=hot) == "torch"
    assert r("torch", hot_data=hot) == "torch"
    assert r("cuda", hot_data=hot, k=10) == "cuda"
    words = Bitset.create(16).words
    assert r("cuda", hot_data=hot, filter_words=words) == "cuda"
    assert r("cuda", hot_data=hot,
             filter_words=words[None].expand(3, -1)) == "torch"
    assert r("cuda", hot_data=hot, k=129) == "torch"
    assert r("cuda", hot_data=hot.to(torch.bfloat16)) == "torch"
    with pytest.raises(RaftError, match="scan_engine"):
        r("pallas", hot_data=hot)


def test_kernel_wrapper_refuses_a_pageable_cold_tier(int_planes):
    """The CUDA engine never copies a pageable cold plane: it refuses it
    before anything is built or launched (the plain engine is what CPU
    tensors run)."""
    arrays, q, probes, _ = int_planes
    hot, cold, hmap, cmap = _split(arrays, "alternate")
    t = torch.from_numpy
    before = t_tier.tiered_list_major_scan.launches
    with pytest.raises(RaftError, match="pinned"):
        t_tier._tier_scan_cuda(
            t(q), t(hot), t(cold), t(hmap), t(cmap), t(arrays["data_norms"]),
            t(arrays["indices"]), t(probes), None, k=10,
            metric=DistanceType.L2Expanded)
    assert t_tier.tiered_list_major_scan.launches == before


# ---------------------------------------------------------------------------
# the staging plan of the kernel (host side)
# ---------------------------------------------------------------------------

STAGE_M = 300                    # padded list extent of the plan tests


def _stage_inputs(seed: int):
    """A union of 40 steps over 60 lists (some cold, sentinel steps at the
    end) and every list's real rows, up to the padded extent."""
    rng = np.random.default_rng(seed)
    n_lists = 60
    sizes = rng.integers(0, STAGE_M + 1, n_lists)
    sizes[:3] = [0, STAGE_M, 64]                   # empty, full, one tile
    cold_lists = np.sort(rng.choice(n_lists, 35, replace=False))
    hot_lists = np.setdiff1d(np.arange(n_lists), cold_lists)
    hmap, cmap = t_tiered._slot_maps(hot_lists, cold_lists, n_lists)
    uniq = np.full(40, n_lists, np.int32)
    uniq[:36] = np.sort(rng.choice(n_lists, 36, replace=False))
    return n_lists, sizes, hmap, cmap, uniq


def _cold_fetch(n_lists, cmap, uniq):
    live = uniq < n_lists
    return np.where(live, cmap[np.minimum(uniq, n_lists - 1)], -1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stage_plan_names_the_cold_steps_of_tier_fetch_plan(seed):
    """The plan stages exactly the steps the JAX package's
    ``tier_fetch_plan`` fetches from the cold tier, each once with its
    slot, longest first and, among lists of equal rows, in its cold order
    (``cold_seq``)."""
    n_lists, sizes, hmap, cmap, uniq = _stage_inputs(seed)
    _, cold_fetch, cold_seq = (np.asarray(a) for a in j_tier.tier_fetch_plan(
        jnp.asarray(uniq), jnp.asarray(hmap), jnp.asarray(cmap), n_lists))
    rows = sizes[np.minimum(uniq, n_lists - 1)]
    plan = t_tier.tier_stage_plan(_cold_fetch(n_lists, cmap, uniq), rows,
                                  STAGE_M, 10**9)
    named = np.nonzero(cold_fetch >= 0)[0]
    assert np.array_equal(np.sort(plan.steps), named)
    assert np.array_equal(plan.slots, cold_fetch[plan.steps])
    key = list(zip(-plan.rows.astype(np.int64), cold_seq[plan.steps]))
    assert key == sorted(key)
    # a ring that holds them all: one after the other, a few waves
    assert not plan.reuse and plan.ring_rows == int(plan.rows.sum())
    assert np.array_equal(plan.offsets, np.cumsum(plan.rows) - plan.rows)
    assert 1 < plan.n_waves <= 2 * t_tier.PIPELINE_WAVES


@pytest.mark.parametrize("seed", [0, 1])
def test_stage_plan_rows_are_real_rows_rounded_to_the_tile(seed):
    n_lists, sizes, _, cmap, uniq = _stage_inputs(seed)
    rows = sizes[np.minimum(uniq, n_lists - 1)]
    plan = t_tier.tier_stage_plan(_cold_fetch(n_lists, cmap, uniq), rows,
                                  STAGE_M, 10**9)
    real = rows[plan.steps]
    want = np.minimum(-(-real // t_tier.STAGE_TILE) * t_tier.STAGE_TILE,
                      STAGE_M)
    assert np.array_equal(plan.rows, want)
    assert (plan.rows >= real).all() and (plan.rows <= STAGE_M).all()
    assert ((plan.rows % t_tier.STAGE_TILE == 0)
            | (plan.rows == STAGE_M)).all()


@pytest.mark.parametrize("groups", [2, 3, 5, 11, "all"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stage_plan_waves_cover_each_cold_list_once(seed, groups):
    """For rings from two lists up to the whole probed cold set: every
    staged list lies in exactly one wave; a ring smaller than the set
    takes wave w in half w % 2, and staging the waves in turn into it
    (each wave over what the wave two before left) reads every list of a
    wave back intact."""
    n_lists, sizes, _, cmap, uniq = _stage_inputs(seed)
    rows = sizes[np.minimum(uniq, n_lists - 1)]
    fetch = _cold_fetch(n_lists, cmap, uniq)
    whole = t_tier.tier_stage_plan(fetch, rows, STAGE_M, 10**9)
    biggest = int(whole.rows.max())
    cap = (int(whole.rows.sum()) if groups == "all"
           else groups * biggest)
    plan = t_tier.tier_stage_plan(fetch, rows, STAGE_M, cap)
    assert np.array_equal(plan.steps, whole.steps)
    assert np.array_equal(plan.rows, whole.rows)
    assert plan.wave_end[-1] == len(plan.steps)
    assert (np.diff(plan.wave_end) > 0).all()
    assert plan.ring_rows <= max(cap, 2 * biggest)
    assert plan.reuse == (groups != "all")
    assert plan.n_waves > 1
    # the cold plane's blocks carry their slot and row in every value
    rng_vals = np.arange(STAGE_M, dtype=np.float32)
    ring = np.full((plan.ring_rows, 1), np.nan, np.float32)
    begin = 0
    half = plan.ring_rows // 2
    for w, end in enumerate(plan.wave_end.tolist()):
        for i in range(begin, end):
            o, r = int(plan.offsets[i]), int(plan.rows[i])
            if plan.reuse:
                assert w % 2 * half <= o and o + r <= (w % 2 + 1) * half
            assert 0 <= o and o + r <= plan.ring_rows
            ring[o:o + r, 0] = 1000 * plan.slots[i] + rng_vals[:r]
        for i in range(begin, end):
            o, r = int(plan.offsets[i]), int(plan.rows[i])
            assert np.array_equal(ring[o:o + r, 0],
                                  1000 * plan.slots[i] + rng_vals[:r])
        begin = end


def test_stage_plan_without_cold_steps():
    plan = t_tier.tier_stage_plan(np.array([-1, -1, -1]),
                                  np.array([5, 64, 0]), 100, 10**6)
    assert plan.n_waves == 0 and plan.ring_rows == 0 and not plan.reuse
    assert len(plan.steps) == len(plan.rows) == 0


def test_live_rows_end_at_the_last_live_id():
    ids = torch.tensor([[3, 4, -1, 7, -1, -1],      # a filtered hole
                        [-1, -1, -1, -1, -1, -1],   # empty (or all filtered)
                        [1, 2, 3, 4, 5, 6]], dtype=torch.int32)
    assert t_scan.live_rows(ids).tolist() == [4, 0, 6]
