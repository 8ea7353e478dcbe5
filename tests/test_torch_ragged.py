"""The port's ragged plan family (``SearchExecutor.search_ragged`` and its
keys) on the CPU, against the JAX package's executor and against the
port's own bucketed path.

The JAX package builds each index on integer-valued data and saves it;
the port loads the bytes (as ``tests/test_torch_executor.py`` does), so
every product is exact. The same seeded blocks, with mixed ``n_probes``
(CAGRA: ``max_iterations``) and ``k`` inside one params class, go through
the JAX ``search_ragged`` and the port's: ids must be equal, distances
agree to rtol 1e-5 / atol 1e-4 x scale (the JAX ``xla`` engine is not
bit-stable across jitted shapes, so its bits are no target). Against the
port's bucketed ``search`` of each block alone the packed results are bit
for bit. The tiered container is split from the loaded IVF-Flat index and
held to the JAX IVF-Flat results (a tiered search equals the all-device
one). Mirrors ``tests/test_executor.py``'s ``TestRaggedPlans``,
``TestRaggedFamilies`` and ``TestRaggedDualTile``.
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

from raft_tpu import SearchExecutor as JExecutor
from raft_tpu.neighbors import brute_force as j_bf
from raft_tpu.neighbors import cagra as j_cagra
from raft_tpu.neighbors import ivf_bq as j_bq
from raft_tpu.neighbors import ivf_flat as j_ivf
from raft_tpu.neighbors import ivf_pq as j_pq
from raft_tpu_torch import Resources, SearchExecutor
from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.validation import RaftError
from raft_tpu_torch.neighbors import brute_force, cagra, ivf_bq, ivf_flat
from raft_tpu_torch.neighbors import ivf_pq, tiered
from raft_tpu_torch.neighbors.filters import BitmapFilter, BitsetFilter
from raft_tpu_torch.serving import metrics

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

CPU = Resources(device="cpu")
N, D, N_LISTS = 600, 16, 16
FAMILIES = ("ivf_flat", "ivf_bq", "cagra", "tiered", "ivf_pq")
# one params class each: n_probes 2..8 -> class 8; k 3..8 -> class 8;
# CAGRA max_iterations 9..16 -> class 16
SIZES = (3, 2, 4, 1, 6)
KS = (3, 7, 5, 8, 4)
BUDGETS = {"ivf_flat": (5, 8, 2, 7, 3), "ivf_bq": (5, 8, 2, 7, 3),
           "ivf_pq": (5, 8, 2, 7, 3),
           "tiered": (5, 8, 2, 7, 3), "cagra": (9, 12, 16, 10, 11)}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(17)
    centers = rng.integers(-5, 6, (12, D))
    x = centers[rng.integers(0, 12, N)] + rng.integers(-2, 3, (N, D))
    q = centers[rng.integers(0, 12, 64)] + rng.integers(-2, 3, (64, D))
    return x.astype(np.float32), q.astype(np.float32)


def _carry(j_mod, t_mod, jidx):
    buf = io.BytesIO()
    j_mod.save(jidx, buf)
    buf.seek(0)
    return t_mod.load(CPU, buf)


def _jax_pq(x):
    """A JAX IVF-PQ index with its centers and codebooks rounded to
    integers before the rows are added: every ADC sum is exact."""
    import dataclasses

    import jax.numpy as jnp

    empty = j_pq.build(None, j_pq.IvfPqIndexParams(
        n_lists=N_LISTS, pq_dim=8, add_data_on_build=False), x)
    empty = dataclasses.replace(empty, centers=jnp.round(empty.centers),
                                codebooks=jnp.round(empty.codebooks))
    return j_pq.extend(None, empty, x)


@pytest.fixture(scope="module")
def indexes(data):
    """{family: (JAX index, port index)}; tiered pairs the JAX IVF-Flat
    index with the port's container split from the loaded copy."""
    x, _ = data
    ji = j_ivf.build(None, j_ivf.IvfFlatIndexParams(n_lists=N_LISTS), x)
    jq = j_bq.build(None, j_bq.IvfBqIndexParams(n_lists=N_LISTS), x)
    jc = j_cagra.build(None, j_cagra.CagraIndexParams(
        graph_degree=8, intermediate_graph_degree=16,
        build_algo=j_cagra.BuildAlgo.NN_DESCENT), x)
    ti = _carry(j_ivf, ivf_flat, ji)
    jp = _jax_pq(x)
    return {
        "ivf_pq": (jp, _carry(j_pq, ivf_pq, jp)),
        "ivf_flat": (ji, ti),
        "ivf_bq": (jq, _carry(j_bq, ivf_bq, jq)),
        "cagra": (jc, _carry(j_cagra, cagra, jc)),
        "tiered": (ji, tiered.build_tiered(ti, hot_fraction=0.5)),
        "brute_force": (None, brute_force.build(CPU, x)),
    }


def _params(name, budget, **kw):
    """(JAX params, port params) of one request."""
    if name == "ivf_flat":
        return (j_ivf.IvfFlatSearchParams(n_probes=budget,
                                          scan_engine="xla"),
                ivf_flat.IvfFlatSearchParams(n_probes=budget, **kw))
    if name == "tiered":
        return (j_ivf.IvfFlatSearchParams(n_probes=budget,
                                          scan_engine="xla"),
                tiered.TieredSearchParams(n_probes=budget, **kw))
    if name == "ivf_bq":
        return (j_bq.IvfBqSearchParams(n_probes=budget, scan_engine="xla"),
                ivf_bq.IvfBqSearchParams(n_probes=budget, **kw))
    if name == "ivf_pq":
        kw.setdefault("scan_engine", "torch")
        return (j_pq.IvfPqSearchParams(n_probes=budget, scan_engine="xla"),
                ivf_pq.IvfPqSearchParams(n_probes=budget, **kw))
    return (j_cagra.CagraSearchParams(itopk_size=16, max_iterations=budget,
                                      algo="xla"),
            cagra.CagraSearchParams(itopk_size=16, max_iterations=budget,
                                    **kw))


def _blocks(q, sizes=SIZES):
    out, at = [], 0
    for m in sizes:
        out.append(q[at:at + m])
        at += m
    return out


def _bitwise(got, want):
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


def _close_to_jax(got, want):
    wd, wi = np.asarray(want[0]), np.asarray(want[1])
    np.testing.assert_array_equal(got[1].numpy(), wi)
    scale = max(1.0, float(np.abs(wd[np.isfinite(wd)]).max(initial=0.0)))
    np.testing.assert_allclose(got[0].numpy(), wd, rtol=1e-5,
                               atol=1e-4 * scale)


class TestRaggedPlans:
    """One plan entry per (index, params class, tile) serves every load
    shape, each block equal to its solo bucketed search."""

    @pytest.mark.parametrize("name", FAMILIES)
    def test_packed_equals_bucketed_and_jax(self, data, indexes, name):
        _, q = data
        jidx, tidx = indexes[name]
        pairs = [_params(name, b) for b in BUDGETS[name]]
        blocks = _blocks(q)
        ex = SearchExecutor(CPU, ragged_tile=16)
        keys = {ex.ragged_key(tidx, k, params=p)
                for k, (_, p) in zip(KS, pairs)}
        assert len(keys) == 1 and None not in keys
        got = ex.search_ragged(tidx, blocks, list(KS),
                               params_list=[p for _, p in pairs])
        want = JExecutor(ragged_tile=16).search_ragged(
            jidx, blocks, list(KS), params_list=[p for p, _ in pairs])
        assert ex.ragged_executables() == 1
        for b, k, (_, p), g, w in zip(blocks, KS, pairs, got, want):
            assert g[1].shape == (b.shape[0], k)
            _bitwise(g, ex.search(tidx, b, k, params=p))
            _close_to_jax(g, w)

    @pytest.mark.parametrize("engine", ["cuda", "torch"])
    def test_both_scan_engines(self, data, indexes, engine):
        """The ``cuda`` engine's plain version on CPU tensors and the
        ``torch`` engine pack alike."""
        _, q = data
        _, tidx = indexes["ivf_flat"]
        blocks = _blocks(q)
        ps = [ivf_flat.IvfFlatSearchParams(n_probes=b, scan_engine=engine)
              for b in BUDGETS["ivf_flat"]]
        ex = SearchExecutor(CPU, ragged_tile=16)
        for b, k, p, g in zip(blocks, KS, ps, ex.search_ragged(
                tidx, blocks, list(KS), params_list=ps)):
            _bitwise(g, ex.search(tidx, b, k, params=p))

    def test_single_request_batch(self, data, indexes):
        _, q = data
        _, tidx = indexes["ivf_flat"]
        p = ivf_flat.IvfFlatSearchParams(n_probes=5)
        ex = SearchExecutor(CPU, ragged_tile=16)
        (got,) = ex.search_ragged(tidx, [q[:5]], 4, params_list=p)
        assert got[0].shape == (5, 4)
        _bitwise(got, ex.search(tidx, q[:5], 4, params=p))

    def test_one_entry_serves_every_load_shape(self, data, indexes):
        """warmup_ragged builds the one entry; mixed load shapes build
        nothing more."""
        _, q = data
        _, tidx = indexes["ivf_flat"]
        p = ivf_flat.IvfFlatSearchParams(n_probes=6)
        ex = SearchExecutor(CPU, ragged_tile=16)
        secs = ex.warmup_ragged(tidx, k=8, params=p)
        assert secs > 0 and ex.stats.compile_count == 1
        assert ex.ragged_executables() == 1
        base = tracing.get_counter("serving.compile_count")
        for sizes in [(1,), (3, 2), (5, 7, 4), (16,), (2, 2, 2), (9, 9)]:
            ex.search_ragged(tidx, _blocks(q, sizes), 8, params_list=p)
        assert ex.stats.compile_count == 1
        assert tracing.get_counter("serving.compile_count") == base
        assert ex.ragged_executables() == 1
        (info,) = ex.executable_costs().values()
        assert info["family"] == "ivf_flat_ragged" and info["bucket"] == 16
        assert info["k"] == 8

    def test_distinct_params_class_distinct_key(self, indexes):
        _, tidx = indexes["ivf_flat"]
        ex = SearchExecutor(CPU, ragged_tile=16)
        p_small = ivf_flat.IvfFlatSearchParams(n_probes=5)
        p_big = ivf_flat.IvfFlatSearchParams(n_probes=16)
        k1 = ex.ragged_key(tidx, 4, params=p_small)
        assert k1 != ex.ragged_key(tidx, 4, params=p_big)   # np 8 vs 16
        assert k1 != ex.ragged_key(tidx, 40, params=p_small)  # k 8 vs 64
        # n_probes past the list count clamps: class 16 = n_lists
        assert (ex.ragged_key(tidx, 4, params=p_big) == ex.ragged_key(
            tidx, 4, params=ivf_flat.IvfFlatSearchParams(n_probes=99)))

    def test_non_class_params_never_share_a_key(self, indexes):
        """Only the budget and k round into the class: a request that
        differs in any other static (CAGRA's itopk, IVF-BQ's epsilon)
        gets its own key, so no packed call serves it with another's
        params."""
        _, cg = indexes["cagra"]
        _, bq = indexes["ivf_bq"]
        ex = SearchExecutor(CPU)
        assert (ex.ragged_key(cg, 4, params=cagra.CagraSearchParams(
            itopk_size=16)) != ex.ragged_key(
            cg, 4, params=cagra.CagraSearchParams(itopk_size=32)))
        assert (ex.ragged_key(bq, 4, params=ivf_bq.IvfBqSearchParams(
            epsilon=3.0)) != ex.ragged_key(
            bq, 4, params=ivf_bq.IvfBqSearchParams(epsilon=2.0)))
        with pytest.raises(RaftError, match="params class"):
            ex.search_ragged(bq, [np.zeros((1, D), np.float32)] * 2, 4,
                             params_list=[
                                 ivf_bq.IvfBqSearchParams(epsilon=3.0),
                                 ivf_bq.IvfBqSearchParams(epsilon=2.0)])

    def test_tile_overflow_streams_chunks(self, data, indexes):
        """Totals past one tile stream through the same entry."""
        _, q = data
        _, tidx = indexes["ivf_flat"]
        p = ivf_flat.IvfFlatSearchParams(n_probes=5)
        ex = SearchExecutor(CPU, ragged_tile=8)
        blocks = _blocks(q, (6, 7, 9))          # 22 rows -> 3 chunks
        tracing.reset_counters("serving.execute.")
        got = ex.search_ragged(tidx, blocks, 6, params_list=p)
        assert ex.ragged_executables() == 1
        assert tracing.get_counter("serving.execute.calls") == 3
        assert tracing.get_counter("serving.execute.rows") == 22
        assert tracing.get_counter("serving.execute.padded_rows") == 24
        for b, g in zip(blocks, got):
            _bitwise(g, ex.search(tidx, b, 6, params=p))

    def test_tensor_blocks_pack_like_numpy_blocks(self, data, indexes):
        _, q = data
        _, tidx = indexes["ivf_flat"]
        p = ivf_flat.IvfFlatSearchParams(n_probes=5)
        ex = SearchExecutor(CPU, ragged_tile=8)
        blocks = _blocks(q, (3, 9))
        want = ex.search_ragged(tidx, blocks, 5, params_list=p)
        got = ex.search_ragged(tidx, [torch.from_numpy(b) for b in blocks],
                               5, params_list=p)
        for g, w in zip(got, want):
            _bitwise(g, w)

    def test_empty_total_returns_empties(self, indexes):
        _, tidx = indexes["ivf_flat"]
        ex = SearchExecutor(CPU, ragged_tile=8)
        ((d, i),) = ex.search_ragged(
            tidx, [np.zeros((0, D), np.float32)], 4,
            params_list=ivf_flat.IvfFlatSearchParams(n_probes=5))
        assert d.shape == (0, 4) and i.dtype == torch.int32
        assert ex.stats.compile_count == 0

    def test_2d_filter_rows_pack_adjacently(self, data, indexes):
        x, q = data
        _, tidx = indexes["ivf_flat"]
        rng = np.random.default_rng(5)
        p = ivf_flat.IvfFlatSearchParams(n_probes=8)
        sizes = (3, 5)
        blocks = _blocks(q, sizes)
        mask = rng.random((sum(sizes), len(x))) < 0.5
        ex = SearchExecutor(CPU, ragged_tile=16)
        got = ex.search_ragged(tidx, blocks, 6, params_list=p,
                               sample_filter=BitmapFilter.from_mask(mask))
        row = 0
        for b, m, g in zip(blocks, sizes, got):
            want = ex.search(tidx, b, 6, params=p,
                             sample_filter=BitmapFilter.from_mask(
                                 mask[row:row + m]))
            _bitwise(g, want)
            ids = g[1].numpy()
            rows_of = np.repeat(np.arange(m), 6).reshape(m, 6)
            ok = ids >= 0
            assert mask[row:row + m][rows_of[ok], ids[ok]].all()
            row += m

    def test_shared_1d_filter(self, data, indexes):
        x, q = data
        _, tidx = indexes["ivf_flat"]
        p = ivf_flat.IvfFlatSearchParams(n_probes=8)
        filt = BitsetFilter(Bitset.from_mask(
            torch.from_numpy(np.arange(len(x)) % 2 == 0)))
        ex = SearchExecutor(CPU, ragged_tile=16)
        blocks = _blocks(q, (4, 3))
        for b, g in zip(blocks, ex.search_ragged(
                tidx, blocks, 5, params_list=p, sample_filter=filt)):
            _bitwise(g, ex.search(tidx, b, 5, params=p, sample_filter=filt))
            ids = g[1].numpy()
            assert (ids[ids >= 0] % 2 == 0).all()

    @pytest.mark.parametrize("name", ["ivf_flat", "ivf_bq", "tiered",
                                      "ivf_pq"])
    def test_probe_accounting_counts_exactly(self, data, indexes, name):
        """The plane counts each packed request's own n_probes per row;
        pad rows and masked slots count nothing, and the plane is the
        bucketed plans' one."""
        _, q = data
        _, tidx = indexes[name]
        ex = SearchExecutor(CPU, ragged_tile=16, probe_accounting=True)
        p1, p2 = _params(name, 5)[1], _params(name, 8)[1]
        blocks = _blocks(q, (3, 2))
        ex.search_ragged(tidx, blocks, 4, params_list=[p1, p2])
        (plane,) = ex.probe_frequencies().values()
        assert plane.sum() == 3 * 5 + 2 * 8
        assert tracing.get_counter("index.probe.rows") >= 5
        ex.search(tidx, blocks[0], 4, params=p1)
        (plane,) = ex.probe_frequencies().values()
        assert plane.sum() == 3 * 5 + 2 * 8 + 3 * 5


class TestPadRows:
    """Pad rows are zero with budget 0: they probe nothing (every slot is
    the sentinel), so the scan merges nothing for them (inf / -1 rows)
    and the probe histogram counts none of them."""

    @pytest.mark.parametrize("name", ["ivf_flat", "ivf_bq", "tiered",
                                      "ivf_pq"])
    def test_budget_zero_rows_probe_nothing(self, data, indexes, name):
        _, q = data
        _, tidx = indexes[name]
        p = _params(name, 8)[1]
        ex = SearchExecutor(CPU, ragged_tile=8)
        spec, _ = ex._ragged_resolve(tidx, 8, p, None, {})
        with ex._lock, ex._dispatch_lock(tidx):
            plan = ex._plan_ragged(tidx, None, spec, 8)
        qt = torch.zeros((8, D))
        qt[:3] = torch.from_numpy(q[:3])
        budgets = torch.tensor([8, 8, 8, 0, 0, 0, 0, 0], dtype=torch.int32)
        counts = torch.zeros(N_LISTS, dtype=torch.int32)
        args = [qt, budgets, *plan.arrays]
        if plan.use_filter:
            args.append(None)
        d, i, counts = plan.fn(*args, probe_counts=counts, n_valid=8,
                               **plan.static)
        assert torch.isinf(d[3:]).all() and (i[3:] == -1).all()
        assert (i[:3] >= 0).all()
        assert int(counts.sum()) == 3 * 8

    def test_cagra_budget_zero_rows_change_nothing(self, data, indexes):
        """CAGRA's pad rows carry an iteration budget of 0: their walk is
        seeds only, and the real rows beside them are the solo rows."""
        _, q = data
        _, tidx = indexes["cagra"]
        p = cagra.CagraSearchParams(itopk_size=16, max_iterations=12)
        ex = SearchExecutor(CPU, ragged_tile=8)
        (got,) = ex.search_ragged(tidx, [q[:3]], 8, params_list=p)
        _bitwise(got, cagra.search(CPU, p, tidx, q[:3], 8))


class TestRaggedFamilies:
    @pytest.mark.parametrize("name", FAMILIES)
    def test_warmup_then_mixed_traffic_builds_nothing(self, data, indexes,
                                                      name):
        _, q = data
        _, tidx = indexes[name]
        pairs = [_params(name, b) for b in BUDGETS[name]]
        ex = SearchExecutor(CPU, ragged_tile=16)
        ex.warmup_ragged(tidx, k=8, params=pairs[0][1])
        assert ex.ragged_executables() == 1
        family = "tiered_ivf" if name == "tiered" else name
        assert ex.ragged_executables(family) == 1
        rng = np.random.default_rng(3)
        for _ in range(3):
            sizes = tuple(int(m) for m in rng.integers(1, 9, 5))
            blocks = _blocks(q, sizes)
            got = ex.search_ragged(tidx, blocks, list(KS),
                                   params_list=[p for _, p in pairs])
            for b, k, (_, p), g in zip(blocks, KS, pairs, got):
                _bitwise(g, ex.search(tidx, b, k, params=p))
        assert ex.ragged_executables() == 1

    def test_tiered_after_an_epoch_keeps_its_entry(self, data, indexes):
        """An epoch swaps same-shape arrays: ragged traffic keeps its
        entry, and results still equal the all-device index's."""
        x, q = data
        ji, ti = indexes["ivf_flat"]
        t = tiered.build_tiered(ti, hot_fraction=0.5)
        p = tiered.TieredSearchParams(n_probes=6)
        ex = SearchExecutor(CPU, ragged_tile=16)
        blocks = _blocks(q, (4, 5))
        ex.search_ragged(t, blocks, 5, params_list=p)
        tiered.apply_plan(t, [int(t.cold_lists[0])], [int(t.hot_lists[0])],
                          1)
        got = ex.search_ragged(t, blocks, 5, params_list=p)
        assert ex.stats.compile_count == 1
        for b, g in zip(blocks, got):
            _bitwise(g, ex.search(
                ti, b, 5, params=ivf_flat.IvfFlatSearchParams(n_probes=6)))

    def test_bq_class_cap_prunes_as_a_solo_run_at_the_cap(self, data,
                                                          indexes):
        """The IVF-BQ margin prune runs at the class cap's k: where a
        margin fails (here forced by epsilon 0), a packed row can keep a
        neighbour its solo run at k pruned. The packed result then equals
        the solo search at k_class sliced to k, not the solo search at k,
        and the JAX executor's ragged path does exactly the same (its ids
        equal the port's, its mismatches against its own solo search are
        the port's)."""
        _, q = data
        jidx, tidx = indexes["ivf_bq"]
        p = ivf_bq.IvfBqSearchParams(n_probes=6, epsilon=0.0)
        jp = j_bq.IvfBqSearchParams(n_probes=6, epsilon=0.0,
                                    scan_engine="xla")
        ex = SearchExecutor(CPU, ragged_tile=64)
        jex = JExecutor(ragged_tile=64)
        (got,) = ex.search_ragged(tidx, [q], 3, params_list=p)
        (jgot,) = jex.search_ragged(jidx, [q], 3, params_list=jp)
        at_cap = ex.search(tidx, q, 8, params=p)
        _bitwise(got, (at_cap[0][:, :3], at_cap[1][:, :3]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(jgot[1]))
        solo = ex.search(tidx, q, 3, params=p)[1].numpy()
        jsolo = np.asarray(jex.search(jidx, q, 3, params=jp)[1])
        port_rows = (got[1].numpy() != solo).any(axis=1)
        jax_rows = (np.asarray(jgot[1]) != jsolo).any(axis=1)
        assert port_rows.any()
        np.testing.assert_array_equal(port_rows, jax_rows)

    def test_residue_reasons(self, data, indexes):
        """The non-raggable residue falls back with the JAX package's own
        reason strings, for the cases the port can build."""
        x, _ = data
        ex = SearchExecutor(CPU)
        jex = JExecutor()
        _, fl = indexes["ivf_flat"]
        _, bq = indexes["ivf_bq"]
        _, cg = indexes["cagra"]
        jfl = indexes["ivf_flat"][0]
        jcg = indexes["cagra"][0]
        reason = ex.ragged_fallback_reason
        assert reason(indexes["brute_force"][1], 4) == (
            jex.ragged_fallback_reason(j_bf.build(None, x), 4))
        assert reason(fl, 4, params=ivf_flat.IvfFlatSearchParams(
            coarse_algo="approx")) == jex.ragged_fallback_reason(
            jfl, 4, params=j_ivf.IvfFlatSearchParams(coarse_algo="approx"))
        assert reason(cg, 20, params=cagra.CagraSearchParams(
            itopk_size=16)) == jex.ragged_fallback_reason(
            jcg, 20, params=j_cagra.CagraSearchParams(itopk_size=16))
        assert reason(cg, 4, params=cagra.CagraSearchParams(
            itopk_size=16)) is None
        assert reason(fl, 0) == jex.ragged_fallback_reason(jfl, 0)
        assert reason(fl, 4, db_tile=64) == jex.ragged_fallback_reason(
            jfl, 4, db_tile=64)
        assert reason(object(), 4) == ex._RAGGED_RESIDUE["family"]
        # codes-only BQ resolves to the rank estimate scan
        codes_only = ivf_bq.build(CPU, ivf_bq.IvfBqIndexParams(
            n_lists=8, store_vectors=False), x)
        assert ex.ragged_key(codes_only, 4) is None
        assert reason(codes_only, 4) == ex._RAGGED_RESIDUE["rank"]
        assert reason(bq, 4, params=ivf_bq.IvfBqSearchParams(
            scan_engine="rank")) == ex._RAGGED_RESIDUE["rank"]
        assert reason(bq, 4) is None
        # IVF-PQ's rank engine (auto on the CPU) stays bucketed, as the
        # JAX package's non-xla PQ engines do
        jpq, pq = indexes["ivf_pq"]
        assert reason(pq, 4) == ex._RAGGED_RESIDUE["rank"]
        assert reason(pq, 4) == jex.ragged_fallback_reason(jpq, 4)
        assert ex.ragged_key(pq, 4, params=ivf_pq.IvfPqSearchParams(
            scan_engine="rank")) is None
        assert reason(pq, 4, params=ivf_pq.IvfPqSearchParams(
            scan_engine="torch")) is None
        with pytest.raises(RaftError, match="brute_force"):
            ex.warmup_ragged(indexes["brute_force"][1], k=4)

    def test_k_past_the_scan_kernel_stays_raggable(self, data, indexes):
        """k past the IVF kernel's limit resolves to the plain ``torch``
        engine, which is still raggable (eager on the card)."""
        _, q = data
        _, tidx = indexes["ivf_flat"]
        ex = SearchExecutor(CPU, ragged_tile=8)
        p = ivf_flat.IvfFlatSearchParams(n_probes=4, scan_engine="cuda")
        assert ex.ragged_key(tidx, 200, params=p) is not None
        assert ex._ragged_resolve(tidx, 200, p, None, {})[0]["engine"] == (
            "torch")
        (got,) = ex.search_ragged(tidx, [q[:3]], 200, params_list=p)
        _bitwise(got, ex.search(tidx, q[:3], 200, params=p))


class TestRaggedDualTile:
    def test_warmup_builds_both_tiles(self, indexes):
        _, tidx = indexes["ivf_flat"]
        ex = SearchExecutor(CPU, ragged_tile=32, ragged_tile_small=8)
        ex.warmup_ragged(tidx, k=4,
                         params=ivf_flat.IvfFlatSearchParams(n_probes=6))
        assert ex.ragged_executables() == 2
        assert ex.ragged_executables("ivf_flat") == 2
        assert sorted(c["bucket"] for c in ex.executable_costs().values()
                      ) == [8, 32]

    def test_dispatch_selects_the_tile(self, data, indexes):
        _, q = data
        _, tidx = indexes["ivf_flat"]
        p = ivf_flat.IvfFlatSearchParams(n_probes=6)
        ex = SearchExecutor(CPU, ragged_tile=32, ragged_tile_small=8)
        ex.warmup_ragged(tidx, k=4, params=p)
        metrics.reset()
        small = ex.search_ragged(tidx, [q[:3]], 4, params_list=p)
        big = _blocks(q, (9, 9, 9, 9, 9))
        res_b = ex.search_ragged(tidx, big, 4, params_list=p)
        assert ex.stats.compile_count == 2
        assert tracing.get_counter(
            "serving.execute.padded_rows.p8.t8") == 8.0
        assert tracing.get_counter(
            "serving.execute.padded_rows.p8.t32") == 64.0
        by_class = metrics.derived()["pad_waste_by_class"]
        assert by_class["p8.t8"] == pytest.approx(1 - 3 / 8)
        assert by_class["p8.t32"] == pytest.approx(1 - 45 / 64)
        _bitwise(small[0], ex.search(tidx, q[:3], 4, params=p))
        for b, g in zip(big, res_b):
            _bitwise(g, ex.search(tidx, b, 4, params=p))

    def test_tile_never_joins_the_key(self, indexes):
        _, tidx = indexes["ivf_flat"]
        p = ivf_flat.IvfFlatSearchParams(n_probes=6)
        assert (SearchExecutor(CPU, ragged_tile=32).ragged_key(
            tidx, 4, params=p) == SearchExecutor(
            CPU, ragged_tile=32, ragged_tile_small=8).ragged_key(
            tidx, 4, params=p))

    @pytest.mark.parametrize("small", [0, 32, 40])
    def test_small_tile_must_be_below_the_tile(self, small):
        with pytest.raises(RaftError, match="ragged_tile_small"):
            SearchExecutor(CPU, ragged_tile=32, ragged_tile_small=small)
