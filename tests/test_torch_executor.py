"""The port's ``SearchExecutor`` (CPU, eager plan entries) against the JAX
package's ``SearchExecutor`` and against the port's own direct searches.

The JAX package builds every index on integer-valued data and saves it
with its serializers (``raft_tpu/core/serialize.py``); the port loads the
bytes. Every product is then exact, so on the same seeded queries the two
executors' ids are equal EXACTLY and distances agree to rtol 1e-5 / atol
1e-4 x scale (the tolerance of ``tests/test_torch_ivf_flat.py``). Against
the port's direct ``search`` the executor is bit for bit: bucketing pads
with inert rows. The tiered container is split from the loaded IVF-Flat
index and held to the JAX executor's IVF-Flat results (a tiered search
equals the all-device search bit for bit). Mirrors
``tests/test_executor.py``'s bit-identity, compile-regression, warmup,
cache and probe-accounting suites.
"""

from __future__ import annotations

import io

import numpy as np
import pytest
import torch

from raft_tpu import SearchExecutor as JExecutor
from raft_tpu.core.bitset import Bitset as JBitset
from raft_tpu.neighbors import brute_force as j_bf
from raft_tpu.neighbors import cagra as j_cagra
from raft_tpu.neighbors import ivf_bq as j_bq
from raft_tpu.neighbors import ivf_flat as j_ivf
from raft_tpu.neighbors import ivf_pq as j_pq
from raft_tpu.neighbors.filters import BitmapFilter as JBitmap
from raft_tpu.neighbors.filters import BitsetFilter as JBitsetFilter
from raft_tpu_torch import Resources, SearchExecutor
from raft_tpu_torch.core import executor, tracing
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.validation import RaftError
from raft_tpu_torch.neighbors import brute_force, cagra, ivf_bq, ivf_flat
from raft_tpu_torch.neighbors import ivf_pq, tiered
from raft_tpu_torch.neighbors.filters import BitmapFilter, BitsetFilter

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

CPU = Resources(device="cpu")
N, D, N_LISTS = 600, 16, 8
FAMILIES = ("brute_force", "ivf_flat", "ivf_bq", "cagra", "tiered", "ivf_pq")
IVF = ("ivf_flat", "ivf_bq", "tiered", "ivf_pq")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    centers = rng.integers(-5, 6, (10, D))
    x = centers[rng.integers(0, 10, N)] + rng.integers(-2, 3, (N, D))
    q = centers[rng.integers(0, 10, 16)] + rng.integers(-2, 3, (16, D))
    return x.astype(np.float32), q.astype(np.float32)


def _carry(j_mod, t_mod, jidx):
    buf = io.BytesIO()
    j_mod.save(jidx, buf)
    buf.seek(0)
    return t_mod.load(CPU, buf)


def _jax_pq(x, n_lists):
    """A JAX IVF-PQ index with its centers and codebooks rounded to
    integers before the rows are added: every ADC sum is exact."""
    import dataclasses

    import jax.numpy as jnp

    empty = j_pq.build(None, j_pq.IvfPqIndexParams(
        n_lists=n_lists, pq_dim=8, add_data_on_build=False), x)
    empty = dataclasses.replace(empty, centers=jnp.round(empty.centers),
                                codebooks=jnp.round(empty.codebooks))
    return j_pq.extend(None, empty, x)


@pytest.fixture(scope="module")
def indexes(data):
    """{family: (JAX index, port index)}; tiered pairs the JAX IVF-Flat
    index with the port's container split from the loaded copy."""
    x, _ = data
    jb = j_bf.build(None, x)
    ji = j_ivf.build(None, j_ivf.IvfFlatIndexParams(n_lists=N_LISTS), x)
    jq = j_bq.build(None, j_bq.IvfBqIndexParams(n_lists=N_LISTS), x)
    jc = j_cagra.build(None, j_cagra.CagraIndexParams(
        graph_degree=8, intermediate_graph_degree=16,
        build_algo=j_cagra.BuildAlgo.NN_DESCENT), x)
    ti = _carry(j_ivf, ivf_flat, ji)
    jp = _jax_pq(x, N_LISTS)
    return {
        "ivf_pq": (jp, _carry(j_pq, ivf_pq, jp)),
        "brute_force": (jb, _carry(j_bf, brute_force, jb)),
        "ivf_flat": (ji, ti),
        "ivf_bq": (jq, _carry(j_bq, ivf_bq, jq)),
        "cagra": (jc, _carry(j_cagra, cagra, jc)),
        "tiered": (ji, tiered.build_tiered(ti, hot_fraction=0.5)),
    }


def _params(name, n_probes=N_LISTS):
    """(JAX params, port params)."""
    return {
        "brute_force": (None, None),
        "ivf_flat": (j_ivf.IvfFlatSearchParams(n_probes=n_probes),
                     ivf_flat.IvfFlatSearchParams(n_probes=n_probes)),
        "ivf_bq": (j_bq.IvfBqSearchParams(n_probes=n_probes),
                   ivf_bq.IvfBqSearchParams(n_probes=n_probes)),
        "cagra": (j_cagra.CagraSearchParams(itopk_size=16),
                  cagra.CagraSearchParams(itopk_size=16)),
        "tiered": (j_ivf.IvfFlatSearchParams(n_probes=n_probes),
                   tiered.TieredSearchParams(n_probes=n_probes)),
        "ivf_pq": (j_pq.IvfPqSearchParams(n_probes=n_probes),
                   ivf_pq.IvfPqSearchParams(n_probes=n_probes)),
    }[name]


def _direct(name, index, params, q, k, sample_filter=None):
    if name == "brute_force":
        return brute_force.search(CPU, index, q, k)
    mod = {"ivf_flat": ivf_flat, "ivf_bq": ivf_bq, "cagra": cagra,
           "tiered": tiered, "ivf_pq": ivf_pq}[name]
    return mod.search(CPU, params, index, q, k, sample_filter=sample_filter)


def _bitwise(got, want):
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


def _close_to_jax(got, want):
    wd, wi = np.asarray(want[0]), np.asarray(want[1])
    np.testing.assert_array_equal(got[1].numpy(), wi)
    scale = max(1.0, float(np.abs(wd[np.isfinite(wd)]).max(initial=0.0)))
    np.testing.assert_allclose(got[0].numpy(), wd, rtol=1e-5,
                               atol=1e-4 * scale)


class TestBitIdentity:
    @pytest.mark.parametrize("name", FAMILIES)
    @pytest.mark.parametrize("q_rows", [3, 11, 16])
    def test_matches_direct_and_jax(self, data, indexes, name, q_rows):
        _, q = data
        jidx, tidx = indexes[name]
        jp, tp = _params(name)
        got = SearchExecutor(CPU).search(tidx, q[:q_rows], 5, params=tp)
        _bitwise(got, _direct(name, tidx, tp, q[:q_rows], 5))
        _close_to_jax(got, JExecutor().search(jidx, q[:q_rows], 5,
                                              params=jp))

    @pytest.mark.parametrize("name", ["brute_force", "ivf_flat", "cagra"])
    def test_oversized_batch_tiles(self, indexes, name):
        """Batches past max_bucket tile through the top bucket's entry;
        CAGRA's seeds are a function of each query's content, so its
        tiles need no row offsets."""
        rng = np.random.default_rng(3)
        big = rng.integers(-6, 7, (70, D)).astype(np.float32)
        jidx, tidx = indexes[name]
        jp, tp = _params(name)
        ex = SearchExecutor(CPU, min_bucket=8, max_bucket=32)
        got = ex.search(tidx, big, 5, params=tp)
        _bitwise(got, _direct(name, tidx, tp, big, 5))
        _close_to_jax(got, JExecutor(min_bucket=8, max_bucket=32).search(
            jidx, big, 5, params=jp))
        # tiles of 32, 32 and a tail of 6 padded into the same bucket
        assert ex.stats.compile_count == 1

    @pytest.mark.parametrize("query_tile", [1, 4, 5])
    def test_cagra_plan_tiles_by_query_tile(self, data, indexes,
                                            query_tile):
        """The CAGRA plan walks its bucket in query_tile-row tiles (what
        bounds a captured graph's pool); rows come out as the direct
        search's, whatever the tiling."""
        _, q = data
        jidx, tidx = indexes["cagra"]
        jp, _ = _params("cagra")
        tp = cagra.CagraSearchParams(itopk_size=16, query_tile=query_tile)
        got = SearchExecutor(CPU).search(tidx, q[:11], 5, params=tp)
        _bitwise(got, _direct("cagra", tidx, tp, q[:11], 5))
        _bitwise(got, _direct("cagra", tidx, _params("cagra")[1], q[:11],
                              5))
        _close_to_jax(got, JExecutor().search(jidx, q[:11], 5, params=jp))

    @pytest.mark.parametrize("name", ["ivf_flat", "ivf_bq", "tiered",
                                      "ivf_pq"])
    @pytest.mark.parametrize("kind", ["bitset", "bitmap"])
    def test_filtered_search(self, data, indexes, name, kind):
        x, q = data
        jidx, tidx = indexes[name]
        jp, tp = _params(name)
        if kind == "bitset":
            mask = np.arange(N) >= N // 2
            tf = BitsetFilter(Bitset.from_mask(torch.from_numpy(mask)))
            jf = JBitsetFilter(JBitset.from_mask(mask))
        else:
            mask = np.ones((9, N), bool)
            mask[:, ::3] = False
            tf, jf = BitmapFilter.from_mask(mask), JBitmap.from_mask(mask)
        got = SearchExecutor(CPU).search(tidx, q[:9], 5, params=tp,
                                         sample_filter=tf)
        _bitwise(got, _direct(name, tidx, tp, q[:9], 5, tf))
        _close_to_jax(got, JExecutor().search(jidx, q[:9], 5, params=jp,
                                              sample_filter=jf))

    @pytest.mark.parametrize("name", FAMILIES)
    def test_zero_and_repeated_pad_rows_agree(self, data, indexes, name,
                                              monkeypatch):
        """Pad rows are inert whatever they hold: rows repeating the
        first query (the executor's choice) and zero rows (the JAX
        package's) give the same real rows, bit for bit."""
        _, q = data
        _, tidx = indexes[name]
        _, tp = _params(name)
        edge = SearchExecutor(CPU).search(tidx, q[:5], 5, params=tp)
        _pad_with_zeros(monkeypatch)
        _bitwise(edge, SearchExecutor(CPU).search(tidx, q[:5], 5, params=tp))


def _pad_with_zeros(monkeypatch) -> None:
    """Make the executor pad query blocks with zero rows."""
    pad = executor._pad
    monkeypatch.setattr(executor, "_pad",
                        lambda t, rows, mode: pad(t, rows, "zero"))


class TestCompileRegression:
    @pytest.mark.parametrize("name", FAMILIES)
    def test_zero_entries_built_within_bucket(self, data, indexes, name):
        _, q = data
        _, tidx = indexes[name]
        _, tp = _params(name)
        ex = SearchExecutor(CPU)
        for n in (16, 13, 9):
            ex.search(tidx, q[:n], 5, params=tp)
        assert ex.stats.compile_count == 1     # one bucket, one entry
        base = tracing.get_counter("serving.compile_count")
        for n in (16, 13, 9, 13, 16, 9):
            ex.search(tidx, q[:n], 5, params=tp)
        assert ex.stats.compile_count == 1
        assert tracing.get_counter("serving.compile_count") == base
        assert ex.stats.cache_hits >= 8

    def test_counters_exported_via_tracing(self, data, indexes):
        _, q = data
        base = tracing.get_counter("serving.compile_count")
        SearchExecutor(CPU).search(indexes["ivf_bq"][1], q, 5)
        assert tracing.get_counter("serving.compile_count") >= base + 1

    def test_same_shape_indexes_share_an_eager_entry(self, data, indexes):
        """Eager entries are keyed on shapes and statics, as the JAX
        package's executables are; each index still gets its own rows."""
        x, q = data
        _, tidx = indexes["brute_force"]
        other = brute_force.build(CPU, x[::-1].copy())
        ex = SearchExecutor(CPU)
        for idx in (tidx, other, tidx):
            _bitwise(ex.search(idx, q[:7], 5),
                     brute_force.search(CPU, idx, q[:7], 5))
        assert ex.stats.compile_count == 1


class TestWarmup:
    def test_warmup_builds_entries(self, data, indexes):
        _, q = data
        _, tp = _params("ivf_flat")
        ex = SearchExecutor(CPU)
        secs = ex.warmup(indexes["ivf_flat"][1], buckets=(8, 16), k=5,
                         params=tp)
        assert secs > 0 and ex.stats.warmup_seconds == secs
        assert ex.stats.compile_count == 2
        d, _ = ex.search(indexes["ivf_flat"][1], q[:5], 5, params=tp)
        assert ex.stats.compile_count == 2
        assert ex.stats.cache_hits == 1
        assert torch.isfinite(d).all()

    def test_warmup_rejects_unknown_bucket(self, indexes):
        ex = SearchExecutor(CPU, min_bucket=8, max_bucket=32)
        with pytest.raises(RaftError):
            ex.warmup(indexes["brute_force"][1], buckets=(7,), k=5)


class TestCacheAndState:
    def test_lru_eviction(self, data, indexes):
        _, q = data
        ex = SearchExecutor(CPU, max_entries=1)
        ex.search(indexes["brute_force"][1], q[:4], 5)
        ex.search(indexes["ivf_flat"][1], q[:4], 5,
                  params=_params("ivf_flat")[1])
        assert ex.stats.evictions == 1
        ex.search(indexes["brute_force"][1], q[:4], 5)
        assert ex.stats.compile_count == 3

    def test_results_survive_the_next_call(self, data, indexes):
        _, q = data
        ex = SearchExecutor(CPU)
        d1, i1 = ex.search(indexes["brute_force"][1], q[:16], 5)
        d1c, i1c = d1.clone(), i1.clone()
        d2, i2 = ex.search(indexes["brute_force"][1], q[:9], 5)
        _bitwise((d1, i1), (d1c, i1c))
        _bitwise((d2, i2), brute_force.search(
            CPU, indexes["brute_force"][1], q[:9], 5))

    def test_empty_batch(self, indexes):
        d, i = SearchExecutor(CPU).search(
            indexes["brute_force"][1], np.zeros((0, D), np.float32), 5)
        assert d.shape == (0, 5) and i.shape == (0, 5)
        assert i.dtype == torch.int32

    def test_unsupported_index_type(self):
        with pytest.raises(TypeError):
            SearchExecutor(CPU).search(object(), np.zeros((2, 4),
                                                          np.float32), 1)

    @pytest.mark.parametrize("name", FAMILIES)
    def test_capture_on_a_cpu_index_raises(self, data, indexes, name):
        _, q = data
        _, tp = _params(name)
        ex = SearchExecutor(CPU, capture=True)
        with pytest.raises(RaftError, match="CUDA"):
            ex.search(indexes[name][1], q[:4], 5, params=tp)
        assert ex.stats.compile_count == 0

    def test_capture_resolves_from_the_device(self):
        assert SearchExecutor(CPU).capture is False

    def test_costs_gauges_and_reservations(self, data, indexes):
        _, q = data
        ex = SearchExecutor(CPU, probe_accounting=True)
        ex.search(indexes["ivf_flat"][1], q, 5,
                  params=_params("ivf_flat")[1])
        costs = ex.executable_costs()
        assert len(costs) == 1
        digest, info = next(iter(costs.items()))
        assert info["family"] == "ivf_flat"
        assert info["bucket"] == 16 and info["k"] == 5
        assert info["captured"] is False and info["pool_bytes"] == 0
        assert tracing.get_gauge(
            "serving.executor.cached_executables") == 1.0
        tracing.reset_gauges("serving.")
        assert tracing.gauges(f"serving.executable.{digest}.") == {}
        ex.publish_cost_gauges()
        assert f"serving.executable.{digest}.pool_bytes" in tracing.gauges(
            "serving.executable.")
        mem = ex.memory_reservations()
        assert mem["executables"] == 1 and mem["graph_pool_bytes"] == {}
        assert mem["probe_plane_bytes"] == {0: 4 * N_LISTS}

    def test_eviction_retires_cost_gauges(self, data, indexes):
        _, q = data
        ex = SearchExecutor(CPU, max_entries=1)
        ex.search(indexes["brute_force"][1], q, 5)
        first = set(ex.executable_costs())
        ex.search(indexes["brute_force"][1], q, 7)
        second = set(ex.executable_costs())
        assert len(second) == 1 and first != second
        assert tracing.gauges(f"serving.executable.{first.pop()}.") == {}

    def test_execute_counters_advance_per_call(self, data, indexes):
        _, q = data
        tracing.reset_counters("serving.execute.")
        ex = SearchExecutor(CPU)
        ex.warmup(indexes["brute_force"][1], buckets=(16,), k=5)
        assert tracing.get_counter("serving.execute.calls") == 0
        ex.search(indexes["brute_force"][1], q[:13], 5)
        ex.search(indexes["brute_force"][1], q[:13], 5)
        assert tracing.get_counter("serving.execute.calls") == 2
        assert tracing.get_counter("serving.execute.rows") == 26
        assert tracing.get_counter("serving.execute.padded_rows") == 32


class TestProbeAccounting:
    @pytest.mark.parametrize("name", IVF)
    def test_bit_identity_with_accounting_on(self, data, indexes, name):
        _, q = data
        _, tidx = indexes[name]
        _, tp = _params(name)
        got = SearchExecutor(CPU, probe_accounting=True).search(
            tidx, q, 5, params=tp)
        _bitwise(got, _direct(name, tidx, tp, q, 5))

    @pytest.mark.parametrize("name", IVF)
    def test_exact_counts_equal_jax(self, data, indexes, name):
        """13 rows pad to the 16-bucket: the pad rows' probes must not
        count. The plane equals the JAX executor's on the same calls."""
        _, q = data
        jidx, tidx = indexes[name]
        jp, tp = _params(name, n_probes=3)
        ex = SearchExecutor(CPU, probe_accounting=True)
        jex = JExecutor(probe_accounting=True)
        for _ in range(3):
            ex.search(tidx, q[:13], 5, params=tp)
            jex.search(jidx, q[:13], 5, params=jp)
        (plane,) = ex.probe_frequencies().values()
        (jplane,) = jex.probe_frequencies().values()
        assert plane.shape == (N_LISTS,) and plane.sum() == 3 * 13 * 3
        np.testing.assert_array_equal(plane, jplane)

    def test_zero_entries_built_in_steady_state(self, data, indexes):
        _, q = data
        ex = SearchExecutor(CPU, probe_accounting=True)
        tp = _params("ivf_flat", n_probes=4)[1]
        for n in (16, 13, 9):
            ex.search(indexes["ivf_flat"][1], q[:n], 5, params=tp)
        compiles0 = ex.stats.compile_count
        for n in (16, 13, 9, 13, 16, 9):
            ex.search(indexes["ivf_flat"][1], q[:n], 5, params=tp)
        assert ex.stats.compile_count == compiles0 == 1

    def test_accounting_is_a_distinct_entry(self, indexes):
        tp = _params("ivf_flat", n_probes=4)[1]
        idx = indexes["ivf_flat"][1]
        kon = SearchExecutor(CPU, probe_accounting=True)._plan(
            idx, tp, 5, 16, None, {}).key
        koff = SearchExecutor(CPU)._plan(idx, tp, 5, 16, None, {}).key
        assert kon != koff and "probe_accounting" in kon

    def test_off_by_default_no_planes(self, data, indexes):
        _, q = data
        ex = SearchExecutor(CPU)
        ex.search(indexes["ivf_flat"][1], q, 5,
                  params=_params("ivf_flat", n_probes=4)[1])
        assert ex.probe_frequencies() == {}
        assert ex.probe_label(indexes["ivf_flat"][1]) is None

    @pytest.mark.parametrize("name", ["brute_force", "cagra"])
    def test_non_ivf_families_unaffected(self, data, indexes, name):
        _, q = data
        _, tidx = indexes[name]
        _, tp = _params(name)
        got = SearchExecutor(CPU, probe_accounting=True).search(
            tidx, q, 5, params=tp)
        _bitwise(got, _direct(name, tidx, tp, q, 5))

    def test_publish_probe_gauges_and_lifetime_counter(self, data,
                                                       indexes):
        _, q = data
        tracing.reset_counters("index.")
        tracing.reset_gauges("index.")
        ex = SearchExecutor(CPU, probe_accounting=True)
        ex.search(indexes["ivf_flat"][1], q, 5,
                  params=_params("ivf_flat", n_probes=4)[1])
        label = ex.probe_label(indexes["ivf_flat"][1])
        assert label is not None and "." not in label
        stats = ex.publish_probe_gauges(top_n=3)[label]
        base = f"index.probe_freq.{label}."
        assert tracing.get_gauge(base + "total") == 16 * 4
        assert 0.0 < tracing.get_gauge(base + "probed_fraction") <= 1.0
        assert (tracing.get_gauge(base + "coverage_p01")
                <= tracing.get_gauge(base + "coverage_p10"))
        assert len(stats["top"]) <= 3
        for lid, c in stats["top"]:
            assert tracing.get_gauge(f"{base}list.{lid}") == float(c)
        assert tracing.get_counter("index.probe_freq.accounted") == 64
        # the window was claimed: a second scrape adds nothing new
        again = ex.probe_frequencies()[label]
        assert again.sum() == 64
        assert tracing.lifetime_counters("index.probe.")[
            "index.probe.dispatches"] >= 1
