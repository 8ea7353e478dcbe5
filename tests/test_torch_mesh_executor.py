"""The port's executor over the list-sharded indexes against the JAX
package's executor, and against the port's own direct mesh searches.

The JAX package builds each list-sharded index on R virtual CPU devices
(R in {2, 4}; a 2 x 2 lists x queries grid for ``query_axis``), with its
coarse centers (and PQ codebooks) rounded to integers and integer-valued
data and queries, so every product is exact; the per-shard arrays cross
as numpy (``from_numpy*``). Both executors then serve the same queries:
ids equal exactly (ties by smallest id), distances within rtol 1e-6 /
atol 1e-5 (the tolerance ``tests/test_torch_distributed.py`` states), the
port's served result equal bit for bit to its direct ``distributed.
search*``, no plan entry built after warmup, and the probe histograms
equal to the JAX executor's. Mirrors ``tests/test_distributed_serving.py``'s
``TestMeshExecutor``, ``Test2DMeshExecutor``, ``TestMeshRagged``,
``TestMeshProbeAccounting``, ``TestMeshSpans``, ``TestPayloadGauges``,
``TestBqFusedMesh``'s executor cases and ``TestQuantizedProbeExchange::
test_executor_serves_quantized_probe_wire``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import raft_tpu.distributed.bq as j_dbq
import raft_tpu.distributed.ivf as j_divf
import raft_tpu.neighbors.ivf_bq as j_ivf_bq
import raft_tpu.neighbors.ivf_flat as j_ivf_flat
import raft_tpu.neighbors.ivf_pq as j_ivf_pq
from raft_tpu import SearchExecutor as JExecutor
from raft_tpu.comms import Comms as JComms
from raft_tpu.comms.bootstrap import make_mesh as j_make_mesh
from raft_tpu_torch import Resources
from raft_tpu_torch.comms import local_comms
from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.executor import SearchExecutor
from raft_tpu_torch.core.validation import RaftError
from raft_tpu_torch.distributed import bq as dbq
from raft_tpu_torch.distributed import ivf as divf
from raft_tpu_torch.neighbors import ivf_bq, ivf_flat, ivf_pq
from raft_tpu_torch.serving import BatcherConfig, DynamicBatcher
from raft_tpu_torch.serving.harness import ManualClock

RES = Resources(device="cpu", seed=0)
N_LISTS, DIM, K = 16, 32, 7
FAMILIES = ["flat", "pq", "bq"]


def _jcomms(r, grid=False):
    devs = jax.devices()[:(2 * r if grid else r)]
    if grid:
        return JComms(JMesh(np.array(devs).reshape(r, 2),
                            ("lists", "queries")), "lists")
    return JComms(j_make_mesh(devices=devs), "data")


def _tcomms(r, grid=False):
    if grid:
        return local_comms(("lists", "queries"), shape=(r, 2), device="cpu")
    return local_comms(shape=(r,), device="cpu")


@pytest.fixture(scope="module")
def int_data():
    rng = np.random.default_rng(21)
    centers = rng.integers(-12, 13, (24, DIM))
    lab = rng.integers(0, 24, 2400)
    x = (centers[lab] + rng.integers(-2, 3, (2400, DIM))).astype(np.float32)
    q = (centers[rng.integers(0, 24, 24)]
         + rng.integers(-2, 3, (24, DIM))).astype(np.float32)
    return x, q


def _shards(a):
    """A JAX list-sharded array's per-shard blocks in rank order (the
    first device of each block on a 2-D mesh)."""
    blocks = {}
    for s in a.addressable_shards:
        blocks.setdefault(s.index[0].start or 0, np.asarray(s.data))
    return [blocks[k] for k in sorted(blocks)]


def _round_field(jidx, name):
    arr = getattr(jidx, name)
    return dataclasses.replace(
        jidx, **{name: jax.device_put(jnp.round(arr), arr.sharding)})


_CACHE = {}


def _pair(family, r, int_data, grid=False):
    """(JAX index, the port's carried index), cached per configuration."""
    key = (family, r, grid)
    if key in _CACHE:
        return _CACHE[key]
    x, _ = int_data
    jc = _jcomms(r, grid)
    if family == "flat":
        ji = j_divf.build(None, jc, j_ivf_flat.IvfFlatIndexParams(
            n_lists=N_LISTS), x)
    elif family == "pq":
        ji = j_divf.build_pq(None, jc, j_ivf_pq.IvfPqIndexParams(
            n_lists=N_LISTS, pq_dim=8, pq_bits=4), x)
        ji = _round_field(ji, "codebooks")
    else:
        ji = j_dbq.build_bq(None, jc, j_ivf_bq.IvfBqIndexParams(
            n_lists=N_LISTS), x)
    ji = _round_field(ji, "centers")
    tc = _tcomms(r, grid)
    if family == "flat":
        ti = divf.from_numpy(
            tc, _shards(ji.centers), _shards(ji.data), _shards(ji.indices),
            _shards(ji.list_sizes), int(ji.metric),
            data_norms=_shards(ji.data_norms))
    elif family == "pq":
        ti = divf.from_numpy_pq(
            tc, _shards(ji.centers), np.asarray(ji.rotation),
            np.asarray(ji.codebooks), _shards(ji.codes), _shards(ji.indices),
            _shards(ji.list_sizes), int(ji.metric), ji.pq_bits,
            int(ji.codebook_kind))
    else:
        ti = dbq.from_numpy_bq(
            tc, _shards(ji.centers), np.asarray(ji.rotation),
            _shards(ji.codes), _shards(ji.rnorm), _shards(ji.cfac),
            _shards(ji.errw), _shards(ji.indices), _shards(ji.list_sizes),
            int(ji.metric), _shards(ji.data), ji.shard_rel_err)
    _CACHE[key] = (ji, ti)
    return ji, ti


def _params(family, n_probes):
    """(JAX params, port params, port direct search)."""
    if family == "flat":
        return (j_ivf_flat.IvfFlatSearchParams(n_probes=n_probes,
                                               scan_engine="xla"),
                ivf_flat.IvfFlatSearchParams(n_probes=n_probes,
                                             scan_engine="torch"),
                divf.search)
    if family == "pq":
        return (j_ivf_pq.IvfPqSearchParams(n_probes=n_probes,
                                           scan_engine="xla"),
                ivf_pq.IvfPqSearchParams(n_probes=n_probes,
                                         scan_engine="torch"),
                divf.search_pq)
    return (j_ivf_bq.IvfBqSearchParams(n_probes=n_probes, scan_engine="xla"),
            ivf_bq.IvfBqSearchParams(n_probes=n_probes, scan_engine="torch"),
            dbq.search_bq)


def _assert_jax(got, want):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-5)


def _assert_bits(got, want):
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


# one JAX executor for the module: its entries compile once per shape
_JEX = {}


def _jex(probe_accounting=False):
    if probe_accounting not in _JEX:
        _JEX[probe_accounting] = JExecutor(probe_accounting=probe_accounting)
    return _JEX[probe_accounting]


class TestMeshExecutor:
    @pytest.mark.parametrize("r", [2, 4])
    @pytest.mark.parametrize("family", FAMILIES)
    @pytest.mark.parametrize("q_rows", [3, 11, 16])
    def test_bucketing_invariance(self, int_data, r, family, q_rows):
        _, q = int_data
        ji, ti = _pair(family, r, int_data)
        jsp, tsp, direct = _params(family, 6)
        ex = SearchExecutor(RES)
        got = ex.search(ti, q[:q_rows], K, params=tsp)
        _assert_bits(got, direct(RES, tsp, ti, q[:q_rows], K))
        _assert_jax(got, _jex().search(ji, q[:q_rows], K, params=jsp))

    def test_zero_recompiles_within_bucket(self, int_data):
        _, q = int_data
        _, ti = _pair("flat", 4, int_data)
        sp = ivf_flat.IvfFlatSearchParams(n_probes=6)
        ex = SearchExecutor(RES)
        for n in (16, 13, 9):
            ex.search(ti, q[:n], 5, params=sp)
        assert ex.stats.compile_count == 1
        for n in (16, 13, 9, 13, 16, 9):
            ex.search(ti, q[:n], 5, params=sp)
        assert ex.stats.compile_count == 1
        assert ex.stats.cache_hits >= 8

    def test_engine_and_wire_switch(self, int_data):
        """The resolved engine and the wires are in the key: ``auto``
        resolves to the plain engine on the CPU and shares its entry; a
        wire switch is a distinct entry."""
        _, q = int_data
        _, ti = _pair("flat", 4, int_data)
        ex = SearchExecutor(RES)
        ex.search(ti, q, 5, params=ivf_flat.IvfFlatSearchParams(
            n_probes=6, scan_engine="torch"))
        ex.search(ti, q, 5, params=ivf_flat.IvfFlatSearchParams(
            n_probes=6, scan_engine="auto"))
        assert ex.stats.compile_count == 1
        ex.search(ti, q, 5, params=ivf_flat.IvfFlatSearchParams(n_probes=6),
                  wire_dtype="bf16")
        assert ex.stats.compile_count == 2

    def test_warmup_then_serve(self, int_data):
        _, q = int_data
        _, ti = _pair("flat", 2, int_data)
        sp = ivf_flat.IvfFlatSearchParams(n_probes=6)
        ex = SearchExecutor(RES)
        secs = ex.warmup(ti, buckets=(32,), k=5, params=sp)
        assert secs > 0 and ex.stats.compile_count == 1
        got = ex.search(ti, q, 5, params=sp)
        assert ex.stats.compile_count == 1 and ex.stats.cache_hits == 1
        _assert_bits(got, divf.search(RES, sp, ti, q, 5))

    def test_rejects_filter_and_bad_query_axis(self, int_data):
        from raft_tpu_torch.core.bitset import Bitset
        from raft_tpu_torch.neighbors.filters import BitsetFilter

        x, q = int_data
        _, ti = _pair("flat", 2, int_data)
        ex = SearchExecutor(RES)
        bs = Bitset.from_mask(np.ones(x.shape[0], bool))
        with pytest.raises(RaftError, match="sample_filter"):
            ex.search(ti, q, 5, params=ivf_flat.IvfFlatSearchParams(
                n_probes=4), sample_filter=BitsetFilter(bs))
        with pytest.raises(RaftError, match="query_axis"):
            ex.search(ti, q, 5, params=ivf_flat.IvfFlatSearchParams(
                n_probes=4), query_axis="queries")

    @pytest.mark.parametrize("family", FAMILIES)
    def test_oversized_batch_tiles_through_the_top_bucket(self, int_data,
                                                          family):
        _, q = int_data
        _, ti = _pair(family, 2, int_data)
        _, tsp, direct = _params(family, 6)
        ex = SearchExecutor(RES, min_bucket=8, max_bucket=8)
        got = ex.search(ti, q[:21], K, params=tsp)
        _assert_bits(got, direct(RES, tsp, ti, q[:21], K))
        assert ex.stats.compile_count == 1


class Test2DMeshExecutor:
    @pytest.mark.parametrize("family", FAMILIES)
    def test_bit_identical_to_1d_and_equal_to_jax(self, int_data, family):
        _, q = int_data
        ji2, t2 = _pair(family, 2, int_data, grid=True)
        _, t1 = _pair(family, 2, int_data)
        jsp, tsp, _ = _params(family, 6)
        ex = SearchExecutor(RES)
        got = ex.search(t2, q[:13], K, params=tsp, query_axis="queries")
        _assert_bits(got, ex.search(t1, q[:13], K, params=tsp))
        _assert_jax(got, _jex().search(ji2, q[:13], K, params=jsp,
                                       query_axis="queries"))

    def test_quantized_wires_bit_identical_to_1d(self, int_data):
        _, q = int_data
        _, t2 = _pair("flat", 2, int_data, grid=True)
        _, t1 = _pair("flat", 2, int_data)
        sp = ivf_flat.IvfFlatSearchParams(n_probes=6)
        ex = SearchExecutor(RES)
        kw = dict(wire_dtype="bf16", probe_wire_dtype="int8")
        _assert_bits(ex.search(t2, q, 5, params=sp, query_axis="queries",
                               **kw),
                     ex.search(t1, q, 5, params=sp, **kw))

    def test_zero_recompiles_under_load(self, int_data):
        rng = np.random.default_rng(31)
        _, t2 = _pair("flat", 2, int_data, grid=True)
        sp = ivf_flat.IvfFlatSearchParams(n_probes=6)
        ex = SearchExecutor(RES, min_bucket=16, max_bucket=64)
        ex.warmup(t2, k=5, params=sp, query_axis="queries")
        compiles0 = ex.stats.compile_count
        assert compiles0 == 3
        for n in (16, 13, 9, 64, 33, 9, 13):
            qs = rng.integers(-8, 9, (n, DIM)).astype(np.float32)
            ex.search(t2, qs, 5, params=sp, query_axis="queries")
        assert ex.stats.compile_count == compiles0
        # the padded block rounds up to the grid extent (2 x 2)
        assert {c["bucket"] for c in ex.executable_costs().values()} == {
            16, 32, 64}

    def test_grid_rounds_the_block_to_the_grid_extent(self, int_data):
        _, q = int_data
        _, t2 = _pair("flat", 2, int_data, grid=True)
        _, t1 = _pair("flat", 2, int_data)
        sp = ivf_flat.IvfFlatSearchParams(n_probes=6)
        ex = SearchExecutor(RES, min_bucket=2, max_bucket=8)
        got = ex.search(t2, q[:3], 5, params=sp, query_axis="queries")
        (info,) = ex.executable_costs().values()
        assert info["bucket"] == 4          # bucket 4 is the grid extent
        _assert_bits(got, divf.search(RES, sp, t1, q[:3], 5))

    def test_auto_wire_selection(self, int_data):
        _, q = int_data
        _, t2 = _pair("flat", 2, int_data, grid=True)
        ex = SearchExecutor(RES)
        d, _ = ex.search(t2, q[:16], 5, params=ivf_flat.IvfFlatSearchParams(
            n_probes=6), query_axis="queries", wire_dtype="auto",
            probe_wire_dtype="auto")
        assert tuple(d.shape) == (16, 5)
        (info,) = ex.executable_costs().values()
        model = info["collective_payload"]
        assert (model["wire_dtype"], model["probe_wire_dtype"]) == (
            divf.resolve_auto_wires(16, 5, 6, N_LISTS, 2, "auto", "global",
                                    "auto"))
        assert divf.resolve_auto_wires(
            64, 10, 32, 4096, 8, "auto", "global", "auto")[1] == "int8"


class TestMeshRagged:
    def _blocks(self, seed=3):
        rng = np.random.default_rng(seed)
        return [rng.integers(-8, 9, (m, DIM)).astype(np.float32)
                for m in (3, 5, 2, 9)]

    @pytest.mark.parametrize("probe_mode", ["global", "local"])
    @pytest.mark.parametrize("r", [2, 4])
    def test_flat_bit_identical_and_equal_to_jax(self, int_data, r,
                                                 probe_mode):
        ji, ti = _pair("flat", r, int_data)
        ex = SearchExecutor(RES, ragged_tile=16)
        p1 = ivf_flat.IvfFlatSearchParams(n_probes=5, scan_engine="torch")
        p2 = ivf_flat.IvfFlatSearchParams(n_probes=8, scan_engine="torch")
        assert (ex.ragged_key(ti, 4, params=p1, probe_mode=probe_mode)
                == ex.ragged_key(ti, 7, params=p2, probe_mode=probe_mode))
        blocks = self._blocks()
        ks, ps = [4, 7, 6, 5], [p1, p2, p1, p2]
        res = ex.search_ragged(ti, blocks, ks, params_list=ps,
                               probe_mode=probe_mode)
        jps = [dataclasses.replace(j_ivf_flat.IvfFlatSearchParams(
            scan_engine="xla"), n_probes=p.n_probes) for p in ps]
        want = JExecutor(ragged_tile=16).search_ragged(
            ji, blocks, ks, params_list=jps, probe_mode=probe_mode)
        for b, got, w, kj, pj in zip(blocks, res, want, ks, ps):
            _assert_bits(got, ex.search(ti, b, kj, params=pj,
                                        probe_mode=probe_mode))
            _assert_jax(got, w)
        assert ex.ragged_executables("dist_ivf_flat") == 1

    @pytest.mark.parametrize("family", ["pq", "bq"])
    def test_pq_bq_bit_identical(self, int_data, family):
        _, ti = _pair(family, 4, int_data)
        mk = (ivf_pq.IvfPqSearchParams if family == "pq"
              else ivf_bq.IvfBqSearchParams)
        p1 = mk(n_probes=5, scan_engine="torch")
        p2 = mk(n_probes=8, scan_engine="torch")
        ex = SearchExecutor(RES, ragged_tile=16)
        blocks = self._blocks(seed=5)
        res = ex.search_ragged(ti, blocks, [4, 7, 6, 5],
                               params_list=[p1, p2, p1, p2])
        for b, got, kj, pj in zip(blocks, res, [4, 7, 6, 5],
                                  [p1, p2, p1, p2]):
            _assert_bits(got, ex.search(ti, b, kj, params=pj))
        assert ex.ragged_executables("dist_ivf_" + family) == 1

    def test_zero_recompile_mixed_load_with_accounting(self, int_data):
        _, ti = _pair("flat", 4, int_data)
        ex = SearchExecutor(RES, ragged_tile=16, probe_accounting=True)
        p1 = ivf_flat.IvfFlatSearchParams(n_probes=5)
        p2 = ivf_flat.IvfFlatSearchParams(n_probes=8)
        ex.warmup_ragged(ti, k=7, params=p1)
        blocks = self._blocks(seed=7)
        ex.search_ragged(ti, blocks[:1], 4, params_list=p1)
        c0 = ex.stats.compile_count
        for _ in range(3):
            ex.search_ragged(ti, blocks, [4, 7, 6, 5],
                             params_list=[p1, p2, p1, p2])
        assert ex.stats.compile_count == c0 == 1
        assert ex.ragged_executables() == 1
        planes = ex.probe_frequencies()
        (label,) = planes.keys()
        assert label.startswith("dist_ivf_flat-")
        assert planes[label].sum() == 3 * 5 + 3 * (
            3 * 5 + 5 * 8 + 2 * 5 + 9 * 8)

    def test_mesh_residue_reasons(self, int_data):
        _, ti = _pair("flat", 2, int_data)
        ex = SearchExecutor(RES)
        p = ivf_flat.IvfFlatSearchParams(n_probes=5)
        assert ex.ragged_key(ti, 4, params=p,
                             probe_wire_dtype="int8") is not None
        assert ex.ragged_fallback_reason(
            ti, 4, params=p, probe_wire_dtype="int8") is None
        assert ex.ragged_key(ti, 4, params=p, query_axis="q") is None
        assert "query_axis" in ex.ragged_fallback_reason(
            ti, 4, params=p, query_axis="q")
        assert ex.ragged_key(ti, 4, params=p, wire_dtype="bf16",
                             probe_wire_dtype="bf16") is not None
        assert "family-specific" in ex.ragged_fallback_reason(
            ti, 4, params=p, query_tile=8)
        assert ex.ragged_fallback_reason(
            ti, 4, params=p, sample_filter=np.ones(2400, bool)) == (
            ex._RAGGED_RESIDUE["dist_filter"])
        # the reason strings are the JAX package's own
        assert ex._RAGGED_RESIDUE == JExecutor._RAGGED_RESIDUE

    @pytest.mark.parametrize("wires", [("f32", "int8"), ("bf16", "bf16")])
    def test_quantized_wires_bit_identical(self, int_data, wires):
        _, ti = _pair("flat", 4, int_data)
        ex = SearchExecutor(RES, ragged_tile=16)
        p1 = ivf_flat.IvfFlatSearchParams(n_probes=5)
        p2 = ivf_flat.IvfFlatSearchParams(n_probes=8)
        kw = dict(wire_dtype=wires[0], probe_wire_dtype=wires[1])
        blocks = self._blocks(seed=13)[:2]
        res = ex.search_ragged(ti, blocks, 4, params_list=[p1, p2], **kw)
        for b, got, pj in zip(blocks, res, [p1, p2]):
            _assert_bits(got, ex.search(ti, b, 4, params=pj, **kw))

    def test_batcher_serves_mesh_ragged(self, int_data):
        _, ti = _pair("flat", 4, int_data)
        ex = SearchExecutor(RES, ragged_tile=16)
        p = ivf_flat.IvfFlatSearchParams(n_probes=5)
        blocks = self._blocks(seed=13)
        clock = ManualClock()
        b = DynamicBatcher(ex, BatcherConfig(max_wait_s=0.002, ragged=True),
                           clock=clock, start=False)
        hs = [b.submit(ti, blk, 5, params=p, probe_mode="global")
              for blk in blocks]
        clock.advance(0.01)
        b.pump()
        for h, blk in zip(hs, blocks):
            _assert_bits(h.result(timeout=0),
                         ex.search(ti, blk, 5, params=p,
                                   probe_mode="global"))
        assert ex.ragged_executables("dist_ivf_flat") == 1
        b.close()


class TestMeshProbeAccounting:
    @pytest.mark.parametrize("r", [2, 4])
    def test_counts_and_histogram_equal_jax(self, int_data, r):
        _, q = int_data
        ji, ti = _pair("flat", r, int_data)
        jsp, tsp, direct = _params("flat", 6)
        ex = SearchExecutor(RES, probe_accounting=True)
        got = ex.search(ti, q, 5, params=tsp)
        _assert_bits(got, direct(RES, tsp, ti, q, 5))
        (plane,) = ex.probe_frequencies().values()
        assert plane.shape == (N_LISTS,)
        assert plane.sum() == q.shape[0] * 6
        jex = JExecutor(probe_accounting=True)
        jex.search(ji, q, 5, params=jsp)
        (jplane,) = jex.probe_frequencies().values()
        np.testing.assert_array_equal(plane, jplane)

    def test_histogram_in_own_list_id_space(self, int_data):
        """The plane is the dist index's own list-id space (the dealt
        order): bin for bin a bincount of the coarse selection over the
        concatenated shard centers."""
        _, q = int_data
        _, ti = _pair("flat", 4, int_data)
        ex = SearchExecutor(RES, probe_accounting=True)
        ex.search(ti, q, 5, params=ivf_flat.IvfFlatSearchParams(n_probes=6))
        (plane,) = ex.probe_frequencies().values()
        c = torch.cat(ti.centers)
        score = 2.0 * torch.as_tensor(q) @ c.T - (c * c).sum(1)[None, :]
        order = np.lexsort((np.broadcast_to(np.arange(N_LISTS), score.shape),
                            -score.numpy()), axis=1)[:, :6]
        np.testing.assert_array_equal(
            np.bincount(order.reshape(-1), minlength=N_LISTS), plane)

    def test_zero_recompile_with_accounting(self, int_data):
        _, q = int_data
        _, ti = _pair("flat", 4, int_data)
        sp = ivf_flat.IvfFlatSearchParams(n_probes=6)
        ex = SearchExecutor(RES, probe_accounting=True)
        for n in (16, 13, 9):
            ex.search(ti, q[:n], 5, params=sp)
        compiles0 = ex.stats.compile_count
        for n in (16, 13, 9, 13, 16, 9):
            ex.search(ti, q[:n], 5, params=sp)
        assert ex.stats.compile_count == compiles0 == 1
        (plane,) = ex.probe_frequencies().values()
        assert plane.sum() == 3 * (16 + 13 + 9) * 6

    @pytest.mark.parametrize("family", ["pq", "bq"])
    def test_pq_and_bq_accounting_equal_jax(self, int_data, family):
        _, q = int_data
        ji, ti = _pair(family, 4, int_data)
        jsp, tsp, direct = _params(family, 6)
        ex = SearchExecutor(RES, probe_accounting=True)
        got = ex.search(ti, q, 5, params=tsp)
        _assert_bits(got, direct(RES, tsp, ti, q, 5))
        (plane,) = ex.probe_frequencies().values()
        assert plane.sum() == q.shape[0] * 6
        jex = JExecutor(probe_accounting=True)
        jex.search(ji, q, 5, params=jsp)
        (jplane,) = jex.probe_frequencies().values()
        np.testing.assert_array_equal(plane, jplane)

    def test_2d_plans_skip_accounting(self, int_data):
        _, q = int_data
        _, t2 = _pair("flat", 2, int_data, grid=True)
        ex = SearchExecutor(RES, probe_accounting=True)
        ex.search(t2, q[:8], 5, params=ivf_flat.IvfFlatSearchParams(
            n_probes=6), query_axis="queries")
        assert ex.probe_frequencies() == {}


class TestMeshSpans:
    def test_executor_mesh_span_tree(self, int_data):
        _, q = int_data
        _, ti = _pair("flat", 4, int_data)
        tracing.reset_spans()
        tracing.reset_gauges("serving.mesh.")
        sp = ivf_flat.IvfFlatSearchParams(n_probes=6)
        ex = SearchExecutor(RES, mesh_trace=True)
        tid = tracing.new_trace_id()
        got = ex.search(ti, q[:16], 5, params=sp, trace_ids=(tid,))
        _assert_bits(got, divf.search(RES, sp, ti, q[:16], 5))
        rec = tracing.span_recorder()
        model = divf.collective_payload_model(16, 5, 6, N_LISTS, 4)
        (cs,) = rec.spans(trace_id=tid, name="serving.mesh.coarse_select")
        assert cs.attrs["wire_bytes"] == model["coarse_bytes"]
        (mg,) = rec.spans(trace_id=tid, name="serving.mesh.merge")
        assert mg.attrs["wire_bytes"] == model["merge_bytes"]
        (sc,) = rec.spans(trace_id=tid, name="serving.mesh.scan")
        # the three phases span one reading: the merged outputs'
        # readiness
        assert cs.duration == sc.duration == mg.duration > 0
        assert all(s.attrs["family"] == "dist_ivf_flat"
                   for s in (cs, sc, mg))
        # one span a slot from that slot's own reading (the host clock
        # after its scan on the CPU), none past the merged readiness,
        # reduced into the straggler gauges
        shards = rec.spans(trace_id=tid, name="serving.mesh.shard")
        assert [s.attrs["shard"] for s in shards] == [0, 1, 2, 3]
        offs = [s.duration for s in shards]
        assert len(set(offs)) == 4 and max(offs) <= mg.duration
        stats = tracing.straggler_stats(offs)
        g = tracing.gauges("serving.mesh.")
        assert g[tracing.MESH_SLOWEST_SHARD] == stats["slowest_shard"]
        assert g[tracing.MESH_SHARD_SKEW] == stats["shard_skew"]

    def test_zero_recompiles_with_mesh_tracing(self, int_data):
        _, q = int_data
        _, ti = _pair("flat", 4, int_data)
        sp = ivf_flat.IvfFlatSearchParams(n_probes=6)
        ex = SearchExecutor(RES, mesh_trace=True)
        tid = tracing.new_trace_id()
        d0 = tracing.get_counter("serving.mesh.dispatches")
        for n in (16, 13, 9, 13, 16):
            ex.search(ti, q[:n], 5, params=sp, trace_ids=(tid,))
        assert ex.stats.compile_count == 1
        assert tracing.get_counter("serving.mesh.dispatches") == d0 + 5
        assert len(tracing.span_recorder().spans(
            trace_id=tid, name="serving.mesh.merge")) == 5

    def test_untraced_and_ragged_dispatches_record_nothing(self, int_data):
        _, q = int_data
        _, ti = _pair("flat", 4, int_data)
        sp = ivf_flat.IvfFlatSearchParams(n_probes=6)
        tracing.reset_spans()
        SearchExecutor(RES).search(ti, q, 5, params=sp)
        SearchExecutor(RES, mesh_trace=True, ragged_tile=16).search_ragged(
            ti, [q[:4]], 5, params_list=sp)
        for phase in ("coarse_select", "scan", "merge", "shard"):
            assert tracing.span_recorder().spans(
                name=f"serving.mesh.{phase}") == []

    def test_collective_counters_count_every_dispatch(self, int_data):
        """The port's collectives run per call (eager here, replayed on
        the card), so the inventory grows by the same amount each
        dispatch, where the JAX package counts them once per trace."""
        _, q = int_data
        _, ti = _pair("flat", 4, int_data)
        sp = ivf_flat.IvfFlatSearchParams(n_probes=6)
        ex = SearchExecutor(RES)
        ex.warmup(ti, buckets=(32,), k=5, params=sp)
        c0 = tracing.get_counter("comms.allgather.calls")
        ex.search(ti, q, 5, params=sp)
        c1 = tracing.get_counter("comms.allgather.calls")
        ex.search(ti, q, 5, params=sp)
        assert c1 > c0
        assert tracing.get_counter("comms.allgather.calls") - c1 == c1 - c0


class TestPayloadGauges:
    def test_mesh_entry_publishes_collective_gauges(self, int_data):
        _, q = int_data
        _, ti = _pair("flat", 4, int_data)
        tracing.reset_gauges("serving.collective.")
        ex = SearchExecutor(RES)
        ex.search(ti, q[:16], 5, params=ivf_flat.IvfFlatSearchParams(
            n_probes=6), wire_dtype="bf16")
        base = "serving.collective.dist_ivf_flat.bf16.f32."
        got = tracing.gauges(base)
        assert set(n.rsplit(".", 1)[1] for n in got) == {
            "coarse_bytes", "dense_coarse_bytes", "merge_bytes"}
        model = divf.collective_payload_model(16, 5, 6, N_LISTS, 4, "bf16")
        assert got[base + "merge_bytes"] == model["merge_bytes"]
        assert got[base + "coarse_bytes"] == model["coarse_bytes"]
        (info,) = ex.executable_costs().values()
        assert info["collective_payload"]["merge_bytes"] == (
            model["merge_bytes"])
        tracing.reset_gauges("serving.")
        assert tracing.gauges(base) == {}
        ex.publish_cost_gauges()
        assert tracing.gauges(base)[base + "merge_bytes"] == (
            model["merge_bytes"])

    def test_payload_gauges_equal_jax(self, int_data):
        _, q = int_data
        ji, ti = _pair("flat", 2, int_data)
        jsp, tsp, _ = _params("flat", 6)
        import raft_tpu.core.tracing as j_tracing

        j_tracing.reset_gauges("serving.collective.")
        tracing.reset_gauges("serving.collective.")
        JExecutor().search(ji, q[:16], 5, params=jsp, wire_dtype="bf16")
        SearchExecutor(RES).search(ti, q[:16], 5, params=tsp,
                                   wire_dtype="bf16")
        assert tracing.gauges("serving.collective.") == j_tracing.gauges(
            "serving.collective.")


class TestMeshCosts:
    def test_modeled_cost_counts_by_hand(self, int_data):
        """The mesh IVF-Flat model: queries and centers read, the coarse
        GEMM, the lists a bucket's probes can touch, the results, and
        every slot's collective payload."""
        _, q = int_data
        _, ti = _pair("flat", 2, int_data)
        ex = SearchExecutor(RES)
        tracing.reset_counters("serving.execute.modeled")
        ex.search(ti, q[:16], 5, params=ivf_flat.IvfFlatSearchParams(
            n_probes=6))
        (info,) = ex.executable_costs().values()
        live = sum(int(s.sum()) for s in ti.list_sizes)
        assert live == 2400
        rows, n_probes = 16, 6
        # every list touched (16 x 6 probes > 16 lists): each live row read
        # once; each query scans 6 lists of the mean 150 rows
        model = divf.collective_payload_model(rows, 5, n_probes, N_LISTS, 2)
        want_bytes = (4 * rows * DIM + 4 * N_LISTS * (DIM + 1)
                      + live * (4 * DIM + 4 + 4) + 8 * rows * 5
                      + 2 * (model["coarse_bytes"] + model["merge_bytes"]))
        want_flops = (2 * rows * N_LISTS * DIM
                      + rows * n_probes * (live / N_LISTS) * 2 * DIM)
        assert info["bytes_accessed"] == pytest.approx(want_bytes,
                                                        rel=1e-12)
        assert info["flops"] == pytest.approx(want_flops, rel=1e-12)
        assert info["hlo_module"] == "rt_dist_ivf_flat_" + next(
            iter(ex.executable_costs()))
        assert tracing.get_counter(
            "serving.execute.modeled_bytes") == info["bytes_accessed"]
        assert tracing.get_counter(
            "serving.execute.modeled_flops") == info["flops"]


class TestBqFusedMeshExecutor:
    @pytest.mark.parametrize("q_rows", [3, 11, 16])
    def test_executor_bucketing_invariance(self, int_data, q_rows):
        _, q = int_data
        ji, ti = _pair("bq", 2, int_data)
        jsp, tsp, direct = _params("bq", 6)
        ex = SearchExecutor(RES)
        got = ex.search(ti, q[:q_rows], 5, params=tsp)
        _assert_bits(got, direct(RES, tsp, ti, q[:q_rows], 5))
        _assert_jax(got, _jex().search(ji, q[:q_rows], 5, params=jsp))

    def test_executor_zero_recompile(self, int_data):
        _, q = int_data
        _, ti = _pair("bq", 2, int_data)
        sp = ivf_bq.IvfBqSearchParams(n_probes=6)
        ex = SearchExecutor(RES)
        for n in (16, 13, 9, 13, 16):
            ex.search(ti, q[:n], 5, params=sp)
        assert ex.stats.compile_count == 1
        ex.search(ti, q[:16], 5, params=dataclasses.replace(sp,
                                                            epsilon=2.0))
        assert ex.stats.compile_count == 2


def test_executor_serves_quantized_probe_wire(int_data):
    _, q = int_data
    ji, ti = _pair("flat", 4, int_data)
    jsp, tsp, _ = _params("flat", 4)
    want = divf.search(RES, tsp, ti, q, 10, probe_wire_dtype="int8")
    got = SearchExecutor(RES).search(ti, q, 10, params=tsp,
                                     probe_wire_dtype="int8")
    _assert_bits(got, want)
    _assert_jax(got, _jex().search(ji, q, 10, params=jsp,
                                   probe_wire_dtype="int8"))


def test_index_gauge_over_a_mesh_index(int_data):
    """The index gauge on a list-sharded index: health from the slots'
    list sizes (``shard_imbalance`` over the slots), drift paired with
    the mesh probe plane through ``probe_label``."""
    from raft_tpu_torch.serving import DriftDetector, IndexGauge

    _, q = int_data
    ji, ti = _pair("flat", 4, int_data)
    ex = SearchExecutor(RES, probe_accounting=True)
    det = DriftDetector.from_index(ti)
    gauge = IndexGauge(executor=ex, indexes={"mesh": ti},
                       drift={"mesh": det})
    ex.search(ti, q, 5, params=ivf_flat.IvfFlatSearchParams(n_probes=6))
    out = gauge.publish()
    sizes = np.concatenate(_shards(ji.list_sizes))
    import raft_tpu.core.tracing as j_tracing

    assert out["health"]["mesh"] == j_tracing.index_health(
        sizes, ti.max_list_size, 4)
    assert out["drift"]["mesh"]["score"] == pytest.approx(
        tracing.js_divergence(ex.probe_frequencies()[ex.probe_label(ti)],
                              sizes))
