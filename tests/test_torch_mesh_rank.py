"""The rank-major engines of the list-sharded shard bodies against the JAX
mesh rank engines (``raft_tpu/distributed/ivf.py`` flat and PQ,
``raft_tpu/distributed/bq.py``), and the positional merge they need.

Each JAX index is built on R virtual CPU devices from integer-valued data
with its coarse centers (and PQ codebooks) rounded to integers, and
crosses to the port as per-shard numpy arrays, as
``tests/test_torch_distributed.py`` carries the list-major ones. Both
sides then run ``scan_engine="rank"``: ids equal, distances within rtol
1e-6 / atol 1e-5 (that file's tolerance). Integer data makes exact
distance ties common, so these cases hold the positional tie order (rank
order within a shard, shard order across the merge), not the
lexicographic one. IVF-BQ's rotation is replaced by the identity on both
sides, so that its rotated residuals are exact before their bfloat16
cast. A codes-only IVF-BQ index (``store_vectors=False``)
resolves to the rank engine on both sides, and the executor's rank-engine
mesh plan equals the direct search bit for bit.
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
from raft_tpu.comms import Comms as JComms
from raft_tpu.comms.bootstrap import make_mesh as j_make_mesh
from raft_tpu.distance.types import DistanceType as JDT
from raft_tpu_torch import Resources, SearchExecutor
from raft_tpu_torch.comms import local_comms
from raft_tpu_torch.distributed import bq as dbq
from raft_tpu_torch.distributed import ivf as divf
from raft_tpu_torch.neighbors import ivf_bq, ivf_flat, ivf_pq

RES = Resources(device="cpu", seed=0)
N_LISTS, DIM, K, N_PROBES = 16, 32, 7, 6


@pytest.fixture(scope="module")
def int_data():
    rng = np.random.default_rng(5)
    centers = rng.integers(-12, 13, (24, DIM))
    lab = rng.integers(0, 24, 2400)
    x = (centers[lab] + rng.integers(-2, 3, (2400, DIM))).astype(np.float32)
    q = (centers[rng.integers(0, 24, 24)]
         + rng.integers(-2, 3, (24, DIM))).astype(np.float32)
    return x, q


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


def _shards(a):
    blocks = {}
    for s in a.addressable_shards:
        blocks.setdefault(s.index[0].start or 0, np.asarray(s.data))
    return [blocks[k] for k in sorted(blocks)]


def _rounded(jidx, name):
    arr = getattr(jidx, name)
    return dataclasses.replace(
        jidx, **{name: jax.device_put(jnp.round(arr), arr.sharding)})


_CACHE = {}


def _pair(family, r, metric, data, grid=False, store_vectors=True):
    """(JAX index, port index) of one configuration, cached."""
    key = (family, r, metric, grid, store_vectors)
    if key in _CACHE:
        return _CACHE[key]
    x, _ = data
    jc, tc = _jcomms(r, grid), _tcomms(r, grid)
    jm = JDT[metric]
    if family == "flat":
        ji = _rounded(j_divf.build(None, jc, j_ivf_flat.IvfFlatIndexParams(
            n_lists=N_LISTS, metric=jm), x), "centers")
        ti = divf.from_numpy(
            tc, _shards(ji.centers), _shards(ji.data), _shards(ji.indices),
            _shards(ji.list_sizes), int(ji.metric),
            data_norms=_shards(ji.data_norms))
    elif family == "pq":
        ji = j_divf.build_pq(None, jc, j_ivf_pq.IvfPqIndexParams(
            n_lists=N_LISTS, pq_dim=8, pq_bits=4, metric=jm), x)
        ji = _rounded(_rounded(ji, "codebooks"), "centers")
        ti = divf.from_numpy_pq(
            tc, _shards(ji.centers), np.asarray(ji.rotation),
            np.asarray(ji.codebooks), _shards(ji.codes), _shards(ji.indices),
            _shards(ji.list_sizes), int(ji.metric), ji.pq_bits,
            int(ji.codebook_kind))
    else:
        ji = _rounded(j_dbq.build_bq(None, jc, j_ivf_bq.IvfBqIndexParams(
            n_lists=N_LISTS, metric=jm, store_vectors=store_vectors), x),
            "centers")
        # the identity as the rotation on both sides: the rotated residual
        # is then exact before its bfloat16 cast, which an ulp of a float
        # product would otherwise flip
        ji = dataclasses.replace(ji, rotation=jax.device_put(
            jnp.eye(*ji.rotation.shape, dtype=jnp.float32),
            ji.rotation.sharding))
        ti = dbq.from_numpy_bq(
            tc, _shards(ji.centers), np.asarray(ji.rotation),
            _shards(ji.codes), _shards(ji.rnorm), _shards(ji.cfac),
            _shards(ji.errw), _shards(ji.indices), _shards(ji.list_sizes),
            int(ji.metric),
            None if ji.data is None else _shards(ji.data), ji.shard_rel_err)
    _CACHE[key] = (ji, ti)
    return ji, ti


def _searches(family, engine="rank"):
    """(JAX search, JAX params, port search, port params) at ``engine``."""
    if family == "flat":
        return (j_divf.search, j_ivf_flat.IvfFlatSearchParams(
            n_probes=N_PROBES, scan_engine=engine), divf.search,
            ivf_flat.IvfFlatSearchParams(n_probes=N_PROBES,
                                         scan_engine=engine))
    if family == "pq":
        return (j_divf.search_pq, j_ivf_pq.IvfPqSearchParams(
            n_probes=N_PROBES, scan_engine=engine), divf.search_pq,
            ivf_pq.IvfPqSearchParams(n_probes=N_PROBES, scan_engine=engine))
    return (j_dbq.search_bq, j_ivf_bq.IvfBqSearchParams(
        n_probes=N_PROBES, scan_engine=engine), dbq.search_bq,
        ivf_bq.IvfBqSearchParams(n_probes=N_PROBES, scan_engine=engine))


def _assert_same(got, want):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("family", ["flat", "pq", "bq"])
@pytest.mark.parametrize("r,metric", [(2, "L2Expanded"), (4, "L2Expanded"),
                                      (4, "InnerProduct")])
def test_rank_engine_equals_jax_mesh_rank(int_data, family, r, metric):
    _, q = int_data
    ji, ti = _pair(family, r, metric, int_data)
    jfn, jsp, tfn, tsp = _searches(family)
    _assert_same(tfn(RES, tsp, ti, q, K), jfn(None, jsp, ji, q, K))


@pytest.mark.parametrize("family", ["flat", "pq", "bq"])
def test_rank_engine_on_a_2x2_grid_equals_jax(int_data, family):
    """The 2-D form: queries over a second axis, the positional merge as
    the scatter-merge's fold."""
    _, q = int_data
    ji, ti = _pair(family, 2, "L2Expanded", int_data, grid=True)
    jfn, jsp, tfn, tsp = _searches(family)
    _assert_same(tfn(RES, tsp, ti, q, K, query_axis="queries"),
                 jfn(None, jsp, ji, q, K, query_axis="queries"))


def test_rank_engine_bf16_wire_equals_jax(int_data):
    _, q = int_data
    ji, ti = _pair("flat", 4, "L2Expanded", int_data)
    jfn, jsp, tfn, tsp = _searches("flat")
    _assert_same(tfn(RES, tsp, ti, q, K, wire_dtype="bf16"),
                 jfn(None, jsp, ji, q, K, wire_dtype="bf16"))


@pytest.mark.parametrize("r", [2, 4])
def test_codes_only_bq_index_searches_as_jax(int_data, r):
    """A codes-only distributed IVF-BQ index resolves to the rank-major
    estimate scan on both sides and answers at the overfetch depth."""
    _, q = int_data
    ji, ti = _pair("bq", r, "L2Expanded", int_data, store_vectors=False)
    assert ti.data is None
    sp = ivf_bq.IvfBqSearchParams(n_probes=N_PROBES)
    assert dbq.resolve_bq_serving_engine(sp, ti, K) == "rank"
    depth = dbq.merge_overfetch(ti, K)
    assert depth == j_dbq.merge_overfetch(ji, K) > K
    _assert_same(dbq.search_bq(RES, sp, ti, q, depth),
                 j_dbq.search_bq(None, j_ivf_bq.IvfBqSearchParams(
                     n_probes=N_PROBES), ji, q, depth))


def test_codes_only_bq_equals_the_full_index_rank_search(int_data):
    """``store_vectors=False`` drops only the rerank plane: the codes-only
    index's search equals the rank search of the index that keeps it."""
    _, q = int_data
    _, full = _pair("bq", 4, "L2Expanded", int_data)
    codes_only = dataclasses.replace(full, data=None, data_norms=None)
    got = dbq.search_bq(RES, ivf_bq.IvfBqSearchParams(n_probes=N_PROBES),
                        codes_only, q, K)
    want = dbq.search_bq(RES, ivf_bq.IvfBqSearchParams(
        n_probes=N_PROBES, scan_engine="rank"), full, q, K)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("family", ["flat", "pq", "bq"])
def test_executor_rank_mesh_plan_equals_direct_search(int_data, family):
    _, q = int_data
    _, ti = _pair(family, 4, "L2Expanded", int_data)
    _, _, tfn, tsp = _searches(family)
    ex = SearchExecutor(RES)
    for n in (16, 11, 24):
        got = ex.search(ti, q[:n], K, params=tsp)
        want = tfn(RES, tsp, ti, q[:n], K)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ex.stats.compile_count == 2          # buckets 16 and 32
    # the ragged front keeps rank plans bucketed, as the JAX executor does
    assert ex.ragged_key(ti, K, params=tsp) is None


def test_positional_merge_equals_jax_merge_candidates():
    """``_merge_candidates(smallest_id_ties=False)``: the rank engines'
    positional order (equal distances keep their stack position), ids as
    they are, against the JAX function on a stack full of ties."""
    rng = np.random.default_rng(3)
    d = rng.integers(0, 4, (3, 9, 5)).astype(np.float32)
    d[:, :, -1] = np.inf
    i = rng.integers(-1, 50, (3, 9, 5)).astype(np.int32)
    for select_min in (True, False):
        for ties in (True, False):
            wd, wi = j_divf._merge_candidates(jnp.asarray(d), jnp.asarray(i),
                                              5, select_min, ties)
            gd, gi = divf._merge_candidates(torch.as_tensor(d),
                                            torch.as_tensor(i), 5,
                                            select_min, ties)
            np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
            np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
