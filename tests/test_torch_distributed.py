"""raft_tpu_torch.distributed against raft_tpu.distributed, and against
the port's own single-device indexes.

- **JAX-carried indexes.** The JAX package builds each list-sharded
  index on R virtual CPU devices (R in {2, 4, 8}); its per-shard arrays
  cross as numpy (``from_numpy*``), with the coarse centers (and PQ
  codebooks) rounded to integers on both sides and integer-valued data
  and queries, so every product is exact. The port's searches (the
  plain list-major engines) then give the JAX searches' (``xla``
  engines) ids, and distances within rtol 1e-6 (the sums are exact; the
  tolerance covers the sqrt and clamp epilogs). Checkpoints the JAX
  package writes load into the port and the other way round.
- **Port against port.** ``probe_mode="global"`` on the f32 wires is
  bit-identical to the port's single-device search of the same index, at
  every R, on Gaussian data.
- **The rest.** k-means and the builds by inertia and recall (their
  generators differ from JAX's); sharded ANN; the payload models equal
  to JAX's dicts; the straggler helpers on scripted timings; the steps of
  the multi-chip dry run; a two-process gloo run.
"""

import dataclasses
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import raft_tpu.core.tracing as j_tracing
import raft_tpu.distributed.bq as j_dbq
import raft_tpu.distributed.checkpoint as j_ckpt
import raft_tpu.distributed.ivf as j_divf
import raft_tpu.distributed.kmeans as j_dkm
import raft_tpu.neighbors.ivf_bq as j_ivf_bq
import raft_tpu.neighbors.ivf_flat as j_ivf_flat
import raft_tpu.neighbors.ivf_pq as j_ivf_pq
from raft_tpu.comms import Comms as JComms
from raft_tpu.comms.bootstrap import make_mesh as j_make_mesh
from raft_tpu.distance.types import DistanceType as JDT
from raft_tpu_torch import Resources
from raft_tpu_torch.comms import local_comms
from raft_tpu_torch.core import tracing
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.distributed import bq as dbq
from raft_tpu_torch.distributed import checkpoint as ckpt
from raft_tpu_torch.distributed import ivf as divf
from raft_tpu_torch.distributed import kmeans as dkm
from raft_tpu_torch.distributed import knn as dknn
from raft_tpu_torch.distributed import sharded_ann
from raft_tpu_torch.neighbors import brute_force, ivf_bq, ivf_flat, ivf_pq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = Resources(device="cpu", seed=0)
R_VALUES = [2, 4, 8]
N_LISTS, DIM, K = 16, 32, 7


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
    rng = np.random.default_rng(5)
    centers = rng.integers(-12, 13, (24, DIM))
    lab = rng.integers(0, 24, 2400)
    x = (centers[lab] + rng.integers(-2, 3, (2400, DIM))).astype(np.float32)
    q = (centers[rng.integers(0, 24, 24)]
         + rng.integers(-2, 3, (24, DIM))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def gauss_data():
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((3000, DIM)) * 2).astype(np.float32)
    q = rng.standard_normal((24, DIM)).astype(np.float32)
    return x, q


def _shards(a):
    """A JAX list-sharded array's per-shard blocks, in rank order (the
    first device of each block on a 2-D mesh)."""
    blocks = {}
    for s in a.addressable_shards:
        start = s.index[0].start or 0
        blocks.setdefault(start, np.asarray(s.data))
    return [blocks[k] for k in sorted(blocks)]


def _round_field(jidx, name):
    arr = getattr(jidx, name)
    return dataclasses.replace(
        jidx, **{name: jax.device_put(jnp.round(arr), arr.sharding)})


_JAX_CACHE = {}


def _jax_index(family, r, metric, int_data, grid=False):
    """A JAX list-sharded index on integer data with integer centers
    (and codebooks), cached per configuration."""
    key = (family, r, metric, grid)
    if key in _JAX_CACHE:
        return _JAX_CACHE[key]
    x, _ = int_data
    jc = _jcomms(r, grid)
    jm = JDT[metric]
    if family == "flat":
        ji = j_divf.build(None, jc, j_ivf_flat.IvfFlatIndexParams(
            n_lists=N_LISTS, metric=jm), x)
    elif family == "pq":
        ji = j_divf.build_pq(None, jc, j_ivf_pq.IvfPqIndexParams(
            n_lists=N_LISTS, pq_dim=8, pq_bits=4, metric=jm), x)
        ji = _round_field(ji, "codebooks")
    else:
        ji = j_dbq.build_bq(None, jc, j_ivf_bq.IvfBqIndexParams(
            n_lists=N_LISTS, metric=jm), x)
    ji = _round_field(ji, "centers")
    _JAX_CACHE[key] = ji
    return ji


def _carry(family, ji, tcomms):
    """The port's index from a JAX index's per-shard arrays."""
    if family == "flat":
        return divf.from_numpy(
            tcomms, _shards(ji.centers), _shards(ji.data),
            _shards(ji.indices), _shards(ji.list_sizes), int(ji.metric),
            data_norms=_shards(ji.data_norms))
    if family == "pq":
        return divf.from_numpy_pq(
            tcomms, _shards(ji.centers), np.asarray(ji.rotation),
            np.asarray(ji.codebooks), _shards(ji.codes),
            _shards(ji.indices), _shards(ji.list_sizes), int(ji.metric),
            ji.pq_bits, int(ji.codebook_kind))
    return dbq.from_numpy_bq(
        tcomms, _shards(ji.centers), np.asarray(ji.rotation),
        _shards(ji.codes), _shards(ji.rnorm), _shards(ji.cfac),
        _shards(ji.errw), _shards(ji.indices), _shards(ji.list_sizes),
        int(ji.metric), _shards(ji.data), ji.shard_rel_err)


def _searches(family, n_probes):
    """(jax search fn, jax params, port search fn, port params)."""
    if family == "flat":
        return (j_divf.search, j_ivf_flat.IvfFlatSearchParams(
            n_probes=n_probes, scan_engine="xla"), divf.search,
            ivf_flat.IvfFlatSearchParams(n_probes=n_probes,
                                         scan_engine="torch"))
    if family == "pq":
        return (j_divf.search_pq, j_ivf_pq.IvfPqSearchParams(
            n_probes=n_probes, scan_engine="xla"), divf.search_pq,
            ivf_pq.IvfPqSearchParams(n_probes=n_probes,
                                     scan_engine="torch"))
    return (j_dbq.search_bq, j_ivf_bq.IvfBqSearchParams(
        n_probes=n_probes, scan_engine="xla"), dbq.search_bq,
        ivf_bq.IvfBqSearchParams(n_probes=n_probes, scan_engine="torch"))


def _assert_same(got, want):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------------------
# JAX-carried indexes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("r", R_VALUES)
@pytest.mark.parametrize("family", ["flat", "pq", "bq"])
@pytest.mark.parametrize("metric", ["L2Expanded", "InnerProduct"])
@pytest.mark.parametrize("probe_mode", ["global", "local"])
def test_search_on_jax_carried_index_equals_jax(int_data, r, family, metric,
                                                probe_mode):
    _, q = int_data
    ji = _jax_index(family, r, metric, int_data)
    ti = _carry(family, ji, _tcomms(r))
    jfn, jsp, tfn, tsp = _searches(family, 6)
    want = jfn(None, jsp, ji, q, K, probe_mode=probe_mode)
    got = tfn(RES, tsp, ti, q, K, probe_mode=probe_mode)
    _assert_same(got, want)


@pytest.mark.parametrize("r", R_VALUES)
@pytest.mark.parametrize("wire,probe_wire", [("bf16", "f32"),
                                             ("f32", "bf16"),
                                             ("f32", "int8"),
                                             ("bf16", "int8")])
def test_wires_equal_jax(int_data, r, wire, probe_wire):
    _, q = int_data
    ji = _jax_index("flat", r, "L2Expanded", int_data)
    ti = _carry("flat", ji, _tcomms(r))
    jfn, jsp, tfn, tsp = _searches("flat", 5)
    kw = dict(wire_dtype=wire, probe_wire_dtype=probe_wire)
    want = jfn(None, jsp, ji, q, K, **kw)
    got = tfn(RES, tsp, ti, q, K, **kw)
    _assert_same(got, want)


@pytest.mark.parametrize("family", ["flat", "pq"])
def test_dense_probe_exchange_equals_jax(int_data, family):
    """Probing most of a shard takes the dense coarse-block gather."""
    _, q = int_data
    ji = _jax_index(family, 4, "L2Expanded", int_data)
    ti = _carry(family, ji, _tcomms(4))
    jfn, jsp, tfn, tsp = _searches(family, 12)
    _assert_same(tfn(RES, tsp, ti, q, K, probe_wire_dtype="int8"),
                 jfn(None, jsp, ji, q, K, probe_wire_dtype="int8"))


@pytest.mark.parametrize("r", [2, 4])
def test_coarse_approx_equals_jax(int_data, r):
    """The port runs ``coarse_algo="approx"`` exactly; the JAX package's
    approximate top-k is exact on the CPU."""
    _, q = int_data
    ji = _jax_index("flat", r, "L2Expanded", int_data)
    ti = _carry("flat", ji, _tcomms(r))
    jsp = j_ivf_flat.IvfFlatSearchParams(n_probes=5, scan_engine="xla",
                                         coarse_algo="approx")
    tsp = ivf_flat.IvfFlatSearchParams(n_probes=5, scan_engine="torch",
                                       coarse_algo="approx")
    _assert_same(divf.search(RES, tsp, ti, q, K),
                 j_divf.search(None, jsp, ji, q, K))


@pytest.mark.parametrize("r", [2, 4])
@pytest.mark.parametrize("family", ["flat", "pq", "bq"])
def test_2d_grid_equals_jax(int_data, r, family):
    _, q = int_data
    ji = _jax_index(family, r, "L2Expanded", int_data, grid=True)
    ti = _carry(family, ji, _tcomms(r, grid=True))
    jfn, jsp, tfn, tsp = _searches(family, 6)
    want = jfn(None, jsp, ji, q, K, query_axis="queries")
    got = tfn(RES, tsp, ti, q, K, query_axis="queries")
    _assert_same(got, want)
    # and equal to the 1-D form of the same index, bit for bit
    one_d = _carry(family, _jax_index(family, r, "L2Expanded", int_data),
                   _tcomms(r))
    flat = tfn(RES, tsp, one_d, q, K)
    assert torch.equal(got[1], flat[1]) and torch.equal(got[0], flat[0])


def _ragged_budgets(q):
    return torch.as_tensor(np.tile([2, 5, 0, 6], q // 4 + 1)[:q],
                           dtype=torch.int32)


@pytest.mark.parametrize("r", [2, 4])
@pytest.mark.parametrize("family", ["flat", "pq", "bq"])
@pytest.mark.parametrize("probe_mode", ["global", "local"])
def test_ragged_bodies_equal_jax(int_data, r, family, probe_mode):
    """A packed tile with per-row budgets (0 on pad rows) through the
    ragged bodies, against the JAX ragged bodies, and each row against
    its solo search at its own budget."""
    _, q = int_data
    ji = _jax_index(family, r, "L2Expanded", int_data)
    ti = _carry(family, ji, _tcomms(r))
    rp = _ragged_budgets(q.shape[0])
    cap = int(rp.max())
    n_probes = divf.resolve_probe_budget(cap, N_LISTS, r, probe_mode)
    jkw = dict(axis="data", mesh=ji.comms.mesh, n_probes=n_probes, k=K,
               metric=ji.metric, probe_mode=probe_mode, scan_engine="xla")
    tkw = dict(comms=ti.comms, n_probes=n_probes, k=K, metric=ti.metric,
               probe_mode=probe_mode, scan_engine="torch")
    qj, rj = jnp.asarray(q), jnp.asarray(rp.numpy())
    static = tuple(jkw)
    if family == "flat":
        want = jax.jit(j_divf._dist_search_ragged_fn,
                       static_argnames=static)(
            qj, rj, ji.centers, ji.data, ji.data_norms, ji.indices, **jkw)
        got = divf._dist_search_ragged_fn(
            torch.as_tensor(q), rp, ti.centers, ti.center_norms, ti.data,
            ti.data_norms, ti.indices, **tkw)
    elif family == "pq":
        want = jax.jit(j_divf._dist_search_ragged_pq_fn,
                       static_argnames=static)(
            qj, rj, ji.centers, ji.rotation, ji.codebooks, ji.codes,
            ji.indices, **jkw)
        got = divf._dist_search_ragged_pq_fn(
            torch.as_tensor(q), rp, ti.centers, ti.center_norms, ti.rotation,
            ti.codebooks, ti.codes, ti.indices, **tkw)
    else:
        want = jax.jit(j_dbq._dist_search_ragged_bq_fn,
                       static_argnames=static)(
            qj, rj, ji.centers, ji.rotation, ji.codes, ji.rnorm, ji.cfac,
            ji.errw, ji.indices, ji.data, ji.data_norms, **jkw)
        got = dbq._dist_search_ragged_bq_fn(
            torch.as_tensor(q), rp, ti.centers, ti.center_norms,
            ti.centers_rot, ti.rotation, ti.codes, ti.rnorm, ti.cfac,
            ti.errw, ti.indices, ti.data, ti.data_norms, **tkw)
    _assert_same(got, want)
    if probe_mode == "global":
        _, _, tfn, tsp = _searches(family, 1)
        for b in sorted(set(rp.tolist()) - {0}):
            rows = (rp == b).nonzero().squeeze(1)
            solo = tfn(RES, dataclasses.replace(tsp, n_probes=b), ti,
                       torch.as_tensor(q)[rows], K)
            assert torch.equal(got[1][rows], solo[1])
        assert bool((got[1][rp == 0] == -1).all())


@pytest.mark.parametrize("r", R_VALUES)
@pytest.mark.parametrize("family", ["flat", "pq", "bq"])
def test_jax_checkpoint_loads_into_the_port(tmp_path, int_data, r, family):
    """A JAX-written checkpoint loads into the port (re-dealt for the
    target mesh) and searches as the JAX package's own restore does."""
    _, q = int_data
    ji = _jax_index(family, r, "L2Expanded", int_data)
    save, load = {"flat": ("save_flat", "load_flat"),
                  "pq": ("save_pq", "load_pq"),
                  "bq": ("save_bq", "load_bq")}[family]
    path = tmp_path / "j.ckpt"
    getattr(j_ckpt, save)(ji, str(path))
    jl = getattr(j_ckpt, load)(None, _jcomms(r), str(path))
    tl = getattr(ckpt, load)(RES, _tcomms(r), str(path))
    jfn, jsp, tfn, tsp = _searches(family, 6)
    _assert_same(tfn(RES, tsp, tl, q, K), jfn(None, jsp, jl, q, K))
    if family == "bq":
        assert tl.shard_rel_err == pytest.approx(jl.shard_rel_err,
                                                 rel=1e-6)


@pytest.mark.parametrize("family", ["flat", "pq", "bq"])
def test_port_checkpoint_loads_into_jax(tmp_path, int_data, family):
    _, q = int_data
    ti = _carry(family, _jax_index(family, 4, "L2Expanded", int_data),
                _tcomms(4))
    save, load = {"flat": ("save_flat", "load_flat"),
                  "pq": ("save_pq", "load_pq"),
                  "bq": ("save_bq", "load_bq")}[family]
    path = tmp_path / "t.ckpt"
    getattr(ckpt, save)(ti, str(path))
    jl = getattr(j_ckpt, load)(None, _jcomms(2), str(path))
    jfn, jsp, tfn, tsp = _searches(family, 6)
    _assert_same(tfn(RES, tsp, ti, q, K), jfn(None, jsp, jl, q, K))


@pytest.mark.parametrize("family", ["flat", "pq", "bq"])
def test_jax_multihost_checkpoint_loads_into_the_port(tmp_path, int_data,
                                                      family):
    _, q = int_data
    ji = _jax_index(family, 4, "L2Expanded", int_data)
    name = {"flat": "flat", "pq": "pq", "bq": "bq"}[family]
    getattr(j_ckpt, f"save_{name}_multihost")(ji, str(tmp_path))
    tl = getattr(ckpt, f"load_{name}_multihost")(RES, _tcomms(2),
                                                 str(tmp_path))
    jl = getattr(j_ckpt, f"load_{name}_multihost")(None, _jcomms(2),
                                                   str(tmp_path))
    jfn, jsp, tfn, tsp = _searches(family, 6)
    _assert_same(tfn(RES, tsp, tl, q, K), jfn(None, jsp, jl, q, K))
    # and the port's own multihost write round-trips
    out = tmp_path / "port"
    getattr(ckpt, f"save_{name}_multihost")(tl, str(out))
    back = getattr(ckpt, f"load_{name}_multihost")(RES, _tcomms(2), str(out))
    a, b = tfn(RES, tsp, tl, q, K), tfn(RES, tsp, back, q, K)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ---------------------------------------------------------------------------
# port against port: global probes equal the single-device search
# ---------------------------------------------------------------------------


_SINGLE = {}


def _single(family, metric, gauss_data):
    key = (family, metric)
    if key not in _SINGLE:
        x, _ = gauss_data
        m = DistanceType[metric]
        if family == "flat":
            idx = ivf_flat.build(RES, ivf_flat.IvfFlatIndexParams(
                n_lists=N_LISTS, metric=m), x)
        elif family == "pq":
            idx = ivf_pq.build(RES, ivf_pq.IvfPqIndexParams(
                n_lists=N_LISTS, pq_dim=8, pq_bits=4, metric=m), x)
        else:
            idx = ivf_bq.build(RES, ivf_bq.IvfBqIndexParams(
                n_lists=N_LISTS, metric=m), x)
        _SINGLE[key] = idx
    return _SINGLE[key]


def _deal(family, comms, idx):
    return {"flat": divf.from_index, "pq": divf.from_pq_index,
            "bq": dbq.from_bq_index}[family](comms, idx)


@pytest.mark.parametrize("r", R_VALUES)
@pytest.mark.parametrize("family", ["flat", "pq", "bq"])
@pytest.mark.parametrize("metric", ["L2Expanded", "InnerProduct",
                                    "L2SqrtExpanded"])
def test_global_probes_bit_identical_to_single_device(gauss_data, r, family,
                                                      metric):
    _, q = gauss_data
    idx = _single(family, metric, gauss_data)
    di = _deal(family, _tcomms(r), idx)
    single_mod = {"flat": ivf_flat, "pq": ivf_pq, "bq": ivf_bq}[family]
    _, _, tfn, tsp = _searches(family, 5)
    for n_probes in (3, 11):
        sp = dataclasses.replace(tsp, n_probes=n_probes)
        got = tfn(RES, sp, di, q, K)
        want = single_mod.search(RES, sp, idx, q, K)
        assert torch.equal(got[1], want[1]), (family, r, n_probes)
        assert torch.equal(got[0], want[0]), (family, r, n_probes)


@pytest.mark.parametrize("family", ["flat", "pq", "bq"])
def test_save_load_search_bit_identical(tmp_path, gauss_data, family):
    _, q = gauss_data
    di = _deal(family, _tcomms(4), _single(family, "L2Expanded", gauss_data))
    save, load = {"flat": (ckpt.save_flat, ckpt.load_flat),
                  "pq": (ckpt.save_pq, ckpt.load_pq),
                  "bq": (ckpt.save_bq, ckpt.load_bq)}[family]
    path = tmp_path / "c.bin"
    save(di, str(path))
    _, _, tfn, tsp = _searches(family, 6)
    for comms in (_tcomms(4), _tcomms(2)):
        back = load(RES, comms, str(path))
        a, b = tfn(RES, tsp, di, q, K), tfn(RES, tsp, back, q, K)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("probe_wire,floor", [("bf16", 0.99), ("int8", 0.95)])
def test_probe_wire_recall_floors(gauss_data, probe_wire, floor):
    """The JAX package's floors of the quantized probe wires against the
    exact f32 exchange."""
    x, q = gauss_data
    di = _deal("flat", _tcomms(4), _single("flat", "L2Expanded", gauss_data))
    sp = ivf_flat.IvfFlatSearchParams(n_probes=4, scan_engine="torch")
    _, ref = divf.search(RES, sp, di, q, 10)
    _, got = divf.search(RES, sp, di, q, 10, probe_wire_dtype=probe_wire)
    hits = np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                    for a, b in zip(got, ref)])
    assert hits >= floor


def test_local_mode_recall_floor(gauss_data):
    x, q = gauss_data
    di = _deal("flat", _tcomms(4), _single("flat", "L2Expanded", gauss_data))
    sp = ivf_flat.IvfFlatSearchParams(n_probes=8, scan_engine="torch")
    _, g = divf.search(RES, sp, di, q, 10)
    _, loc = divf.search(RES, sp, di, q, 10, probe_mode="local")
    hits = np.mean([len(set(a.tolist()) & set(b.tolist())) / 10
                    for a, b in zip(loc, g)])
    assert hits >= 0.8


def test_probe_counts_count_each_probe_once(gauss_data):
    x, q = gauss_data
    idx = _single("flat", "L2Expanded", gauss_data)
    di = _deal("flat", _tcomms(4), idx)
    n_local = N_LISTS // 4
    planes = [torch.zeros(n_local, dtype=torch.int32) for _ in range(4)]
    d, i, cnt = divf._dist_search_fn(
        torch.as_tensor(q), di.centers, di.center_norms, di.data,
        di.data_norms, di.indices, planes, 20, comms=di.comms, n_probes=5,
        k=K, metric=di.metric, probe_mode="global")
    assert int(sum(c.sum() for c in cnt)) == 20 * 5


def test_distributed_entries_refuse_the_rank_engine(gauss_data):
    """The direct mesh searches serve ``scan_engine="rank"`` (the JAX shard
    bodies' rank-major engines; ``tests/test_torch_mesh_rank.py`` holds
    them to JAX), but the packed ragged bodies refuse it, as the JAX
    package's do: the rank-major scan has no membership mask. An unknown
    engine is refused by the direct search."""
    x, q = gauss_data
    di = _deal("flat", _tcomms(2), _single("flat", "L2Expanded", gauss_data))
    from raft_tpu_torch.core.validation import RaftError

    with pytest.raises(RaftError, match="rank"):
        divf._dist_search_ragged_fn(
            torch.as_tensor(q), torch.full((q.shape[0],), 4, dtype=torch.int32),
            di.centers, di.center_norms, di.data, di.data_norms, di.indices,
            comms=di.comms, n_probes=4, k=K, metric=di.metric,
            probe_mode="global", scan_engine="rank")
    with pytest.raises(RaftError, match="scan_engine"):
        divf.search(RES, ivf_flat.IvfFlatSearchParams(scan_engine="pallas"),
                    di, q, K)


# ---------------------------------------------------------------------------
# builds, k-means, kNN, sharded ANN
# ---------------------------------------------------------------------------


def _recall(ids, truth):
    ids = np.asarray(ids)
    return float(np.mean([len(set(a) & set(b)) / truth.shape[1]
                          for a, b in zip(ids, truth)]))


@pytest.mark.parametrize("family", ["flat", "pq", "bq"])
def test_builds_recall_near_jax(int_data, family):
    x, q = int_data
    d2 = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    truth = np.argsort(d2, axis=1, kind="stable")[:, :10]
    t_build = {"flat": (divf.build, ivf_flat.IvfFlatIndexParams(
        n_lists=N_LISTS)), "pq": (divf.build_pq, ivf_pq.IvfPqIndexParams(
            n_lists=N_LISTS, pq_dim=8, pq_bits=4)),
        "bq": (dbq.build_bq, ivf_bq.IvfBqIndexParams(n_lists=N_LISTS))}
    fn, params = t_build[family]
    ti = fn(RES, _tcomms(4), params, x)
    ji = _jax_index(family, 4, "L2Expanded", int_data)
    jfn, jsp, tfn, tsp = _searches(family, N_LISTS)
    _, ti_ids = tfn(RES, tsp, ti, q, 10)
    _, ji_ids = jfn(None, jsp, ji, q, 10)
    assert ti.size == len(x)
    assert _recall(ti_ids, truth) >= _recall(ji_ids, truth) - 0.05


def test_build_streaming_equals_dealt_single_device(tmp_path, gauss_data):
    """The streamed list-sharded build holds the same lists as the
    in-memory quantizer's dealt index would: every row once, each in its
    nearest list; and at full probes its search is exact."""
    from raft_tpu_torch.io import BinDataset, write_bin

    x, q = gauss_data
    path = tmp_path / "x.fbin"
    write_bin(path, x)
    with BinDataset(path) as ds:
        a = divf.build_streaming(RES, _tcomms(4), ivf_flat.IvfFlatIndexParams(
            n_lists=N_LISTS), ds, chunk_rows=700, train_rows=1024)
        b = divf.build_streaming(RES, _tcomms(4), ivf_flat.IvfFlatIndexParams(
            n_lists=N_LISTS), ds, chunk_rows=1 << 12, train_rows=1024)
    for f in ("centers", "data", "indices", "list_sizes"):
        for u, v in zip(getattr(a, f), getattr(b, f)):
            assert torch.equal(u, v), f
    ids = torch.cat([i.reshape(-1) for i in a.indices])
    assert sorted(ids[ids >= 0].tolist()) == list(range(len(x)))
    sp = ivf_flat.IvfFlatSearchParams(n_probes=N_LISTS, scan_engine="torch")
    _, got = divf.search(RES, sp, a, q, 10)
    _, want = brute_force.knn(RES, x, q, 10)
    assert torch.equal(got, want)


@pytest.mark.parametrize("r", R_VALUES)
def test_kmeans_inertia_near_jax(r):
    rng = np.random.default_rng(2)
    centers = rng.standard_normal((16, 8)) * 10
    x = (centers[rng.integers(0, 16, 1024)]
         + rng.standard_normal((1024, 8))).astype(np.float32)
    c, inertia = dkm.fit(_tcomms(r), x, 24, n_iters=10, seed=3)
    c2, inertia2 = dkm.fit(_tcomms(r), x, 24, n_iters=10, seed=3)
    assert torch.equal(c, c2) and torch.equal(inertia, inertia2)
    _, j_inertia = j_dkm.fit(_jcomms(r), x, 24, n_iters=10, seed=3)
    assert float(inertia) <= float(j_inertia) * 1.10
    # the noise floor n * d * 1 of well-posed blobs
    assert float(inertia) <= 1024 * 8 * 1.3


def _kmeans_blobs():
    rng = np.random.default_rng(2)
    centers = rng.standard_normal((16, 8)) * 10
    return (centers[rng.integers(0, 16, 1024)]
            + rng.standard_normal((1024, 8))).astype(np.float32)


def _kmeans_vs_lloyd(r, x, n_clusters=24, n_iters=10, seed=3):
    """(max |center difference|, relative inertia gap) of the distributed
    fit against single-device Lloyd from the same seeds and iterations."""
    from raft_tpu_torch.cluster import kmeans

    c, inertia = dkm.fit(_tcomms(r), x, n_clusters, n_iters=n_iters,
                         seed=seed)
    seeds = dkm.initial_centers(torch.as_tensor(x), n_clusters, seed)
    want, want_inertia, _ = kmeans.fit(RES, kmeans.KMeansParams(
        n_clusters=n_clusters, init=kmeans.InitMethod.Array,
        max_iter=n_iters, tol=0.0), x, init_centroids=seeds)
    return (float((c - want).abs().max()),
            float(inertia) / float(want_inertia) - 1.0)


# the EM's all-reduces reorder a float sum, nothing more: the fit stays on
# single-device Lloyd's path to float rounding
KMEANS_CENTER_ATOL, KMEANS_GAP = 1e-4, 1e-5


@pytest.mark.parametrize("r", R_VALUES)
def test_kmeans_equals_single_device_lloyd(r):
    diff, gap = _kmeans_vs_lloyd(r, _kmeans_blobs())
    assert diff <= KMEANS_CENTER_ATOL and abs(gap) <= KMEANS_GAP


def test_kmeans_lloyd_check_catches_a_dropped_slot(monkeypatch):
    """An all-reduce that loses the last slot's sums and counts (an EM on
    3/4 of the rows) must fail the check above."""
    real = dkm.allreduce

    def dropped(xs, op, axis):
        if xs[0].ndim == 0:         # the final inertia stays whole
            return real(xs, op, axis)
        return real(list(xs[:-1]) + [torch.zeros_like(xs[-1])], op, axis)

    monkeypatch.setattr(dkm, "allreduce", dropped)
    diff, gap = _kmeans_vs_lloyd(4, _kmeans_blobs())
    assert diff > KMEANS_CENTER_ATOL or abs(gap) > KMEANS_GAP


@pytest.mark.parametrize("wire", ["bf16", "int8", "auto"])
def test_kmeans_wires_near_f32(wire):
    rng = np.random.default_rng(4)
    centers = rng.standard_normal((16, 64)) * 5
    x = (centers[rng.integers(0, 16, 1024)]
         + rng.standard_normal((1024, 64))).astype(np.float32)
    _, f32 = dkm.fit(_tcomms(4), x, 20, n_iters=8, seed=1)
    _, narrow = dkm.fit(_tcomms(4), x, 20, n_iters=8, seed=1,
                        wire_dtype=wire)
    assert float(narrow) <= float(f32) * 1.02


@pytest.mark.parametrize("r", R_VALUES)
def test_brute_force_knn_equals_jax(int_data, r):
    from raft_tpu.distributed import brute_force_knn, brute_force_knn_ring

    x, q = int_data
    x, q = x[:2400 // r * r], q[:24]
    got = dknn.brute_force_knn(_tcomms(r), x, q, 5)
    want = brute_force_knn(_jcomms(r), x, q, 5)
    _assert_same(got, want)
    got = dknn.brute_force_knn_ring(_tcomms(r), x, q, 5)
    want = brute_force_knn_ring(_jcomms(r), x, q, 5)
    _assert_same(got, want)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_ann_equals_jax(int_data, n_shards):
    from raft_tpu.distributed import build_sharded as j_build_sharded
    from raft_tpu.neighbors import brute_force as j_bf

    x, q = int_data
    si = sharded_ann.build_sharded(
        RES, lambda r_, part: brute_force.build(r_, part),
        lambda r_, ix, qq, k: brute_force.search(r_, ix, qq, k), x,
        n_shards=n_shards)
    jsi = j_build_sharded(
        None, lambda r_, part: j_bf.build(r_, part),
        lambda r_, ix, qq, k: j_bf.search(r_, ix, qq, k), x,
        devices=jax.devices()[:n_shards])
    tid = tracing.new_trace_id()
    _assert_same(si.search(RES, q, 5, trace_id=tid), jsi.search(None, q, 5))
    assert si.n_shards == n_shards and si.offsets == jsi.offsets
    assert tracing.get_gauge(tracing.MESH_SLOWEST_SHARD, -2) >= 0


# ---------------------------------------------------------------------------
# models, resolvers and tracing helpers equal the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q,k,n_probes,n_lists,r", [
    (64, 10, 32, 1024, 4), (10, 10, 128, 1024, 4), (500, 10, 8, 64, 8),
    (7, 3, 60, 64, 2)])
@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("probe_wire", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("mode", ["global", "local"])
def test_payload_model_equals_jax(q, k, n_probes, n_lists, r, wire,
                                  probe_wire, mode):
    args = (q, k, n_probes, n_lists, r, wire, mode, probe_wire)
    assert divf.collective_payload_model(*args) == \
        j_divf.collective_payload_model(*args)
    model = divf.collective_payload_model(*args)
    assert divf.mesh_phases(model) == j_divf.mesh_phases(model)
    auto = (q, k, n_probes, n_lists, r, "auto", mode, "auto")
    assert divf.resolve_auto_wires(*auto) == j_divf.resolve_auto_wires(*auto)
    assert divf.resolve_probe_budget(n_probes, n_lists, r, mode) == \
        j_divf.resolve_probe_budget(n_probes, n_lists, r, mode)


@pytest.mark.parametrize("n_clusters,dim", [(1024, 128), (64, 96), (8, 3)])
@pytest.mark.parametrize("wire", ["f32", "bf16", "int8", "auto"])
def test_kmeans_payload_model_equals_jax(n_clusters, dim, wire):
    if wire != "auto":
        assert dkm.collective_payload_model(n_clusters, dim, wire) == \
            j_dkm.collective_payload_model(n_clusters, dim, wire)
    assert dkm.resolve_kmeans_wire(wire, n_clusters, dim) == \
        j_dkm.resolve_kmeans_wire(wire, n_clusters, dim)


@pytest.mark.parametrize("r", [1, 3, 4, 8])
def test_deal_order_and_rel_err_equal_jax(rng_np, r):
    sizes = rng_np.integers(0, 50, 24)
    np.testing.assert_array_equal(divf.deal_order(sizes, r),
                                  j_divf.deal_order(sizes, r))
    if 24 % r == 0:
        errw = rng_np.random((24, 6)).astype(np.float32)
        rnorm = rng_np.random((24, 6)).astype(np.float32) + 1
        ids = np.where(rng_np.random((24, 6)) < 0.8, 1, -1)
        perm = divf.deal_order(sizes, r)
        assert dbq.shard_rel_err_from_arrays(errw, rnorm, ids, 64, perm, r) \
            == j_dbq.shard_rel_err_from_arrays(errw, rnorm, ids, 64, perm, r)


@pytest.mark.parametrize("timings", [[], [0.1], [0.3, 0.1, 0.2],
                                     [0.5, 0.5, 0.25, 0.75]])
def test_straggler_stats_equal_jax(timings):
    assert tracing.straggler_stats(timings) == \
        j_tracing.straggler_stats(timings)


@pytest.mark.parametrize("samples", [None, [0.01, 0.03, 0.02]])
def test_record_mesh_spans_equal_jax(samples):
    timings = [0.002, 0.005, 0.001]
    phases = {"scan": {"modeled": True, "wire_bytes": 0}}
    for mod in (tracing, j_tracing):
        mod.reset_gauges("serving.mesh.")
        mod.reset_counters("serving.mesh.")
    got = tracing.record_mesh_spans("fam", 1.0, 1.01, trace_ids=(5,),
                                    phases=phases, shard_timings=timings,
                                    skew_samples=samples)
    want = j_tracing.record_mesh_spans("fam", 1.0, 1.01, trace_ids=(5,),
                                       phases=phases, shard_timings=timings,
                                       skew_samples=samples)
    assert got == want
    assert tracing.gauges("serving.mesh.") == j_tracing.gauges(
        "serving.mesh.")
    assert tracing.get_counter("serving.mesh.dispatches") == 1.0


def test_poll_shard_timings_on_cpu_tensors():
    parts = [(torch.zeros(2), torch.zeros(2)) for _ in range(3)]
    ts = tracing.poll_shard_timings(parts, 0.0)
    assert len(ts) == 3 and all(t > 0 for t in ts)


def test_traced_search_records_mesh_spans(gauss_data):
    x, q = gauss_data
    di = _deal("flat", _tcomms(4), _single("flat", "L2Expanded", gauss_data))
    tracing.reset_spans()
    tid = tracing.new_trace_id()
    divf.search(RES, ivf_flat.IvfFlatSearchParams(n_probes=4,
                                                  scan_engine="torch"),
                di, q, K, trace_id=tid)
    names = {s.name for s in tracing.span_recorder().spans()
             if tid in s.trace_ids}
    assert {"comms.dispatch.dist_ivf_flat", "serving.mesh.coarse_select",
            "serving.mesh.scan", "serving.mesh.merge"} <= names


def test_merge_overfetch_follows_jax():
    idx = ivf_bq.build(RES, ivf_bq.IvfBqIndexParams(n_lists=8,
                                                    store_vectors=False),
                       np.random.default_rng(0).standard_normal(
                           (800, 32)).astype(np.float32))
    di = dbq.from_bq_index(_tcomms(2), idx)
    worst = max(di.shard_rel_err)
    assert dbq.merge_overfetch(di, 10) == int(np.ceil(
        10 * (1.0 + j_ivf_bq._OVERFETCH_KAPPA * worst)))
    # the codes-only index searches (the rank-major estimate scan, as the
    # JAX package resolves it): estimate-ranked live ids
    d, i = dbq.search_bq(RES, ivf_bq.IvfBqSearchParams(), di,
                         np.zeros((2, 32), np.float32), 5)
    assert d.shape == i.shape == (2, 5)
    assert bool(((i >= 0) & (i < 800)).all())


# ---------------------------------------------------------------------------
# the multi-chip dry run and two processes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_slots", [4, 8])
def test_dryrun_multichip_steps_on_the_port(n_slots):
    """The steps of ``__graft_entry__.dryrun_multichip`` on the port's
    slot mesh: k-means, brute-force kNN (and its ring form), list-sharded
    IVF-Flat, IVF-PQ and IVF-BQ, and index-per-shard CAGRA."""
    from raft_tpu_torch.distributed import (
        brute_force_knn,
        brute_force_knn_ring,
        build_sharded,
        kmeans_fit,
    )
    from raft_tpu_torch.neighbors import cagra

    comms = _tcomms(n_slots)
    n, d, k = 64 * n_slots, 32, 5
    g = torch.Generator().manual_seed(0)
    dataset = torch.randn(n, d, generator=g)
    queries = torch.randn(4, d, generator=g)
    centers, inertia = kmeans_fit(comms, dataset, 8, n_iters=3)
    assert centers.shape == (8, d) and torch.isfinite(inertia)
    dists, idx = brute_force_knn(comms, dataset, queries, k)
    assert dists.shape == (4, k) and bool((dists.diff(dim=1) >= -1e-4).all())
    index = divf.build(RES, comms, ivf_flat.IvfFlatIndexParams(n_lists=8),
                       dataset)
    dd, ii = divf.search(RES, ivf_flat.IvfFlatSearchParams(n_probes=8),
                         index, queries, k)
    assert torch.equal(ii, idx)
    pq = divf.build_pq(RES, comms, ivf_pq.IvfPqIndexParams(n_lists=8,
                                                           pq_dim=16),
                       dataset)
    assert divf.search_pq(RES, ivf_pq.IvfPqSearchParams(n_probes=8), pq,
                          queries, k)[1].shape == (4, k)
    rd, ri = brute_force_knn_ring(comms, dataset,
                                  torch.randn(2 * n_slots, d, generator=g), k)
    assert ri.shape == (2 * n_slots, k)
    bq = dbq.build_bq(RES, comms, ivf_bq.IvfBqIndexParams(n_lists=8),
                      dataset)
    bd, bi = dbq.search_bq(RES, ivf_bq.IvfBqSearchParams(n_probes=8), bq,
                           queries, k)
    assert torch.equal(bi, idx)
    cp = cagra.CagraIndexParams(graph_degree=8, intermediate_graph_degree=16)
    sp = cagra.CagraSearchParams(itopk_size=16)
    sharded = build_sharded(RES, lambda r_, part: cagra.build(r_, cp, part),
                            lambda r_, ix, q, kk: cagra.search(r_, sp, ix,
                                                               q, kk),
                            dataset, n_shards=n_slots)
    cd, ci = sharded.search(RES, queries, k)
    assert cd.shape == (4, k) and bool(((ci >= 0) & (ci < n)).all())


_WORKER = textwrap.dedent("""
    import sys, numpy as np, torch
    from raft_tpu_torch import Resources
    from raft_tpu_torch.comms import initialize, local_comms
    from raft_tpu_torch.distributed import checkpoint as ckpt, ivf as divf
    from raft_tpu_torch.neighbors import ivf_flat

    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    initialize(f"localhost:{port}", 2, rank, backend="gloo", timeout_s=60)
    res = Resources(device="cpu", seed=0)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1200, 16)).astype(np.float32)
    q = rng.standard_normal((12, 16)).astype(np.float32)
    idx = ivf_flat.build(res, ivf_flat.IvfFlatIndexParams(n_lists=16), x)
    # the global index dealt over 4 shards; this process holds shards
    # 2*rank and 2*rank + 1 on its own 2 slots
    whole = divf.from_index(local_comms(shape=(4,), device="cpu"), idx)
    mine = local_comms(shape=(2,), device="cpu")
    part = divf.DistributedIvfFlat(
        mine, *[getattr(whole, f)[2 * rank:2 * rank + 2] for f in (
            "centers", "center_norms", "data", "data_norms", "indices",
            "list_sizes")], whole.metric)
    ckpt.save_flat_multihost(part, out)
    back = ckpt.load_flat_multihost(res, mine, out)
    sp = ivf_flat.IvfFlatSearchParams(n_probes=5, scan_engine="torch")
    d, i = divf.search(res, sp, back, q, 5)
    d0, i0 = ivf_flat.search(res, sp, idx, q, 5)
    assert torch.equal(i, i0) and torch.equal(d, d0)
    got = [torch.zeros_like(i) for _ in range(2)]
    torch.distributed.all_gather(got, i)
    assert torch.equal(got[0], got[1])
    torch.distributed.destroy_process_group()
    print("worker ok", rank)
""")


def test_two_gloo_processes_multihost_checkpoint_and_search(tmp_path):
    """Two processes in a gloo group: each holds half of the dealt lists,
    writes its part of a multihost checkpoint, reads the whole of it onto
    its own slots and searches it, equal to the single-device search and
    to the other process's answer (all-gathered over the group). Bounded
    by a 120 s timeout so a hang fails."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(port),
         str(tmp_path / "ckpt")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        assert "worker ok" in out
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "meta.bin", "part00000.bin", "part00001.bin"]
