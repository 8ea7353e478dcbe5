"""The port's CAGRA (``neighbors/cagra``) against the JAX package's.

Equal outputs on equal inputs: the graph optimization (``_detour_counts``
both ways, ``_select_forward``, ``_merge_forward_reverse``,
``optimize``) on a k-NN graph the JAX package built, the seeding on
integer-valued data, the ``torch`` engine against the JAX ``xla`` engine
given the same seeds (integer data, so every distance is exact: ids
equal, distances to rtol 1e-5), with a filter and with the BQ traversal,
and the v5 file, byte for byte both ways. The beam kernel's plain
version (``algo="cuda"`` on a CPU index) is held to the ``torch`` engine
on tie-free Gaussian data (ids equal, distances to 1e-4: the two sum in
other orders). Builds use other generators: held to recall.
"""

from __future__ import annotations

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core.bitset import Bitset as JBitset
from raft_tpu.distance.types import DistanceType as JD
from raft_tpu.neighbors import cagra as j_cagra
from raft_tpu.neighbors import nn_descent as j_nnd
from raft_tpu_torch import Resources
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors import cagra as t_cagra
from raft_tpu_torch.ops import beam_search as t_bs
from raft_tpu_torch.ops.bq_scan import auto_query_bits

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

CPU = Resources(device="cpu")
N, D = 1200, 64


def _blobs(seed, n, d, integer):
    rng = np.random.default_rng(seed)
    if integer:
        centers = rng.integers(-5, 6, (12, d))
        x = centers[rng.integers(0, 12, n)] + rng.integers(-2, 3, (n, d))
        q = centers[rng.integers(0, 12, 16)] + rng.integers(-2, 3, (16, d))
    else:
        centers = rng.standard_normal((12, d)) * 4
        x = centers[rng.integers(0, 12, n)] + rng.standard_normal((n, d))
        q = centers[rng.integers(0, 12, 16)] + rng.standard_normal((16, d))
    return x.astype(np.float32), q.astype(np.float32)


def _truth(x, q, k):
    d = (x * x).sum(1)[None] - 2 * q @ x.T
    return np.argsort(d, axis=1, kind="stable")[:, :k]


def _recall(ids, truth):
    ids = np.asarray(ids)
    return float(np.mean([len(set(a) & set(b)) / truth.shape[1]
                          for a, b in zip(ids, truth)]))


@pytest.fixture(scope="module")
def jax_index():
    """A JAX index (NN-descent graph, seed plane, 2-bit BQ plane) on
    integer data, and the port's copy of it."""
    x, q = _blobs(0, N, D, integer=True)
    j = j_cagra.build(None, j_cagra.CagraIndexParams(
        graph_degree=16, intermediate_graph_degree=24,
        build_algo=j_cagra.BuildAlgo.NN_DESCENT, bq_bits=2), x)
    arrays = {f: np.array(getattr(j, f)) for f in (
        "dataset", "graph", "seed_centers", "seed_members", "bq_rotation",
        "bq_center_rot", "bq_records")}
    t = t_cagra.from_numpy(metric=DistanceType.L2Expanded, bq_bits=2,
                           res=CPU, **arrays)
    return j, t, x, q


@pytest.fixture(scope="module")
def knn_graph():
    x, _ = _blobs(1, 600, 24, integer=False)
    return np.array(j_nnd.build(None, j_nnd.NNDescentParams(
        graph_degree=24, intermediate_graph_degree=32, max_iterations=4), x))


@pytest.mark.parametrize("method", ["search", "compare"])
def test_detour_counts_equal_jax(knn_graph, method):
    g = knn_graph.copy()
    g[::11, 20:] = -1
    want = np.asarray(j_cagra._detour_counts(jnp.asarray(g), 128, method))
    got = t_cagra._detour_counts(torch.from_numpy(g), 100, method)
    np.testing.assert_array_equal(got.numpy(), want)


def test_optimize_equals_jax(knn_graph):
    g = knn_graph
    det = j_cagra._detour_counts(jnp.asarray(g), 128)
    fwd = np.array(j_cagra._select_forward(jnp.asarray(g), det, 8))
    tdet = torch.from_numpy(np.array(det))
    np.testing.assert_array_equal(
        t_cagra._select_forward(torch.from_numpy(g), tdet, 8).numpy(), fwd)
    rev = np.array(j_nnd._reverse_sample(jnp.asarray(fwd), 600, 8))
    np.testing.assert_array_equal(
        t_cagra._merge_forward_reverse(
            torch.from_numpy(g), torch.from_numpy(fwd), torch.from_numpy(rev),
            16).numpy(),
        np.asarray(j_cagra._merge_forward_reverse(
            jnp.asarray(g), jnp.asarray(fwd), jnp.asarray(rev), 16)))
    np.testing.assert_array_equal(
        t_cagra.optimize(CPU, g, 16, tile=77).numpy(),
        np.asarray(j_cagra.optimize(None, g, 16)))


@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.InnerProduct],
                         ids=lambda m: m.name)
def test_seeding_equals_jax(metric):
    x, q = _blobs(2, 800, 32, integer=True)
    rng = np.random.default_rng(2)
    centers = rng.integers(-5, 6, (9, 32)).astype(np.float32)
    members = rng.integers(0, 800, (9, 40)).astype(np.int32)
    members[:, 30:] = -1
    jm = JD(int(metric))
    want = np.asarray(j_cagra._coarse_seeds(
        jnp.asarray(x), jnp.asarray(centers), jnp.asarray(members),
        jnp.asarray(q), n_probes=3, n_seeds=50, metric=jm))
    got = t_cagra._coarse_seeds(
        torch.from_numpy(x), torch.from_numpy(centers),
        torch.from_numpy(members), torch.from_numpy(q), n_probes=3,
        n_seeds=50, metric=metric)
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(j_cagra._pooled_seeds(jnp.asarray(x), jnp.asarray(q),
                                            256, 40, jm))
    got = t_cagra._pooled_seeds(torch.from_numpy(x), torch.from_numpy(q),
                                256, 40, metric)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["plain", "filter", "bq", "row_iters"])
def test_torch_engine_equals_xla_engine(jax_index, case):
    j, t, x, q = jax_index
    sp = j_cagra.CagraSearchParams(itopk_size=32, search_width=2)
    cfg = j_cagra.derive_search_config(sp, j, 10)
    seeds = np.array(j_cagra._make_seeds(
        j.dataset, j.seed_centers, j.seed_members, jnp.asarray(q),
        cfg["n_seeds"], j.metric, "coarse", 0))
    kw = dict(k=10, L=cfg["L"], w=cfg["w"], max_iters=cfg["max_iters"])
    jargs = [None, None, None, None, None]
    targs = [None, None, None, None, None]
    jkw, tkw = {}, {}
    if case == "filter":
        mask = np.random.default_rng(3).random(N) < 0.6
        jargs[0] = JBitset.from_mask(mask).words
        targs[0] = Bitset.from_mask(mask).words
    if case == "row_iters":
        ri = np.array([0, 1, 2, 5, 9, 40] + [3] * 10, np.int32)
        jargs[1], targs[1] = jnp.asarray(ri), torch.from_numpy(ri)
    if case == "bq":
        qrot = q @ np.asarray(j.bq_rotation).T
        jargs[2:] = [j.bq_records, jnp.asarray(qrot), j.bq_center_rot]
        targs[2:] = [t.bq_records, torch.from_numpy(qrot), t.bq_center_rot]
        jkw = dict(bq_bits=2, bq_query_bits=auto_query_bits(2))
        tkw = dict(jkw)
    wd, wi = j_cagra._search_batch(
        j.dataset, j.graph, jnp.asarray(q), jnp.asarray(seeds), *jargs,
        metric=JD.L2Expanded, **kw, **jkw)
    gd, gi = t_cagra._search_batch_fn(
        t.dataset, t.graph, torch.from_numpy(q), torch.from_numpy(seeds),
        *targs, metric=DistanceType.L2Expanded, **kw, **tkw)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    fin = np.isfinite(np.asarray(wd))
    np.testing.assert_array_equal(np.isfinite(gd.numpy()), fin)
    np.testing.assert_allclose(gd.numpy()[fin], np.asarray(wd)[fin],
                               rtol=1e-5)
    if case == "filter":
        ids = gi.numpy()
        assert mask[ids[ids >= 0]].all()


@pytest.fixture(scope="module")
def gauss_index():
    x, q = _blobs(4, 1500, 128, integer=False)
    index = t_cagra.build(CPU, t_cagra.CagraIndexParams(
        graph_degree=16, intermediate_graph_degree=32,
        build_algo=t_cagra.BuildAlgo.CLUSTER_JOIN, bq_bits=1), x)
    return index, x, q


@pytest.mark.parametrize("kw", [
    dict(itopk_size=64, search_width=4),
    dict(itopk_size=128, search_width=4),          # L > C: chunked seeds
    dict(itopk_size=64, search_width=4, num_random_samplings=2),
    dict(itopk_size=64, search_width=4, bq_traversal="on"),
], ids=["L64", "L128", "samplings2", "bq"])
def test_plain_beam_equals_torch_engine(gauss_index, kw):
    index, _, q = gauss_index
    dt, it = t_cagra.search(CPU, t_cagra.CagraSearchParams(algo="torch", **kw),
                            index, q, 10)
    before = t_bs.beam_search.launches
    dp, ip = t_cagra.search(CPU, t_cagra.CagraSearchParams(algo="cuda", **kw),
                            index, q, 10)
    assert t_bs.beam_search.launches == before     # CPU: the plain version
    np.testing.assert_array_equal(ip.numpy(), it.numpy())
    np.testing.assert_allclose(dp.numpy(), dt.numpy(), rtol=1e-4, atol=1e-4)


def test_build_and_search_recall(gauss_index):
    index, x, q = gauss_index
    assert index.graph.shape == (1500, 16) and index.bq_records is not None
    truth = _truth(x, q, 10)
    off = _recall(t_cagra.search(CPU, t_cagra.CagraSearchParams(
        itopk_size=64, search_width=4, bq_traversal="off"), index, q, 10)[1],
        truth)
    on = _recall(t_cagra.search(CPU, t_cagra.CagraSearchParams(
        itopk_size=64, search_width=4, bq_traversal="on"), index, q, 10)[1],
        truth)
    assert off >= 0.9 and on >= off - 0.02, (on, off)


@pytest.mark.parametrize("metric", [DistanceType.InnerProduct,
                                    DistanceType.L2SqrtExpanded],
                         ids=lambda m: m.name)
def test_metrics_and_storage(metric):
    x, q = _blobs(5, 900, 48, integer=False)
    index = t_cagra.build(CPU, t_cagra.CagraIndexParams(
        metric=metric, graph_degree=16, intermediate_graph_degree=24,
        build_algo=t_cagra.BuildAlgo.NN_DESCENT, storage_dtype="bfloat16"),
        x)
    assert index.dataset.dtype == torch.bfloat16
    d, i = t_cagra.search(CPU, t_cagra.CagraSearchParams(itopk_size=32),
                          index, q, 5)
    xb = index.dataset.to(torch.float32).numpy()
    if metric == DistanceType.InnerProduct:
        want = np.sort(q @ xb.T, axis=1)[:, ::-1][:, :5]
        np.testing.assert_allclose(d.numpy(), want, rtol=1e-4, atol=1e-3)
    else:
        assert _recall(i, _truth(xb, q, 5)) >= 0.9
        np.testing.assert_allclose(
            d.numpy(), np.sqrt(((q[:, None] - xb[i.numpy()]) ** 2).sum(-1)),
            rtol=1e-3, atol=1e-3)


def test_int8_dataset_self_hit():
    rng = np.random.default_rng(6)
    x8 = rng.integers(-100, 100, (700, 32)).astype(np.int8)
    index = t_cagra.build(CPU, t_cagra.CagraIndexParams(
        graph_degree=8, intermediate_graph_degree=16,
        build_algo=t_cagra.BuildAlgo.NN_DESCENT), x8)
    assert index.dataset.dtype == torch.int8
    _, i = t_cagra.search(CPU, t_cagra.CagraSearchParams(
        itopk_size=32, algo="cuda"), index, x8[:20].astype(np.float32), 1)
    np.testing.assert_array_equal(i.numpy()[:, 0], np.arange(20))


def test_v5_file_is_byte_identical_both_ways(jax_index):
    j, t, _, q = jax_index
    jb, tb = io.BytesIO(), io.BytesIO()
    j_cagra.save(j, jb)
    t_cagra.save(t, tb)
    assert tb.getvalue() == jb.getvalue()
    jb.seek(0)
    back = t_cagra.load(CPU, jb)
    for f in ("dataset", "graph", "seed_centers", "seed_members",
              "bq_rotation", "bq_center_rot", "bq_records"):
        np.testing.assert_array_equal(getattr(back, f).numpy(),
                                      np.array(getattr(j, f)))
    tb.seek(0)
    jback = j_cagra.load(None, tb)
    np.testing.assert_array_equal(np.asarray(jback.bq_records),
                                  t.bq_records.numpy())
    sp = t_cagra.CagraSearchParams(itopk_size=32, search_width=2)
    a = t_cagra.search(CPU, sp, t, q, 10)
    b = t_cagra.search(CPU, sp, back, q, 10)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    nb = io.BytesIO()
    t_cagra.save(t, nb, include_dataset=False)
    nb.seek(0)
    with pytest.raises(Exception, match="without its dataset"):
        t_cagra.load(CPU, nb)
    nb.seek(0)
    assert torch.equal(t_cagra.load(CPU, nb, dataset=t.dataset).graph,
                       t.graph)


def test_engine_resolution_and_errors(jax_index):
    _, t, x, q = jax_index
    sp = t_cagra.CagraSearchParams
    assert t_cagra._resolve_search_algo(sp(), t, None) == "torch"
    assert t_cagra._resolve_search_algo(sp(algo="cuda"), t, None) == "cuda"
    assert t_cagra._resolve_search_algo(
        sp(algo="cuda", itopk_size=512), t, None) == "cuda"
    words = Bitset.from_mask(np.ones(N, bool)).words
    with pytest.raises(Exception, match="algo='cuda' needs"):
        t_cagra._resolve_search_algo(sp(algo="cuda"), t, words)
    # itopk and w*deg are the kernel wrapper's limits (it raises past
    # them), not an engine rule
    assert t_cagra._resolve_search_algo(
        sp(algo="cuda", itopk_size=513), t, None) == "cuda"
    assert t_cagra._resolve_search_algo(
        sp(itopk_size=513), t, None) == "torch"        # a CPU index
    # the default graph source is IVF-PQ: the default params build
    default = t_cagra.build(CPU, t_cagra.CagraIndexParams(), x)
    assert default.graph.shape == (N, 64) and bool((default.graph >= 0).all())
    _, i = t_cagra.search(CPU, sp(itopk_size=64), default, q, 5)
    assert _recall(i, _truth(x, q, 5)) >= 0.9
    with pytest.raises(Exception, match="bq_traversal='on'"):
        t_cagra.search(CPU, sp(bq_traversal="on"), t_cagra.from_graph(
            CPU, x, t.graph), q, 5)
    plain = t_cagra.from_graph(CPU, x, t.graph)
    _, i = t_cagra.search(CPU, sp(itopk_size=32), plain, q, 5)  # pool seeds
    assert _recall(i, _truth(x, q, 5)) >= 0.8


def test_ivf_pq_graph_source_equals_jax(monkeypatch):
    """``build_knn_graph`` against the JAX package's on integer data, both
    searching one carried-across IVF-PQ index (integer centers and
    codebooks, identity rotation): the same candidates, the same exact
    re-rank, the same self-hit drop and compaction."""
    from raft_tpu.neighbors import ivf_pq as j_pq
    from raft_tpu_torch.neighbors import ivf_pq as t_pq

    rng = np.random.default_rng(5)
    n, dim, n_lists, pq_dim = 600, 16, 8, 8
    x = rng.integers(-8, 9, (n, dim)).astype(np.float32)
    empty = j_pq.IvfPqIndex(
        centers=jnp.asarray(rng.integers(-6, 7, (n_lists, dim)), jnp.float32),
        rotation=jnp.eye(dim, dtype=jnp.float32),
        codebooks=jnp.asarray(rng.integers(-3, 4, (pq_dim, 16, 2)),
                              jnp.float32),
        codes=jnp.zeros((n_lists, 0, pq_dim), jnp.uint8),
        indices=jnp.full((n_lists, 0), -1, jnp.int32),
        list_sizes=jnp.zeros((n_lists,), jnp.int32),
        metric=JD.L2Expanded,
        codebook_kind=j_pq.CodebookKind.PER_SUBSPACE, pq_bits=4)
    ji = j_pq.extend(None, empty, x)
    assert ji.packed
    ti = t_pq.from_numpy(*(np.asarray(getattr(ji, f)) for f in (
        "centers", "rotation", "codebooks", "codes", "indices",
        "list_sizes")), pq_bits=4, packed=True, res=CPU)
    monkeypatch.setattr(j_cagra.ivf_pq_mod, "build", lambda *a: ji)
    monkeypatch.setattr(t_pq, "build", lambda *a: ti)
    want = np.asarray(j_cagra.build_knn_graph(None, x, 12, n_lists=n_lists,
                                              n_probes=3, batch=256))
    got = t_cagra.build_knn_graph(CPU, x, 12, n_lists=n_lists, n_probes=3,
                                  batch=256)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != np.arange(n)[:, None]).all()
