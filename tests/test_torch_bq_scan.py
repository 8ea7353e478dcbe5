"""The port's fused IVF-BQ scan (plain engine) against the JAX package's
engines on the same index: ``xla`` and ``pallas`` (interpret mode).

The index is built by the JAX package on integer-valued data and carried
over by ``ivf_bq.from_numpy`` (its norm plane is recomputed, exactly on
integer data); both sides get the same rotated queries and centers, so every difference left is a sum taken in another order.
Ids must be equal, distances equal to rtol 1e-5, and the number of rows
each query reranked equal to a replay of ``_bq_scan_xla``'s steps with
the JAX package's own estimate and merge. The CUDA engine's walk (one
query at a time over its sorted probes, each list's live rows split
over a cluster's CTAs against the list-start threshold, survivors
reranked alone, every sum in ``tree_sum``'s order) is checked by
emulating it with plain tensor code, bit for bit on Gaussian data too.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core.bitset import Bitset as JBitset
from raft_tpu.distance.types import DistanceType as JD
from raft_tpu.neighbors import ivf_bq as j_bq
from raft_tpu.ops import bq_scan as j_scan
from raft_tpu.ops import ivf_scan as j_ivf_scan
from raft_tpu_torch import Resources
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors import ivf_bq as t_bq
from raft_tpu_torch.ops import bq_scan as t_scan
from raft_tpu_torch.ops.ivf_scan import (
    _merge_smallest_id,
    live_rows,
    union_id_planes,
)

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

N_LISTS, N, D, Q = 12, 1500, 40, 24
CPU = Resources(device="cpu")
_INDEXES = {}


def _index(bits: int, metric: DistanceType):
    """A JAX-built index on integer data, as numpy arrays (cached; the
    L2 and L2Sqrt indexes are the same arrays)."""
    ip = metric == DistanceType.InnerProduct
    key = (bits, ip)
    if key not in _INDEXES:
        rng = np.random.default_rng(bits)
        x = rng.integers(-4, 5, (N, D)).astype(np.float32)
        x[700] = x[3]                     # exact duplicates of one row
        x[1300] = x[3]
        idx = j_bq.build(None, j_bq.IvfBqIndexParams(
            n_lists=N_LISTS, bits=bits,
            metric=JD.InnerProduct if ip else JD.L2Expanded), x)
        arrays = {f: np.array(getattr(idx, f)) for f in (
            "centers", "rotation", "codes", "rnorm", "cfac", "errw",
            "indices", "data", "data_norms")}
        q = rng.integers(-4, 5, (Q, D)).astype(np.float32)
        q[0] = x[3]
        arrays["qf"] = q
        arrays["qrot"] = q @ arrays["rotation"].T
        arrays["crot"] = arrays["centers"] @ arrays["rotation"].T
        probes = rng.integers(0, N_LISTS, (Q, 5)).astype(np.int32)
        probes[2, 3:] = N_LISTS           # sentinel (masked) probe slots
        probes[5, :] = N_LISTS            # a query that probes nothing
        probes[6, 1] = probes[6, 0]       # a repeated probe counts once
        probes[0, 0] = int(np.nonzero(arrays["indices"] == 3)[0][0])
        arrays["probes"] = probes
        arrays["words1"] = np.array(JBitset.from_mask(
            rng.random(N) < 0.7).words)
        arrays["words2"] = _bitmap(rng)
        _INDEXES[key] = arrays
    return _INDEXES[key]


def _bitmap(rng):
    """Per-query (2-D) filter words, bit id % 32 of word id // 32."""
    mask = rng.random((Q, N)) < 0.7
    padded = np.zeros((Q, -(-N // 32) * 32), bool)
    padded[:, :N] = mask
    bits = padded.reshape(Q, -1, 32).astype(np.uint32)
    return (bits << np.arange(32, dtype=np.uint32)).sum(axis=2,
                                                        dtype=np.uint32)


_PLANES = ("codes", "rnorm", "cfac", "errw", "indices", "data",
           "data_norms")


def _filter(a, which):
    return None if which is None else a[which]


def _jax_scan(a, fw, *, k, metric, engine, query_bits):
    return j_scan.bq_list_major_scan(
        jnp.asarray(a["qf"]), jnp.asarray(a["qrot"]), jnp.asarray(a["crot"]),
        *[jnp.asarray(a[p]) for p in _PLANES], jnp.asarray(a["probes"]),
        None if fw is None else jnp.asarray(fw), k=k,
        metric=JD(int(metric)), epsilon=3.0, engine=engine,
        query_bits=query_bits, interpret=True)


def _torch_args(a, fw):
    """The scan's arguments from the JAX index carried over by
    ``ivf_bq.from_numpy`` (which recomputes the norm plane)."""
    idx = t_bq.from_numpy(*[a[f] for f in (
        "centers", "rotation", "codes", "rnorm", "cfac", "errw", "indices")],
        list_sizes=(a["indices"] >= 0).sum(axis=1), data=a["data"], res=CPU)
    tw = None if fw is None else torch.from_numpy(fw.view(np.int32))
    return ([torch.from_numpy(a[n]) for n in ("qf", "qrot", "crot")]
            + [getattr(idx, p) for p in _PLANES]
            + [torch.from_numpy(a["probes"]), tw])


def _jax_survivors(a, fw, *, k, metric, query_bits):
    """Rows each query reranked, by replaying ``_bq_scan_xla``'s steps
    with the JAX package's ``_block_estimate`` and merge."""
    from raft_tpu.neighbors.filters import test_filter

    ip_metric = metric == DistanceType.InnerProduct
    probes = jnp.asarray(a["probes"])
    uniq = np.asarray(j_ivf_scan.unique_lists(probes, N_LISTS))
    ids_g = jnp.asarray(a["indices"])[np.minimum(uniq, N_LISTS - 1)]
    if fw is not None and fw.ndim == 1:
        ok = test_filter(jnp.asarray(fw), ids_g) & (ids_g >= 0)
        ids_g = jnp.where(ok, ids_g, -1)
    qf = jnp.asarray(a["qf"])
    qn = jnp.sum(jnp.square(qf), axis=1, keepdims=True)
    best_d = jnp.full((Q, k), jnp.inf, jnp.float32)
    best_i = jnp.full((Q, k), -1, jnp.int32)
    surv = np.zeros(Q, np.int64)
    bits = a["cfac"].shape[2]
    for j, lid in enumerate(uniq):
        if lid >= N_LISTS:
            continue
        est, margin = j_scan._block_estimate(
            jnp.asarray(a["qrot"]), jnp.asarray(a["crot"][lid:lid + 1]),
            jnp.asarray(a["rnorm"][lid][None]),
            jnp.asarray(a["errw"][lid][None]),
            jnp.asarray(a["cfac"][lid].T), jnp.asarray(a["codes"][lid]),
            dim_ext=a["crot"].shape[1], bits=bits, query_bits=query_bits,
            epsilon=3.0, ip_metric=ip_metric)
        ids_b = jnp.broadcast_to(ids_g[j][None, :], est.shape)
        ok = (ids_b >= 0) & jnp.any(probes == lid, axis=1)[:, None]
        if fw is not None and fw.ndim == 2:
            ok = ok & test_filter(jnp.asarray(fw), ids_b)
        est = jnp.where(ok, est, jnp.inf)
        cand = (est - margin) < best_d[:, k - 1:k]
        surv += np.asarray(cand).sum(axis=1)
        ipx = qf @ jnp.asarray(a["data"][lid]).T
        exact = -ipx if ip_metric else jnp.maximum(
            qn + jnp.asarray(a["data_norms"][lid])[None] - 2.0 * ipx, 0.0)
        exact = jnp.where(cand, exact, jnp.inf)
        best_d, best_i = j_ivf_scan._merge_smallest_id(best_d, best_i, exact,
                                                       ids_b, k)
    return surv


def _check(got, want, survivors=None):
    gd, gi, gs = got
    wd, wi = np.asarray(want[0]), np.asarray(want[1])
    assert np.array_equal(gi.numpy(), wi)
    fin = np.isfinite(wd)
    assert np.array_equal(fin, np.isfinite(gd.numpy()))
    np.testing.assert_allclose(gd.numpy()[fin], wd[fin], rtol=1e-5, atol=0)
    assert (gi[5] == -1).all() and int(gs[5]) == 0   # probed nothing
    if survivors is not None:
        assert gs.tolist() == survivors.tolist()


@pytest.mark.parametrize("which", [None, "words1", "words2"],
                         ids=["nofilter", "filter1d", "filter2d"])
@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.L2SqrtExpanded,
                                    DistanceType.InnerProduct],
                         ids=lambda m: m.name)
@pytest.mark.parametrize("bits", [1, 2, 3])
def test_plain_scan_matches_xla(bits, metric, which):
    a = _index(bits, metric)
    fw = _filter(a, which)
    qb = t_scan.auto_query_bits(bits)
    want = _jax_scan(a, fw, k=10, metric=metric, engine="xla", query_bits=qb)
    got = t_scan.bq_list_major_scan(*_torch_args(a, fw), k=10, metric=metric,
                                    epsilon=3.0, engine="torch",
                                    query_bits=qb)
    _check(got, want, _jax_survivors(a, fw, k=10, metric=metric,
                                     query_bits=qb))


@pytest.mark.parametrize("bits,metric,which,k", [
    (1, DistanceType.L2Expanded, "words1", 10),
    (2, DistanceType.InnerProduct, None, 3),
    (3, DistanceType.L2Expanded, None, 1),
], ids=["b1-L2-filter", "b2-IP", "b3-L2-k1"])
def test_plain_scan_matches_pallas_interpret(bits, metric, which, k):
    a = _index(bits, metric)
    fw = _filter(a, which)
    qb = t_scan.auto_query_bits(bits)
    want = _jax_scan(a, fw, k=k, metric=metric, engine="pallas",
                     query_bits=qb)
    got = t_scan.bq_list_major_scan(*_torch_args(a, fw), k=k, metric=metric,
                                    epsilon=3.0, engine="torch",
                                    query_bits=qb)
    _check(got, want)


def test_duplicates_order_by_smallest_id():
    a = _index(1, DistanceType.L2Expanded)
    gd, gi, _ = t_scan.bq_list_major_scan(
        *_torch_args(a, None), k=3, metric=DistanceType.L2Expanded,
        epsilon=3.0, engine="torch")
    assert gi[0].tolist() == [3, 700, 1300]
    assert gd[0].tolist() == [0.0, 0.0, 0.0]


def _emulate_cluster_walk(args, *, k, metric, query_bits, cluster=1,
                          chunk=1024):
    """The kernel's decomposition in plain code: each query walks its own
    sorted probes (positions into the union from ``_walk_plan``) and
    reads the threshold at the start of each list. A list's live rows
    (``live_rows``) are cut in rounds of ``cluster`` slices of at most
    ``chunk`` rows, as the cluster's CTAs cut them; each slice is pruned
    against the list-start threshold and reranked alone, only the
    survivors that beat the list-start k-th entry are kept, and a round's
    kept survivors merge together, taken in reverse CTA order (the
    leader's order does not matter)."""
    (qf, qrot, crot, codes, rnorm, cfac, errw, indices, data, norms, probes,
     fw) = args
    n_lists = indices.shape[0]
    ip_metric = metric == DistanceType.InnerProduct
    uniq, upos = t_scan._walk_plan(probes, n_lists)
    ids_g = union_id_planes(indices, uniq, fw)
    live = live_rows(ids_g)
    q = qf.shape[0]
    out_d = torch.full((q, k), float("inf"))
    out_i = torch.full((q, k), -1, dtype=torch.int32)
    surv = torch.zeros(q, dtype=torch.int32)
    for r in range(q):
        bd, bi = out_d[r:r + 1], out_i[r:r + 1]
        for j in upos[r].tolist():
            if j < 0:
                continue
            lid, n_live = int(uniq[j]), int(live[j])
            est, margin = t_scan._block_estimate(
                qrot[r:r + 1], crot[lid:lid + 1], rnorm[lid][None],
                errw[lid][None], cfac[lid].T, codes[lid],
                dim_ext=crot.shape[1], bits=cfac.shape[2],
                query_bits=query_bits, epsilon=3.0, ip_metric=ip_metric)
            kth = bd[0, k - 1]                  # the list-start threshold
            kth_id = int(bi[0, k - 1])
            per = min(chunk, -(-n_live // cluster)) if n_live else 1
            for base in range(0, n_live, per * cluster):
                parts = []
                for rank in range(cluster):
                    r0 = base + rank * per
                    r1 = min(n_live, r0 + per)
                    sl = torch.arange(r0, max(r0, r1))
                    rows = sl[(ids_g[j][sl] >= 0)
                              & ((est - margin)[0][sl] < kth)]
                    surv[r] += rows.numel()
                    ip = t_scan.tree_sum(data[lid][rows] * qf[r])
                    ex = -ip if ip_metric else torch.clamp(
                        t_scan.tree_sum(qf[r] * qf[r]) + norms[lid][rows]
                        - 2.0 * ip, min=0.0)
                    # only those that beat the list-start k-th entry
                    ids = ids_g[j][rows]
                    keep = (ex < kth) | ((ex == kth) & (ids < kth_id))
                    parts.append((ex[keep], ids[keep]))
                parts.reverse()
                bd, bi = _merge_smallest_id(
                    bd, bi, torch.cat([p[0] for p in parts])[None],
                    torch.cat([p[1] for p in parts])[None], k)
        out_d[r], out_i[r] = bd[0], bi[0]
    if ip_metric:
        out_d = -out_d
    return out_d, out_i, surv


def _gaussian_args(metric: DistanceType):
    """Scan arguments on a port-built index over clustered Gaussian data,
    where every sum rounds; d = 50 pads dim_ext to 64."""
    rng = np.random.default_rng(5)
    cen = rng.standard_normal((12, 50)) * 2
    x = (cen[rng.integers(0, 12, 1200)]
         + rng.standard_normal((1200, 50))).astype(np.float32)
    qf = torch.from_numpy((cen[rng.integers(0, 12, Q)]
                           + rng.standard_normal((Q, 50))).astype(np.float32))
    idx = t_bq.build(CPU, t_bq.IvfBqIndexParams(n_lists=N_LISTS, bits=2,
                                                metric=metric), x)
    probes = torch.from_numpy(rng.integers(0, N_LISTS, (Q, 5))).to(
        torch.int32)
    probes[5, :] = N_LISTS                # a query that probes nothing
    words = torch.from_numpy(rng.integers(0, 2**31, -(-1200 // 32))).to(
        torch.int32)
    return (qf, qf @ idx.rotation.T, idx.centers @ idx.rotation.T,
            idx.codes, idx.rnorm, idx.cfac, idx.errw, idx.indices, idx.data,
            idx.data_norms, probes, words)


@pytest.mark.parametrize("data", ["integer", "gaussian"])
@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.InnerProduct],
                         ids=lambda m: m.name)
def test_cuda_walk_decomposition_matches_plain(metric, data):
    if data == "integer":
        a = _index(2, metric)
        args = _torch_args(a, a["words1"])
    else:
        args = _gaussian_args(metric)
    want = t_scan.bq_list_major_scan(*args, k=10, metric=metric, epsilon=3.0,
                                     engine="torch", query_bits=4)
    got = _emulate_cluster_walk(args, k=10, metric=metric, query_bits=4)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2])
    assert torch.equal(got[0], want[0])
    assert int(got[2][5]) == 0 < int(got[2].sum())


@pytest.mark.parametrize("cluster,chunk", [(1, 1024), (2, 1024), (8, 1024),
                                           (16, 1024), (1, 16), (4, 7)])
@pytest.mark.parametrize("data", ["integer", "gaussian"])
@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.InnerProduct],
                         ids=lambda m: m.name)
def test_cluster_split_walk_matches_plain(metric, data, cluster, chunk):
    """The cluster walk's split (each list's live rows cut into
    ``cluster`` slices per round, every slice pruned against the
    list-start threshold, a round's survivors merged together) equals
    the plain scan bit for bit: distances, ids and rows reranked, with a
    shared filter, sentinel, repeated and empty probes."""
    if data == "integer":
        a = _index(2, metric)
        args = _torch_args(a, a["words1"])
    else:
        args = _gaussian_args(metric)
    want = t_scan.bq_list_major_scan(*args, k=10, metric=metric, epsilon=3.0,
                                     engine="torch", query_bits=4)
    got = _emulate_cluster_walk(args, k=10, metric=metric, query_bits=4,
                                cluster=cluster, chunk=chunk)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2])
    assert torch.equal(got[0], want[0])


def test_cluster_size_follows_the_batch():
    # the H100's 132 SMs at the walk kernel's 4 resident CTAs an SM
    size = functools.partial(t_scan.bq_cluster_size, n_sm=132, ctas_per_sm=4)
    assert [size(q) for q in (0, 1, 10, 16, 33)] == [16] * 5
    assert [size(q) for q in (34, 66)] == [8, 8]
    assert [size(q) for q in (67, 132)] == [4, 4]
    assert [size(q) for q in (133, 264)] == [2, 2]
    assert [size(q) for q in (265, 500, 10_000)] == [1, 1, 1]
    assert size(10, n_sm=8) == 2 and size(100, n_sm=8) == 1
    assert size(10, ctas_per_sm=2) == 16 and size(20, ctas_per_sm=2) == 8
    assert all(size(q) in t_scan.CLUSTER_SIZES for q in range(0, 600, 7))


@pytest.mark.parametrize("n", [1, 3, 32, 50, 64, 100, 128, 129])
def test_tree_sum_is_the_halving_tree(n):
    """tree_sum adds lane i + h to lane i, h halving from the padded
    width, each add rounded to float32; wider zero padding (the kernel
    pads to 32 lanes per tree step) rounds no differently."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((6, n)) * 10.0 ** rng.integers(-3, 4, (6, n))
         ).astype(np.float32)
    width = 1
    while width < n:
        width *= 2
    lanes = np.zeros((6, width), np.float32)
    lanes[:, :n] = x
    while lanes.shape[1] > 1:
        h = lanes.shape[1] // 2
        lanes = (lanes[:, :h] + lanes[:, h:]).astype(np.float32)
    got = t_scan.tree_sum(torch.from_numpy(x))
    assert np.array_equal(got.numpy(), lanes[:, 0])
    wide = torch.nn.functional.pad(torch.from_numpy(x), (0, 4 * width - n))
    assert torch.equal(t_scan.tree_sum(wide), got)
    np.testing.assert_allclose(got.numpy(), x.astype(np.float64).sum(axis=1),
                               rtol=1e-4, atol=1e-4 * np.abs(x).sum())


@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.InnerProduct],
                         ids=lambda m: m.name)
def test_rows_read_is_the_union_of_each_querys_reranked_rows(metric):
    """``rows_read`` marks a slot once whichever queries reranked it: for
    one query it holds as many rows as that query's survivor count, and
    for the batch it is the union of the queries' own marks."""
    a = _index(1, metric)
    args = _torch_args(a, a["words1"])
    indices = args[7]
    kw = dict(k=10, metric=metric, epsilon=3.0, query_bits=4)
    rows = torch.zeros(indices.shape, dtype=torch.bool)
    surv = t_scan._bq_scan_torch(*args, rows_read=rows, **kw)[2]
    union = torch.zeros_like(rows)
    for r in range(Q):
        one = torch.zeros_like(rows)
        solo = [t[r:r + 1] if i in (0, 1, 10) else t
                for i, t in enumerate(args)]
        assert t_scan._bq_scan_torch(*solo, rows_read=one, **kw)[2].tolist() \
            == [int(surv[r])]
        assert int(one.sum()) == int(surv[r])
        union |= one
    assert torch.equal(rows, union)
    assert not bool(rows[indices < 0].any())
    assert int(surv.max()) < int(rows.sum()) < int(surv.sum())


def test_walk_plan_sorts_and_drops_repeats():
    probes = torch.tensor([[3, 1, 3, 7], [7, 7, 7, 7], [5, 2, 0, 1]],
                          dtype=torch.int32)       # 7 = n_lists sentinel
    uniq, upos = t_scan._walk_plan(probes, 7)
    assert uniq.tolist() == [0, 1, 2, 3, 5, 7, 7]
    walked = [[int(uniq[j]) for j in row if j >= 0] for row in upos.tolist()]
    assert walked == [[1, 3], [], [0, 1, 2, 5]]


@pytest.mark.parametrize("seed", [0, 1])
def test_popcount_matches_reference(seed):
    rng = np.random.default_rng(seed)
    v = rng.integers(-2**31, 2**31, 4096, dtype=np.int64).astype(np.int32)
    v[:4] = [0, -1, -2**31, 2**31 - 1]
    want = np.asarray(j_scan._popcount32(jnp.asarray(v)))
    got = t_scan._popcount32(torch.from_numpy(v))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, [bin(int(x) & 0xFFFFFFFF).count("1")
                                 for x in v])


@pytest.mark.parametrize("ip_metric", [False, True])
@pytest.mark.parametrize("bits,query_bits", [(1, 4), (2, 4), (3, 8)])
def test_block_estimate_matches_reference(bits, query_bits, ip_metric):
    rng = np.random.default_rng(bits)
    dim_ext = 64
    resid = rng.standard_normal((300, dim_ext)).astype(np.float32)
    codes, rnorm, cfac, errw = (np.array(t) for t in j_bq._encode(
        jnp.asarray(resid), bits))
    qrot = rng.standard_normal((7, dim_ext)).astype(np.float32)
    crot = rng.standard_normal((1, dim_ext)).astype(np.float32)
    kw = dict(dim_ext=dim_ext, bits=bits, query_bits=query_bits)
    want = j_scan._block_estimate(
        jnp.asarray(qrot), jnp.asarray(crot), jnp.asarray(rnorm)[None],
        jnp.asarray(errw)[None], jnp.asarray(cfac.T), jnp.asarray(codes),
        epsilon=3.0, ip_metric=ip_metric, **kw)
    got = t_scan._block_estimate(
        torch.from_numpy(qrot), torch.from_numpy(crot),
        torch.from_numpy(rnorm)[None], torch.from_numpy(errw)[None],
        torch.from_numpy(cfac.T.copy()), torch.from_numpy(codes),
        epsilon=3.0, ip_metric=ip_metric, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    cross_w, delta_w = j_scan._estimate_block(
        jnp.asarray(qrot - crot), jnp.asarray(codes),
        jnp.asarray(rnorm)[None], jnp.asarray(cfac.T), **kw)
    cross_g, delta_g = t_scan._estimate_block(
        torch.from_numpy(qrot - crot), torch.from_numpy(codes),
        torch.from_numpy(rnorm)[None], torch.from_numpy(cfac.T.copy()), **kw)
    np.testing.assert_allclose(cross_g.numpy(), np.asarray(cross_w),
                               rtol=1e-5, atol=1e-5)
    assert np.array_equal(delta_g.numpy(), np.asarray(delta_w))


@pytest.mark.parametrize("c", [12, 15, 64, 128])
def test_div_by_constant_is_correctly_rounded(c):
    """``_div`` (the estimate's ``/ levels``, the margin's ``/ 12`` and
    ``/ dim_ext``) rounds the exact quotient once, as the kernel's
    ``__fdiv_rn`` does, on whatever device ``x`` lies."""
    rng = np.random.default_rng(c)
    x = (rng.standard_normal(20_000) * 10.0 ** rng.integers(-6, 7, 20_000)
         ).astype(np.float32)
    want = (x.astype(np.float64) / c).astype(np.float32)
    assert np.array_equal(t_scan._div(torch.from_numpy(x), c).numpy(), want)


def test_auto_query_bits_and_margin_match_reference():
    for bits in (1, 2, 3, 4):
        assert t_scan.auto_query_bits(bits) == j_scan.auto_query_bits(bits)
    rng = np.random.default_rng(3)
    qcn, rn, ew = (rng.random((4, 1)).astype(np.float32),
                   rng.random((1, 9)).astype(np.float32),
                   rng.random((1, 9)).astype(np.float32))
    delta = rng.random((4, 1)).astype(np.float32)
    want = j_bq.estimator_margin(*map(jnp.asarray, (qcn, rn, ew, delta)), 64,
                                 3.0)
    got = t_scan.estimator_margin(*map(torch.from_numpy, (qcn, rn, ew,
                                                          delta)), 64, 3.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_resolve_bq_engine():
    data = torch.zeros((2, 8, 4))
    r = t_scan.resolve_bq_engine
    assert r("auto", data=data) == "torch"
    assert r("auto", data=None) == "rank"       # codes-only index
    assert r("torch", data=None) == "rank"
    assert r("rank", data=data) == "rank"
    assert r("cuda", data=data, k=128) == "cuda"
    assert r("cuda", data=data, k=129) == "torch"
    words = torch.zeros(3, dtype=torch.int32)
    assert r("cuda", data=data, filter_words=words) == "cuda"
    assert r("cuda", data=data, filter_words=words[None].expand(2, -1)) \
        == "torch"
    assert r("cuda", data=data.to(torch.bfloat16)) == "torch"
    assert r("cuda", data=torch.zeros((2, 8, 1024))) == "cuda"
    assert r("cuda", data=torch.zeros((2, 8, 1025))) == "torch"
    with pytest.raises(Exception, match="scan_engine"):
        r("pallas", data=data)
