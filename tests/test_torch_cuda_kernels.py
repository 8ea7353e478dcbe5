"""The port's CUDA kernels against their plain PyTorch versions, on the
card. A CUDA kernel has no CPU mode, so every test here needs a CUDA
device and skips without one. The file imports no JAX: on a machine with
a card but without JAX, run it with ``--noconftest`` (tests/conftest.py
imports JAX):

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Integer-valued inputs make every product exact: ids must be equal and
distances equal to float32 rounding (1e-6 relative); that holds for
``fused_knn``'s tensor-core products too (3xTF32 for float32, one bf16
pass for bfloat16). On Gaussian data with mean offset 10 its distances
stay within 4e-6 (|q|^2 + |x|^2) of float64, which one TF32 pass misses.
``select_k_tiles`` equals its plain version (values and columns) on
ties, NaN, +-inf, all-equal rows and rows finite only in their last
chunk, in float32, bfloat16 and float16. The IVF-BQ scan and
the CAGRA beam search run on Gaussian data; they take every sum in their
plain versions' order (``ops.bq_scan.tree_sum``), so their distances,
ids and counts (rows reranked per query; live iterations, candidates and
rows scored per query) equal the plain versions' bit for bit, the IVF-BQ
scan at every cluster size. The tiered scan (cold lists in pinned host
memory, staged into a device ring, in waves when the ring is small)
equals the all-device scan kernel bit for bit on any data;
``stream_read_sum`` equals the float64 sum on integer data and is within
1e-6 sum|x| of it on Gaussian data."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from raft_tpu_torch import Resources
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors import ivf_bq
from raft_tpu_torch.ops.bq_scan import auto_query_bits, bq_list_major_scan
from raft_tpu_torch.ops.fused_topk import (
    _SUPPORTED_METRICS,
    _select_plan,
    fused_knn,
    fused_knn_plain,
    select_k_tiles,
    select_k_tiles_plain,
)
from raft_tpu_torch.ops.ivf_scan import list_major_scan

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check(got, want):
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    fin = torch.isfinite(want[0])
    assert torch.equal(fin, torch.isfinite(got[0]))
    torch.testing.assert_close(got[0][fin], want[0][fin], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("metric", _SUPPORTED_METRICS, ids=lambda m: m.name)
def test_fused_knn_kernel_matches_plain(dev, metric, k, dtype):
    rng = np.random.default_rng(0)
    x = np.where(rng.random((5003, 96)) < 0.5, -1.0, 1.0).astype(np.float32)
    x[4000] = x[9]
    q = np.where(rng.random((70, 96)) < 0.5, -1.0, 1.0).astype(np.float32)
    q[0] = x[9]
    xt = torch.from_numpy(x).to(dev, dtype)
    qt = torch.from_numpy(q).to(dev)
    before = fused_knn.launches
    got = fused_knn(qt, xt, k, metric)
    assert fused_knn.launches == before + 1
    _check(got, fused_knn_plain(qt, xt, k, metric))


@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.InnerProduct],
                         ids=lambda m: m.name)
def test_scan_kernel_matches_plain(dev, metric, k):
    rng = np.random.default_rng(1)
    n_lists, m, d = 24, 136, 64
    data = torch.from_numpy(rng.integers(-3, 4, (n_lists, m, d)).astype(
        np.float32)).to(dev)
    indices = torch.arange(n_lists * m, dtype=torch.int32,
                           device=dev).reshape(n_lists, m)
    indices[:, 100:] = -1                             # padding
    norms = torch.where(indices >= 0, (data * data).sum(dim=2),
                        torch.full_like(indices, float("inf"),
                                        dtype=torch.float32))
    qf = torch.from_numpy(rng.integers(-3, 4, (150, d)).astype(
        np.float32)).to(dev)
    probes = torch.from_numpy(rng.integers(0, n_lists, (150, 6))).to(
        dev, torch.int32)
    probes[::4, 3:] = n_lists                         # sentinel slots
    words = torch.from_numpy(rng.integers(0, 2**31, -(-n_lists * m // 32))
                             ).to(dev, torch.int32)
    for fw in (None, words):
        args = (qf, data, norms, indices, probes, fw)
        before = list_major_scan.launches
        got = list_major_scan(*args, k=k, metric=metric, engine="cuda")
        assert list_major_scan.launches == before + 1
        _check(got, list_major_scan(*args, k=k, metric=metric,
                                    engine="torch"))


@pytest.fixture(scope="module")
def bq_indexes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    res = Resources(device="cuda", seed=3)
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((30, 100)) * 3
    x = (centers[rng.integers(0, 30, 6000)]
         + rng.standard_normal((6000, 100))).astype(np.float32)
    q = (centers[rng.integers(0, 30, 90)]
         + rng.standard_normal((90, 100))).astype(np.float32)
    out = {}
    for bits in (1, 2, 3):
        for metric in (DistanceType.L2Expanded, DistanceType.InnerProduct):
            out[bits, metric] = ivf_bq.build(res, ivf_bq.IvfBqIndexParams(
                n_lists=24, bits=bits, metric=metric), x)
    return out, torch.from_numpy(q).cuda()


@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.InnerProduct],
                         ids=lambda m: m.name)
@pytest.mark.parametrize("bits", [1, 2, 3])
def test_bq_scan_kernel_matches_plain(dev, bq_indexes, bits, metric, k):
    indexes, qf = bq_indexes
    idx = indexes[bits, metric]
    assert idx.dim_ext == 128                     # d = 100: padded lanes
    n_lists = idx.n_lists
    rng = np.random.default_rng(bits)
    probes = torch.from_numpy(rng.integers(0, n_lists, (qf.shape[0], 8))).to(
        dev, torch.int32)
    probes[::5, 4:] = n_lists                     # sentinel slots
    probes[1, :] = n_lists                        # a query that probes nothing
    probes[2, 1] = probes[2, 0]                   # a repeated probe
    words = torch.from_numpy(rng.integers(0, 2**31, -(-6000 // 32))).to(
        dev, torch.int32)
    qrot = qf @ idx.rotation.T
    crot = idx.centers @ idx.rotation.T
    for fw in (None, words):
        args = (qf, qrot, crot, idx.codes, idx.rnorm, idx.cfac, idx.errw,
                idx.indices, idx.data, idx.data_norms, probes, fw)
        kw = dict(k=k, metric=metric, epsilon=3.0,
                  query_bits=auto_query_bits(bits))
        before = bq_list_major_scan.launches
        got = bq_list_major_scan(*args, engine="cuda", **kw)
        assert bq_list_major_scan.launches == before + 1
        want = bq_list_major_scan(*args, engine="torch", **kw)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[2], want[2])
        assert int(got[2][1]) == 0 and (got[1][1] == -1).all()


@pytest.mark.parametrize("q", [1, 10, 90])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_bq_scan_cluster_sizes_equal_plain(dev, bq_indexes, cluster, q):
    """Every cluster size the wrapper can choose gives the plain version's
    distances, ids and rows reranked bit for bit (L2 and IP, bits 1 and
    3, with a shared filter); the wrapper's own choice for 10 queries is
    a cluster of more than one CTA."""
    from raft_tpu_torch.ops import bq_scan

    indexes, qf = bq_indexes
    qf = qf[:q]
    rng = np.random.default_rng(cluster + q)
    for bits, metric in ((1, DistanceType.L2Expanded),
                         (3, DistanceType.InnerProduct)):
        idx = indexes[bits, metric]
        probes = torch.from_numpy(rng.integers(0, idx.n_lists, (q, 8))).to(
            dev, torch.int32)
        probes[::3, 5:] = idx.n_lists
        words = torch.from_numpy(rng.integers(0, 2**31, -(-6000 // 32))).to(
            dev, torch.int32)
        args = (qf, qf @ idx.rotation.T, idx.centers @ idx.rotation.T,
                idx.codes, idx.rnorm, idx.cfac, idx.errw, idx.indices,
                idx.data, idx.data_norms, probes, words)
        kw = dict(k=10, metric=metric, epsilon=3.0,
                  query_bits=auto_query_bits(bits))
        got = bq_scan._bq_scan_cuda(*args, cluster=cluster, **kw)
        assert bq_list_major_scan.last_cluster == cluster
        want = bq_list_major_scan(*args, engine="torch", **kw)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[2], want[2])
        if q == 10:
            bq_list_major_scan(*args, engine="cuda", **kw)
            assert bq_list_major_scan.last_cluster > 1


def _skewed_scan_inputs(dev, d: int, dtype, q: int, seed: int = 3):
    """A packed index on the card whose lists span the work items' shapes:
    one list of 1,300 rows (three row chunks), short and empty lists, -1
    padding past every list; integer values (every product exact);
    probes with sentinel and repeated slots, the long list probed by
    most queries (several query groups)."""
    rng = np.random.default_rng(seed)
    sizes = [1300, 7, 0, 515, 64, 0, 200, 33]
    n_lists, m = len(sizes), max(sizes) + 9
    data = np.zeros((n_lists, m, d), np.float32)
    indices = np.full((n_lists, m), -1, np.int32)
    row = 0
    for lid, size in enumerate(sizes):
        data[lid, :size] = rng.integers(-3, 4, (size, d))
        indices[lid, :size] = np.arange(row, row + size)
        row += size
    data[3, 10] = data[0, 5]                     # a tie across lists
    queries = rng.integers(-3, 4, (q, d)).astype(np.float32)
    probes = rng.integers(0, n_lists, (q, 5)).astype(np.int32)
    probes[: q * 3 // 4, 0] = 0
    probes[::5, 3:] = n_lists                    # sentinel slots
    probes[q // 2, 2] = probes[q // 2, 1]        # a repeated probe
    pt = torch.from_numpy(data).to(dev, dtype)
    pf = pt.to(torch.float32)
    it = torch.from_numpy(indices).to(dev)
    norms = torch.where(it >= 0, (pf * pf).sum(dim=2),
                        torch.full_like(it, float("inf"),
                                        dtype=torch.float32))
    return (torch.from_numpy(queries).to(dev), pt, norms, it,
            torch.from_numpy(probes).to(dev))


@pytest.mark.parametrize("q", [1, 10, 500])
@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("layout", [(128, torch.float32),
                                    (128, torch.bfloat16),
                                    (100, torch.float32),
                                    (33, torch.float32),
                                    (300, torch.float32)],
                         ids=lambda c: f"d{c[0]}-{str(c[1])[6:]}")
def test_scan_kernel_work_items_match_plain(dev, layout, k, q):
    """The work-item scan across its shapes: a list longer than two row
    chunks, several query groups on one list, batch 1, 10 and 500, k up
    to 128, bfloat16 storage, a dimension not a multiple of 32 (100),
    one whose rows are not 16-byte aligned (33: element copies) and one
    past the whole-depth query slab (300: queries staged a stage at a
    time). Ids equal, distances to float32 rounding; L2 and IP."""
    d, dtype = layout
    args = _skewed_scan_inputs(dev, d, dtype, q)
    for metric in (DistanceType.L2Expanded, DistanceType.InnerProduct):
        got = list_major_scan(*args, k=k, metric=metric, engine="cuda")
        _check(got, list_major_scan(*args, k=k, metric=metric,
                                    engine="torch"))


def test_scan_kernel_refuses_unlaunchable_inputs(dev):
    """The wrapper raises on what the kernel cannot take; it never walks
    with the plain version on the card."""
    args = _skewed_scan_inputs(dev, 16, torch.float32, 4)
    for bad, msg in ((dict(k=129), "k <="),
                     (dict(k=10, data=args[1].to(torch.float16)),
                      "float32/bfloat16")):
        a = list(args)
        if "data" in bad:
            a[1] = bad.pop("data")
        before = list_major_scan.launches
        with pytest.raises(Exception, match=msg):
            list_major_scan(*a, metric=DistanceType.L2Expanded,
                            engine="cuda", **bad)
        assert list_major_scan.launches == before


def test_builds_are_reproducible_on_the_card(dev):
    """Two builds from one seed are equal: balanced k-means centers, the
    IVF-Flat lists (adaptive centers after an extend included) and the
    CAGRA graph. The center sums take a fixed order (no float atomics)."""
    from raft_tpu_torch.cluster import kmeans_balanced
    from raft_tpu_torch.neighbors import cagra, ivf_flat

    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    centers = torch.randn(200, 64, generator=g, device="cuda") * 2
    x = centers[torch.randint(0, 200, (60_000,), generator=g,
                              device="cuda")]
    x = x + torch.randn(x.shape, generator=g, device="cuda")

    def build_all():
        res = Resources(device="cuda", seed=0)
        km = kmeans_balanced.fit(res, kmeans_balanced.KMeansBalancedParams(),
                                 x, 256)
        idx = ivf_flat.build(res, ivf_flat.IvfFlatIndexParams(
            n_lists=128, adaptive_centers=True), x[:50_000])
        idx = ivf_flat.extend(res, idx, x[50_000:],
                              torch.arange(50_000, 60_000, device="cuda",
                                           dtype=torch.int32))
        graph = cagra.build(res, cagra.CagraIndexParams(
            graph_degree=32, intermediate_graph_degree=64,
            build_algo=cagra.BuildAlgo.CLUSTER_JOIN), x[:20_000]).graph
        return km, idx, graph

    (k1, i1, g1), (k2, i2, g2) = build_all(), build_all()
    assert torch.equal(k1, k2)
    for name in ("centers", "data", "data_norms", "indices", "list_sizes"):
        assert torch.equal(getattr(i1, name), getattr(i2, name)), name
    assert torch.equal(g1, g2)


def _beam_inputs(seed: int, n: int, d: int, q: int, deg: int, w: int,
                 L: int, samplings: int):
    """A clustered dataset, its exact k-NN graph (degree ``deg``, some
    entries -1), random seeds with -1 holes, ragged row budgets with a
    0, and queries, on the card."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((20, d)) * 3
    x = (centers[rng.integers(0, 20, n)]
         + rng.standard_normal((n, d))).astype(np.float32)
    qs = (centers[rng.integers(0, 20, q)]
          + rng.standard_normal((q, d))).astype(np.float32)
    xt = torch.from_numpy(x)
    dist = (xt * xt).sum(1)[:, None] + (xt * xt).sum(1)[None] - 2 * xt @ xt.T
    dist.fill_diagonal_(float("inf"))
    graph = torch.sort(dist, dim=1, stable=True).indices[:, :deg].to(
        torch.int32)
    graph[::7, deg - 3:] = -1
    c = w * deg
    s = -(-max(L, c) * samplings // c) * c
    seeds = torch.from_numpy(rng.integers(0, n, (q, s))).to(torch.int32)
    seeds[:, 1::5] = -1
    row_iters = torch.from_numpy(rng.integers(0, L // w + 24, q)).to(
        torch.int32)
    row_iters[0] = 0
    return (torch.from_numpy(x).cuda(), torch.from_numpy(qs).cuda(),
            graph.cuda(), seeds.cuda(), row_iters.cuda())


def _bq_plane(x: torch.Tensor, bits: int, seed: int):
    """The record plane of a BQ traversal index over x (the CAGRA build's
    recipe: pinned rotation, codes about the global mean)."""
    from raft_tpu_torch.ops.bq_scan import pack_bq_records

    d = x.shape[1]
    de = -(-d // 32) * 32
    rot = torch.from_numpy(ivf_bq._pinned_rotation(seed, de, d)).cuda()
    center = x.mean(dim=0, keepdim=True)
    codes, rnorm, cfac, errw = ivf_bq._encode((x - center) @ rot.T, bits)
    return pack_bq_records(codes, rnorm, cfac, errw), rot, center @ rot.T


@pytest.mark.parametrize("case", [
    # (metric, dtype, bq bits, k, L, w, deg, q, samplings)
    (DistanceType.L2Expanded, torch.float32, 0, 10, 64, 4, 32, 60, 1),
    (DistanceType.L2SqrtExpanded, torch.bfloat16, 0, 1, 32, 1, 32, 10, 2),
    (DistanceType.InnerProduct, torch.float32, 0, 64, 128, 4, 64, 30, 1),
    (DistanceType.L2Expanded, torch.int8, 0, 10, 256, 2, 64, 20, 1),
    (DistanceType.L2Expanded, torch.float32, 0, 10, 512, 4, 64, 8, 1),
    (DistanceType.L2Expanded, torch.float32, 1, 10, 64, 4, 32, 60, 2),
    (DistanceType.InnerProduct, torch.bfloat16, 2, 10, 128, 4, 32, 30, 1),
    (DistanceType.L2Expanded, torch.int8, 2, 1, 32, 1, 64, 20, 2),
    # neither L nor C = w * deg a power of two
    (DistanceType.L2Expanded, torch.float32, 1, 7, 100, 3, 24, 33, 2),
], ids=lambda c: f"{c[0].name}-{str(c[1])[6:]}-bq{c[2]}-k{c[3]}-L{c[4]}"
                 f"-w{c[5]}-deg{c[6]}")
def test_beam_search_kernel_equals_plain(dev, case):
    """The CAGRA walk's kernel takes every sum in the plain version's
    order: ids, distances and the per-query counts are equal, on
    Gaussian data, BQ traversal included."""
    from raft_tpu_torch.ops.beam_search import beam_search, beam_search_plain

    metric, dtype, bits, k, L, w, deg, q, samplings = case
    x, qs, graph, seeds, row_iters = _beam_inputs(
        k + L + w + deg + q + bits, 2000, 100, q, deg, w, L, samplings)
    if dtype == torch.int8:
        data = torch.clamp(torch.round(x * 20), -127, 127).to(torch.int8)
        qs = torch.round(qs * 20)
    else:
        data = x.to(dtype)
    kw = dict(row_iters=row_iters if q > 10 else None)
    if bits:
        recs, rot, crot = _bq_plane(data.to(torch.float32), bits, 5)
        kw.update(bq_records=recs, bq_qrot=qs @ rot.T, bq_crot=crot,
                  bq_bits=bits, bq_query_bits=auto_query_bits(bits))
    args = (qs, data, graph, seeds, k, L, w, L // w + 24, metric)
    before = beam_search.launches
    got = beam_search(*args, **kw)
    assert beam_search.launches == before + 1
    want = beam_search_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[2], want[2])
    assert int(want[2][:, 1].sum()) > 0
    if kw["row_iters"] is not None:
        assert int(got[2][0, 0]) == 0       # a zero budget walks nothing
    if bits and metric != DistanceType.InnerProduct:
        # the estimate prunes: fewer rows are scored than proposed (with
        # two seed chunks the buffer is full before the second one)
        assert int(want[2][:, 2].sum()) < int(want[2][:, 1].sum())


@pytest.mark.parametrize("bits", [0, 1])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_beam_search_cluster_sizes_equal_plain(dev, cluster, bits):
    """Every cluster size the kernel takes, forced, at batch 1, 10 and 90
    (the wrapper's own pick at each batch too): ids, distances and counts
    equal the plain version's bit for bit, exact and BQ traversal."""
    from raft_tpu_torch.ops import beam_search as bs

    metric = DistanceType.L2Expanded
    x, qs, graph, seeds, row_iters = _beam_inputs(
        31 + cluster + bits, 3000, 128, 90, 32, 4, 64, 2)
    for q in (1, 10, 90):
        kw = dict(row_iters=row_iters[:q], bq_records=None, bq_qrot=None,
                  bq_crot=None, bq_bits=0, bq_query_bits=4, bq_epsilon=3.0,
                  deg=32)
        if bits:
            recs, rot, crot = _bq_plane(x, bits, 5)
            kw.update(bq_records=recs, bq_qrot=qs[:q] @ rot.T, bq_crot=crot,
                      bq_bits=bits, bq_query_bits=auto_query_bits(bits))
        args = (qs[:q], x, graph, seeds[:q], 10, 64, 4, 40, metric)
        checked = bs._check_args(*args[:7], metric, 32, kw["row_iters"],
                                 kw["bq_records"], kw["bq_qrot"],
                                 kw["bq_crot"], bits)
        want = bs.beam_search_plain(*args, **kw)
        for c in (cluster, None):
            got = bs._beam_search_cuda(*args, checked, cluster=c, **kw)
            torch.cuda.synchronize()
            if c is not None:
                assert bs.beam_search.last_cluster <= c
            for g_, w_ in zip(got, want):
                assert torch.equal(g_, w_)


def test_cagra_search_auto_launches_the_kernel(dev):
    """On a CUDA index, ``algo="auto"`` walks with the kernel, one launch
    per query tile, a sample filter takes the ``torch`` engine, and
    shapes past the kernel's limits raise."""
    from raft_tpu_torch.core.bitset import Bitset
    from raft_tpu_torch.neighbors import cagra
    from raft_tpu_torch.ops.beam_search import beam_search

    x, qs, _, _, _ = _beam_inputs(9, 3000, 64, 300, 16, 1, 32, 1)
    index = cagra.build(Resources(device="cuda"), cagra.CagraIndexParams(
        graph_degree=16, intermediate_graph_degree=32,
        build_algo=cagra.BuildAlgo.CLUSTER_JOIN, bq_bits=1), x)
    sp = cagra.CagraSearchParams(itopk_size=64, search_width=2,
                                 query_tile=128)
    before = beam_search.launches
    d, i = cagra.search(None, sp, index, qs, 10)
    assert beam_search.launches == before + 3        # tiles 128, 128, 44
    truth = torch.sort((x * x).sum(1)[None] - 2 * qs @ x.T, dim=1,
                       stable=True).indices[:, :10]
    hit = (i[:, :, None] == truth[:, None, :]).any(dim=2)
    assert float(hit.float().mean()) >= 0.9
    mask = np.ones(3000, bool)
    mask[::2] = False
    before = beam_search.launches
    _, fi = cagra.search(None, sp, index, qs, 10,
                         sample_filter=Bitset.from_mask(mask))
    assert beam_search.launches == before
    assert bool((fi % 2 == 1).all())
    # past the kernel's shared-memory shapes ``auto`` raises, never walks
    # with the plain version on the card
    for kw, msg in (({"itopk_size": 513}, "itopk L <= 512"),
                    ({"search_width": 17}, "w\\*deg <= 256")):
        before = beam_search.launches
        with pytest.raises(Exception, match=msg):
            cagra.search(None, cagra.CagraSearchParams(**kw), index, qs, 10)
        assert beam_search.launches == before


@pytest.mark.parametrize("c", [12, 15, 128])
def test_bq_div_by_constant_is_correctly_rounded(dev, c):
    """The plain scan's divisions by a constant round as the kernel's
    ``__fdiv_rn`` on the card too (PyTorch's CUDA division by a host
    scalar multiplies by its reciprocal instead)."""
    from raft_tpu_torch.ops.bq_scan import _div

    rng = np.random.default_rng(c)
    x = (rng.standard_normal(100_000) * 10.0 ** rng.integers(-6, 7, 100_000)
         ).astype(np.float32)
    want = (x.astype(np.float64) / c).astype(np.float32)
    got = _div(torch.from_numpy(x).to(dev), c).cpu().numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [16384, 100003])
@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("select_min", [True, False])
def test_select_k_kernel_matches_plain(dev, select_min, k, n, dtype):
    rng = np.random.default_rng(k)
    v = rng.integers(-1000, 1000, (37, n)).astype(np.float32)  # many ties
    v[3, 5:] = np.inf if select_min else -np.inf       # short of finite
    v[4, ::7] = np.nan
    v[5, :] = -np.inf if select_min else np.inf        # never enters
    vt = torch.from_numpy(v).to(dev, dtype)
    before = select_k_tiles.launches
    got = select_k_tiles(vt, k, select_min)
    assert select_k_tiles.launches == before + 1
    want = select_k_tiles_plain(vt, k, select_min)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])
    assert (got[1][5] == -1).all()


def _offset_gaussian(seed: int, shape):
    """Gaussian data with mean offset 10 (large norms, as SIFT's)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 10.0).astype(np.float32)


# the float64 bound of the tensor-core products (3xTF32 for float32, one
# bf16 pass for bf16 data): 4e-6 (|q|^2 + |x|^2); one TF32 pass misses it
KNN_F64_BOUND = 4e-6


@pytest.mark.parametrize("k", [1, 10, 33, 64])
@pytest.mark.parametrize("d", [96, 128])
@pytest.mark.parametrize("q", [1, 70, 500])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_knn_kernel_within_float64_bound(dev, dtype, q, d, k):
    """Distances within 4e-6 (|q|^2 + |x|^2) of the float64 distances of
    the returned ids, and every returned id's float64 distance within that
    tolerance of the float64 k-th (bf16 data: of the bf16-rounded data
    and queries, the kernel's inputs)."""
    n = 20_011
    xt = torch.from_numpy(_offset_gaussian(1, (n, d))).to(dev, dtype)
    qt = torch.from_numpy(_offset_gaussian(2, (q, d))).to(dev)
    dist, ids = fused_knn(qt, xt, k)
    torch.cuda.synchronize()
    x64 = xt.to(torch.float64)
    q64 = qt.to(dtype).to(torch.float64)
    xn = (x64 * x64).sum(dim=1)
    qn = (q64 * q64).sum(dim=1, keepdim=True)
    d64 = qn + xn[None, :] - 2.0 * (q64 @ x64.T)
    assert bool((ids >= 0).all())
    assert all(len(set(r)) == k for r in ids.tolist())
    idl = ids.to(torch.int64)
    got64 = torch.gather(d64, 1, idl)
    tol = KNN_F64_BOUND * (qn + xn[idl])
    assert bool(((dist.to(torch.float64) - got64).abs() <= tol).all())
    kth = torch.sort(d64, dim=1).values[:, k - 1 : k]
    assert bool((got64 <= kth + tol).all())


@pytest.mark.parametrize("k", [10, 64])
@pytest.mark.parametrize("d", [33, 100, 200, 960])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_knn_kernel_depths_match_plain(dev, dtype, d, k):
    """Depths off the main path: rows that are not 16-byte aligned (d 33;
    bf16 d 100) take element copies, and depths whose query tile does not
    fit beside the ring (float32 d 200 and 960, bf16 960) stream the
    queries' columns with each stage. +-1 data: every product is exact."""
    rng = np.random.default_rng(d)
    x = np.where(rng.random((3001, d)) < 0.5, -1.0, 1.0).astype(np.float32)
    x[2000] = x[3]
    q = np.where(rng.random((70, d)) < 0.5, -1.0, 1.0).astype(np.float32)
    q[0] = x[3]
    xt = torch.from_numpy(x).to(dev, dtype)
    qt = torch.from_numpy(q).to(dev)
    for metric in (DistanceType.L2Expanded, DistanceType.InnerProduct):
        _check(fused_knn(qt, xt, k, metric),
               fused_knn_plain(qt, xt, k, metric))


def test_one_tf32_pass_misses_the_float64_bound(dev):
    """The test above has teeth: one TF32 pass (the card's own TF32
    matmul) misses the bound on the same data."""
    n, d, q = 20_011, 128, 70
    x = torch.from_numpy(_offset_gaussian(1, (n, d))).to(dev)
    qt = torch.from_numpy(_offset_gaussian(2, (q, d))).to(dev)
    x64, q64 = x.double(), qt.double()
    xn, qn = (x64 * x64).sum(dim=1), (q64 * q64).sum(dim=1, keepdim=True)
    d64 = qn + xn[None, :] - 2.0 * (q64 @ x64.T)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ip = qt @ x.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    d1 = qn + xn[None, :] - 2.0 * ip.double()
    assert float(((d1 - d64).abs() / (qn + xn[None, :])).max()) \
        > KNN_F64_BOUND


def _select_cases(n: int, b: int, k: int, select_min: bool, last_chunk: int,
                  seed: int):
    """Integer values (many exact ties) with special rows: all equal, only
    finite in the row's last chunk, NaN every 7th, fewer than k finite,
    none finite."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-1000, 1000, (b, n)).astype(np.float32)
    far = np.inf if select_min else -np.inf
    if b >= 5:
        v[0, :] = 5.0
        v[1, :last_chunk] = far
        v[2, ::7] = np.nan
        v[3, min(k, n) // 2:] = far
        v[4, :] = -far
    return v


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("k", [1, 10, 33, 64, 128])
@pytest.mark.parametrize("shape", [(37, 16384), (37, 100003), (37, 2048),
                                   (1, 100003), (2048, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_select_k_kernel_cases_equal_plain(dev, dtype, shape, k, select_min):
    b, n = shape
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, chunk = _select_plan(b, n, sms)
    v = _select_cases(n, b, k, select_min, (splits - 1) * chunk, seed=k)
    vt = torch.from_numpy(v).to(dev, dtype)
    before = select_k_tiles.launches
    got = select_k_tiles(vt, k, select_min)
    assert select_k_tiles.launches == before + 1
    want = select_k_tiles_plain(vt, k, select_min)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


def _tier_inputs(dev, seed: int, integer: bool):
    """A small packed index on the card (24 lists of 136 slots, -1
    padding past 100), its queries and probes (sentinel slots, a repeated
    probe) and a shared filter."""
    rng = np.random.default_rng(seed)
    n_lists, m, d = 24, 136, 64
    raw = (rng.integers(-3, 4, (n_lists, m, d)) if integer
           else rng.standard_normal((n_lists, m, d)))
    data = torch.from_numpy(raw.astype(np.float32)).to(dev)
    indices = torch.arange(n_lists * m, dtype=torch.int32,
                           device=dev).reshape(n_lists, m)
    indices[:, 100:] = -1
    norms = torch.where(indices >= 0, (data * data).sum(dim=2),
                        torch.full_like(indices, float("inf"),
                                        dtype=torch.float32))
    qraw = (rng.integers(-3, 4, (150, d)) if integer
            else rng.standard_normal((150, d)))
    qf = torch.from_numpy(qraw.astype(np.float32)).to(dev)
    probes = torch.from_numpy(rng.integers(0, n_lists, (150, 6))).to(
        dev, torch.int32)
    probes[::4, 3:] = n_lists
    probes[1, 1] = probes[1, 0]
    words = torch.from_numpy(rng.integers(0, 2**31, -(-n_lists * m // 32))
                             ).to(dev, torch.int32)
    return data, norms, indices, qf, probes, words


def _tiers(data, hot_lists, cold_lists):
    """The split planes: hot on the card, cold in pinned host memory."""
    from raft_tpu_torch.neighbors.tiered import _slot_maps

    n_lists = data.shape[0]
    hot_lists = np.asarray(hot_lists, np.int64)
    cold_lists = np.asarray(cold_lists, np.int64)
    hmap, cmap = _slot_maps(hot_lists, cold_lists, n_lists)
    hot = data[torch.from_numpy(hot_lists).to(data.device)].contiguous()
    cold = data[torch.from_numpy(cold_lists).to(data.device)].cpu()
    return (hot, cold.pin_memory(), torch.from_numpy(hmap).to(data.device),
            torch.from_numpy(cmap).to(data.device))


def _tier_c_entry(hot, cold):
    """The tier_scan C entry called with a cold plane and nothing to do:
    returns its error code (the cold plane's check comes first)."""
    from raft_tpu_torch.ops import _build

    z = torch.zeros(64, dtype=torch.int32, device=hot.device)
    stream = torch.cuda.current_stream().cuda_stream
    return _build.load("tier_scan")(
        z.data_ptr(), hot.data_ptr(), cold.data_ptr(), *[z.data_ptr()] * 16,
        1, 1, 1, 1, 1, 0, 0, 0, 0, *[z.data_ptr()] * 9, stream, stream,
        None)


TIER_SPLITS = {"alternate": (list(range(0, 24, 2)), list(range(1, 24, 2))),
               "one-cold": (list(range(1, 24)), [0]),
               "one-hot": ([5], [i for i in range(24) if i != 5])}


@pytest.mark.parametrize("split", list(TIER_SPLITS))
@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.InnerProduct],
                         ids=lambda m: m.name)
def test_tier_scan_kernel_matches_plain_and_all_device_scan(dev, metric, k,
                                                            split):
    """The dual-source kernel equals its plain version (ids exactly, on
    integer data), and the all-device scan kernel on the un-split planes
    bit for bit, on integer and Gaussian data."""
    from raft_tpu_torch.ops.tier_scan import tiered_list_major_scan

    for integer in (True, False):
        data, norms, indices, qf, probes, words = _tier_inputs(
            dev, k, integer)
        hot, cold, hmap, cmap = _tiers(data, *TIER_SPLITS[split])
        for fw in (None, words):
            args = (qf, hot, cold, hmap, cmap, norms, indices, probes, fw)
            before = tiered_list_major_scan.launches
            got = tiered_list_major_scan(*args, k=k, metric=metric,
                                         engine="cuda")
            assert tiered_list_major_scan.launches == before + 1
            whole = list_major_scan(qf, data, norms, indices, probes, fw,
                                    k=k, metric=metric, engine="cuda")
            torch.cuda.synchronize()
            assert torch.equal(got[1], whole[1])
            assert torch.equal(got[0], whole[0])
            if integer:
                _check(got, tiered_list_major_scan(*args, k=k, metric=metric,
                                                   engine="torch"))


def test_tier_scan_refuses_a_pageable_cold_tier(dev):
    """A pageable cold plane raises at the wrapper, and the C entry itself
    refuses a cold pointer that is not page-locked host memory."""
    from raft_tpu_torch.core.validation import RaftError
    from raft_tpu_torch.ops.tier_scan import tiered_list_major_scan

    data, norms, indices, qf, probes, _ = _tier_inputs(dev, 0, True)
    hot, cold, hmap, cmap = _tiers(data, *TIER_SPLITS["alternate"])
    before = tiered_list_major_scan.launches
    for bad in (cold.clone(), cold.to(dev)):       # pageable, device
        with pytest.raises(RaftError, match="pinned"):
            tiered_list_major_scan(qf, hot, bad, hmap, cmap, norms, indices,
                                   probes, k=10,
                                   metric=DistanceType.L2Expanded,
                                   engine="cuda")
        assert _tier_c_entry(hot, bad) != 0
    assert tiered_list_major_scan.launches == before
    assert _tier_c_entry(hot, cold) == 0            # pinned: taken


TIER_STAGE_CASES = ["waves of one list", "waves of two lists",
                    "no cold list probed", "no cold tier"]


@pytest.mark.parametrize("case", TIER_STAGE_CASES)
@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.InnerProduct],
                         ids=lambda m: m.name)
def test_tier_scan_staged_cases_equal_all_device_scan(dev, metric, case):
    """The staging edge cases: a ring smaller than the probed cold set
    (several waves, each half of the ring reused), a request that probes
    no cold list and an index with no cold tier (no wave, one scan).
    Each equals the all-device scan kernel and the plain version bit for
    bit, with and without a shared filter, and stages each probed cold
    list once: its real rows rounded up to the 64-row tile."""
    from raft_tpu_torch.core import tracing
    from raft_tpu_torch.ops.tier_scan import tiered_list_major_scan

    data, norms, indices, qf, probes, words = _tier_inputs(dev, 7, True)
    n_lists, m, d = data.shape
    lists = list(range(n_lists))
    block = 128 * d * 4                 # 100 real rows -> 128 staged
    workspace, per_wave = 1 << 30, n_lists
    hot_lists, cold_lists = TIER_SPLITS["alternate"]
    if case == "waves of one list":
        workspace, per_wave = 2 * block, 1
    elif case == "waves of two lists":
        workspace, per_wave = 5 * block, 2
    elif case == "no cold list probed":
        probes = (probes // 2) * 2      # even lists (and the sentinel 24)
    else:
        hot_lists, cold_lists = lists, []
    hot, cold, hmap, cmap = _tiers(data, hot_lists, cold_lists)
    cold_probed = sorted({int(v) for v in probes.flatten().tolist()}
                         & set(cold_lists))
    for fw in (None, words):
        args = (qf, hot, cold, hmap, cmap, norms, indices, probes, fw)
        c0 = tracing.counters("tier.")
        got = tiered_list_major_scan(*args, k=10, metric=metric,
                                     engine="cuda", workspace_bytes=workspace)
        c1 = tracing.counters("tier.")
        staged = c1.get("tier.cold_bytes_staged", 0.0) - c0.get(
            "tier.cold_bytes_staged", 0.0)
        n_waves = c1.get("tier.stage_waves", 0.0) - c0.get(
            "tier.stage_waves", 0.0)
        whole = list_major_scan(qf, data, norms, indices, probes, fw, k=10,
                                metric=metric, engine="cuda")
        torch.cuda.synchronize()
        assert torch.equal(got[1], whole[1])
        assert torch.equal(got[0], whole[0])
        _check(got, tiered_list_major_scan(*args, k=10, metric=metric,
                                           engine="torch"))
        if fw is None:
            assert staged == len(cold_probed) * block
            assert n_waves == -(-len(cold_probed) // per_wave)
            if per_wave < n_lists:
                assert n_waves > 2


@pytest.mark.parametrize("d", [100, 128])
@pytest.mark.parametrize("n", [1, 1000, 1 << 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_read_sum_kernel_matches_plain(dev, dtype, n, d):
    """Integer-valued data: every partial sum is an integer below 2^24,
    exact in any order, so the kernel equals the plain version and the
    float64 sum. Gaussian data: both within 1e-6 x sum|x| of the float64
    sum per column (the summation orders differ)."""
    from raft_tpu_torch.ops.fused_topk import (
        stream_read_sum,
        stream_read_sum_plain,
    )

    g = torch.Generator(device=dev)
    g.manual_seed(n + d)
    for integer in (True, False):
        x = (torch.randint(-3, 4, (n, d), generator=g, device=dev).float()
             if integer else torch.randn(n, d, generator=g, device=dev))
        x = x.to(dtype)
        before = stream_read_sum.launches
        got = stream_read_sum(x)
        assert stream_read_sum.launches == before + 1
        want = stream_read_sum_plain(x)
        ref = x.double().sum(dim=0, keepdim=True)
        assert got.shape == (1, d) and got.dtype == torch.float32
        if integer:
            assert torch.equal(got, want)
            assert torch.equal(got.double(), ref)
        else:
            tol = 1e-6 * x.double().abs().sum(dim=0, keepdim=True)
            assert bool(((got.double() - ref).abs() <= tol).all())
            assert bool(((want.double() - ref).abs() <= tol).all())
        assert torch.equal(stream_read_sum(x), got)     # run to run


def test_tiered_search_on_the_card(dev):
    """A tiered index on the card: the cold tier is pinned host memory,
    search launches the dual-source kernel (and not the all-device one)
    and equals ivf_flat.search bit for bit, before and after an epoch."""
    from raft_tpu_torch.core import memwatch
    from raft_tpu_torch.neighbors import ivf_flat, tiered
    from raft_tpu_torch.ops.tier_scan import tiered_list_major_scan

    res = Resources(device="cuda", seed=4)
    rng = np.random.default_rng(4)
    centers = rng.standard_normal((50, 48)) * 3
    x = (centers[rng.integers(0, 50, 8000)]
         + rng.standard_normal((8000, 48))).astype(np.float32)
    q = torch.from_numpy(x[:300] + 0.1).to(dev)
    index = ivf_flat.build(res, ivf_flat.IvfFlatIndexParams(n_lists=32), x)
    t = tiered.build_tiered(index, hot_fraction=0.5)
    assert t.host_resident and t.cold_data.is_pinned()
    assert memwatch.memory_tier(t.cold_data) == "host"
    sp = tiered.TieredSearchParams(n_probes=8)
    want = ivf_flat.search(res, ivf_flat.IvfFlatSearchParams(n_probes=8),
                           index, q, 10)
    for _ in range(2):
        scans, tiers = list_major_scan.launches, \
            tiered_list_major_scan.launches
        got = tiered.search(res, sp, t, q, 10)
        torch.cuda.synchronize()
        assert tiered_list_major_scan.launches == tiers + 1
        assert list_major_scan.launches == scans
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        promo, demo = [int(t.cold_lists[0])], [int(t.hot_lists[0])]
        tiered.apply_plan(t, promo, demo, width=1)
        assert int(t.hot_slot_map[promo[0]]) >= 0


def test_memory_ledger_live_headroom(dev):
    """Live device stats: a tensor's bytes leave the headroom while it
    lives, and come back when it is freed, although the caching allocator
    keeps them reserved; a live ledger sizes the hot tier from that."""
    from raft_tpu_torch.core import memwatch
    from raft_tpu_torch.neighbors import ivf_flat, tiered

    stats = memwatch.device_memory_stats()
    assert stats["supported"]
    card = stats["devices"][torch.cuda.current_device()]
    assert 0 < card["in_use_bytes"] <= card["peak_bytes"] <= card[
        "limit_bytes"]
    ledger = memwatch.MemoryLedger()
    torch.cuda.synchronize()
    before = ledger.headroom_bytes()
    x = torch.empty(1 << 28, dtype=torch.uint8, device=dev)
    during = ledger.headroom_bytes()
    del x
    after = ledger.headroom_bytes()
    assert torch.cuda.memory_reserved() - torch.cuda.memory_allocated() \
        >= 1 << 28
    assert before - during == 1 << 28
    assert after == before
    index = ivf_flat.build(Resources(device="cuda"),
                           ivf_flat.IvfFlatIndexParams(n_lists=16),
                           torch.randn(4000, 32, device=dev))
    block = index.max_list_size * 32 * 4
    assert tiered.resolve_hot_slots(index, ledger=ledger) == 15
    ledger.reserve("hold", int(ledger.headroom_bytes()) - 3 * block)
    assert tiered.resolve_hot_slots(index, ledger=ledger,
                                    safety_fraction=0.0) == 3


# ---------------------------------------------------------------------------
# IVF-PQ: the LUT scan kernel (csrc/ivf_pq_scan.cu) against its plain
# version, bit for bit, over metric x codebook kind x pq_bits x lut_dtype
# x k, with shared and per-query filters, sentinel probe slots, odd pq_dim
# and three-wide subspaces, and LUTs too large for shared memory
# ---------------------------------------------------------------------------

PQ_LUTS = (torch.float32, torch.bfloat16, torch.float8_e4m3fn,
           torch.float8_e5m2)


def _pq_scan_case(dev, ip_metric, per_cluster, bits, k, case, pq_dim=None,
                  L=None, m=300, q=40, hot=None):
    """Random scan inputs: 9 lists of ``m`` slots (ids -1 in the last 50
    and at every 37th slot), ``q`` queries x 5 probe slots (drawn with
    repeats, each repeat made the sentinel; with ``hot``, every query's
    first slot probes list ``hot``)."""
    from raft_tpu_torch.neighbors.ivf_pq import _pack_nibbles
    from raft_tpu_torch.ops.ivf_pq_scan import codebook_norms, dedup_slots

    rng = np.random.default_rng(case)
    n_lists, p = 9, 5
    pq_dim = pq_dim or (6, 16, 64)[case % 3]
    L = L or 2 + case % 2
    book = 1 << bits
    cb = torch.from_numpy(rng.standard_normal(
        (n_lists if per_cluster else pq_dim, book, L)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, book, (n_lists, m, pq_dim)
                                          ).astype(np.uint8))
    packed = bits == 4 and pq_dim % 2 == 0
    if packed:
        codes = _pack_nibbles(codes)
    ids = rng.permutation(n_lists * m).reshape(n_lists, m).astype(np.int32)
    ids[:, m - 50:] = -1
    ids[:, ::37] = -1
    probes = rng.integers(0, n_lists, (q, p)).astype(np.int32)
    if hot is not None:
        probes[:, 0] = hot
    probes[::3, 3:] = n_lists                          # ragged budgets
    probes = dedup_slots(torch.from_numpy(probes), n_lists)
    shape = (q, pq_dim * L) if ip_metric else (q, p, pq_dim * L)
    qres = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    base = (torch.from_numpy(rng.standard_normal((q, p)).astype(np.float32))
            if ip_metric else None)
    n_words = -(-n_lists * m // 32)
    fw = [None, rng.integers(-2**31, 2**31, n_words),
          rng.integers(-2**31, 2**31, (q, n_words))][case % 3]
    to = (lambda t: None if t is None else torch.as_tensor(t).to(dev))
    return dict(qres=to(qres), base=to(base), codebooks=to(cb),
                cb_norms=None if ip_metric else to(codebook_norms(cb)),
                codes=to(codes), indices=to(torch.from_numpy(ids)),
                probes=to(probes),
                filter_words=None if fw is None else to(
                    torch.from_numpy(fw.astype(np.int32)))), packed


# the list-major kernel's work items: a list probed by more pairs than an
# item holds, lists longer than two chunks of rows, a batch of one
PQ_ITEM_SHAPES = (dict(q=70, hot=3), dict(m=1300), dict(q=1))


@pytest.mark.parametrize("k", [10, 258])
@pytest.mark.parametrize("lut", PQ_LUTS, ids=str)
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("per_cluster", [False, True])
@pytest.mark.parametrize("ip_metric", [False, True])
def test_ivf_pq_scan_kernel_matches_plain(dev, ip_metric, per_cluster, bits,
                                          lut, k):
    from raft_tpu_torch.ops.ivf_pq_scan import ivf_pq_scan

    for case in range(3 + len(PQ_ITEM_SHAPES)):
        shape = PQ_ITEM_SHAPES[case - 3] if case >= 3 else {}
        args, packed = _pq_scan_case(dev, ip_metric, per_cluster, bits, k,
                                     case + 7 * k, **shape)
        kw = dict(k=k, ip_metric=ip_metric, per_cluster=per_cluster,
                  lut_dtype=lut, packed=packed)
        before = ivf_pq_scan.launches
        got = ivf_pq_scan(**args, **kw, engine="cuda")
        assert ivf_pq_scan.launches == before + 1
        want = ivf_pq_scan(**args, **kw, engine="torch")
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0], want[0])
        assert (got[1] >= 0).any() or shape.get("q") == 1


@pytest.mark.parametrize("lut", [torch.float32, torch.bfloat16,
                                 torch.float8_e5m2], ids=str)
@pytest.mark.parametrize("ip_metric", [False, True])
@pytest.mark.parametrize("shape", [(240, 4, 10), (240, 4, 258),
                                   (196, 4, 258), (512, 1, 10)],
                         ids=lambda s: "pq_dim%d-len%d-k%d" % s)
def test_ivf_pq_scan_kernel_builds_large_luts_in_parts(dev, shape, ip_metric,
                                                       lut):
    """Tables past shared memory (an fp32 table of pq_dim 240 at 8 bits is
    240 KB; pq_dim 196 is 196 KB beside k=258's queues) take the
    per-pair instance, which builds them in parts, on plain lists and on
    a list probed by every query: still the plain version bit for bit."""
    from raft_tpu_torch.ops.ivf_pq_scan import ivf_pq_scan

    pq_dim, L, k = shape
    for items in ({}, dict(q=70, hot=4, m=700)):
        args, packed = _pq_scan_case(dev, ip_metric, False, 8, k, pq_dim + k,
                                     pq_dim=pq_dim, L=L, **items)
        kw = dict(k=k, ip_metric=ip_metric, per_cluster=False, lut_dtype=lut,
                  packed=packed)
        got = ivf_pq_scan(**args, **kw, engine="cuda")
        want = ivf_pq_scan(**args, **kw, engine="torch")
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
        assert (got[1] >= 0).any()


# the dual-source fetch of a tiered index: the codes plane split into a
# hot plane on the card and a cold plane in pinned host memory
PQ_TIER_SPLITS = {"hot-only": (list(range(9)), []),
                  "half-cold": ([0, 2, 4, 6, 8], [1, 3, 5, 7]),
                  "all-cold": ([], list(range(9)))}


def _pq_tiers(args, split):
    """``args``' codes split by ``PQ_TIER_SPLITS[split]``: the tiered
    keywords of ``ivf_pq_scan`` (hot codes, cold codes, slot maps)."""
    hot_lists, cold_lists = PQ_TIER_SPLITS[split]
    hot, cold, hmap, cmap = _tiers(args["codes"], hot_lists, cold_lists)
    return dict(args, codes=hot, cold_codes=cold, hot_slot_map=hmap,
                cold_slot_map=cmap)


@pytest.mark.parametrize("split", list(PQ_TIER_SPLITS))
@pytest.mark.parametrize("lut", PQ_LUTS, ids=str)
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("ip_metric", [False, True])
def test_ivf_pq_scan_dual_source_equals_plain_and_all_device(
        dev, ip_metric, bits, lut, split):
    """The tiered kernel (cold lists staged into a device ring) against
    its plain version on the same split planes and the all-device kernel
    on the whole plane, bit for bit; then with a ring of two lists'
    bytes, so the waves take turns in its halves."""
    from raft_tpu_torch.core import tracing
    from raft_tpu_torch.ops import ivf_pq_scan as ops

    for case in range(3 + len(PQ_ITEM_SHAPES)):
        shape = PQ_ITEM_SHAPES[case - 3] if case >= 3 else {}
        args, packed = _pq_scan_case(dev, ip_metric, case % 2 == 1, bits,
                                     10, case + 11, **shape)
        kw = dict(k=10, ip_metric=ip_metric, per_cluster=case % 2 == 1,
                  lut_dtype=lut, packed=packed)
        want = ops.ivf_pq_scan(**args, **kw, engine="cuda")
        tiers = _pq_tiers(args, split)
        plain = ops.ivf_pq_scan(**tiers, **kw, engine="torch")
        m, row_bytes = args["codes"].shape[1:]
        for ring in (None, 2 * m * row_bytes):
            before = ops.ivf_pq_scan.launches
            staged0 = tracing.get_counter("tier.cold_bytes_staged")
            got = ops.ivf_pq_scan(**tiers, **kw, engine="cuda",
                                  workspace_bytes=ring)
            torch.cuda.synchronize()
            assert ops.ivf_pq_scan.launches == before + 1
            for other in (want, plain):
                assert torch.equal(got[1], other[1])
                assert torch.equal(got[0], other[0])
            plan = ops._launch_tiered.last_plan
            staged = tracing.get_counter("tier.cold_bytes_staged") - staged0
            assert staged == plan.staged_bytes
            if split == "hot-only":
                assert plan.n_waves == 0
            elif ring is not None and plan.n_waves > 2:
                assert plan.reuse


@pytest.mark.parametrize("lut", PQ_LUTS, ids=str)
def test_ivf_pq_scan_dual_source_builds_large_luts_in_parts(dev, lut):
    """pq_dim 240 (a table past shared memory: the per-pair instance)
    over half-cold and all-cold splits, with a small ring too."""
    from raft_tpu_torch.ops import ivf_pq_scan as ops

    for ip_metric in (False, True):
        args, packed = _pq_scan_case(dev, ip_metric, False, 8, 10, 240,
                                     pq_dim=240, L=4, m=200)
        kw = dict(k=10, ip_metric=ip_metric, per_cluster=False,
                  lut_dtype=lut, packed=packed)
        want = ops.ivf_pq_scan(**args, **kw, engine="cuda")
        for split in ("half-cold", "all-cold"):
            tiers = _pq_tiers(args, split)
            for ring in (None, 2 * 200 * 240):
                got = ops.ivf_pq_scan(**tiers, **kw, engine="cuda",
                                      workspace_bytes=ring)
                torch.cuda.synchronize()
                assert torch.equal(got[1], want[1])
                assert torch.equal(got[0], want[0])


def test_ivf_pq_scan_dual_source_refuses_a_pageable_cold_plane(dev):
    """A pageable or device cold plane raises at the wrapper, before any
    launch, and the C entry refuses a cold pointer that is not page-locked
    host memory."""
    import ctypes

    from raft_tpu_torch.core.validation import RaftError
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.ops import ivf_pq_scan as ops

    args, packed = _pq_scan_case(dev, False, False, 8, 10, 3)
    tiers = _pq_tiers(args, "half-cold")
    kw = dict(k=10, ip_metric=False, per_cluster=False,
              lut_dtype=torch.float32, packed=packed, engine="cuda")
    before = ops.ivf_pq_scan.launches
    for bad in (tiers["cold_codes"].clone(), tiers["cold_codes"].to(dev)):
        with pytest.raises(RaftError, match="pinned"):
            ops.ivf_pq_scan(**dict(tiers, cold_codes=bad), **kw)
    assert ops.ivf_pq_scan.launches == before
    entry = _build.function(
        "ivf_pq_scan", "raft_ivf_pq_scan_tiered",
        _build.SIGNATURES["ivf_pq_scan"][1][:-1]
        + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
        + [ctypes.c_void_p] * 6)
    z = torch.zeros(64, dtype=torch.int32, device=dev)
    zi = np.zeros(4, np.int64)
    stream = torch.cuda.current_stream().cuda_stream
    for bad in (tiers["cold_codes"].clone(), tiers["cold_codes"].to(dev)):
        err = entry(*[z.data_ptr()] * 8, 0, *[z.data_ptr()] * 6,
                    *[1] * 13, 1, 1, 1, *[z.data_ptr()] * 4, z.data_ptr(),
                    bad.data_ptr(), z.data_ptr(), 1, 0,
                    *[zi.ctypes.data] * 4, stream, stream)
        assert err != 0


def test_tiered_pq_search_on_the_card(dev):
    """``build_tiered_pq`` on a card index: the cold codes pinned, every
    search through the dual-source kernel equal to ``ivf_pq.search`` bit
    for bit before and after a placement epoch, at two ring sizes."""
    from raft_tpu_torch.neighbors import ivf_pq, tiered
    from raft_tpu_torch.ops.ivf_pq_scan import ivf_pq_scan

    res = Resources(device="cuda", seed=3)
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((24, 32)) * 3
    x = (centers[rng.integers(0, 24, 6000)]
         + rng.standard_normal((6000, 32))).astype(np.float32)
    q = torch.from_numpy((centers[rng.integers(0, 24, 90)]
                          + rng.standard_normal((90, 32))).astype(
        np.float32)).to(dev)
    index = ivf_pq.build(res, ivf_pq.IvfPqIndexParams(n_lists=24, pq_dim=16),
                         x)
    t = tiered.build_tiered_pq(index, hot_fraction=0.5)
    assert t.host_resident and t.cold_codes.is_pinned()
    sp = ivf_pq.IvfPqSearchParams(n_probes=8)
    want = ivf_pq.search(res, sp, index, q, 10)
    small = Resources(device="cuda", seed=3,
                      workspace_limit_bytes=2 * t.block_bytes)
    for epoch in range(2):
        for r in (res, small):
            before = ivf_pq_scan.launches
            got = tiered.search_pq(r, sp, t, q, 10)
            torch.cuda.synchronize()
            assert ivf_pq_scan.launches == before + 1
            assert torch.equal(got[1], want[1])
            assert torch.equal(got[0], want[0])
        tiered.apply_plan(t, list(t.cold_lists[:3]), list(t.hot_lists[:3]),
                          width=3)


@pytest.mark.parametrize("dim", [128, 20])
@pytest.mark.parametrize("metric", ["L2Expanded", "L2SqrtExpanded",
                                    "InnerProduct"])
def test_quantized_search_on_the_card_equals_cpu(dev, metric, dim):
    """``quantized.search`` on the card (``torch._int_mm``) against its CPU
    path (an exact int32 product) at the default 32,768-row tile, with a
    ragged last tile and fewer than 17 queries. Integers spanning exactly
    [-127, 127] give scale 1 and zero 0, so every distance is an exact
    integer (its sqrt to 1e-6) and the ids are equal."""
    from raft_tpu_torch.neighbors import quantized

    rng = np.random.default_rng(dim)
    x = rng.integers(-127, 128, (40_003, dim)).astype(np.float32)
    x[0, 0], x[1, 1] = -127.0, 127.0
    q = rng.integers(-127, 128, (50, dim)).astype(np.float32)
    gpu_res, cpu_res = Resources(device="cuda"), Resources(device="cpu")
    gpu = quantized.build(gpu_res, x, DistanceType[metric])
    cpu = quantized.build(cpu_res, x, DistanceType[metric])
    assert (gpu.scale, gpu.zero) == (cpu.scale, cpu.zero) == (1.0, 0.0)
    assert gpu.codes.device.type == "cuda"
    for nq in (5, 50):
        got = quantized.search(gpu_res, gpu, q[:nq], 10)
        want = quantized.search(cpu_res, cpu, q[:nq], 10)
        assert got[1].device.type == "cuda"
        assert torch.equal(got[1].cpu(), want[1])
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-6, atol=0)


@pytest.mark.parametrize("rows,group", [(512, 16), (64, 4)])
def test_ivf_pq_plan_kernel_equals_its_torch_twin(dev, rows, group):
    """The plan kernel lays out what ``_pq_items`` does: the same CSR
    offsets, items and partial slots, and each list's pairs (as a set:
    the kernel places them in arrival order)."""
    from raft_tpu_torch.ops import ivf_pq_scan as ops

    for shape in ({}, *PQ_ITEM_SHAPES):
        args, _ = _pq_scan_case(dev, False, False, 8, 10, 5, **shape)
        probes, indices = args["probes"], args["indices"]
        got = ops._pq_items_cuda(probes, indices, 10, rows, group)
        want = ops._pq_items(probes, indices, 10, rows, group)
        torch.cuda.synchronize()
        for name in ("offs", "live", "item_off", "slot_off"):
            assert torch.equal(got[name].cpu().to(torch.int64),
                               want[name].cpu().to(torch.int64)), name
        q, p = probes.shape
        offs = want["offs"].cpu().to(torch.int64)
        owner = torch.repeat_interleave(torch.arange(offs.numel() - 1),
                                        offs[1:] - offs[:-1])
        n = int(offs[-1])

        def keys(plan):
            pq = plan["pair_q"][:n].cpu().to(torch.int64)
            ps = plan["pair_slot"][:n].cpu().to(torch.int64)
            return torch.sort(owner * q * p + pq * p + ps).values

        assert torch.equal(keys(got), keys(want))
        assert got["pd"].numel() == want["pd"].numel()


def test_ivf_pq_scan_kernel_replays_in_a_graph(dev):
    from raft_tpu_torch.ops.ivf_pq_scan import ivf_pq_scan

    args, packed = _pq_scan_case(dev, False, False, 8, 10, 1)
    kw = dict(k=10, ip_metric=False, per_cluster=False,
              lut_dtype=torch.float32, packed=packed, engine="cuda")
    want = ivf_pq_scan(**args, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ivf_pq_scan(**args, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ivf_pq_scan(**args, **kw)
    args["qres"].mul_(1.0)                   # same values, replayed in place
    before = ivf_pq_scan.launches
    graph.replay()
    torch.cuda.synchronize()
    assert ivf_pq_scan.launches == before    # a replay runs no Python
    assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])


@pytest.mark.parametrize("lut", PQ_LUTS, ids=str)
@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.L2SqrtExpanded,
                                    DistanceType.InnerProduct],
                         ids=lambda m: m.name)
def test_ivf_pq_search_cuda_engine_equals_torch_engine(dev, metric, lut):
    from raft_tpu_torch.neighbors import ivf_pq

    res = Resources(device="cuda", seed=5)
    rng = np.random.default_rng(5)
    centers = rng.standard_normal((20, 32)) * 3
    x = (centers[rng.integers(0, 20, 4000)]
         + rng.standard_normal((4000, 32))).astype(np.float32)
    q = torch.from_numpy((centers[rng.integers(0, 20, 70)] + rng.standard_normal(
        (70, 32))).astype(np.float32)).to(dev)
    for bits, kind in ((8, ivf_pq.CodebookKind.PER_SUBSPACE),
                       (4, ivf_pq.CodebookKind.PER_CLUSTER)):
        index = ivf_pq.build(res, ivf_pq.IvfPqIndexParams(
            n_lists=16, pq_dim=16, pq_bits=bits, codebook_kind=kind,
            metric=metric), x)
        assert index.packed == (bits == 4)
        got = ivf_pq.search(res, ivf_pq.IvfPqSearchParams(
            n_probes=6, lut_dtype=lut), index, q, 10)
        want = ivf_pq.search(res, ivf_pq.IvfPqSearchParams(
            n_probes=6, lut_dtype=lut, scan_engine="torch"), index, q, 10)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
