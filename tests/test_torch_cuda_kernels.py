"""The port's CUDA kernels against their plain PyTorch versions, on the
card. A CUDA kernel has no CPU mode, so every test here needs a CUDA
device and skips without one. The file imports no JAX: on a machine with
a card but without JAX, run it with ``--noconftest`` (tests/conftest.py
imports JAX):

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Integer-valued inputs make every product exact: ids must be equal and
distances equal to float32 rounding (1e-6 relative). The IVF-BQ scan and
the CAGRA beam search run on Gaussian data; they take every sum in their
plain versions' order (``ops.bq_scan.tree_sum``), so their distances,
ids and counts (rows reranked per query; live iterations, candidates and
rows scored per query) equal the plain versions' bit for bit. The tiered
scan (cold lists in pinned host memory) equals the all-device scan kernel
bit for bit on any data; ``stream_read_sum`` equals the float64 sum on
integer data and is within 1e-6 sum|x| of it on Gaussian data."""

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
    hmap, cmap = _slot_maps(np.asarray(hot_lists), np.asarray(cold_lists),
                            n_lists)
    hot = data[torch.as_tensor(hot_lists, device=data.device)].contiguous()
    cold = data[torch.as_tensor(cold_lists, device=data.device)].cpu()
    return (hot, cold.pin_memory(), torch.from_numpy(hmap).to(data.device),
            torch.from_numpy(cmap).to(data.device))


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
    from raft_tpu_torch.ops import _build
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
        z = torch.zeros(64, dtype=torch.int32, device=dev)
        err = _build.load("tier_scan")(
            z.data_ptr(), hot.data_ptr(), bad.data_ptr(), *[z.data_ptr()] * 8,
            1, 1, 1, 1, 1, 0, 0, 0, *[z.data_ptr()] * 4,
            torch.cuda.current_stream().cuda_stream)
        assert err != 0
    assert tiered_list_major_scan.launches == before


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
