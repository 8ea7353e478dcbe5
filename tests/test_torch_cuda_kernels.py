"""The port's CUDA kernels against their plain PyTorch versions, on the
card. A CUDA kernel has no CPU mode, so every test here needs a CUDA
device and skips without one. The file imports no JAX: on a machine with
a card but without JAX, run it with ``--noconftest`` (tests/conftest.py
imports JAX):

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Integer-valued inputs make every product exact: ids must be equal and
distances equal to float32 rounding (1e-6 relative). The IVF-BQ scan
runs on Gaussian data; it takes every sum in the plain version's order
(``ops.bq_scan.tree_sum``), so its distances, ids and the rows each
query reranked equal the plain version's bit for bit."""

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
