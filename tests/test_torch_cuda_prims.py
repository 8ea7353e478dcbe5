"""The primitives on the card, at sizes too small for ``chip_smoke.py``'s
``prims`` phase, whose checks they share: single-linkage (its kNN search
against ``fused_knn_plain`` block by block, the first MST forest against
scipy's, the labels against the components of the tree
less its heaviest edges), Lanczos on the spectral graph's Laplacian,
linear assignment against scipy, sparse kNN against a float64 product,
``make_blobs`` with ``stats.cov``/``meanvar`` against float64, and the
sweep of every other public function of the primitive modules against
its CPU run. Also: a CUDA ``single_linkage`` equal to the CPU one on
integer data, and ``brute_force.search`` running past 512 queries as
512-row ``fused_knn`` blocks. Every test needs a CUDA device and skips without one; the
file imports no JAX, so run it with ``--noconftest``:

    python -m pytest --noconftest -q tests/test_torch_cuda_prims.py
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from raft_tpu_torch import Resources, random  # noqa: E402
from raft_tpu_torch.cluster import single_linkage  # noqa: E402
from raft_tpu_torch.distance.types import DistanceType  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def res():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: knn_graph launches fused_knn")
    torch.backends.cuda.matmul.allow_tf32 = False
    return Resources(device="cuda", seed=0)


@pytest.fixture(scope="module")
def blobs(res):
    x, y, _ = random.make_blobs(random.RngState(3), 6000, 32, n_clusters=8,
                                device="cuda")
    return x, y


def test_single_linkage_checks_and_spectral(res, blobs):
    x, y = blobs
    state = {}
    sl = cs.prims_single_linkage(torch, res, x, y, 8, 10, state)
    assert state["launches"]["fused_knn"] > 0
    assert sl["rec"]["connect_rounds"] >= 1
    assert sl["rec"]["ari"] > 0.99
    sp = cs.prims_spectral(torch, res, sl["graph"], y, 8, seed=0)
    assert sp["rayleigh_err"] <= 1e-4 and sp["orthonormal"] <= 1e-3


def test_search_takes_the_fused_kernel_in_blocks(res, blobs):
    """brute_force.search picks its query tile: 1,300 queries run as
    three fused_knn launches (512, 512 and a ragged 276), equal to the
    plain version on each row."""
    from raft_tpu_torch.neighbors import brute_force
    from raft_tpu_torch.ops.fused_topk import fused_knn, fused_knn_plain

    x, _ = blobs
    q = x[:1300].flip(1).contiguous()     # away from the dataset's rows
    index = brute_force.build(res, x, DistanceType.L2Expanded)
    before = fused_knn.launches
    d, i = brute_force.search(res, index, q, 10)
    assert fused_knn.launches == before + 3
    wd, wi = fused_knn_plain(q, x, 10, DistanceType.L2Expanded,
                             dataset_norms=index.norms)
    assert float((i == wi).float().mean()) >= 0.99
    torch.testing.assert_close(d, wd, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("seed", [0, 1])
def test_single_linkage_cuda_equals_cpu_on_integer_data(res, seed):
    rng = np.random.default_rng(seed)
    centers = rng.integers(-40, 40, (6, 16))
    x = (centers[rng.integers(0, 6, 3000)]
         + rng.integers(-3, 4, (3000, 16))).astype(np.float32)
    got = single_linkage(res, x, 6, metric=DistanceType.L2Expanded, k=8)
    want = single_linkage(Resources(device="cpu"), x, 6,
                          metric=DistanceType.L2Expanded, k=8)
    for name in ("labels", "children", "sizes", "deltas"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))


@pytest.mark.parametrize("n", [64, 300])
def test_linear_assignment_equals_scipy(res, n):
    rec = cs.prims_lap(torch, res, n, n)
    assert rec["phases"] >= 1 and rec["iterations"] >= 1


def test_sparse_knn_equals_float64_product(res):
    rec = cs.prims_sparse_knn(torch, res, 0, cols=3011, rows=20000,
                              queries=200, doc_nnz=120, query_nnz=49,
                              check=50)
    assert rec["checked"] == 50


def test_blobs_cov_meanvar(res, monkeypatch):
    monkeypatch.setattr(cs, "BLOBS_1M", 100_000)
    rec = cs.prims_blobs_1m(torch, 0)
    assert rec["cov_err"] <= 1e-4


def test_sweep_equals_cpu(res):
    cases = cs.sweep_cases(torch, 0)
    names = [c[0] for c in cases]
    assert len(names) == len(set(names))
    rec = cs.prims_sweep(torch, 0, "cuda")
    assert rec["cases"] == len(cases)
