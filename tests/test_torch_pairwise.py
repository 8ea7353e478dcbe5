"""The port's distance family against the JAX package on the CPU: every
one of the 20 pairwise metrics, the tiled form, the errors, gram
matrices, ``compress_to_bits`` and ``masked_l2_nn``, and exact kNN
(``brute_force.search``) for every metric.

Inputs are made from a seed with numpy, per metric of the data it is
defined on: Gaussian rows for the real-valued metrics, nonnegative rows
normalised to sum 1 for KL, JensenShannon and Hellinger, binary rows for
Jaccard, Dice, RusselRao and Hamming, (lat, lon) radians for Haversine.
Tolerance: rtol 1e-5 and atol 1e-5; Linf, Hamming and RusselRao are
exact on integer data. kNN ids are equal on integer data where the
metric is a monotone function of exact integer sums (ties broken by the
smallest id); for the metrics with transcendental or inexact terms, ids
are equal up to ties within the distance tolerance.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from raft_tpu.distance import kernels as j_kernels
from raft_tpu.distance import masked_nn as j_masked
from raft_tpu.distance import pairwise as j_pw
from raft_tpu.distance.types import DistanceType as JD
from raft_tpu.neighbors import brute_force as j_bf
from raft_tpu_torch import Resources
from raft_tpu_torch.core.validation import RaftError
from raft_tpu_torch.distance import kernels as t_kernels
from raft_tpu_torch.distance import masked_nn as t_masked
from raft_tpu_torch.distance import pairwise as t_pw
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors import brute_force as t_bf

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

CPU = Resources(device="cpu")
METRICS = [m for m in DistanceType if m != DistanceType.Precomputed]
PROB = (DistanceType.KLDivergence, DistanceType.JensenShannon,
        DistanceType.HellingerExpanded)
BINARY = (DistanceType.JaccardExpanded, DistanceType.DiceExpanded,
          DistanceType.RusselRaoExpanded, DistanceType.HammingUnexpanded)
#: monotone functions of exact sums on integer (binary for BINARY) data
EXACT_IDS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
             DistanceType.L2Unexpanded, DistanceType.L2SqrtUnexpanded,
             DistanceType.L1, DistanceType.Linf, DistanceType.LpUnexpanded,
             DistanceType.InnerProduct, DistanceType.BrayCurtis) + BINARY
RTOL = ATOL = 1e-5
P = 3.0   # LpUnexpanded's metric_arg


def _data(metric, m, n, seed=0, d=16, integer=False):
    """(x, y) float32 rows for ``metric``."""
    rng = np.random.default_rng(seed)
    if metric == DistanceType.Haversine:
        def pts(k):
            return np.stack([rng.uniform(-1.5, 1.5, k),
                             rng.uniform(-3.1, 3.1, k)], 1)
        return pts(m).astype(np.float32), pts(n).astype(np.float32)
    if metric in BINARY:
        x = (rng.random((m, d)) < 0.4).astype(np.float32)
        y = (rng.random((n, d)) < 0.4).astype(np.float32)
        x[1] = 0
        y[2] = 0        # the zero-denominator guards
        return x, y
    if metric in PROB:
        x = rng.random((m, d)) * (rng.random((m, d)) < 0.8)
        y = rng.random((n, d)) * (rng.random((n, d)) < 0.8)
        x /= x.sum(1, keepdims=True)
        y /= y.sum(1, keepdims=True)
        return x.astype(np.float32), y.astype(np.float32)
    if integer:
        x = rng.integers(-4, 5, (m, d)).astype(np.float32)
        y = rng.integers(-4, 5, (n, d)).astype(np.float32)
        if metric == DistanceType.BrayCurtis:
            x, y = np.abs(x), np.abs(y)
        return x, y
    x = rng.standard_normal((m, d)).astype(np.float32)
    y = rng.standard_normal((n, d)).astype(np.float32)
    if metric in (DistanceType.Canberra, DistanceType.BrayCurtis):
        x[0, :4] = 0
        y[0, :4] = 0    # 0 / 0 terms
    return x, y


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.name)
def test_pairwise_matches_reference(metric):
    x, y = _data(metric, 23, 41)
    want = np.asarray(j_pw.pairwise_distance(None, x, y, JD(int(metric)), P))
    got = t_pw.pairwise_distance(CPU, x, y, metric, P)
    assert got.dtype == torch.float32 and got.shape == (23, 41)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", [DistanceType.Linf,
                                    DistanceType.HammingUnexpanded,
                                    DistanceType.RusselRaoExpanded],
                         ids=lambda m: m.name)
def test_integer_metrics_are_exact(metric):
    x, y = _data(metric, 17, 29, seed=3, integer=True)
    want = np.asarray(j_pw.pairwise_distance(None, x, y, JD(int(metric))))
    got = t_pw.pairwise_distance(CPU, x, y, metric)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.name)
def test_tiled_equals_untiled_and_small_workspace(metric):
    x, y = _data(metric, 37, 19, seed=1)
    whole = t_pw.pairwise_distance(CPU, x, y, metric, P)
    tiled = t_pw.pairwise_distance_tiled(CPU, x, y, metric, P, row_tile=8)
    # a budget of a few rows x columns: more blocks, the same sums
    small = t_pw.pairwise_distance(
        Resources(device="cpu", workspace_limit_bytes=4 * 16 * 5), x, y,
        metric, P)
    want = np.asarray(j_pw.pairwise_distance_tiled(None, x, y,
                                                   JD(int(metric)), P,
                                                   row_tile=8))
    assert torch.equal(whole, small)
    np.testing.assert_allclose(tiled.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tiled.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["lp_p_zero", "lp_p_negative",
                                  "haversine_3d", "dims_differ",
                                  "not_2d"])
def test_errors_match_reference(case):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 3)).astype(np.float32)
    metric, arg, y = DistanceType.LpUnexpanded, 0.0, x
    if case == "lp_p_negative":
        arg = -1.0
    elif case == "haversine_3d":
        metric = DistanceType.Haversine
    elif case == "dims_differ":
        metric, y = DistanceType.L1, x[:, :2]
    elif case == "not_2d":
        metric, y = DistanceType.L1, x[0]
    with pytest.raises(Exception):
        np.asarray(j_pw.pairwise_distance(None, x, y, JD(int(metric)), arg))
    with pytest.raises(RaftError):
        t_pw.pairwise_distance(CPU, x, y, metric, arg)


def test_matmul_precision():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((9, 40)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((7, 40)).astype(np.float32))
    full = t_pw.matmul(x, y, "highest")
    assert torch.equal(full, x @ y.T)
    assert torch.equal(t_pw.matmul(x, y, "float32"), full)
    bf = t_pw.matmul(x, y, "bfloat16")
    want = x.to(torch.bfloat16).float() @ y.to(torch.bfloat16).float().T
    assert torch.equal(bf, want) and not torch.equal(bf, full)
    with pytest.raises(RaftError, match="matmul_precision"):
        t_pw.matmul(x, y, "tf32")
    half = Resources(device="cpu", matmul_precision="bfloat16")
    got = t_pw.pairwise_distance(half, x, y, DistanceType.InnerProduct)
    assert torch.equal(got, bf)


@pytest.mark.parametrize("kernel", list(t_kernels.KernelType),
                         ids=lambda k: k.name)
def test_gram_matrix_matches_reference(kernel):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((13, 8)) * 0.5).astype(np.float32)
    y = (rng.standard_normal((21, 8)) * 0.5).astype(np.float32)
    kw = dict(degree=3, gamma=0.7, coef0=0.3)
    want = np.asarray(j_kernels.gram_matrix(None, x, y, j_kernels.KernelParams(
        j_kernels.KernelType(int(kernel)), **kw)))
    got = t_kernels.gram_matrix(CPU, x, y, t_kernels.KernelParams(kernel,
                                                                  **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(5, 32), (7, 45), (3, 1), (4, 100)])
def test_compress_to_bits_is_bit_equal(shape):
    mask = np.random.default_rng(shape[1]).random(shape) < 0.5
    mask[0] = True                    # the sign bit of every word
    want = np.asarray(j_masked.compress_to_bits(None, mask))
    got = t_masked.compress_to_bits(CPU, mask)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("sqrt", [False, True])
def test_masked_l2_nn_matches_reference(sqrt):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((29, 6)).astype(np.float32)
    y = rng.standard_normal((50, 6)).astype(np.float32)
    group_idxs = np.array([10, 18, 18, 35, 50], np.int32)  # one empty group
    adj = rng.random((29, 5)) < 0.4
    adj[3] = False                                         # no group
    adj[4] = [False, False, True, False, False]            # only the empty
    want_d, want_i = j_masked.masked_l2_nn(None, x, y, adj, group_idxs,
                                           sqrt=sqrt)
    small = Resources(device="cpu", workspace_limit_bytes=4 * 50 * 4)
    for res in (CPU, small):
        got_d, got_i = t_masked.masked_l2_nn(res, x, y, adj, group_idxs,
                                             sqrt=sqrt)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                                   rtol=RTOL, atol=ATOL)
    assert got_i[3] == -1 and got_i[4] == -1 and torch.isinf(got_d[3])


def test_distance_exports_mirror_reference():
    import raft_tpu.distance as jdist
    import raft_tpu_torch.distance as tdist

    assert sorted(tdist.__all__) == sorted(jdist.__all__)
    assert {int(m) for m in tdist.EXPANDED_METRICS} == \
        {int(m) for m in jdist.EXPANDED_METRICS}


# ---------------------------------------------------------------------------
# exact kNN for every metric
# ---------------------------------------------------------------------------


def _same_up_to_ties(jd, ji, td, ti, tol):
    """Distances equal to ``tol``; ids equal wherever the distance is
    farther than ``tol`` from every other of the row's distances."""
    np.testing.assert_allclose(td, jd, rtol=tol, atol=tol)
    for r in range(jd.shape[0]):
        for j in range(jd.shape[1]):
            near = np.abs(np.delete(jd[r], j) - jd[r, j]) <= tol * (
                1 + abs(jd[r, j]))
            if not near.any():
                assert ji[r, j] == ti[r, j], (r, j)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.name)
def test_brute_force_every_metric_matches_reference(metric):
    exact = metric in EXACT_IDS
    x, q = _data(metric, 13, 300, seed=11, integer=exact)
    x, q = q, x                       # 300 rows, 13 queries
    jidx = j_bf.build(None, x, JD(int(metric)), P)
    tidx = t_bf.build(CPU, x, metric, P)
    jd, ji = j_bf.search(None, jidx, q, 9, db_tile=128)
    td, ti = t_bf.search(CPU, tidx, q, 9, db_tile=128)
    jd, ji = np.asarray(jd), np.asarray(ji)
    if exact:
        np.testing.assert_array_equal(ti.numpy(), ji)
        np.testing.assert_allclose(td.numpy(), jd, rtol=1e-6, atol=1e-6)
    else:
        _same_up_to_ties(jd, ji, td.numpy(), ti.numpy(), RTOL)
    ad, ai = t_bf.search(CPU, tidx, q, 9, db_tile=128, approx=True)
    assert torch.equal(ai, ti) and torch.equal(ad, td)


def test_brute_force_ties_go_to_the_smallest_id():
    x = np.zeros((40, 4), np.float32)
    x[::2] = 1.0                              # 20 equal rows each
    for metric in (DistanceType.L1, DistanceType.Linf,
                   DistanceType.HammingUnexpanded, DistanceType.Canberra):
        _, ti = t_bf.knn(CPU, x, x[:1], 5, metric)
        _, ji = j_bf.knn(None, x, x[:1], 5, JD(int(metric)))
        assert ti[0].tolist() == [0, 2, 4, 6, 8] == np.asarray(ji)[0].tolist()


def test_brute_force_threads_metric_arg():
    x, q = _data(DistanceType.LpUnexpanded, 9, 120, seed=4, integer=True)
    x, q = q, x
    for p in (1.0, 2.0, 4.0):
        _, ti = t_bf.knn(CPU, x, q, 6, DistanceType.LpUnexpanded, p)
        _, ji = j_bf.knn(None, x, q, 6, JD.LpUnexpanded, p)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    with pytest.raises(RaftError, match="metric_arg > 0"):
        t_bf.knn(CPU, x, q, 6, DistanceType.LpUnexpanded, 0.0)
