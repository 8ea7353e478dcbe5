"""The port's random ball cover, epsilon neighbourhood, ``spatial.knn``
and ``utils.recall`` against the JAX package on the CPU.

A ball cover built from the JAX index's landmarks files the same rows
under the same balls in the same order (member distances and radii
within 1e-5, the two packages' Haversine and L2 rounding); ``knn_query``
then returns the same ids, and ``eps_nn_query`` / ``eps_neighbors`` the
same adjacency. Inputs are seeded (lat, lon) radians and low-dimensional
Gaussian rows."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from raft_tpu.neighbors import ball_cover as jb
from raft_tpu.neighbors import brute_force as j_bf
from raft_tpu.neighbors import epsilon_neighborhood as je
from raft_tpu.utils import recall as jrecall
from raft_tpu_torch import Resources
from raft_tpu_torch.core.validation import RaftError
from raft_tpu_torch.distance.pairwise import pairwise_distance
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors import ball_cover as tb
from raft_tpu_torch.neighbors import brute_force as t_bf
from raft_tpu_torch.neighbors import epsilon_neighborhood as te
from raft_tpu_torch.utils import recall as trecall

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

CPU = Resources(device="cpu")
METRICS = [DistanceType.Haversine, DistanceType.L2SqrtExpanded,
           DistanceType.L2Expanded]


def _points(metric, n, seed):
    rng = np.random.default_rng(seed)
    if metric == DistanceType.Haversine:
        return np.stack([rng.uniform(-1.4, 1.4, n),
                         rng.uniform(-3.1, 3.1, n)], 1).astype(np.float32)
    return rng.standard_normal((n, 3)).astype(np.float32)


_PAIRS = {}


def _pair(metric):
    """(JAX index, port index over the JAX landmarks, queries)."""
    if metric not in _PAIRS:
        x = _points(metric, 1500, 0)
        ji = jb.build_index(None, x, metric)
        lm = np.asarray(ji.landmarks)
        rows = np.array([np.flatnonzero((x == r).all(1))[0] for r in lm])
        _PAIRS[metric] = (ji, tb.from_landmarks(CPU, x, rows, metric),
                          _points(metric, 60, 1))
    return _PAIRS[metric]


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.name)
def test_build_files_the_reference_balls(metric):
    ji, ti, _ = _pair(metric)
    np.testing.assert_array_equal(ti.landmarks.numpy(),
                                  np.asarray(ji.landmarks))
    np.testing.assert_array_equal(ti.members.numpy(), np.asarray(ji.members))
    for f in ("member_dists", "radii"):
        np.testing.assert_allclose(getattr(ti, f).numpy(),
                                   np.asarray(getattr(ji, f)), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("k", [1, 7])
@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.name)
def test_knn_query_ids_equal_the_reference(metric, k):
    ji, ti, q = _pair(metric)
    for n_probes in (0, 3):
        jd, jix = jb.knn_query(None, ji, q, k, n_probes=n_probes, tile=16)
        td, tix = tb.knn_query(CPU, ti, q, k, n_probes=n_probes, tile=16)
        np.testing.assert_array_equal(tix.numpy(), np.asarray(jix))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("metric", [DistanceType.Haversine,
                                    DistanceType.L2SqrtExpanded],
                         ids=lambda m: m.name)
def test_exhaustive_probe_equals_brute_force(metric):
    _, ti, q = _pair(metric)
    _, tix = tb.knn_query(CPU, ti, q, 5, n_probes=ti.n_landmarks)
    _, bix = t_bf.knn(CPU, ti.dataset, q, 5, metric)
    np.testing.assert_array_equal(tix.numpy(), bix.numpy())


def test_port_build_buckets_every_row_once():
    x = _points(DistanceType.Haversine, 900, 3)
    idx = tb.build_index(Resources(device="cpu", seed=4), x,
                         DistanceType.Haversine)
    assert idx.n_landmarks == 30
    ids = idx.members[idx.members >= 0]
    assert torch.equal(torch.sort(ids).values, torch.arange(900,
                                                            dtype=torch.int32))
    d = pairwise_distance(CPU, x, idx.landmarks, DistanceType.Haversine)
    own = torch.argmin(d, dim=1)
    for b in range(idx.n_landmarks):
        mem = idx.members[b][idx.members[b] >= 0].long()
        assert (own[mem] == b).all()
        md = idx.member_dists[b][: len(mem)]
        assert (md[1:] >= md[:-1]).all()
    with pytest.raises(RaftError, match="more landmarks"):
        tb.build_index(CPU, x[:3], n_landmarks=5)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.name)
def test_eps_queries_equal_the_reference(metric):
    ji, ti, q = _pair(metric)
    for eps in (0.05, 0.3):
        ja, jv = jb.eps_nn_query(None, ji, q, eps)
        ta, tv = tb.eps_nn_query(CPU, ti, q, eps)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert tv.dtype == torch.int32
        ja, jv = je.eps_neighbors(None, q, ji.dataset, eps, tile=16)
        ta, tv = te.eps_neighbors(CPU, q, ti.dataset, eps, tile=16)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        d = pairwise_distance(CPU, q, ti.dataset, DistanceType.L2Expanded)
        assert torch.equal(ta, d <= torch.tensor(eps, dtype=torch.float32)
                           ** 2)


def test_spatial_knn_forwards_with_a_warning():
    from raft_tpu_torch.neighbors import quantized
    from raft_tpu_torch.spatial import knn as sknn

    x = _points(DistanceType.L2Expanded, 200, 5)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        d, i = sknn.brute_force_knn(CPU, x, x[:9], 4)
    wd, wi = j_bf.knn(None, x, x[:9], 4)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    with pytest.warns(DeprecationWarning):
        _, i1 = sknn.knn(CPU, x, x[:9], 4, DistanceType.L1)
    assert torch.equal(i1, t_bf.knn(CPU, x, x[:9], 4, DistanceType.L1)[1])
    assert sknn.ann_quantized_knn is quantized.knn
    assert sknn.ball_cover_build_index is tb.build_index
    assert sknn.ball_cover_knn_query is tb.knn_query
    assert sknn.BallCoverIndex is tb.BallCoverIndex


def test_recall_matches_reference():
    rng = np.random.default_rng(6)
    want_i = rng.integers(0, 50, (20, 10))
    got_i = want_i.copy()
    got_i[::3, 4] = 99                      # misses
    want_d = np.sort(rng.random((20, 10)), 1).astype(np.float32)
    got_d = want_d.copy()
    got_d[::6, 4] = want_d[::6, 4] + 1e-5   # half the misses are ties
    got_d[3::6, 4] = 5.0
    for args in ((want_i, got_i), (want_i, got_i, want_d, got_d)):
        j = jrecall.eval_recall(*args)
        t = trecall.eval_recall(*(torch.from_numpy(np.asarray(a))
                                  for a in args))
        assert t == j
    assert trecall.eval_recall(want_i, got_i)[0] < \
        trecall.eval_recall(want_i, got_i, want_d, got_d)[0] < 1.0
    with pytest.raises(AssertionError, match="below required"):
        trecall.eval_neighbours(want_i, got_i, want_d, got_d, 0.999)
    assert trecall.eval_neighbours(want_i, want_i, want_d, want_d, 1.0) == 1
