"""The port's cluster-join graph build (``neighbors/cluster_join``)
against the JAX package's. Packing and the within-cluster pass are
deterministic: equal (the pass on integer-valued data, where every
product is exact and ties break by member slot in both). Builds use
other k-means generators: held to quality, the port's graph recall at
least the JAX graph's minus 0.02."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.distance.types import DistanceType as JD
from raft_tpu.neighbors import cluster_join as j_cj
from raft_tpu_torch import Resources
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors import cluster_join as t_cj

import test_torch_nn_descent as nnd_tests

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

CPU = Resources(device="cpu")


@pytest.mark.parametrize("n_clusters,max_size", [(5, 60), (7, 90)])
def test_pack_cluster_indices_equals_jax(n_clusters, max_size):
    rng = np.random.default_rng(n_clusters)
    labels = rng.integers(0, n_clusters, 300).astype(np.int32)
    labels[labels == 2] = 3                        # an empty cluster
    max_size = max(max_size, int(np.bincount(labels).max()))
    want = np.asarray(j_cj._pack_cluster_indices(jnp.asarray(labels),
                                                 n_clusters, max_size))
    got = t_cj._pack_cluster_indices(torch.from_numpy(labels), n_clusters,
                                     max_size)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.InnerProduct],
                         ids=lambda m: m.name)
@pytest.mark.parametrize("k", [6, 40])
def test_one_pass_equals_jax(metric, k):
    """Integer data (ties everywhere) in 6 clusters, one of them smaller
    than k + 1: ids and distances equal."""
    rng = np.random.default_rng(k)
    x = rng.integers(-3, 4, (400, 16)).astype(np.float32)
    labels = rng.integers(0, 6, 400).astype(np.int32)
    labels[labels == 5] = 4
    labels[:8] = 5                                 # a cluster of 8 rows
    idx = j_cj._pack_cluster_indices(jnp.asarray(labels), 6,
                                     int(np.bincount(labels).max()) + 5)
    wi, wd = j_cj._one_pass(jnp.asarray(x), idx, k, JD(int(metric)))
    gi, gd = t_cj._one_pass(torch.from_numpy(x),
                            torch.from_numpy(np.array(idx)), k, metric)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


def test_one_pass_selects_through_select_k_topk(monkeypatch):
    """Each cluster's rows go through ``matrix.select_k`` with AUTO, which
    picks TOPK at a cluster's width (as the JAX package's ``lax.top_k``);
    the wide-row kernel is never reached, and the pass still equals the
    JAX package's."""
    import raft_tpu_torch.matrix.select_k as t_sk
    import raft_tpu_torch.ops.fused_topk as t_ft

    picked, widths = [], []
    choose = t_sk._choose_algo

    def spy_choose(batch, n, k, dtype=torch.float32, device="cpu"):
        widths.append(n)
        picked.append(choose(batch, n, k, dtype, "cuda"))
        return choose(batch, n, k, dtype, device)

    def no_tiles(*a, **kw):
        raise AssertionError("select_k_tiles reached from cluster_join")

    monkeypatch.setattr(t_sk, "_choose_algo", spy_choose)
    monkeypatch.setattr(t_ft, "select_k_tiles", no_tiles)
    rng = np.random.default_rng(3)
    x = rng.integers(-3, 4, (600, 16)).astype(np.float32)
    labels = rng.integers(0, 4, 600).astype(np.int32)
    idx = j_cj._pack_cluster_indices(jnp.asarray(labels), 4,
                                     int(np.bincount(labels).max()))
    wi, wd = j_cj._one_pass(jnp.asarray(x), idx, 10, JD.L2Expanded)
    gi, gd = t_cj._one_pass(torch.from_numpy(x),
                            torch.from_numpy(np.array(idx)), 10,
                            DistanceType.L2Expanded)
    assert len(picked) == 4
    # what AUTO picks at these widths even for values on the card
    assert set(picked) == {t_sk.SelectAlgo.TOPK}, picked
    assert max(widths) < t_sk._TILES_MIN_N
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


def test_build_recall_not_below_jax(blobs_cj):
    x = blobs_cj
    params = dict(graph_degree=16, target_cluster_size=300, passes=3)
    jg = j_cj.build(None, j_cj.ClusterJoinParams(**params), x)
    tg = t_cj.build(CPU, t_cj.ClusterJoinParams(**params), x)
    assert tuple(tg.shape) == (2000, 16) and tg.dtype == torch.int32
    rj = nnd_tests.graph_recall(jg, x, 10)
    rt = nnd_tests.graph_recall(tg, x, 10)
    assert rt >= rj - 0.02, (rt, rj)


def test_single_cluster_is_exact(blobs_cj):
    """One cluster holding every row is brute force: the exact graph."""
    x = blobs_cj[:500]
    g, d = t_cj.build(CPU, t_cj.ClusterJoinParams(
        graph_degree=8, target_cluster_size=1000), x, return_distances=True)
    assert nnd_tests.graph_recall(g, x, 8) == 1.0
    assert (np.diff(d.numpy(), axis=1) >= 0).all()


@pytest.fixture(scope="module")
def blobs_cj():
    rng = np.random.default_rng(1)
    centers = rng.standard_normal((25, 32)) * 3
    return (centers[rng.integers(0, 25, 2000)]
            + rng.standard_normal((2000, 32))).astype(np.float32)
