"""The port's NN-descent (``neighbors/nn_descent``) against the JAX
package's. The deterministic pieces (``_merge_dedup``,
``_reverse_sample``) must be equal. The builds draw their randomness from
different generators, so they are held to quality: the port's graph
recall at least the JAX graph's minus 0.02 on the same data."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import nn_descent as j_nnd
from raft_tpu_torch import Resources
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors import nn_descent as t_nnd

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

CPU = Resources(device="cpu")


def graph_recall(graph, x, k):
    """Share of each row's exact k nearest (self excluded) in its row."""
    xt = torch.from_numpy(x)
    d = (xt * xt).sum(1)[:, None] + (xt * xt).sum(1)[None] - 2 * xt @ xt.T
    d.fill_diagonal_(float("inf"))
    truth = torch.sort(d, dim=1, stable=True).indices[:, :k].numpy()
    g = np.asarray(graph)[:, :k]
    return float(np.mean([len(set(a) & set(b)) / k
                          for a, b in zip(g, truth)]))


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((15, 24)) * 4
    return (centers[rng.integers(0, 15, 1500)]
            + rng.standard_normal((1500, 24))).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_dedup_equals_jax(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, 40, (30, 64)).astype(np.int32)
    # a repeated id keeps its first distance, as in a real candidate row
    dists = rng.integers(0, 20, (30, 64)).astype(np.float32)   # many ties
    dists[ids < 0] = np.inf
    wi, wd = j_nnd._merge_dedup(jnp.asarray(ids), jnp.asarray(dists), 16)
    gi, gd = t_nnd._merge_dedup(torch.from_numpy(ids),
                                torch.from_numpy(dists), 16)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


@pytest.mark.parametrize("r", [1, 5, 12])
def test_reverse_sample_equals_jax(r):
    rng = np.random.default_rng(r)
    graph = rng.integers(-1, 200, (200, 9)).astype(np.int32)
    want = np.asarray(j_nnd._reverse_sample(jnp.asarray(graph), 200, r))
    got = t_nnd._reverse_sample(torch.from_numpy(graph), 200, r)
    np.testing.assert_array_equal(got.numpy(), want)


def test_reverse_sample_random_is_a_reverse_sample():
    rng = np.random.default_rng(4)
    graph = rng.integers(-1, 300, (300, 10)).astype(np.int32)
    gen = torch.Generator().manual_seed(0)
    rev = t_nnd._reverse_sample_random(torch.from_numpy(graph), 300, 6,
                                       gen).numpy()
    assert rev.shape == (300, 6)
    edges = {(int(i), int(j)) for i in range(300) for j in graph[i] if j >= 0}
    for j in range(300):
        row = rev[j]
        valid = row[row >= 0]
        assert (row[:len(valid)] >= 0).all()          # filled slots first
        assert all((int(i), j) in edges for i in valid)
    assert (rev >= 0).mean() > 0.5


def test_build_recall_not_below_jax(blobs):
    x = blobs
    params = dict(graph_degree=16, intermediate_graph_degree=24,
                  max_iterations=8)
    jg = j_nnd.build(None, j_nnd.NNDescentParams(**params), x)
    tg = t_nnd.build(CPU, t_nnd.NNDescentParams(**params), x)
    assert tuple(tg.shape) == (1500, 16) and tg.dtype == torch.int32
    rows = np.arange(1500)[:, None]
    assert not (tg.numpy() == rows).any()          # no self edges
    rj, rt = graph_recall(jg, x, 10), graph_recall(tg, x, 10)
    assert rt >= rj - 0.02, (rt, rj)
    assert rt > 0.9


def test_init_graph_and_distances(blobs):
    """Seeded from the exact graph, one round keeps it; returned
    distances are sorted and are the squared L2 of the edges."""
    x = blobs
    xt = torch.from_numpy(x)
    d = (xt * xt).sum(1)[:, None] + (xt * xt).sum(1)[None] - 2 * xt @ xt.T
    d.fill_diagonal_(float("inf"))
    exact = torch.sort(d, dim=1, stable=True).indices[:, :12].to(torch.int32)
    g, gd = t_nnd.build(CPU, t_nnd.NNDescentParams(
        graph_degree=12, intermediate_graph_degree=12, max_iterations=1,
        termination_threshold=0.0), x, return_distances=True,
        init_graph=exact)
    assert graph_recall(g, x, 12) > 0.99
    assert (np.diff(gd.numpy(), axis=1) >= 0).all()
    edge = ((xt[:, None, :] - xt[g.to(torch.int64)]) ** 2).sum(-1)
    torch.testing.assert_close(gd, edge, rtol=1e-4, atol=1e-3)


def test_inner_product_metric(blobs):
    g, gd = t_nnd.build(CPU, t_nnd.NNDescentParams(
        graph_degree=8, intermediate_graph_degree=16, max_iterations=4,
        metric=DistanceType.InnerProduct), blobs, return_distances=True)
    assert (np.diff(gd.numpy(), axis=1) <= 0).all()   # similarities, desc.
