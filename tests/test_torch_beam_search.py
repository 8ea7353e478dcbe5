"""The port's beam search (``ops/beam_search``) against the JAX package's
Pallas kernel run in interpret mode, and the BQ record plane.

Both walk the same exact k-NN graph from the same seeds. On
integer-valued data every product and sum is exact, so ids must be equal
and distances equal to rtol 1e-5 (the BQ estimate is not integer: its
sums are taken in other orders, which may move a prune decision only at
an ulp from the threshold). Interpreted Pallas is slow, so these cases
are few and small (n = 1,200, q = 8, one grid block). The record plane
must be byte for byte the JAX package's.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.distance.types import DistanceType as JD
from raft_tpu.ops import beam_search as j_bs
from raft_tpu.ops import bq_scan as j_scan
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors import ivf_bq as t_bq
from raft_tpu_torch.ops import beam_search as t_bs
from raft_tpu_torch.ops import bq_scan as t_scan

N, D, Q, DEG = 1200, 128, 8, 16


@pytest.fixture(scope="module")
def walk():
    """Integer data, its exact 16-NN graph (a few -1 entries), queries
    and seeds with -1 holes."""
    rng = np.random.default_rng(0)
    centers = rng.integers(-6, 7, (12, D))
    x = (centers[rng.integers(0, 12, N)]
         + rng.integers(-2, 3, (N, D))).astype(np.float32)
    q = (centers[rng.integers(0, 12, Q)]
         + rng.integers(-2, 3, (Q, D))).astype(np.float32)
    xt = torch.from_numpy(x)
    dist = (xt * xt).sum(1)[:, None] + (xt * xt).sum(1)[None] - 2 * xt @ xt.T
    dist.fill_diagonal_(float("inf"))
    graph = torch.sort(dist, dim=1, stable=True).indices[:, :DEG].to(
        torch.int32).numpy()
    graph[::9, DEG - 2:] = -1
    seeds = rng.integers(0, N, (Q, 2 * 4 * DEG)).astype(np.int32)
    seeds[:, 3::7] = -1
    return x, q, graph, seeds


def _both(walk, k, L, w, metric, row_iters=None, bits=0):
    x, q, graph, seeds = walk
    c = w * DEG
    seeds = seeds[:, :c * (seeds.shape[1] // c)]
    max_iters = L // w + 24
    jkw, tkw = {}, {}
    if row_iters is not None:
        jkw["row_iters"] = jnp.asarray(row_iters)
        tkw["row_iters"] = torch.from_numpy(row_iters)
    if bits:
        rot = t_bq._pinned_rotation(5, D, D)
        center = x.mean(axis=0, keepdims=True)
        codes, rnorm, cfac, errw = t_bq._encode(
            torch.from_numpy((x - center) @ rot.T), bits)
        recs = t_scan.pack_bq_records(codes, rnorm, cfac, errw)
        qrot = (q @ rot.T).astype(np.float32)
        crot = (center @ rot.T).astype(np.float32)
        common = dict(bq_bits=bits, bq_query_bits=t_scan.auto_query_bits(bits),
                      bq_epsilon=3.0)
        jkw.update(bq_records=jnp.asarray(recs.numpy()),
                   bq_qrot=jnp.asarray(qrot), bq_crot=jnp.asarray(crot),
                   **common)
        tkw.update(bq_records=recs, bq_qrot=torch.from_numpy(qrot),
                   bq_crot=torch.from_numpy(crot), **common)
    jd, ji = j_bs.beam_search(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(graph),
        jnp.asarray(seeds), k, L, w, max_iters, JD(int(metric)),
        interpret=True, **jkw)
    td, ti, counts = t_bs.beam_search(
        torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(graph),
        torch.from_numpy(seeds), k, L, w, max_iters, metric, **tkw)
    return (np.asarray(jd), np.asarray(ji)), (td.numpy(), ti.numpy()), counts


def _assert_equal(j, t):
    np.testing.assert_array_equal(t[1], j[1])
    fin = np.isfinite(j[0])
    np.testing.assert_array_equal(np.isfinite(t[0]), fin)
    np.testing.assert_allclose(t[0][fin], j[0][fin], rtol=1e-5)


@pytest.mark.parametrize("metric,k,L,w", [
    (DistanceType.L2Expanded, 10, 64, 4),
    (DistanceType.InnerProduct, 5, 32, 2),
], ids=["l2-L64-w4", "ip-L32-w2"])
def test_plain_equals_interpreted_kernel(walk, metric, k, L, w):
    j, t, counts = _both(walk, k, L, w, metric)
    _assert_equal(j, t)
    assert (counts[:, 0] > 0).all()       # every query walked


def test_row_iters_ragged_budgets(walk):
    """Per-row budgets, one of them 0 (the seeds only)."""
    ri = np.array([0, 1, 3, 40, 2, 0, 7, 100], np.int32)
    j, t, counts = _both(walk, 10, 64, 4, DistanceType.L2Expanded,
                         row_iters=ri)
    _assert_equal(j, t)
    assert (counts[:, 0].numpy() <= ri).all()
    assert int(counts[0, 0]) == 0 and int(counts[5, 0]) == 0


def test_bq_traversal(walk):
    """The BQ-coded traversal prunes the same candidates as the JAX
    kernel: equal ids, and fewer rows scored than proposed (the buffer of
    32 is full after two of the four seed chunks: far seeds are cut)."""
    j, t, counts = _both(walk, 10, 32, 2, DistanceType.L2Expanded, bits=2)
    _assert_equal(j, t)
    assert int(counts[:, 2].sum()) < int(counts[:, 1].sum())


@pytest.mark.parametrize("n,bits,d", [(1000, 1, 128), (37, 2, 100),
                                      (5, 3, 64), (130, 4, 32)])
def test_record_plane_matches_jax(n, bits, d):
    rng = np.random.default_rng(n)
    de = -(-d // 32) * 32
    words = bits * de // 32
    codes = rng.integers(-2**31, 2**31, (n, words)).astype(np.int32)
    rnorm = rng.random(n).astype(np.float32)
    cfac = rng.standard_normal((n, bits)).astype(np.float32)
    errw = rng.random(n).astype(np.float32)
    assert t_scan.bq_record_geometry(words, bits) == \
        j_scan.bq_record_geometry(words, bits)
    want = np.asarray(j_scan.pack_bq_records(
        jnp.asarray(codes), jnp.asarray(rnorm), jnp.asarray(cfac),
        jnp.asarray(errw)))
    got = t_scan.pack_bq_records(*map(torch.from_numpy,
                                      (codes, rnorm, cfac, errw)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    back = t_scan.unpack_bq_records(got, n, words, bits)
    for g, w in zip(back, (codes, rnorm, cfac, errw)):
        np.testing.assert_array_equal(g.numpy(), w)


def test_pad_graph_matches_jax(walk):
    graph = walk[2][:, :40]
    np.testing.assert_array_equal(
        t_bs.pad_graph(torch.from_numpy(graph)).numpy(),
        np.asarray(j_bs.pad_graph(jnp.asarray(graph))))


def test_padded_graph_walks_the_same(walk):
    """A graph padded to 128 lanes with its logical ``deg`` gives the
    unpadded walk."""
    x, q, graph, seeds = walk
    args = (torch.from_numpy(q), torch.from_numpy(x))
    s = torch.from_numpy(seeds[:, :4 * DEG])
    a = t_bs.beam_search_plain(*args, torch.from_numpy(graph), s, 10, 64, 4,
                               40, DistanceType.L2Expanded)
    b = t_bs.beam_search_plain(*args, t_bs.pad_graph(torch.from_numpy(graph)),
                               s, 10, 64, 4, 40, DistanceType.L2Expanded,
                               deg=DEG)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_wrapper_checks():
    x = torch.zeros((50, 8))
    g = torch.zeros((50, 4), dtype=torch.int32)
    q = torch.zeros((2, 8))
    with pytest.raises(Exception, match="seeds"):
        t_bs.beam_search(q, x, g, torch.zeros((2, 6), dtype=torch.int32), 1,
                         8, 1, 4, DistanceType.L2Expanded)
    with pytest.raises(Exception, match="k must be"):
        t_bs.beam_search(q, x, g, torch.zeros((2, 8), dtype=torch.int32), 9,
                         8, 1, 4, DistanceType.L2Expanded)
    with pytest.raises(Exception, match="unsupported"):
        t_bs.beam_search(q, x, g, torch.zeros((2, 8), dtype=torch.int32), 1,
                         8, 1, 4, DistanceType.CosineExpanded)
