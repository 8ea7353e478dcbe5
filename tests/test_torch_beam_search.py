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

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

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


# ---------------------------------------------------------------------------
# models of the kernel's round (csrc/beam_search.cu) in plain code
# ---------------------------------------------------------------------------

_HASH_EMPTY = -1


def _hash_slot(key: int, mask: int) -> int:
    return (key * 2654435761) & 0xFFFFFFFF & mask


def _hashed_fresh(cands, buf_live, L):
    """The kernel's hashed dedup of one round: the table (2 (L + C) slots
    or more, a power of two) holds each live buffer id with the mark -1
    and each candidate id with the smallest index that proposes it; a
    candidate is fresh when its id is >= 0 and its slot holds its own
    index. Insertions go in a shuffled order, as a block's atomics may."""
    c = len(cands)
    hs = 64
    while hs < 2 * (L + c):
        hs <<= 1
    mask = hs - 1
    keys = [_HASH_EMPTY] * hs
    vals = [2**31 - 1] * hs
    puts = [(b, -1) for b in buf_live] + [(x, t) for t, x in
                                          enumerate(cands) if x >= 0]
    order = np.random.default_rng(len(puts)).permutation(len(puts))
    for o in order:
        key, v = puts[o]
        h = _hash_slot(key, mask)
        while keys[h] not in (_HASH_EMPTY, key):
            h = (h + 1) & mask
        keys[h] = key
        vals[h] = min(vals[h], v)

    def get(key):
        h = _hash_slot(key, mask)
        while keys[h] != key:
            h = (h + 1) & mask
        return vals[h]

    return [x >= 0 and get(x) == t for t, x in enumerate(cands)]


@pytest.mark.parametrize("L,c", [(32, 32), (64, 128), (512, 256),
                                 (100, 72)])
def test_hashed_dedup_drops_what_the_linear_scan_drops(L, c):
    """The hashed dedup keeps exactly the candidates the linear scans of
    the live buffer and the earlier candidates keep (the plain version's
    ``dedup_candidate_mask``): repeats, buffer ids, -1 holes, a partly
    filled buffer, ids that collide in the table."""
    from raft_tpu_torch.neighbors._exact import dedup_candidate_mask

    rng = np.random.default_rng(L + c)
    for trial in range(20):
        n_ids = int(rng.integers(c // 2, 4 * (L + c)))
        nlive = int(rng.integers(0, L + 1))
        buf = rng.choice(n_ids + L, size=L, replace=False)
        cands = rng.integers(-1, n_ids, c)
        cands[rng.random(c) < 0.2] = buf[rng.integers(0, L, 1)[0]]
        # ids a table stride apart land in one probe chain
        cands[:4] = [7, 7 + 4096, 7 + 8192, 7]
        live = buf[:nlive].tolist()
        got = _hashed_fresh(cands.tolist(), live, L)
        buf_ids = torch.full((1, L), -2, dtype=torch.int32)
        buf_ids[0, :nlive] = torch.from_numpy(buf[:nlive])
        ct = torch.from_numpy(cands).to(torch.int32)[None]
        want = ((ct >= 0) & ~dedup_candidate_mask(ct, buf_ids))[0]
        assert got == want.tolist(), trial


def _cluster_share(ns: int, nc: int, rank: int, warp: int, R: int,
                   warps: int = 8):
    """The kept rows one warp of one CTA scores in a round
    (``score_share``): batches of R from (rank * warps + warp) * R, a
    stride of nc * warps * R."""
    out = []
    base = (rank * warps + warp) * R
    while base < ns:
        out += [s for s in range(base, base + R) if s < ns]
        base += nc * warps * R
    return out


@pytest.mark.parametrize("nc", t_bs.CLUSTER_SIZES)
@pytest.mark.parametrize("R", [1, 2, 4, 8, 16])
def test_cluster_split_scores_each_kept_row_once(nc, R):
    """The cluster's CTAs and warps split a round's kept rows: each row of
    every round size (0 .. 256) is scored by exactly one warp."""
    for ns in range(257):
        seen = [s for rank in range(nc) for warp in range(8)
                for s in _cluster_share(ns, nc, rank, warp, R)]
        assert sorted(seen) == list(range(ns)), ns


def _cluster_walk(x, q, graph, seeds, k, L, w, max_iters, nc, R=4):
    """The kernel's walk for each query in plain code, round by round:
    hashed dedup, then the round's kept rows scored in the cluster
    split's order (rank by rank, warp by warp, R rows at a time), each
    row's distance on its own in ``tree_sum``'s order, written to its
    candidate slot; the merge keeps the L smallest (distance, id)."""
    inf = float("inf")
    deg = graph.shape[1]
    c = w * deg
    outd = torch.full((q.shape[0], k), inf)
    outi = torch.full((q.shape[0], k), -1, dtype=torch.int32)
    counts = torch.zeros((q.shape[0], 3), dtype=torch.int32)
    for row in range(q.shape[0]):
        qv = q[row]
        qn = t_bs.tree_sum(qv * qv)
        buf = [(inf, -1, False)] * L

        def round_(cands):
            live = [e[1] for e in buf if e[0] < inf]
            fresh = _hashed_fresh(cands, live, L)
            kept = [t for t in range(c) if fresh[t]]
            counts[row, 1] += len(kept)
            counts[row, 2] += len(kept)
            cd = [inf] * c
            for rank in range(nc):
                for warp in range(8):
                    for s_ in _cluster_share(len(kept), nc, rank, warp, R):
                        t = kept[s_]
                        xr = x[cands[t]]
                        ip = t_bs.tree_sum(qv * xr)
                        v = torch.clamp((t_bs.tree_sum(xr * xr) - 2.0 * ip)
                                        + qn, min=0.0)
                        cd[t] = float(v)
            new = buf + [(cd[t], cands[t], False) for t in range(c)
                         if cd[t] < inf]
            new.sort(key=lambda e: (e[0], e[1]) if e[0] < inf
                     else (inf, 2**31))
            return [e if e[0] < inf else (inf, -1, False) for e in new[:L]]

        for c0 in range(0, seeds.shape[1], c):
            buf = round_(seeds[row, c0:c0 + c].tolist())
        for _ in range(max_iters):
            par = [i for i, e in enumerate(buf) if e[0] < inf and not e[2]]
            par = par[:w]
            if not par:
                break
            counts[row, 0] += 1
            for i in par:
                buf[i] = (buf[i][0], buf[i][1], True)
            cands = []
            for j in range(w):
                cands += (graph[buf[par[j]][1]].tolist() if j < len(par)
                          else [-1] * deg)
            buf = round_(cands)
        for j in range(k):
            outd[row, j] = buf[j][0]
            outi[row, j] = buf[j][1] if buf[j][0] < inf else -1
    return outd, outi, counts


@pytest.mark.parametrize("nc", t_bs.CLUSTER_SIZES)
def test_cluster_split_walk_equals_plain(walk, nc):
    """The CPU model of the kernel's rounds at each cluster size (hashed
    dedup, the kept rows split over the cluster's CTAs and warps, scores
    written by candidate slot, the leader's merge) equals
    ``beam_search_plain``: ids, distances and counts."""
    x, q, graph, seeds = walk
    xt, qt = torch.from_numpy(x), torch.from_numpy(q[:3])
    gt, st = torch.from_numpy(graph), torch.from_numpy(seeds[:3])
    want = t_bs.beam_search_plain(qt, xt, gt, st, 10, 64, 4, 12,
                                  DistanceType.L2Expanded)
    got = _cluster_walk(xt, qt, gt, st, 10, 64, 4, 12, nc)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[2], want[2])


def test_beam_cluster_size_follows_the_batch():
    """The largest of 1..16 with q x size CTAs within ctas_per_sm x SMs:
    16 at small batches, 1 once one CTA a query fills the card."""
    f = t_bs.beam_cluster_size
    assert f(1, n_sm=132, ctas_per_sm=2) == 16
    assert f(10, n_sm=132, ctas_per_sm=2) == 16
    assert f(17, n_sm=132, ctas_per_sm=2) == 8
    assert f(100, n_sm=132, ctas_per_sm=2) == 2
    assert f(264, n_sm=132, ctas_per_sm=2) == 1
    assert f(500, n_sm=132, ctas_per_sm=2) == 1
    assert f(500, n_sm=132, ctas_per_sm=8) == 2
    assert f(0, n_sm=132, ctas_per_sm=2) == 16
