"""The port's plain list-major scan against the JAX package's engines on
the same packed index: ``xla`` and ``pallas`` (interpret mode).

Integer-valued data makes every product exact, so ids are compared
EXACTLY (smallest id first on the duplicate rows) and distances to
float32 rounding (rtol 1e-6). The CUDA engine's glue — the (list, query)
pairs and their CSR offsets — runs on the CPU here and is checked by
emulating the kernel's per-probe decomposition with plain tensor code.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core.bitset import Bitset as JBitset
from raft_tpu.distance.types import DistanceType as JD
from raft_tpu.neighbors import ivf_flat as j_ivf
from raft_tpu.ops import ivf_scan as j_scan
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.ops import ivf_scan as t_scan

N_LISTS, N, D = 12, 900, 16
SEED_ROWS = 512      # kSeedRows of csrc/ivf_scan_body.cuh


@pytest.fixture(scope="module")
def packed():
    rng = np.random.default_rng(0)
    x = rng.integers(-4, 5, (N, D)).astype(np.float32)
    x[400] = x[3]                # exact duplicates of one row
    x[800] = x[3]
    idx = j_ivf.build(None, j_ivf.IvfFlatIndexParams(n_lists=N_LISTS), x)
    arrays = {name: np.array(getattr(idx, name)) for name in
              ("data", "data_norms", "indices")}
    q = rng.integers(-4, 5, (21, D)).astype(np.float32)
    q[0] = x[3]
    probes = rng.integers(0, N_LISTS, (21, 5)).astype(np.int32)
    probes[2, 3:] = N_LISTS      # sentinel (masked) probe slots
    probes[5, :] = N_LISTS       # a row that probes nothing
    probes[6, 1] = probes[6, 0]  # a repeated probe counts once
    # the duplicates' list is probed by query 0
    probes[0, 0] = int(np.nonzero(arrays["indices"] == 3)[0][0])
    words = JBitset.from_mask(rng.random(N) < 0.7).words
    return arrays, q, probes, np.array(words)


def _torch_args(arrays, q, probes):
    return (torch.from_numpy(q), torch.from_numpy(arrays["data"]),
            torch.from_numpy(arrays["data_norms"]),
            torch.from_numpy(arrays["indices"]), torch.from_numpy(probes))


@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("use_filter", [False, True])
@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.InnerProduct],
                         ids=lambda m: m.name)
@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_plain_engine_matches_reference(packed, engine, metric, use_filter,
                                        k):
    arrays, q, probes, words = packed
    fw = words if use_filter else None
    wd, wi = j_scan.list_major_scan(
        jnp.asarray(q), jnp.asarray(arrays["data"]),
        jnp.asarray(arrays["data_norms"]), jnp.asarray(arrays["indices"]),
        jnp.asarray(probes), None if fw is None else jnp.asarray(fw),
        k=k, metric=JD(int(metric)), engine=engine, interpret=True)
    tw = None if fw is None else torch.from_numpy(fw.view(np.int32))
    gd, gi = t_scan.list_major_scan(*_torch_args(arrays, q, probes), tw,
                                    k=k, metric=metric, engine="torch")
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-6,
                               atol=0)
    assert (gi[5] == -1).all()             # probed nothing: all empty


def test_duplicates_order_by_smallest_id(packed):
    arrays, q, probes, _ = packed
    gd, gi = t_scan.list_major_scan(*_torch_args(arrays, q, probes), None,
                                    k=3, metric=DistanceType.L2Expanded,
                                    engine="torch")
    assert gi[0].tolist() == [3, 400, 800]
    assert torch.equal(gd[0], gd[0, :1].expand(3))


def _decode_items(g, q, p):
    """The kernel's work items in plain code, decoded from the glue's plan
    as ``scan_items`` does: (union step, chunk, first pair, pair count,
    first row, rows)."""
    item_off = g["item_off"].numpy()
    offs = g["offs"].numpy()
    live = g["live"].numpy()
    out = []
    for it in range(int(item_off[-1])):
        j = int(np.searchsorted(item_off, it, side="right")) - 1
        t = it - int(item_off[j])
        cnt_all = int(offs[j + 1] - offs[j])
        ngr = -(-cnt_all // t_scan._QUERY_GROUP)
        chunk, grp = divmod(t, ngr)
        r0 = chunk * t_scan._CHUNK_ROWS
        start = int(offs[j]) + grp * t_scan._QUERY_GROUP
        out.append((j, chunk, start,
                    min(t_scan._QUERY_GROUP, cnt_all - grp *
                        t_scan._QUERY_GROUP),
                    r0, min(t_scan._CHUNK_ROWS, int(live[j]) - r0)))
    return out


def _lex_key(d, i):
    return (float(d), int(i))


def _seed_bounds(g, qf, data, norms, k, ip_metric):
    """The kernels' seed bound of each query in plain code: the k-th
    smallest (distance, id) pair over the first ``SEED_ROWS`` rows (id >=
    0) of its seed list, (+inf, large) where there are fewer than k."""
    out = []
    for row, j in enumerate(g["seed_step"].tolist()):
        cands = []
        if j >= 0:
            lid = int(g["uniq"][j])
            n = min(SEED_ROWS, int(g["live"][j]))
            ip = qf[row:row + 1] @ data[lid].to(torch.float32).T
            dist = (-ip if ip_metric else norms[lid][None] - 2.0 * ip)[0]
            ids = g["ids_g"][j]
            cands = sorted(_lex_key(dist[r], ids[r]) for r in range(n)
                           if int(ids[r]) >= 0)
        out.append(cands[k - 1] if len(cands) >= k
                   else (float("inf"), 2**31 - 1))
    return out


def _emulate_cuda_scan(qf, data, norms, indices, probes, k, metric,
                       filter_words=None, seed_bound=False):
    """The CUDA engine's decomposition in plain code: each work item (list,
    chunk of its live rows, group of its probers) writes one partial
    top-k per query into the query's slot for (probe slot, chunk); then
    each query's ragged run of slots merges. With ``seed_bound`` the
    items drop the candidates past each query's seed bound first, as the
    kernels do. Returns the result and how often each partial was
    written."""
    q, p = probes.shape
    ip_metric = metric == DistanceType.InnerProduct
    g = t_scan._launch_glue(qf, indices, probes, filter_words, k)
    bound = (_seed_bounds(g, qf, data, norms, k, ip_metric) if seed_bound
             else None)
    n_part = int(g["slot_off"][-1])
    pd = torch.full((n_part, k), float("nan"))
    pi = torch.full((n_part, k), -7, dtype=torch.int32)
    writes = np.zeros(n_part, np.int64)
    for j, chunk, start, cnt, r0, nrows in _decode_items(g, q, p):
        lid = int(g["uniq"][j])
        ip = qf @ data[lid].to(torch.float32).T        # the plain product
        dist = -ip if ip_metric else norms[lid][None, :] - 2.0 * ip
        ids = g["ids_g"][j][r0:r0 + nrows]
        for e in range(start, start + cnt):
            row, slot = int(g["pair_q"][e]), int(g["pair_slot"][e])
            dv = torch.where(ids >= 0, dist[row, r0:r0 + nrows],
                             torch.full_like(ids, float("inf"),
                                             dtype=torch.float32))
            if bound is not None:
                past = torch.tensor([_lex_key(v, i) > bound[row]
                                     for v, i in zip(dv, ids)],
                                    dtype=torch.bool)
                dv = torch.where(past, torch.full_like(dv, float("inf")), dv)
            bd, bi = t_scan._merge_smallest_id(
                torch.full((1, k), float("inf")),
                torch.full((1, k), -1, dtype=torch.int32),
                dv[None], ids[None], k)
            o = int(g["slot_off"][row * p + slot]) + chunk
            pd[o], pi[o] = bd[0], bi[0]
            writes[o] += 1
    so = g["slot_off"]
    best_d = torch.full((q, k), float("inf"))
    best_i = torch.full((q, k), -1, dtype=torch.int32)
    for r in range(q):
        lo, hi = int(so[r * p]), int(so[(r + 1) * p])
        best_d[r:r + 1], best_i[r:r + 1] = t_scan._merge_smallest_id(
            best_d[r:r + 1], best_i[r:r + 1], pd[lo:hi].reshape(1, -1),
            pi[lo:hi].reshape(1, -1), k)
    return ((-best_d if ip_metric else best_d), best_i), writes


@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.InnerProduct],
                         ids=lambda m: m.name)
def test_cuda_engine_decomposition_matches_plain(packed, metric):
    arrays, q, probes, _ = packed
    args = _torch_args(arrays, q, probes)
    want = t_scan.list_major_scan(*args, k=10, metric=metric,
                                  engine="torch")
    got, writes = _emulate_cuda_scan(*args, 10, metric)
    assert (writes == 1).all()
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


def test_scan_pairs_cover_each_probe_once():
    probes = torch.tensor([[3, 1, 3, 7], [7, 7, 7, 7], [0, 2, 5, 1]],
                          dtype=torch.int32)       # 7 = n_lists sentinel
    uniq, offs, pair_q, pair_slot = t_scan._scan_pairs(probes, 7)
    assert uniq.tolist() == [0, 1, 2, 3, 5, 7, 7]
    pairs = set()
    for j in range(uniq.shape[0]):
        for e in range(int(offs[j]), int(offs[j + 1])):
            pairs.add((int(pair_q[e]), int(uniq[j])))
    assert pairs == {(0, 1), (0, 3), (2, 0), (2, 1), (2, 2), (2, 5)}
    assert int(offs[-1]) == len(pairs)


def test_unique_lists_and_ragged_front_match_reference():
    rng = np.random.default_rng(1)
    probes = rng.integers(0, 9, (6, 4)).astype(np.int32)
    probes[1, 2:] = 9
    want = np.asarray(j_scan.unique_lists(jnp.asarray(probes), 9))
    got = t_scan.unique_lists(torch.from_numpy(probes), 9)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    rp = j_scan.ragged_row_probes([2, 3], [4, 1], 6)
    assert np.array_equal(rp, t_scan.ragged_row_probes([2, 3], [4, 1], 6))
    want = np.asarray(j_scan.ragged_probes(jnp.asarray(probes),
                                           jnp.asarray(rp), 9))
    got = t_scan.ragged_probes(torch.from_numpy(probes),
                               torch.from_numpy(rp), 9)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["all_lists_and_sentinel", "out_of_range",
                                  "one_row"])
def test_unique_lists_past_the_cap_matches_reference(case):
    """More distinct values than the cap ``min(n_lists, q * n_probes)``:
    every list plus the sentinel, ids past the sentinel, or a single row
    whose cap is its probe count; the values past the cap are dropped."""
    n_lists = 4
    if case == "all_lists_and_sentinel":
        probes = np.array([[0, 1, 2], [3, 4, 4], [2, 0, 4]], np.int32)
    elif case == "out_of_range":
        probes = np.array([[7, 1, 3], [0, 2, 6], [5, 4, 1]], np.int32)
    else:
        n_lists = 9
        probes = np.array([[8, 2, 5, 9, 0]], np.int32)
    want = np.asarray(j_scan.unique_lists(jnp.asarray(probes), n_lists))
    got = t_scan.unique_lists(torch.from_numpy(probes), n_lists)
    assert got.shape == (min(n_lists, probes.size),)
    assert np.array_equal(got.numpy(), want)


def test_resolve_scan_engine():
    data = torch.zeros((2, 8, 4))
    assert t_scan.resolve_scan_engine("auto", data=data) == "torch"
    assert t_scan.resolve_scan_engine("torch", data=data) == "torch"
    assert t_scan.resolve_scan_engine("cuda", data=data, k=10) == "cuda"
    words = Bitset.create(16).words
    assert t_scan.resolve_scan_engine(
        "cuda", data=data, filter_words=words) == "cuda"
    assert t_scan.resolve_scan_engine(
        "cuda", data=data, filter_words=words[None].expand(3, -1)) == "torch"
    assert t_scan.resolve_scan_engine("cuda", data=data, k=129) == "torch"
    assert t_scan.resolve_scan_engine(
        "cuda", data=data.to(torch.int8)) == "torch"
    assert t_scan.resolve_scan_engine(
        "cuda", data=data.to(torch.bfloat16)) == "cuda"
    with pytest.raises(Exception, match="scan_engine"):
        t_scan.resolve_scan_engine("pallas", data=data)


def test_probe_histogram_matches_reference():
    rng = np.random.default_rng(3)
    probes = rng.integers(0, 9, (7, 4)).astype(np.int32)
    probes[1, 2:] = 9                              # sentinel slots drop
    probes[2, 0] = -1                              # counts from the end
    counts = rng.integers(0, 5, 9).astype(np.int32)
    for n_valid in (None, 5, 0):
        want = np.asarray(j_scan.probe_histogram(
            jnp.asarray(probes), jnp.asarray(counts), n_valid))
        got = t_scan.probe_histogram(torch.from_numpy(probes),
                                     torch.from_numpy(counts), n_valid)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def skewed():
    """A packed index whose lists span the item shapes: one longer than
    two row chunks, a short one, empty ones, padding past every list's
    end, and filtered rows at a list's end (its live rows stop early);
    probes with sentinel and repeated slots, and more than one query
    group on the long list."""
    rng = np.random.default_rng(7)
    n_lists, d = 6, 8
    sizes = [2 * t_scan._CHUNK_ROWS + 37, 5, 0, 300, 0, 64]
    labels = np.concatenate([np.full(s, i) for i, s in enumerate(sizes)])
    n = labels.size
    x = rng.integers(-3, 4, (n, d)).astype(np.float32)
    m = max(sizes) + 11                            # padding past every list
    data = np.zeros((n_lists, m, d), np.float32)
    indices = np.full((n_lists, m), -1, np.int32)
    fill = np.zeros(n_lists, np.int64)
    for row, lab in enumerate(labels):
        data[lab, fill[lab]] = x[row]
        indices[lab, fill[lab]] = row
        fill[lab] += 1
    norms = np.where(indices >= 0, (data * data).sum(axis=2),
                     np.inf).astype(np.float32)
    q = 150
    queries = rng.integers(-3, 4, (q, d)).astype(np.float32)
    probes = rng.integers(0, n_lists, (q, 4)).astype(np.int32)
    probes[:100, 0] = 0                             # two groups on list 0
    probes[3, 1:] = n_lists                         # sentinel slots
    probes[4, 2] = probes[4, 1]                     # repeated probe
    keep = np.ones(n, bool)
    keep[np.nonzero(labels == 3)[0][-40:]] = False  # a filtered tail
    words = np.array(JBitset.from_mask(keep).words)
    return dict(data=data, data_norms=norms, indices=indices), queries, \
        probes, words, keep


@pytest.mark.parametrize("use_filter", [False, True])
def test_items_cover_each_probed_live_row_once(skewed, use_filter):
    """Every (query, probed list, live row) is scored by exactly one work
    item, and no item reaches a row past its list's last live id."""
    arrays, q, probes, words, keep = skewed
    args = _torch_args(arrays, q, probes)
    fw = torch.from_numpy(words.view(np.int32)) if use_filter else None
    g = t_scan._launch_glue(args[0], args[3], args[4], fw, 5)
    seen = {}
    for j, chunk, start, cnt, r0, nrows in _decode_items(g, *probes.shape):
        assert 0 < nrows <= t_scan._CHUNK_ROWS and 0 < cnt <= 64
        assert r0 + nrows <= int(g["live"][j])
        lid = int(g["uniq"][j])
        for e in range(start, start + cnt):
            for r in range(r0, r0 + nrows):
                key = (int(g["pair_q"][e]), lid, r)
                seen[key] = seen.get(key, 0) + 1
    assert set(seen.values()) == {1}
    ind = arrays["indices"]
    want = set()
    for row in range(probes.shape[0]):
        for lid in set(int(v) for v in probes[row] if v < ind.shape[0]):
            live = ind[lid] >= 0
            if use_filter:
                live = live & keep[np.maximum(ind[lid], 0)]
            last = np.nonzero(live)[0]
            want.update((row, lid, r) for r in range(
                int(last[-1]) + 1 if last.size else 0))
    assert set(seen) == want
    assert int(g["live"].max()) > 2 * t_scan._CHUNK_ROWS  # 3 chunks
    # the filtered tail shortens list 3's live rows
    j3 = int(np.nonzero(g["uniq"].numpy() == 3)[0][0])
    assert int(g["live"][j3]) == (260 if use_filter else 300)


@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("use_filter", [False, True])
@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.InnerProduct],
                         ids=lambda m: m.name)
def test_chunked_items_equal_plain_and_reference(skewed, metric,
                                                 use_filter, k):
    """The CPU model of the work items plus the ragged merge equals the
    plain scan bit for bit and the JAX ``xla`` engine (ids exactly,
    distances to float32 rounding), writing each partial once."""
    arrays, q, probes, words, _ = skewed
    args = _torch_args(arrays, q, probes)
    fw = torch.from_numpy(words.view(np.int32)) if use_filter else None
    want = t_scan.list_major_scan(*args, fw, k=k, metric=metric,
                                  engine="torch")
    got, writes = _emulate_cuda_scan(*args, k, metric, fw)
    assert (writes == 1).all()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    # the seed bound drops candidates, never a result
    bounded, _ = _emulate_cuda_scan(*args, k, metric, fw, seed_bound=True)
    assert torch.equal(bounded[1], want[1])
    assert torch.equal(bounded[0], want[0])
    wd, wi = j_scan.list_major_scan(
        jnp.asarray(q), jnp.asarray(arrays["data"]),
        jnp.asarray(arrays["data_norms"]), jnp.asarray(arrays["indices"]),
        jnp.asarray(probes), None if fw is None else jnp.asarray(words),
        k=k, metric=JD(int(metric)), engine="xla")
    assert np.array_equal(got[1].numpy(), np.asarray(wi))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(wd), rtol=1e-6,
                               atol=0)


def test_seed_steps_name_a_probed_usable_list():
    """Each row's seed list is its first probe of a real (and, for the
    tiered scan, hot) list, as a union step; -1 where it has none."""
    probes = torch.tensor([[3, 1, 7], [7, 7, 7], [-1, 5, 2], [6, 4, 1]],
                          dtype=torch.int32)             # 7 = n_lists
    uniq = t_scan.unique_lists(t_scan.sorted_probes(probes, 7), 7)
    steps = t_scan._seed_steps(probes, uniq, 7)
    lists = [int(uniq[j]) if j >= 0 else None for j in steps.tolist()]
    assert lists == [3, None, 5, 6]
    hot = torch.tensor([True, True, False, False, True, True, False])
    steps = t_scan._seed_steps(probes, uniq, 7, usable=hot)
    lists = [int(uniq[j]) if j >= 0 else None for j in steps.tolist()]
    assert lists == [1, None, 5, 4]
