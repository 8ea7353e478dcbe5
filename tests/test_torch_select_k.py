"""The port's ``matrix.select_k`` against the JAX package's on the same
values: TOPK, SORT and TILES (the Pallas kernel in interpret mode; on the
CPU the port's TILES route is the kernel's plain version
``select_k_tiles_plain``). Values are integer-valued so that ties are
many and exact: ids must be equal (the lower index first on equal
values) and values equal.
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu_torch import Resources
from raft_tpu_torch.matrix import select_k as t_sel
from raft_tpu_torch.ops import fused_topk

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

# the module: raft_tpu.matrix's package namespace binds the function
j_sel = importlib.import_module("raft_tpu.matrix.select_k")
CPU = Resources(device="cpu")
ALGOS = ["TOPK", "SORT", "TILES"]


def _values(b, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-20, 20, (b, n)).astype(np.float32)


def _both(v, k, algo, **kw):
    want = j_sel.select_k(None, jnp.asarray(v), k,
                          algo=j_sel.SelectAlgo[algo], **kw)
    got = t_sel.select_k(CPU, v, k, algo=t_sel.SelectAlgo[algo], **kw)
    return got, want


def _equal(got, want):
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[1].dtype == torch.int32


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("k", [1, 7, 64])
@pytest.mark.parametrize("algo", ALGOS)
def test_matches_reference_with_ties(algo, k, select_min):
    v = _values(6, 300)
    _equal(*_both(v, k, algo, select_min=select_min))


@pytest.mark.parametrize("algo", ALGOS)
def test_index_values_payload(algo):
    v = _values(5, 200, seed=1)
    payload = np.random.default_rng(2).integers(0, 10**6, v.shape).astype(
        np.int32)
    got, want = _both(v, 9, algo, index_values=payload)
    _equal(got, want)


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("algo", ALGOS)
def test_short_finite_rows(algo, select_min):
    """Rows with fewer than k finite values: TILES fills the rest with
    index -1 (the kernels' caveat), TOPK and SORT return the positions
    of the infinite entries, lower index first."""
    v = _values(4, 200, seed=3)
    far = np.inf if select_min else -np.inf
    v[1, 3:] = far
    v[2, :] = far
    got, want = _both(v, 5, algo, select_min=select_min)
    _equal(got, want)
    if algo == "TILES":
        assert got[1][1].tolist()[3:] == [-1, -1]
        assert (got[1][2] == -1).all()


def test_wide_rows_bfloat16_match_interpreted_kernel():
    v = _values(3, 20_000, seed=4)
    v[0, 19_999] = -100.0                  # the best entry in the last tile
    vb = jnp.asarray(v, jnp.bfloat16)
    want = j_sel.select_k(None, vb, 10, algo=j_sel.SelectAlgo.TILES)
    got = t_sel.select_k(CPU, torch.from_numpy(v).to(torch.bfloat16), 10,
                         algo=t_sel.SelectAlgo.TILES)
    assert got[0].dtype == torch.bfloat16     # the caller's dtype back
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert np.array_equal(got[0].to(torch.float32).numpy(),
                          np.asarray(want[0].astype(jnp.float32)))
    assert int(got[1][0, 0]) == 19_999


def test_plain_selector_leaves_out_every_non_finite_value():
    v = torch.tensor([[3.0, float("nan"), -float("inf"), 1.0, float("inf"),
                       1.0]])
    d, i = fused_topk.select_k_tiles_plain(v, 4)
    assert i.tolist() == [[3, 5, 0, -1]]
    assert d[0, :3].tolist() == [1.0, 1.0, 3.0] and d[0, 3] == float("inf")
    d, i = fused_topk.select_k_tiles_plain(v, 4, select_min=False)
    assert i.tolist() == [[0, 3, 5, -1]]
    assert d[0, 3] == -float("inf")
    # the CPU wrapper takes the plain version
    assert torch.equal(fused_topk.select_k_tiles(v, 2)[1],
                       fused_topk.select_k_tiles_plain(v, 2)[1])


def test_approx_runs_exact():
    v = _values(4, 500, seed=5)
    got = t_sel.select_k(CPU, v, 12, algo=t_sel.SelectAlgo.APPROX)
    want = t_sel.select_k(CPU, v, 12, algo=t_sel.SelectAlgo.TOPK)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_choose_algo():
    c = t_sel._choose_algo
    A = t_sel.SelectAlgo
    assert c(4, 100, 100) == A.SORT
    assert c(4, 100, 80) == A.SORT
    assert c(4, 100, 10) == A.TOPK
    assert c(4, 1 << 20, 10, torch.float32, "cpu") == A.TOPK
    assert c(4, 1 << 20, 10, torch.float32, "cuda") == A.TILES
    assert c(4, 1 << 20, 10, torch.bfloat16, "cuda:0") == A.TILES
    assert c(4, 1 << 20, 10, torch.float16, "cuda") == A.TILES
    assert c(4, 1 << 20, 65, torch.float32, "cuda") == A.TOPK
    assert c(4, 16383, 10, torch.float32, "cuda") == A.TOPK
    assert c(4, 1 << 20, 10, torch.float64, "cuda") == A.TOPK
    assert j_sel._choose_algo(4, 1 << 20, 10).value == c(
        4, 1 << 20, 10).value            # the same rule off the card


def test_errors():
    with pytest.raises(Exception, match="k must be"):
        t_sel.select_k(CPU, np.zeros((2, 4), np.float32), 5)
    with pytest.raises(Exception, match="batch, n"):
        t_sel.select_k(CPU, np.zeros(4, np.float32), 1)


# ---------------------------------------------------------------------------
# the wide-row kernel's shared-bound filter (plain model)
# ---------------------------------------------------------------------------


def _queue_push(state, key, k, kp, lim):
    """One candidate into a chunk's queue (sorted list, buffer of kp): it
    enters when its key is at most the threshold; a full buffer merges
    into the list first (keeping the kp smallest) and tightens it."""
    if key > lim():
        return
    if len(state["buf"]) == kp:
        _queue_flush(state, k, kp)
        if key > lim():
            return
    state["buf"].append(key)


def _queue_flush(state, k, kp):
    state["list"] = sorted(state["list"] + state["buf"])[:kp]
    state["buf"] = []
    if len(state["list"]) >= k:
        state["thr"] = min(state["thr"], state["list"][k - 1])


def _filtered_select(values, k, select_min, chunk, seed, group=32):
    """Model of ``csrc/select_k.cu``: a row's columns cut into chunks of
    ``chunk``, each scanned ``group`` values at a time by its own filtered
    queue, the chunks' groups interleaved in a random order (``seed``). A
    candidate's key is (min-space value, column), non-finite values left
    out; its threshold is the lower of its list's k-th key (once the list
    holds k) and the row's bound, the smallest k-th key any list has
    reached (taken as a list merges). After the scan each list's first k
    entries go through one more queue under the final bound."""
    kp = 32 if k <= 32 else 64 if k <= 64 else 128
    rng = np.random.default_rng(seed)
    inf = (float("inf"), 1 << 31)
    out_d = np.full((values.shape[0], k), np.inf, np.float32)
    out_i = np.full((values.shape[0], k), -1, np.int32)
    for r, row in enumerate(values.astype(np.float32)):
        v = row if select_min else -row
        n = v.shape[0]
        chunks = [(c0, min(n, c0 + chunk)) for c0 in range(0, n, chunk)]
        states = [{"list": [], "buf": [], "thr": inf, "next": c0}
                  for c0, _ in chunks]
        bound = [inf]

        def scan_group(ci):
            st, (_, c1) = states[ci], chunks[ci]
            lim = lambda: min(st["thr"], bound[0])  # noqa: E731
            for c in range(st["next"], min(c1, st["next"] + group)):
                if np.isfinite(v[c]):
                    _queue_push(st, (float(v[c]), c), k, kp, lim)
            st["next"] = min(c1, st["next"] + group)
            bound[0] = min(bound[0], st["thr"])

        schedule = [ci for ci, (c0, c1) in enumerate(chunks)
                    for _ in range(-(-(c1 - c0) // group))]
        rng.shuffle(schedule)
        for ci in schedule:
            scan_group(ci)
        for st in states:
            _queue_flush(st, k, kp)
            bound[0] = min(bound[0], st["thr"])
        final = {"list": [], "buf": [], "thr": inf}
        for st in states:
            for key in st["list"][:k]:
                _queue_push(final, key, k, kp,
                            lambda: min(final["thr"], bound[0]))
        _queue_flush(final, k, kp)
        for j, (d, c) in enumerate(final["list"][:k]):
            out_d[r, j], out_i[r, j] = d, c
    return (out_d if select_min else -out_d), out_i


def _filter_rows(n, k, select_min, chunk):
    """Ties, all-equal, NaN, +-inf, fewer than k finite, and a row whose
    only finite values lie in its last chunk."""
    rng = np.random.default_rng(n + k)
    v = rng.integers(-20, 20, (7, n)).astype(np.float32)
    far = np.inf if select_min else -np.inf
    v[1, :] = 3.0
    v[2, ::7] = np.nan
    v[3, ::3] = -far
    v[3, 1::3] = far
    v[4, k // 2 + 1:] = far
    v[5, :((n - 1) // chunk) * chunk] = far
    v[6] = rng.standard_normal(n).astype(np.float32)
    v[6, ::5] = -0.0
    v[6, 1::5] = 0.0
    return v


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("chunk", [37, 256, 1000])
@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("k", [1, 7, 33, 64])
def test_shared_bound_filter_equals_plain(k, select_min, chunk, seed):
    v = _filter_rows(1200, k, select_min, chunk)
    got = _filtered_select(v, k, select_min, chunk, seed)
    want = fused_topk.select_k_tiles_plain(torch.from_numpy(v), k,
                                           select_min)
    assert np.array_equal(got[1], want[1].numpy())
    assert np.array_equal(got[0], want[0].numpy())


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("k", [1, 7, 33, 64])
def test_shared_bound_filter_matches_reference(k, select_min):
    """Against the JAX kernel (interpret mode) on the rows it defines: the
    JAX kernel lets NaN and the winning infinity into its top-k, which
    the port's kernels leave out, so those rows are compared with the
    plain version above only."""
    v = _filter_rows(1200, k, select_min, 256)[[0, 1, 4, 5, 6]]
    got = _filtered_select(v, k, select_min, 256, seed=3)
    want = j_sel.select_k(None, jnp.asarray(v), k, select_min=select_min,
                          algo=j_sel.SelectAlgo.TILES)
    assert np.array_equal(got[1], np.asarray(want[1]))
    assert np.array_equal(got[0], np.asarray(want[0]))


@pytest.mark.parametrize("sms", [1, 78, 132])
@pytest.mark.parametrize("shape", [(1, 2048), (64, 1 << 20), (37, 100003),
                                   (2048, 2048), (5, 16384), (300, 70000)])
def test_select_plan_covers_rows(shape, sms):
    """One warp a row, or a multiple of 8 warps (a block's warps share a
    row); the chunks cover the row."""
    b, n = shape
    splits, chunk = fused_topk._select_plan(b, n, sms)
    assert splits == 1 or splits % 8 == 0
    assert splits * chunk >= n and chunk % 8 == 0
    assert (splits - 1) * chunk < n
