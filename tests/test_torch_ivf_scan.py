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


def _emulate_cuda_scan(qf, data, norms, indices, probes, k, metric):
    """The CUDA engine's decomposition in plain code: each (list, query)
    pair's top-k lands in the query's probe slot, then the slots merge."""
    q, p = probes.shape
    n_lists = data.shape[0]
    uniq, offs, pair_q, pair_slot = t_scan._scan_pairs(probes, n_lists)
    pd = torch.full((q, p, k), float("inf"))
    pi = torch.full((q, p, k), -1, dtype=torch.int32)
    for j in range(uniq.shape[0]):
        for e in range(int(offs[j]), int(offs[j + 1])):
            row, slot, lid = int(pair_q[e]), int(pair_slot[e]), int(uniq[j])
            one = torch.full((1, p), n_lists, dtype=torch.int32)
            one[0, 0] = lid
            d, i = t_scan.list_major_scan(
                qf[row:row + 1], data, norms, indices, one, k=k,
                metric=metric, engine="torch")
            # the kernel's partials are min-space: inner products negated
            pd[row, slot] = -d[0] if metric == DistanceType.InnerProduct \
                else d[0]
            pi[row, slot] = i[0]
    best_d, best_i = t_scan._merge_smallest_id(
        torch.full((q, k), float("inf")), torch.full((q, k), -1,
                                                   dtype=torch.int32),
        pd.reshape(q, -1), pi.reshape(q, -1), k)
    return (-best_d if metric == DistanceType.InnerProduct else best_d), \
        best_i


@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.InnerProduct],
                         ids=lambda m: m.name)
def test_cuda_engine_decomposition_matches_plain(packed, metric):
    arrays, q, probes, _ = packed
    args = _torch_args(arrays, q, probes)
    want = t_scan.list_major_scan(*args, k=10, metric=metric,
                                  engine="torch")
    got = _emulate_cuda_scan(*args, 10, metric)
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
