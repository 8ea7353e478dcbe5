"""IVF-Flat as a whole slice, against the JAX package on the CPU.

Indexes built by the JAX package are saved, loaded into the port (or
handed over with ``from_numpy``) and searched by both: on
integer-valued data every product is exact, so ids are EXACTLY equal
and distances equal to float32 rounding (rtol 1e-6); on Gaussian data
distances agree to rtol 1e-5 / atol 1e-4 x scale. Both ``extend`` paths
must lay out the same tensors as the JAX package's. A port-built index
is held to recall: at least the JAX build's recall@10 - 0.02 against
the port's own brute force. Files cross in both directions, bf16 too.
"""

from __future__ import annotations

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core.bitset import Bitset as JBitset
from raft_tpu.distance.types import DistanceType as JD
from raft_tpu.neighbors import ivf_flat as j_ivf
from raft_tpu_torch import Resources
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors import brute_force as t_bf
from raft_tpu_torch.neighbors import ivf_flat as t_ivf

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

RES = Resources(device="cpu")
N_LISTS = 16


def _int_data(seed=0, n=1500, d=16, q=25):
    rng = np.random.default_rng(seed)
    x = rng.integers(-4, 5, (n, d)).astype(np.float32)
    x[900] = x[4]
    qs = rng.integers(-4, 5, (q, d)).astype(np.float32)
    qs[0] = x[4]
    return x, qs


def _jax_to_port(jidx):
    buf = io.BytesIO()
    j_ivf.save(jidx, buf)
    buf.seek(0)
    return t_ivf.load(RES, buf)


def _port_to_jax(tidx):
    buf = io.BytesIO()
    t_ivf.save(tidx, buf)
    buf.seek(0)
    return j_ivf.load(None, buf)


def _search_both(jidx, tidx, q, k, n_probes, jfilter=None, tfilter=None):
    wd, wi = j_ivf.search(None, j_ivf.IvfFlatSearchParams(
        n_probes=n_probes, scan_engine="xla"), jidx, q, k, jfilter)
    gd, gi = t_ivf.search(RES, t_ivf.IvfFlatSearchParams(n_probes=n_probes),
                          tidx, q, k, tfilter)
    return (np.asarray(wd), np.asarray(wi)), (gd.numpy(), gi.numpy())


def _assert_exact(want, got):
    assert np.array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_probes", [1, 5, N_LISTS])
@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.L2SqrtExpanded,
                                    DistanceType.InnerProduct],
                         ids=lambda m: m.name)
def test_jax_built_index_searched_by_both(metric, n_probes):
    x, q = _int_data()
    jidx = j_ivf.build(None, j_ivf.IvfFlatIndexParams(
        n_lists=N_LISTS, metric=JD(int(metric))), x)
    tidx = _jax_to_port(jidx)
    want, got = _search_both(jidx, tidx, q, 10, n_probes)
    _assert_exact(want, got)
    if metric != DistanceType.InnerProduct:
        assert list(got[1][0, :2]) == [4, 900]


def test_from_numpy_equals_load_and_gaussian_tolerance():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1200, 24)).astype(np.float32)
    q = rng.standard_normal((40, 24)).astype(np.float32)
    jidx = j_ivf.build(None, j_ivf.IvfFlatIndexParams(n_lists=N_LISTS), x)
    tidx = t_ivf.from_numpy(
        np.asarray(jidx.centers), np.asarray(jidx.data),
        np.asarray(jidx.indices), np.asarray(jidx.list_sizes),
        jidx.metric, jidx.adaptive_centers, res=RES)
    loaded = _jax_to_port(jidx)
    for name in ("centers", "data", "data_norms", "indices", "list_sizes"):
        assert torch.equal(getattr(tidx, name), getattr(loaded, name)), name
    want, got = _search_both(jidx, tidx, q, 10, 6)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-4 * 48)
    assert (got[1] == want[1]).mean() >= 0.99


def _assert_same_layout(jidx, tidx):
    for name in ("data", "indices", "list_sizes"):
        assert np.array_equal(getattr(tidx, name).numpy(),
                              np.asarray(getattr(jidx, name))), name
    np.testing.assert_allclose(tidx.centers.numpy(), np.asarray(jidx.centers),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("path", ["scatter", "repack", "adaptive"])
def test_extend_paths_match_reference(path):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1000, 16)).astype(np.float32)
    jidx = j_ivf.build(None, j_ivf.IvfFlatIndexParams(
        n_lists=N_LISTS, adaptive_centers=path == "adaptive"), x)
    tidx = _jax_to_port(jidx)
    if path == "scatter":
        # copies of rows of the least-filled list: they land there, in
        # its padding
        small = int(torch.argmin(tidx.list_sizes))
        assert tidx.max_list_size - int(tidx.list_sizes[small]) >= 3
        extra = tidx.data[small, :3].numpy().copy()
    else:
        extra = rng.standard_normal((900, 16)).astype(np.float32)
    j2 = j_ivf.extend(None, jidx, extra)
    t2 = t_ivf.extend(RES, tidx, extra)
    grew = t2.max_list_size != tidx.max_list_size
    assert grew == (path != "scatter")
    _assert_same_layout(j2, t2)
    assert t2.size == 1000 + extra.shape[0]
    # the functional extend leaves the old index as it was
    assert tidx.size == 1000
    if path == "scatter":     # donated: the same result, written in place
        t3 = t_ivf.extend(RES, tidx, extra, donate=True)
        assert t3.data.data_ptr() == tidx.data.data_ptr()
        _assert_same_layout(j2, t3)


def test_port_built_recall_not_below_reference():
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((30, 16)).astype(np.float32) * 3.0
    x = (centers[rng.integers(0, 30, 3000)]
         + rng.standard_normal((3000, 16))).astype(np.float32)
    q = (centers[rng.integers(0, 30, 100)]
         + rng.standard_normal((100, 16))).astype(np.float32)
    _, truth = t_bf.search(RES, t_bf.build(RES, x), q, 10)
    truth = truth.numpy()

    def recall(ids):
        return np.mean([len(set(a) & set(b)) / 10.0
                        for a, b in zip(ids, truth)])

    jidx = j_ivf.build(None, j_ivf.IvfFlatIndexParams(n_lists=32), x)
    tidx = t_ivf.build(RES, t_ivf.IvfFlatIndexParams(n_lists=32), x)
    assert tidx.size == 3000 and tidx.n_lists == 32
    sp = dict(n_probes=4)
    _, wi = j_ivf.search(None, j_ivf.IvfFlatSearchParams(**sp), jidx, q, 10)
    _, gi = t_ivf.search(RES, t_ivf.IvfFlatSearchParams(**sp), tidx, q, 10)
    assert recall(gi.numpy()) >= recall(np.asarray(wi)) - 0.02


@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.InnerProduct],
                         ids=lambda m: m.name)
def test_port_built_index_loads_in_jax(metric):
    x, q = _int_data(seed=4)
    tidx = t_ivf.build(RES, t_ivf.IvfFlatIndexParams(n_lists=N_LISTS,
                                                     metric=metric), x)
    jidx = _port_to_jax(tidx)
    want, got = _search_both(jidx, tidx, q, 10, 4)
    _assert_exact(want, got)


def test_bf16_index_both_ways():
    x, q = _int_data(seed=5)
    jidx = j_ivf.build(None, j_ivf.IvfFlatIndexParams(n_lists=N_LISTS),
                       jnp.asarray(x, jnp.bfloat16))
    tidx = _jax_to_port(jidx)
    assert tidx.data.dtype == torch.bfloat16
    want, got = _search_both(jidx, tidx, q, 10, 5)
    _assert_exact(want, got)
    back = _port_to_jax(tidx)
    assert back.data.dtype == jnp.bfloat16
    assert np.array_equal(np.asarray(back.data, np.float32),
                          np.asarray(jidx.data, np.float32))


def test_filtered_search_and_query_tiles():
    x, q = _int_data(seed=6, q=40)
    jidx = j_ivf.build(None, j_ivf.IvfFlatIndexParams(n_lists=N_LISTS), x)
    tidx = _jax_to_port(jidx)
    mask = np.random.default_rng(7).random(x.shape[0]) < 0.6
    want, got = _search_both(jidx, tidx, q, 10, 6, JBitset.from_mask(mask),
                             Bitset.from_mask(torch.from_numpy(mask)))
    _assert_exact(want, got)
    assert mask[got[1][got[1] >= 0]].all()
    gd, gi = t_ivf.search(RES, t_ivf.IvfFlatSearchParams(n_probes=6), tidx,
                          q, 10, Bitset.from_mask(torch.from_numpy(mask)),
                          query_tile=16)
    assert np.array_equal(gi.numpy(), got[1])


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.L2SqrtExpanded,
                                    DistanceType.InnerProduct],
                         ids=lambda m: m.name)
def test_rank_engine_equals_reference_rank(metric, filtered):
    """The legacy rank-major engine against the JAX ``rank`` engine:
    exact ids on integer data (ties to the running state first), and
    distances within 1e-5 (1 + |d|)."""
    x, q = _int_data(seed=8, q=30)
    jidx = j_ivf.build(None, j_ivf.IvfFlatIndexParams(
        n_lists=N_LISTS, metric=JD(int(metric))), x)
    tidx = _jax_to_port(jidx)
    mask = np.random.default_rng(9).random(x.shape[0]) < 0.5
    jf = JBitset.from_mask(mask) if filtered else None
    tf = Bitset.from_mask(torch.from_numpy(mask)) if filtered else None
    for n_probes in (1, 4, N_LISTS):
        wd, wi = j_ivf.search(None, j_ivf.IvfFlatSearchParams(
            n_probes=n_probes, scan_engine="rank"), jidx, q, 10, jf)
        gd, gi = t_ivf.search(RES, t_ivf.IvfFlatSearchParams(
            n_probes=n_probes, scan_engine="rank"), tidx, q, 10, tf)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        wd = np.asarray(wd)
        fin = np.isfinite(wd)
        assert np.array_equal(np.isfinite(gd.numpy()), fin)
        err = np.abs(gd.numpy()[fin] - wd[fin])
        assert (err <= 1e-5 * (1 + np.abs(wd[fin]))).all(), err.max()
    # every list probed: the list-major engine's distances (its ties go
    # to the smallest id, the rank engine's to the earlier probe)
    ld, _ = t_ivf.search(RES, t_ivf.IvfFlatSearchParams(
        n_probes=N_LISTS, scan_engine="torch"), tidx, q, 10, tf)
    assert torch.equal(gd, ld)
