"""The port's IVF-BQ index against the JAX package's: the pinned
rotation byte for byte, the sign-word packing, the RaBitQ encoding, the
index carried over by ``from_numpy`` searched end to end by the fused and
the estimate-only engines, the serialization format both ways, extend,
the over-fetch budget and refine.

Tolerances: the fused engines return exact distances, so ids must be
equal and distances equal to rtol 1e-5, plus 1e-6 (‖q‖² + max ‖x‖²)
for L2: the expanded form ‖q‖² + ‖x‖² - 2<q, x> loses digits to
cancellation, and the dot products are sums taken in another order.
The estimate-only engine crosses the rotated query in bfloat16; an ulp
of difference before that rounding can move a cross term by a bfloat16
step, so its estimates are held to rtol 1e-3 and its ids to 99%
agreement.
"""

from __future__ import annotations

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.distance.types import DistanceType as JD
from raft_tpu.neighbors import ivf_bq as j_bq
from raft_tpu.neighbors.refine import refine as jax_refine
from raft_tpu_torch import Resources
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors import brute_force
from raft_tpu_torch.neighbors import ivf_bq as t_bq
from raft_tpu_torch.neighbors import refine as t_refine

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

CPU = Resources(device="cpu")
_FIELDS = ("centers", "rotation", "codes", "rnorm", "cfac", "errw",
           "indices", "list_sizes")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((20, 40)) * 4
    x = (centers[rng.integers(0, 20, 3000)]
         + rng.standard_normal((3000, 40))).astype(np.float32)
    q = (centers[rng.integers(0, 20, 50)]
         + rng.standard_normal((50, 40))).astype(np.float32)
    return x, q


_JAX_INDEXES = {}


def _jax_index(x, *, metric=JD.L2Expanded, bits=1, store_vectors=True):
    key = (int(metric), bits, store_vectors)
    if key not in _JAX_INDEXES:
        _JAX_INDEXES[key] = j_bq.build(None, j_bq.IvfBqIndexParams(
            n_lists=16, bits=bits, metric=metric,
            store_vectors=store_vectors), x)
    return _JAX_INDEXES[key]


def _assert_distances(got, want, x, q):
    """rtol 1e-5 plus the expanded form's cancellation (docstring)."""
    scale = float((q * q).sum(axis=1).max() + (x * x).sum(axis=1).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)


def _carry(jidx) -> t_bq.IvfBqIndex:
    arrays = [np.asarray(getattr(jidx, f)) for f in _FIELDS]
    data = None if jidx.data is None else np.asarray(jidx.data)
    return t_bq.from_numpy(*arrays, metric=DistanceType(int(jidx.metric)),
                           data=data, res=CPU)


@pytest.mark.parametrize("seed,dim_ext,dim", [(0, 64, 40), (3, 128, 100),
                                              (11, 32, 32)])
def test_pinned_rotation_is_byte_identical(seed, dim_ext, dim):
    want = np.asarray(j_bq._pinned_rotation(seed, dim_ext, dim))
    got = t_bq._pinned_rotation(seed, dim_ext, dim)
    assert got.dtype == np.float32 and got.shape == (dim_ext, dim)
    assert got.tobytes() == want.tobytes()


def test_pack_words_round_trip_and_reference():
    rng = np.random.default_rng(1)
    r = rng.standard_normal((9, 96)).astype(np.float32)
    r[0] = -1.0                      # bit 31 set in every word: negative
    packed = t_bq._pack_words(torch.from_numpy(r) >= 0)
    assert packed.dtype == torch.int32 and packed.shape == (9, 3)
    want = np.asarray(j_bq._pack_words(jnp.asarray(r) >= 0))
    assert np.array_equal(packed.numpy(), want)
    for dtype in (torch.bfloat16, torch.float32):
        pm1 = t_bq._unpack_pm1(packed, dtype)
        assert pm1.dtype == dtype
        assert np.array_equal(pm1.to(torch.float32).numpy(),
                              np.where(r >= 0, 1.0, -1.0))


@pytest.mark.parametrize("bits", [1, 2, 3])
def test_encode_matches_reference(bits):
    rng = np.random.default_rng(bits)
    r = rng.standard_normal((400, 64)).astype(np.float32)
    want = [np.asarray(t) for t in j_bq._encode(jnp.asarray(r), bits)]
    got = [t.numpy() for t in t_bq._encode(torch.from_numpy(r), bits)]
    assert np.array_equal(got[0], want[0])           # codes
    for g, w in zip(got[1:], want[1:]):              # rnorm, cfac, errw
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bits", [1, 2])
@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.L2SqrtExpanded,
                                    DistanceType.InnerProduct],
                         ids=lambda m: m.name)
def test_fused_search_matches_reference(data, metric, bits):
    x, q = data
    jidx = _jax_index(x, metric=JD(int(metric)), bits=bits)
    wd, wi = j_bq.search(None, j_bq.IvfBqSearchParams(n_probes=6), jidx, q,
                         10)
    gd, gi = t_bq.search(CPU, t_bq.IvfBqSearchParams(n_probes=6),
                         _carry(jidx), q, 10)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    _assert_distances(gd.numpy(), np.asarray(wd), x, q)


def test_fused_search_with_filter_and_tiles(data):
    x, q = data
    jidx = _jax_index(x)
    rng = np.random.default_rng(5)
    keep = rng.random(x.shape[0]) < 0.6
    from raft_tpu.core.bitset import Bitset as JBitset

    words = np.array(JBitset.from_mask(keep).words)
    wd, wi = j_bq.search(None, j_bq.IvfBqSearchParams(n_probes=6), jidx, q,
                         10, sample_filter=jnp.asarray(words), query_tile=16)
    gd, gi = t_bq.search(CPU, t_bq.IvfBqSearchParams(n_probes=6),
                         _carry(jidx), q, 10, sample_filter=words,
                         query_tile=16)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    _assert_distances(gd.numpy(), np.asarray(wd), x, q)
    assert keep[gi.numpy()[gi.numpy() >= 0]].all()


@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.InnerProduct],
                         ids=lambda m: m.name)
def test_codes_only_rank_engine_matches_reference(data, metric):
    x, q = data
    jidx = _jax_index(x, metric=JD(int(metric)), store_vectors=False)
    tidx = _carry(jidx)
    assert tidx.data is None
    sp = dict(n_probes=6)
    wd, wi = j_bq.search(None, j_bq.IvfBqSearchParams(**sp), jidx, q, 20)
    gd, gi = t_bq.search(CPU, t_bq.IvfBqSearchParams(**sp), tidx, q, 20)
    assert (gi.numpy() == np.asarray(wi)).mean() >= 0.99
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-3,
                               atol=1e-3)
    # the same engine on an index that carries the vectors
    full = _carry(_jax_index(x, metric=JD(int(metric))))
    _, ri = t_bq.search(CPU, t_bq.IvfBqSearchParams(
        scan_engine="rank", **sp), full, q, 20)
    assert (ri.numpy() == np.asarray(wi)).mean() >= 0.99


def test_estimate_then_refine_recovers_the_fused_answer(data):
    x, q = data
    tidx = _carry(_jax_index(x, store_vectors=False))
    jbudget = j_bq.overfetch_budget(_jax_index(x, store_vectors=False), 10,
                                    confidence=2.0)
    budget = t_bq.overfetch_budget(tidx, 10, confidence=2.0)
    assert budget == jbudget and budget > 10
    stats = t_bq.estimator_stats(tidx)
    jstats = j_bq.estimator_stats(_jax_index(x, store_vectors=False))
    for key in ("mean_errw", "mean_rnorm2", "rel_err"):
        assert stats[key] == pytest.approx(jstats[key], rel=1e-5)
    _, cand = t_bq.search(CPU, t_bq.IvfBqSearchParams(n_probes=16), tidx, q,
                          budget)
    d, i = t_refine.refine(CPU, x, q, cand, 10)
    _, gt = brute_force.knn(CPU, x, q, 10)
    recall = (i[:, :, None] == gt[:, None, :]).any(dim=2).float().mean()
    assert float(recall) >= 0.95
    assert t_bq.overfetch_budget(_carry(_jax_index(x)), 10) == 10


@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.L2SqrtExpanded,
                                    DistanceType.InnerProduct],
                         ids=lambda m: m.name)
def test_refine_matches_reference(metric):
    rng = np.random.default_rng(2)
    x = rng.integers(-3, 4, (500, 24)).astype(np.float32)
    q = rng.integers(-3, 4, (13, 24)).astype(np.float32)
    cand = rng.integers(0, 500, (13, 40)).astype(np.int32)
    cand[:, -3:] = -1                                 # missing candidates
    wd, wi = jax_refine(None, x, q, cand, 8, metric=JD(int(metric)))
    gd, gi = t_refine.refine(CPU, x, q, cand, 8, metric=metric)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-6)


@pytest.mark.parametrize("store_vectors", [True, False])
def test_files_cross_both_ways(data, store_vectors):
    x, q = data
    jidx = _jax_index(x, store_vectors=store_vectors)
    want = io.BytesIO()
    j_bq.save(jidx, want)
    tidx = t_bq.load(CPU, io.BytesIO(want.getvalue()))
    for f in _FIELDS:
        assert np.array_equal(getattr(tidx, f).numpy(),
                              np.asarray(getattr(jidx, f))), f
    assert (tidx.data is None) == (not store_vectors)
    got = io.BytesIO()
    t_bq.save(tidx, got)
    assert got.getvalue() == want.getvalue()          # byte for byte
    back = j_bq.load(None, io.BytesIO(got.getvalue()))
    sp = j_bq.IvfBqSearchParams(n_probes=4)
    for a, b in zip(j_bq.search(None, sp, back, q, 5),
                    j_bq.search(None, sp, jidx, q, 5)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_port_build_save_load_search_is_bit_identical(data):
    x, q = data
    idx = t_bq.build(CPU, t_bq.IvfBqIndexParams(n_lists=16, bits=2), x)
    assert idx.size == x.shape[0] and idx.dim_ext == 64 and idx.bits == 2
    sp = t_bq.IvfBqSearchParams(n_probes=8)
    d, i = t_bq.search(CPU, sp, idx, q, 10)
    _, gt = brute_force.knn(CPU, x, q, 10)
    recall = (i[:, :, None] == gt[:, None, :]).any(dim=2).float().mean()
    assert float(recall) >= 0.95
    buf = io.BytesIO()
    t_bq.save(idx, buf)
    buf.seek(0)
    d2, i2 = t_bq.search(CPU, sp, t_bq.load(CPU, buf), q, 10)
    assert torch.equal(d, d2) and torch.equal(i, i2)
    # the JAX package reads the port's file and encodes with the same
    # rotation bytes
    buf.seek(0)
    jl = j_bq.load(None, buf)
    assert np.array_equal(np.asarray(jl.codes), idx.codes.numpy())
    assert np.asarray(jl.rotation).tobytes() == \
        idx.rotation.numpy().tobytes()


def test_extend_matches_reference(data):
    x, q = data
    base = j_bq.build(None, j_bq.IvfBqIndexParams(n_lists=16), x[:2000])
    want = j_bq.extend(None, base, x[2000:])
    got = t_bq.extend(CPU, _carry(base), x[2000:])
    for f in ("indices", "list_sizes", "codes"):
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f
    for f in ("rnorm", "cfac", "errw", "data", "data_norms"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5,
                                   atol=1e-5)
    sp = dict(n_probes=6)
    wd, wi = j_bq.search(None, j_bq.IvfBqSearchParams(**sp), want, q, 10)
    gd, gi = t_bq.search(CPU, t_bq.IvfBqSearchParams(**sp), got, q, 10)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    _assert_distances(gd.numpy(), np.asarray(wd), x, q)


def test_build_without_data_then_extend_with_ids(data):
    x, _ = data
    empty = t_bq.build(CPU, t_bq.IvfBqIndexParams(
        n_lists=8, add_data_on_build=False), x[:500])
    assert empty.size == 0 and empty.max_list_size == 0
    with pytest.raises(Exception, match="empty"):
        t_bq.search(CPU, t_bq.IvfBqSearchParams(), empty, x[:2], 1)
    ids = np.arange(1000, 1500, dtype=np.int32)
    full = t_bq.extend(CPU, empty, x[:500], ids)
    assert full.size == 500
    assert set(full.indices[full.indices >= 0].tolist()) == set(ids.tolist())
    _, i = t_bq.search(CPU, t_bq.IvfBqSearchParams(n_probes=8), full, x[:5],
                       1)
    assert i[:, 0].tolist() == list(range(1000, 1005))


def test_params_and_errors():
    with pytest.raises(Exception, match="bits"):
        t_bq.build(CPU, t_bq.IvfBqIndexParams(n_lists=2, bits=5),
                   np.zeros((8, 32), np.float32))
    with pytest.raises(Exception, match="supports"):
        t_bq.build(CPU, t_bq.IvfBqIndexParams(
            n_lists=2, metric=DistanceType.L1), np.zeros((8, 32), np.float32))
