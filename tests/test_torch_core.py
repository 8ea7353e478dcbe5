"""Port foundations against the JAX package on the same inputs:
serialization (both directions), bitsets and filters, batching, packing,
merge_topk and the k-means argmin. Exact equality unless stated."""

from __future__ import annotations

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core import serialize as jser
from raft_tpu.core.bitset import Bitset as JBitset
from raft_tpu.distance.fused_l2_nn import fused_l2_nn_argmin as j_l2nn
from raft_tpu.matrix.select_k import merge_topk as j_merge
from raft_tpu.neighbors import _batching as jbatch
from raft_tpu.neighbors import _packing as jpack
from raft_tpu.neighbors.filters import BitmapFilter as JBitmap
from raft_tpu_torch.core import serialize as tser
from raft_tpu_torch.core import bitset as tbitset
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn_argmin as t_l2nn
from raft_tpu_torch.distance.types import DistanceType, is_min_close
from raft_tpu_torch.matrix.select_k import merge_topk as t_merge
from raft_tpu_torch.neighbors import _batching as tbatch
from raft_tpu_torch.neighbors import _packing as tpack
from raft_tpu_torch.neighbors import filters as tfilters
from raft_tpu_torch.neighbors.filters import (
    BitmapFilter,
    BitsetFilter,
    NoneSampleFilter,
    resolve_filter_words,
)

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)


def test_distance_type_values_match_reference():
    from raft_tpu.distance.types import DistanceType as JD

    assert {m.name: int(m) for m in DistanceType} == \
        {m.name: int(m) for m in JD}
    assert not is_min_close(DistanceType.InnerProduct)
    assert is_min_close(DistanceType.L2Expanded)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_serialize_records_roundtrip_across_packages(direction):
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((5, 3)).astype(np.float32)
    i32 = rng.integers(-5, 5, (7,)).astype(np.int32)
    bf = rng.standard_normal((4, 6)).astype(np.float32)
    buf = io.BytesIO()
    if direction == "jax_to_port":
        jser.serialize_scalar(buf, 4, np.int32)
        jser.serialize_array(buf, jnp.asarray(f32))
        jser.serialize_array(buf, jnp.asarray(i32))
        jser.serialize_array(buf, jnp.asarray(bf, jnp.bfloat16))
        buf.seek(0)
        assert int(tser.deserialize_scalar(buf)) == 4
        a, b, c = (tser.deserialize_array(buf) for _ in range(3))
    else:
        tser.serialize_scalar(buf, 4, np.int32)
        tser.serialize_array(buf, torch.from_numpy(f32))
        tser.serialize_array(buf, torch.from_numpy(i32))
        tser.serialize_array(buf, torch.from_numpy(bf).to(torch.bfloat16))
        buf.seek(0)
        assert int(jser.deserialize_scalar(buf)) == 4
        a, b, c = (jser.deserialize_array(buf) for _ in range(3))
        a, b = torch.from_numpy(a), torch.from_numpy(b)
        c = torch.from_numpy(np.asarray(c, np.float32)).to(torch.bfloat16)
    assert a.dtype == torch.float32 and torch.equal(a, torch.from_numpy(f32))
    assert b.dtype == torch.int32 and torch.equal(b, torch.from_numpy(i32))
    assert c.dtype == torch.bfloat16
    assert torch.equal(c, torch.from_numpy(bf).to(torch.bfloat16))


def test_serialize_bytes_identical():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    bj, bt = io.BytesIO(), io.BytesIO()
    jser.serialize_array(bj, jnp.asarray(x, jnp.bfloat16))
    tser.serialize_array(bt, torch.from_numpy(x).to(torch.bfloat16))
    assert bj.getvalue() == bt.getvalue()


def test_bitset_words_and_tests_match():
    rng = np.random.default_rng(1)
    mask = rng.random(100) < 0.4
    jb = JBitset.from_mask(mask)
    tb = Bitset.from_mask(torch.from_numpy(mask))
    assert np.array_equal(np.asarray(jb.words).view(np.int32),
                          tb.words.numpy())
    idx = rng.integers(-3, 100, (6, 11))
    assert np.array_equal(np.asarray(jb.test(idx)),
                          tb.test(torch.from_numpy(idx)).numpy())
    assert np.array_equal(tb.to_mask().numpy(), mask)
    assert tb.count() == int(mask.sum())
    assert torch.equal(tbitset.test_words(tb.words, torch.from_numpy(idx)),
                       tb.test(torch.from_numpy(idx)))
    assert Bitset.create(40).count() == 40
    assert Bitset.create(40, default=False).count() == 0


def test_filters_resolve_and_test_match():
    rng = np.random.default_rng(2)
    mask = rng.random((3, 70)) < 0.5
    jw = np.asarray(JBitmap.from_mask(mask).words)
    tw = BitmapFilter.from_mask(mask).words
    assert np.array_equal(jw.view(np.int32), tw.numpy())
    ids = torch.from_numpy(rng.integers(0, 70, (3, 9)))
    want = np.take_along_axis(mask, ids.numpy(), axis=1)
    assert np.array_equal(tfilters.test_filter(tw, ids).numpy(), want)
    shared = Bitset.from_mask(torch.from_numpy(mask[0]))
    assert resolve_filter_words(None) is None
    assert resolve_filter_words(NoneSampleFilter()) is None
    assert resolve_filter_words(shared) is shared.words
    assert resolve_filter_words(BitsetFilter(shared)) is shared.words
    raw = resolve_filter_words(jw)            # numpy uint32 words
    assert raw.dtype == torch.int32 and np.array_equal(raw.numpy(),
                                                       jw.view(np.int32))
    with pytest.raises(TypeError):
        resolve_filter_words("nope")


def test_coarse_select_keeps_top_k_order_on_ties():
    rng = np.random.default_rng(3)
    score = rng.integers(0, 4, (9, 40)).astype(np.float32)   # many ties
    want = np.asarray(jbatch.coarse_select(jnp.asarray(score), 7, "exact"))
    got = tbatch.coarse_select(torch.from_numpy(score), 7, "exact")
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    # "approx" has no GPU counterpart: the exact route
    assert torch.equal(tbatch.coarse_select(torch.from_numpy(score), 7,
                                            "approx"), got)


def test_tile_queries_pads_and_concatenates():
    seen = []

    def run(qt, fw):
        seen.append((qt.shape[0], None if fw is None else fw.shape[0]))
        return qt.sum(dim=1, keepdim=True), qt[:, :1].to(torch.int32)

    q = torch.arange(30, dtype=torch.float32).reshape(10, 3)
    words = torch.zeros((10, 2), dtype=torch.int32)
    d, i = tbatch.tile_queries(run, q, words, 4)
    assert seen == [(4, 4), (4, 4), (4, 4)]
    assert torch.equal(d, q.sum(dim=1, keepdim=True))
    assert torch.equal(i, q[:, :1].to(torch.int32))
    assert tbatch.pad_rows(q, 12).shape == (12, 3)
    assert tbatch.pad_rows(q, 5) is q


def test_packing_matches_reference():
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 6, 50).astype(np.int32)
    vals = rng.standard_normal((50, 3)).astype(np.float32)
    ids = np.arange(50, dtype=np.int32)
    m = jpack.padded_extent(np.bincount(labels, minlength=6))
    assert tpack.padded_extent(torch.bincount(torch.from_numpy(labels))) == m
    (jd, ji), js = jpack.pack_padded_lists(labels, 6, m,
                                           [(vals, 0), (ids, -1)])
    (td, ti), ts = tpack.pack_padded_lists(
        torch.from_numpy(labels), 6, m,
        [(torch.from_numpy(vals), 0), (torch.from_numpy(ids), -1)])
    assert np.array_equal(np.asarray(jd), td.numpy())
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())
    fill_j = np.asarray(js).astype(np.int64)
    fill_t = fill_j.copy()
    lab2 = rng.integers(0, 6, 20)
    assert np.array_equal(jpack.streaming_ranks(lab2, fill_j, 6),
                          tpack.streaming_ranks(lab2, fill_t, 6))
    assert np.array_equal(fill_j, fill_t)


@pytest.mark.parametrize("select_min", [True, False])
def test_merge_topk_matches_reference(select_min):
    rng = np.random.default_rng(5)
    bd = np.sort(rng.integers(0, 5, (6, 4)).astype(np.float32), axis=1)
    if not select_min:
        bd = bd[:, ::-1].copy()
    bi = rng.integers(0, 100, (6, 4)).astype(np.int32)
    cd = rng.integers(0, 5, (6, 9)).astype(np.float32)
    ci = rng.integers(0, 100, (6, 9)).astype(np.int32)
    wd, wi = j_merge(jnp.asarray(bd), jnp.asarray(bi), jnp.asarray(cd),
                     jnp.asarray(ci), 4, select_min)
    gd, gi = t_merge(*(torch.from_numpy(a) for a in (bd, bi, cd, ci)), 4,
                     select_min)
    assert np.array_equal(np.asarray(wd), gd.numpy())
    assert np.array_equal(np.asarray(wi), gi.numpy())


def test_fused_l2_nn_argmin_matches_reference():
    rng = np.random.default_rng(6)
    x = rng.integers(-3, 4, (200, 8)).astype(np.float32)
    y = rng.integers(-3, 4, (37, 8)).astype(np.float32)
    y[20] = y[3]                         # a tie: the first index wins
    wd, wi = j_l2nn(None, jnp.asarray(x), jnp.asarray(y))
    gd, gi = t_l2nn(torch.from_numpy(x), torch.from_numpy(y))
    assert np.array_equal(np.asarray(wi), gi.numpy())
    np.testing.assert_allclose(np.asarray(wd), gd.numpy(), rtol=0, atol=0)
    assert jax.default_backend() == "cpu"
