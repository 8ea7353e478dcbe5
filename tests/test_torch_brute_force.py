"""Exact kNN as a whole slice: an index built and saved by the JAX
package, loaded into the port, searched by both on the CPU.

Integer-valued data: every product exact, so ids are EXACTLY equal
(ties in lax.top_k's order, lower index first) and distances equal to
float32 rounding (rtol 1e-6). Gaussian data: distances agree to rtol
1e-5 / atol 1e-4 x scale, ids equal except at such near ties."""

from __future__ import annotations

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.distance.types import DistanceType as JD
from raft_tpu.neighbors import brute_force as j_bf
from raft_tpu_torch import Resources
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors import brute_force as t_bf

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

RES = Resources(device="cpu")
METRICS = [DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
           DistanceType.InnerProduct, DistanceType.CosineExpanded,
           DistanceType.L2Unexpanded]


def _int_data(seed=0, n=700, d=20, q=13):
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, (n, d)).astype(np.float32)
    x[333] = x[11]
    qs = rng.integers(-3, 4, (q, d)).astype(np.float32)
    qs[0] = x[11]
    return x, qs


def _jax_to_port(jidx):
    buf = io.BytesIO()
    j_bf.save(jidx, buf)
    buf.seek(0)
    return t_bf.load(RES, buf)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m.name)
def test_jax_built_index_searched_by_both(metric):
    x, q = _int_data()
    jidx = j_bf.build(None, x, JD(int(metric)))
    tidx = _jax_to_port(jidx)
    assert tidx.metric == metric and tidx.dataset.dtype == torch.float32
    wd, wi = j_bf.search(None, jidx, q, 12, db_tile=256)
    gd, gi = t_bf.search(RES, tidx, q, 12, db_tile=256)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-6,
                               atol=1e-6)


def test_gaussian_within_tolerance_and_query_tiles():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((900, 24)).astype(np.float32)
    q = rng.standard_normal((50, 24)).astype(np.float32)
    wd, wi = j_bf.search(None, j_bf.build(None, x), q, 10)
    tidx = t_bf.build(RES, x)
    gd, gi = t_bf.search(RES, tidx, q, 10, query_tile=16, db_tile=128)
    wd, wi = np.asarray(wd), np.asarray(wi)
    np.testing.assert_allclose(gd.numpy(), wd, rtol=1e-5, atol=1e-4 * 48)
    assert (gi.numpy() == wi).mean() >= 0.99


def test_bf16_storage_both_ways():
    x, q = _int_data(seed=2)
    jidx = j_bf.build(None, x, storage_dtype=jnp.bfloat16)
    tidx = _jax_to_port(jidx)
    assert tidx.dataset.dtype == torch.bfloat16
    wd, wi = j_bf.search(None, jidx, q, 9)
    gd, gi = t_bf.search(RES, tidx, q, 9)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-6)
    # and back: the port's bf16 index loads in the JAX package
    buf = io.BytesIO()
    t_bf.save(t_bf.build(RES, x, storage_dtype=torch.bfloat16), buf)
    buf.seek(0)
    back = j_bf.load(None, buf)
    assert back.dataset.dtype == jnp.bfloat16
    bd, bi = j_bf.search(None, back, q, 9)
    assert np.array_equal(np.asarray(bi), np.asarray(wi))


def test_port_saved_index_loads_in_jax():
    x, q = _int_data(seed=3)
    tidx = t_bf.build(RES, x, DistanceType.InnerProduct)
    buf = io.BytesIO()
    t_bf.save(tidx, buf)
    buf.seek(0)
    jidx = j_bf.load(None, buf)
    assert jidx.metric == JD.InnerProduct
    wd, wi = j_bf.search(None, jidx, q, 5)
    gd, gi = t_bf.search(RES, tidx, q, 5)
    assert np.array_equal(gi.numpy(), np.asarray(wi))


def test_from_numpy_knn_and_merge_parts():
    x, q = _int_data(seed=4)
    jidx = j_bf.build(None, x)
    tidx = t_bf.from_numpy(np.asarray(jidx.dataset), np.asarray(jidx.norms),
                           res=RES)
    a = t_bf.search(RES, tidx, q, 7)
    b = t_bf.knn(RES, x, q, 7)
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])
    rng = np.random.default_rng(5)
    parts_d = np.sort(rng.integers(0, 6, (3, 4, 5)).astype(np.float32), 2)
    parts_i = rng.integers(0, 99, (3, 4, 5)).astype(np.int32)
    wd, wi = j_bf.knn_merge_parts(parts_d, parts_i)
    gd, gi = t_bf.knn_merge_parts(parts_d, parts_i)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    assert np.array_equal(gd.numpy(), np.asarray(wd))
