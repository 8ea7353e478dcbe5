"""The port's dense matrix ops (``raft_tpu_torch.matrix.ops``, exported
from ``raft_tpu_torch.matrix``) against the JAX package's on the CPU:
``TestMatrixOps`` and ``TestMatrixMath`` mirror ``tests/test_matrix.py``
and feed the same numpy inputs to both packages. Ids and orders are
equal exactly; float32 results agree to rtol 1e-5 / atol 1e-5."""

from __future__ import annotations

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import matrix as jm
from raft_tpu_torch import matrix as tm

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want):
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


class TestMatrixOps:
    def test_gather_scatter(self, rng):
        m = rng.standard_normal((10, 4)).astype(np.float32)
        idx = np.array([3, 1, 7])
        _eq(tm.gather(_t(m), idx), jm.gather(m, idx))
        g = m[idx]
        _eq(tm.scatter(_t(np.zeros_like(m)), idx, g),
            jm.scatter(np.zeros_like(m), idx, g))

    def test_gather_if(self, rng):
        m = rng.standard_normal((6, 3)).astype(np.float32)
        idx = np.array([0, 2, 4])
        stencil = np.array([1, 0, 1])
        _eq(tm.gather_if(_t(m), idx, stencil, lambda s: s > 0),
            jm.gather_if(m, idx, stencil, lambda s: s > 0))

    def test_argmax_argmin(self, rng):
        m = rng.integers(0, 3, (5, 9)).astype(np.float32)   # ties: first
        for axis in (0, 1):
            _eq(tm.argmax(_t(m), axis), jm.argmax(m, axis))
            _eq(tm.argmin(_t(m), axis), jm.argmin(m, axis))
        assert tm.argmax(_t(m)).dtype == torch.int32

    def test_col_sort(self, rng):
        m = rng.integers(0, 4, (4, 7)).astype(np.float32)   # ties: stable
        payload = rng.standard_normal((4, 7)).astype(np.float32)
        keys, order = tm.col_sort(_t(m))
        jkeys, jorder = jm.col_sort(m)
        _eq(keys, jkeys)
        _eq(order, jorder)
        keys, vals = tm.col_sort(_t(m), _t(payload))
        _eq(vals, jm.col_sort(m, payload)[1])

    def test_slice_reverse_tri(self, rng):
        m = rng.standard_normal((6, 6)).astype(np.float32)
        _eq(tm.slice(_t(m), (1, 4), (2, 5)), jm.slice(m, (1, 4), (2, 5)))
        for axis in (0, 1):
            _eq(tm.reverse(_t(m), axis), jm.reverse(m, axis))
        _eq(tm.triangular_upper(_t(m)), jm.triangular_upper(m))
        _eq(tm.triangular_lower(_t(m)), jm.triangular_lower(m))

    def test_linewise(self, rng):
        m = rng.standard_normal((3, 5)).astype(np.float32)
        v = rng.standard_normal(5).astype(np.float32)
        w = rng.standard_normal(3).astype(np.float32)
        _close(tm.linewise_op(_t(m), v, True, torch.add),
               jm.linewise_op(m, v, True, jnp.add))
        _close(tm.linewise_op(_t(m), w, False, torch.mul),
               jm.linewise_op(m, w, False, jnp.multiply))

    def test_print(self, rng):
        m = rng.standard_normal((3, 5)).astype(np.float32)
        outs = []
        for fn, arg in ((tm.matrix_print, _t(m)), (jm.matrix_print, m)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                fn(arg, "m", max_rows=2, max_cols=3)
            outs.append(buf.getvalue())
        assert outs[0] == outs[1]


class TestMatrixMath:
    """The small ``raft/matrix/*.cuh`` math headers: copy/diagonal/init/
    power/sqrt/reciprocal/ratio/sign_flip/threshold/norm."""

    def test_copy_fill_eye_diag(self, rng):
        m = rng.standard_normal((4, 6)).astype(np.float32)
        src = _t(m)
        cp = tm.copy(src)
        _eq(cp, jm.copy(m))
        assert cp.data_ptr() != src.data_ptr()
        _eq(tm.fill(src, 3.0), jm.fill(m, 3.0))
        _eq(tm.eye(3, device="cpu"), jm.eye(3))
        _eq(tm.diagonal(src), jm.diagonal(m))
        d = rng.standard_normal(4).astype(np.float32)
        _eq(tm.set_diagonal(src, d), jm.set_diagonal(m, d))
        _eq(src, m)   # inputs are never written

    def test_elementwise_math(self, rng):
        m = np.abs(rng.standard_normal((3, 4))).astype(np.float32) + 0.1
        _close(tm.power(_t(m), 2.0), jm.power(m, 2.0))
        _close(tm.sqrt(_t(m)), jm.sqrt(m))
        _close(tm.ratio(_t(m)), jm.ratio(m))
        np.testing.assert_allclose(float(tm.l2_norm(_t(m))),
                                   float(jm.l2_norm(m)), **TOL)

    def test_reciprocal_guard_threshold_signflip(self, rng):
        x = np.array([[0.0, 2.0, -4.0]], np.float32)
        _close(tm.reciprocal(_t(x), 1.0, 1e-6), jm.reciprocal(x, 1.0, 1e-6))
        _eq(tm.threshold(_t(x), 1.0), jm.threshold(x, 1.0))
        y = np.array([[0.5, -0.5, 3.0]], np.float32)
        _eq(tm.zero_small_values(_t(y), 0.5), jm.zero_small_values(y, 0.5))
        m = rng.standard_normal((5, 4)).astype(np.float32)
        _eq(tm.sign_flip(_t(m)), jm.sign_flip(m))
