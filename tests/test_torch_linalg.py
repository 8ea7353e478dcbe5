"""The port's linalg (``raft_tpu_torch.linalg``) against the JAX
package's on the CPU: each JAX test class of ``tests/test_linalg.py`` has
a counterpart here that feeds the same numpy inputs (from a seed) to both
packages. Float32 results agree to rtol 1e-5 / atol 1e-5; eigen- and
singular vectors are compared up to each column's sign (the two LAPACKs
may flip it); rsvd's sketches come from different generators, so its
result is held to the same low-rank matrix as the JAX one."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import linalg as jl
from raft_tpu_torch import Resources
from raft_tpu_torch import linalg as tl
from raft_tpu_torch.core.validation import RaftError

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

CPU = Resources(device="cpu")
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, **kw):
    np.testing.assert_allclose(_np(got), _np(want), **(kw or TOL))


def _same_up_to_sign(got, want, **kw):
    got, want = _np(got), _np(want)
    sign = np.sign(np.sum(got * want, axis=0))
    np.testing.assert_allclose(got * sign[None, :], want, **(kw or TOL))


@pytest.fixture
def rng():
    return np.random.default_rng(42)


class TestBlas:
    def test_gemm(self, rng):
        a = rng.standard_normal((17, 9)).astype(np.float32)
        b = rng.standard_normal((9, 23)).astype(np.float32)
        _close(tl.gemm(CPU, a, b), jl.gemm(None, a, b))

    def test_gemm_trans_alpha_beta(self, rng):
        a = rng.standard_normal((9, 17)).astype(np.float32)
        b = rng.standard_normal((23, 9)).astype(np.float32)
        c = rng.standard_normal((17, 23)).astype(np.float32)
        kw = dict(alpha=2.0, beta=0.5, c=c, trans_a=True, trans_b=True)
        _close(tl.gemm(CPU, a, b, **kw), jl.gemm(None, a, b, **kw))
        with pytest.raises(RaftError):
            tl.gemm(CPU, a, b, beta=1.0, trans_a=True, trans_b=True)

    def test_gemv_axpy_dot(self, rng):
        a = rng.standard_normal((11, 7)).astype(np.float32)
        x = rng.standard_normal(7).astype(np.float32)
        y = rng.standard_normal(11).astype(np.float32)
        _close(tl.gemv(CPU, a, x), jl.gemv(None, a, x))
        _close(tl.gemv(CPU, a, y, trans=True, alpha=0.5, beta=2.0, y=x),
               jl.gemv(None, a, y, trans=True, alpha=0.5, beta=2.0, y=x))
        _close(tl.axpy(CPU, 2.0, y, y), jl.axpy(None, 2.0, y, y))
        _close(tl.dot(CPU, x, x), jl.dot(None, x, x))

    def test_bfloat16_precision_rounds_operands(self, rng):
        a = rng.standard_normal((8, 5)).astype(np.float32)
        b = rng.standard_normal((5, 6)).astype(np.float32)
        res = Resources(device="cpu", matmul_precision="bfloat16")
        ab = torch.from_numpy(a).bfloat16().float()
        bb = torch.from_numpy(b).bfloat16().float()
        _close(tl.gemm(res, a, b), ab @ bb)


class TestElementwise:
    def test_ops(self, rng):
        x = rng.standard_normal((5, 6)).astype(np.float32)
        y = rng.standard_normal((5, 6)).astype(np.float32)
        z = np.abs(y) + 1
        for name in ("add", "subtract", "multiply", "divide", "power"):
            yy = z if name in ("divide", "power") else y
            xx = np.abs(x) if name == "power" else x
            _close(getattr(tl, name)(CPU, xx, yy),
                   getattr(jl, name)(None, xx, yy))
        _close(tl.sqrt(CPU, np.abs(x)), jl.sqrt(None, np.abs(x)))
        _close(tl.unary_op(CPU, x, lambda v: v * 3),
               jl.unary_op(None, x, lambda v: v * 3))
        _close(tl.binary_op(CPU, x, y, torch.maximum),
               jl.binary_op(None, x, y, jnp.maximum))
        _close(tl.ternary_op(CPU, x, y, z, lambda a, b, c: a * b + c),
               jl.ternary_op(None, x, y, z, lambda a, b, c: a * b + c))
        _close(tl.scalar_add(CPU, x, 2.5), jl.scalar_add(None, x, 2.5))
        _close(tl.scalar_multiply(CPU, x, -3.0),
               jl.scalar_multiply(None, x, -3.0))
        _close(tl.transpose(CPU, x), jl.transpose(None, x))
        _close(tl.map(CPU, lambda a, b: a - 2 * b, x, y),
               jl.map(None, lambda a, b: a - 2 * b, x, y))

    def test_map_offset(self):
        out = tl.map_offset(CPU, (3, 4), lambda i: i * 2, dtype=torch.int32)
        want = jl.map_offset(None, (3, 4), lambda i: i * 2, dtype=jnp.int32)
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))


class TestMatrixVector:
    def test_along_rows(self, rng):
        m = rng.standard_normal((6, 4)).astype(np.float32)
        v = rng.standard_normal(4).astype(np.float32)
        _close(tl.matrix_vector_op(CPU, m, v, torch.add, along_rows=True),
               jl.matrix_vector_op(None, m, v, jnp.add, along_rows=True))

    def test_along_cols(self, rng):
        m = rng.standard_normal((6, 4)).astype(np.float32)
        v = rng.standard_normal(6).astype(np.float32)
        _close(tl.matrix_vector_op(CPU, m, v, torch.mul, along_rows=False),
               jl.matrix_vector_op(None, m, v, jnp.multiply,
                                   along_rows=False))
        with pytest.raises(RaftError):
            tl.matrix_vector_op(CPU, m, v, torch.mul, along_rows=True)


class TestReduce:
    def test_reduce_rows_cols(self, rng):
        m = rng.standard_normal((8, 5)).astype(np.float32)
        _close(tl.coalesced_reduction(CPU, m),
               jl.coalesced_reduction(None, m))
        _close(tl.strided_reduction(CPU, m), jl.strided_reduction(None, m))
        kw_t = dict(main_op=torch.abs, reduce_op=torch.amax,
                    final_op=torch.sqrt)
        kw_j = dict(main_op=jnp.abs, reduce_op=jnp.max, final_op=jnp.sqrt)
        _close(tl.reduce(CPU, m, along_rows=False, **kw_t),
               jl.reduce(None, m, along_rows=False, **kw_j))
        # a reduce_op returning (values, indices) gives its values
        _close(tl.reduce(CPU, m, reduce_op=torch.max),
               jl.reduce(None, m, reduce_op=jnp.max))
        _close(tl.map_reduce(CPU, m, lambda v: v * v),
               jl.map_reduce(None, m, lambda v: v * v))

    def test_norms(self, rng):
        m = rng.standard_normal((8, 5)).astype(np.float32)
        for nt in (tl.L1Norm, tl.L2Norm, tl.LinfNorm):
            for rows in (True, False):
                _close(tl.norm(CPU, m, nt, along_rows=rows),
                       jl.norm(None, m, nt, along_rows=rows))
        _close(tl.norm(CPU, m, tl.L2Norm, sqrt=True),
               jl.norm(None, m, jl.L2Norm, sqrt=True))
        with pytest.raises(ValueError):
            tl.norm(CPU, m, "l3")

    def test_normalize(self, rng):
        m = rng.standard_normal((8, 5)).astype(np.float32)
        m[3] = 0.0
        for nt in (tl.L1Norm, tl.L2Norm, tl.LinfNorm):
            _close(tl.normalize(CPU, m, nt), jl.normalize(None, m, nt))

    def test_mse(self, rng):
        a = rng.standard_normal((8, 5)).astype(np.float32)
        b = rng.standard_normal((8, 5)).astype(np.float32)
        _close(tl.mean_squared_error(CPU, a, b, weight=2.0),
               jl.mean_squared_error(None, a, b, weight=2.0))

    def test_reduce_rows_by_key(self, rng):
        m = rng.standard_normal((20, 4)).astype(np.float32)
        keys = rng.integers(0, 3, 20).astype(np.int32)
        w = rng.random(20).astype(np.float32)
        _close(tl.reduce_rows_by_key(CPU, m, keys, 3),
               jl.reduce_rows_by_key(None, m, jnp.asarray(keys), 3))
        _close(tl.reduce_rows_by_key(CPU, m, keys, 3, weights=w),
               jl.reduce_rows_by_key(None, m, jnp.asarray(keys), 3,
                                     weights=jnp.asarray(w)))
        # a key past n_keys adds to no group, as a one-hot row of zeros
        keys[0] = 7
        _close(tl.reduce_rows_by_key(CPU, m, keys, 3),
               jl.reduce_rows_by_key(None, m, jnp.asarray(keys), 3))

    def test_reduce_cols_by_key(self, rng):
        m = rng.standard_normal((4, 20)).astype(np.float32)
        keys = rng.integers(0, 5, 20).astype(np.int32)
        _close(tl.reduce_cols_by_key(CPU, m, keys, 5),
               jl.reduce_cols_by_key(None, m, jnp.asarray(keys), 5))


class TestSolvers:
    def test_eig(self, rng):
        a = rng.standard_normal((12, 12)).astype(np.float32)
        a = a @ a.T + 12 * np.eye(12, dtype=np.float32)
        v, w = tl.eig_dc(CPU, a)
        jv, jw = jl.eig_dc(None, a)
        _close(w, jw)
        _same_up_to_sign(v, jv, rtol=1e-5, atol=1e-4)
        v2, w2 = tl.eig_jacobi(CPU, a)
        assert torch.equal(v2, v) and torch.equal(w2, w)

    def test_svd(self, rng):
        a = rng.standard_normal((15, 8)).astype(np.float32)
        u, s, v = tl.svd(CPU, a)
        ju, js, jv = jl.svd(None, a)
        _close(s, js)
        _same_up_to_sign(u, ju, rtol=1e-5, atol=1e-4)
        _same_up_to_sign(v, jv, rtol=1e-5, atol=1e-4)

    def test_qr(self, rng):
        a = rng.standard_normal((10, 6)).astype(np.float32)
        q, r = tl.qr(CPU, a)
        jq, jr = jl.qr(None, a)
        _same_up_to_sign(q, jq)
        _same_up_to_sign(r.T, np.asarray(jr).T)

    def test_rsvd_low_rank_recovery(self, rng):
        u0 = rng.standard_normal((40, 5)).astype(np.float32)
        v0 = rng.standard_normal((5, 30)).astype(np.float32)
        a = u0 @ v0
        u, s, v = tl.rsvd(CPU, a, 5, n_iters=3, key=7)
        ju, js, jv = jl.rsvd(None, a, 5, n_iters=3)
        approx = u.numpy() @ np.diag(s.numpy()) @ v.numpy().T
        japprox = np.asarray(ju) @ np.diag(np.asarray(js)) @ np.asarray(jv).T
        np.testing.assert_allclose(approx, japprox, rtol=1e-3, atol=1e-3)
        _close(s, js, rtol=1e-4, atol=1e-4)
        # the same generator seed draws the same sketch
        u2, s2, v2 = tl.rsvd(CPU, a, 5, n_iters=3, key=7)
        assert torch.equal(u2, u) and torch.equal(s2, s)

    def test_lstsq(self, rng):
        a = rng.standard_normal((30, 6)).astype(np.float32)
        b = a @ rng.standard_normal(6).astype(np.float32)
        _close(tl.lstsq(CPU, a, b), jl.lstsq(None, a, b))
        # rank-deficient: the minimum-norm solution, as jnp.linalg.lstsq
        a[:, 5] = a[:, 4]
        b2 = rng.standard_normal((30, 2)).astype(np.float32)
        _close(tl.lstsq(CPU, a, b2), jl.lstsq(None, a, b2), rtol=1e-4,
               atol=1e-4)

    def test_cholesky_rank_one_update(self, rng):
        n = 7
        a = rng.standard_normal((n, n)).astype(np.float32)
        a = a @ a.T + n * np.eye(n, dtype=np.float32)
        x = rng.standard_normal(n).astype(np.float32)
        l0 = np.linalg.cholesky(a)
        _close(tl.cholesky_rank_one_update(CPU, l0, x),
               jl.cholesky_rank_one_update(None, l0, x))
        _close(tl.cholesky_rank_one_update(CPU, l0.T, x, lower=False),
               jl.cholesky_rank_one_update(None, l0.T, x, lower=False))

    def test_lanczos_alias(self):
        from raft_tpu_torch.sparse.solver import lanczos_smallest

        assert tl.lanczos_smallest is lanczos_smallest
        assert set(tl.__all__) == set(jl.__all__)


class TestReduceInitSemantics:
    def test_init_seeds_accumulator(self):
        """init is the accumulator seed (reference linalg::reduce), not an
        additive bias: max-reduce of negatives with init=0 returns 0."""
        m = np.array([[-5.0, -2.0], [1.0, 3.0]], np.float32)
        out = tl.reduce(CPU, m, reduce_op=torch.amax, init=0.0)
        want = jl.reduce(None, jnp.asarray(m), reduce_op=jnp.max, init=0.0)
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
        assert float(out[0]) == 0.0
        out = tl.reduce(CPU, m, along_rows=False, reduce_op=torch.amin,
                        init=-1.0)
        want = jl.reduce(None, jnp.asarray(m), along_rows=False,
                         reduce_op=jnp.min, init=-1.0)
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
