"""The port's sparse package (``raft_tpu_torch.sparse``) against the JAX
package's on the CPU: each JAX test class of ``tests/test_sparse.py`` has
a counterpart here. Both packages get the same matrices (the JAX
containers' arrays carried across by ``from_numpy``). Conversions,
structure ops, ``indptr``/``indices``, ids and the MST (on graphs with
tied weights) are equal exactly; float32 values agree to rtol 1e-5 /
atol 1e-5. Lanczos is compared on matrices of n <= max(4k + 8, 32),
where the Krylov space is the whole space and the result does not depend
on the start vector (eigenvectors up to sign)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from raft_tpu.distance.types import DistanceType as JD
from raft_tpu.sparse import COO as JCOO
from raft_tpu.sparse import CSR as JCSR
from raft_tpu.sparse import convert as jconv
from raft_tpu.sparse import distance as jdist
from raft_tpu.sparse import linalg as jlin
from raft_tpu.sparse import neighbors as jnb
from raft_tpu.sparse import ops as jops
from raft_tpu.sparse import solver as jsol
from raft_tpu_torch import Resources
from raft_tpu_torch.core.validation import RaftError
from raft_tpu_torch.distance.types import DistanceType as TD
from raft_tpu_torch.sparse import COO, CSR, convert, linalg, neighbors, ops
from raft_tpu_torch.sparse import distance as tdist
from raft_tpu_torch.sparse import solver
from raft_tpu_torch.sparse.types import _lexsort, _segment_max, _segment_min

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

CPU = Resources(device="cpu")
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(j):
    """The port's container of a JAX container's arrays."""
    if isinstance(j, JCSR):
        return CSR.from_numpy(np.asarray(j.indptr), np.asarray(j.indices),
                              np.asarray(j.data), j.shape, device="cpu")
    return COO.from_numpy(np.asarray(j.rows), np.asarray(j.cols),
                          np.asarray(j.vals), j.shape, device="cpu")


def _j(fn, *args, **kw):
    """The JAX reference call, jitted whole (one compile, where the eager
    ops compile one by one), Python arguments fixed."""
    return jax.jit(lambda *arrays: fn(*arrays, *args, **kw))


def _eq(got, want):
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _close(got, want, **kw):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(kw or TOL))


def _same(got, want, exact_vals=False):
    """Two containers hold the same arrays (structure exactly)."""
    if isinstance(got, CSR):
        _eq(got.indptr, want.indptr)
        _eq(got.indices, want.indices)
        (_eq if exact_vals else _close)(got.data, want.data)
    else:
        _eq(got.rows, want.rows)
        _eq(got.cols, want.cols)
        (_eq if exact_vals else _close)(got.vals, want.vals)
    assert tuple(got.shape) == tuple(want.shape)


@pytest.fixture
def rand_csr():
    def make(m=32, n=24, density=0.2, seed=0, integer=False):
        rs = np.random.RandomState(seed)
        mat = sp.random(m, n, density=density, format="csr",
                        random_state=rs, dtype=np.float32)
        if integer:
            mat.data = np.ceil(mat.data * 4).astype(np.float32)
        return JCSR.from_scipy(mat), mat
    return make


class TestTypesAndConvert:
    def test_roundtrip_dense(self, rand_csr):
        j, ref = rand_csr()
        csr = _t(j)
        coo, jcoo = convert.csr_to_coo(csr), _j(jconv.csr_to_coo)(j)
        _same(coo, jcoo, exact_vals=True)
        _same(convert.coo_to_csr(coo), _j(jconv.coo_to_csr)(jcoo), True)
        _eq(convert.csr_to_dense(csr), _j(jconv.csr_to_dense)(j))
        _eq(convert.coo_to_dense(coo), _j(jconv.coo_to_dense)(jcoo))
        _eq(csr.to_dense(), coo.to_dense())
        from_sp = CSR.from_scipy(ref, device="cpu")
        _same(from_sp, j, exact_vals=True)
        back = CSR.from_numpy(**from_sp.to_numpy(), device="cpu")
        _same(back, j, exact_vals=True)
        jcoo2 = JCOO.from_scipy(ref)
        _same(COO.from_scipy(ref, device="cpu"), jcoo2, exact_vals=True)

    def test_coo_padding(self):
        dense = np.array([[1, 0], [0, 2]], np.float32)
        coo, jcoo = COO.from_dense(dense, nnz=6, device="cpu"), \
            JCOO.from_dense(dense, nnz=6)
        assert coo.nnz == 6
        _same(coo, jcoo, exact_vals=True)
        _eq(coo.to_dense(), _j(jconv.coo_to_dense)(jcoo))
        _same(convert.coo_to_csr(coo), _j(jconv.coo_to_csr)(jcoo), True)
        _same(convert.dense_to_coo(dense, device="cpu"),
              jconv.dense_to_coo(dense), True)
        with pytest.raises(ValueError):
            COO.from_dense(dense, nnz=1, device="cpu")
        # COO's arrays cross as they are, padding included
        _same(COO.from_numpy(**coo.to_numpy(), device="cpu"), jcoo, True)

    def test_from_dense_csr(self):
        dense = np.array([[0, 3, 0], [4, 0, 5], [0, 0, 0]], np.float32)
        csr = CSR.from_dense(dense, device="cpu")
        _same(csr, JCSR.from_dense(dense), exact_vals=True)
        _same(convert.dense_to_csr(dense, device="cpu"),
              jconv.dense_to_csr(dense), True)
        # padding past indptr[-1]: row id -1 and no contribution
        padded = CSR(csr.indptr, torch.cat([csr.indices,
                                            torch.zeros(3, dtype=torch.int32)]),
                     torch.cat([csr.data, torch.zeros(3)]), csr.shape)
        jpadded = JCSR(jnp.asarray(csr.indptr.numpy()),
                       jnp.asarray(padded.indices.numpy()),
                       jnp.asarray(padded.data.numpy()), csr.shape)
        _eq(padded.row_ids(), _j(JCSR.row_ids)(jpadded))
        _eq(padded.to_dense(), dense)

    def test_idioms(self):
        rng = np.random.default_rng(0)
        keys = [rng.integers(0, 3, 40) for _ in range(3)]
        _eq(_lexsort([torch.from_numpy(k) for k in keys]),
            jnp.lexsort([jnp.asarray(k) for k in keys]))
        import jax

        v = rng.standard_normal(10).astype(np.float32)
        ids = rng.integers(0, 6, 10)
        for fn, jfn in ((_segment_min, jax.ops.segment_min),
                        (_segment_max, jax.ops.segment_max)):
            # empty segments hold the op's identity (+-inf / int32 max,min)
            _eq(fn(torch.from_numpy(v), torch.from_numpy(ids), 8),
                jfn(jnp.asarray(v), jnp.asarray(ids), num_segments=8))
            iv = v.astype(np.int32)
            _eq(fn(torch.from_numpy(iv), torch.from_numpy(ids), 8),
                jfn(jnp.asarray(iv), jnp.asarray(ids), num_segments=8))


class TestOps:
    def test_sort_and_dedup(self):
        rows = np.array([2, 0, 2, 0, -1, 1], np.int32)
        cols = np.array([1, 1, 1, 1, 0, 0], np.int32)
        vals = np.array([5.0, 1.0, 7.0, 2.0, 9.0, -3.0], np.float32)
        coo = COO.from_numpy(rows, cols, vals, (3, 2), device="cpu")
        jcoo = JCOO(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals),
                    (3, 2))
        _same(ops.coo_sort(coo), _j(jops.coo_sort)(jcoo), True)
        _same(ops.sum_duplicates(coo), _j(jops.sum_duplicates)(jcoo), True)
        _same(ops.max_duplicates(coo), _j(jops.max_duplicates)(jcoo), True)
        _same(ops.remove_scalar(coo, 7.0), _j(jops.remove_scalar, 7.0)(jcoo),
              True)

    def test_remove_scalar_degree(self, rand_csr):
        j, _ = rand_csr()
        coo, jcoo = convert.csr_to_coo(_t(j)), _j(jconv.csr_to_coo)(j)
        got = ops.degree(coo)
        assert got.dtype == torch.int32
        _eq(got, _j(jops.degree)(jcoo))
        _same(ops.remove_zeros(coo), _j(jops.remove_zeros)(jcoo), True)

    def test_row_slice(self, rand_csr):
        j, _ = rand_csr()
        for a, b in ((8, 20), (0, 32), (5, 5)):
            _same(ops.row_slice(_t(j), a, b), _j(jops.row_slice, a, b)(j),
                  True)

    def test_csr_row_op(self, rand_csr):
        j, _ = rand_csr()
        _same(ops.csr_row_op(_t(j), lambda r, v: v * (r.to(v.dtype) + 1)),
              _j(jops.csr_row_op, lambda r, v: v * (r + 1))(j))


class TestLinalg:
    def test_spmm(self, rand_csr):
        j, _ = rand_csr()
        b = np.random.default_rng(1).standard_normal((24, 7)).astype(
            np.float32)
        _close(linalg.spmm(_t(j), b), _j(jlin.spmm)(j, b))
        _close(linalg.spmm(_t(j), b, transpose_output=True),
               _j(jlin.spmm, transpose_output=True)(j, b))
        _close(linalg.spmv(_t(j), b[:, 0]), _j(jlin.spmv)(j, b[:, 0]))

    def test_row_norms_and_normalize(self, rand_csr):
        j, _ = rand_csr(m=40, density=0.1)   # some empty rows
        for nt in ("l1", "l2", "linf"):
            _close(linalg.row_norm_csr(_t(j), nt),
                   _j(jlin.row_norm_csr, nt)(j))
            _same(linalg.csr_row_normalize(_t(j), nt),
                  _j(jlin.csr_row_normalize, nt)(j))
        with pytest.raises(ValueError):
            linalg.row_norm_csr(_t(j), "l3")

    def test_transpose_add(self, rand_csr):
        a, _ = rand_csr(seed=1)
        b, _ = rand_csr(seed=2)
        _same(linalg.transpose(_t(a)), _j(jlin.transpose)(a), True)
        _same(linalg.add(_t(a), _t(b)), _j(jlin.add)(a, b))

    def test_symmetrize(self, rand_csr):
        j, _ = rand_csr(m=24, seed=3, integer=True)
        coo, jcoo = convert.csr_to_coo(_t(j)), _j(jconv.csr_to_coo)(j)
        _same(linalg.coo_symmetrize(coo), _j(jlin.coo_symmetrize)(jcoo),
              True)
        _same(linalg.coo_symmetrize(coo, lambda v: v * 0.5),
              _j(jlin.coo_symmetrize, lambda v: v * 0.5)(jcoo), True)

    @pytest.mark.parametrize("normalized", [False, True])
    def test_laplacian(self, rand_csr, normalized):
        j, ref = rand_csr(m=24, seed=4)
        sym = JCSR.from_scipy(ref[:, :24] + ref[:, :24].T)
        _same(linalg.laplacian(_t(sym), normalized),
              _j(jlin.laplacian, normalized)(sym))


class TestDistanceAndNeighbors:
    @pytest.mark.parametrize("metric", ["L2Expanded", "L1"])
    def test_pairwise(self, rand_csr, metric):
        a, _ = rand_csr(m=20, seed=3)
        b, _ = rand_csr(m=16, seed=4)
        _close(tdist.pairwise_distance(CPU, _t(a), _t(b), TD[metric],
                                       tile=10),
               jdist.pairwise_distance(None, a, b, JD[metric], tile=10))

    @pytest.mark.parametrize("metric", ["L2SqrtExpanded", "InnerProduct"])
    def test_pairwise_column_tiled(self, rand_csr, metric):
        a, _ = rand_csr(m=20, seed=7)
        b, _ = rand_csr(m=16, seed=8)
        _close(tdist.pairwise_distance(CPU, _t(a), _t(b), TD[metric],
                                       tile=8, col_tile=5),
               jdist.pairwise_distance(None, a, b, JD[metric], tile=8,
                                       col_tile=5))

    def test_pairwise_column_tiled_rejects_unexpanded(self, rand_csr):
        a, _ = rand_csr(m=8, seed=9)
        with pytest.raises(RaftError, match="expanded metric"):
            tdist.pairwise_distance(CPU, _t(a), _t(a), TD.L1, col_tile=4)

    def test_pairwise_wide_budget_guard(self, rand_csr, monkeypatch):
        a, _ = rand_csr(m=12, seed=10)
        monkeypatch.setenv("RAFT_TPU_SPARSE_TILE_MB", "0")
        _close(tdist.pairwise_distance(CPU, _t(a), _t(a), TD.L2Expanded),
               jdist.pairwise_distance(None, a, a, JD.L2Expanded))
        with pytest.raises(RaftError, match="budget"):
            tdist.pairwise_distance(CPU, _t(a), _t(a), TD.L1)

    @pytest.mark.parametrize("metric", ["L2Expanded", "InnerProduct"])
    def test_sparse_knn(self, rand_csr, metric):
        # integer values: every distance exact, ties by the smaller id
        db, _ = rand_csr(m=64, seed=5, integer=True)
        q, _ = rand_csr(m=10, seed=6, integer=True)
        d, i = neighbors.brute_force_knn(CPU, _t(db), _t(q), 5, TD[metric],
                                         tile=16)
        jd, ji = jnb.brute_force_knn(None, db, q, 5, JD[metric], tile=16)
        _eq(i, ji)
        _eq(d, jd)

    def test_knn_graph(self):
        rng = np.random.default_rng(0)
        x = rng.integers(-3, 4, (50, 8)).astype(np.float32)
        g = neighbors.knn_graph(CPU, x, 4)
        _same(g, jnb.knn_graph(None, x, 4), True)

    def test_cross_component_nn(self):
        rng = np.random.default_rng(1)
        a = rng.integers(-3, 4, (20, 4)).astype(np.float32)
        b = rng.integers(-3, 4, (20, 4)).astype(np.float32) + 50
        c = rng.integers(-3, 4, (10, 4)).astype(np.float32) - 40
        x = np.vstack([a, b, c])
        labels = np.array([0] * 20 + [3] * 20 + [1] * 10, np.int32)
        got = neighbors.cross_component_nn(CPU, x, labels, tile=25)
        _same(got, jnb.cross_component_nn(None, x, jnp.asarray(labels),
                                          tile=25), True)


class TestSolvers:
    def test_mst_path_graph(self):
        dense = np.zeros((4, 4), np.float32)
        for i, w in [(0, 1.0), (1, 2.0), (2, 3.0)]:
            dense[i, i + 1] = dense[i + 1, i] = w
        dense[0, 3] = dense[3, 0] = 10.0
        r = solver.mst(CPU, CSR.from_dense(dense, device="cpu"))
        j = jsol.mst(None, JCSR.from_dense(dense))
        assert r.n_edges == j.n_edges == 3
        assert r.total_weight == j.total_weight == 6.0

    @pytest.mark.parametrize("seed", [0])
    def test_mst_vs_scipy(self, seed):
        """Tied integer weights and a forest of two components: src, dst,
        weights and colors equal the JAX package's."""
        rng = np.random.default_rng(seed)
        n = 40
        w = rng.integers(1, 4, (n, n)).astype(np.float32)
        w *= rng.random((n, n)) < 0.15
        w[:20, 20:] = 0
        w = np.triu(w, 1)
        w = w + w.T
        r = solver.mst(CPU, CSR.from_dense(w, device="cpu"))
        j = jsol.mst(None, JCSR.from_dense(w))
        for name in ("src", "dst", "weights", "color"):
            _eq(getattr(r, name), getattr(j, name))
        assert r.n_edges == j.n_edges
        from scipy.sparse.csgraph import minimum_spanning_tree
        assert r.total_weight == minimum_spanning_tree(w).sum()

    @pytest.mark.parametrize("n,k", [(30, 3)])
    def test_lanczos_smallest(self, n, k):
        rng = np.random.default_rng(n)
        a = rng.standard_normal((n, n)).astype(np.float32)
        m = a @ a.T / n + np.eye(n, dtype=np.float32)
        m[np.abs(m) < 0.05] = 0
        m = (m + m.T) / 2
        ev, vec = solver.lanczos_smallest(CPU, CSR.from_dense(m,
                                                               device="cpu"),
                                          k, seed=3)
        jev, jvec = _j(jsol.lanczos_smallest, k)(None, JCSR.from_dense(m))
        _close(ev, jev)
        jvec = np.asarray(jvec)
        sign = np.sign(np.sum(vec.numpy() * jvec, axis=0))
        np.testing.assert_allclose(vec.numpy() * sign, jvec, rtol=1e-5,
                                   atol=1e-4)
        # the start vector is drawn on the CPU: any device, same draws
        ev2, vec2 = solver.lanczos_smallest(CPU, CSR.from_dense(
            m, device="cpu"), k, seed=3)
        assert torch.equal(ev2, ev) and torch.equal(vec2, vec)


class TestReviewRegressions:
    def test_lanczos_breakdown_restart(self):
        eye = np.eye(40, dtype=np.float32)
        ev, v = solver.lanczos_smallest(CPU, CSR.from_dense(eye,
                                                             device="cpu"), 3)
        jev, _ = _j(jsol.lanczos_smallest, 3)(None, JCSR.from_dense(eye))
        _close(ev, jev)
        np.testing.assert_allclose(np.linalg.norm(v.numpy(), axis=0), 1.0,
                                   atol=1e-5)

    def test_knn_graph_duplicate_rows_degree_cap(self):
        x = np.zeros((10, 4), np.float32)
        g = neighbors.knn_graph(CPU, x, 3)
        _same(g, jnb.knn_graph(None, x, 3), True)
        r = g.rows.numpy()
        np.testing.assert_array_equal(np.bincount(r[r >= 0], minlength=10),
                                      3)

    def test_sparse_pairwise_distance_tiles_both_operands(self, rand_csr):
        # the port's tiles of 3 and 7 rows against the JAX package's of 10
        a, _ = rand_csr(m=20, seed=3)
        b, _ = rand_csr(m=16, seed=4)
        jd = jdist.pairwise_distance(None, a, b, JD.L2Expanded, tile=10)
        for tile in (3, 7):
            _close(tdist.pairwise_distance(CPU, _t(a), _t(b), tile=tile), jd)


class TestSpgemm:
    def test_matches_dense_product(self):
        rng = np.random.default_rng(42)
        a = rng.standard_normal((12, 8)) * (rng.random((12, 8)) < 0.3)
        b = rng.standard_normal((8, 10)) * (rng.random((8, 10)) < 0.3)
        a, b = a.astype(np.float32), b.astype(np.float32)
        got = linalg.spgemm(CSR.from_dense(a, device="cpu"),
                            CSR.from_dense(b, device="cpu"))
        # JAX's spgemm: spmm against the densified right operand, then
        # re-sparsified on the host (its two device steps jitted here)
        want = JCSR.from_dense(np.asarray(_j(jlin.spmm)(
            JCSR.from_dense(a), _j(jconv.csr_to_dense)(JCSR.from_dense(b)))))
        _eq(got.indptr, want.indptr)
        _eq(got.indices, want.indices)
        _close(got.data, want.data)
