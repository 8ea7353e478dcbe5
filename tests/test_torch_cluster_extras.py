"""The port's single-linkage, spectral partitioning and linear assignment
against the JAX package's on the CPU (``TestSingleLinkage``,
``TestSpectral`` and ``TestLAP`` mirror ``tests/test_cluster_extras.py``).

- ``single_linkage`` on integer-valued data with ``L2Expanded`` (every
  distance exact) gives the JAX package's ``labels``, ``children``,
  ``sizes`` and ``deltas``; the port's O(n α(n)) dendrogram equals a
  literal transcription of the JAX package's loop at n = 2,000.
- ``linear_assignment`` on integer costs gives the JAX package's
  assignment and total exactly.
- Spectral entries on graphs of n <= max(4k + 8, 32), where Lanczos spans
  the whole space: eigenvalues within rtol 1e-5 / atol 1e-5, eigenvectors
  up to sign, partitions equal up to a relabeling (the two k-means draw
  their seeds from different generators).
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize
import sklearn.metrics as skm
import torch
from sklearn.datasets import make_moons

from raft_tpu import spectral as jspec
from raft_tpu.cluster.single_linkage import single_linkage as j_single_linkage
from raft_tpu.distance.types import DistanceType as JD
from raft_tpu.solver import LinearAssignmentProblem as JLAP
from raft_tpu.solver import linear_assignment as j_lap
from raft_tpu.sparse.types import CSR as JCSR
from raft_tpu_torch import Resources
from raft_tpu_torch import spectral as tspec
from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.validation import RaftError
from raft_tpu_torch.distance.types import DistanceType as TD
from raft_tpu_torch.solver import LinearAssignmentProblem, linear_assignment
from raft_tpu_torch.sparse.types import CSR

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

# the module (the package's ``single_linkage`` names the function)
tsl = importlib.import_module("raft_tpu_torch.cluster.single_linkage")
CPU = Resources(device="cpu")
TOL = dict(rtol=1e-5, atol=1e-5)


def _int_blobs(seed: int, n: int, d: int = 6, k: int = 5):
    rng = np.random.default_rng(seed)
    centers = rng.integers(-30, 30, (k, d))
    lab = rng.integers(0, k, n)
    return (centers[lab] + rng.integers(-2, 3, (n, d))).astype(np.float32)


def _jax_dendrogram(src, dst, n):
    """The JAX package's dendrogram loop, transcribed line for line
    (``raft_tpu/cluster/single_linkage.py``)."""
    parent = np.arange(2 * n - 1)
    cluster_of = np.arange(n)
    size = np.ones(2 * n - 1, dtype=np.int64)

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    children = np.zeros((n - 1, 2), dtype=np.int64)
    sizes = np.zeros(n - 1, dtype=np.int64)
    for step in range(n - 1):
        ra, rb = find(src[step]), find(dst[step])
        ca, cb = cluster_of[ra], cluster_of[rb]
        new_id = n + step
        children[step] = (min(ca, cb), max(ca, cb))
        parent[ra] = parent[rb] = new_id
        cluster_of = np.append(cluster_of, 0)
        size[new_id] = size[ra] + size[rb]
        sizes[step] = size[new_id]
        cluster_of = cluster_of[: 2 * n - 1]
        cluster_of[new_id] = new_id
    return children, sizes


def _same_partition(a, b):
    assert skm.adjusted_rand_score(np.asarray(a), np.asarray(b)) == 1.0


class TestSingleLinkage:
    def test_blobs_recovery(self):
        """Integer blobs that the 15-NN graph splits: a connect round
        runs, and every output equals the JAX package's. (One round: each
        round compiles the JAX package's symmetrize, CSR and MST anew.)"""
        x = _int_blobs(2, 240)
        before = tracing.get_counter("cluster.single_linkage.connect_rounds")
        out = tsl.single_linkage(CPU, x, 5, metric=TD.L2Expanded)
        assert tracing.get_counter(
            "cluster.single_linkage.connect_rounds") > before
        want = j_single_linkage(None, x, 5, metric=JD.L2Expanded)
        for name in ("labels", "children", "sizes", "deltas"):
            np.testing.assert_array_equal(getattr(out, name),
                                          getattr(want, name))
        assert out.n_clusters == 5 and len(np.unique(out.labels)) == 5

    def test_matches_sklearn_moons(self):
        x, _ = make_moons(n_samples=150, noise=0.04, random_state=0)
        x = x.astype(np.float32)
        out = tsl.single_linkage(CPU, x, 2, k=10)
        from sklearn.cluster import AgglomerativeClustering

        sk = AgglomerativeClustering(n_clusters=2, linkage="single").fit(x)
        assert skm.adjusted_rand_score(sk.labels_, out.labels) > 0.95

    @pytest.mark.parametrize("n_clusters", [1, 7])
    def test_dendrogram_shape(self, n_clusters):
        """The union-find dendrogram and flat cut equal the JAX package's
        loop on a random spanning tree of n = 2,000 (its edges in a
        random order, as sorted MST edges arrive)."""
        n = 2000
        rng = np.random.default_rng(n_clusters)
        perm = rng.permutation(n)
        parent_of = rng.integers(0, np.arange(1, n))   # a random tree
        src = perm[1:]
        dst = perm[parent_of]
        order = rng.permutation(n - 1)
        src, dst = src[order], dst[order]
        children, sizes = tsl._dendrogram(src, dst, n)
        want_c, want_s = _jax_dendrogram(src, dst, n)
        np.testing.assert_array_equal(children, want_c)
        np.testing.assert_array_equal(sizes, want_s)
        assert sizes[-1] == n
        labels = tsl._flat_labels(src, dst, n, n_clusters)
        assert labels.max() == n_clusters - 1

    def test_bad_n_clusters(self):
        with pytest.raises(RaftError):
            tsl.single_linkage(CPU, np.zeros((4, 2), np.float32), 5)


def _two_cliques(n_half=10):
    n = 2 * n_half
    a = np.zeros((n, n), np.float32)
    a[:n_half, :n_half] = 1.0
    a[n_half:, n_half:] = 1.0
    np.fill_diagonal(a, 0.0)
    a[0, n_half] = a[n_half, 0] = 1.0
    return a


class TestSpectral:
    def test_partition_two_cliques(self):
        a = _two_cliques()
        labels, evals, emb = tspec.partition(CPU, CSR.from_dense(
            a, device="cpu"), 2, seed=3)
        jlabels, jevals, jemb = jspec.partition(None, JCSR.from_dense(a), 2,
                                                seed=3)
        _same_partition(labels, jlabels)
        _same_partition(labels, [0] * 10 + [1] * 10)
        np.testing.assert_allclose(evals.numpy(), np.asarray(jevals), **TOL)
        assert emb.shape == (20, 2)

    def test_analyze_partition(self):
        a = _two_cliques()
        for labels in ([0] * 10 + [1] * 10, [0] * 7 + [1] * 8 + [2] * 5):
            labels = np.asarray(labels, np.int32)
            got = tspec.analyze_partition(CPU, CSR.from_dense(a, device="cpu"),
                                          labels)
            want = jspec.analyze_partition(None, JCSR.from_dense(a),
                                           jnp.asarray(labels))
            for g, w in zip(got, want):
                np.testing.assert_allclose(float(g), float(w), **TOL)

    def test_modularity_maximization(self):
        a = _two_cliques()
        labels, evals, emb = tspec.modularity_maximization(
            CPU, CSR.from_dense(a, device="cpu"), 2, seed=0)
        jlabels, jevals, _ = jspec.modularity_maximization(
            None, JCSR.from_dense(a), 2, seed=0)
        _same_partition(labels, jlabels)
        np.testing.assert_allclose(evals.numpy(), np.asarray(jevals), **TOL)
        for lab in ([0] * 10 + [1] * 10, [3] * 5 + [7] * 15):
            lab = np.asarray(lab, np.int32)
            q = tspec.modularity(CPU, CSR.from_dense(a, device="cpu"), lab)
            jq = jspec.modularity(None, JCSR.from_dense(a), jnp.asarray(lab))
            np.testing.assert_allclose(float(q), float(jq), **TOL)

    def test_fit_embedding_fiedler_sign_structure(self):
        a = _two_cliques()
        evals, evecs = tspec.fit_embedding(CPU, CSR.from_dense(
            a, device="cpu"), 1, seed=1)
        jevals, jevecs = jspec.fit_embedding(None, JCSR.from_dense(a), 1,
                                             seed=1)
        np.testing.assert_allclose(evals.numpy(), np.asarray(jevals), **TOL)
        f, jf = evecs.numpy()[:, 0], np.asarray(jevecs)[:, 0]
        np.testing.assert_allclose(f * np.sign(f @ jf), jf, rtol=1e-5,
                                   atol=1e-4)
        s1, s2 = set(np.sign(f[:10])), set(np.sign(f[10:]))
        assert len(s1) == len(s2) == 1 and s1 != s2


class TestLAP:
    @pytest.mark.parametrize("n", [5, 20, 64])
    def test_matches_scipy(self, n):
        cost = np.random.default_rng(n).integers(0, 100, (n, n)).astype(
            np.float32)
        assign, total = linear_assignment(CPU, cost)
        jassign, jtotal = j_lap(None, cost)
        np.testing.assert_array_equal(assign.numpy(), np.asarray(jassign))
        assert float(total) == float(jtotal)
        ri, ci = scipy.optimize.linear_sum_assignment(cost)
        assert float(total) == cost[ri, ci].sum()

    def test_float_costs_near_optimal(self):
        n = 32
        cost = np.random.default_rng(0).random((n, n)).astype(np.float32)
        assign, total = linear_assignment(CPU, cost)
        jassign, jtotal = j_lap(None, cost)
        np.testing.assert_array_equal(assign.numpy(), np.asarray(jassign))
        np.testing.assert_allclose(float(total), float(jtotal), **TOL)

    def test_maximize(self):
        n = 10
        cost = np.random.default_rng(1).integers(0, 50, (n, n)).astype(
            np.float32)
        assign, total = linear_assignment(CPU, cost, maximize=True)
        jassign, jtotal = j_lap(None, cost, maximize=True)
        np.testing.assert_array_equal(assign.numpy(), np.asarray(jassign))
        assert float(total) == float(jtotal)

    def test_batched_object_api(self):
        n, b = 8, 3
        costs = np.random.default_rng(2).integers(0, 30, (b, n, n)).astype(
            np.float32)
        lap = LinearAssignmentProblem(CPU, n, b)
        jlap = JLAP(None, n, b)
        got = lap.solve(costs)
        assert torch.equal(got, lap.row_assignments)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jlap.solve(costs)))
        np.testing.assert_array_equal(lap.objective_values.numpy(),
                                      np.asarray(jlap.objective_values))
        assert lap.solve(costs[0]).shape == (1, n)

    def test_counts_phases_and_iterations(self):
        cost = np.random.default_rng(3).integers(0, 100, (16, 16)).astype(
            np.float32)
        p0 = tracing.get_counter("solver.lap.phases")
        i0 = tracing.get_counter("solver.lap.iterations")
        linear_assignment(CPU, cost)
        assert tracing.get_counter("solver.lap.phases") > p0
        assert tracing.get_counter("solver.lap.iterations") > i0
        with pytest.raises(RaftError):
            linear_assignment(CPU, cost[:, :5])
