"""The port's stats and label packages (``raft_tpu_torch.stats``,
``raft_tpu_torch.label``) against the JAX package's on the CPU: each JAX
test class of ``tests/test_stats.py`` has a counterpart here, fed the
same numpy inputs from a seed. Float32 results agree to rtol 1e-5 /
atol 1e-5; counts, labels and other integer outputs are equal."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

from raft_tpu import label as jlab
from raft_tpu import stats as js
from raft_tpu.distance.types import DistanceType as JD
from raft_tpu.stats.metrics import ICType as JIC
from raft_tpu_torch import Resources
from raft_tpu_torch import label as tlab
from raft_tpu_torch import stats as ts
from raft_tpu_torch.core.validation import RaftError
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.stats.metrics import ICType

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

CPU = Resources(device="cpu")
TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, **kw):
    got = [got] if isinstance(got, torch.Tensor) else list(got)
    want = [want] if not isinstance(want, tuple) else list(want)
    for g, w in zip(got, want):
        assert g.device.type == "cpu"
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **(kw or TOL))


def _j(fn, *args, **kw):
    """The JAX reference call jitted whole (one compile, where its eager
    ops compile one by one), Python arguments fixed."""
    return jax.jit(lambda *arrays: fn(None, *arrays, *args, **kw))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture
def rng():
    return np.random.default_rng(42)


class TestSummary:
    def test_mean_var_stddev(self, rng):
        x = rng.standard_normal((50, 7)).astype(np.float32)
        mu = x.mean(axis=0) + 0.5
        for rows in (False, True):
            _close(ts.mean(CPU, x, along_rows=rows),
                   js.mean(None, x, along_rows=rows))
            _close(ts.sum_stat(CPU, x, along_rows=rows),
                   js.sum_stat(None, x, along_rows=rows))
        for sample in (True, False):
            _close(ts.var(CPU, x, sample=sample), js.var(None, x,
                                                         sample=sample))
            _close(ts.stddev(CPU, x, mu, sample=sample),
                   js.stddev(None, x, jnp.asarray(mu), sample=sample))

    def test_cov(self, rng):
        x = rng.standard_normal((100, 5)).astype(np.float32)
        _close(ts.cov(CPU, x), js.cov(None, x))
        _close(ts.cov(CPU, x, np.zeros(5, np.float32), sample=False),
               js.cov(None, x, jnp.zeros(5), sample=False))

    def test_mean_center(self, rng):
        x = rng.standard_normal((20, 4)).astype(np.float32)
        _close(ts.mean_center(CPU, x), js.mean_center(None, x))

    def test_histogram(self, rng):
        x = rng.uniform(0, 1, (200, 3)).astype(np.float32)
        _eq(ts.histogram(CPU, x, 10, lo=0.0, hi=1.0),
            js.histogram(None, x, 10, lo=0.0, hi=1.0))
        y = rng.standard_normal(300).astype(np.float32)
        got = ts.histogram(CPU, y, 7)
        assert got.dtype == torch.int32
        _eq(got, js.histogram(None, y, 7))
        _eq(ts.histogram(CPU, y, 5, lo=-1.0, hi=1.0),
            js.histogram(None, y, 5, lo=-1.0, hi=1.0))

    def test_minmax(self, rng):
        x = rng.standard_normal((30, 4)).astype(np.float32)
        mn, mx = ts.minmax(CPU, x)
        jmn, jmx = js.minmax(None, x)
        _eq(mn, jmn)
        _eq(mx, jmx)

    def test_weighted_mean(self, rng):
        x = rng.standard_normal((12, 6)).astype(np.float32)
        w = rng.uniform(0.1, 1.0, 6).astype(np.float32)
        w2 = rng.uniform(0.1, 1.0, 12).astype(np.float32)
        _close(ts.weighted_mean(CPU, x, w), js.weighted_mean(None, x, w))
        _close(ts.weighted_mean(CPU, x, w2, along_rows=False),
               js.weighted_mean(None, x, w2, along_rows=False))
        with pytest.raises(RaftError):
            ts.weighted_mean(CPU, x, w2)


class TestRegressionMetrics:
    def test_accuracy(self, rng):
        y = rng.integers(0, 3, 100)
        p = y.copy()
        p[:25] = (p[:25] + 1) % 3
        _close(ts.accuracy(CPU, p, y), js.accuracy(None, p, y))

    def test_r2(self, rng):
        y = rng.standard_normal(80).astype(np.float32)
        yh = y + 0.1 * rng.standard_normal(80).astype(np.float32)
        _close(ts.r2_score(CPU, y, yh), js.r2_score(None, y, yh))


class TestClusteringMetrics:
    @pytest.fixture
    def two_labelings(self, rng):
        a = rng.integers(0, 4, 300)
        b = a.copy()
        flip = rng.random(300) < 0.2
        b[flip] = rng.integers(0, 5, int(flip.sum()))
        return a.astype(np.int32), b.astype(np.int32)

    def test_contingency(self, two_labelings):
        a, b = two_labelings
        got = ts.contingency_matrix(CPU, a, b)
        assert got.dtype == torch.int32
        _eq(got, js.contingency_matrix(None, jnp.asarray(a), jnp.asarray(b)))
        # labels past the class counts count nowhere
        _eq(ts.contingency_matrix(CPU, a, b, 3, 4),
            js.contingency_matrix(None, jnp.asarray(a), jnp.asarray(b), 3, 4))

    @pytest.mark.parametrize("fn", ["rand_index", "adjusted_rand_index",
                                    "mutual_info_score", "homogeneity_score",
                                    "completeness_score", "v_measure"])
    def test_pair_metrics(self, two_labelings, fn):
        a, b = two_labelings
        _close(getattr(ts, fn)(CPU, a, b),
               getattr(js, fn)(None, jnp.asarray(a), jnp.asarray(b)))
        # identical labelings: the perfect score
        _close(getattr(ts, fn)(CPU, a, a),
               getattr(js, fn)(None, jnp.asarray(a), jnp.asarray(a)))

    def test_homogeneity_completeness_v_measure(self, two_labelings):
        a, b = two_labelings
        _close(ts.homogeneity_score(CPU, a, b, n_classes=4),
               js.homogeneity_score(None, jnp.asarray(a), jnp.asarray(b),
                                    n_classes=4))
        _close(ts.v_measure(CPU, a, b, beta=2.0),
               js.v_measure(None, jnp.asarray(a), jnp.asarray(b), beta=2.0))
        one = np.zeros(300, np.int32)
        _close(ts.homogeneity_score(CPU, one, b),
               js.homogeneity_score(None, jnp.asarray(one), jnp.asarray(b)))

    def test_entropy(self, two_labelings):
        a, _ = two_labelings
        _close(ts.entropy(CPU, a, 4), js.entropy(None, jnp.asarray(a), 4))
        _close(ts.entropy(CPU, np.array([0, 0, 1, 1]), 2),
               js.entropy(None, jnp.asarray([0, 0, 1, 1]), 2))

    def test_kl(self):
        p = np.array([0.5, 0.5, 0.0], np.float32)
        q = np.array([0.9, 0.1, 0.0], np.float32)
        _close(ts.kl_divergence(CPU, p, q),
               js.kl_divergence(None, jnp.asarray(p), jnp.asarray(q)))

    def test_silhouette(self):
        x, y = make_blobs(n_samples=200, centers=4, n_features=8,
                          random_state=0)
        x = x.astype(np.float32)
        _close(ts.silhouette_score(CPU, x, y),
               _j(js.silhouette_score, 4)(x, y))
        _close(ts.silhouette_score(CPU, x, y, metric=DistanceType.L1),
               _j(js.silhouette_score, 4, JD.L1)(x, y))
        y1 = y.copy()
        y1[0] = 4                      # a singleton scores 0
        _close(ts.silhouette_score(CPU, x, y1),
               _j(js.silhouette_score, 5)(x, y1))

    def test_silhouette_batched_matches(self):
        x, y = make_blobs(n_samples=150, centers=3, n_features=5,
                          random_state=1)
        x = x.astype(np.float32)
        _close(ts.silhouette_score(CPU, x, y, tile=37),
               _j(js.silhouette_score, 3, tile=37)(x, y))
        _close(ts.silhouette_score(CPU, x, y, tile=37),
               ts.silhouette_score(CPU, x, y))

    def test_trustworthiness(self, rng):
        x = rng.standard_normal((100, 10)).astype(np.float32)
        xe = x[:, :2] + 0.01 * rng.standard_normal((100, 2)).astype(
            np.float32)
        _close(ts.trustworthiness(CPU, x, xe, 5),
               _j(js.trustworthiness, 5)(x, xe))
        # integer points: many tied distances, ranked by the smaller index
        xi = rng.integers(0, 3, (60, 4)).astype(np.float32)
        xei = xi[:, :2].copy()
        _close(ts.trustworthiness(CPU, xi, xei, 4),
               _j(js.trustworthiness, 4)(xi, xei))
        with pytest.raises(RaftError):
            ts.trustworthiness(CPU, x, xe, 60)

    def test_information_criterion(self):
        ll = np.array([-100.0, -200.0], np.float32)
        for t, j in ((ICType.AIC, JIC.AIC), (ICType.AICc, JIC.AICc),
                     (ICType.BIC, JIC.BIC)):
            _close(ts.information_criterion(CPU, ll, t, 3, 50),
                   js.information_criterion(None, jnp.asarray(ll), j, 3, 50))

    def test_dispersion(self, rng):
        c = rng.standard_normal((5, 3)).astype(np.float32)
        sizes = rng.integers(1, 20, 5).astype(np.int32)
        _close(ts.dispersion(CPU, c, sizes),
               js.dispersion(None, jnp.asarray(c), jnp.asarray(sizes)))
        g = np.ones(3, np.float32)
        _close(ts.dispersion(CPU, c, sizes, g),
               js.dispersion(None, jnp.asarray(c), jnp.asarray(sizes),
                             jnp.asarray(g)))


class TestLabel:
    def test_unique_and_monotonic(self):
        labels = np.array([10, 20, 10, 99, 20], np.int32)
        _eq(tlab.get_unique_labels(CPU, labels),
            jlab.get_unique_labels(None, jnp.asarray(labels)))
        got = tlab.make_monotonic(CPU, labels)
        assert got.dtype == torch.int32
        _eq(got, jlab.make_monotonic(None, jnp.asarray(labels)))
        classes = np.array([5, 10, 20, 99], np.int32)
        _eq(tlab.make_monotonic(CPU, labels, classes),
            jlab.make_monotonic(None, jnp.asarray(labels),
                                jnp.asarray(classes)))

    def test_ovr(self):
        labels = np.array([1, 2, 1, 3])
        _eq(tlab.ovr_labels(CPU, labels, 1),
            jlab.ovr_labels(None, jnp.asarray(labels), 1))

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_merge_labels(self, seed):
        la = np.array([0, 0, 2, 3, 3], np.int32)
        lb = np.array([0, 1, 1, 1, 2], np.int32)
        _eq(tlab.merge_labels(CPU, la, lb),
            jlab.merge_labels(None, jnp.asarray(la), jnp.asarray(lb)))
        rng = np.random.default_rng(seed)
        n = 64
        la = rng.integers(0, n, n).astype(np.int32)
        lb = rng.integers(0, n, n).astype(np.int32)
        mask = rng.random(n) < 0.7
        _eq(tlab.merge_labels(CPU, la, lb, mask),
            jlab.merge_labels(None, jnp.asarray(la), jnp.asarray(lb),
                              jnp.asarray(mask)))


class TestMeanVarRegression:
    def test_meanvar_matches_separate(self, rng):
        x = rng.standard_normal((50, 6)).astype(np.float32)
        _close(ts.meanvar(CPU, x), js.meanvar(None, x))
        _close(ts.meanvar(CPU, x, sample=False),
               js.meanvar(None, x, sample=False))

    @pytest.mark.parametrize("n", [64, 65])
    def test_regression_metrics(self, rng, n):
        p = rng.standard_normal(n).astype(np.float32)
        r = rng.standard_normal(n).astype(np.float32)
        _close(ts.regression_metrics(CPU, p, r),
               js.regression_metrics(None, p, r))

    def test_trustworthiness_alias(self):
        assert ts.trustworthiness_score is ts.trustworthiness
        assert set(ts.__all__) == set(js.__all__)
