"""The port's random package (``raft_tpu_torch.random``) against the JAX
package's on the CPU. The generators differ (``jax.random``'s threefry
against PyTorch's), so the draws never agree bit for bit: each
distribution is held to the JAX package's draws of the same call by
distribution only — the means and variances within 5 standard errors of
each other, and a two-sample Kolmogorov–Smirnov test at p > 1e-3.
``TestRng`` and ``TestGenerators`` mirror ``tests/test_random.py``; a
seed reproduces its draws on one device."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import scipy.stats
import torch

from raft_tpu import random as jr
from raft_tpu_torch import random as tr
from raft_tpu_torch.random.rng import _key_of

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

N = 20000


def _port(fn, *args, **kw):
    out = getattr(tr, fn)(tr.RngState(0), *args, device="cpu", **kw)
    assert out.device.type == "cpu"
    return out.numpy().astype(np.float64)


def _jax(fn, *args, **kw):
    """The JAX package's draw, jitted whole (one compile)."""
    out = jax.jit(lambda: getattr(jr, fn)(jr.RngState(0), *args, **kw))()
    return np.asarray(out).astype(np.float64)


def _same_distribution(a, b):
    """Means and variances within 5 standard errors; KS p > 1e-3."""
    n, m = a.size, b.size
    se_mean = np.sqrt(a.var() / n + b.var() / m)
    assert abs(a.mean() - b.mean()) <= 5 * se_mean + 1e-12

    def var_se(x):
        c = x - x.mean()
        return np.sqrt(max(np.mean(c ** 4) - np.mean(c ** 2) ** 2, 0.0)
                       / x.size)

    se_var = np.sqrt(var_se(a) ** 2 + var_se(b) ** 2)
    assert abs(a.var() - b.var()) <= 5 * se_var + 1e-12
    assert scipy.stats.ks_2samp(a.ravel(), b.ravel()).pvalue > 1e-3


class TestRng:
    def test_reproducible(self):
        a = tr.uniform(tr.RngState(3), (100,), device="cpu")
        b = tr.uniform(tr.RngState(3), (100,), device="cpu")
        assert torch.equal(a, b)
        c = tr.uniform(3, (100,), device="cpu")
        assert torch.equal(c, tr.uniform(3, (100,), device="cpu"))

    def test_stream_advances(self):
        st = tr.RngState(3)
        a = tr.uniform(st, (100,), device="cpu")
        b = tr.uniform(st, (100,), device="cpu")
        assert not torch.equal(a, b)
        skipped = tr.RngState(3)
        skipped.advance(1)
        assert torch.equal(tr.uniform(skipped, (100,), device="cpu"), b)
        assert tr.GeneratorType.Philox == jr.GeneratorType.Philox == 1

    def test_uniform_range(self):
        x = _port("uniform", (N,), low=-2, high=3)
        assert x.min() >= -2 and x.max() < 3
        _same_distribution(x, _jax("uniform", (N,), low=-2, high=3))

    def test_normal_moments(self):
        _same_distribution(_port("normal", (N,), mu=1.0, sigma=2.0),
                           _jax("normal", (N,), mu=1.0, sigma=2.0))

    @pytest.mark.parametrize("fn", ["lognormal", "gumbel", "logistic",
                                    "laplace", "exponential", "rayleigh"])
    def test_distributions_finite(self, fn):
        x = _port(fn, (N,))
        assert np.isfinite(x).all()
        _same_distribution(x, _jax(fn, (N,)))

    def test_uniform_int_and_scaled_bernoulli(self):
        x = _port("uniform_int", (N,), 2, 9)
        assert x.min() >= 2 and x.max() < 9
        _same_distribution(x, _jax("uniform_int", (N,), 2, 9))
        s = _port("scaled_bernoulli", (N,), prob=0.3, scale=2.5)
        assert set(np.unique(s)) == {-2.5, 2.5}
        _same_distribution(s, _jax("scaled_bernoulli", (N,), prob=0.3,
                                   scale=2.5))

    def test_bernoulli(self):
        x = _port("bernoulli", (N,), prob=0.3)
        _same_distribution(x, _jax("bernoulli", (N,), prob=0.3))

    def test_permute(self):
        p = tr.permute(tr.RngState(0), 100, device="cpu")
        assert p.dtype == torch.int32
        np.testing.assert_array_equal(np.sort(p.numpy()), np.arange(100))

    def test_sample_without_replacement(self):
        s = tr.sample_without_replacement(tr.RngState(0), 20, 100,
                                          device="cpu")
        assert len(set(s.tolist())) == 20 and s.max() < 100
        # position of each draw's first sample: uniform over the population
        firsts = np.array([int(tr.sample_without_replacement(
            tr.RngState(i), 1, 10, device="cpu")[0]) for i in range(400)])
        jfirsts = np.array([int(jr.sample_without_replacement(
            jr.RngState(i), 1, 10)[0]) for i in range(400)])
        assert scipy.stats.chisquare(np.bincount(firsts, minlength=10)
                                     ).pvalue > 1e-3
        assert scipy.stats.chisquare(np.bincount(jfirsts, minlength=10)
                                     ).pvalue > 1e-3

    def test_weighted_sample(self):
        w = np.zeros(50)
        w[:10] = 1.0
        s = tr.sample_without_replacement(tr.RngState(0), 10, 50,
                                          weights=w + 1e-9, device="cpu")
        js = jr.sample_without_replacement(jr.RngState(0), 10, 50,
                                           weights=w + 1e-9)
        assert set(s.tolist()) == set(np.asarray(js).tolist()) \
            == set(range(10))

    def test_subsample(self):
        for pop, n in ((100, 7), (10, 20)):
            got = tr.subsample(tr.RngState(0), pop, n, device="cpu")
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(jr.subsample(jr.RngState(0), pop, n)))

    def test_generator_passes_through(self):
        g = torch.Generator().manual_seed(5)
        assert _key_of(g) is g
        x = tr.normal(g, (4,))
        assert x.device.type == "cpu"


class TestGenerators:
    def test_make_blobs_separable(self):
        x, labels, centers = tr.make_blobs(tr.RngState(0), 500, 8,
                                           n_clusters=4, cluster_std=0.1,
                                           device="cpu")
        assert x.shape == (500, 8) and labels.dtype == torch.int32
        d = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
        assert (d.argmin(1) == labels).float().mean() > 0.99
        # the noise and the centers follow the JAX package's distributions
        jx, jlab, jc = jax.jit(lambda: jr.make_blobs(jr.RngState(0), 4000, 8,
                                                     n_clusters=4))()
        x, labels, centers = tr.make_blobs(tr.RngState(0), 4000, 8,
                                           n_clusters=4, device="cpu")
        noise = (x - centers[labels.long()]).numpy().astype(np.float64)
        jnoise = np.asarray(jx - jc[jlab], np.float64)
        _same_distribution(noise, jnoise)
        assert centers.min() >= -10 and centers.max() < 10
        _same_distribution(np.bincount(labels.numpy(), minlength=4),
                           np.bincount(np.asarray(jlab), minlength=4))
        fixed = np.eye(3, 8, dtype=np.float32) * 50
        x, labels, centers = tr.make_blobs(0, 300, 8, centers=fixed,
                                           shuffle=False, device="cpu")
        np.testing.assert_array_equal(centers.numpy(), fixed)
        assert int(labels.max()) == 2

    def test_make_regression_solvable(self):
        x, y, coef = tr.make_regression(tr.RngState(0), 200, 10, noise=0.0,
                                        n_informative=6, device="cpu")
        fitted, *_ = np.linalg.lstsq(x.numpy(), y.numpy(), rcond=None)
        np.testing.assert_allclose(fitted, coef.numpy(), rtol=1e-2,
                                   atol=1e-2)
        assert (coef[6:] == 0).all()
        jx, jy, jcoef = jax.jit(lambda: jr.make_regression(
            jr.RngState(0), 200, 10, n_informative=6))()
        _same_distribution(coef[:6].numpy().ravel().astype(np.float64),
                           np.asarray(jcoef)[:6].ravel().astype(np.float64))

    def test_rmat_shapes(self):
        e = tr.rmat(tr.RngState(0), 8, 6, 1000, device="cpu")
        assert e.shape == (1000, 2) and e.dtype == torch.int32
        assert e.min() >= 0 and e[:, 0].max() < 256 and e[:, 1].max() < 64

    def test_rmat_skew(self):
        e = _port("rmat", 10, 10, N)
        je = _jax("rmat", 10, 10, N)
        assert (e[:, 0] < 512).mean() > 0.6
        for col in (0, 1):
            _same_distribution(e[:, col], je[:, col])

    def test_mvg(self):
        cov = np.array([[2.0, 0.5], [0.5, 1.0]], np.float32)
        x = _port("multi_variable_gaussian", np.zeros(2), cov, N)
        jx = _jax("multi_variable_gaussian", np.zeros(2), cov, N)
        np.testing.assert_allclose(np.cov(x.T), cov, atol=0.15)
        for col in (0, 1):
            _same_distribution(x[:, col], jx[:, col])
