"""The port's balanced k-means against the JAX package's on the same
inputs. ``predict`` and ``calc_centers_and_sizes`` are deterministic and
compared directly (labels equal; centers to float32 tolerance atol
1e-5). ``fit`` draws from another generator than ``jax.random``, so it
is held to quality instead: its inertia lies within 5% of the JAX fit's
on the same seeded blobs."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from raft_tpu.cluster import kmeans_balanced as j_km
from raft_tpu.distance.types import DistanceType as JD
from raft_tpu_torch import Resources
from raft_tpu_torch.cluster import kmeans_balanced as t_km
from raft_tpu_torch.distance.types import DistanceType

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

RES = Resources(device="cpu", seed=0)


def _blobs(seed=0, n=3000, d=16, centers=24):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d)).astype(np.float32) * 6.0
    lab = rng.integers(0, centers, n)
    return (c[lab] + rng.standard_normal((n, d))).astype(np.float32)


def _inertia(x, centers):
    d2 = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(axis=2)
    return float(d2.min(axis=1).sum())


@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.InnerProduct],
                         ids=lambda m: m.name)
def test_predict_labels_equal(metric):
    x = _blobs()
    rng = np.random.default_rng(1)
    centers = rng.standard_normal((20, 16)).astype(np.float32)
    if metric == DistanceType.InnerProduct:
        centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    want = j_km.predict(None, j_km.KMeansBalancedParams(metric=JD(int(metric))),
                        centers, x)
    got = t_km.predict(RES, t_km.KMeansBalancedParams(metric=metric),
                       centers, x)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_calc_centers_and_sizes_match():
    x = _blobs()
    labels = np.random.default_rng(2).integers(0, 30, x.shape[0]).astype(
        np.int32)
    labels[labels == 7] = 8          # an empty cluster
    wc, ws = j_km.calc_centers_and_sizes(x, labels, 30)
    gc, gs = t_km.calc_centers_and_sizes(x, labels, 30)
    assert np.array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=0, atol=1e-5)


@pytest.mark.parametrize("blobs", [6, 100])
def test_fit_inertia_within_five_percent_of_reference(blobs):
    # more lists than blobs (6) or many more blobs than lists (100): the
    # optimum is well posed. With exactly one list per blob, both fits
    # land in local optima that vary 3x from seed to seed.
    x = _blobs(seed=3, centers=blobs)
    jc = np.asarray(j_km.fit(None, j_km.KMeansBalancedParams(n_iters=20),
                             x, 24))
    tc = t_km.fit(RES, t_km.KMeansBalancedParams(n_iters=20), x, 24)
    assert tc.shape == (24, 16) and tc.dtype == torch.float32
    assert _inertia(x, tc.numpy()) <= 1.05 * _inertia(x, jc)


def test_fit_inner_product_centers_are_normalized():
    x = _blobs(seed=4)
    tc = t_km.fit(RES, t_km.KMeansBalancedParams(
        n_iters=5, metric=DistanceType.InnerProduct), x, 10)
    np.testing.assert_allclose(torch.linalg.norm(tc, dim=1).numpy(), 1.0,
                               rtol=1e-5)


def test_build_clusters_and_seed_determinism():
    x = _blobs(seed=5)
    params = t_km.KMeansBalancedParams(n_iters=6, seed=11)
    c1, labels, sizes = t_km.build_clusters(RES, params, x, 12)
    c2 = t_km.fit(RES, params, x, 12)
    assert torch.equal(c1, c2)                # same seed, same centers
    assert int(sizes.sum()) == x.shape[0]
    assert torch.equal(torch.bincount(labels.long(), minlength=12).int(),
                       sizes)
    c3, lab3 = t_km.fit_predict(RES, params, x, 12)
    assert torch.equal(c3, c1) and lab3.shape == (x.shape[0],)


@pytest.mark.parametrize("n_segments", [1, 30, 257])
def test_segment_sum_is_row_order_and_equals_jax(n_segments):
    """The fixed-order center sums: bit-equal to a serial float32 sum in
    row order (numpy's unbuffered ``add.at``), and equal to
    ``jax.ops.segment_sum`` within float32 tolerance; empty segments sum
    to 0."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(n_segments)
    x = (rng.standard_normal((4000, 24)) * 10).astype(np.float32)
    labels = rng.integers(0, n_segments, 4000).astype(np.int32)
    labels[labels == n_segments // 2] = 0          # an empty segment
    got = t_km.segment_sum(torch.from_numpy(x), torch.from_numpy(labels),
                           n_segments).numpy()
    serial = np.zeros((n_segments, 24), np.float32)
    np.add.at(serial, labels, x)
    assert np.array_equal(got, serial)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(x),
                                          jnp.asarray(labels), n_segments))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(x).sum(axis=0).max())
    if n_segments > 1:
        assert not got[n_segments // 2].any()


def test_fit_calls_no_float_index_add(monkeypatch):
    """The build sums through ``segment_sum``: a float ``index_add_``
    (atomics on CUDA, no fixed order) is never called."""
    calls = []
    orig = torch.Tensor.index_add_

    def spy(self, *a, **kw):
        calls.append(self.dtype)
        return orig(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "index_add_", spy)
    x = _blobs(n=800)
    t_km.build_clusters(RES, t_km.KMeansBalancedParams(n_iters=3), x, 12)
    assert not [dt for dt in calls if dt.is_floating_point]


def test_weighted_draw_follows_the_weights_and_the_generator():
    """The balancing step's draw: a row of an at-least-average cluster is
    (1 + 1e-6) / 1e-6 times as likely as one of a small cluster (so with
    half the rows big, nearly every draw is big and spread evenly over
    them), and one seed gives the same draws."""
    big = torch.zeros(1000, dtype=torch.bool)
    big[::2] = True

    def draw(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return t_km._weighted_draw(g, big, 20000)

    a, b = draw(3), draw(3)
    assert torch.equal(a, b) and not torch.equal(a, draw(4))
    assert int(a.min()) >= 0 and int(a.max()) < 1000
    assert float(big[a].float().mean()) > 0.999
    counts = torch.bincount(a[big[a]], minlength=1000)[::2].float()
    assert float(counts.std() / counts.mean()) < 0.2
