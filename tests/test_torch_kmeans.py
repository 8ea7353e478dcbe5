"""The port's Lloyd k-means against the JAX package's on the CPU, on
seeded blobs. With the same initial centers (``InitMethod.Array``) both
take the same steps: labels and iteration counts equal, centroids within
1e-5. The k-means++ and random draws come from different generators, so
those fits are held to the JAX fit's inertia within 10%. predict,
transform, cluster_cost, update_centroids and find_k take the same
inputs through both packages; two same-seed fits are equal."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from raft_tpu.cluster import kmeans as jk
from raft_tpu.distance.types import DistanceType as JD
from raft_tpu_torch import Resources
from raft_tpu_torch.cluster import kmeans as tk
from raft_tpu_torch.cluster.kmeans_balanced import draw_by_weight
from raft_tpu_torch.core.validation import RaftError
from raft_tpu_torch.distance.types import DistanceType

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

CPU = Resources(device="cpu")


def _blobs(seed=0, n=800, d=6, k=7, spread=8.0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * spread
    lab = rng.integers(0, k, n)
    return (centers[lab] + rng.standard_normal((n, d))).astype(np.float32)


def _init(x, k, seed=1):
    return x[np.random.default_rng(seed).choice(len(x), k, replace=False)]


@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.L2SqrtExpanded],
                         ids=lambda m: m.name)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_array_init_takes_the_reference_steps(seed, metric):
    x = _blobs(seed)
    init = _init(x, 7, seed)
    jc, ji, jn = jk.fit(None, jk.KMeansParams(
        n_clusters=7, init=jk.InitMethod.Array, metric=JD(int(metric))), x,
        init)
    params = tk.KMeansParams(n_clusters=7, init=tk.InitMethod.Array,
                             metric=metric)
    tc, ti, tn = tk.fit(CPU, params, x, init)
    assert tn == int(jn)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(ti), float(ji), rtol=1e-5)
    tc2, tl2, ti2, tn2 = tk.fit_predict(CPU, params, x, init)
    jl2, _ = jk.predict(None, jk.KMeansParams(n_clusters=7), jc, x)
    assert torch.equal(tc2, tc) and tn2 == tn
    np.testing.assert_array_equal(tl2.numpy(), np.asarray(jl2))


@pytest.mark.parametrize("init", [tk.InitMethod.KMeansPlusPlus,
                                  tk.InitMethod.Random], ids=str)
@pytest.mark.parametrize("seed", [0, 3])
def test_seeded_inits_match_reference_quality(init, seed):
    x = _blobs(seed, n=1200, k=9)
    _, ji, _ = jk.fit(None, jk.KMeansParams(
        n_clusters=12, init=jk.InitMethod(int(init)), seed=seed), x)
    params = tk.KMeansParams(n_clusters=12, init=init, seed=seed)
    tc, ti, tn = tk.fit(CPU, params, x)
    assert float(ti) <= 1.10 * float(ji)
    again = tk.fit(CPU, params, x)
    assert torch.equal(again[0], tc) and again[2] == tn


def test_kmeanspp_beats_its_seeds():
    x = torch.from_numpy(_blobs(4, n=1500, k=10))
    gen = torch.Generator()
    gen.manual_seed(0)
    seeds = tk._kmeanspp_init(gen, x, 10)
    seed_cost = tk.cluster_cost(CPU, seeds, x)
    _, inertia, _ = tk.fit(CPU, tk.KMeansParams(n_clusters=10), x)
    assert float(inertia) <= float(seed_cost)


def test_predict_transform_cost_update_match_reference():
    x = _blobs(5)
    c = _init(x, 7, 2)
    jp = jk.KMeansParams(n_clusters=7)
    tp = tk.KMeansParams(n_clusters=7)
    jl, jinert = jk.predict(None, jp, c, x)
    tl, tinert = tk.predict(CPU, tp, c, x)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(float(tinert), float(jinert), rtol=1e-5)
    np.testing.assert_allclose(float(tk.cluster_cost(CPU, c, x)),
                               float(jk.cluster_cost(None, c, x)), rtol=1e-5)
    np.testing.assert_allclose(tk.transform(CPU, tp, c, x).numpy(),
                               np.asarray(jk.transform(None, jp, c, x)),
                               rtol=1e-5, atol=1e-4)
    w = np.random.default_rng(0).random(len(x)).astype(np.float32)
    for weights in (None, w):
        jn, jlab = jk.update_centroids(None, x, c, weights)
        tn, tlab = tk.update_centroids(CPU, x, c, weights)
        np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5,
                                   atol=1e-5)


def test_update_centroids_keeps_empty_clusters():
    x = _blobs(6)
    c = np.concatenate([_init(x, 5, 3), np.full((1, 6), 1e4, np.float32)])
    for weights in (None, np.ones(len(x), np.float32)):
        tn, _ = tk.update_centroids(CPU, x, c, weights)
        jn, _ = jk.update_centroids(None, x, c, weights)
        np.testing.assert_array_equal(tn[5].numpy(), c[5])
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5,
                                   atol=1e-5)


def test_find_k_matches_reference():
    x = _blobs(7, n=600, d=4, k=5, spread=12.0)
    jbest, _ = jk.find_k(None, x, k_max=8)
    tbest, tinert = tk.find_k(CPU, x, k_max=8)
    assert tbest == jbest == 5
    assert float(tinert) > 0


@pytest.mark.parametrize("metric", [DistanceType.L1,
                                    DistanceType.InnerProduct,
                                    DistanceType.CosineExpanded],
                         ids=lambda m: m.name)
def test_other_metrics_raise_the_reference_error(metric):
    x = _blobs(8, n=50)
    with pytest.raises(Exception) as jerr:
        jk.fit(None, jk.KMeansParams(n_clusters=3, metric=JD(int(metric))),
               x)
    with pytest.raises(RaftError) as terr:
        tk.fit(CPU, tk.KMeansParams(n_clusters=3, metric=metric), x)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(RaftError):
        tk.predict(CPU, tk.KMeansParams(n_clusters=3, metric=metric),
                   x[:3], x)


def test_fit_errors():
    x = _blobs(9, n=10)
    with pytest.raises(RaftError, match="n_clusters > n_samples"):
        tk.fit(CPU, tk.KMeansParams(n_clusters=11), x)
    with pytest.raises(RaftError, match="init_centroids"):
        tk.fit(CPU, tk.KMeansParams(n_clusters=3,
                                    init=tk.InitMethod.Array), x)


def test_draw_by_weight_is_proportional_and_fixed():
    w = torch.tensor([0, 1, 3, 0, 6], dtype=torch.int64)
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(5)
    g2.manual_seed(5)
    a = draw_by_weight(g1, w, 20000)
    assert torch.equal(a, draw_by_weight(g2, w, 20000))
    share = torch.bincount(a, minlength=5).double() / 20000
    assert share[0] == 0 and share[3] == 0
    assert torch.allclose(share, w.double() / 10, atol=0.02)


def test_cluster_exports_mirror_reference():
    import raft_tpu.cluster as jc
    import raft_tpu_torch.cluster as tc

    missing = set(jc.__all__) - set(tc.__all__)
    assert missing == set()
