"""The streaming builds of raft_tpu_torch against the JAX package's: the
train sample, the label pass, and each family's ``build_streaming`` with
the trained parts carried across.

The builds train with other generators than JAX's, so the trained parts
(centers, rotation, codebooks) are handed to both packages: the JAX
trainer and the port's are wrapped to return the same integer-valued
centers and codebooks (and the identity rotation), on integer-valued
data, so every product is exact and the lists, ids, codes and rows must
be equal. The builds left alone are held to recall (within 0.02 of the
JAX build's at full probes), and the port to its own invariances:
``chunk_rows`` does not change the index, and a cancelled build raises.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_tpu.io as jio
import raft_tpu.neighbors._streaming as j_streaming
import raft_tpu.neighbors.ivf_bq as j_ivf_bq
import raft_tpu.neighbors.ivf_flat as j_ivf_flat
import raft_tpu.neighbors.ivf_pq as j_ivf_pq
from raft_tpu.cluster.kmeans_balanced import (
    KMeansBalancedParams as JKMParams,
)
from raft_tpu_torch import Resources
from raft_tpu_torch.cluster.kmeans_balanced import KMeansBalancedParams
from raft_tpu_torch.core import interruptible
from raft_tpu_torch.io import BinDataset, write_bin
from raft_tpu_torch.neighbors import _streaming, ivf_bq, ivf_flat, ivf_pq

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)

RES = Resources(device="cpu", seed=0)
N_LISTS = 8


def _int_blobs(rng, n, d, n_blobs=8):
    centers = rng.integers(-20, 21, (n_blobs, d))
    lab = rng.integers(0, n_blobs, n)
    return (centers[lab] + rng.integers(-3, 4, (n, d))).astype(np.float32)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    rng = np.random.default_rng(7)
    x = _int_blobs(rng, 3001, 32)
    path = tmp_path_factory.mktemp("stream") / "x.fbin"
    write_bin(path, x)
    return x, path


def _int_centers(x, n_lists):
    return np.round(x[:: len(x) // n_lists][:n_lists]).astype(np.float32)


def _assert_fields_equal(a, b, names):
    for f in names:
        va, vb = getattr(a, f), getattr(b, f)
        np.testing.assert_array_equal(
            va.cpu().numpy() if isinstance(va, torch.Tensor) else va,
            np.asarray(vb), err_msg=f)


@pytest.mark.parametrize("train_rows,chunk", [(512, 1000), (1000, 333),
                                              (4096, 64)])
def test_sample_trainset_equals_jax(dataset, train_rows, chunk):
    _, path = dataset
    with BinDataset(path) as ds, jio.BinDataset(path, use_native=False) as jd:
        got = _streaming.sample_trainset(ds, train_rows, chunk)
        want = j_streaming.sample_trainset(jd, train_rows, chunk)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunk", [500, 4096])
def test_sample_trainset_keeps_its_phase_across_chunks(dataset, chunk):
    _, path = dataset
    with BinDataset(path) as ds:
        np.testing.assert_array_equal(
            _streaming.sample_trainset(ds, 700, chunk),
            _streaming.sample_trainset(ds, 700, 3001))


@pytest.mark.parametrize("metric", ["L2Expanded", "InnerProduct"])
def test_label_pass_equals_jax(dataset, metric):
    from raft_tpu.distance.types import DistanceType as JDT

    from raft_tpu_torch.distance.types import DistanceType

    x, path = dataset
    centers = _int_centers(x, N_LISTS)
    km = KMeansBalancedParams(metric=DistanceType[metric])
    jkm = JKMParams(metric=JDT[metric])
    with BinDataset(path) as ds, jio.BinDataset(path, use_native=False) as jd:
        lab, sizes = _streaming.label_pass(RES, km, torch.as_tensor(centers),
                                           ds, 700, N_LISTS)
        jlab, jsizes = j_streaming.label_pass(None, jkm, jnp.asarray(centers),
                                              jd, 700, N_LISTS)
    np.testing.assert_array_equal(lab, jlab)
    np.testing.assert_array_equal(sizes, jsizes)


@pytest.fixture
def carried_flat(monkeypatch, dataset):
    """Both packages' streaming IVF-Flat quantizer returns the same
    integer centers."""
    x, _ = dataset
    centers = _int_centers(x, N_LISTS)
    import raft_tpu.cluster.kmeans_balanced as j_kb

    from raft_tpu_torch.cluster import kmeans_balanced as t_kb

    monkeypatch.setattr(j_kb, "fit",
                        lambda *a, **k: jnp.asarray(centers))
    monkeypatch.setattr(t_kb, "fit",
                        lambda res, *a, **k: res.put(centers))
    return centers


@pytest.mark.parametrize("chunk", [700, 1024])
def test_flat_build_streaming_equals_jax(dataset, carried_flat, chunk):
    _, path = dataset
    params = ivf_flat.IvfFlatIndexParams(n_lists=N_LISTS)
    jparams = j_ivf_flat.IvfFlatIndexParams(n_lists=N_LISTS)
    with BinDataset(path) as ds, jio.BinDataset(path, use_native=False) as jd:
        got = ivf_flat.build_streaming(RES, params, ds, chunk_rows=chunk,
                                       train_rows=512)
        want = j_ivf_flat.build_streaming(None, jparams, jd,
                                          chunk_rows=chunk, train_rows=512)
    _assert_fields_equal(got, want, ["centers", "data", "data_norms",
                                     "indices", "list_sizes"])


def _carry_trainer(monkeypatch, j_mod, t_mod, fix):
    """Wrap both packages' in-memory trainers (``build`` without data, as
    ``build_streaming`` calls it) so their trained parts are ``fix``'s."""
    j_build, t_build = j_mod.build, t_mod.build

    def j_wrapped(res, params, trainset):
        return dataclasses.replace(j_build(res, params, trainset),
                                   **{k: jnp.asarray(v)
                                      for k, v in fix.items()})

    def t_wrapped(res, params, trainset):
        return dataclasses.replace(t_build(res, params, trainset),
                                   **{k: res.put(v) for k, v in fix.items()})

    monkeypatch.setattr(j_mod, "build", j_wrapped)
    monkeypatch.setattr(t_mod, "build", t_wrapped)


@pytest.mark.parametrize("metric", ["L2Expanded", "InnerProduct"])
def test_pq_build_streaming_equals_jax(monkeypatch, dataset, metric):
    from raft_tpu.distance.types import DistanceType as JDT

    from raft_tpu_torch.distance.types import DistanceType

    x, path = dataset
    rng = np.random.default_rng(3)
    pq_dim, pq_len = 8, 4
    fix = {"centers": _int_centers(x, N_LISTS),
           "rotation": np.eye(32, dtype=np.float32),
           "codebooks": rng.integers(-6, 7, (pq_dim, 256, pq_len)).astype(
               np.float32)}
    _carry_trainer(monkeypatch, j_ivf_pq, ivf_pq, fix)
    params = ivf_pq.IvfPqIndexParams(n_lists=N_LISTS, pq_dim=pq_dim,
                                     metric=DistanceType[metric])
    jparams = j_ivf_pq.IvfPqIndexParams(n_lists=N_LISTS, pq_dim=pq_dim,
                                        metric=JDT[metric])
    with BinDataset(path) as ds, jio.BinDataset(path, use_native=False) as jd:
        got = ivf_pq.build_streaming(RES, params, ds, chunk_rows=900,
                                     train_rows=1024)
        want = j_ivf_pq.build_streaming(None, jparams, jd, chunk_rows=900,
                                        train_rows=1024)
    assert not got.packed and not want.packed
    _assert_fields_equal(got, want, ["centers", "rotation", "codebooks",
                                     "codes", "indices", "list_sizes"])


@pytest.mark.parametrize("bits,store", [(1, True), (2, False)])
def test_bq_build_streaming_equals_jax(monkeypatch, dataset, bits, store):
    x, path = dataset
    fix = {"centers": _int_centers(x, N_LISTS),
           "rotation": np.eye(32, dtype=np.float32)}
    _carry_trainer(monkeypatch, j_ivf_bq, ivf_bq, fix)
    params = ivf_bq.IvfBqIndexParams(n_lists=N_LISTS, bits=bits,
                                     store_vectors=store)
    jparams = j_ivf_bq.IvfBqIndexParams(n_lists=N_LISTS, bits=bits,
                                        store_vectors=store)
    with BinDataset(path) as ds, jio.BinDataset(path, use_native=False) as jd:
        got = ivf_bq.build_streaming(RES, params, ds, chunk_rows=800,
                                     train_rows=1024)
        want = j_ivf_bq.build_streaming(None, jparams, jd, chunk_rows=800,
                                        train_rows=1024)
    _assert_fields_equal(got, want, ["centers", "rotation", "codes",
                                     "indices", "list_sizes"])
    # the norms and per-level scales are sums over the dimension in each
    # framework's own order: float32 rounding apart (an ulp on 0.4% of
    # the rnorm entries)
    for f in ("rnorm", "cfac", "errw"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    assert (got.data is None) == (not store)
    if store:
        _assert_fields_equal(got, want, ["data", "data_norms"])


@pytest.mark.parametrize("family", ["flat", "pq", "bq"])
def test_build_streaming_does_not_depend_on_chunk_rows(dataset, family):
    _, path = dataset
    mod, params = {
        "flat": (ivf_flat, ivf_flat.IvfFlatIndexParams(n_lists=N_LISTS)),
        "pq": (ivf_pq, ivf_pq.IvfPqIndexParams(n_lists=N_LISTS, pq_dim=8)),
        "bq": (ivf_bq, ivf_bq.IvfBqIndexParams(n_lists=N_LISTS)),
    }[family]
    with BinDataset(path) as ds:
        a = mod.build_streaming(RES, params, ds, chunk_rows=1 << 12,
                                train_rows=1024)
        b = mod.build_streaming(RES, params, ds, chunk_rows=333,
                                train_rows=1024)
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, torch.Tensor):
            assert torch.equal(va, vb), f.name
        else:
            assert va == vb, f.name


def _recall(ids, truth):
    ids = np.asarray(ids)
    return float(np.mean([len(set(a) & set(b)) / truth.shape[1]
                          for a, b in zip(ids, truth)]))


@pytest.mark.parametrize("family", ["flat", "pq", "bq"])
def test_untouched_build_recall_near_jax(tmp_path, family):
    """No trained part carried: the port's and the JAX build's generators
    differ, so the builds differ; at full probes their recall@10 is held
    within 0.02 (400 queries, so one build's codebook draw moves it less
    than that)."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((4000, 32)) * 2).astype(np.float32)
    q = rng.standard_normal((400, 32)).astype(np.float32)
    path = tmp_path / "x.fbin"
    write_bin(path, x)
    d2 = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    truth = np.argsort(d2, axis=1, kind="stable")[:, :10]
    mods = {"flat": (ivf_flat, j_ivf_flat, "IvfFlatIndexParams",
                     "IvfFlatSearchParams", {}),
            "pq": (ivf_pq, j_ivf_pq, "IvfPqIndexParams",
                   "IvfPqSearchParams", {"pq_dim": 16}),
            "bq": (ivf_bq, j_ivf_bq, "IvfBqIndexParams",
                   "IvfBqSearchParams", {})}
    t_mod, j_mod, ip, sp, extra = mods[family]
    with BinDataset(path) as ds, jio.BinDataset(path, use_native=False) as jd:
        got = t_mod.build_streaming(
            RES, getattr(t_mod, ip)(n_lists=16, **extra), ds,
            chunk_rows=1000)
        want = j_mod.build_streaming(
            None, getattr(j_mod, ip)(n_lists=16, **extra), jd,
            chunk_rows=1000)
    _, ti = t_mod.search(RES, getattr(t_mod, sp)(n_probes=16), got, q, 10)
    _, ji = j_mod.search(None, getattr(j_mod, sp)(n_probes=16), want, q, 10)
    assert got.size == want.size == 4000
    assert abs(_recall(ti, truth) - _recall(ji, truth)) <= 0.02


def test_cancelled_build_raises_mid_build(dataset):
    """``interruptible.cancel`` from another thread ends a build at its
    next chunk; the flag is consumed, so the next build runs."""
    import threading

    _, path = dataset
    params = ivf_flat.IvfFlatIndexParams(n_lists=N_LISTS)
    chunks = []

    class Source:
        """A BinDataset whose third chunk cancels the building thread."""

        def __init__(self, ds):
            self.ds, self.n_rows, self.dim = ds, ds.n_rows, ds.dim

        def iter_chunks(self, chunk_rows):
            for first, c in self.ds.iter_chunks(chunk_rows):
                chunks.append(first)
                if len(chunks) == 3:
                    t = threading.Thread(target=interruptible.cancel,
                                         args=(threading.get_ident(),))
                    t.start()
                    t.join(10)
                yield first, c

    with BinDataset(path) as ds:
        with pytest.raises(interruptible.InterruptedException):
            ivf_flat.build_streaming(RES, params, Source(ds), chunk_rows=500,
                                     train_rows=512)
        assert len(chunks) == 3
        index = ivf_flat.build_streaming(RES, params, ds, chunk_rows=500,
                                         train_rows=512)
    assert index.size == 3001


@pytest.mark.parametrize("family", ["flat", "pq", "bq"])
def test_cancel_before_build_raises(dataset, family):
    _, path = dataset
    mod, params = {
        "flat": (ivf_flat, ivf_flat.IvfFlatIndexParams(n_lists=N_LISTS)),
        "pq": (ivf_pq, ivf_pq.IvfPqIndexParams(n_lists=N_LISTS, pq_dim=8)),
        "bq": (ivf_bq, ivf_bq.IvfBqIndexParams(n_lists=N_LISTS)),
    }[family]
    interruptible.cancel()
    with BinDataset(path) as ds:
        with pytest.raises(interruptible.InterruptedException):
            mod.build_streaming(RES, params, ds, chunk_rows=500)
