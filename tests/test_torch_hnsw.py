"""raft_tpu_torch.neighbors.hnsw against raft_tpu.neighbors.hnsw: the
hnswlib file the port writes is byte-identical to the JAX writer's for the
same graph and dataset (float32, int8, uint8); either package loads the
other's file into the same graph and dataset; a saved and loaded index
searches exactly as the original (the same beam search over the same
graph and vectors); a foreign file (permuted labels, ragged link counts)
loads as the JAX package loads it.
"""

import struct

import numpy as np
import pytest
import scipy.spatial.distance as spd
import torch

import raft_tpu.neighbors.cagra as j_cagra
import raft_tpu.neighbors.hnsw as j_hnsw
from raft_tpu.distance.types import DistanceType as JDT
from raft_tpu_torch import Resources
from raft_tpu_torch.core.validation import RaftError
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors import cagra, hnsw

RES = Resources(device="cpu", seed=0)


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(11)
    centers = rng.standard_normal((12, 24)) * 4
    labels = rng.integers(0, 12, 1500)
    x = (centers[labels] + rng.standard_normal((1500, 24))).astype(np.float32)
    q = (centers[rng.integers(0, 12, 32)]
         + rng.standard_normal((32, 24))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def jax_index(dataset):
    x, _ = dataset
    return j_cagra.build(None, j_cagra.CagraIndexParams(
        graph_degree=16, intermediate_graph_degree=32,
        build_algo=j_cagra.BuildAlgo.NN_DESCENT), x)


def _port(jidx):
    return cagra.from_numpy(np.asarray(jidx.dataset), np.asarray(jidx.graph),
                            DistanceType(int(jidx.metric)), res=RES)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_file_bytes_equal_the_jax_writer(jax_index, tmp_path):
    jp, tp = str(tmp_path / "jax.hnsw"), str(tmp_path / "port.hnsw")
    j_hnsw.save_hnswlib(None, jax_index, jp)
    hnsw.save_hnswlib(RES, _port(jax_index), tp)
    assert _bytes(tp) == _bytes(jp)
    # ef_construction rides the header verbatim
    j_hnsw.save_hnswlib(None, jax_index, jp, ef_construction=77)
    hnsw.save_hnswlib(RES, _port(jax_index), tp, ef_construction=77)
    assert _bytes(tp) == _bytes(jp)


@pytest.mark.parametrize("dtype", [np.int8, np.uint8])
def test_byte_datasets_equal_the_jax_writer(tmp_path, dtype):
    rng = np.random.default_rng(3)
    info = np.iinfo(dtype)
    x = rng.integers(info.min, info.max, (64, 16)).astype(dtype)
    g = rng.integers(0, 64, (64, 12)).astype(np.int32)
    jp, tp = str(tmp_path / "jax.hnsw"), str(tmp_path / "port.hnsw")
    j_hnsw.save_hnswlib(None, j_cagra.CagraIndex(
        dataset=x, graph=g, metric=JDT.L2Expanded), jp)
    hnsw.save_hnswlib(RES, cagra.from_numpy(x, g, res=RES), tp)
    assert _bytes(tp) == _bytes(jp)
    for dt in (dtype, {np.int8: torch.int8, np.uint8: torch.uint8}[dtype]):
        back = hnsw.load_hnswlib(RES, jp, 16, dtype=dt)
        assert back.dataset.dtype == {np.int8: torch.int8,
                                      np.uint8: torch.uint8}[dtype]
        np.testing.assert_array_equal(back.dataset.numpy(), x)
        np.testing.assert_array_equal(back.graph.numpy(), g)


def test_header_layout(jax_index, tmp_path):
    path = str(tmp_path / "cagra.hnsw")
    index = _port(jax_index)
    hnsw.save_hnswlib(RES, index, path)
    raw = _bytes(path)
    hdr = struct.Struct("<QQQQQQiIQQQdQ")
    (off0, max_elems, count, per_elem, label_off, data_off,
     maxlevel, entry, max_m, max_m0, m, mult, efc) = hdr.unpack_from(raw, 0)
    n, degree = index.graph.shape
    dim = index.dataset.shape[1]
    assert off0 == 0 and max_elems == n and count == n
    assert max_m0 == degree and m == max_m == degree // 2
    assert data_off == 4 + 4 * degree
    assert label_off == data_off + 4 * dim
    assert per_elem == label_off + 8
    assert maxlevel == 0 and entry == 0
    assert mult == pytest.approx(1.0 / np.log(degree // 2))
    assert efc == 500
    assert len(raw) == hdr.size + n * per_elem + 4 * n


@pytest.mark.parametrize("metric", ["L2Expanded", "InnerProduct"])
def test_jax_written_file_loads_into_the_same_graph(jax_index, tmp_path,
                                                    metric):
    path = str(tmp_path / "jax.hnsw")
    j_hnsw.save_hnswlib(None, jax_index, path)
    dim = jax_index.dataset.shape[1]
    got = hnsw.load_hnswlib(RES, path, dim, metric=DistanceType[metric])
    want = j_hnsw.load_hnswlib(None, path, dim, metric=JDT[metric])
    assert got.metric == DistanceType[metric]
    assert got.graph.dtype == torch.int32
    np.testing.assert_array_equal(got.graph.numpy(), np.asarray(want.graph))
    np.testing.assert_array_equal(got.dataset.numpy(),
                                  np.asarray(want.dataset))
    np.testing.assert_array_equal(got.graph.numpy(),
                                  np.asarray(jax_index.graph))
    # and the JAX loader reads the port's file the same way
    tp = str(tmp_path / "port.hnsw")
    hnsw.save_hnswlib(RES, got, tp)
    back = j_hnsw.load_hnswlib(None, tp, dim)
    np.testing.assert_array_equal(np.asarray(back.graph), got.graph.numpy())


def test_round_trip_searches_equal(dataset, jax_index, tmp_path):
    x, q = dataset
    index = _port(jax_index)
    path = str(tmp_path / "cagra.hnsw")
    hnsw.save_hnswlib(RES, index, path)
    loaded = hnsw.load_hnswlib(RES, path, x.shape[1])
    for sp in (cagra.CagraSearchParams(itopk_size=64),
               cagra.CagraSearchParams(itopk_size=32, search_width=2,
                                       algo="cuda")):
        want = cagra.search(RES, sp, index, q, 10)
        got = cagra.search(RES, sp, loaded, q, 10)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    truth = np.argsort(spd.cdist(q, x, "sqeuclidean"), axis=1,
                       kind="stable")[:, :10]
    ids = got[1].numpy()
    recall = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, truth)])
    assert recall >= 0.9


def test_wrong_dim_and_types_rejected(jax_index, tmp_path):
    path = str(tmp_path / "cagra.hnsw")
    index = _port(jax_index)
    hnsw.save_hnswlib(RES, index, path)
    with pytest.raises(RaftError, match="layout mismatch"):
        hnsw.load_hnswlib(RES, path, index.dataset.shape[1] + 3)
    with pytest.raises(RaftError, match="f32/int8/uint8"):
        hnsw.load_hnswlib(RES, path, index.dataset.shape[1],
                          dtype=torch.bfloat16)
    bf = cagra.CagraIndex(index.dataset.to(torch.bfloat16), index.graph,
                          index.metric)
    with pytest.raises(RaftError, match="f32/int8/uint8"):
        hnsw.save_hnswlib(RES, bf, str(tmp_path / "bf16.hnsw"))
    with open(path, "rb") as f:
        raw = f.read()
    with open(path, "wb") as f:
        f.write(raw[:len(raw) // 2])
    with pytest.raises(RaftError, match="truncated"):
        hnsw.load_hnswlib(RES, path, index.dataset.shape[1])


def test_foreign_permuted_ragged_file_loads_as_jax(tmp_path):
    """A file shaped like hnswlib's own output: permuted insertion order
    (labels != internal ids) and ragged link counts."""
    rng = np.random.default_rng(5)
    n, dim, max_m0 = 50, 8, 6
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    labels = rng.permutation(n).astype(np.uint64)
    counts = rng.integers(1, max_m0 + 1, n)
    links = rng.integers(0, n, (n, max_m0)).astype(np.uint32)
    hdr = struct.Struct("<QQQQQQiIQQQdQ")
    data_off = 4 + 4 * max_m0
    label_off = data_off + 4 * dim
    path = str(tmp_path / "foreign.hnsw")
    with open(path, "wb") as f:
        f.write(hdr.pack(0, n, n, label_off + 8, label_off, data_off,
                         2, 17, max_m0 // 2, max_m0, max_m0 // 2, 1.0, 200))
        for i in range(n):
            f.write(struct.pack("<I", counts[i]))
            f.write(links[i].tobytes())
            f.write(vecs[i].tobytes())
            f.write(struct.pack("<Q", labels[i]))
        f.write(np.zeros(n, dtype="<u4").tobytes())
    got = hnsw.load_hnswlib(RES, path, dim)
    want = j_hnsw.load_hnswlib(None, path, dim)
    np.testing.assert_array_equal(got.graph.numpy(), np.asarray(want.graph))
    np.testing.assert_array_equal(got.dataset.numpy(),
                                  np.asarray(want.dataset))
    inv = np.argsort(labels)
    np.testing.assert_array_equal(got.dataset.numpy(), vecs[inv])
