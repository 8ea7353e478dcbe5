"""The mesh layer on the card, at sizes too small for ``chip_smoke.py``:
the list-sharded IVF-Flat, IVF-PQ and IVF-BQ searches on R shard slots
of one card (kernel #2, ``ivf_pq_scan`` and kernel #4 in the shard
bodies) against the single-device searches, the quantized wires, the 2-D
grid, the ragged bodies, checkpoints, and the multihost format in a
one-process NCCL group. Every test needs a CUDA device and skips
without one; the file imports no JAX, so run it with ``--noconftest``:

    python -m pytest --noconftest -q tests/test_torch_cuda_distributed.py

``probe_mode="global"`` on the f32 wires must equal the single-device
search bit for bit (ids and distances); the bf16 and int8 probe wires are
held to 0.99 and 0.95 of the f32 wire's ids; the 2-D grid equals the 1-D
mesh bit for bit; each ragged row equals its solo search at its budget;
save -> load -> search is bit-identical.
"""

from __future__ import annotations

import socket

import numpy as np
import pytest
import torch

from raft_tpu_torch import Resources
from raft_tpu_torch.comms import initialize, local_comms
from raft_tpu_torch.distributed import bq as dbq
from raft_tpu_torch.distributed import checkpoint as ckpt
from raft_tpu_torch.distributed import ivf as divf
from raft_tpu_torch.distributed import kmeans as dkm
from raft_tpu_torch.distributed import knn as dknn
from raft_tpu_torch.neighbors import brute_force, ivf_bq, ivf_flat, ivf_pq
from raft_tpu_torch.ops.bq_scan import bq_list_major_scan
from raft_tpu_torch.ops.ivf_pq_scan import ivf_pq_scan
from raft_tpu_torch.ops.ivf_scan import list_major_scan

pytestmark = pytest.mark.cuda

N, D, N_LISTS, K = 20000, 64, 64, 10
FAMILIES = ("flat", "pq", "bq")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the shard bodies run the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def res(dev):
    return Resources(device=dev)


@pytest.fixture(scope="module")
def data(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    centers = torch.randn(128, D, generator=g, device=dev) * 2
    lab = torch.randint(0, 128, (N + 500,), generator=g, device=dev)
    pts = centers[lab] + torch.randn(N + 500, D, generator=g, device=dev)
    return pts[:N].contiguous(), pts[N:].contiguous()


@pytest.fixture(scope="module")
def indexes(res, data):
    x, _ = data
    return {
        "flat": ivf_flat.build(res, ivf_flat.IvfFlatIndexParams(
            n_lists=N_LISTS), x),
        "pq": ivf_pq.build(res, ivf_pq.IvfPqIndexParams(
            n_lists=N_LISTS, pq_dim=32), x),
        "bq": ivf_bq.build(res, ivf_bq.IvfBqIndexParams(n_lists=N_LISTS), x),
    }


def _mod(family):
    return {"flat": (ivf_flat, ivf_flat.IvfFlatSearchParams, divf.search,
                     divf.from_index),
            "pq": (ivf_pq, ivf_pq.IvfPqSearchParams, divf.search_pq,
                   divf.from_pq_index),
            "bq": (ivf_bq, ivf_bq.IvfBqSearchParams, dbq.search_bq,
                   dbq.from_bq_index)}[family]


def _comms(r, dev, grid=False):
    if grid:
        return local_comms(("lists", "queries"), shape=(r, 2), device=dev)
    return local_comms(shape=(r,), device=dev)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("r", [2, 4, 8])
@pytest.mark.parametrize("n_probes,batch", [(8, 1), (8, 10), (32, 500)])
def test_global_equals_single_device(dev, res, data, indexes, family, r,
                                     n_probes, batch):
    _, q = data
    mod, SP, search, deal = _mod(family)
    di = deal(_comms(r, dev), indexes[family])
    sp = SP(n_probes=n_probes)
    counter = {"flat": list_major_scan, "pq": ivf_pq_scan,
               "bq": bq_list_major_scan}[family]
    before = counter.launches
    got = search(res, sp, di, q[:batch], K)
    assert counter.launches > before, "the shard bodies ran no kernel"
    want = mod.search(res, sp, indexes[family], q[:batch], K)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("probe_wire,floor", [("bf16", 0.99), ("int8", 0.95)])
def test_probe_wires_hold_their_floors(dev, res, data, indexes, family,
                                       probe_wire, floor):
    _, q = data
    _, SP, search, deal = _mod(family)
    di = deal(_comms(4, dev), indexes[family])
    _, ref = search(res, SP(n_probes=16), di, q, K)
    _, got = search(res, SP(n_probes=16), di, q, K,
                    probe_wire_dtype=probe_wire, wire_dtype="bf16")
    hit = (got[:, :, None] == ref[:, None, :]).any(dim=2).float().mean()
    assert float(hit) >= floor


@pytest.mark.parametrize("family", FAMILIES)
def test_2d_grid_equals_1d(dev, res, data, indexes, family):
    _, q = data
    _, SP, search, deal = _mod(family)
    one = deal(_comms(4, dev), indexes[family])
    two = deal(_comms(4, dev, grid=True), indexes[family])
    a = search(res, SP(n_probes=16), one, q[:500], K)
    b = search(res, SP(n_probes=16), two, q[:500], K, query_axis="queries")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("probe_mode", ["global", "local"])
def test_ragged_rows_equal_their_solo_search(dev, res, data, indexes, family,
                                             probe_mode):
    _, q = data
    _, SP, search, deal = _mod(family)
    di = deal(_comms(4, dev), indexes[family])
    rp = torch.as_tensor(np.tile([4, 16, 0, 9], 64), dtype=torch.int32,
                         device=dev)
    qt = q[:256]
    cap = divf.resolve_probe_budget(16, N_LISTS, 4, probe_mode)
    kw = dict(comms=di.comms, n_probes=cap, k=K, metric=di.metric,
              probe_mode=probe_mode, scan_engine="cuda")
    if family == "flat":
        got = divf._dist_search_ragged_fn(
            qt, rp, di.centers, di.center_norms, di.data, di.data_norms,
            di.indices, **kw)
    elif family == "pq":
        got = divf._dist_search_ragged_pq_fn(
            qt, rp, di.centers, di.center_norms, di.rotation, di.codebooks,
            di.codes, di.indices, **kw)
    else:
        got = dbq._dist_search_ragged_bq_fn(
            qt, rp, di.centers, di.center_norms, di.centers_rot,
            di.rotation, di.codes, di.rnorm, di.cfac, di.errw, di.indices,
            di.data, di.data_norms, **kw)
    for b in (4, 16, 9):
        rows = (rp == b).nonzero().squeeze(1)
        solo = search(res, SP(n_probes=b), di, qt[rows], K,
                      probe_mode=probe_mode)
        assert torch.equal(got[1][rows], solo[1]), b
        assert torch.equal(got[0][rows], solo[0]), b
    assert bool((got[1][rp == 0] == -1).all())


@pytest.mark.parametrize("family", FAMILIES)
def test_save_load_search_bit_identical(dev, res, data, indexes, family,
                                        tmp_path):
    _, q = data
    _, SP, search, deal = _mod(family)
    di = deal(_comms(4, dev), indexes[family])
    save, load = {"flat": (ckpt.save_flat, ckpt.load_flat),
                  "pq": (ckpt.save_pq, ckpt.load_pq),
                  "bq": (ckpt.save_bq, ckpt.load_bq)}[family]
    save(di, str(tmp_path / "c.bin"))
    back = load(res, _comms(4, dev), str(tmp_path / "c.bin"))
    a = search(res, SP(n_probes=16), di, q, K)
    b = search(res, SP(n_probes=16), back, q, K)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_multihost_format_in_a_one_process_nccl_group(dev, res, data,
                                                      indexes, tmp_path):
    _, q = data
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    initialize(f"localhost:{port}", 1, 0, local_device_ids=[0],
               backend="nccl", timeout_s=60)
    try:
        for family, save, load in (
                ("flat", ckpt.save_flat_multihost, ckpt.load_flat_multihost),
                ("pq", ckpt.save_pq_multihost, ckpt.load_pq_multihost),
                ("bq", ckpt.save_bq_multihost, ckpt.load_bq_multihost)):
            _, SP, search, deal = _mod(family)
            di = deal(_comms(4, dev), indexes[family])
            out = tmp_path / family
            save(di, str(out))
            back = load(res, _comms(2, dev), str(out))
            a = search(res, SP(n_probes=16), di, q, K)
            b = search(res, SP(n_probes=16), back, q, K)
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            assert sorted(p.name for p in out.iterdir()) == [
                "meta.bin", "part00000.bin"]
    finally:
        torch.distributed.destroy_process_group()


def test_knn_and_kmeans_on_the_card(dev, res, data):
    x, q = data
    comms = _comms(4, dev)
    d, i = dknn.brute_force_knn(comms, x, q[:50], K)
    d0, i0 = brute_force.knn(res, x, q[:50], K)
    assert float((i == i0).float().mean()) >= 0.99
    dr, ir = dknn.brute_force_knn_ring(comms, x, q[:52], K)
    assert float((ir[:50] == i0).float().mean()) >= 0.99
    c1, in1 = dkm.fit(comms, x, 64, n_iters=5, seed=1)
    c2, in2 = dkm.fit(comms, x, 64, n_iters=5, seed=1)
    assert torch.equal(c1, c2) and torch.equal(in1, in2)


def test_build_streaming_on_the_card(dev, res, data, tmp_path):
    from raft_tpu_torch.io import BinDataset, write_bin

    x, q = data
    path = tmp_path / "x.fbin"
    assert write_bin(path, x.cpu().numpy(), use_native=True)
    p = ivf_flat.IvfFlatIndexParams(n_lists=N_LISTS)
    with BinDataset(path, use_native=True) as ds:
        a = divf.build_streaming(res, _comms(4, dev), p, ds, chunk_rows=7000)
        b = divf.build_streaming(res, _comms(4, dev), p, ds,
                                 chunk_rows=1 << 14)
        s = ivf_flat.build_streaming(res, p, ds, chunk_rows=7000)
    for f in ("centers", "data", "indices", "list_sizes"):
        for u, v in zip(getattr(a, f), getattr(b, f)):
            assert torch.equal(u, v), f
    sp = ivf_flat.IvfFlatSearchParams(n_probes=N_LISTS)
    _, got = divf.search(res, sp, a, q, K)
    _, want = ivf_flat.search(res, sp, s, q, K)
    assert torch.equal(got, want)
