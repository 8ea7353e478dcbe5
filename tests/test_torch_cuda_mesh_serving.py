"""The executor's mesh plans on the card, at sizes too small for
``chip_smoke.py``: captured CUDA graphs over the list-sharded IVF-Flat,
IVF-PQ and IVF-BQ indexes (kernel #2, ``ivf_pq_scan`` and kernel #4 in
the shard bodies) against the direct mesh searches, no capture after
warmup, the ragged mesh family, probe accounting, the timed calls of a
capture window, and graph captures kept out of profiler sessions. Every
test needs a CUDA device and skips without one; the file imports no
JAX, so run it with ``--noconftest``:

    python -m pytest --noconftest -q tests/test_torch_cuda_mesh_serving.py

A served request must equal the direct ``distributed.search*`` bit for
bit (ids and distances); replays record kernel launches; timing events
are recorded only while a capture window is open.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from raft_tpu_torch import Resources
from raft_tpu_torch.comms import local_comms
from raft_tpu_torch.core import profiling, tracing
from raft_tpu_torch.core.executor import SearchExecutor, _kernel_wrappers
from raft_tpu_torch.distributed import bq as dbq
from raft_tpu_torch.distributed import ivf as divf
from raft_tpu_torch.neighbors import ivf_bq, ivf_flat, ivf_pq

pytestmark = pytest.mark.cuda

N, D, N_LISTS, K = 20000, 64, 64, 10
FAMILIES = ("flat", "pq", "bq")
KERNEL = {"flat": "list_major_scan", "pq": "ivf_pq_scan", "bq": "bq_scan"}


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
    g = torch.Generator(device=dev).manual_seed(5)
    centers = torch.randn(128, D, generator=g, device=dev) * 2
    lab = torch.randint(0, 128, (N + 600,), generator=g, device=dev)
    pts = centers[lab] + torch.randn(N + 600, D, generator=g, device=dev)
    return pts[:N].contiguous(), pts[N:].contiguous()


@pytest.fixture(scope="module")
def mesh(res, data):
    """The three families built on the card and dealt over 4 slots."""
    x, _ = data
    comms = local_comms(shape=(4,), device="cuda")
    return {
        "flat": divf.from_index(comms, ivf_flat.build(
            res, ivf_flat.IvfFlatIndexParams(n_lists=N_LISTS), x)),
        "pq": divf.from_pq_index(comms, ivf_pq.build(
            res, ivf_pq.IvfPqIndexParams(n_lists=N_LISTS, pq_dim=32), x)),
        "bq": dbq.from_bq_index(comms, ivf_bq.build(
            res, ivf_bq.IvfBqIndexParams(n_lists=N_LISTS), x)),
    }


def _params(family, n_probes):
    if family == "flat":
        return ivf_flat.IvfFlatSearchParams(n_probes=n_probes), divf.search
    if family == "pq":
        return ivf_pq.IvfPqSearchParams(n_probes=n_probes), divf.search_pq
    return ivf_bq.IvfBqSearchParams(n_probes=n_probes), dbq.search_bq


def _bits(got, want):
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n_probes", [8, 32])
def test_captured_mesh_plan_equals_direct(res, data, mesh, family,
                                          n_probes):
    _, q = data
    sp, direct = _params(family, n_probes)
    ex = SearchExecutor(res)
    ex.warmup(mesh[family], buckets=(8, 16, 512), k=K, params=sp)
    assert all(c["captured"] for c in ex.executable_costs().values())
    c0 = ex.stats.compile_count
    for rows in (1, 7, 16, 300, 512):
        want = direct(res, sp, mesh[family], q[:rows], K)
        _bits(ex.search(mesh[family], q[:rows], K, params=sp), want)
    assert ex.stats.compile_count == c0


@pytest.mark.parametrize("family", FAMILIES)
def test_replays_launch_the_family_kernel(res, data, mesh, family):
    _, q = data
    sp, _ = _params(family, 16)
    ex = SearchExecutor(res)
    ex.warmup(mesh[family], buckets=(32,), k=K, params=sp)
    (info,) = ex.executable_costs().values()
    assert info["launches"] > 0 and info["pool_bytes"] >= 0
    w = _kernel_wrappers()[KERNEL[family]]
    n0 = w.launches
    ex.search(mesh[family], q[:20], K, params=sp)
    # four slots, each its own scan launch
    assert w.launches - n0 >= 4


@pytest.mark.parametrize("family", FAMILIES)
def test_ragged_mesh_tiles_equal_solo(res, data, mesh, family):
    _, q = data
    # 9 and 13 probes round up to one params class (16)
    sp, _ = _params(family, 9)
    sp2 = dataclasses.replace(sp, n_probes=13)
    ex = SearchExecutor(res, ragged_tile=64)
    ex.warmup_ragged(mesh[family], k=8, params=sp2)
    c0 = ex.stats.compile_count
    blocks = [q[:5], q[5:30], q[30:33]]
    ps = [sp, sp2, sp]
    # k 8, 4 and 7: one k class (8), as n_probes 9 and 13 are one class
    out = ex.search_ragged(mesh[family], blocks, [8, 4, 7], params_list=ps)
    assert ex.stats.compile_count == c0
    for b, got, kj, pj in zip(blocks, out, [8, 4, 7], ps):
        _bits(got, ex.search(mesh[family], b, kj, params=pj))
    assert ex.ragged_executables() == 1


def test_probe_accounting_in_the_captured_plan(res, data, mesh):
    _, q = data
    sp, direct = _params("flat", 8)
    ex = SearchExecutor(res, probe_accounting=True)
    ex.warmup(mesh["flat"], buckets=(64,), k=K, params=sp)
    assert ex.probe_frequencies()[ex.probe_label(mesh["flat"])].sum() == 0
    got = ex.search(mesh["flat"], q[:50], K, params=sp)
    _bits(got, direct(res, sp, mesh["flat"], q[:50], K))
    (plane,) = ex.probe_frequencies().values()
    assert plane.sum() == 50 * 8


def test_2d_grid_captured_equals_1d(res, data, mesh):
    x, q = data
    comms2 = local_comms(("lists", "queries"), shape=(4, 2), device="cuda")
    flat2 = divf.from_index(comms2, ivf_flat.build(
        res, ivf_flat.IvfFlatIndexParams(n_lists=N_LISTS), x))
    sp, _ = _params("flat", 16)
    ex = SearchExecutor(res)
    got = ex.search(flat2, q[:37], K, params=sp, query_axis="queries")
    _bits(got, ex.search(mesh["flat"], q[:37], K, params=sp))


def test_timed_calls_only_inside_a_capture_window(res, data, mesh):
    _, q = data
    sp, _ = _params("flat", 8)
    ex = SearchExecutor(res)
    ex.warmup(mesh["flat"], buckets=(16,), k=K, params=sp)
    (info,) = ex.executable_costs().values()
    orig = profiling.note_call
    seen = []

    def spy(module, ev0, ev1):
        seen.append(module)
        orig(module, ev0, ev1)

    profiling.note_call = spy
    try:
        ex.search(mesh["flat"], q[:10], K, params=sp)
        assert seen == []
        with profiling.capture_window() as w:
            ex.search(mesh["flat"], q[:10], K, params=sp)
            ex.search(mesh["flat"], q[:12], K, params=sp)
        ex.search(mesh["flat"], q[:10], K, params=sp)
    finally:
        profiling.note_call = orig
    assert seen == [info["hlo_module"]] * 2
    calls = w.timings()
    assert [c["module"] for c in calls] == [info["hlo_module"]] * 2
    assert all(c["dur_s"] > 0 for c in calls)


def test_mesh_trace_records_spans_without_captures(res, data, mesh):
    _, q = data
    sp, _ = _params("flat", 8)
    ex = SearchExecutor(res, mesh_trace=True)
    ex.warmup(mesh["flat"], buckets=(16,), k=K, params=sp)
    c0 = ex.stats.compile_count
    tracing.reset_spans()
    tid = tracing.new_trace_id()
    ex.search(mesh["flat"], q[:16], K, params=sp, trace_ids=(tid,))
    rec = tracing.span_recorder()
    (mg,) = rec.spans(trace_id=tid, name="serving.mesh.merge")
    assert mg.duration > 0
    assert rec.spans(trace_id=tid, name="serving.mesh.shard") == []
    assert ex.stats.compile_count == c0


def test_capture_on_another_thread_records_the_device(res, data, mesh,
                                                      tmp_path):
    """After :func:`profiling.prime` on this thread, a session started on
    another thread records device ops, and the timed calls of the entry
    served inside it."""
    import threading

    _, q = data
    sp, _ = _params("flat", 8)
    ex = SearchExecutor(res)
    ex.warmup(mesh["flat"], buckets=(16,), k=K, params=sp)
    profiling.prime()
    box = {}

    def capture():
        with tracing.capture(str(tmp_path)) as cap:
            for _ in range(3):
                ex.search(mesh["flat"], q[:16], K, params=sp)
            torch.cuda.synchronize()
        box["path"] = cap.path

    t = threading.Thread(target=capture)
    t.start()
    t.join()
    attr = profiling.attribute(box["path"], ex.executable_costs())
    ops = profiling.load_ops(box["path"])[0]
    assert ops, "the session recorded no device op"
    (m,) = attr.modules.values()
    assert m.timed_calls == 3 and m.invocations == 3
    assert m.device_seconds > 0


def test_cache_miss_waits_out_a_profiler_session(res, data, mesh, tmp_path):
    """A request that misses the cache while a session runs on another
    thread captures its graph after the session has ended, instead of
    capturing inside it (which hung the process); both finish."""
    import threading
    import time

    _, q = data
    sp, direct = _params("flat", 8)
    ex = SearchExecutor(res)
    ex.warmup(mesh["flat"], buckets=(16,), k=K, params=sp)
    profiling.prime()
    opened = threading.Event()
    box = {}

    def session():
        with tracing.capture(str(tmp_path)):
            opened.set()
            time.sleep(1.0)
        box["closed"] = time.perf_counter()

    def miss():
        # 40 rows: the 64-row bucket, not warmed
        box["got"] = ex.search(mesh["flat"], q[:40], K, params=sp)
        box["served"] = time.perf_counter()

    t = threading.Thread(target=session, daemon=True)
    t.start()
    assert opened.wait(60)
    m = threading.Thread(target=miss, daemon=True)
    m.start()
    m.join(120)
    t.join(120)
    assert not t.is_alive() and not m.is_alive(), "capture or session hung"
    assert box["served"] > box["closed"]
    assert ex.stats.compile_count == 2
    assert all(c["captured"] for c in ex.executable_costs().values())
    _bits(box["got"], direct(res, sp, mesh["flat"], q[:40], K))


def test_cache_miss_inside_a_session_on_its_thread_raises(res, data, mesh,
                                                          tmp_path):
    _, q = data
    sp, direct = _params("flat", 8)
    ex = SearchExecutor(res)
    profiling.prime()
    with tracing.capture(str(tmp_path)):
        with pytest.raises(RuntimeError, match="inside a profiler session"):
            ex.search(mesh["flat"], q[:16], K, params=sp)
    assert ex.stats.compile_count == 0 and ex.stats.cache_misses == 0
    _bits(ex.search(mesh["flat"], q[:16], K, params=sp),
          direct(res, sp, mesh["flat"], q[:16], K))
