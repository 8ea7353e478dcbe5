"""Per-slot readiness in ``mesh_trace`` and the rank-major mesh plans on
the card. Every test needs a CUDA device and skips without one; the file
imports no JAX, so run it with ``--noconftest``:

    python -m pytest --noconftest -q tests/test_torch_cuda_mesh_slots.py

- A captured mesh entry records one timing event after each slot's scan
  and one after the merge inside its CUDA graph (``external`` events):
  every replay publishes R ``serving.mesh.shard`` spans from R distinct
  readings, none past the merged readiness, sets the straggler gauges,
  and captures nothing after warmup.
- Two threads replaying the same entry each read their own dispatch's
  events: a dispatch holds the entry's events until it has read them.
- The rank-major mesh plans (eager IVF-Flat and IVF-PQ, captured IVF-BQ,
  a codes-only IVF-BQ index) equal their direct searches bit for bit,
  and the direct rank searches equal the single-device rank searches.
"""

from __future__ import annotations

import dataclasses
import threading

import pytest
import torch

from raft_tpu_torch import Resources
from raft_tpu_torch.comms import local_comms
from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.executor import SearchExecutor
from raft_tpu_torch.distributed import bq as dbq
from raft_tpu_torch.distributed import ivf as divf
from raft_tpu_torch.neighbors import ivf_bq, ivf_flat, ivf_pq

pytestmark = pytest.mark.cuda

N, D, N_LISTS, K, SLOTS = 20000, 64, 64, 10, 4


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the slot events are CUDA events")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def res(dev):
    return Resources(device=dev)


@pytest.fixture(scope="module")
def data(dev):
    g = torch.Generator(device=dev).manual_seed(7)
    centers = torch.randn(128, D, generator=g, device=dev) * 2
    lab = torch.randint(0, 128, (N + 600,), generator=g, device=dev)
    pts = centers[lab] + torch.randn(N + 600, D, generator=g, device=dev)
    return pts[:N].contiguous(), pts[N:].contiguous()


@pytest.fixture(scope="module")
def single(res, data):
    x, _ = data
    return {
        "flat": ivf_flat.build(res, ivf_flat.IvfFlatIndexParams(
            n_lists=N_LISTS), x),
        "pq": ivf_pq.build(res, ivf_pq.IvfPqIndexParams(n_lists=N_LISTS,
                                                        pq_dim=32), x),
        "bq": ivf_bq.build(res, ivf_bq.IvfBqIndexParams(n_lists=N_LISTS), x),
    }


@pytest.fixture(scope="module")
def mesh(single):
    comms = local_comms(shape=(SLOTS,), device="cuda")
    bq = dbq.from_bq_index(comms, single["bq"])
    return {"flat": divf.from_index(comms, single["flat"]),
            "pq": divf.from_pq_index(comms, single["pq"]),
            "bq": bq,
            "bq_codes": dataclasses.replace(bq, data=None, data_norms=None)}


def _family(family, n_probes=16, engine="auto"):
    """(search params, direct mesh search, single-device search)."""
    if family == "flat":
        return (ivf_flat.IvfFlatSearchParams(n_probes=n_probes,
                                             scan_engine=engine),
                divf.search, ivf_flat.search)
    if family == "pq":
        return (ivf_pq.IvfPqSearchParams(n_probes=n_probes,
                                         scan_engine=engine),
                divf.search_pq, ivf_pq.search)
    return (ivf_bq.IvfBqSearchParams(n_probes=n_probes, scan_engine=engine),
            dbq.search_bq, ivf_bq.search)


def _bits(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _dispatch_spans(tid):
    rec = tracing.span_recorder()
    merges = rec.spans(trace_id=tid, name="serving.mesh.merge")
    shards = rec.spans(trace_id=tid, name="serving.mesh.shard")
    return [(m, [s for s in shards if s.start == m.start]) for m in merges]


@pytest.mark.parametrize("family", ["flat", "pq", "bq", "bq_codes"])
def test_captured_slot_loop_publishes_every_slot(res, data, mesh, family):
    _, q = data
    sp, direct, _ = _family(family)
    index = mesh[family]
    ex = SearchExecutor(res, mesh_trace=True)
    ex.warmup(index, buckets=(16,), k=K, params=sp)
    (info,) = ex.executable_costs().values()
    assert info["captured"]
    (entry,) = ex._cache.values()
    assert entry.marks is not None and entry.marks.cuda
    c0 = ex.stats.compile_count
    tracing.reset_spans()
    tracing.reset_gauges("serving.mesh.")
    tid = tracing.new_trace_id()
    for j in range(4):
        got = ex.search(index, q[16 * j:16 * j + 16], K, params=sp,
                        trace_ids=(tid,))
        _bits(got, direct(res, sp, index, q[16 * j:16 * j + 16], K))
    assert ex.stats.compile_count == c0
    spans = _dispatch_spans(tid)
    assert len(spans) == 4
    for merge, own in spans:
        offs = [s.duration for s in own]
        assert [s.attrs["shard"] for s in own] == list(range(SLOTS))
        assert len(set(offs)) == SLOTS and max(offs) <= merge.duration
        # one card, one stream: the slots finish in slot order
        assert offs == sorted(offs)
    g = tracing.gauges("serving.mesh.")
    assert g[tracing.MESH_SLOWEST_SHARD] == float(SLOTS - 1)
    assert g[tracing.MESH_SHARD_SKEW] > 0


def test_two_threads_replaying_one_entry_read_their_own_slots(res, data,
                                                              mesh):
    _, q = data
    sp, direct, _ = _family("flat")
    index = mesh["flat"]
    ex = SearchExecutor(res, mesh_trace=True)
    ex.warmup(index, buckets=(16,), k=K, params=sp)
    want = [direct(res, sp, index, q[16 * j:16 * j + 16], K)
            for j in range(8)]
    c0 = ex.stats.compile_count
    tracing.reset_spans()
    tids = [tracing.new_trace_id() for _ in range(2)]
    got = [[None] * 8 for _ in range(2)]
    errors = []

    def run(t):
        try:
            for rep in range(5):
                for j in range(8):
                    got[t][j] = ex.search(index, q[16 * j:16 * j + 16], K,
                                          params=sp, trace_ids=(tids[t],))
        except Exception as e:          # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    assert not errors
    assert ex.stats.compile_count == c0
    for t in range(2):
        for g, w in zip(got[t], want):
            _bits(g, w)
        spans = _dispatch_spans(tids[t])
        assert len(spans) == 40
        for merge, own in spans:
            offs = [s.duration for s in own]
            assert len(own) == SLOTS and len(set(offs)) == SLOTS
            assert max(offs) <= merge.duration


@pytest.mark.parametrize("family", ["flat", "pq", "bq", "bq_codes"])
def test_rank_mesh_plans_equal_direct_and_single_device(res, data, single,
                                                        mesh, family):
    _, q = data
    sp, direct, single_search = _family(family, engine="rank")
    index = mesh[family]
    ex = SearchExecutor(res)
    ex.warmup(index, buckets=(16, 64), k=K, params=sp)
    (info, *_) = ex.executable_costs().values()
    # captured where the single-device rank plan is: IVF-BQ only
    assert info["captured"] == family.startswith("bq")
    c0 = ex.stats.compile_count
    for n in (16, 9, 64, 40):
        _bits(ex.search(index, q[:n], K, params=sp),
              direct(res, sp, index, q[:n], K))
    assert ex.stats.compile_count == c0
    one = single["bq" if family == "bq_codes" else family]
    if family == "bq_codes":
        one = dataclasses.replace(one, data=None, data_norms=None)
    _bits(direct(res, sp, index, q[:64], K),
          single_search(res, sp, one, q[:64], K))
