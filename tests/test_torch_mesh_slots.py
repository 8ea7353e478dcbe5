"""Per-slot readiness in ``mesh_trace`` on the CPU.

An eager mesh dispatch reads the host clock right after each slot's scan
(the shard body's ``slot_marks``), so a dispatch over R slots publishes R
``serving.mesh.shard`` spans from R distinct readings, none past the
merged outputs' readiness, and the straggler gauges reduce them with
:func:`~raft_tpu_torch.core.tracing.straggler_stats`, which must equal
the JAX package's function on the same offsets.
"""

import threading

import numpy as np
import pytest

import raft_tpu.core.tracing as j_tracing
from raft_tpu_torch import Resources, SearchExecutor
from raft_tpu_torch.comms import local_comms
from raft_tpu_torch.core import tracing
from raft_tpu_torch.distributed import bq as dbq
from raft_tpu_torch.distributed import ivf as divf
from raft_tpu_torch.neighbors import ivf_bq, ivf_flat, ivf_pq

RES = Resources(device="cpu", seed=0)
K = 5


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(13)
    x = rng.integers(-4, 5, (1600, 16)).astype(np.float32)
    q = rng.integers(-4, 5, (40, 16)).astype(np.float32)
    return x, q


_CACHE = {}


def _index(family, r, data, grid=False):
    key = (family, r, grid)
    if key not in _CACHE:
        x, _ = data
        comms = (local_comms(("lists", "queries"), shape=(r, 2),
                             device="cpu") if grid
                 else local_comms(shape=(r,), device="cpu"))
        if family == "flat":
            idx = divf.build(RES, comms, ivf_flat.IvfFlatIndexParams(
                n_lists=8), x)
        elif family == "pq":
            idx = divf.build_pq(RES, comms, ivf_pq.IvfPqIndexParams(
                n_lists=8, pq_dim=4, pq_bits=4), x)
        else:
            idx = dbq.build_bq(RES, comms, ivf_bq.IvfBqIndexParams(
                n_lists=8, store_vectors=family == "bq"), x)
        _CACHE[key] = idx
    return _CACHE[key]


_PARAMS = {"flat": ivf_flat.IvfFlatSearchParams,
           "pq": ivf_pq.IvfPqSearchParams,
           "bq": ivf_bq.IvfBqSearchParams,
           "bq_codes": ivf_bq.IvfBqSearchParams}


def _traced(ex, index, q, params, **kw):
    tracing.reset_spans()
    tracing.reset_gauges("serving.mesh.")
    tid = tracing.new_trace_id()
    ex.search(index, q, K, params=params, trace_ids=(tid,), **kw)
    rec = tracing.span_recorder()
    (merge,) = rec.spans(trace_id=tid, name="serving.mesh.merge")
    return rec.spans(trace_id=tid, name="serving.mesh.shard"), merge


@pytest.mark.parametrize("family", ["flat", "pq", "bq", "bq_codes"])
@pytest.mark.parametrize("r", [2, 4])
def test_one_span_a_slot_from_its_own_reading(data, family, r):
    _, q = data
    index = _index(family, r, data)
    ex = SearchExecutor(RES, mesh_trace=True)
    d0 = tracing.get_counter("serving.mesh.dispatches")
    shards, merge = _traced(ex, index, q[:12], _PARAMS[family](n_probes=4))
    assert [s.attrs["shard"] for s in shards] == list(range(r))
    assert all(s.attrs["family"] == merge.attrs["family"] for s in shards)
    offs = [s.duration for s in shards]
    # R distinct readings, taken in slot order, none past the merge
    assert len(set(offs)) == r and offs == sorted(offs)
    assert 0 < offs[0] and offs[-1] <= merge.duration
    stats = tracing.straggler_stats(offs)
    g = tracing.gauges("serving.mesh.")
    assert g[tracing.MESH_SHARD_SKEW] == stats["shard_skew"]
    assert g[tracing.MESH_SLOWEST_SHARD] == float(stats["slowest_shard"])
    assert g[tracing.MESH_SHARD_TIME_MAX] == stats["max_s"]
    assert g[tracing.MESH_SHARD_TIME_MEAN] == stats["mean_s"]
    assert tracing.get_counter("serving.mesh.dispatches") == d0 + 1


def test_a_2x2_grid_publishes_every_slot(data):
    _, q = data
    index = _index("flat", 2, data, grid=True)
    ex = SearchExecutor(RES, mesh_trace=True)
    shards, merge = _traced(ex, index, q[:12],
                            ivf_flat.IvfFlatSearchParams(n_probes=4),
                            query_axis="queries")
    offs = [s.duration for s in shards]
    assert len(offs) == 4 and len(set(offs)) == 4
    assert max(offs) <= merge.duration


def test_readings_differ_between_dispatches(data):
    """Each dispatch takes its own readings: two dispatches' spans are
    not copies of each other."""
    _, q = data
    index = _index("flat", 4, data)
    ex = SearchExecutor(RES, mesh_trace=True)
    sp = ivf_flat.IvfFlatSearchParams(n_probes=4)
    first, _ = _traced(ex, index, q[:12], sp)
    second, _ = _traced(ex, index, q[12:24], sp)
    assert [s.start for s in first] != [s.start for s in second]
    assert all(a.end <= b.start for a, b in zip(first, second))


def test_two_threads_each_read_their_own_slots(data):
    _, q = data
    index = _index("pq", 4, data)
    ex = SearchExecutor(RES, mesh_trace=True)
    sp = ivf_pq.IvfPqSearchParams(n_probes=4)
    ex.search(index, q[:8], K, params=sp)
    tracing.reset_spans()
    tids = [tracing.new_trace_id() for _ in range(2)]
    errors = []

    def run(t):
        try:
            for j in range(3):
                ex.search(index, q[8 * j:8 * j + 8], K, params=sp,
                          trace_ids=(tids[t],))
        except Exception as e:          # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    assert not errors
    rec = tracing.span_recorder()
    for tid in tids:
        shards = rec.spans(trace_id=tid, name="serving.mesh.shard")
        merges = rec.spans(trace_id=tid, name="serving.mesh.merge")
        assert len(shards) == 12 and len(merges) == 3
        for m in merges:
            own = [s for s in shards if s.start == m.start]
            assert [s.attrs["shard"] for s in own] == [0, 1, 2, 3]
            assert max(s.end for s in own) <= m.end


def test_untraced_and_ragged_dispatches_publish_no_slot(data):
    _, q = data
    index = _index("flat", 4, data)
    sp = ivf_flat.IvfFlatSearchParams(n_probes=4)
    tracing.reset_spans()
    SearchExecutor(RES).search(index, q[:12], K, params=sp)
    ragged = SearchExecutor(RES, mesh_trace=True, ragged_tile=64)
    ragged.search_ragged(index, [q[:5], q[5:12]], [K, K],
                         params_list=[sp, sp])
    assert not tracing.span_recorder().spans(name="serving.mesh.shard")


@pytest.mark.parametrize("offsets", [
    [], [0.5], [0.002, 0.009, 0.004], [3e-4, 3e-4, 1e-4, 7e-4],
    [1.0, 0.25, 1.0, 0.5, 0.125], [0.0, 0.0]])
def test_straggler_stats_equal_jax(offsets):
    assert tracing.straggler_stats(offsets) == \
        j_tracing.straggler_stats(offsets)
    assert tracing.straggler_stats(np.asarray(offsets)) == \
        j_tracing.straggler_stats(np.asarray(offsets))


def test_recorded_gauges_reduce_as_jax(data):
    """The gauges a traced dispatch sets are the JAX reduction of the
    readings its spans carry."""
    _, q = data
    index = _index("bq_codes", 4, data)
    ex = SearchExecutor(RES, mesh_trace=True)
    shards, _ = _traced(ex, index, q[:12],
                        ivf_bq.IvfBqSearchParams(n_probes=4))
    want = j_tracing.straggler_stats([s.duration for s in shards])
    g = tracing.gauges("serving.mesh.")
    assert g[tracing.MESH_SHARD_SKEW] == want["shard_skew"]
    assert g[tracing.MESH_SLOWEST_SHARD] == float(want["slowest_shard"])
    assert g[tracing.MESH_SHARD_TIME_MEAN] == want["mean_s"]
