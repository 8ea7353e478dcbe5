"""The memory ledger's scrape surface in the port against the JAX
package's, on the CPU: a JAX ``MemoryLedger`` watching a JAX-built
IVF-Flat index and a port ledger watching its port copy (the same
arrays) give ``snapshot``, ``federation_payload`` and ``publish``
results with the same keys, gauge names and byte values; with a
probe-accounting executor attached to each, the forecast carries the
executor's terms under the same names, the probe planes' bytes equal,
and every dispatch counts one ``memory.samples``. Neither side has live
device statistics here (``supported`` False on both).
"""

from __future__ import annotations

import numpy as np
import pytest

from raft_tpu.core import memwatch as j_memwatch
from raft_tpu.core import tracing as j_tracing
from raft_tpu.core.executor import SearchExecutor as JaxExecutor
from raft_tpu.neighbors import ivf_flat as j_ivf
from raft_tpu_torch import Resources
from raft_tpu_torch.core import memwatch, tracing
from raft_tpu_torch.core.executor import SearchExecutor
from raft_tpu_torch.neighbors import ivf_flat

RES = Resources(device="cpu")
CAPACITY = 64e6


@pytest.fixture(scope="module")
def indexes():
    rng = np.random.default_rng(2)
    x = rng.integers(-4, 5, (1200, 16)).astype(np.float32)
    jidx = j_ivf.build(None, j_ivf.IvfFlatIndexParams(n_lists=12), x)
    pidx = ivf_flat.from_numpy(
        np.array(jidx.centers), np.array(jidx.data), np.array(jidx.indices),
        np.array(jidx.list_sizes), res=RES)
    q = rng.integers(-4, 5, (20, 16)).astype(np.float32)
    return jidx, pidx, q


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) and k != "devices" else None
            for k, v in d.items()}


def _ledgers(indexes, **kw):
    jidx, pidx, _ = indexes
    jl = j_memwatch.MemoryLedger(capacity_bytes=CAPACITY, **kw.get("j", {}))
    pl = memwatch.MemoryLedger(capacity_bytes=CAPACITY, **kw.get("p", {}))
    assert jl.watch("sift flat", jidx) == pl.watch("sift flat", pidx)
    return jl, pl


def test_snapshot_and_federation_payload_equal_the_reference(indexes):
    jl, pl = _ledgers(indexes)
    snap, jsnap = pl.snapshot(), jl.snapshot()
    assert _keys(snap) == _keys(jsnap)
    assert snap["supported"] is False and jsnap["supported"] is False
    for key in ("resident_total_bytes", "host_resident_total_bytes",
                "headroom_bytes", "divergence_bytes", "capacity_bytes",
                "reserved_held_bytes", "watermark"):
        assert snap[key] == jsnap[key], key
    assert snap["forecast"] == jsnap["forecast"]
    model, jmodel = snap["indexes"]["sift-flat"], jsnap["indexes"][
        "sift-flat"]
    for key in ("resident_bytes", "shard_resident_bytes",
                "host_resident_bytes", "per_device_bytes"):
        assert model[key] == jmodel[key], key
    fed, jfed = pl.federation_payload(), jl.federation_payload()
    assert fed == jfed
    pl.reserve("tier.prefetch", 1000)
    jl.reserve("tier.prefetch", 1000)
    assert pl.snapshot()["headroom_bytes"] == jl.snapshot()[
        "headroom_bytes"]


def test_publish_sets_the_reference_gauges(indexes):
    jl, pl = _ledgers(indexes)
    tracing.reset_gauges("memory.")
    j_tracing.reset_gauges("memory.")
    snap, jsnap = pl.publish(), jl.publish()
    gauges, jgauges = tracing.gauges("memory."), j_tracing.gauges("memory.")
    assert set(gauges) == set(jgauges)
    assert "memory.index.sift-flat.resident_bytes" in gauges
    for name, value in jgauges.items():
        assert gauges[name] == pytest.approx(value), name
    # the published snapshot is what federation reuses
    assert pl.last_snapshot is snap and jl.last_snapshot is jsnap
    pl.unwatch("sift-flat")
    jl.unwatch("sift-flat")
    assert tracing.gauges("memory.index.") == {} == j_tracing.gauges(
        "memory.index.")


def test_executor_terms_and_dispatch_samples(indexes):
    jidx, pidx, q = indexes
    jex = JaxExecutor(None, probe_accounting=True)
    pex = SearchExecutor(RES, probe_accounting=True)
    jl, pl = _ledgers(indexes, j={"executor": jex}, p={"executor": pex})
    assert pl.executor is pex and pex._memwatch is pl
    j0 = j_tracing.get_counter(j_memwatch.SAMPLES)
    p0 = tracing.get_counter(memwatch.SAMPLES)
    for _ in range(3):
        jex.search(jidx, q, 5, params=j_ivf.IvfFlatSearchParams(n_probes=3))
        pex.search(pidx, q, 5,
                   params=ivf_flat.IvfFlatSearchParams(n_probes=3))
    assert j_tracing.get_counter(j_memwatch.SAMPLES) - j0 == 3
    assert tracing.get_counter(memwatch.SAMPLES) - p0 == 3
    fc, jfc = pl.forecast(), jl.forecast()
    assert set(fc) == set(jfc)
    assert fc["probe_plane_bytes"] == jfc["probe_plane_bytes"] == 12 * 4
    assert fc["resident_bytes"] == jfc["resident_bytes"]
    res = pex.memory_reservations()
    assert {"donated_state_bytes", "probe_plane_bytes",
            "max_temp_bytes"} <= set(res)
    # eager plans hold no static buffers and no graph pool
    assert res["donated_state_bytes"] == {} and res["max_temp_bytes"] == 0
    assert _keys(pl.snapshot()) == _keys(jl.snapshot())
