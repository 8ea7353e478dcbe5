"""The port's XSpace decoder (``core/xplane.py``) and its xplane ingestion
in ``core/profiling`` against the JAX package's, on the committed
``tests/data/graftfleet_capture.xplane.pb``: the same decoded planes,
the same device ops, and the same attribution; a capture directory that
holds only the ``.xplane.pb`` is read through it, one that holds a
chrome trace too through the chrome trace."""

import dataclasses
import os
import shutil

import pytest
import torch

import raft_tpu.core.profiling as j_profiling
import raft_tpu.core.xplane as j_xplane
from raft_tpu_torch.core import profiling, xplane

# one intra-op thread, as in every port test file: tier-1 runs the files
# in parallel workers
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
XPLANE = os.path.join(DATA, "graftfleet_capture.xplane.pb")
CHROME = os.path.join(DATA, "torch_profiler_capture.trace.json")
# the JAX package's mesh entry in the capture (tests/test_profiling.py)
COSTS = {"bbbb02bbbb02": {
    "hlo_module": "jit_rt_dist_ivf_flat_bbbb02bbbb02",
    "family": "dist_ivf_flat", "bucket": 16, "k": 5,
    "bytes_accessed": 1_300_000.0, "flops": 2_600_000.0}}


def _bytes():
    with open(XPLANE, "rb") as f:
        return f.read()


def _fields(op):
    return dataclasses.astuple(op)


def test_parse_xspace_equals_the_jax_decoder():
    data = _bytes()
    got = xplane.parse_xspace(data)
    assert got == j_xplane.parse_xspace(data)
    assert len(got["planes"]) == 3
    for plane in got["planes"]:
        for line in plane["lines"]:
            for ev in line["events"]:
                assert xplane.resolve_stats(ev, plane["stat_metadata"]) \
                    == j_xplane.resolve_stats(ev, plane["stat_metadata"])


@pytest.mark.parametrize("as_bytes", [False, True])
def test_parse_xplane_gives_the_jax_device_ops(as_bytes):
    src = _bytes() if as_bytes else XPLANE
    got = profiling.parse_xplane(src)
    want = j_profiling.parse_xplane(src)
    assert [f.name for f in dataclasses.fields(profiling.DeviceOp)] == [
        f.name for f in dataclasses.fields(j_profiling.DeviceOp)]
    assert [_fields(o) for o in got] == [_fields(o) for o in want]
    assert len(got) == 12
    assert [o.phase for o in got] == [o.phase for o in want]


def test_xplane_attribution_equals_the_jax_attribution():
    got = profiling.attribute(XPLANE, COSTS)
    want = j_profiling.attribute(XPLANE, COSTS)
    assert got.trace_file == want.trace_file == XPLANE
    g, w = got.modules["bbbb02bbbb02"], want.modules["bbbb02bbbb02"]
    assert g.device_seconds == pytest.approx(w.device_seconds, rel=1e-12)
    assert g.invocations == w.invocations == 2
    assert g.phase_seconds == pytest.approx(w.phase_seconds, rel=1e-12)
    assert g.shard_seconds == pytest.approx(w.shard_seconds, rel=1e-12)
    assert [x.skew for x in g.windows] == pytest.approx(
        [x.skew for x in w.windows], rel=1e-12)


def test_load_ops_takes_the_xplane_only_without_a_chrome_trace(tmp_path):
    run = tmp_path / "plugins" / "profile" / "r1"
    run.mkdir(parents=True)
    pb = str(run / "h.xplane.pb")
    shutil.copyfile(XPLANE, pb)
    ops, path = profiling.load_ops(str(tmp_path))
    j_ops, j_path = j_profiling.load_ops(str(tmp_path))
    assert path == j_path == pb
    assert [_fields(o) for o in ops] == [_fields(o) for o in j_ops]
    # a chrome trace beside it wins, whatever the mtimes say
    tr = str(run / "h.pt.trace.json")
    shutil.copyfile(CHROME, tr)
    os.utime(pb)
    ops, path = profiling.load_ops(str(tmp_path))
    assert path == tr
    assert [_fields(o) for o in ops] == [
        _fields(o) for o in profiling.parse_chrome_trace(
            profiling.load_trace(CHROME))]
    assert profiling.latest_trace_file(str(tmp_path)) == tr
    # a capture that rewrote only the xplane produced the xplane
    before = profiling.trace_snapshot(str(tmp_path))
    os.utime(pb, (os.path.getatime(pb), os.path.getmtime(pb) + 10))
    assert profiling.fresh_trace_file(str(tmp_path), before) == pb


def test_load_trace_stays_chrome_only(tmp_path):
    run = tmp_path / "plugins" / "profile" / "r1"
    run.mkdir(parents=True)
    shutil.copyfile(XPLANE, str(run / "h.xplane.pb"))
    with pytest.raises(FileNotFoundError, match="load_ops"):
        profiling.load_trace(str(tmp_path))
    with pytest.raises(ValueError, match="load_ops"):
        profiling.load_trace(str(run / "h.xplane.pb"))
    with pytest.raises(FileNotFoundError):
        profiling.load_ops(str(tmp_path / "plugins"))


def test_truncated_xplane_is_an_error():
    data = _bytes()
    with pytest.raises(ValueError):
        profiling.parse_xplane(data[:len(data) // 2])
    with pytest.raises(ValueError):
        j_profiling.parse_xplane(data[:len(data) // 2])
