"""The port's memory-profile parsing and diffing: snapshot dicts shaped
like ``torch.cuda.memory._snapshot()`` (segments of blocks, with the
frames ``_record_memory_history`` records), grouped by device, segment
and allocation site; the diff against the JAX package's
``diff_memory_profiles`` on the same groups (the output keys are the JAX
package's)."""

import pickle

import numpy as np
import pytest

import raft_tpu.core.memwatch as j_memwatch
from raft_tpu_torch.core import memwatch


def _frames(*sites):
    return [{"filename": f, "line": ln, "name": n} for f, ln, n in sites]


TORCH_FRAME = ("/usr/lib/python3/site-packages/torch/cuda/memory.py", 10,
               "alloc")
PORT_FRAME = ("/srv/raft_tpu_torch/core/executor.py", 900, "_call")


def _snapshot(extra_rows: int = 0):
    """Two devices; an index plane, a query block, a cached free block;
    ``extra_rows`` grows the index plane as an ``extend`` would."""
    blocks0 = [
        {"address": 0, "size": 4096 + 512 * extra_rows,
         "requested_size": 4000, "state": "active_allocated",
         "frames": _frames(TORCH_FRAME, ("/app/build.py", 12, "build"))},
        {"address": 8192, "size": 1024, "requested_size": 1000,
         "state": "active_allocated",
         "frames": _frames(PORT_FRAME, ("/app/serve.py", 40, "serve"))},
        {"address": 9216, "size": 2048, "requested_size": 0,
         "state": "inactive", "frames": []},
    ]
    blocks1 = [{"address": 0, "size": 512, "requested_size": 512,
                "state": "active_allocated", "frames": []}]
    return {"segments": [
        {"device": 0, "address": 0, "total_size": 1 << 20,
         "segment_type": "large", "blocks": blocks0},
        {"device": 1, "address": 0, "total_size": 1 << 16,
         "segment_type": "small", "blocks": blocks1}],
        "device_traces": []}


def test_parse_groups_allocated_blocks_by_site():
    got = memwatch.parse_memory_profile(_snapshot())
    assert got == {
        "device=0,segment=large,site=build@build.py:12": 4096,
        "device=0,segment=large,site=serve@serve.py:40": 1024,
        "device=1,segment=small,site=(none)": 512,
    }


def test_parse_takes_the_pickled_snapshot():
    snap = _snapshot()
    assert memwatch.parse_memory_profile(pickle.dumps(snap)) == \
        memwatch.parse_memory_profile(snap)
    assert memwatch.parse_memory_profile({"segments": []}) == {}


def test_diff_shows_the_extend_and_equals_jax():
    before = memwatch.parse_memory_profile(_snapshot())
    after = memwatch.parse_memory_profile(_snapshot(extra_rows=8))
    d = memwatch.diff_memory_profiles(before, after)
    assert d["deltas"] == [{
        "label": "device=0,segment=large,site=build@build.py:12",
        "from_bytes": 4096, "to_bytes": 4096 + 4096,
        "delta_bytes": 4096}]
    assert d["total_delta_bytes"] == 4096
    assert d == j_memwatch.diff_memory_profiles(before, after)


@pytest.mark.parametrize("seed", range(5))
def test_diff_ordering_equals_jax(seed):
    rng = np.random.default_rng(seed)
    keys = [f"device=0,segment=large,site=f{i}@a.py:{i}" for i in range(8)]
    before = {k: int(v) for k, v in zip(keys, rng.integers(0, 5, 8) * 256)
              if v}
    after = {k: int(v) for k, v in zip(keys, rng.integers(0, 5, 8) * 256)
             if v}
    assert memwatch.diff_memory_profiles(before, after) == \
        j_memwatch.diff_memory_profiles(before, after)


def test_the_port_s_own_modules_are_sites():
    """Only ``torch`` itself and the port's ``core`` are framework: an
    allocation made in ``raft_tpu_torch/neighbors`` is sited there."""
    snap = {"segments": [{"device": 0, "segment_type": "large", "blocks": [
        {"size": 256, "state": "active_allocated", "frames": _frames(
            ("/venv/lib/python3.12/site-packages/torch/nn/functional.py",
             3, "pad"),
            ("/srv/raft_tpu_torch/neighbors/ivf_flat.py", 250, "extend"),
            ("/app/main.py", 7, "grow"))}]}]}
    assert memwatch.parse_memory_profile(snap) == {
        "device=0,segment=large,site=extend@ivf_flat.py:250": 256}
