"""The port's resources manager: one shared handle a device however many
threads ask at once, set-then-freeze defaults, the JAX package's names,
and no handle cached when CUDA is asked for and absent."""

from __future__ import annotations

import os
import sys
import threading
import time

import pytest
import torch

import raft_tpu.core.resources as jres
from raft_tpu_torch.core import resources as tres

# one intra-op thread: tier-1 runs the test files in parallel workers,
# and a torch pool of one thread a core in each worker oversubscribes
# the cores (about 5x slower under the full run)
torch.set_num_threads(1)


def _slow_cpu_handles(monkeypatch):
    """A fresh process manager whose handles land on the CPU, each taking
    10 ms to build (to widen any race); returns the list of built ones."""
    built = []

    class Slow(tres.Resources):
        def __init__(self, device="cuda", **kw):
            time.sleep(0.01)
            super().__init__(device="cpu", **kw)
            built.append(self)

    monkeypatch.setattr(tres, "Resources", Slow)
    monkeypatch.setattr(tres, "resources_manager", tres.ResourcesManager())
    return built


def _from_threads(fn, n):
    """``fn()`` from ``n`` threads released at once, with a short switch
    interval; each join bounded."""
    out = [None] * n
    go = threading.Barrier(n)

    def run(i):
        go.wait(timeout=30)
        out[i] = fn()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    return out


def test_threads_share_one_default_handle(monkeypatch):
    built = _slow_cpu_handles(monkeypatch)
    n = 2 * (os.cpu_count() or 4) + 8
    got = _from_threads(lambda: tres.ensure_resources(None), n)
    assert len(built) == 1 and all(h is built[0] for h in got)
    assert tres.get_default_resources() is built[0]
    mine = tres.Resources(device="cpu")
    assert tres.ensure_resources(mine) is mine


def test_defaults_are_set_then_frozen():
    m = tres.ResourcesManager()
    m.set_seed(7)
    m.set_workspace_limit_bytes(1 << 20)
    m.set_matmul_precision("bfloat16")
    m.set_compilation_cache_dir("ignored")
    h = m.get_device_resources("cpu")
    assert (h.seed, h.workspace_limit_bytes, h.matmul_precision) == \
        (7, 1 << 20, "bfloat16")
    assert torch.equal(torch.rand(3, generator=h.generator),
                       torch.rand(3, generator=torch.Generator().manual_seed(
                           7)))
    with pytest.warns(RuntimeWarning, match="frozen"):
        m.set_seed(9)
    assert m.get_device_resources(torch.device("cpu")) is h
    assert m.get_device_resources("cpu").seed == 7


def test_missing_card_raises_and_caches_nothing():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the request is valid here")
    m = tres.ResourcesManager()
    for device in (None, 0, "cuda"):
        with pytest.raises(RuntimeError, match="cuda"):
            m.get_device_resources(device)
    assert not m._handles
    m.set_seed(3)       # not frozen: nothing was built


def test_names_mirror_the_reference():
    for name in ("ResourcesManager", "resources_manager",
                 "get_default_resources", "ensure_resources",
                 "DeviceResources"):
        assert hasattr(jres, name) and hasattr(tres, name)
    assert tres.DeviceResources is tres.Resources
    for name in ("set_seed", "set_matmul_precision",
                 "set_workspace_limit_bytes", "set_compilation_cache_dir",
                 "get_device_resources"):
        assert callable(getattr(tres.ResourcesManager, name))
