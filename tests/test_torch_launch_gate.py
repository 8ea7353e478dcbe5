"""The gate between the executor's dispatches and the profiler turning on
or off (``core/profiling.launching`` / ``_quiesced``): on the card,
``torch.profiler``'s stop deadlocked with a CUDA graph replay launched on
another thread at that moment, so a dispatch's device work and the
profiler's start and stop never overlap. Threads here stand in for the
batcher and the capturing thread; every wait is bounded.
"""

import threading
import time

import numpy as np

from raft_tpu_torch import Resources, SearchExecutor
from raft_tpu_torch.core import profiling
from raft_tpu_torch.neighbors import ivf_flat


def _in_thread(fn):
    t = threading.Thread(target=fn, daemon=True)
    t.start()
    return t


def test_toggle_waits_for_the_dispatch_under_way():
    inside, release, toggled = (threading.Event() for _ in range(3))

    def dispatch():
        with profiling.launching():
            inside.set()
            release.wait(timeout=30)

    def toggle():
        with profiling._quiesced():
            toggled.set()

    d = _in_thread(dispatch)
    assert inside.wait(timeout=30)
    t = _in_thread(toggle)
    time.sleep(0.1)
    assert not toggled.is_set()          # held back by the dispatch
    release.set()
    assert toggled.wait(timeout=30)
    for th in (d, t):
        th.join(timeout=30)
        assert not th.is_alive()


def test_dispatch_waits_while_the_profiler_turns():
    toggling, release, dispatched = (threading.Event() for _ in range(3))

    def toggle():
        with profiling._quiesced():
            toggling.set()
            release.wait(timeout=30)

    def dispatch():
        with profiling.launching():
            dispatched.set()

    t = _in_thread(toggle)
    assert toggling.wait(timeout=30)
    d = _in_thread(dispatch)
    time.sleep(0.1)
    assert not dispatched.is_set()       # held back while turning
    release.set()
    assert dispatched.wait(timeout=30)
    for th in (d, t):
        th.join(timeout=30)
        assert not th.is_alive()


def test_sessions_over_concurrent_searches(tmp_path):
    """Sessions start and stop while four threads search through one
    executor: every search returns its direct result and every session
    writes its trace."""
    res = Resources(device="cpu", seed=0)
    rng = np.random.default_rng(2)
    x = rng.integers(-4, 5, (2000, 16)).astype(np.float32)
    q = rng.integers(-4, 5, (64, 16)).astype(np.float32)
    index = ivf_flat.build(res, ivf_flat.IvfFlatIndexParams(n_lists=16), x)
    sp = ivf_flat.IvfFlatSearchParams(n_probes=4)
    ex = SearchExecutor(res)
    ex.warmup(index, buckets=(8,), k=5, params=sp)
    want = ex.search(index, q[:8], 5, params=sp)
    stop = threading.Event()
    bad = []

    def pump():
        while not stop.is_set():
            got = ex.search(index, q[:8], 5, params=sp)
            if not (np.array_equal(got[0], want[0])
                    and np.array_equal(got[1], want[1])):
                bad.append(got)

    pumps = [_in_thread(pump) for _ in range(4)]
    caps = []
    for j in range(3):
        with profiling.session(str(tmp_path / f"s{j}")) as cap:
            time.sleep(0.02)
        caps.append(cap)
    stop.set()
    for th in pumps:
        th.join(timeout=60)
        assert not th.is_alive()
    assert not bad
    assert all(c.path is not None for c in caps)
