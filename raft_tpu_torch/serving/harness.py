"""Fault-injection harness of the serving frontend — the port of
``raft_tpu/serving/harness.py``:

- :class:`ManualClock`: virtual time under test control. With
  ``DynamicBatcher(start=False)`` a test advances time and calls
  ``pump()``; nothing sleeps, so deadline expiry and dual-trigger timing
  are exact. In threaded mode the clock's ``wait`` is a rendezvous that
  :meth:`ManualClock.advance` wakes.
- :class:`FakeExecutor`: a device-free executor stand-in with the
  batcher-facing API (``coalesce_key`` / ``search_blocks`` /
  ``buckets``). Results encode the query rows (``indices[r, j]`` is
  ``queries[r, 0] * k + j``), so a mis-split is caught by value.
- :class:`ShimExecutor`: wraps any executor-like with scripted latency
  (charged to the injected clock) and scripted failures, plus a call
  log.
- :func:`burst_schedule` / :func:`drive_open_loop`: bursty *open-loop*
  load (submission times fixed in advance, independent of completions).

Not ported yet: the ragged methods (``FakeExecutor.ragged_key`` /
``search_ragged``, ``ShimExecutor.search_ragged``) and the shim's
scripted mesh shard timings, with the ragged plan family and the mesh
layer.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np


class ManualClock:
    """Deterministic virtual clock.

    ``now()`` returns the current virtual time; :meth:`advance` moves
    it forward and wakes any condition a batcher worker is parked on.
    ``wait`` ignores its timeout — virtual time only moves when the
    test says so, which is exactly what makes expiry tests exact."""

    def __init__(self, start: float = 0.0):
        self._t = start
        self._lock = threading.Lock()
        self._conds: List[threading.Condition] = []

    def now(self) -> float:
        with self._lock:
            return self._t

    def advance(self, dt: float) -> float:
        with self._lock:
            self._t += dt
            conds = list(self._conds)
            t = self._t
        for c in conds:
            with c:
                c.notify_all()
        return t

    def wait(self, cond: threading.Condition, timeout: Optional[float]):
        with self._lock:
            if cond not in self._conds:
                self._conds.append(cond)
        cond.wait()    # woken by advance()/submit()/close(), never time


class FakeExecutor:
    """Batcher-facing executor stand-in: no device, no plans.

    ``search_blocks`` returns, per block, ``distances[r, j] = (sum of
    row r) + j`` and ``indices[r, j] = int(queries[r, 0]) * k + j`` —
    row-identifying outputs, so a mis-split or cross-request mixup is
    caught by value. ``calls`` records every dispatched micro-batch as
    ``(n_blocks, total_rows)``."""

    def __init__(self):
        self.buckets = (8, 16, 32, 64, 128, 256)
        self.calls: List[Tuple[int, int]] = []

    def coalesce_key(self, index, k: int, params=None,
                     sample_filter=None, **kw) -> tuple:
        return (id(index), "fake", k, repr(params),
                tuple(sorted((n, str(v)) for n, v in kw.items())))

    def search_blocks(self, index, blocks, k: int, params=None,
                      sample_filter=None, **kw):
        self.calls.append((len(blocks),
                           sum(int(np.shape(b)[0]) for b in blocks)))
        out = []
        for b in blocks:
            b = np.asarray(b, np.float32)
            base = b.sum(axis=1, keepdims=True)
            d = base + np.arange(k, dtype=np.float32)[None, :]
            i = (b[:, :1].astype(np.int64) * k
                 + np.arange(k, dtype=np.int64)[None, :]).astype(np.int32)
            out.append((d, i))
        return out

class ShimExecutor:
    """Wrap an executor-like with scripted latency and failures.

    ``delay_s`` is charged to ``clock`` per ``search_blocks`` call
    (virtual clocks advance; real clocks sleep): the *slow executor* that
    makes queues pile up on demand. ``fail_on`` maps 0-based call
    ordinals to exceptions to raise instead of executing. The wrapped
    executor's results pass through untouched; ``calls`` logs
    ``(n_blocks, rows)`` per call."""

    def __init__(self, inner, *, delay_s: float = 0.0, clock=None,
                 fail_on: Optional[dict] = None):
        self.inner = inner
        self.delay_s = delay_s
        self.clock = clock
        self.fail_on = dict(fail_on or {})
        self.calls: List[Tuple[int, int]] = []

    @property
    def buckets(self):
        return self.inner.buckets

    def coalesce_key(self, *a, **kw):
        return self.inner.coalesce_key(*a, **kw)

    def search_blocks(self, index, blocks, k: int, **kw):
        ordinal = len(self.calls)
        self.calls.append((len(blocks),
                           sum(int(np.shape(b)[0]) for b in blocks)))
        if self.delay_s:
            if self.clock is not None and hasattr(self.clock, "advance"):
                self.clock.advance(self.delay_s)
            else:
                import time

                time.sleep(self.delay_s)
        if ordinal in self.fail_on:
            raise self.fail_on[ordinal]
        return self.inner.search_blocks(index, blocks, k, **kw)


def burst_schedule(n_bursts: int, burst_size: int, period_s: float,
                   start_s: float = 0.0) -> List[Tuple[float, int]]:
    """Open-loop burst plan: ``n_bursts`` bursts of ``burst_size``
    submissions, one burst every ``period_s`` seconds."""
    return [(start_s + i * period_s, burst_size) for i in range(n_bursts)]


def drive_open_loop(
    submit: Callable[[int, float], Any],
    schedule: Sequence[Tuple[float, int]],
    clock,
    pump: Optional[Callable[[], Any]] = None,
) -> List[Any]:
    """Run an open-loop load: at each scheduled virtual/wall time, call
    ``submit(request_ordinal, t)`` for every request of the burst —
    regardless of what completed. With a :class:`ManualClock`,
    ``clock.advance`` moves between bursts and ``pump`` (when given)
    runs the batcher's ready work after each burst; with a real clock
    the schedule is honored by sleeping. Returns everything ``submit``
    returned (handles), in submission order."""
    out: List[Any] = []
    ordinal = 0
    for t, n in schedule:
        dt = t - clock.now()
        if dt > 0:
            if hasattr(clock, "advance"):
                clock.advance(dt)
            else:
                import time

                time.sleep(dt)
        if pump is not None:
            pump()
        now = clock.now()
        for _ in range(n):
            out.append(submit(ordinal, now))
            ordinal += 1
        if pump is not None:
            pump()
    return out
