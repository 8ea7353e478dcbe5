"""Fault-injection harness of the serving frontend — the port of
``raft_tpu/serving/harness.py``:

- :class:`ManualClock`: virtual time under test control. With
  ``DynamicBatcher(start=False)`` a test advances time and calls
  ``pump()``; nothing sleeps, so deadline expiry and dual-trigger timing
  are exact. In threaded mode the clock's ``wait`` is a rendezvous that
  :meth:`ManualClock.advance` wakes.
- :class:`FakeExecutor`: a device-free executor stand-in with the
  batcher-facing API (``coalesce_key`` / ``search_blocks`` /
  ``buckets``, and the ragged ``ragged_key`` / ``search_ragged`` /
  ``ragged_tile``). Results encode the query rows (``indices[r, j]`` is
  ``queries[r, 0] * k + j``), so a mis-split is caught by value.
- :class:`ShimExecutor`: wraps any executor-like with scripted latency
  (charged to the injected clock) and scripted failures, plus a call
  log.
- :func:`burst_schedule` / :func:`drive_open_loop`: bursty *open-loop*
  load (submission times fixed in advance, independent of completions).
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
    ``(n_blocks, total_rows)``, ``ragged_calls`` every packed dispatch as
    ``(n_slices, claimed_rows)``."""

    def __init__(self, ragged_tile: int = 8):
        self.buckets = (8, 16, 32, 64, 128, 256)
        self.ragged_tile = ragged_tile
        self.calls: List[Tuple[int, int]] = []
        self.ragged_calls: List[Tuple[int, int]] = []

    def coalesce_key(self, index, k: int, params=None,
                     sample_filter=None, **kw) -> tuple:
        return (id(index), "fake", k, repr(params),
                tuple(sorted((n, str(v)) for n, v in kw.items())))

    def ragged_key(self, index, k: int, params=None, sample_filter=None,
                   **kw):
        """Everything packs (mixed k too: the fake's params class is the
        index and params) unless the index says ``bucketed_only = True``,
        the tests' stand-in for the executor's non-raggable residue."""
        if getattr(index, "bucketed_only", False):
            return None
        return (id(index), "fake_ragged", repr(params),
                tuple(sorted((n, str(v)) for n, v in kw.items())))

    @staticmethod
    def _rows_out(b, k: int):
        b = np.asarray(b, np.float32)
        d = b.sum(axis=1, keepdims=True) + np.arange(
            k, dtype=np.float32)[None, :]
        i = (b[:, :1].astype(np.int64) * k
             + np.arange(k, dtype=np.int64)[None, :]).astype(np.int32)
        return d, i

    def search_blocks(self, index, blocks, k: int, params=None,
                      sample_filter=None, **kw):
        self.calls.append((len(blocks),
                           sum(int(np.shape(b)[0]) for b in blocks)))
        return [self._rows_out(b, k) for b in blocks]

    def search_ragged(self, index, blocks, ks, params_list=None,
                      sample_filter=None, **kw):
        """The packed path: ``search_blocks``' formula with each block's
        own ``k``."""
        if not isinstance(ks, (list, tuple)):
            ks = [ks] * len(blocks)
        self.ragged_calls.append(
            (len(blocks), sum(int(np.shape(b)[0]) for b in blocks)))
        return [self._rows_out(b, k) for b, k in zip(blocks, ks)]


class ShimExecutor:
    """Wrap an executor-like with scripted latency and failures.

    ``delay_s`` is charged to ``clock`` per ``search_blocks`` or
    ``search_ragged`` call (virtual clocks advance; real clocks sleep):
    the *slow executor* that makes queues pile up on demand. ``fail_on``
    maps 0-based call ordinals (of both entries) to exceptions to raise
    instead of executing. The wrapped executor's results pass through
    untouched; ``calls`` logs ``(n_blocks, rows)`` per call.

    ``shard_times`` scripts per-shard mesh timings: a sequence of
    per-shard seconds applied to every ``search_blocks`` call, or a dict
    of 0-based call ordinal -> sequence. Each scripted call records them
    through :func:`raft_tpu_torch.core.tracing.record_mesh_spans` at the
    injected clock's time, as a mesh dispatch would, so the
    ``serving.mesh.*`` straggler gauges are pinned to the script."""

    def __init__(self, inner, *, delay_s: float = 0.0, clock=None,
                 fail_on: Optional[dict] = None, shard_times=None):
        self.inner = inner
        self.delay_s = delay_s
        self.clock = clock
        self.fail_on = dict(fail_on or {})
        self.shard_times = shard_times
        self.calls: List[Tuple[int, int]] = []

    @property
    def buckets(self):
        return self.inner.buckets

    @property
    def ragged_tile(self):
        return getattr(self.inner, "ragged_tile", 256)

    def coalesce_key(self, *a, **kw):
        return self.inner.coalesce_key(*a, **kw)

    def ragged_key(self, *a, **kw):
        inner = getattr(self.inner, "ragged_key", None)
        return inner(*a, **kw) if inner is not None else None

    def _charge_call(self, blocks) -> int:
        """The scripted latency and failure of one call, either entry;
        returns the call's 0-based ordinal."""
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
        return ordinal

    def search_blocks(self, index, blocks, k: int, **kw):
        ordinal = self._charge_call(blocks)
        times = self.shard_times
        if isinstance(times, dict):
            times = times.get(ordinal)
        if times:
            from raft_tpu_torch.core import tracing

            t0 = self.clock.now() if self.clock is not None else 0.0
            tracing.record_mesh_spans(
                "shim", t0, t0 + max(times),
                trace_ids=tuple(kw.get("trace_ids", ())),
                shard_timings=list(times))
        return self.inner.search_blocks(index, blocks, k, **kw)

    def search_ragged(self, index, blocks, ks, **kw):
        self._charge_call(blocks)
        return self.inner.search_ragged(index, blocks, ks, **kw)


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
