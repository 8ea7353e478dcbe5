"""Profiling ranges (``common::nvtx::range``) and the process-wide
counter and gauge registry.

The span names are the JAX package's (``raft_tpu.ivf_flat.search``, ...),
so a ``torch.profiler`` trace of the port lines up with a trace of the
reference. Counters and gauges keep the JAX package's names and
semantics (``raft_tpu/core/tracing.py``): counters only grow (the tiered
swap counts ``tier.swaps``, ``tier.swap_bytes``,
``tier.promote_cold_bytes``; the capacity gate ``memory.gate.*``), gauges
hold the last value set. Spans, histograms and the lifetime ledger are
not ported yet.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict

import torch


@contextlib.contextmanager
def range(name: str):  # noqa: A001 - mirrors the reference name
    """A named span in ``torch.profiler`` traces."""
    with torch.profiler.record_function(name):
        yield


_counters: Dict[str, float] = {}  # guarded-by: _counters_lock
_gauges: Dict[str, float] = {}    # guarded-by: _counters_lock
_counters_lock = threading.Lock()


def inc_counter(name: str, amount: float = 1.0) -> None:
    """Add ``amount`` to a named process-wide counter (creates it at 0)."""
    with _counters_lock:
        _counters[name] = _counters.get(name, 0.0) + amount


def inc_counters(amounts: Dict[str, float]) -> None:
    """Add several counters under one lock acquisition."""
    with _counters_lock:
        for name, amount in amounts.items():
            _counters[name] = _counters.get(name, 0.0) + amount


def get_counter(name: str) -> float:
    """Current value of a counter (0.0 if never incremented)."""
    with _counters_lock:
        return _counters.get(name, 0.0)


def counters(prefix: str = "") -> dict:
    """Snapshot of all counters whose name starts with ``prefix``."""
    with _counters_lock:
        return {k: v for k, v in _counters.items() if k.startswith(prefix)}


def set_gauge(name: str, value: float) -> None:
    """Set a named process-wide gauge to ``value`` (last write wins)."""
    with _counters_lock:
        _gauges[name] = value


def gauges(prefix: str = "") -> dict:
    """Snapshot of all gauges whose name starts with ``prefix``."""
    with _counters_lock:
        return {k: v for k, v in _gauges.items() if k.startswith(prefix)}


def reset_gauges(prefix: str = "") -> None:
    """Drop gauges matching ``prefix``."""
    with _counters_lock:
        for k in [k for k in _gauges if k.startswith(prefix)]:
            del _gauges[k]
