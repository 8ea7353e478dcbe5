"""Logging — port of ``raft_tpu/core/logger.py``, the analog of the
reference's spdlog-backed ``raft::logger``.

Reference: ``core/logger-inl.hpp:74-160`` (singleton, levels TRACE..OFF,
pattern, callback sink). A thin veneer over :mod:`logging` with the same
level vocabulary, a callback-sink hook, and trace-vector dumping
(``RAFT_LOG_TRACE_VEC``). The logger is ``raft_tpu_torch``'s own, so the
two packages' levels are set apart.
"""

from __future__ import annotations

import enum
import logging
import sys
from typing import Callable, Optional

import numpy as np
import torch


class LogLevel(enum.IntEnum):
    """Mirrors RAFT_LEVEL_* (reference ``core/logger-macros.hpp``)."""

    OFF = 0
    CRITICAL = 1
    ERROR = 2
    WARN = 3
    INFO = 4
    DEBUG = 5
    TRACE = 6


_LEVEL_TO_PY = {
    LogLevel.OFF: logging.CRITICAL + 10,
    LogLevel.CRITICAL: logging.CRITICAL,
    LogLevel.ERROR: logging.ERROR,
    LogLevel.WARN: logging.WARNING,
    LogLevel.INFO: logging.INFO,
    LogLevel.DEBUG: logging.DEBUG,
    LogLevel.TRACE: logging.DEBUG - 5,
}

logger = logging.getLogger("raft_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("[%(levelname)s] [%(asctime)s] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.WARNING)

_callback: Optional[Callable[[int, str], None]] = None


def set_level(level: LogLevel | int) -> None:
    """Set the package's log level (``logger::set_level``, reference
    ``core/logger-inl.hpp:103``)."""
    logger.setLevel(_LEVEL_TO_PY[LogLevel(level)])


def get_level() -> LogLevel:
    py = logger.getEffectiveLevel()
    best = LogLevel.OFF
    for lvl, pyl in _LEVEL_TO_PY.items():
        if pyl >= py and (best == LogLevel.OFF or pyl < _LEVEL_TO_PY[best]):
            best = lvl
    return best


def set_callback(cb: Optional[Callable[[int, str], None]]) -> None:
    """Install a callback sink (analog of the spdlog callback sink the
    reference uses to route C++ logs into Python logging)."""
    global _callback
    _callback = cb


def _emit(level: LogLevel, msg: str, *args) -> None:
    text = msg % args if args else msg
    if _callback is not None:
        _callback(int(level), text)
    logger.log(_LEVEL_TO_PY[level], "%s", text)


def trace(msg, *args):
    _emit(LogLevel.TRACE, msg, *args)


def debug(msg, *args):
    _emit(LogLevel.DEBUG, msg, *args)


def info(msg, *args):
    _emit(LogLevel.INFO, msg, *args)


def warn(msg, *args):
    _emit(LogLevel.WARN, msg, *args)


def error(msg, *args):
    _emit(LogLevel.ERROR, msg, *args)


def trace_vec(name: str, vec, limit: int = 16) -> None:
    """Dump the head of a vector at TRACE level (analog of
    ``RAFT_LOG_TRACE_VEC``); a device tensor is read back only when TRACE
    is on."""
    if logger.isEnabledFor(_LEVEL_TO_PY[LogLevel.TRACE]):
        if isinstance(vec, torch.Tensor):
            vec = vec.detach().reshape(-1)[:limit].cpu().numpy()
        head = np.asarray(vec).reshape(-1)[:limit]
        _emit(LogLevel.TRACE, "%s = %s", name, np.array2string(head, precision=4))
