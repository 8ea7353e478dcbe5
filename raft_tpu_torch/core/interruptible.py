"""Cooperative cancellation — analog of ``raft::interruptible``; port of
``raft_tpu/core/interruptible.py``.

Reference: ``core/interruptible.hpp:39-123`` — a per-thread token
registry letting one thread cancel another thread's blocking waits. Long
host-side loops (the streaming index builds, chunk by chunk)
check it: ``synchronize``/``yield_`` test the calling thread's token and
raise ``InterruptedException``; ``cancel(thread_id)`` sets it from any
thread.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

_tokens: dict[int, threading.Event] = {}
_lock = threading.Lock()


class InterruptedException(RuntimeError):
    """Raised at a cancellation point (``raft::interruptible::interrupted_exception``)."""


def _token(tid: Optional[int] = None) -> threading.Event:
    tid = tid if tid is not None else threading.get_ident()
    with _lock:
        if tid not in _tokens:
            _tokens[tid] = threading.Event()
        return _tokens[tid]


def cancel(thread_id: Optional[int] = None) -> None:
    """Flag a thread for cancellation (``interruptible::cancel``)."""
    _token(thread_id).set()


def yield_() -> None:
    """Cancellation point: raise if this thread was cancelled, clearing
    the flag (``interruptible::yield``)."""
    tok = _token()
    if tok.is_set():
        tok.clear()
        raise InterruptedException("raft_tpu: thread execution interrupted")


def yield_no_throw() -> bool:
    """Non-throwing check (``interruptible::yield_no_throw``)."""
    tok = _token()
    if tok.is_set():
        tok.clear()
        return True
    return False


def synchronize(*tensors) -> None:
    """Interruptible device sync (``interruptible::synchronize``,
    ``core/interruptible.hpp:83``): wait for the card when any tensor
    lies on it, then hit a cancellation point."""
    if any(isinstance(t, torch.Tensor) and t.device.type == "cuda"
           for t in tensors):
        torch.cuda.synchronize()
    yield_()
