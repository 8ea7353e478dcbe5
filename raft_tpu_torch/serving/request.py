"""Request model of the serving frontend — the port of
``raft_tpu/serving/request.py``: a :class:`SearchRequest` (query block,
k, params, deadline, priority) and the future-style
:class:`ResultHandle` its caller blocks on.

Submission never waits for device work: the caller gets a handle at once
and the batcher completes it once the coalesced micro-batch has run.
Failure is always a typed exception on the handle: :class:`Overloaded`
(admission control rejected it), :class:`DeadlineExceeded` (it expired
in the queue and was shed before any device work), :class:`Cancelled`
(the caller cancelled it before batch assembly) or :class:`ShutDown`
(the batcher closed before it could run). On the ragged path a request
may split across packed tiles: it records which rows were claimed and
assembles its result once its last slice has landed.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core import tracing


class ServingError(RuntimeError):
    """Base class of every typed serving-frontend failure."""


class Overloaded(ServingError):
    """Admission control rejected the request (bounded queue full, or the
    load-shed ladder reached its reject rung)."""


class DeadlineExceeded(ServingError):
    """The request's deadline passed while it waited in the queue; it was
    shed before any device work was spent on it."""


class Cancelled(ServingError):
    """The caller cancelled the request before batch assembly."""


class ShutDown(ServingError):
    """The batcher shut down before the request could be dispatched."""


_PENDING = "pending"
_RUNNING = "running"
_DONE = "done"


class ResultHandle:
    """Future-style handle of one :class:`SearchRequest`.

    Lifecycle: *pending* (queued, cancellable) -> *running* (assembled
    into a micro-batch; no longer cancellable) -> *done* (result or typed
    exception set). Every transition happens under one lock, so a
    ``cancel()`` racing batch assembly has exactly one winner."""

    __slots__ = ("_lock", "_event", "_state", "_result", "_exception")

    def __init__(self):
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._state = _PENDING  # guarded-by: _lock
        self._result: Optional[Tuple[Any, Any]] = None
        self._exception: Optional[BaseException] = None

    # -- caller side --------------------------------------------------------

    def done(self) -> bool:
        """True once a result or exception is set."""
        return self._event.is_set()

    def cancelled(self) -> bool:
        """True iff the handle completed with :class:`Cancelled`."""
        return isinstance(self._exception, Cancelled)

    def cancel(self) -> bool:
        """Cancel if still pending. True when the cancellation won (the
        handle completes with :class:`Cancelled`); False when the request
        already entered batch assembly or completed."""
        with self._lock:
            if self._state != _PENDING:
                return False
            self._state = _DONE
            self._exception = Cancelled("request cancelled by caller")
        self._event.set()
        return True

    def result(self, timeout: Optional[float] = None) -> Tuple[Any, Any]:
        """Block until done; return ``(distances, indices)`` or raise the
        typed failure. ``TimeoutError`` if not done in time."""
        if not self._event.wait(timeout):
            raise TimeoutError("result not ready")
        if self._exception is not None:
            raise self._exception
        return self._result

    def exception(self, timeout: Optional[float] = None):
        """Block until done; return the typed exception (None on
        success)."""
        if not self._event.wait(timeout):
            raise TimeoutError("result not ready")
        return self._exception

    # -- batcher side -------------------------------------------------------

    def _try_start(self) -> bool:
        """pending -> running; False when a cancel (or a shed) won."""
        with self._lock:
            if self._state != _PENDING:
                return False
            self._state = _RUNNING
            return True

    def _set_result(self, distances, indices) -> bool:
        """Complete with a result (no-op if already done). True when this
        call completed the handle (the SLO accounting keys on it)."""
        with self._lock:
            if self._state == _DONE:
                return False
            self._state = _DONE
            self._result = (distances, indices)
        self._event.set()
        return True

    def _set_exception(self, exc: BaseException) -> bool:
        """Complete with a typed failure (no-op if already done). True
        when this call completed the handle."""
        with self._lock:
            if self._state == _DONE:
                return False
            self._state = _DONE
            self._exception = exc
        self._event.set()
        return True


_seq = itertools.count()


@dataclasses.dataclass
class SearchRequest:
    """One caller's query block and its scheduling attributes.

    ``deadline`` is absolute, in the batcher clock's domain; None means
    no deadline. Lower ``priority`` values are served first; within a
    priority class the queue is earliest-deadline-first, then FIFO by
    ``seq``. ``trace_id`` is minted at construction and rides every stage
    span the request touches."""

    index: Any
    queries: Any                      # (m, dim) host array or tensor
    k: int
    params: Any = None
    deadline: Optional[float] = None
    priority: int = 0
    sample_filter: Any = None
    kw: dict = dataclasses.field(default_factory=dict)
    handle: ResultHandle = dataclasses.field(default_factory=ResultHandle)
    # filled at admission
    compat_key: Any = None
    arrival: float = 0.0
    seq: int = dataclasses.field(default_factory=lambda: next(_seq))
    trace_id: int = dataclasses.field(default_factory=tracing.new_trace_id)
    # ragged continuous batching: a request may split across packed
    # tiles. ``taken`` rows were claimed by earlier tiles (the queue
    # holds the remainder; touched only under the admission queue's
    # lock); the slices' results gather in ``parts`` under their own
    # lock, since two dispatchers (the worker and a concurrent pump())
    # may deliver slices of one request, and ``add_part`` elects exactly
    # one assembler
    ragged: bool = False
    taken: int = 0
    parts: list = dataclasses.field(default_factory=list)
    _parts_lock: Any = dataclasses.field(default_factory=threading.Lock)
    _assembled: bool = False

    @property
    def rows(self) -> int:
        return int(np.shape(self.queries)[0])

    @property
    def rows_left(self) -> int:
        """Rows no packed tile has claimed yet (``rows`` unless a ragged
        split claimed some)."""
        return self.rows - self.taken

    def take(self, n: int) -> Tuple[int, int]:
        """Claim the next ``n`` rows for a packed tile; returns the
        claimed ``(start, stop)`` row range."""
        start = self.taken
        self.taken = start + n
        return start, self.taken

    def add_part(self, start: int, distances, indices) -> bool:
        """Record one claimed slice's results; True once every row has
        landed, for exactly one caller, who then assembles and completes
        the request."""
        with self._parts_lock:
            self.parts.append((start, distances, indices))
            if (self._assembled
                    or sum(p[1].shape[0] for p in self.parts) < self.rows):
                return False
            self._assembled = True
            return True

    def assemble(self):
        """The slices concatenated by row range into the request's
        ``(distances, indices)``: rows are independent, so the result
        equals an unsplit call's. Called only by ``add_part``'s winner."""
        self.parts.sort(key=lambda p: p[0])
        if len(self.parts) == 1:
            return self.parts[0][1], self.parts[0][2]
        if all(isinstance(p[1], np.ndarray) for p in self.parts):
            return (np.concatenate([p[1] for p in self.parts]),
                    np.concatenate([p[2] for p in self.parts]))
        return (torch.cat([torch.as_tensor(p[1]) for p in self.parts]),
                torch.cat([torch.as_tensor(p[2]) for p in self.parts]))

    def order_key(self) -> tuple:
        """EDF within priority (deadline-less requests after any
        deadline, then FIFO)."""
        d = self.deadline if self.deadline is not None else float("inf")
        return (self.priority, d, self.seq)

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline
