"""Serving frontend: dynamic batching in front of
:class:`~raft_tpu_torch.core.executor.SearchExecutor`, and tiered
placement policy — the port of ``raft_tpu/serving``'s request layer.

- :mod:`~raft_tpu_torch.serving.request`: :class:`SearchRequest` and the
  future-style :class:`ResultHandle`, with cancellation and typed
  failures (:class:`Overloaded`, :class:`DeadlineExceeded`,
  :class:`Cancelled`, :class:`ShutDown`).
- :mod:`~raft_tpu_torch.serving.batcher`: :class:`DynamicBatcher`, a
  background micro-batcher with a dual dispatch trigger (max-wait timer
  or bucket-full) that coalesces compatible requests and splits the
  results back per request.
- :mod:`~raft_tpu_torch.serving.admission`: bounded queue with
  backpressure, EDF within priority, deadline shedding and the load-shed
  ladder (:class:`LoadShed`).
- :mod:`~raft_tpu_torch.serving.metrics`: per-stage latency histograms,
  throughput, shed and occupancy counters, the SLO window and the
  multiwindow burn-rate alert.
- :mod:`~raft_tpu_torch.serving.harness`: the manual clock, executor
  shims and open-loop load the deterministic tests drive.
- :mod:`~raft_tpu_torch.serving.placement`: the tiered index's epoch
  planner and :class:`~raft_tpu_torch.serving.placement.TierManager`,
  which runs its epochs on live traffic.
- :mod:`~raft_tpu_torch.serving.prefetch`: the forecast and the staged
  promotions ahead of an epoch (:class:`~raft_tpu_torch.serving.prefetch
  .TierPrefetcher`).

Not ported yet: ``continuous``, ``exporter``, ``flight``, ``gauge`` and
``federation`` (ROADMAP Queue 1).
"""

from raft_tpu_torch.serving.admission import AdmissionQueue, LoadShed
from raft_tpu_torch.serving.batcher import (
    AdaptiveWait,
    BatcherConfig,
    DynamicBatcher,
    MonotonicClock,
)
from raft_tpu_torch.serving.metrics import (
    MultiBurnAlert,
    MultiBurnConfig,
    SloConfig,
    SloWindow,
)
from raft_tpu_torch.serving.request import (
    Cancelled,
    DeadlineExceeded,
    Overloaded,
    ResultHandle,
    SearchRequest,
    ServingError,
    ShutDown,
)

__all__ = [
    "AdaptiveWait",
    "AdmissionQueue",
    "BatcherConfig",
    "Cancelled",
    "DeadlineExceeded",
    "DynamicBatcher",
    "LoadShed",
    "MonotonicClock",
    "MultiBurnAlert",
    "MultiBurnConfig",
    "Overloaded",
    "ResultHandle",
    "SearchRequest",
    "ServingError",
    "ShutDown",
    "SloConfig",
    "SloWindow",
]
