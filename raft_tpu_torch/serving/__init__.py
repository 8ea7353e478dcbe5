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
- :mod:`~raft_tpu_torch.serving.exporter`: :class:`MetricsExporter`, the
  one HTTP scrape surface (``/metrics``, ``/snapshot.json``,
  ``/trace.json``, ``/profile``, ``/incident.json``, ``/memory.json``,
  ``/memory_profile``, ``/tier.json``, ``/index.json``, ``/fleet.json``,
  ``/route.json``, ``/push``, ``/healthz``).
- :mod:`~raft_tpu_torch.serving.flight`: :class:`FlightRecorder`, the
  incident capture its triggers arm (multiburn, latency anomaly, low
  headroom), with on-disk bundles.
- :mod:`~raft_tpu_torch.serving.continuous`: :class:`ContinuousCapture`,
  low-duty-cycle profiler windows folded into the rolling attribution.
- :mod:`~raft_tpu_torch.serving.gauge`: :class:`IndexGauge` (index
  health, shadow recall through :class:`ShadowSampler`, drift through
  :class:`DriftDetector`).
- :mod:`~raft_tpu_torch.serving.federation`: :class:`FleetAggregator`,
  one merged view over several replicas' exporters.

Works for single-device and list-sharded (``Distributed*``) indexes
alike: the batcher only talks to the executor API. The fleet layer above
it (:mod:`raft_tpu_torch.fleet`: routing table, planner, router, harness)
attaches to the exporter as ``MetricsExporter(route=QueryRouter(...))``,
which arms ``/route.json`` and ``POST /push?route=1``.
"""

from raft_tpu_torch.serving.admission import AdmissionQueue, LoadShed
from raft_tpu_torch.serving.batcher import (
    AdaptiveWait,
    BatcherConfig,
    DynamicBatcher,
    MonotonicClock,
)
from raft_tpu_torch.serving.continuous import (
    ContinuousCapture,
    ContinuousConfig,
)
from raft_tpu_torch.serving.exporter import MetricsExporter
from raft_tpu_torch.serving.federation import (
    FleetAggregator,
    FleetConfig,
    ProbePlaneView,
    ReplicaHeadroom,
)
from raft_tpu_torch.serving.flight import (
    FlightConfig,
    FlightRecorder,
    LatencyAnomaly,
)
from raft_tpu_torch.serving.gauge import (
    DriftDetector,
    IndexGauge,
    RecallWindow,
    ShadowConfig,
    ShadowSampler,
)
from raft_tpu_torch.serving.metrics import (
    MultiBurnAlert,
    MultiBurnConfig,
    SloConfig,
    SloWindow,
)
from raft_tpu_torch.serving.placement import (
    PlacementConfig,
    PlacementPlan,
    TierManager,
    plan_epoch,
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
    "ContinuousCapture",
    "ContinuousConfig",
    "DeadlineExceeded",
    "DriftDetector",
    "DynamicBatcher",
    "FleetAggregator",
    "FleetConfig",
    "FlightConfig",
    "FlightRecorder",
    "IndexGauge",
    "LatencyAnomaly",
    "LoadShed",
    "MetricsExporter",
    "MonotonicClock",
    "MultiBurnAlert",
    "MultiBurnConfig",
    "Overloaded",
    "PlacementConfig",
    "PlacementPlan",
    "ProbePlaneView",
    "RecallWindow",
    "ReplicaHeadroom",
    "ResultHandle",
    "SearchRequest",
    "ServingError",
    "ShadowConfig",
    "ShadowSampler",
    "ShutDown",
    "SloConfig",
    "SloWindow",
    "TierManager",
    "plan_epoch",
]
