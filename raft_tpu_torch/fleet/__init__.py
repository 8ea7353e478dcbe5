"""Fleet placement planning and content-aware routing — port of
``raft_tpu/fleet``.

The layer above one replica's serving stack: the federation
(:class:`~raft_tpu_torch.serving.federation.FleetAggregator`) merges
probe planes, traffic and memory fleet-wide; per-replica placement is
a pure epoch function executed as fixed-width swaps with no new
capture (:func:`raft_tpu_torch.neighbors.tiered.apply_plan`); the
cross-replica merge has an exact contract. This package closes the
loop — N identical replicas become a distributed cache hierarchy:

- :mod:`~raft_tpu_torch.fleet.planner` — the pure fleet placement
  function (merged probe plane × headroom → per-replica hot sets
  with traffic-driven replication) plus ``apply_plan``-shaped
  rebalance deltas and prefetch staging hints;
- :mod:`~raft_tpu_torch.fleet.table` — the versioned, diffable,
  byte-canonical routing table (served at ``/route.json``, pushed
  over the federation channel);
- :mod:`~raft_tpu_torch.fleet.router` — coverage-steered request routing
  with exact ownership fan-out and the quantized merge wire;
- :mod:`~raft_tpu_torch.fleet.harness` — the device-free multi-replica
  test fleet (manual clock, scripted deaths).
"""

from raft_tpu_torch.fleet.harness import (
    FleetFakeExecutor,
    FleetHarness,
    FleetReplica,
    make_fleet,
)
from raft_tpu_torch.fleet.planner import (
    FleetPlanConfig,
    FleetPlanner,
    PlacementDelta,
    placement_deltas,
    plan_fleet,
)
from raft_tpu_torch.fleet.router import (
    QueryRouter,
    ReplicaUnavailable,
    RouteDecision,
    RouterConfig,
    merge_fanout,
    route_payload_model,
)
from raft_tpu_torch.fleet.table import RoutingTable

__all__ = [
    "FleetFakeExecutor",
    "FleetHarness",
    "FleetPlanConfig",
    "FleetPlanner",
    "FleetReplica",
    "PlacementDelta",
    "QueryRouter",
    "ReplicaUnavailable",
    "RouteDecision",
    "RouterConfig",
    "RoutingTable",
    "make_fleet",
    "merge_fanout",
    "placement_deltas",
    "plan_fleet",
    "route_payload_model",
]
