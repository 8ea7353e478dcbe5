"""Fleet placement as a pure epoch function — port of
``raft_tpu/fleet/planner.py``.

:func:`~raft_tpu_torch.serving.placement.plan_epoch` decides WHICH
lists one replica keeps hot; this module decides WHO keeps what,
fleet-wide. :func:`plan_fleet` is the same species of policy — a pure,
deterministic function, here of the federation's merged probe plane ×
per-replica headroom — so two control planes observing the
same aggregator state emit byte-identical routing tables
(:meth:`~raft_tpu_torch.fleet.table.RoutingTable.to_bytes` is the witness
tests pin).

Policy shape: every list gets exactly ONE owner (the long tail is
owned once — shared-nothing, no duplicate scan work on fan-out), and
lists whose measured traffic beats ``hot_share_ratio`` × the uniform
share earn replication copies (R > 1 hot replicas the router may
steer to), capped by per-replica hot capacity derived from reported
headroom. Assignment is greedy hottest-first onto the least-loaded
replica; every tie breaks deterministically (load, then slot count,
then replica name; lists order by (−count, lid)).

Rebalance rides the existing fixed-width swap contract: per replica,
:func:`placement_deltas` turns a table transition into the same
(promotions, demotions) pairs :func:`raft_tpu_torch.neighbors.tiered
.apply_plan` executes as fixed-width in-place swaps — no new captured
plan, no new swap discipline. The delta also carries a staging
hint (promotions, hottest first) for the replica's
:class:`~raft_tpu_torch.serving.prefetch.TierPrefetcher`, so a list is
staged on the replica ABOUT to become hot for it before the epoch.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.fleet.table import RoutingTable

# counters
PLAN_BUILDS = "fleet.plan.builds"
PLAN_CHANGED = "fleet.plan.changed"
# gauges
PLAN_VERSION = "fleet.plan.version"
PLAN_REPLICATED = "fleet.plan.replicated_lists"
PLAN_WINDOW_TOTAL = "fleet.plan.window_total"


@dataclasses.dataclass(frozen=True)
class FleetPlanConfig:
    """Knobs of the pure policy (all defaults deterministic).

    ``hot_share_ratio``: a list replicates once more for every
    multiple of (ratio × uniform share) its traffic reaches.
    ``max_replication``: hard cap on copies (0 → up to fleet size).
    ``list_bytes`` + ``safety_fraction``: per-replica hot capacity
    is ``floor(headroom × (1 − safety) / list_bytes)`` slots; with
    ``list_bytes == 0`` (or unreported headroom) capacity falls back
    to ``fallback_slots`` (0 → unbounded).
    ``max_swaps``: the fixed swap width placement deltas truncate to
    (``plan_epoch``'s ``max_swaps`` contract).
    """

    hot_share_ratio: float = 4.0
    max_replication: int = 0
    list_bytes: int = 0
    safety_fraction: float = 0.25
    fallback_slots: int = 0
    max_swaps: int = 8


@dataclasses.dataclass(frozen=True)
class PlacementDelta:
    """One replica's ``apply_plan``-shaped rebalance step.

    ``promotions[i]`` (newly hot list) takes the slot
    ``demotions[i]`` frees — index-paired, truncated to the fixed
    swap ``width`` that ``apply_plan`` executes. ``stage`` is the prefetch hint: the FULL gained set ordered
    hottest-first, fed to ``TierPrefetcher`` ahead of the epoch.
    """

    promotions: Tuple[int, ...]
    demotions: Tuple[int, ...]
    stage: Tuple[int, ...]
    width: int


def _capacity(headroom: Optional[float],
              config: FleetPlanConfig, n_lists: int) -> int:
    if config.list_bytes <= 0 or headroom is None:
        fb = int(config.fallback_slots)
        return n_lists if fb <= 0 else min(fb, n_lists)
    usable = float(headroom) * (1.0 - config.safety_fraction)
    return max(0, min(n_lists, int(usable // config.list_bytes)))


def plan_fleet(window_counts,
               replica_headroom: Mapping[str, Optional[float]],
               *, label: str = "",
               version: int = 0,
               generations: Optional[Mapping[str, int]] = None,
               config: Optional[FleetPlanConfig] = None) -> RoutingTable:
    """The pure fleet placement function.

    Args:
      window_counts: ``(n_lists,)`` merged probe-plane counts.
      replica_headroom: replica name → headroom bytes (None when the
        replica reported none — capacity falls back, see config).
      label / version / generations: carried into the table verbatim
        (the caller — :class:`FleetPlanner` — owns versioning).

    Returns a :class:`RoutingTable`; same arguments ⇒ byte-identical
    ``to_bytes()`` output.
    """
    config = config or FleetPlanConfig()
    counts = np.asarray(window_counts, np.int64)
    expect(counts.ndim == 1 and counts.size > 0,
           "window_counts must be a non-empty (n_lists,) vector")
    expect(len(replica_headroom) > 0,
           "plan_fleet needs at least one replica")
    n_lists = int(counts.size)
    names = sorted(replica_headroom)
    n_rep = len(names)
    cap = {n: _capacity(replica_headroom[n], config, n_lists)
           for n in names}
    # every list needs an owner even on a capacity-starved fleet:
    # distribute ceil(n_lists / n_rep) ownership minimums
    total = int(counts.sum())
    uniform = total / n_lists if total > 0 else 0.0
    rep_cap = n_rep if config.max_replication <= 0 \
        else min(config.max_replication, n_rep)

    def copies(c: int) -> int:
        if total <= 0 or uniform <= 0.0:
            return 1
        extra = int(float(c) / (config.hot_share_ratio * uniform))
        return max(1, min(rep_cap, 1 + extra))

    order = sorted(range(n_lists), key=lambda l: (-counts[l], l))
    load = {n: 0 for n in names}      # assigned traffic
    slots = {n: 0 for n in names}     # hot slots consumed
    assignments: list = [None] * n_lists
    cold_owned: list = []
    for lid in order:
        r = copies(int(counts[lid]))
        share = max(1, int(counts[lid])) // r if total > 0 else 1
        ranked = sorted(names,
                        key=lambda n: (load[n], slots[n], n))
        chosen = []
        for n in ranked:
            if len(chosen) == r:
                break
            if slots[n] < cap[n]:
                chosen.append(n)
        if not chosen:
            # capacity exhausted everywhere — ownership is still
            # mandatory (the owner serves the list cold); place on
            # the least-loaded replica without consuming a slot
            owner = ranked[0]
            load[owner] += share
            assignments[lid] = (owner,)
            cold_owned.append(lid)
            continue
        for n in chosen:
            load[n] += share
            slots[n] += 1
        assignments[lid] = tuple(chosen)
    gens = tuple(sorted(
        (str(n), int(g)) for n, g in (generations or {}).items()))
    return RoutingTable(version=int(version), label=label,
                        assignments=tuple(assignments),
                        counts=tuple(int(c) for c in counts),
                        generations=gens,
                        cold_owned=tuple(sorted(cold_owned)))


def placement_deltas(table: RoutingTable,
                     current_hot: Mapping[str, Sequence[int]],
                     *, max_swaps: int = 8
                     ) -> Dict[str, PlacementDelta]:
    """Per-replica rebalance steps for a table transition.

    ``current_hot`` maps replica → its CURRENT hot list ids. Gained
    lists order hottest-first (−count, lid), lost lists coldest-
    first (count, lid); pairs truncate to ``max_swaps`` — exactly
    the fixed-width contract of ``apply_plan``. Leftover
    gains stage anyway (the prefetch hint covers the full move; the
    next epoch's pairs drain it).
    """
    expect(max_swaps > 0, "max_swaps must be positive")
    counts = table.counts
    out: Dict[str, PlacementDelta] = {}
    for name in table.replicas:
        new_hot = set(table.hot_lists(name).tolist())
        cur = set(int(l) for l in current_hot.get(name, ()))
        gain = sorted(new_hot - cur,
                      key=lambda l: (-counts[l], l))
        lose = sorted(cur - new_hot,
                      key=lambda l: (counts[l], l))
        pairs = min(len(gain), len(lose), max_swaps)
        out[name] = PlacementDelta(
            promotions=tuple(gain[:pairs]),
            demotions=tuple(lose[:pairs]),
            stage=tuple(gain),
            width=max_swaps)
    return out


class FleetPlanner:
    """Versioned wrapper: aggregator signals in, routing table out.

    Reads the aggregator's typed accessors (never the ``/fleet.json``
    dict by string key), runs :func:`plan_fleet`, and bumps the
    table version ONLY when the placement actually changed — a
    steady fleet re-plans forever at one version, so pushed tables
    are idempotent and the router's stale-push refusal is cheap.
    """

    def __init__(self, aggregator, *, label: str,
                 config: Optional[FleetPlanConfig] = None):
        self._agg = aggregator
        self._label = label
        self._config = config or FleetPlanConfig()
        self._lock = threading.Lock()
        self._table: Optional[RoutingTable] = None  # guarded-by: _lock

    @property
    def table(self) -> Optional[RoutingTable]:
        with self._lock:
            return self._table

    def plan(self, *, generations: Optional[Mapping[str, int]] = None
             ) -> RoutingTable:
        """Plan from the aggregator's CURRENT merged state.

        ``generations`` optionally pins per-replica tiered-layout
        generations into the table (the router's steer skew check);
        omitted entries simply don't gate steering.
        """
        plane = self._agg.merged_probe_plane(self._label)
        headroom = {h.name: h.headroom_bytes
                    for h in self._agg.replica_headroom()}
        with self._lock:
            prev = self._table
            version = prev.version if prev is not None else 0
            cand = plan_fleet(plane.counts, headroom,
                              label=self._label, version=version,
                              generations=generations,
                              config=self._config)
            changed = prev is None or cand.to_bytes() != prev.to_bytes()
            if changed:
                cand = dataclasses.replace(cand, version=version + 1)
                self._table = cand
            table = self._table
        tracing.inc_counter(PLAN_BUILDS)
        if changed:
            tracing.inc_counter(PLAN_CHANGED)
        tracing.set_gauges({
            PLAN_VERSION: float(table.version),
            PLAN_REPLICATED: float(table.replicated_lists()),
            PLAN_WINDOW_TOTAL: float(sum(table.counts)),
        })
        for name in table.replicas:
            tracing.set_gauge(
                f"fleet.plan.replica.{name}.hot_lists",
                float(table.hot_lists(name).size))
        return table

    def deltas(self, current_hot: Mapping[str, Sequence[int]]
               ) -> Dict[str, PlacementDelta]:
        """Rebalance steps from ``current_hot`` to the live table."""
        with self._lock:
            table = self._table
        expect(table is not None, "plan() before deltas()")
        return placement_deltas(table, current_hot,
                                max_swaps=self._config.max_swaps)
