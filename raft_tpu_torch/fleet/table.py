"""The serializable fleet routing table — port of
``raft_tpu/fleet/table.py`` (numpy only).

The table is the single artifact the planner emits and the router
consumes: for every coarse list it names the replicas hot for that
list, owner first. It is deliberately a PURE value — no clocks, no
timestamps, no RNG — so the planner's determinism claim composes:
same (merged probe plane × headroom) in, byte-identical table out
(:func:`RoutingTable.to_bytes` serializes with sorted keys and no
whitespace variance). Anything time-flavoured (table age, staleness)
lives router-side against an injected clock.

Distribution rides the existing federation channels: the serving
exporter serves the table at ``/route.json`` (scrape mode) and
accepts it on the federation's ``POST /push`` channel (``?route=1``) for
NAT-bound replicas — the table is small (one name tuple per list),
versioned, and diffable (:meth:`RoutingTable.diff`), so pushing a
fresh table is idempotent and stale pushes are refused by version.

Generation check: the table records, per replica, the tiered-layout
``generation`` it was planned against. The router refuses to STEER
to a replica whose live generation disagrees (mid-rebalance skew) —
it falls back to ownership fan-out, which stays exact regardless of
which tier a list currently occupies (ownership decides who scans,
not where the list's blocks live).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from raft_tpu_torch.core.validation import expect

TABLE_FORMAT = "graftroute/1"


@dataclasses.dataclass(frozen=True)
class RoutingTable:
    """Versioned fleet routing table: list → hot replicas.

    ``assignments[lid]`` is the ordered replica-name tuple hot for
    list ``lid`` — the first entry is the OWNER (scans the list on
    fan-out), later entries are traffic copies the router may steer
    to. ``counts`` is the traffic plane the plan was built from (per
    list, monotone window counts) — kept in the table so placement
    deltas can order promotions hottest-first without re-reading the
    aggregator. ``generations`` pins each replica's tiered-layout
    generation at plan time (see module docstring).
    """

    version: int
    label: str
    assignments: Tuple[Tuple[str, ...], ...]
    counts: Tuple[int, ...]
    generations: Tuple[Tuple[str, int], ...] = ()
    # lists whose owner serves them from the COLD tier (fleet hot
    # capacity exhausted): still owned exactly once — fan-out stays
    # exact — but never steer-covered and never in a hot set
    cold_owned: Tuple[int, ...] = ()

    def __post_init__(self):
        expect(self.version >= 0, "table version must be >= 0")
        expect(len(self.assignments) == len(self.counts),
               "one traffic count per assigned list")
        for lid, names in enumerate(self.assignments):
            expect(len(names) >= 1,
                   f"list {lid} must have at least an owner")

    # -- shape accessors ------------------------------------------

    @property
    def n_lists(self) -> int:
        return len(self.assignments)

    @property
    def replicas(self) -> Tuple[str, ...]:
        """Every replica named by the table, sorted."""
        seen = set()
        for names in self.assignments:
            seen.update(names)
        return tuple(sorted(seen))

    def owner(self, lid: int) -> str:
        return self.assignments[lid][0]

    def owners(self) -> Tuple[str, ...]:
        """Per-list owner names, index-aligned with list ids."""
        return tuple(names[0] for names in self.assignments)

    def hot_lists(self, replica: str) -> np.ndarray:
        """Sorted int32 list ids ``replica`` is HOT for (cold-owned
        lists are owned, not hot — they serve from the cold tier)."""
        cold = set(self.cold_owned)
        lids = [lid for lid, names in enumerate(self.assignments)
                if replica in names and lid not in cold]
        return np.asarray(lids, np.int32)

    def replicated_lists(self) -> int:
        """How many lists are hot on more than one replica."""
        return sum(1 for names in self.assignments if len(names) > 1)

    def generation_of(self, replica: str) -> Optional[int]:
        for name, gen in self.generations:
            if name == replica:
                return gen
        return None

    def covering(self, lids: Sequence[int],
                 healthy=None) -> Tuple[str, ...]:
        """Replicas hot for EVERY list in ``lids`` (sorted names).

        ``healthy`` optionally restricts candidates to replicas the
        predicate admits (the router passes fleet health here).
        """
        lids = list(lids)
        if not lids:
            return ()
        cold = set(self.cold_owned)
        cover = None
        for lid in lids:
            expect(0 <= lid < self.n_lists,
                   f"list id {lid} outside table ({self.n_lists})")
            if lid in cold:
                return ()
            names = set(self.assignments[lid])
            cover = names if cover is None else (cover & names)
            if not cover:
                return ()
        if healthy is not None:
            cover = {n for n in cover if healthy(n)}
        return tuple(sorted(cover))

    # -- serialization --------------------------------------------

    def to_json(self) -> Dict:
        return {
            "format": TABLE_FORMAT,
            "version": int(self.version),
            "label": self.label,
            "n_lists": self.n_lists,
            "assignments": [list(names) for names in self.assignments],
            "counts": [int(c) for c in self.counts],
            "generations": {n: int(g) for n, g in self.generations},
            "cold_owned": [int(l) for l in self.cold_owned],
            "replicated_lists": self.replicated_lists(),
        }

    def to_bytes(self) -> bytes:
        """Canonical byte serialization — the purity witness.

        Sorted keys, fixed separators: two tables built from the
        same inputs compare equal as BYTES, not just as values.
        """
        return json.dumps(self.to_json(), sort_keys=True,
                          separators=(",", ":")).encode("utf-8")

    @classmethod
    def from_json(cls, doc: Mapping) -> "RoutingTable":
        expect(isinstance(doc, Mapping), "routing table must be a dict")
        expect(doc.get("format") == TABLE_FORMAT,
               f"unknown routing-table format {doc.get('format')!r}")
        assignments = tuple(
            tuple(str(n) for n in names)
            for names in doc.get("assignments") or ())
        counts = tuple(int(c) for c in doc.get("counts") or ())
        gens = tuple(sorted(
            (str(n), int(g))
            for n, g in (doc.get("generations") or {}).items()))
        return cls(version=int(doc.get("version", 0)),
                   label=str(doc.get("label", "")),
                   assignments=assignments, counts=counts,
                   generations=gens,
                   cold_owned=tuple(
                       int(l) for l in doc.get("cold_owned") or ()))

    # -- diffing --------------------------------------------------

    def diff(self, old: Optional["RoutingTable"]) -> Dict:
        """Per-replica hot-set delta vs ``old`` (None → all gained).

        Returns ``{replica: {"gain": [...], "lose": [...]}}`` with
        sorted list ids — the shape the planner's placement deltas
        and the rebalance tests consume.
        """
        if old is not None:
            expect(old.n_lists == self.n_lists,
                   "diff requires same list geometry")
        out: Dict[str, Dict[str, list]] = {}
        names = set(self.replicas)
        if old is not None:
            names.update(old.replicas)
        for name in sorted(names):
            new_hot = set(self.hot_lists(name).tolist())
            old_hot = (set(old.hot_lists(name).tolist())
                       if old is not None else set())
            gain = sorted(new_hot - old_hot)
            lose = sorted(old_hot - new_hot)
            if gain or lose:
                out[name] = {"gain": gain, "lose": lose}
        return out
