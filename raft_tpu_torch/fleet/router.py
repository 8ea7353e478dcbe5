"""Content-aware steering with exact fan-out — port of
``raft_tpu/fleet/router.py``.

The router sits in FRONT of each replica's batcher: it resolves a
request's probed lists (replica-local coarse select — the signal is
free, the request needed it anyway), scores coverage against the
fleet :class:`~raft_tpu_torch.fleet.table.RoutingTable`, and either

- **steers** — some healthy replica is hot for EVERY probed list
  (and its live tiered generation matches the table's pin): the
  whole request goes there, one leg, result bit-identical to a solo
  replica because it IS a solo replica for those lists; or
- **fans out** — probed lists partition by table OWNER (disjoint —
  the long tail is owned exactly once, so no replica scans a list
  another leg also scans), and the per-leg top-k blocks merge with
  the mesh merge's wire discipline: ids exact int32, distances optionally
  on a bf16 wire, ties re-ranked to the smallest id. On the f32
  wire the merge of disjoint partials is EXACT, so fan-out is also
  bit-identical to solo per engine.

Failure is typed, never silent: a replica that dies mid-request
raises :class:`ReplicaUnavailable` from its handle; the router
retries the affected lists on survivors (``fleet.route.retries``)
and only re-raises when no replica is left. Skew is handled the
same way staged prefetch hits are — a generation check: a replica
mid-rebalance (live generation ≠ table pin) is never steered to,
and ownership fan-out stays exact regardless of which tier a list
occupies.

Clock discipline: the router never reads a wall clock — table age is measured against the injected clock (batcher
convention).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.fleet.table import RoutingTable
from raft_tpu_torch.serving.batcher import MonotonicClock
from raft_tpu_torch.serving.request import ServingError

ROUTE_WIRE_DTYPES = ("f32", "bf16")

# counters
ROUTE_REQUESTS = "fleet.route.requests"
ROUTE_STEERED = "fleet.route.steered"
ROUTE_FANOUT = "fleet.route.fanout"
ROUTE_FANOUT_LEGS = "fleet.route.fanout_legs"
ROUTE_RETRIES = "fleet.route.retries"
ROUTE_UNCOVERED = "fleet.route.uncovered"
ROUTE_SKEW = "fleet.route.generation_skew"
ROUTE_TABLE_APPLIED = "fleet.route.table_applied"
ROUTE_TABLE_STALE = "fleet.route.table_stale"
# gauges
ROUTE_COVERAGE = "fleet.route.coverage_rate"
ROUTE_FANOUT_FRACTION = "fleet.route.fanout_fraction"
ROUTE_TABLE_VERSION = "fleet.route.table_version"
ROUTE_TABLE_AGE = "fleet.route.table_age_s"


class ReplicaUnavailable(ServingError):
    """A replica died (or refused) while a request was in flight on
    it — the router's typed retry-on-survivor trigger."""


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """``merge_wire_dtype`` prices the fan-out merge wire (f32 exact
    / bf16 half the distance bytes, ids always exact int32);
    ``steer`` can force always-fan-out (A/B surface)."""

    merge_wire_dtype: str = "f32"
    steer: bool = True

    def __post_init__(self):
        expect(self.merge_wire_dtype in ROUTE_WIRE_DTYPES,
               f"merge_wire_dtype must be one of {ROUTE_WIRE_DTYPES}")


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    """What the router did with one request (test/debug evidence).

    ``mode``: ``steer`` | ``fanout`` | ``passthrough``; ``fallback``
    names WHY a fan-out happened (``no_table`` / ``uncovered`` /
    ``generation_skew`` / ``retry``) or None.
    """

    mode: str
    replica: Optional[str]
    lists: Tuple[int, ...]
    legs: int
    fallback: Optional[str] = None


def merge_fanout(parts, k: int, *, wire_dtype: str = "f32",
                 select_min: bool = True):
    """Merge per-leg top-k blocks — the router-side twin of the
    distributed :func:`~raft_tpu_torch.distributed.ivf._merge_candidates`
    epilog (``router.py:104``), same deterministic smallest-id tie
    re-rank: the lexicographic (distance, id) order of a two-key sort.

    ``parts``: per-leg ``(d (rows, ≤k), i (rows, ≤k))`` blocks with
    +inf/−1 padding, numpy arrays or tensors on any device (one device
    for all the tensors). Distances cross the wire in ``wire_dtype``
    (bf16 → rounded through ``torch.bfloat16``); ids stay exact int32.
    Returns merged ``(rows, k)`` float32/int32 tensors on the parts'
    device (the CPU for numpy parts).
    """
    from raft_tpu_torch.distributed.ivf import _lexsort_take

    expect(wire_dtype in ROUTE_WIRE_DTYPES,
           f"wire_dtype must be one of {ROUTE_WIRE_DTYPES}")
    expect(len(parts) >= 1, "merge_fanout needs at least one leg")
    dev = next((t.device for part in parts for t in part
                if isinstance(t, torch.Tensor)), torch.device("cpu"))
    ds, ids = [], []
    for d, i in parts:
        d = torch.as_tensor(d).to(device=dev, dtype=torch.float32)
        if wire_dtype == "bf16":
            d = d.to(torch.bfloat16).to(torch.float32)
        ds.append(d)
        ids.append(torch.as_tensor(i).to(device=dev, dtype=torch.int32))
    cat_d = torch.cat(ds, dim=1)
    cat_i = torch.cat(ids, dim=1)
    sd, si = _lexsort_take(cat_d if select_min else -cat_d, cat_i, k)
    si = torch.where(torch.isfinite(sd), si, torch.full_like(si, -1))
    return (sd if select_min else -sd), si


def route_payload_model(q: int, k: int, legs: int,
                        wire_dtype: str = "f32") -> dict:
    """Modeled cross-replica merge payload (bytes) — the
    ``collective_payload_model`` convention applied to the router's
    fan-out: each leg ships ``(q, k)`` distances in ``wire_dtype``
    plus exact int32 ids back to the merge point."""
    expect(wire_dtype in ROUTE_WIRE_DTYPES,
           f"wire_dtype must be one of {ROUTE_WIRE_DTYPES}")
    itemsize = 2 if wire_dtype == "bf16" else 4
    per_leg = q * k * (itemsize + 4)
    return {
        "legs": int(legs),
        "per_leg_bytes": int(per_leg),
        "merge_bytes": int(per_leg * legs),
        "wire_dtype": wire_dtype,
    }


class QueryRouter:
    """Content-aware front door of an N-replica shared-nothing fleet.

    Args:
      replicas: name → replica. A replica exposes ``submit(queries,
        k, lists=...) -> handle`` (``handle.result()`` → ``(d, i)``,
        raising :class:`ReplicaUnavailable` on death) and optionally
        a live ``generation`` attribute (tiered layout epoch).
      resolve_probes: queries → probed coarse list ids (the
        replica-local coarse select, deterministic).
      health: optional callable → ``{name: bool}`` (the federation's
        replica health); unlisted replicas count healthy.
      clock: injected clock (``now()``), table age only.
    """

    def __init__(self, replicas: Mapping[str, object], *,
                 resolve_probes: Callable,
                 table: Optional[RoutingTable] = None,
                 config: Optional[RouterConfig] = None,
                 health: Optional[Callable] = None,
                 clock=None):
        expect(len(replicas) > 0, "router needs at least one replica")
        self._replicas = dict(replicas)
        self._resolve = resolve_probes
        self._config = config or RouterConfig()
        self._health = health
        self._clock = clock or MonotonicClock()
        self._lock = threading.Lock()
        self._table = table                      # guarded-by: _lock
        self._applied_at: Optional[float] = None  # guarded-by: _lock
        self._down: set = set()                  # guarded-by: _lock
        self._steers = {n: 0 for n in replicas}  # guarded-by: _lock
        self._requests = 0                       # guarded-by: _lock
        self._steered = 0                        # guarded-by: _lock
        self._fanned = 0                         # guarded-by: _lock

    # -- table lifecycle ------------------------------------------

    @property
    def table(self) -> Optional[RoutingTable]:
        with self._lock:
            return self._table

    def apply_table(self, table) -> bool:
        """Install a newer routing table (push or scrape delivery).

        Accepts a :class:`RoutingTable` or its ``to_json`` dict.
        Only a strictly newer version replaces the live table —
        stale pushes are refused (False, ``fleet.route.table_stale``)
        so out-of-order delivery over the federation channel is
        harmless.
        """
        if not isinstance(table, RoutingTable):
            table = RoutingTable.from_json(table)
        with self._lock:
            live = self._table
            if live is not None and table.version <= live.version:
                stale = True
            else:
                stale = False
                self._table = table
                self._applied_at = self._clock.now()
                self._down.clear()  # fresh plan, retry everyone
        tracing.inc_counter(
            ROUTE_TABLE_STALE if stale else ROUTE_TABLE_APPLIED)
        return not stale

    def snapshot(self) -> dict:
        """The ``/route.json`` payload: live table + router view."""
        with self._lock:
            table = self._table
            if table is None:
                raise LookupError("no routing table applied")
            doc = table.to_json()
            doc["router"] = {
                "requests": self._requests,
                "steered": self._steered,
                "fanout": self._fanned,
                "down": sorted(self._down),
                "steers": dict(sorted(self._steers.items())),
            }
        return doc

    # -- health ---------------------------------------------------

    def _healthy_names(self) -> list:
        healthy = {n: True for n in self._replicas}
        if self._health is not None:
            for n, ok in (self._health() or {}).items():
                if n in healthy:
                    healthy[n] = bool(ok)
        with self._lock:
            down = set(self._down)
        return sorted(n for n, ok in healthy.items()
                      if ok and n not in down)

    def _mark_down(self, name: str) -> None:
        with self._lock:
            self._down.add(name)

    # -- routing --------------------------------------------------

    def route(self, queries, k: int):
        """Answer one request: ``(d, i, decision)``.

        Bit-identity contract: for a given engine, the returned
        ``(d, i)`` equal a solo replica's answer for steered
        requests and for f32-wire fan-out; the bf16 wire trades
        distance bytes for a pinned ≥0.99 recall floor.
        """
        with self._lock:
            self._requests += 1
        tracing.inc_counter(ROUTE_REQUESTS)
        lids = tuple(int(l) for l in self._resolve(queries))
        expect(len(lids) > 0, "resolver returned no probed lists")
        if len(self._replicas) == 1:
            name = next(iter(self._replicas))
            d, i = self._replicas[name].submit(
                queries, k, lists=lids).result()
            return d, i, RouteDecision(mode="passthrough",
                                       replica=name, lists=lids,
                                       legs=1)
        table = self.table
        healthy = self._healthy_names()
        if not healthy:
            raise ReplicaUnavailable("no healthy replica in fleet")
        fallback = None
        if table is None:
            fallback = "no_table"
        elif self._config.steer:
            cover = table.covering(lids, healthy=set(healthy).__contains__)
            fresh = [n for n in cover if not self._skewed(table, n)]
            if cover and not fresh:
                tracing.inc_counter(ROUTE_SKEW)
                fallback = "generation_skew"
            elif not cover:
                tracing.inc_counter(ROUTE_UNCOVERED)
                fallback = "uncovered"
            else:
                got = self._try_steer(fresh, queries, k, lids)
                if got is not None:
                    return got
                fallback = "retry"
        else:
            fallback = "uncovered"
        return self._fan_out(queries, k, lids, table, fallback)

    def _skewed(self, table: RoutingTable, name: str) -> bool:
        pin = table.generation_of(name)
        if pin is None:
            return False
        live = getattr(self._replicas[name], "generation", None)
        return live is not None and int(live) != pin

    def _try_steer(self, cover, queries, k: int, lids):
        """One steered leg to the least-steered covering replica;
        None when the pick died mid-flight (caller fans out on the
        survivors — typed, never an error)."""
        with self._lock:
            name = min(cover, key=lambda n: (self._steers[n], n))
            self._steers[name] += 1
        try:
            d, i = self._replicas[name].submit(
                queries, k, lists=lids).result()
        except ReplicaUnavailable:
            tracing.inc_counter(ROUTE_RETRIES)
            self._mark_down(name)
            return None
        with self._lock:
            self._steered += 1
        tracing.inc_counter(ROUTE_STEERED)
        return d, i, RouteDecision(mode="steer", replica=name,
                                   lists=lids, legs=1)

    def _partition(self, lids, table: Optional[RoutingTable],
                   healthy) -> Dict[str, list]:
        """Disjoint lid → replica partition (exactness invariant:
        every probed list scanned exactly once). Owner scans when
        healthy, else the first healthy copy, else round-robin by
        lid position over the healthy fleet."""
        alive = sorted(healthy)
        legs: Dict[str, list] = {}
        for pos, lid in enumerate(sorted(lids)):
            name = None
            if table is not None:
                for cand in table.assignments[lid]:
                    if cand in healthy:
                        name = cand
                        break
            if name is None:
                name = alive[pos % len(alive)]
            legs.setdefault(name, []).append(lid)
        return legs

    def _fan_out(self, queries, k: int, lids, table, fallback):
        healthy = set(self._healthy_names())
        parts = []
        legs_run = 0
        pending = tuple(lids)
        while pending:
            if not healthy:
                raise ReplicaUnavailable(
                    "no surviving replica for lists %r" % (pending,))
            legs = self._partition(pending, table, healthy)
            pending = ()
            for name in sorted(legs):
                handle = self._replicas[name].submit(
                    queries, k, lists=tuple(legs[name]))
                try:
                    parts.append(handle.result())
                    legs_run += 1
                except ReplicaUnavailable:
                    tracing.inc_counter(ROUTE_RETRIES)
                    self._mark_down(name)
                    healthy.discard(name)
                    pending = pending + tuple(legs[name])
        with self._lock:
            self._fanned += 1
        tracing.inc_counters({ROUTE_FANOUT: 1,
                              ROUTE_FANOUT_LEGS: legs_run})
        if len(parts) == 1:
            d, i = parts[0]
        else:
            d, i = merge_fanout(
                parts, k, wire_dtype=self._config.merge_wire_dtype)
            if not any(isinstance(t, torch.Tensor)
                       for part in parts for t in part):
                # numpy legs answer in numpy, as a solo leg does
                d, i = d.numpy(), i.numpy()
        return d, i, RouteDecision(mode="fanout", replica=None,
                                   lists=tuple(lids), legs=legs_run,
                                   fallback=fallback)

    # -- observability --------------------------------------------

    def payload_model(self, q: int, k: int, legs: int) -> dict:
        return route_payload_model(
            q, k, legs, self._config.merge_wire_dtype)

    def publish_gauges(self) -> None:
        """Refresh the ``fleet.route.*`` gauge family (scrape-driven,
        the TierManager/exporter convention)."""
        with self._lock:
            req = self._requests
            steered = self._steered
            fanned = self._fanned
            table = self._table
            applied = self._applied_at
            steers = dict(self._steers)
        gauges = {
            ROUTE_COVERAGE: steered / req if req else 0.0,
            ROUTE_FANOUT_FRACTION: fanned / req if req else 0.0,
            ROUTE_TABLE_VERSION:
                float(table.version) if table is not None else 0.0,
            ROUTE_TABLE_AGE:
                (self._clock.now() - applied)
                if applied is not None else 0.0,
        }
        for name, n in steers.items():
            gauges[f"fleet.route.replica.{name}.steered"] = float(n)
        tracing.set_gauges(gauges)
