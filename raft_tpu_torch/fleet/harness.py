"""A device-free N-replica fleet in one process — port of
``raft_tpu/fleet/harness.py`` (numpy only).

The serving harness (:mod:`raft_tpu_torch.serving.harness`) made the
batcher's failure modes deterministic with a manual clock and shim
executors; this module lifts the same discipline to FLEET scope so
planner convergence, router failover, and rebalance-under-traffic
races are plain assertions, not races.

:class:`FleetFakeExecutor` is the per-replica engine: a pure
integer-hash distance function of (query row id, candidate id) with
the REAL scan epilog — per-list candidate generation, top-k by
(distance, id) with the smallest-id tie re-rank, +inf/−1 padding —
so a fan-out over any disjoint list partition merges back to the
solo answer bit-for-bit on the f32 wire. Distances are built as
``integer + id·2⁻¹²``: the integer part survives a bf16 wire with
order preserved (rounding is monotone and sub-1 integer gaps never
collapse), the jitter breaks ties in id order on the f32 wire and
vanishes on the bf16 wire — exercising the deterministic
smallest-id re-rank, with the measured recall floor the harness
tests pin ≥0.99 at fleet size 4.

:class:`FleetReplica` wraps one engine with liveness scripting:
``kill()`` for hard death, ``fail_results(n)`` for death DURING an
in-flight request (submit succeeds, ``result()`` raises the typed
:class:`~raft_tpu_torch.fleet.router.ReplicaUnavailable`), plus the live
``generation`` attribute the router's steer skew check reads.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.fleet.router import ReplicaUnavailable
from raft_tpu_torch.serving.harness import ManualClock

_HASH_A = 2654435761  # Knuth multiplicative constants — any odd
_HASH_B = 40503       # mixers do; pinned for reproducibility


class FleetFakeExecutor:
    """Deterministic per-list scan engine (host-side by contract).

    Candidate ``j`` of list ``l`` has global id ``l·list_size + j``
    and distance ``hash(qid, gid) % modulus + gid·2⁻¹²`` against
    query row id ``qid`` (the row's first component, the
    ``FakeExecutor`` row-identifying convention).
    """

    def __init__(self, n_lists: int = 32, list_size: int = 8,
                 *, modulus: int = 512, seed: int = 7):
        expect(n_lists > 0 and list_size > 0,
               "fleet engine needs non-empty lists")
        self.n_lists = int(n_lists)
        self.list_size = int(list_size)
        self.modulus = int(modulus)
        self.seed = int(seed)

    def scan_lists(self, queries, lists: Sequence[int], k: int):
        """Scan ``lists`` for every query row → ``(d, i)`` blocks of
        shape ``(rows, k)``, +inf/−1 padded, smallest-id ties."""
        q = np.asarray(queries)
        lids = np.asarray(sorted(int(l) for l in lists), np.int64)
        expect(lids.size > 0, "scan needs at least one list")
        expect(np.all((lids >= 0) & (lids < self.n_lists)),
               "list id out of range")
        qid = q[:, 0].astype(np.int64)
        gid = (lids[:, None] * self.list_size
               + np.arange(self.list_size)[None, :]).reshape(-1)
        h = (qid[:, None] * _HASH_A + gid[None, :] * _HASH_B
             + self.seed) % (2 ** 31)
        dist = (h % self.modulus).astype(np.float32) \
            + gid.astype(np.float32) * np.float32(2.0 ** -12)
        ids = np.broadcast_to(gid.astype(np.int32), dist.shape)
        rows, n = dist.shape
        d_out = np.full((rows, k), np.inf, np.float32)
        i_out = np.full((rows, k), -1, np.int32)
        take = min(k, n)
        # row-wise (distance, id) sort — the smallest-id tie re-rank
        # of the real merge epilog (np.lexsort: last key is primary)
        order = np.lexsort((ids, dist), axis=1)[:, :take]
        d_out[:, :take] = np.take_along_axis(dist, order, axis=1)
        i_out[:, :take] = np.take_along_axis(ids, order, axis=1)
        return d_out, i_out


class _FleetHandle:
    """Lazy result handle — evaluation happens at ``result()`` so a
    replica can die while the request is in flight."""

    def __init__(self, replica: "FleetReplica", queries, k, lists):
        self._replica = replica
        self._queries = queries
        self._k = k
        self._lists = lists

    def result(self):
        return self._replica._finish(self._queries, self._k,
                                     self._lists)


class FleetReplica:
    """One shared-nothing replica: full engine copy + liveness."""

    def __init__(self, name: str, executor: FleetFakeExecutor,
                 *, generation: int = 0):
        self.name = name
        self.executor = executor
        self.generation = int(generation)
        self.alive = True
        self.calls: list = []
        self._fail_results = 0

    def kill(self) -> None:
        self.alive = False

    def revive(self) -> None:
        self.alive = True
        self._fail_results = 0

    def fail_results(self, n: int = 1) -> None:
        """Script death DURING flight: the next ``n`` ``result()``
        calls raise :class:`ReplicaUnavailable` (submit succeeds)."""
        self._fail_results = int(n)

    def submit(self, queries, k: int, lists=None) -> _FleetHandle:
        self.calls.append((len(np.asarray(queries)),
                           None if lists is None else tuple(lists)))
        return _FleetHandle(self, queries, k, lists)

    def _finish(self, queries, k: int, lists):
        if self._fail_results > 0:
            self._fail_results -= 1
            raise ReplicaUnavailable(
                f"replica {self.name} died in flight")
        if not self.alive:
            raise ReplicaUnavailable(f"replica {self.name} is down")
        if lists is None:
            lists = range(self.executor.n_lists)
        return self.executor.scan_lists(queries, lists, k)


@dataclasses.dataclass
class FleetHarness:
    """Everything a fleet test needs, deterministically wired."""

    executor: FleetFakeExecutor
    replicas: Dict[str, FleetReplica]
    clock: ManualClock
    n_probes: int

    def resolve_probes(self, queries) -> Tuple[int, ...]:
        """The replica-local coarse select: probed lists are a pure
        function of the query rows' id components."""
        q = np.asarray(queries)
        lids = set()
        for qid in q[:, 0].astype(np.int64):
            for j in range(self.n_probes):
                lids.add(int((qid + 7 * j) % self.executor.n_lists))
        return tuple(sorted(lids))

    def solo(self, queries, k: int):
        """The solo-replica reference answer (bit-identity oracle):
        one engine scans every probed list."""
        return self.executor.scan_lists(
            queries, self.resolve_probes(queries), k)

    def make_queries(self, rows: int, start: int = 0) -> np.ndarray:
        q = np.zeros((rows, 4), np.float32)
        q[:, 0] = np.arange(start, start + rows, dtype=np.float32)
        return q


def make_fleet(n_replicas: int = 4, *, n_lists: int = 32,
               list_size: int = 8, n_probes: int = 4,
               modulus: int = 512, seed: int = 7) -> FleetHarness:
    """Build an N-replica fleet sharing one engine geometry (every
    replica holds the FULL index — the shared-nothing model)."""
    expect(n_replicas >= 1, "fleet needs at least one replica")
    executor = FleetFakeExecutor(n_lists, list_size,
                                 modulus=modulus, seed=seed)
    replicas = {
        f"r{i}": FleetReplica(f"r{i}", executor)
        for i in range(n_replicas)
    }
    return FleetHarness(executor=executor, replicas=replicas,
                        clock=ManualClock(), n_probes=n_probes)
