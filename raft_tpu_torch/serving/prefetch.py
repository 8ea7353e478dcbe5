"""Forecast-driven tier promotion ahead of the epoch — the port of
``raft_tpu/serving/prefetch.py``.

Placement (:mod:`raft_tpu_torch.serving.placement`) promotes reactively:
a hot set that shifts pays the cold tier's host link on the epoch's path.
This module stages the promotions it forecasts before the epoch, in three
pieces:

- **Forecast** (:func:`forecast_plan`), pure and deterministic: the
  claimed epoch windows fold into a per-list EWMA (``alpha`` an epoch);
  the next plan is predicted by running :func:`~raft_tpu_torch.serving
  .placement.plan_epoch` over the rolling window plus the down-weighted
  EWMA, scaled to integers. No clock, no random draw.
- **Staged promotions** (:meth:`TierPrefetcher.prefetch`): at the
  :class:`~raft_tpu_torch.serving.placement.TierManager`'s lead-time tick,
  the forecast promotions' cold blocks are copied into a fixed ``(K,
  ...)`` device tensor per hot plane, allocated once: one ``copy_`` a
  block from the pinned cold plane, on a side stream on the card, an
  event recorded after them. At the epoch, :meth:`TierPrefetcher.take`
  hands :func:`~raft_tpu_torch.neighbors.tiered.apply_plan` the staged
  rows (the current stream waits on that event) and only the misses
  cross the host link then: only they count into
  ``tier.promote_cold_bytes``.
- **Capacity**: ``K`` is sized from the ledger's headroom at
  construction, and the active staged bytes ride the ledger as the named
  hold ``tier.prefetch`` (:meth:`~raft_tpu_torch.core.memwatch
  .MemoryLedger.reserve`). A stage that would not fit raises
  :class:`~raft_tpu_torch.core.memwatch.CapacityExceeded` on the host,
  which degrades to the reactive path (counted, never raised toward a
  search); :meth:`TierPrefetcher.maintain` evicts the least recently
  staged rows when the headroom shrinks under them.

Staleness: each staged row carries the container's placement
``generation``; ``apply_plan`` bumps it under the swap lock, so a row
staged before another epoch (or before its list was demoted again) is
refused by :meth:`TierPrefetcher.take` and counted
``tier.prefetch.cancelled``; its promotion streams from the cold tier.

Counters: ``tier.prefetch.{issued,hits,misses,cancelled}``. The
prefetcher holds no clock: its order is a logical stage counter (LRU
age) and the placement generation.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional

import numpy as np
import torch

from raft_tpu_torch.core import memwatch, tracing
from raft_tpu_torch.core.memwatch import CapacityExceeded
from raft_tpu_torch.core.validation import expect

ISSUED = "tier.prefetch.issued"
HITS = "tier.prefetch.hits"
MISSES = "tier.prefetch.misses"
CANCELLED = "tier.prefetch.cancelled"

#: the ledger hold of the staged rows
HOLD = "tier.prefetch"


@dataclasses.dataclass(frozen=True)
class PrefetchConfig:
    """Forecast and staging knobs. ``alpha``: the per-epoch EWMA fold.
    ``capacity``: the staged row count ``K``; None sizes it from the swap
    width, clamped by ledger headroom x (1 - ``safety_fraction``).
    ``min_heat_ratio``: the forecast's hysteresis (the placement
    policy's). ``prior_weight``: the EWMA's weight beside the rolling
    window (:func:`forecast_plan`)."""

    alpha: float = 0.3
    capacity: Optional[int] = None
    safety_fraction: float = 0.25
    min_heat_ratio: float = 1.5
    prior_weight: float = 0.25


@dataclasses.dataclass(frozen=True)
class StagedBlocks:
    """What :func:`~raft_tpu_torch.neighbors.tiered.apply_plan` takes:
    ``rows[i]`` the staged row holding ``promotions[i]``'s blocks (-1: a
    miss, copied from the cold tier), ``planes`` each hot plane name's
    fixed ``(K, ...)`` staged storage."""

    rows: np.ndarray
    planes: Dict[str, torch.Tensor]


def forecast_plan(ewma, hot_lists, cold_lists, *, max_swaps: int,
                  min_heat_ratio: float = 1.5, window=None,
                  prior_weight: float = 0.25):
    """Predict the next epoch's plan: ``prior_weight x ewma + window`` (the
    rolling window, a read-only peek of the ledger), scaled by 1024 and
    rounded to integers (the policy compares ratios, so a common scale
    changes nothing), through the same :func:`~raft_tpu_torch.serving
    .placement.plan_epoch` against the current assignment. Ties break as
    the epoch's do, so a right forecast is the plan."""
    from raft_tpu_torch.serving.placement import plan_epoch

    counts = np.asarray(ewma, np.float64)
    if window is not None:
        counts = prior_weight * counts + np.asarray(window, np.float64)
    counts = np.rint(counts * 1024.0)
    return plan_epoch(counts.astype(np.int64), hot_lists, cold_lists,
                      max_swaps=max_swaps, min_heat_ratio=min_heat_ratio)


class TierPrefetcher:
    """The background promotion channel of one tiered container (any
    family: the staged planes mirror its ``_PLANE_PAIRS`` hot planes).

    The :class:`~raft_tpu_torch.serving.placement.TierManager` drives it:
    :meth:`observe` folds each claimed epoch window, :meth:`prefetch`
    stages the forecast promotions at the lead-time tick, :meth:`take`
    resolves an epoch's promotions against the staged rows. A prefetcher
    of zero capacity is disabled: every method is a no-op and serving is
    the reactive path."""

    def __init__(self, tiered, *, width: int,
                 config: Optional[PrefetchConfig] = None, ledger=None):
        self.tiered = tiered
        self.config = config or PrefetchConfig()
        self.ledger = ledger
        self._lock = threading.Lock()
        self._ewma = np.zeros((tiered.n_lists,), np.float64)  # guarded-by: _lock
        self._epochs_observed = 0                             # guarded-by: _lock
        self._stage_seq = 0                                   # guarded-by: _lock
        cap = self.config.capacity
        cap = max(0, min(int(width if cap is None else cap), tiered.n_cold))
        led = self._ledger()
        if led is not None and cap > 0:
            headroom = led.headroom_bytes()
            if headroom is not None:
                usable = max(float(headroom)
                             * (1.0 - self.config.safety_fraction), 0.0)
                cap = min(cap, int(usable // max(tiered.block_bytes, 1)))
        self.capacity = cap
        # which list each staged row holds (-1 free), the generation it
        # was staged at, and its logical age (LRU)
        self._row_list = np.full((cap,), -1, np.int64)  # guarded-by: _lock
        self._row_gen = np.zeros((cap,), np.int64)      # guarded-by: _lock
        self._row_age = np.zeros((cap,), np.int64)      # guarded-by: _lock
        # fixed (K, ...) storage per hot plane, on the hot tier's device,
        # allocated once; stages write rows in place
        self.planes: Dict[str, torch.Tensor] = {}
        self._stream = None
        self._staged_event = None  # guarded-by: _lock
        if cap > 0:
            for hot_name, _ in type(tiered)._PLANE_PAIRS:
                hot = getattr(tiered, hot_name)
                self.planes[hot_name] = torch.zeros(
                    (cap,) + tuple(hot.shape[1:]), dtype=hot.dtype,
                    device=hot.device)
            dev = next(iter(self.planes.values())).device
            if dev.type == "cuda":
                self._stream = torch.cuda.Stream(device=dev)

    # -- wiring -------------------------------------------------------------

    def _ledger(self):
        """The capacity authority: the attached ledger, else the armed
        process-wide gate."""
        return self.ledger if self.ledger is not None else memwatch.gate()

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    # -- forecast -----------------------------------------------------------

    def observe(self, window_counts) -> None:
        """Fold one claimed epoch window into the EWMA (called inside the
        manager's epoch, from the same claim as the plan)."""
        window = np.asarray(window_counts, np.float64)
        a = self.config.alpha
        with self._lock:
            expect(window.shape == self._ewma.shape,
                   "observe() needs one count per list")
            if self._epochs_observed == 0:
                self._ewma = window.copy()
            else:
                self._ewma = a * window + (1.0 - a) * self._ewma
            self._epochs_observed += 1

    def predict(self, *, max_swaps: int, window=None):
        """The next epoch's plan, forecast from the rolling ``window`` and
        the EWMA against the container's current assignment (read under
        its swap lock)."""
        with self._lock:
            ewma = self._ewma.copy()
        with self.tiered._swap_lock:
            hot = self.tiered.hot_lists.copy()
            cold = self.tiered.cold_lists.copy()
        return forecast_plan(ewma, hot, cold, max_swaps=max_swaps,
                             min_heat_ratio=self.config.min_heat_ratio,
                             window=window,
                             prior_weight=self.config.prior_weight)

    # -- the background channel ---------------------------------------------

    def _stage_locked(self, cold_slot: int, row: int) -> None:
        """Copy cold block ``cold_slot`` of every plane into staged row
        ``row``: on the side stream on the card (after the current
        stream's queued work, which may still write the cold plane)."""
        pair_map = dict(type(self.tiered)._PLANE_PAIRS)
        for hot_name, plane in self.planes.items():
            cold = getattr(self.tiered, pair_map[hot_name])
            if self._stream is None:
                plane[row].copy_(cold[cold_slot])
            else:
                with torch.cuda.stream(self._stream):
                    plane[row].copy_(cold[cold_slot], non_blocking=True)

    def prefetch(self, *, max_swaps: int, window=None) -> int:
        """Stage the forecast promotions' cold blocks ahead of the epoch;
        returns the stages issued. A stage the ledger refuses degrades to
        the reactive path: the remaining forecasts are dropped (counted
        cancelled), nothing raises toward serving."""
        if not self.enabled:
            return 0
        plan = self.predict(max_swaps=max_swaps, window=window)
        if not plan.promotions:
            return 0
        from raft_tpu_torch.neighbors.tiered import _slot_maps

        issued = cancelled = 0
        with self._lock:
            # the cold slots and the generation under the swap lock, held
            # while the copies are issued: a swap cannot move a block
            # between the read of its slot and its stage
            with self.tiered._swap_lock:
                gen = self.tiered.generation
                _, cold_map = _slot_maps(self.tiered.hot_lists,
                                         self.tiered.cold_lists,
                                         self.tiered.n_lists)
                if self._stream is not None:
                    self._stream.wait_stream(torch.cuda.current_stream(
                        self._stream.device))
                for lid in plan.promotions:
                    if self._find_row_locked(lid, gen) >= 0:
                        continue                 # already staged, fresh
                    cs = int(cold_map[lid])
                    if cs < 0:
                        continue                 # promoted meanwhile
                    row = self._free_row_locked()
                    if row < 0:
                        row = self._evict_lru_locked()
                        cancelled += 1
                    try:
                        self._admit_locked(extra_rows=1)
                    except CapacityExceeded:
                        # reactive from here: free the row, count it, stop
                        self._row_list[row] = -1
                        cancelled += 1
                        break
                    self._stage_locked(cs, row)
                    self._stage_seq += 1
                    self._row_list[row] = int(lid)
                    self._row_gen[row] = gen
                    self._row_age[row] = self._stage_seq
                    issued += 1
                if issued and self._stream is not None:
                    self._staged_event = self._stream.record_event()
        if issued:
            tracing.inc_counter(ISSUED, float(issued))
        if cancelled:
            tracing.inc_counter(CANCELLED, float(cancelled))
        return issued

    def take(self, promotions, generation: int) -> Optional[StagedBlocks]:
        """Resolve one epoch's promotions against the staged rows: a row
        staged for the list at this ``generation`` is a hit (consumed:
        ``apply_plan`` copies it in and the row frees), anything else a
        miss. Rows of an older generation are stale and cancelled, never
        served. The current stream waits for the stages first."""
        if not self.enabled:
            return None
        rows = np.full((len(promotions),), -1, np.int32)
        hits = 0
        with self._lock:
            old = (self._row_list >= 0) & (self._row_gen != int(generation))
            stale = int(old.sum())
            self._row_list[old] = -1
            for i, lid in enumerate(promotions):
                r = self._find_row_locked(int(lid), int(generation))
                if r >= 0:
                    rows[i] = r
                    self._row_list[r] = -1       # consumed
                    hits += 1
            self._release_locked()
            if hits and self._staged_event is not None:
                torch.cuda.current_stream(
                    self._stream.device).wait_event(self._staged_event)
        tracing.inc_counters({HITS: float(hits),
                              MISSES: float(len(promotions) - hits)})
        if stale:
            tracing.inc_counter(CANCELLED, float(stale))
        if hits == 0:
            return None
        return StagedBlocks(rows=rows, planes=dict(self.planes))

    def maintain(self) -> int:
        """Evict least recently staged rows while the active staged bytes
        exceed what the ledger's headroom (which already subtracts this
        prefetcher's hold) sustains; returns the rows evicted (counted
        cancelled)."""
        led = self._ledger()
        if not self.enabled or led is None:
            return 0
        evicted = 0
        with self._lock:
            headroom = led.headroom_bytes()
            if headroom is None:
                return 0
            block = max(int(self.tiered.block_bytes), 1)
            allowance = max((float(headroom) + self._active_bytes_locked())
                            * (1.0 - self.config.safety_fraction), 0.0)
            budget_rows = int(allowance // block)
            while int((self._row_list >= 0).sum()) > budget_rows:
                self._evict_lru_locked()
                evicted += 1
            self._release_locked()
        if evicted:
            tracing.inc_counter(CANCELLED, float(evicted))
        return evicted

    # -- row bookkeeping (under self._lock) ---------------------------------

    def _find_row_locked(self, lid: int, gen: int) -> int:
        m = np.nonzero((self._row_list == lid) & (self._row_gen == gen))[0]
        return int(m[0]) if m.size else -1

    def _free_row_locked(self) -> int:
        m = np.nonzero(self._row_list < 0)[0]
        return int(m[0]) if m.size else -1

    def _evict_lru_locked(self) -> int:
        live = np.nonzero(self._row_list >= 0)[0]
        if not live.size:
            return -1
        row = int(live[np.argmin(self._row_age[live])])
        self._row_list[row] = -1
        return row

    def _active_bytes_locked(self) -> int:
        return int((self._row_list >= 0).sum()) * int(self.tiered.block_bytes)

    def _admit_locked(self, extra_rows: int = 0) -> None:
        """Grow the ledger hold to the active rows plus ``extra_rows``:
        :class:`CapacityExceeded` reaches :meth:`prefetch`'s reactive
        path."""
        led = self._ledger()
        if led is None:
            return
        led.reserve(HOLD, self._active_bytes_locked()
                    + extra_rows * int(self.tiered.block_bytes))

    def _release_locked(self) -> None:
        led = self._ledger()
        if led is not None:
            led.reserve(HOLD, self._active_bytes_locked())

    # -- the scrape surface -------------------------------------------------

    def snapshot(self) -> dict:
        """The ``/tier.json`` ``prefetch`` block."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "capacity": int(self.capacity),
                "staged": int((self._row_list >= 0).sum()),
                "staged_bytes": self._active_bytes_locked(),
                "epochs_observed": int(self._epochs_observed),
                "config": {
                    "alpha": self.config.alpha,
                    "safety_fraction": self.config.safety_fraction,
                    "min_heat_ratio": self.config.min_heat_ratio,
                    "prior_weight": self.config.prior_weight,
                },
            }
