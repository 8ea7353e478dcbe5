"""Tiered placement policy — the port of ``raft_tpu/serving/placement.py``
(``PlacementConfig``, ``PlacementPlan``, ``plan_epoch``; pure numpy).

One epoch pairs the hottest cold lists of a traffic window (per-list
probe counts, e.g. from :func:`raft_tpu_torch.ops.ivf_scan.probe_histogram`)
with the coldest hot lists, at most ``max_swaps`` pairs, and keeps a pair
only while the cold list's count beats the hot list's by
``min_heat_ratio`` (hysteresis: border lists do not swap two blocks back
and forth on noise). Ties break to the smaller list id, so the plan is a
pure function of its inputs. :func:`raft_tpu_torch.neighbors.tiered
.apply_plan` executes it.

:class:`TierManager` runs the epochs on live traffic for one tiered index
(any family) served by one probe-accounting
:class:`~raft_tpu_torch.core.executor.SearchExecutor`: its window is the
delta of the executor's lifetime probe ledger
(:meth:`~raft_tpu_torch.core.executor.SearchExecutor.probe_frequencies`),
claimed once an epoch under the manager's lock, and its pacing reads an
injected clock (:meth:`TierManager.tick`), never a wall clock. With a
:class:`~raft_tpu_torch.serving.prefetch.TierPrefetcher` attached, the
tick ``prefetch_lead_s`` before an epoch stages the forecast promotions.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Tuple

import numpy as np

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.validation import expect

EPOCHS = "tier.epochs"
PROMOTIONS = "tier.promotions"
DEMOTIONS = "tier.demotions"


@dataclasses.dataclass(frozen=True)
class PlacementConfig:
    """Epoch policy knobs. ``max_swaps_per_epoch`` is also the fixed swap
    width that ``apply_plan`` checks plans against."""

    epoch_every_s: float = 60.0
    max_swaps_per_epoch: int = 8
    min_heat_ratio: float = 1.5
    prefetch_lead_s: float = 10.0


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    """One epoch's decision: ``promotions[i]`` (a cold list) takes the hot
    slot ``demotions[i]`` frees. ``window_total`` and
    ``hot_window_fraction`` (the share of the window's probes that landed
    on hot lists) are the evidence it was computed from."""

    promotions: Tuple[int, ...]
    demotions: Tuple[int, ...]
    window_total: int
    hot_window_fraction: float


def plan_epoch(window_counts, hot_lists, cold_lists, *,
               max_swaps: int = 8,
               min_heat_ratio: float = 1.5) -> PlacementPlan:
    """The epoch function, pure and deterministic: pair the hottest cold
    lists against the coldest hot lists and keep each pair while the cold
    side's count beats the hot side's by ``min_heat_ratio`` (a cold list
    with no traffic never promotes; a hot list with none demotes against
    any cold traffic). Ties break to the smaller list id on both sides."""
    counts = np.asarray(window_counts, np.int64)
    hot = np.asarray(hot_lists, np.int64)
    cold = np.asarray(cold_lists, np.int64)
    total = int(counts.sum())
    hot_frac = float(counts[hot].sum() / total) if total > 0 else 0.0
    # hottest cold first / coldest hot first, ties to the smaller id
    # (lexsort's last key is the primary one)
    cold_order = cold[np.lexsort((cold, -counts[cold]))]
    hot_order = hot[np.lexsort((hot, counts[hot]))]
    promotions, demotions = [], []
    for c, h in zip(cold_order[:max_swaps], hot_order[:max_swaps]):
        cc, hc = int(counts[c]), int(counts[h])
        if cc <= 0 or cc < min_heat_ratio * hc:
            break
        promotions.append(int(c))
        demotions.append(int(h))
    return PlacementPlan(promotions=tuple(promotions),
                         demotions=tuple(demotions),
                         window_total=total,
                         hot_window_fraction=hot_frac)


class TierManager:
    """Drives placement epochs for one tiered index served by one
    probe-accounting executor.

    The traffic window is the delta of the executor's lifetime probe
    ledger since the last epoch: however many scrapers also claim device
    windows, no probe is lost to placement or counted twice. Epochs fire
    from the injected ``clock`` when :meth:`tick` sees ``epoch_every_s``
    elapsed, or directly from :meth:`epoch`.

    Gauges: ``tier.{hot_lists,cold_lists,hot_bytes,cold_bytes,
    host_resident,hot_window_fraction,last_swaps,window_total}`` (and
    ``tier.prefetch.{enabled,capacity,staged,staged_bytes}`` with a
    prefetcher); counters ``tier.{epochs,promotions,demotions}`` here and
    ``tier.{swaps,swap_bytes,promote_cold_bytes}`` in ``apply_plan``.
    """

    def __init__(self, tiered, executor, *,
                 config: Optional[PlacementConfig] = None, clock=None,
                 prefetcher=None):
        from raft_tpu_torch.serving.batcher import MonotonicClock

        expect(getattr(executor, "probe_accounting", False),
               "TierManager needs a probe-accounting SearchExecutor "
               "(SearchExecutor(probe_accounting=True)): placement without "
               "the traffic signal would be blind")
        self.tiered = tiered
        self.executor = executor
        self.config = config or PlacementConfig()
        self._clock = clock or MonotonicClock()
        self._lock = threading.Lock()
        self._last_epoch_t: Optional[float] = None   # guarded-by: _lock
        self._last_counts: Optional[np.ndarray] = None  # guarded-by: _lock
        self._epochs = 0                             # guarded-by: _lock
        self._last_plan: Optional[PlacementPlan] = None  # guarded-by: _lock
        self.prefetcher = prefetcher
        # one prefetch per epoch window: armed at each epoch, spent at the
        # lead-time tick
        self._prefetch_armed = True                  # guarded-by: _lock

    def enable_prefetch(self, *, config=None, ledger=None):
        """Attach a :class:`~raft_tpu_torch.serving.prefetch
        .TierPrefetcher` sized to this manager's swap width and return it
        (one left with no capacity by the ledger still attaches: every
        call then takes the reactive path)."""
        from raft_tpu_torch.serving.prefetch import TierPrefetcher

        self.prefetcher = TierPrefetcher(
            self.tiered, width=self.config.max_swaps_per_epoch,
            config=config, ledger=ledger)
        return self.prefetcher

    # -- the epoch ----------------------------------------------------------

    def _ledger_counts(self) -> np.ndarray:
        label = self.executor.probe_label(self.tiered)
        n = self.tiered.n_lists
        if label is None:
            return np.zeros((n,), np.int64)
        return self.executor.probe_frequencies().get(
            label, np.zeros((n,), np.int64))

    def _claim_window_locked(self) -> np.ndarray:
        """This epoch's window: the lifetime ledger's delta since the last
        claim (zeros before the first accounted dispatch)."""
        counts = self._ledger_counts()
        last = self._last_counts
        self._last_counts = counts
        return counts.copy() if last is None else counts - last

    def _peek_window_locked(self) -> np.ndarray:
        """The window accumulating toward the next epoch, read-only: the
        claim's baseline does not move, so the epoch still folds every
        probe once (the prefetcher's forecast input)."""
        counts = self._ledger_counts()
        if self._last_counts is None:
            return counts.copy()
        return counts - self._last_counts

    def _epoch_locked(self) -> PlacementPlan:
        """The epoch body, one critical section: the window is claimed
        once and that one claim feeds the plan and the prefetcher's
        forecast."""
        from raft_tpu_torch.neighbors.tiered import apply_plan

        cfg = self.config
        window = self._claim_window_locked()
        pf = self.prefetcher
        if pf is not None:
            pf.observe(window)
        with self.tiered._swap_lock:
            hot = self.tiered.hot_lists.copy()
            cold = self.tiered.cold_lists.copy()
            generation = self.tiered.generation
        plan = plan_epoch(window, hot, cold,
                          max_swaps=cfg.max_swaps_per_epoch,
                          min_heat_ratio=cfg.min_heat_ratio)
        staged = None
        if pf is not None and plan.promotions:
            # stale rows (staged against an older generation) are refused
            # inside take() and counted cancelled
            staged = pf.take(plan.promotions, generation)
        apply_plan(self.tiered, plan.promotions, plan.demotions,
                   width=cfg.max_swaps_per_epoch, executor=self.executor,
                   staged=staged)
        self._epochs += 1
        self._last_plan = plan
        self._prefetch_armed = True
        return plan

    def _count_epoch(self, plan: PlacementPlan) -> None:
        tracing.inc_counters({
            EPOCHS: 1.0,
            PROMOTIONS: float(len(plan.promotions)),
            DEMOTIONS: float(len(plan.demotions)),
        })
        self.publish_gauges()

    def epoch(self) -> PlacementPlan:
        """Run one placement epoch now: claim the window, plan, swap.
        Returns the plan (an empty plan moves nothing)."""
        with self._lock:
            plan = self._epoch_locked()
        self._count_epoch(plan)
        return plan

    def tick(self) -> Optional[PlacementPlan]:
        """Scrape-driven pacing on the injected clock: the first tick
        stamps the baseline; a tick ``epoch_every_s`` after the last epoch
        runs one (never more than one, however many periods passed), under
        the same lock acquisition that read the clock's verdict. With a
        prefetcher, the first tick within ``prefetch_lead_s`` of the next
        epoch stages the forecast promotions, and every tick that runs no
        epoch lets the prefetcher evict under shrinking headroom; both
        outside the lock, so the background channel never blocks an
        epoch."""
        now = self._clock.now()
        plan = partial = None
        cfg = self.config
        with self._lock:
            if self._last_epoch_t is None:
                self._last_epoch_t = now
            elif now - self._last_epoch_t >= cfg.epoch_every_s:
                self._last_epoch_t = now
                plan = self._epoch_locked()
            elif (self.prefetcher is not None and self._prefetch_armed
                  and now - self._last_epoch_t
                  >= cfg.epoch_every_s - cfg.prefetch_lead_s):
                self._prefetch_armed = False
                partial = self._peek_window_locked()
        if plan is not None:
            self._count_epoch(plan)
            return plan
        if partial is not None:
            self.prefetcher.prefetch(max_swaps=cfg.max_swaps_per_epoch,
                                     window=partial)
        if self.prefetcher is not None:
            self.prefetcher.maintain()
        return None

    # -- the scrape surface -------------------------------------------------

    def publish_gauges(self) -> None:
        """Set the ``tier.*`` gauges from the layout and the last plan."""
        t = self.tiered
        with self._lock:
            plan = self._last_plan
        vals = {
            "tier.hot_lists": float(t.n_hot),
            "tier.cold_lists": float(t.n_cold),
            "tier.hot_bytes": float(t.hot_bytes),
            "tier.cold_bytes": float(t.cold_bytes),
            "tier.host_resident": 1.0 if t.host_resident else 0.0,
            "tier.last_swaps": float(len(plan.promotions)) if plan else 0.0,
            "tier.window_total": float(plan.window_total) if plan else 0.0,
            "tier.hot_window_fraction":
                plan.hot_window_fraction if plan else 0.0,
        }
        if self.prefetcher is not None:
            ps = self.prefetcher.snapshot()
            vals["tier.prefetch.enabled"] = 1.0 if ps["enabled"] else 0.0
            vals["tier.prefetch.capacity"] = float(ps["capacity"])
            vals["tier.prefetch.staged"] = float(ps["staged"])
            vals["tier.prefetch.staged_bytes"] = float(ps["staged_bytes"])
        tracing.set_gauges(vals)

    def snapshot(self) -> dict:
        """The ``/tier.json`` body: the live layout, the last epoch's plan
        and evidence, and the policy config."""
        with self._lock:
            plan = self._last_plan
            epochs = self._epochs
        cfg = self.config
        return {
            "layout": self.tiered.layout(),
            "epochs": epochs,
            "config": {
                "epoch_every_s": cfg.epoch_every_s,
                "max_swaps_per_epoch": cfg.max_swaps_per_epoch,
                "min_heat_ratio": cfg.min_heat_ratio,
                "prefetch_lead_s": cfg.prefetch_lead_s,
            },
            "last_plan": None if plan is None else {
                "promotions": list(plan.promotions),
                "demotions": list(plan.demotions),
                "window_total": plan.window_total,
                "hot_window_fraction": plan.hot_window_fraction,
            },
            "prefetch": (self.prefetcher.snapshot()
                         if self.prefetcher is not None else None),
        }
