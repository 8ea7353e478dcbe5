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

Not ported yet: ``TierManager``, which runs epochs from the executor's
probe accounting (:meth:`raft_tpu_torch.core.executor.SearchExecutor
.probe_frequencies`), with the prefetcher (ROADMAP Queue 1, the tiered
remainder).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


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
