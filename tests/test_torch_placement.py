"""The port's placement policy against the JAX package's: ``plan_epoch``
is pure numpy in both, so every plan must be equal field for field
(promotions, demotions, window total, hot share) on the same window and
assignment."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from raft_tpu.serving import placement as j_placement
from raft_tpu_torch.serving import placement

CASES = {
    # two hot/cold pairs swap, the third cold list stays
    "pairs": ([0, 100, 5, 50, 2, 0], [0, 2], [1, 3, 4, 5], {}),
    # 14 < 1.5 x 10: hysteresis holds the border pair ...
    "hysteresis": ([10, 14, 0, 0], [0], [1, 2, 3], {}),
    # ... and lets it through at a lower ratio
    "hysteresis-1.2": ([10, 14, 0, 0], [0], [1, 2, 3],
                       {"min_heat_ratio": 1.2}),
    "zero-traffic": ([0, 0, 0, 0], [0, 1], [2, 3], {}),
    "max-swaps": ([0, 0, 0, 9, 9, 9], [0, 1, 2], [3, 4, 5],
                  {"max_swaps": 2}),
    "ties": ([0, 0, 7, 7], [0, 1], [2, 3], {"max_swaps": 1}),
    "ties-hot": ([3, 3, 3, 9, 9], [0, 1, 2], [3, 4], {}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plan_epoch_matches_reference(name):
    counts, hot, cold, kw = CASES[name]
    want = j_placement.plan_epoch(np.asarray(counts), hot, cold, **kw)
    got = placement.plan_epoch(np.asarray(counts), hot, cold, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_plan_epoch_expected_plans():
    counts, hot, cold, _ = CASES["pairs"]
    plan = placement.plan_epoch(counts, hot, cold)
    assert (plan.promotions, plan.demotions) == ((1, 3), (0, 2))
    assert plan.window_total == 157
    assert plan.hot_window_fraction == pytest.approx(5 / 157)
    assert placement.plan_epoch(*CASES["hysteresis"][:3]).promotions == ()
    assert placement.plan_epoch(*CASES["zero-traffic"][:3]).promotions == ()
    plan = placement.plan_epoch(*CASES["ties"][:3], max_swaps=1)
    assert (plan.promotions, plan.demotions) == ((2,), (0,))


def test_random_windows_match_reference():
    rng = np.random.default_rng(5)
    for _ in range(20):
        counts = rng.integers(0, 6, size=32)      # small counts: many ties
        perm = rng.permutation(32)
        hot, cold = np.sort(perm[:12]), np.sort(perm[12:])
        kw = dict(max_swaps=int(rng.integers(1, 10)),
                  min_heat_ratio=float(rng.choice([1.0, 1.5, 2.0])))
        want = j_placement.plan_epoch(counts, hot, cold, **kw)
        got = placement.plan_epoch(counts, hot, cold, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_config_defaults_match_reference():
    assert (dataclasses.asdict(placement.PlacementConfig())
            == dataclasses.asdict(j_placement.PlacementConfig()))
