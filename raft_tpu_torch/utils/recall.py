"""Recall with distance-tie tolerance — port of ``raft_tpu/utils/
recall.py`` (reference ``cpp/test/neighbors/ann_utils.cuh:127-210``,
``eval_recall`` / ``eval_neighbours``). Host code: tensors on any device
and numpy arrays are read to the host."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _host(a):
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def eval_recall(expected_idx, actual_idx, expected_dist=None,
                actual_dist=None, eps: float = 1e-3
                ) -> Tuple[float, int, int]:
    """The share of true neighbours found, a returned id outside the true
    set counting when its distance is within ``eps`` (relative, at least
    absolute) of a true neighbour's (the reference's tie handling).
    Returns ``(recall, n_match, n_total)``."""
    expected_idx = _host(expected_idx)
    actual_idx = _host(actual_idx)
    expected_dist = _host(expected_dist)
    actual_dist = _host(actual_dist)
    q, k = expected_idx.shape
    match = 0
    for i in range(q):
        want = set(expected_idx[i].tolist())
        for j, g in enumerate(actual_idx[i].tolist()):
            if g in want:
                match += 1
            elif expected_dist is not None and actual_dist is not None:
                ad = actual_dist[i, j]
                if np.any(np.abs(expected_dist[i] - ad)
                          <= eps * max(1.0, abs(ad))):
                    match += 1
    return match / (q * k), match, q * k


def eval_neighbours(expected_idx, actual_idx, expected_dist, actual_dist,
                    min_recall: float, eps: float = 1e-3) -> float:
    """:func:`eval_recall` that raises ``AssertionError`` below
    ``min_recall - eps``; returns the recall."""
    recall, match, total = eval_recall(expected_idx, actual_idx,
                                       expected_dist, actual_dist, eps)
    if recall < min_recall - eps:
        raise AssertionError(f"recall {recall:.4f} ({match}/{total}) below "
                             f"required {min_recall:.4f}")
    return recall
