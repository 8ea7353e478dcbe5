"""Class-label utilities — port of ``raft_tpu/label/classlabels.py``
(reference ``raft/label/classlabels.cuh`` and ``merge_labels.cuh``).

``merge_labels`` is the reference's union-find-flavored label
reconciliation used by connected components: pointer jumping over a
min-label table, ``ceil(log2 n)`` fixed rounds (a segment min is a
``scatter_reduce`` onto a table filled with the int32 maximum).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.core.resources import Resources, ensure_resources

_INT32_MAX = torch.iinfo(torch.int32).max


def get_unique_labels(res: Optional[Resources], labels) -> torch.Tensor:
    """Sorted unique labels — ``label::getUniquelabels`` (its size is
    data-dependent, like the reference's two-pass count+fill)."""
    res = ensure_resources(res)
    return torch.unique(res.put(labels), sorted=True)


def make_monotonic(
    res: Optional[Resources], labels, classes=None
) -> torch.Tensor:
    """Map arbitrary label values onto 0..n_classes-1 —
    ``label::make_monotonic``."""
    res = ensure_resources(res)
    labels = res.put(labels)
    if classes is None:
        classes = get_unique_labels(res, labels)
    classes = res.put(classes).to(labels.dtype)
    # rank of each label within the sorted class table
    return torch.searchsorted(classes.contiguous(),
                              labels.contiguous()).to(torch.int32)


def ovr_labels(res: Optional[Resources], labels, target) -> torch.Tensor:
    """One-vs-rest relabeling: 1 where ``labels == target`` else 0 —
    ``label::getOvrlabels``."""
    res = ensure_resources(res)
    return (res.put(labels) == target).to(torch.int32)


def merge_labels(
    res: Optional[Resources],
    labels_a,
    labels_b,
    mask=None,
) -> torch.Tensor:
    """Merge two label assignments: rows sharing a label in either input
    end up with one common (minimum) label — ``label::merge_labels``
    (``merge_labels.cuh``; used to stitch connected components computed
    in batches).

    ``mask`` restricts which rows participate (unmasked rows keep
    ``labels_a``).
    """
    res = ensure_resources(res)
    la = res.put(labels_a).to(torch.int32)
    lb = res.put(labels_b).to(torch.int64)
    n = la.shape[0]
    mask = (torch.ones((n,), dtype=torch.bool, device=la.device)
            if mask is None else res.put(mask).to(torch.bool))

    # representative per b-group: min a-label in the group; then propagate
    # a→rep(a) links by pointer jumping until fixed point
    n_groups = n  # b-labels are < n by construction in CC usage
    rounds = max(1, int(np.ceil(np.log2(max(n, 2)))))
    seg = torch.where(mask, lb, n_groups - 1)
    lab = la
    for _ in range(rounds):
        grp_min = torch.full((n_groups,), _INT32_MAX, dtype=torch.int32,
                             device=la.device).scatter_reduce_(
            0, seg, torch.where(mask, lab, _INT32_MAX), "amin")
        new = torch.where(mask, torch.minimum(lab, grp_min[lb]), lab)
        # chase a-labels: label of my label's row (labels index rows in CC)
        chased = new[new.clamp(0, n - 1).to(torch.int64)]
        lab = torch.where(mask, torch.minimum(new, chased), new)
    return lab
