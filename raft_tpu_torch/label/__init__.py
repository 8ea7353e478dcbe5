"""Label utilities — port of ``raft_tpu/label`` (reference
``raft/label/``: ``classlabels.cuh``'s ``getUniquelabels`` /
``getOvrlabels`` / ``make_monotonic``; ``merge_labels.cuh``'s union-find
label merge).
"""

from raft_tpu_torch.label.classlabels import (
    get_unique_labels,
    make_monotonic,
    merge_labels,
    ovr_labels,
)

__all__ = [
    "get_unique_labels",
    "make_monotonic",
    "merge_labels",
    "ovr_labels",
]
