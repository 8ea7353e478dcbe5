"""Shared passes of the streaming index builds (flat / PQ / BQ); port of
``raft_tpu/neighbors/_streaming.py``: the three-pass structure over a
:class:`raft_tpu_torch.io.BinDataset` — a strided train sample, per-chunk
label predict + size count, then each index's own encode + scatter pass
(whose rank bookkeeping is :func:`raft_tpu_torch.neighbors._packing.
streaming_ranks`)."""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.core import interruptible


def sample_trainset(source, train_rows: int, chunk_rows: int) -> np.ndarray:
    """Pass 1: a strided ``train_rows``-row sample spanning the whole
    dataset, assembled chunk by chunk (the stride keeps its phase across
    chunk boundaries, so the sample does not depend on ``chunk_rows``).
    Each chunk is a cancellation point (``interruptible.yield_``)."""
    n = source.n_rows
    stride = max(1, n // train_rows)
    parts = []
    for first, chunk in source.iter_chunks(chunk_rows):
        interruptible.yield_()
        offset = (-first) % stride
        parts.append(np.asarray(chunk[offset::stride], np.float32))
    return np.concatenate(parts)[:train_rows]


def label_pass(res, km_params, centers, source, chunk_rows: int,
               n_lists: int):
    """Pass 2: per-chunk nearest-center labels (on the handle's device)
    and per-list populations (host). Returns ``(labels_np, sizes_np)``.
    Each chunk is a cancellation point."""
    n = source.n_rows
    labels_np = np.empty((n,), np.int32)
    for first, chunk in source.iter_chunks(chunk_rows):
        interruptible.yield_()
        lab = kmeans_balanced.predict(res, km_params, centers,
                                      res.put(chunk, torch.float32))
        labels_np[first:first + chunk.shape[0]] = lab.cpu().numpy()
    sizes_np = np.bincount(labels_np, minlength=n_lists)
    return labels_np, sizes_np


def scatter_pass(res, source, labels_np, chunk_rows: int, n_lists: int,
                 scatter) -> None:
    """Pass 3's loop, shared by every streaming build: for each chunk,
    the (list, rank) slot of each row at the running fill of its list
    (:func:`~raft_tpu_torch.neighbors._packing.streaming_ranks`), then
    ``scatter(rows, lists, ranks, ids)`` with the chunk's float32 rows,
    int64 list ids and ranks, and int32 dataset ids on the handle's
    device; ``scatter`` writes its planes in place (``index_put_``).
    Indexing is 2-D (list, rank), so no flat slot index can overflow.
    Each chunk is a cancellation point."""
    from raft_tpu_torch.neighbors._packing import streaming_ranks

    fill = np.zeros((n_lists,), np.int64)
    for first, chunk in source.iter_chunks(chunk_rows):
        interruptible.yield_()
        m = chunk.shape[0]
        lab = labels_np[first:first + m]
        ranks = streaming_ranks(lab, fill, n_lists)
        scatter(res.put(chunk, torch.float32),
                res.put(lab, torch.int64), res.put(ranks, torch.int64),
                res.put(first + np.arange(m, dtype=np.int32)))
