"""Checkpoint / resume of the list-sharded indexes — port of
``raft_tpu/distributed/checkpoint.py``, in the JAX package's on-disk
records (a checkpoint either package writes loads into the other).

Format: the versioned ``.npy``-record stream of the single-device
indexes, the arrays written in their global (dealt) list order. ``load``
takes a :class:`~raft_tpu_torch.comms.comms.Comms` and RE-DEALS the lists
round-robin by population for the target mesh before sharding them, so
the shard count may differ between save and load.

- ``save_*`` / ``load_*``: one file of the whole index.
- ``save_*_multihost`` / ``load_*_multihost``: per process. A process of
  a ``torch.distributed`` group holds one contiguous block of the global
  dealt lists on its own slots (equal blocks, in process-rank order);
  each writes ``<dir>/part<rank>.bin`` with its block and its start row,
  rank 0 adds ``meta.bin`` (scalars and replicated arrays), and the
  writers meet at a barrier. A load reads every part, reassembles the
  global dealt order and re-deals it over the caller's comms, so the
  process count may differ too. Outside a process group the process is
  rank 0 of 1.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from raft_tpu_torch.comms.comms import Comms
from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.serialize import (
    check_version,
    deserialize_array,
    deserialize_scalar,
    open_maybe_path,
    serialize_array,
    serialize_scalar,
)
from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.distributed.ivf import (
    DistributedIvfFlat,
    DistributedIvfPq,
    deal_order,
    from_numpy,
    from_numpy_pq,
)
from raft_tpu_torch.neighbors.ivf_pq import CodebookKind

# distinct magic+version per kind, the JAX package's
_FLAT_VERSION = 0x4601  # 'F' << 8 | 1
_PQ_VERSION = 0x5001    # 'P' << 8 | 1
_BQ_VERSION = 0x4203    # 'B' << 8 | 3


def _fetch(comms: Comms, parts) -> np.ndarray:
    """The global (dealt-order) host array of a per-slot list."""
    return comms.assemble(parts).cpu().numpy()


def _rep(parts) -> np.ndarray:
    return parts[0].cpu().numpy()


def _flat_fields(index: DistributedIvfFlat):
    return [index.centers, index.data, index.data_norms, index.indices,
            index.list_sizes]


def _bq_fields(index):
    return [index.centers, index.codes, index.rnorm, index.cfac, index.errw,
            index.indices, index.list_sizes]


def save_flat(index: DistributedIvfFlat, fh_or_path) -> None:
    """Write a sharded IVF-Flat index; list order is the dealt order."""
    fh, own = open_maybe_path(fh_or_path, "wb")
    try:
        with tracing.range("raft_tpu.distributed.checkpoint.save_flat"):
            serialize_scalar(fh, _FLAT_VERSION, np.int32)
            serialize_scalar(fh, int(index.metric), np.int32)
            for a in _flat_fields(index):
                serialize_array(fh, _fetch(index.comms, a))
    finally:
        if own:
            fh.close()


def _redeal(comms: Comms, sizes: np.ndarray):
    expect(len(sizes) % comms.size == 0,
           f"the mesh axis ({comms.size}) must divide n_lists {len(sizes)}")
    deal = deal_order(np.asarray(sizes), comms.size)
    return deal, (lambda a: None if a is None
                  else np.ascontiguousarray(np.asarray(a)[deal]))


def _flat_from(comms, metric, centers, data, norms, indices, sizes):
    _, perm = _redeal(comms, sizes)
    return from_numpy(comms, perm(centers), perm(data), perm(indices),
                      perm(sizes), metric, data_norms=perm(norms))


def load_flat(res, comms: Comms, fh_or_path) -> DistributedIvfFlat:
    """Restore onto ``comms``'s mesh (re-dealt; the mesh axis must divide
    ``n_lists``)."""
    del res
    fh, own = open_maybe_path(fh_or_path, "rb")
    try:
        check_version(int(deserialize_scalar(fh)), _FLAT_VERSION,
                      "distributed ivf_flat")
        metric = DistanceType(int(deserialize_scalar(fh)))
        arrays = [deserialize_array(fh).numpy() for _ in range(5)]
    finally:
        if own:
            fh.close()
    return _flat_from(comms, metric, *arrays)


def save_pq(index: DistributedIvfPq, fh_or_path) -> None:
    """Write a sharded IVF-PQ index (unpacked codes)."""
    fh, own = open_maybe_path(fh_or_path, "wb")
    try:
        with tracing.range("raft_tpu.distributed.checkpoint.save_pq"):
            serialize_scalar(fh, _PQ_VERSION, np.int32)
            serialize_scalar(fh, int(index.metric), np.int32)
            serialize_scalar(fh, int(index.codebook_kind), np.int32)
            serialize_scalar(fh, index.pq_bits, np.int32)
            per_cluster = index.codebook_kind == CodebookKind.PER_CLUSTER
            c = index.comms
            serialize_array(fh, _fetch(c, index.centers))
            serialize_array(fh, _rep(index.rotation))
            serialize_array(fh, _fetch(c, index.codebooks) if per_cluster
                            else _rep(index.codebooks))
            serialize_array(fh, _fetch(c, index.codes))
            serialize_array(fh, _fetch(c, index.indices))
            serialize_array(fh, _fetch(c, index.list_sizes))
    finally:
        if own:
            fh.close()


def _pq_from(comms, metric, kind, pq_bits, centers, rotation, codebooks,
             codes, indices, sizes):
    _, perm = _redeal(comms, sizes)
    per_cluster = kind == CodebookKind.PER_CLUSTER
    return from_numpy_pq(
        comms, perm(centers), rotation,
        perm(codebooks) if per_cluster else codebooks, perm(codes),
        perm(indices), perm(sizes), metric, pq_bits, kind)


def load_pq(res, comms: Comms, fh_or_path) -> DistributedIvfPq:
    del res
    fh, own = open_maybe_path(fh_or_path, "rb")
    try:
        check_version(int(deserialize_scalar(fh)), _PQ_VERSION,
                      "distributed ivf_pq")
        metric = DistanceType(int(deserialize_scalar(fh)))
        kind = CodebookKind(int(deserialize_scalar(fh)))
        pq_bits = int(deserialize_scalar(fh))
        arrays = [deserialize_array(fh).numpy() for _ in range(6)]
    finally:
        if own:
            fh.close()
    return _pq_from(comms, metric, kind, pq_bits, *arrays)


def save_bq(index, fh_or_path) -> None:
    """Write a sharded IVF-BQ index (sign codes, RaBitQ correction
    scalars, the optional rerank plane)."""
    fh, own = open_maybe_path(fh_or_path, "wb")
    try:
        with tracing.range("raft_tpu.distributed.checkpoint.save_bq"):
            serialize_scalar(fh, _BQ_VERSION, np.int32)
            serialize_scalar(fh, int(index.metric), np.int32)
            serialize_scalar(fh, index.bits, np.int32)
            serialize_scalar(fh, int(index.data is not None), np.int32)
            c = index.comms
            serialize_array(fh, _fetch(c, index.centers))
            serialize_array(fh, _rep(index.rotation))
            for a in _bq_fields(index)[1:]:
                serialize_array(fh, _fetch(c, a))
            if index.data is not None:
                serialize_array(fh, _fetch(c, index.data))
    finally:
        if own:
            fh.close()


def _bq_from(comms, metric, rotation, centers, codes, rnorm, cfac, errw,
             indices, sizes, data):
    from raft_tpu_torch.distributed.bq import (
        from_numpy_bq,
        shard_rel_err_from_arrays,
    )

    deal, perm = _redeal(comms, sizes)
    rel = shard_rel_err_from_arrays(errw, rnorm, indices,
                                    np.asarray(rotation).shape[0], deal,
                                    comms.size)
    return from_numpy_bq(comms, perm(centers), rotation, perm(codes),
                         perm(rnorm), perm(cfac), perm(errw), perm(indices),
                         perm(sizes), metric, perm(data), rel)


def load_bq(res, comms: Comms, fh_or_path):
    """Restore onto ``comms``'s mesh with the re-deal; the per-shard
    estimator-error stats re-derive for the new deal."""
    del res
    fh, own = open_maybe_path(fh_or_path, "rb")
    try:
        check_version(int(deserialize_scalar(fh)), _BQ_VERSION,
                      "distributed ivf_bq")
        metric = DistanceType(int(deserialize_scalar(fh)))
        int(deserialize_scalar(fh))   # bits: recorded, shape-derivable
        has_data = bool(deserialize_scalar(fh))
        arrays = [deserialize_array(fh).numpy() for _ in range(8)]
        data = deserialize_array(fh).numpy() if has_data else None
    finally:
        if own:
            fh.close()
    (centers, rotation, codes, rnorm, cfac, errw, indices, sizes) = arrays
    return _bq_from(comms, metric, rotation, centers, codes, rnorm, cfac,
                    errw, indices, sizes, data)


# ---------------------------------------------------------------------------
# the per-process scheme
# ---------------------------------------------------------------------------


def _process() -> tuple:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier() -> None:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def _save_parts(dirpath, version: int, comms: Comms, sharded, meta_scalars,
                meta_arrays) -> None:
    """Write this process's part (+ meta from rank 0), then meet the
    other writers at a barrier. ``sharded`` are per-slot lists of the
    process's block; its start row is ``rank * block rows``."""
    me, n_parts = _process()
    os.makedirs(dirpath, exist_ok=True)
    blocks = [_fetch(comms, a) for a in sharded]
    start = me * blocks[0].shape[0]
    with open(os.path.join(dirpath, f"part{me:05d}.bin"), "wb") as fh:
        serialize_scalar(fh, version, np.int32)
        for b in blocks:
            serialize_array(fh, b)
        serialize_scalar(fh, start, np.int64)
    if me == 0:
        # a re-save into a directory must leave no stale higher parts
        for stale in glob.glob(os.path.join(dirpath, "part*.bin")):
            if int(os.path.basename(stale)[4:9]) >= n_parts:
                os.remove(stale)
        with open(os.path.join(dirpath, "meta.bin"), "wb") as fh:
            serialize_scalar(fh, version, np.int32)
            serialize_scalar(fh, n_parts, np.int32)
            for s in meta_scalars:
                serialize_scalar(fh, int(s), np.int32)
            for a in meta_arrays:
                serialize_array(fh, a)
    _barrier()


def _load_parts(dirpath, version: int, what: str, n_sharded: int,
                n_scalars: int, n_meta_arrays: int):
    """Read meta and every part; each field reassembled in the global
    dealt order."""
    with open(os.path.join(dirpath, "meta.bin"), "rb") as fh:
        check_version(int(deserialize_scalar(fh)), version, what)
        n_parts = int(deserialize_scalar(fh))
        scalars = [int(deserialize_scalar(fh)) for _ in range(n_scalars)]
        metas = [deserialize_array(fh).numpy() for _ in range(n_meta_arrays)]
    paths = sorted(glob.glob(os.path.join(dirpath, "part*.bin")))
    expect(len(paths) == n_parts,
           f"checkpoint dir has {len(paths)} part files, meta says "
           f"{n_parts} — mixed checkpoints in one directory?")
    parts = []
    for p in paths:
        with open(p, "rb") as fh:
            check_version(int(deserialize_scalar(fh)), version, what)
            arrays = [deserialize_array(fh).numpy()
                      for _ in range(n_sharded)]
            start = int(deserialize_scalar(fh))
        parts.append((start, arrays))
    parts.sort(key=lambda t: t[0])
    fields = [np.concatenate([p[1][i] for p in parts], axis=0)
              for i in range(n_sharded)]
    return scalars, metas, fields


def _peek_scalars(dirpath, version: int, what: str, n: int) -> list:
    with open(os.path.join(dirpath, "meta.bin"), "rb") as fh:
        check_version(int(deserialize_scalar(fh)), version, what)
        deserialize_scalar(fh)   # n_parts
        return [int(deserialize_scalar(fh)) for _ in range(n)]


def save_flat_multihost(index: DistributedIvfFlat, dirpath) -> None:
    """Per-process IVF-Flat checkpoint (see the module docstring)."""
    with tracing.range("raft_tpu.distributed.checkpoint.save_flat_mh"):
        _save_parts(dirpath, _FLAT_VERSION, index.comms,
                    _flat_fields(index), [int(index.metric)], [])


def load_flat_multihost(res, comms: Comms, dirpath) -> DistributedIvfFlat:
    del res
    scalars, _, fields = _load_parts(dirpath, _FLAT_VERSION,
                                     "distributed ivf_flat", 5, 1, 0)
    return _flat_from(comms, DistanceType(scalars[0]), *fields)


def save_pq_multihost(index: DistributedIvfPq, dirpath) -> None:
    """Per-process IVF-PQ checkpoint: PER_CLUSTER codebooks ride the
    parts, PER_SUBSPACE ones meta.bin."""
    per_cluster = index.codebook_kind == CodebookKind.PER_CLUSTER
    sharded = [index.centers, index.codes, index.indices, index.list_sizes]
    metas = [_rep(index.rotation)]
    if per_cluster:
        sharded.append(index.codebooks)
    else:
        metas.append(_rep(index.codebooks))
    with tracing.range("raft_tpu.distributed.checkpoint.save_pq_mh"):
        _save_parts(dirpath, _PQ_VERSION, index.comms, sharded,
                    [int(index.metric), int(index.codebook_kind),
                     index.pq_bits], metas)


def load_pq_multihost(res, comms: Comms, dirpath) -> DistributedIvfPq:
    del res
    kind = CodebookKind(_peek_scalars(dirpath, _PQ_VERSION,
                                      "distributed ivf_pq", 2)[1])
    per_cluster = kind == CodebookKind.PER_CLUSTER
    scalars, metas, fields = _load_parts(
        dirpath, _PQ_VERSION, "distributed ivf_pq",
        5 if per_cluster else 4, 3, 1 if per_cluster else 2)
    if per_cluster:
        centers, codes, indices, sizes, codebooks = fields
        rotation = metas[0]
    else:
        centers, codes, indices, sizes = fields
        rotation, codebooks = metas
    return _pq_from(comms, DistanceType(scalars[0]), kind, scalars[2],
                    centers, rotation, codebooks, codes, indices, sizes)


def save_bq_multihost(index, dirpath) -> None:
    """Per-process IVF-BQ checkpoint (the rerank plane rides as an extra
    sharded field, flagged in the meta)."""
    fields = _bq_fields(index)
    if index.data is not None:
        fields.append(index.data)
    with tracing.range("raft_tpu.distributed.checkpoint.save_bq_mh"):
        _save_parts(dirpath, _BQ_VERSION, index.comms, fields,
                    [int(index.metric), index.bits,
                     int(index.data is not None)], [_rep(index.rotation)])


def load_bq_multihost(res, comms: Comms, dirpath):
    del res
    has_data = bool(_peek_scalars(dirpath, _BQ_VERSION,
                                  "distributed ivf_bq", 3)[2])
    scalars, metas, fields = _load_parts(
        dirpath, _BQ_VERSION, "distributed ivf_bq", 8 if has_data else 7, 3,
        1)
    centers, codes, rnorm, cfac, errw, indices, sizes = fields[:7]
    data = fields[7] if has_data else None
    return _bq_from(comms, DistanceType(scalars[0]), metas[0], centers,
                    codes, rnorm, cfac, errw, indices, sizes, data)
