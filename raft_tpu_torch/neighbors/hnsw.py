"""CAGRA ⇄ hnswlib interop — port of ``raft_tpu/neighbors/hnsw.py``, the
analog of the reference's ``raft::neighbors::hnsw`` bridge
(``cagra_serialize.cuh``'s ``serialize_to_hnswlib``).

``save_hnswlib`` writes a CAGRA index as a *flat* (single-level)
hnswlib-format file that stock ``hnswlib.Index.load_index`` accepts:
every element sits at level 0 with the full CAGRA ``graph_degree`` as
its level-0 link list, ``maxlevel = 0`` and entrypoint 0, so hnswlib's
search descends straight into the level-0 beam search over the CAGRA
graph. The layout below mirrors ``hnswalg.h``'s ``saveIndex`` field by
field (all scalars little-endian; ``size_t``/``labeltype`` = u64,
``tableint``/``linklistsizeint`` = u32):

    offsetLevel0  u64   = 0
    max_elements  u64   = n
    cur_count     u64   = n
    size_per_elem u64   = 4 + 4*maxM0 + data_bytes + 8
    label_offset  u64   = 4 + 4*maxM0 + data_bytes
    offset_data   u64   = 4 + 4*maxM0
    maxlevel      i32   = 0
    entrypoint    u32   = 0
    maxM          u64   = graph_degree / 2
    maxM0         u64   = graph_degree
    M             u64   = graph_degree / 2
    mult          f64   = 1 / ln(M)
    ef_constr     u64   (cosmetic; hnswlib only replays it)
    n × [ u32 n_links | u32 links[maxM0] | vector | u64 label ]
    n × [ u32 0 ]       (no upper levels)

The file is byte-identical to the JAX package's for the same graph and
dataset. ``load_hnswlib`` is the reverse bridge: it parses any
level-0-complete hnswlib file (including ones produced by hnswlib
itself) back into a :class:`~raft_tpu_torch.neighbors.cagra.CagraIndex`
on the handle's device, so a foreign HNSW graph is searched by the CAGRA
beam-search kernel. The loaded index has no seed or BQ plane: its
searches seed from the strided pool.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.resources import Resources
from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors.cagra import CagraIndex, from_graph

_HDR = struct.Struct("<QQQQQQiIQQQdQ")  # fields in docstring order

_TORCH_DTYPES = {torch.float32: np.float32, torch.int8: np.int8,
                 torch.uint8: np.uint8}


def _data_dtype(dtype) -> np.dtype:
    """The element type of a dataset dtype (numpy or torch)."""
    if isinstance(dtype, torch.dtype):
        dtype = _TORCH_DTYPES.get(dtype, dtype)
    ok = not isinstance(dtype, torch.dtype) and np.dtype(dtype) in (
        np.dtype(np.float32), np.dtype(np.int8), np.dtype(np.uint8))
    expect(ok, f"hnswlib interop supports f32/int8/uint8 datasets, got "
               f"{dtype} (cast bf16 datasets to float32 first)")
    return np.dtype(dtype)


def save_hnswlib(res: Optional[Resources], index: CagraIndex, path: str,
                 ef_construction: int = 500) -> None:
    """Serialize ``index`` into hnswlib's native file format (see module
    docstring for the exact layout). Float32 exports load with stock
    ``hnswlib.Index(space, dim).load_index(path)`` — ``space='l2'`` for
    the L2 metrics, ``'ip'`` for InnerProduct. int8/uint8 exports use the
    same layout with 1-byte elements, which stock hnswlib's float spaces
    do not read — they round-trip through :func:`load_hnswlib`."""
    del res
    dt = _data_dtype(index.dataset.dtype)
    dataset = index.dataset.detach().cpu().numpy()
    graph = index.graph.detach().cpu().numpy().astype(np.uint32)
    n, degree = graph.shape
    expect(dataset.shape[0] == n, "graph/dataset row mismatch")
    data_bytes = dataset.shape[1] * dt.itemsize
    m = max(degree // 2, 1)
    size_links0 = 4 + 4 * degree
    size_per_elem = size_links0 + data_bytes + 8

    with tracing.range("raft_tpu.hnsw.save_hnswlib"):
        # one structured-array write instead of n struct.pack loops
        elem = np.dtype([
            ("n_links", "<u4"),
            ("links", "<u4", (degree,)),
            ("data", dt.newbyteorder("<"), (dataset.shape[1],)),
            ("label", "<u8"),
        ])
        expect(elem.itemsize == size_per_elem, "element layout mismatch")
        block = np.empty(n, dtype=elem)
        block["n_links"] = degree
        block["links"] = graph
        block["data"] = dataset
        block["label"] = np.arange(n, dtype=np.uint64)

        with open(path, "wb") as f:
            f.write(_HDR.pack(0, n, n, size_per_elem,
                              size_links0 + data_bytes, size_links0,
                              0, 0, m, degree, m,
                              1.0 / float(np.log(max(m, 2))),
                              ef_construction))
            f.write(block.tobytes())
            f.write(np.zeros(n, dtype="<u4").tobytes())


def load_hnswlib(res: Optional[Resources], path: str, dim: int,
                 metric: DistanceType = DistanceType.L2Expanded,
                 dtype=np.float32) -> CagraIndex:
    """Parse an hnswlib index file into a :class:`CagraIndex` (level-0
    graph + vectors) on the handle's device. Rows with fewer than
    ``maxM0`` links are padded by repeating their first link (a no-op for
    the beam search's dedup). ``dim``/``dtype`` (numpy or torch) play the
    role of hnswlib's ``SpaceInterface`` — the file itself does not
    record them."""
    dt = _data_dtype(dtype)
    with tracing.range("raft_tpu.hnsw.load_hnswlib"), open(path, "rb") as f:
        raw = f.read()
    (off0, max_elems, n, size_per_elem, label_off, data_off,
     _maxlevel, _entry, _max_m, max_m0, _m, _mult, _efc) = \
        _HDR.unpack_from(raw, 0)
    expect(off0 == 0, "multi-section hnswlib files are not supported")
    expect(n <= max_elems, "corrupt hnswlib header (count > capacity)")
    data_bytes = dim * dt.itemsize
    expect(data_off == 4 + 4 * max_m0,
           f"level-0 link block mismatch: dim/space wrong? "
           f"(offset_data {data_off} != {4 + 4 * max_m0})")
    expect(label_off == data_off + data_bytes and
           size_per_elem == label_off + 8,
           f"element layout mismatch for dim={dim} itemsize={dt.itemsize}")
    body = _HDR.size + n * size_per_elem
    expect(len(raw) >= body, "truncated hnswlib file")

    elem = np.dtype([
        ("n_links", "<u4"),
        ("links", "<u4", (max_m0,)),
        ("data", dt.newbyteorder("<"), (dim,)),
        ("label", "<u8"),
    ])
    block = np.frombuffer(raw, dtype=elem, count=n, offset=_HDR.size)
    counts = block["n_links"].astype(np.int64)
    expect(bool((counts <= max_m0).all()), "corrupt link counts")
    links = block["links"].astype(np.int64)
    expect(bool((links[np.arange(max_m0) < counts[:, None]] < n).all()),
           "link id out of range")
    # pad short rows with their first link (self-loop if empty)
    first = np.where(counts > 0, links[:, 0], np.arange(n))
    pad = np.arange(max_m0)[None, :] >= counts[:, None]
    graph = np.where(pad, first[:, None], links)

    # hnswlib insertion order is not label order — undo the permutation
    labels = block["label"].astype(np.int64)
    expect(bool((labels < n).all()) and len(np.unique(labels)) == n,
           "labels are not a permutation of [0, n)")
    order = np.argsort(labels)
    data = block["data"][order]
    # rows into label order; link targets from internal id -> label
    graph = labels[graph[order]]
    return from_graph(res, np.ascontiguousarray(data).astype(dt),
                      graph.astype(np.int32), metric)
