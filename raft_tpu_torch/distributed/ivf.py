"""List-sharded IVF-Flat and IVF-PQ — port of
``raft_tpu/distributed/ivf.py``.

ONE logical index whose inverted lists are block-sharded over a mesh
axis: every shard slot owns ``n_lists / R`` lists (dealt round-robin by
population, :func:`deal_order`), and a search is

    local coarse top-p  ->  local probe scan  ->  lean all-gather + merge

The shard-local scan is the single-device list-major engine
(:func:`raft_tpu_torch.ops.ivf_scan.list_major_scan`: kernel #2 on the
card, its plain version on the CPU; IVF-PQ's
:func:`raft_tpu_torch.ops.ivf_pq_scan.ivf_pq_scan`), with the probes a
shard does not own masked to the sentinel id ``n_local``, which both
kernels skip. The slots are those of :mod:`raft_tpu_torch.comms` (one
process; every slot ``cuda:0`` on one card), and each phase runs slot by
slot with the collectives between phases.

Probe semantics (``probe_mode``):

- ``"global"`` (exact): each shard contributes its top
  ``min(n_probes, n_local)`` (coarse distance, global id) candidates
  (the dense coarse block when that is not leaner); the global probe set
  is the lexicographic (distance, id) top-``n_probes`` of the gathered
  candidates; each shard scans the probed lists it owns. With the f32
  wires the result equals the single-device index's.
- ``"local"`` (approximate): each shard probes its own top
  ``ceil(n_probes / R)`` lists.

The result merge gathers each shard's (q, k) top-k (distances optionally
on a bf16 wire, ids exact) and merges by (distance, smallest id). The
2-D form shards the queries over a second mesh axis and scatter-merges
(:func:`merge_results_sharded`). The rank-major engines are not ported
to the mesh: ``scan_engine="rank"`` raises here.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.comms.comms import (
    Comms,
    allgather,
    allgather_quantized,
    allgather_wire,
    alltoall,
    rank as comm_rank,
    reducescatter_quantized,
    resolve_probe_wire_dtype,
    resolve_wire_dtype,
    size as comm_size,
)
from raft_tpu_torch.core import memwatch, tracing
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.distance.types import DistanceType, is_min_close
from raft_tpu_torch.neighbors import ivf_flat as ivf_flat_mod
from raft_tpu_torch.neighbors import ivf_pq as ivf_pq_mod
from raft_tpu_torch.neighbors._batching import coarse_select
from raft_tpu_torch.neighbors._packing import padded_extent
from raft_tpu_torch.neighbors.ivf_flat import (
    IvfFlatIndexParams,
    IvfFlatSearchParams,
)
from raft_tpu_torch.neighbors.ivf_pq import (
    CodebookKind,
    IvfPqIndexParams,
    IvfPqSearchParams,
)
from raft_tpu_torch.ops.ivf_scan import list_major_scan, ragged_owned

Slots = List[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DistributedIvfFlat:
    """List-sharded IVF-Flat index: every field is a per-slot list, each
    slot holding its shard's ``n_local`` lists (a 2-D mesh repeats a
    shard's block across the other axis). ``center_norms`` are the
    centers' squared norms, computed once over all ``n_lists`` centers
    and dealt with them."""

    comms: Comms
    centers: Slots           # (n_local, d)
    center_norms: Slots      # (n_local,)
    data: Slots              # (n_local, max_list_size, d)
    data_norms: Slots        # (n_local, max_list_size), +inf on padding
    indices: Slots           # (n_local, max_list_size) int32, -1 padding
    list_sizes: Slots        # (n_local,) int32
    metric: DistanceType

    @property
    def n_lists(self) -> int:
        return self.centers[0].shape[0] * self.comms.size

    @property
    def dim(self) -> int:
        return self.centers[0].shape[1]

    @property
    def max_list_size(self) -> int:
        return self.data[0].shape[1]

    @property
    def size(self) -> int:
        return int(self.comms.assemble(self.list_sizes).sum())


def deal_order(sizes: np.ndarray, r: int) -> np.ndarray:
    """Round-robin deal by descending population — THE list-to-shard
    layout policy (build, build_pq, checkpoint restore): shard s gets
    every r-th list of the size-sorted order."""
    order = np.argsort(-np.asarray(sizes), kind="stable")
    return np.concatenate([order[s::r] for s in range(r)])


def admit_deal(arrays, r: int, what: str) -> None:
    """The opt-in capacity gate of the deal: admit the per-shard bytes
    (:func:`raft_tpu_torch.core.memwatch.dealt_shard_bytes`) before any
    block moves. Accepts tensors or ``(shape, dtype)`` of planned
    buffers."""
    memwatch.admit(memwatch.dealt_shard_bytes(arrays, r), what)


def place_dealt(a: torch.Tensor, perm: np.ndarray, comms: Comms) -> Slots:
    """Deal + place one build-device tensor: shard r's block (its lists,
    ``perm[r·L:(r+1)·L]``) is gathered on the build device and moved to
    the slots of rank r, one block at a time, so the fully permuted
    tensor never exists. The largest block and the bytes moved go to the
    ``distributed.build.peak_deal_block_bytes`` /
    ``deal_bytes_total`` counters."""
    perm = np.asarray(perm)
    r = comms.size
    n_local = len(perm) // r
    devs = comms.mesh.slot_devices()
    blocks = {}
    for rank in range(r):
        rows = torch.as_tensor(perm[rank * n_local:(rank + 1) * n_local],
                               dtype=torch.int64, device=a.device)
        blocks[rank] = a.index_select(0, rows)
        nbytes = blocks[rank].numel() * blocks[rank].element_size()
        tracing.max_counter("distributed.build.peak_deal_block_bytes",
                            nbytes)
        holders = [s for s in range(comms.mesh.size)
                   if comms.mesh.coord(s, comms.axis) == rank]
        tracing.inc_counter("distributed.build.deal_bytes_total",
                            nbytes * len(holders))
    return [blocks[comms.mesh.coord(s, comms.axis)].to(devs[s])
            for s in range(comms.mesh.size)]


def _norms(centers: torch.Tensor) -> torch.Tensor:
    return torch.square(centers).sum(dim=1)


# ---------------------------------------------------------------------------
# the shared shard-body pieces
# ---------------------------------------------------------------------------


def _coarse(qf, centers_l, cnorm_l, ip_metric: bool):
    """(coarse, ip): this shard's min-close coarse distances (``-q·c``
    for IP, ``‖c‖² - 2 q·c`` for L2) and its query-center products."""
    ip = qf @ centers_l.T
    if ip_metric:
        return -ip, ip
    return cnorm_l[None, :] - 2.0 * ip, ip


def _lexsort_take(d, i, n: int):
    """The first ``n`` of each row in lexicographic (d, i) order (two
    stable sorts: by id, then by distance)."""
    o1 = torch.sort(i, dim=1, stable=True).indices
    d = torch.gather(d, 1, o1)
    i = torch.gather(i, 1, o1)
    sd, o2 = torch.sort(d, dim=1, stable=True)
    return sd[:, :n], torch.gather(i, 1, o2[:, :n])


def select_probes_sharded(coarse: Slots, n_probes: int, axis: str,
                          probe_mode: str, coarse_algo: str = "exact",
                          probe_wire_dtype: str = "f32"):
    """Probe selection over the slots (``ivf.py:194``) — THE
    probe-ownership arithmetic of every list-sharded family. ``coarse``
    holds each slot's (q, n_local) min-close coarse distances. Returns
    per-slot ``(local, mine)``: each (query, probe rank)'s local list id
    and whether this shard owns it.

    ``"global"``: the lean exchange — each shard's top
    ``min(n_probes, n_local)`` (distance, global id) candidates (ids
    exact int32, distances on ``probe_wire_dtype``; int8 scales from the
    full local block), the global probe set their lexicographic top
    ``n_probes``; the dense coarse-block gather where it is not leaner
    (``2 · local_k >= n_local``). ``"local"``: each shard's own top
    ``n_probes``."""
    q, n_local = coarse[0].shape
    if probe_mode != "global":
        local = [coarse_select(-c, n_probes, coarse_algo) for c in coarse]
        return local, [torch.ones(p.shape, dtype=torch.bool,
                                  device=p.device) for p in local]
    ranks = comm_rank(axis)
    local_k = min(n_probes, n_local)
    if 2 * local_k < n_local:
        loc = [coarse_select(-c, local_k, coarse_algo) for c in coarse]
        dloc = [torch.gather(c, 1, lc.to(torch.int64))
                for c, lc in zip(coarse, loc)]
        gid = [lc + r * n_local for lc, r in zip(loc, ranks)]
        all_d = allgather_quantized(dloc, axis, probe_wire_dtype,
                                    scale_ref=coarse)
        all_g = allgather(gid, axis)
        probes = []
        for d, g in zip(all_d, all_g):
            r = d.shape[0]
            cand_d = d.permute(1, 0, 2).reshape(q, r * local_k)
            cand_g = g.permute(1, 0, 2).reshape(q, r * local_k)
            probes.append(_lexsort_take(cand_d, cand_g, n_probes)[1])
    else:
        coarse_all = allgather_quantized(coarse, axis, probe_wire_dtype)
        probes = []
        for c in coarse_all:
            r = c.shape[0]
            flat = c.permute(1, 0, 2).reshape(q, r * n_local)
            probes.append(coarse_select(-flat, n_probes, coarse_algo))
    local, mine = [], []
    for p, r in zip(probes, ranks):
        owner = torch.div(p, n_local, rounding_mode="floor")
        local.append((p - owner * n_local).to(torch.int32))
        mine.append(owner == r)
    return local, mine


def _merge_candidates(all_d, all_i, k: int, select_min: bool):
    """Concatenate an (R, rows, k) rank stack in rank order and reduce
    each row's R·k candidates to its top-k by (distance, smallest id),
    with -1 on non-finite entries."""
    r, q, _ = all_d.shape
    cat_d = all_d.permute(1, 0, 2).reshape(q, r * k)
    cat_i = all_i.permute(1, 0, 2).reshape(q, r * k)
    sd, si = _lexsort_take(cat_d if select_min else -cat_d, cat_i, k)
    si = torch.where(torch.isfinite(sd), si, torch.full_like(si, -1))
    return (sd if select_min else -sd), si


def merge_results_sharded(best_d: Slots, best_i: Slots, axis: str,
                          select_min: bool, wire_dtype: str = "f32",
                          scatter: bool = False):
    """The O(q · k) result collective of every list-sharded search
    (``ivf.py:289``): each shard's (q, k) top-k gathered and merged.
    ``wire_dtype="bf16"`` moves the distances in bf16 (ids exact).
    ``scatter=True`` (the 2-D grids) scatter-merges: the distances ride
    :func:`reducescatter_quantized` with this merge as the fold, each
    shard merges a disjoint q/R slice and one tiled all-gather
    reassembles the rows — bit-identical to the gather path, which stays
    the fallback when R does not divide q. Returns per-slot (d, i)."""
    r = comm_size(axis)
    q, k = best_d[0].shape
    if scatter and q % r == 0 and q >= r:
        sub_i = alltoall(best_i, axis)
        it = iter(sub_i)
        merged = reducescatter_quantized(
            best_d, axis=axis, wire_dtype=wire_dtype,
            fold=lambda sub_d: _merge_candidates(
                sub_d, next(it), k, select_min))
        return (allgather([m[0] for m in merged], axis, tiled=True),
                allgather([m[1] for m in merged], axis, tiled=True))
    all_d = allgather_wire(best_d, axis, wire_dtype)
    all_i = allgather(best_i, axis)
    out = [_merge_candidates(d, i, k, select_min)
           for d, i in zip(all_d, all_i)]
    return [o[0] for o in out], [o[1] for o in out]


def _owned_histogram(local, mine, counts, n_valid):
    """``counts`` plus the probes this shard owns (each probe counts
    once mesh-wide); rows at and past ``n_valid`` count nothing."""
    from raft_tpu_torch.ops.ivf_scan import probe_histogram

    masked = torch.where(mine, local, torch.full_like(local,
                                                      counts.shape[0]))
    return probe_histogram(masked, counts, n_valid)


# ---------------------------------------------------------------------------
# payload model and traced dispatch
# ---------------------------------------------------------------------------


def collective_payload_model(q: int, k: int, n_probes: int, n_lists: int,
                             r: int, wire_dtype: str = "f32",
                             probe_mode: str = "global",
                             probe_wire_dtype: str = "f32") -> dict:
    """Modeled per-shard query-path collective payloads, in bytes
    (``ivf.py:339``): the probe-candidate exchange (``coarse_bytes``;
    ``dense_coarse_bytes`` the dense block for comparison) and the
    result merge (``merge_bytes``)."""
    n_local = max(n_lists // max(r, 1), 1)
    local_k = min(n_probes, n_local)
    wire_itemsize = 2 if wire_dtype == "bf16" else 4
    probe_itemsize = {"f32": 4, "bf16": 2, "int8": 1}[probe_wire_dtype]
    scale = 8 if probe_wire_dtype == "int8" else 0
    dense = q * (n_local * probe_itemsize + scale)
    lean = q * (local_k * (probe_itemsize + 4) + scale)
    coarse = 0
    if probe_mode == "global":
        coarse = lean if 2 * local_k < n_local else dense
    return {
        "coarse_bytes": coarse,
        "dense_coarse_bytes": (q * n_local * 4
                               if probe_mode == "global" else 0),
        "merge_bytes": q * k * (wire_itemsize + 4),
        "wire_dtype": wire_dtype,
        "probe_wire_dtype": probe_wire_dtype,
    }


def mesh_phases(model: dict) -> dict:
    """One payload model as the three mesh phases' span attrs."""
    return {
        "coarse_select": {"modeled": True,
                          "wire_bytes": model["coarse_bytes"],
                          "dense_wire_bytes": model["dense_coarse_bytes"],
                          "probe_wire_dtype": model["probe_wire_dtype"]},
        "scan": {"modeled": True, "wire_bytes": 0},
        "merge": {"modeled": True, "wire_bytes": model["merge_bytes"],
                  "wire_dtype": model["wire_dtype"]},
    }


def _synchronize(out):
    tensors = [t for t in (out if isinstance(out, tuple) else (out,))
               if isinstance(t, torch.Tensor)]
    if any(t.device.type == "cuda" for t in tensors):
        torch.cuda.synchronize()
    return out


def record_dispatch(family: str, model, trace_id, thunk, *,
                    axis: str = "data", phases: Optional[dict] = None,
                    modeled_bytes: Optional[float] = None,
                    attrs: Optional[dict] = None):
    """The traced-dispatch path of the direct distributed entries
    (``ivf.py:406``): with ``trace_id=None`` the thunk runs untouched;
    with one, the call is timed through :func:`~raft_tpu_torch.comms.
    comms.timed_dispatch`, synchronizes the card (so the span covers the
    work, not the enqueue) and records the mesh phase spans
    (:func:`raft_tpu_torch.core.tracing.record_mesh_spans`) with the
    modeled per-phase bytes. ``model`` is a payload-model dict or a
    zero-argument callable making one."""
    from raft_tpu_torch.comms.comms import timed_dispatch

    if trace_id is None:
        return thunk()
    if callable(model):
        model = model()
    if phases is None:
        phases = mesh_phases(model)
    if modeled_bytes is None:
        modeled_bytes = float(model["coarse_bytes"] + model["merge_bytes"])
    ids = (trace_id,)
    t0 = time.perf_counter()
    out = timed_dispatch(family, lambda: _synchronize(thunk()), axis,
                         modeled_bytes=modeled_bytes, trace_ids=ids,
                         attrs=attrs)
    tracing.record_mesh_spans(family, t0, time.perf_counter(),
                              trace_ids=ids, phases=phases)
    return out


def publish_payload_gauges(family: str, model: dict) -> None:
    """Register one payload model as ``serving.collective.*`` gauges."""
    base = (f"serving.collective.{family}."
            f"{model['wire_dtype']}.{model['probe_wire_dtype']}.")
    tracing.set_gauges({
        base + "coarse_bytes": float(model["coarse_bytes"]),
        base + "dense_coarse_bytes": float(model["dense_coarse_bytes"]),
        base + "merge_bytes": float(model["merge_bytes"]),
    })


def resolve_auto_wires(q: int, k: int, n_probes: int, n_lists: int, r: int,
                       wire_dtype: str, probe_mode: str,
                       probe_wire_dtype: str) -> Tuple[str, str]:
    """``"auto"`` wires by argmin over the modeled per-shard payload
    (ties prefer the wider wire); concrete dtypes pass through."""
    from raft_tpu_torch.comms.comms import PROBE_WIRE_DTYPES, WIRE_DTYPES

    def bytes_for(wd: str, pwd: str) -> dict:
        return collective_payload_model(q, k, n_probes, n_lists, r, wd,
                                        probe_mode, pwd)

    if wire_dtype == "auto":
        wire_dtype = min(WIRE_DTYPES,
                         key=lambda wd: bytes_for(wd, "f32")["merge_bytes"])
    if probe_wire_dtype == "auto":
        probe_wire_dtype = min(
            PROBE_WIRE_DTYPES,
            key=lambda pwd: bytes_for("f32", pwd)["coarse_bytes"])
    return wire_dtype, probe_wire_dtype


def resolve_query_sharding(comms: Comms, queries, query_axis) -> None:
    """Validate ``query_axis`` for the 2-D list x query grids."""
    if query_axis is not None:
        expect(query_axis in comms.mesh.axis_names
               and query_axis != comms.axis,
               f"query_axis {query_axis!r} must be another mesh axis")
        expect(queries.shape[0] % comms.mesh.shape[query_axis] == 0,
               "the query-axis size must divide the query count evenly")


def resolve_probe_budget(n_probes: int, n_lists: int, mesh_size: int,
                         probe_mode: str) -> int:
    """The per-call probe budget: ``n_probes`` clamped to the index;
    local mode probes each shard's ``ceil(n_probes / R)`` lists."""
    expect(probe_mode in ("global", "local"),
           f"probe_mode must be 'global' or 'local', got {probe_mode!r}")
    local_lists = n_lists // mesh_size
    n_probes = min(n_probes, n_lists)
    if probe_mode == "local":
        n_probes = min(-(-n_probes // mesh_size), local_lists)
    return n_probes


def _resolve_list_engine(engine: str, device: torch.device) -> str:
    """The mesh bodies' list-major engine: ``auto`` is the kernel on a
    CUDA index and the plain engine otherwise; ``rank`` is not ported
    to the mesh."""
    expect(engine in ("auto", "cuda", "torch"),
           f"distributed scan_engine must be auto|cuda|torch (the "
           f"rank-major engines are not ported to the mesh), got "
           f"{engine!r}")
    if engine == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    expect(engine != "cuda" or device.type == "cuda",
           "scan_engine='cuda' needs an index on a CUDA device")
    return engine


def _query_slots(comms: Comms, queries: torch.Tensor, query_axis):
    from raft_tpu_torch.comms.comms import P

    if query_axis is None:
        return comms.replicate(queries)
    return comms.shard(queries, P(query_axis, None))


def _gather_rows(comms: Comms, parts: Slots, query_axis) -> torch.Tensor:
    """The merged result: replicated within each list group, so read one
    slot a query block."""
    from raft_tpu_torch.comms.comms import P

    return comms.assemble(parts, P() if query_axis is None
                          else P(query_axis, None))


def _finish(comms, d, i, query_axis):
    return _gather_rows(comms, d, query_axis), _gather_rows(comms, i,
                                                            query_axis)


# ---------------------------------------------------------------------------
# IVF-Flat
# ---------------------------------------------------------------------------


def build(res: Optional[Resources], comms: Comms, params: IvfFlatIndexParams,
          dataset) -> DistributedIvfFlat:
    """Build a list-sharded index (``ivf.py:516``): the single-device
    build (global balanced k-means quantizer + packed lists), then the
    lists dealt round-robin by population and placed shard by shard
    (:func:`place_dealt`). ``params.n_lists`` is rounded up to a multiple
    of the mesh-axis size."""
    res = ensure_resources(res)
    r = comms.size
    params = dataclasses.replace(params, n_lists=-(-params.n_lists // r) * r)
    with tracing.range("raft_tpu.distributed.ivf_flat.build"):
        index = ivf_flat_mod.build(res, params, dataset)
        return from_index(comms, index)


def from_index(comms: Comms, index) -> DistributedIvfFlat:
    """Deal a single-device :class:`~raft_tpu_torch.neighbors.ivf_flat.
    IvfFlatIndex` over ``comms`` (the mesh axis must divide
    ``n_lists``)."""
    r = comms.size
    expect(index.n_lists % r == 0,
           f"the mesh axis ({r}) must divide n_lists {index.n_lists}")
    perm = deal_order(index.list_sizes.cpu().numpy(), r)
    admit_deal((index.centers, index.data, index.data_norms, index.indices,
                index.list_sizes), r, "distributed.ivf_flat.build.deal")

    def place(a):
        return place_dealt(a, perm, comms)

    return DistributedIvfFlat(
        comms=comms, centers=place(index.centers),
        center_norms=place(index.center_norms), data=place(index.data),
        data_norms=place(index.data_norms), indices=place(index.indices),
        list_sizes=place(index.list_sizes), metric=index.metric)


def from_numpy(comms: Comms, centers, data, indices, list_sizes,
               metric: DistanceType = DistanceType.L2Expanded,
               data_norms=None) -> DistributedIvfFlat:
    """A list-sharded IVF-Flat index from host arrays already dealt — a
    JAX ``DistributedIvfFlat``'s, per shard: each argument is a list of
    the R shards' numpy blocks in rank order (or the global array in
    dealt order). The norm planes are recomputed over the whole
    (n_lists, ...) arrays, as a single-device index computes them."""
    cat = _concat_shards
    dev = comms.mesh.slot_devices()[0]
    c = torch.as_tensor(cat(centers), dtype=torch.float32).to(dev)
    d = torch.as_tensor(cat(data)).to(dev)
    ids = torch.as_tensor(cat(indices), dtype=torch.int32).to(dev)
    norms = (torch.as_tensor(cat(data_norms), dtype=torch.float32).to(dev)
             if data_norms is not None
             else ivf_flat_mod._slot_norms(d, ids))
    return DistributedIvfFlat(
        comms=comms, centers=comms.shard(c), center_norms=comms.shard(
            _norms(c)), data=comms.shard(d), data_norms=comms.shard(norms),
        indices=comms.shard(ids),
        list_sizes=comms.shard(torch.as_tensor(
            cat(list_sizes), dtype=torch.int32).to(dev)),
        metric=DistanceType(int(metric)))


def _concat_shards(a):
    if isinstance(a, (list, tuple)):
        return np.concatenate([np.asarray(b) for b in a], axis=0)
    return np.asarray(a)


def _dist_search_fn(queries, centers, center_norms, data, data_norms,
                    indices, probe_counts=None, n_valid=None,
                    row_probes=None, *, comms: Comms, n_probes: int, k: int,
                    metric: DistanceType, probe_mode: str,
                    query_axis: Optional[str] = None,
                    coarse_algo: str = "exact", scan_engine: str = "torch",
                    wire_dtype: str = "f32", probe_wire_dtype: str = "f32"):
    """The shard body (``ivf.py:557``): per slot, coarse against the
    shard's centers; the probe selection over the slots; per slot, the
    list-major scan with not-owned probes masked to the sentinel
    ``n_local``; the lean result merge; the metric epilog. Returns
    ``(distances, indices)`` (+ the per-slot probe planes when
    ``probe_counts``, a per-slot list of (n_local,) int32 planes, is
    given: each shard counts the probes it owns).

    ``row_probes`` (the mesh ragged front) is a packed tile's (q,) per-row
    global probe budget: selection runs at the class cap ``n_probes`` and
    each row's ownership past its budget folds out of ``mine``
    (:func:`raft_tpu_torch.ops.ivf_scan.ragged_owned`)."""
    axis = comms.axis
    select_min = is_min_close(metric)
    ip_metric = metric == DistanceType.InnerProduct
    qs = _query_slots(comms, queries, query_axis)
    with comms.active():
        qf = [q.to(torch.float32) for q in qs]
        coarse = [_coarse(q, c, cn, ip_metric)[0]
                  for q, c, cn in zip(qf, centers, center_norms)]
        local, mine = select_probes_sharded(coarse, n_probes, axis,
                                            probe_mode, coarse_algo,
                                            probe_wire_dtype)
        if row_probes is not None:
            shards = comm_size(axis) if probe_mode == "local" else 1
            mine = [ragged_owned(m, row_probes.to(m.device), shards)
                    for m in mine]
        cnt = None
        if probe_counts is not None:
            cnt = [_owned_histogram(lc, m, c, n_valid)
                   for lc, m, c in zip(local, mine, probe_counts)]
        best = []
        for q, lc, m, x, xn, ids in zip(qf, local, mine, data, data_norms,
                                        indices):
            n_local = x.shape[0]
            masked = torch.where(m, lc, torch.full_like(lc, n_local))
            best.append(list_major_scan(q, x, xn, ids, masked, None, k=k,
                                        metric=metric, engine=scan_engine))
        d, i = merge_results_sharded(
            [b[0] for b in best], [b[1] for b in best], axis, select_min,
            wire_dtype, scatter=query_axis is not None)
    out_d, out_i = _finish(comms, d, i, query_axis)
    out_d = ivf_flat_mod.metric_epilog(queries.to(torch.float32), out_d,
                                       metric)
    if probe_counts is not None:
        return out_d, out_i, cnt
    return out_d, out_i


def _dist_search_ragged_fn(queries, row_probes, centers, center_norms, data,
                           data_norms, indices, probe_counts=None,
                           n_valid=None, *, comms: Comms, n_probes: int,
                           k: int, metric: DistanceType, probe_mode: str,
                           scan_engine: str = "torch",
                           wire_dtype: str = "f32",
                           probe_wire_dtype: str = "f32"):
    """The packed ragged-batch mesh body (``ivf.py:707``): the per-row
    budgets ride ``row_probes`` into :func:`_dist_search_fn`'s ownership
    mask, so one tile serves every per-request ``n_probes`` of the class,
    each row equal to its request's solo search. Exact coarse selection;
    list-major engines only."""
    del n_valid
    expect(scan_engine in ("cuda", "torch"),
           "mesh ragged serving needs a list-major engine (cuda|torch), "
           f"got {scan_engine!r}")
    return _dist_search_fn(
        queries, centers, center_norms, data, data_norms, indices,
        probe_counts, None, row_probes, comms=comms, n_probes=n_probes, k=k,
        metric=metric, probe_mode=probe_mode, coarse_algo="exact",
        scan_engine=scan_engine, wire_dtype=wire_dtype,
        probe_wire_dtype=probe_wire_dtype)


def resolve_flat_engine(params: IvfFlatSearchParams, index, k: int) -> str:
    """The list-major engine of a mesh IVF-Flat search: what the direct
    :func:`search` and the executor's mesh plan both run."""
    from raft_tpu_torch.ops.ivf_scan import resolve_scan_engine

    engine = _resolve_list_engine(params.scan_engine, index.data[0].device)
    return resolve_scan_engine(engine, data=index.data[0], k=k)


def resolve_pq_engine(params: IvfPqSearchParams, index, k: int
                      ) -> Tuple[str, str]:
    """``(scan engine, score mode)`` of a mesh IVF-PQ search, for the
    direct :func:`search_pq` and the executor's mesh plan alike."""
    expect(params.lut_dtype in ivf_pq_mod.LUT_DTYPES,
           f"lut_dtype must be float32/bfloat16/float8_e4m3fn/float8_e5m2, "
           f"got {params.lut_dtype}")
    score_mode = ivf_pq_mod.resolve_score_mode(params.score_mode)
    engine = _resolve_list_engine(params.scan_engine,
                                  index.codes[0].device)
    if engine == "cuda":
        engine = ivf_pq_mod.resolve_scan_engine("cuda", None, k, score_mode)
    return engine, score_mode


def _resolve_search(comms, queries, k, index_dim, n_lists, params,
                    probe_mode, query_axis, wire_dtype, probe_wire_dtype):
    expect(queries.ndim == 2 and queries.shape[1] == index_dim,
           "queries must be (q, dim)")
    resolve_query_sharding(comms, queries, query_axis)
    n_probes = resolve_probe_budget(params.n_probes, n_lists, comms.size,
                                    probe_mode)
    expect(params.coarse_algo in ("exact", "approx"),
           f"coarse_algo must be 'exact' or 'approx', got "
           f"{params.coarse_algo!r}")
    wire_dtype, probe_wire_dtype = resolve_auto_wires(
        queries.shape[0], k, n_probes, n_lists, comms.size, wire_dtype,
        probe_mode, probe_wire_dtype)
    resolve_wire_dtype(wire_dtype)
    resolve_probe_wire_dtype(probe_wire_dtype)
    return n_probes, wire_dtype, probe_wire_dtype


def search(res: Optional[Resources], params: IvfFlatSearchParams,
           index: DistributedIvfFlat, queries, k: int,
           probe_mode: str = "global", query_axis: Optional[str] = None,
           wire_dtype: str = "f32", probe_wire_dtype: str = "f32",
           trace_id: Optional[int] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed search (``ivf.py:~735``): (q, k) distances and global
    row ids. ``query_axis`` shards the queries over a second mesh axis
    (the 2-D grid); ``wire_dtype="bf16"`` compresses the merge's
    distances; ``probe_wire_dtype`` (``f32|bf16|int8``) the probe
    exchange; ``trace_id`` records the mesh spans
    (:func:`record_dispatch`). ``params.scan_engine``: ``auto`` is kernel
    #2 on a CUDA index, the plain engine on the CPU."""
    res = ensure_resources(res)
    comms = index.comms
    queries = torch.as_tensor(queries).to(index.centers[0].device)
    n_probes, wire_dtype, probe_wire_dtype = _resolve_search(
        comms, queries, k, index.dim, index.n_lists, params, probe_mode,
        query_axis, wire_dtype, probe_wire_dtype)
    engine = resolve_flat_engine(params, index, k)
    with tracing.range("raft_tpu.distributed.ivf_flat.search"):
        model = lambda: collective_payload_model(  # noqa: E731
            queries.shape[0], k, n_probes, index.n_lists, comms.size,
            wire_dtype, probe_mode, probe_wire_dtype)
        return record_dispatch(
            "dist_ivf_flat", model, trace_id, axis=comms.axis,
            thunk=lambda: _dist_search_fn(
                queries, index.centers, index.center_norms, index.data,
                index.data_norms, index.indices, comms=comms,
                n_probes=n_probes, k=k, metric=index.metric,
                probe_mode=probe_mode, query_axis=query_axis,
                coarse_algo=params.coarse_algo, scan_engine=engine,
                wire_dtype=wire_dtype, probe_wire_dtype=probe_wire_dtype))


def build_streaming(res: Optional[Resources], comms: Comms,
                    params: IvfFlatIndexParams, source,
                    chunk_rows: int = 1 << 20, train_rows: int = 1 << 18
                    ) -> DistributedIvfFlat:
    """Stream a dataset straight into the list-sharded index
    (``ivf.py:843``): the quantizer trains on a strided sample (the
    single-device streaming passes, :mod:`raft_tpu_torch.neighbors.
    _streaming`), then every chunk's rows are scattered in place
    (``index_put_``) into the shard planes of their lists, so the dataset
    never materializes on one device or in host memory."""
    from raft_tpu_torch.cluster.kmeans_balanced import KMeansBalancedParams
    from raft_tpu_torch.neighbors._streaming import (
        label_pass,
        sample_trainset,
        scatter_pass,
    )

    res = ensure_resources(res)
    r = comms.size
    n_lists = -(-params.n_lists // r) * r
    params = dataclasses.replace(params, n_lists=n_lists,
                                 add_data_on_build=False)
    n, d = source.n_rows, source.dim
    with tracing.range("raft_tpu.distributed.ivf_flat.build_streaming"):
        train_rows = max(n_lists, min(train_rows, n))
        trainset = sample_trainset(source, train_rows, chunk_rows)
        quant = ivf_flat_mod.build(res, params, trainset)
        km = KMeansBalancedParams(
            metric=ivf_flat_mod._kmeans_metric(params.metric))
        labels_np, sizes_np = label_pass(res, km, quant.centers, source,
                                         chunk_rows, n_lists)
        max_size = padded_extent(sizes_np)
        deal = deal_order(sizes_np, r)
        dealt_pos = np.empty((n_lists,), np.int64)
        dealt_pos[deal] = np.arange(n_lists)
        admit_deal((((n_lists, max_size, d), torch.float32),
                    ((n_lists, max_size), torch.int32),
                    ((n_lists, max_size), torch.float32)), r,
                   "distributed.ivf_flat.build_streaming.deal")
        n_local = n_lists // r
        devs = comms.mesh.slot_devices()
        ranks = [comms.mesh.coord(s, comms.axis) for s in range(len(devs))]
        # one plane pair a rank, on its first slot's device
        home = {rk: devs[s] for s, rk in reversed(list(enumerate(ranks)))}
        planes = {rk: (torch.zeros((n_local, max_size, d), device=dev),
                       torch.full((n_local, max_size), -1, dtype=torch.int32,
                                  device=dev))
                  for rk, dev in home.items()}
        pos = torch.as_tensor(dealt_pos, device=res.device)

        def scatter(rows, lists, ranks_in_list, ids):
            dp = pos[lists]
            owner = torch.div(dp, n_local, rounding_mode="floor")
            for rk, (data, idx) in planes.items():
                sel = (owner == rk).nonzero().squeeze(1)
                slots = ((dp[sel] - rk * n_local).to(data.device),
                         ranks_in_list[sel].to(data.device))
                data.index_put_(slots, rows[sel].to(data.device))
                idx.index_put_(slots, ids[sel].to(data.device))

        scatter_pass(res, source, labels_np, chunk_rows, n_lists, scatter)
        data = [planes[rk][0].to(dev) for rk, dev in zip(ranks, devs)]
        indices = [planes[rk][1].to(dev) for rk, dev in zip(ranks, devs)]
        return DistributedIvfFlat(
            comms=comms, centers=place_dealt(quant.centers, deal, comms),
            center_norms=place_dealt(quant.center_norms, deal, comms),
            data=data,
            data_norms=[ivf_flat_mod._slot_norms(x, i)
                        for x, i in zip(data, indices)],
            indices=indices,
            list_sizes=place_dealt(torch.as_tensor(sizes_np,
                                                   dtype=torch.int32),
                                   deal, comms),
            metric=DistanceType(params.metric))


# ---------------------------------------------------------------------------
# IVF-PQ: compressed codes sharded over the mesh, codebooks replicated
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DistributedIvfPq:
    """List-sharded IVF-PQ index (``ivf.py:~960``): centers, their norms,
    codes and ids per shard; the rotation replicated; PER_SUBSPACE
    codebooks replicated, PER_CLUSTER codebooks sharded with their lists.
    Codes are unpacked (one byte a code)."""

    comms: Comms
    centers: Slots           # (n_local, dim)
    center_norms: Slots      # (n_local,)
    rotation: Slots          # (dim_ext, dim) replicated
    codebooks: Slots         # (pq_dim | n_local, 2^bits, pq_len)
    codes: Slots             # (n_local, max_list_size, pq_dim) uint8
    indices: Slots           # (n_local, max_list_size) int32
    list_sizes: Slots        # (n_local,) int32
    metric: DistanceType
    pq_bits: int
    codebook_kind: CodebookKind = CodebookKind.PER_SUBSPACE

    @property
    def n_lists(self) -> int:
        return self.centers[0].shape[0] * self.comms.size

    @property
    def dim(self) -> int:
        return self.centers[0].shape[1]

    @property
    def max_list_size(self) -> int:
        return self.codes[0].shape[1]

    @property
    def pq_dim(self) -> int:
        return self.codes[0].shape[2]

    @property
    def pq_len(self) -> int:
        return self.codebooks[0].shape[2]

    @property
    def size(self) -> int:
        return int(self.comms.assemble(self.list_sizes).sum())


def build_pq(res: Optional[Resources], comms: Comms,
             params: IvfPqIndexParams, dataset) -> DistributedIvfPq:
    """Build + deal, like :func:`build` (``ivf.py:~1000``); nibble-packed
    codes are unpacked for the mesh scan."""
    res = ensure_resources(res)
    r = comms.size
    params = dataclasses.replace(params, n_lists=-(-params.n_lists // r) * r)
    with tracing.range("raft_tpu.distributed.ivf_pq.build"):
        index = ivf_pq_mod.build(res, params, dataset)
        return from_pq_index(comms, index)


def from_pq_index(comms: Comms, index) -> DistributedIvfPq:
    """Deal a single-device :class:`~raft_tpu_torch.neighbors.ivf_pq.
    IvfPqIndex` over ``comms``."""
    r = comms.size
    expect(index.n_lists % r == 0,
           f"the mesh axis ({r}) must divide n_lists {index.n_lists}")
    codes = (ivf_pq_mod._unpack_nibbles(index.codes) if index.packed
             else index.codes)
    perm = deal_order(index.list_sizes.cpu().numpy(), r)
    per_cluster = index.codebook_kind == CodebookKind.PER_CLUSTER
    admit_deal((index.centers, codes, index.indices, index.list_sizes)
               + ((index.codebooks,) if per_cluster else ()), r,
               "distributed.ivf_pq.build.deal")

    def place(a):
        return place_dealt(a, perm, comms)

    return DistributedIvfPq(
        comms=comms, centers=place(index.centers),
        center_norms=place(_norms(index.centers)),
        rotation=comms.replicate(index.rotation),
        codebooks=(place(index.codebooks) if per_cluster
                   else comms.replicate(index.codebooks)),
        codes=place(codes), indices=place(index.indices),
        list_sizes=place(index.list_sizes), metric=index.metric,
        pq_bits=index.pq_bits, codebook_kind=index.codebook_kind)


def from_numpy_pq(comms: Comms, centers, rotation, codebooks, codes, indices,
                  list_sizes, metric: DistanceType = DistanceType.L2Expanded,
                  pq_bits: int = 8,
                  codebook_kind: CodebookKind = CodebookKind.PER_SUBSPACE
                  ) -> DistributedIvfPq:
    """A list-sharded IVF-PQ index from host arrays already dealt (a JAX
    ``DistributedIvfPq``'s): sharded arguments as per-shard lists in rank
    order (or global arrays in dealt order), ``rotation`` and
    PER_SUBSPACE ``codebooks`` as one array."""
    dev = comms.mesh.slot_devices()[0]
    cat = _concat_shards
    kind = CodebookKind(int(codebook_kind))
    c = torch.as_tensor(cat(centers), dtype=torch.float32).to(dev)
    books = torch.as_tensor(cat(codebooks), dtype=torch.float32).to(dev)
    return DistributedIvfPq(
        comms=comms, centers=comms.shard(c),
        center_norms=comms.shard(_norms(c)),
        rotation=comms.replicate(torch.as_tensor(
            np.asarray(rotation), dtype=torch.float32).to(dev)),
        codebooks=(comms.shard(books) if kind == CodebookKind.PER_CLUSTER
                   else comms.replicate(books)),
        codes=comms.shard(torch.as_tensor(cat(codes),
                                          dtype=torch.uint8).to(dev)),
        indices=comms.shard(torch.as_tensor(cat(indices),
                                            dtype=torch.int32).to(dev)),
        list_sizes=comms.shard(torch.as_tensor(
            cat(list_sizes), dtype=torch.int32).to(dev)),
        metric=DistanceType(int(metric)), pq_bits=int(pq_bits),
        codebook_kind=kind)


def _dist_search_pq_fn(queries, centers, center_norms, rotation, codebooks,
                       codes, indices, probe_counts=None, n_valid=None,
                       row_probes=None, *, comms: Comms, n_probes: int,
                       k: int, metric: DistanceType, probe_mode: str,
                       query_axis: Optional[str] = None,
                       codebook_kind: CodebookKind = (
                           CodebookKind.PER_SUBSPACE),
                       score_mode: str = "gather", lut_dtype=torch.float32,
                       coarse_algo: str = "exact", scan_engine: str = "torch",
                       wire_dtype: str = "f32",
                       probe_wire_dtype: str = "f32"):
    """The distributed ADC body (``ivf.py:1049``): the probe plumbing of
    :func:`_dist_search_fn`, and per slot the single-device LUT scan
    (:func:`~raft_tpu_torch.ops.ivf_pq_scan.ivf_pq_scan`) over the
    shard's lists with not-owned probes at the sentinel; each (query,
    probe slot)'s rotated residual is computed as the single-device body
    computes it, so a probed list scores as it would there."""
    from raft_tpu_torch.ops.ivf_pq_scan import codebook_norms, ivf_pq_scan

    axis = comms.axis
    select_min = is_min_close(metric)
    ip_metric = metric == DistanceType.InnerProduct
    per_cluster = codebook_kind == CodebookKind.PER_CLUSTER
    score = (None if scan_engine == "cuda"
             else ivf_pq_mod.score_fn(score_mode, codebooks[0].shape[1]))
    qs = _query_slots(comms, queries, query_axis)
    with comms.active():
        qf = [q.to(torch.float32) for q in qs]
        co = [_coarse(q, c, cn, ip_metric)
              for q, c, cn in zip(qf, centers, center_norms)]
        local, mine = select_probes_sharded([c[0] for c in co], n_probes,
                                            axis, probe_mode, coarse_algo,
                                            probe_wire_dtype)
        if row_probes is not None:
            shards = comm_size(axis) if probe_mode == "local" else 1
            mine = [ragged_owned(m, row_probes.to(m.device), shards)
                    for m in mine]
        cnt = None
        if probe_counts is not None:
            cnt = [_owned_histogram(lc, m, c, n_valid)
                   for lc, m, c in zip(local, mine, probe_counts)]
        best = []
        for s in range(len(qf)):
            q, lc, m = qf[s], local[s], mine[s]
            c_l, rot, books = centers[s], rotation[s], codebooks[s]
            n_local = c_l.shape[0]
            slot_lists = lc.to(torch.int64).clamp(0, n_local - 1)
            if ip_metric:
                qres = q @ rot.T
                base = torch.gather(co[s][1], 1, slot_lists)
                cb_norms = None
            else:
                qres = (q[:, None, :] - c_l[slot_lists]) @ rot.T
                base = None
                cb_norms = codebook_norms(books)
            masked = torch.where(m, lc, torch.full_like(lc, n_local))
            best.append(ivf_pq_scan(
                qres, base, books, cb_norms, codes[s], indices[s], masked,
                None, k=k, ip_metric=ip_metric, per_cluster=per_cluster,
                lut_dtype=lut_dtype, packed=False, engine=scan_engine,
                score=score))
        d, i = merge_results_sharded(
            [b[0] for b in best], [b[1] for b in best], axis, select_min,
            wire_dtype, scatter=query_axis is not None)
    out_d, out_i = _finish(comms, d, i, query_axis)
    if metric == DistanceType.L2SqrtExpanded:
        out_d = torch.where(torch.isfinite(out_d),
                            torch.sqrt(torch.clamp(out_d, min=0.0)), out_d)
    if probe_counts is not None:
        return out_d, out_i, cnt
    return out_d, out_i


def _dist_search_ragged_pq_fn(queries, row_probes, centers, center_norms,
                              rotation, codebooks, codes, indices,
                              probe_counts=None, n_valid=None, *,
                              comms: Comms, n_probes: int, k: int,
                              metric: DistanceType, probe_mode: str,
                              codebook_kind: CodebookKind = (
                                  CodebookKind.PER_SUBSPACE),
                              score_mode: str = "gather",
                              lut_dtype=torch.float32,
                              scan_engine: str = "torch",
                              wire_dtype: str = "f32",
                              probe_wire_dtype: str = "f32"):
    """The packed ragged-batch mesh PQ body (``ivf.py:1236``): see
    :func:`_dist_search_ragged_fn`."""
    del n_valid
    expect(scan_engine in ("cuda", "torch"),
           "mesh ragged PQ serving needs a list-major engine (cuda|torch), "
           f"got {scan_engine!r}")
    return _dist_search_pq_fn(
        queries, centers, center_norms, rotation, codebooks, codes, indices,
        probe_counts, None, row_probes, comms=comms, n_probes=n_probes, k=k,
        metric=metric, probe_mode=probe_mode, codebook_kind=codebook_kind,
        score_mode=score_mode, lut_dtype=lut_dtype, coarse_algo="exact",
        scan_engine=scan_engine, wire_dtype=wire_dtype,
        probe_wire_dtype=probe_wire_dtype)


def search_pq(res: Optional[Resources], params: IvfPqSearchParams,
              index: DistributedIvfPq, queries, k: int,
              probe_mode: str = "global", query_axis: Optional[str] = None,
              wire_dtype: str = "f32", probe_wire_dtype: str = "f32",
              trace_id: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed PQ search (``ivf.py:1266``): :func:`search`'s
    semantics with per-shard LUT scoring. ``params.scan_engine``:
    ``auto`` is the ``ivf_pq_scan`` kernel on a CUDA index and the plain
    engine on the CPU (the single-device ``rank`` default of the CPU is
    not ported to the mesh); ``cuda`` takes ``torch`` past the kernel's
    k, as the single-device resolver does."""
    res = ensure_resources(res)
    comms = index.comms
    queries = torch.as_tensor(queries).to(index.centers[0].device)
    n_probes, wire_dtype, probe_wire_dtype = _resolve_search(
        comms, queries, k, index.dim, index.n_lists, params, probe_mode,
        query_axis, wire_dtype, probe_wire_dtype)
    engine, score_mode = resolve_pq_engine(params, index, k)
    with tracing.range("raft_tpu.distributed.ivf_pq.search"):
        model = lambda: collective_payload_model(  # noqa: E731
            queries.shape[0], k, n_probes, index.n_lists, comms.size,
            wire_dtype, probe_mode, probe_wire_dtype)
        return record_dispatch(
            "dist_ivf_pq", model, trace_id, axis=comms.axis,
            thunk=lambda: _dist_search_pq_fn(
                queries, index.centers, index.center_norms, index.rotation,
                index.codebooks, index.codes, index.indices, comms=comms,
                n_probes=n_probes, k=k, metric=index.metric,
                probe_mode=probe_mode, query_axis=query_axis,
                codebook_kind=index.codebook_kind, score_mode=score_mode,
                lut_dtype=params.lut_dtype, coarse_algo=params.coarse_algo,
                scan_engine=engine, wire_dtype=wire_dtype,
                probe_wire_dtype=probe_wire_dtype))
