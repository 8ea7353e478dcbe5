"""List-sharded IVF-BQ — port of ``raft_tpu/distributed/bq.py``: the
RaBitQ residual sign-code index list-sharded over a mesh axis with the
layout policy of :mod:`raft_tpu_torch.distributed.ivf` (lists dealt
round-robin by population, coarse centers sharded with their lists,
rotation replicated, the raw-vector rerank plane sharded with its
lists).

The shard-local scan is the single-device fused estimate-then-rerank
engine (:func:`raft_tpu_torch.ops.bq_scan.bq_list_major_scan`: kernel #4
on the card, its plain version on the CPU) with not-owned probes masked
to the sentinel id. Its distances are exact, so the merge is lossless
and :func:`merge_overfetch` is ``k``. An estimate-only index (no rerank
plane) has the per-shard estimator error measured at build
(``shard_rel_err``), from which :func:`merge_overfetch` derives the
fetch depth; its rank-major estimate scan is not ported to the mesh, so
searching one raises here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.comms.comms import Comms
from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.distance.types import DistanceType, is_min_close
from raft_tpu_torch.distributed.ivf import (
    _coarse,
    _concat_shards,
    _finish,
    _norms,
    _owned_histogram,
    _query_slots,
    _resolve_search,
    admit_deal,
    collective_payload_model,
    comm_size,
    deal_order,
    merge_results_sharded,
    place_dealt,
    record_dispatch,
    select_probes_sharded,
)
from raft_tpu_torch.neighbors import ivf_bq as ivf_bq_mod
from raft_tpu_torch.neighbors._batching import tile_queries
from raft_tpu_torch.ops.ivf_scan import ragged_owned
from raft_tpu_torch.neighbors.ivf_bq import (
    _OVERFETCH_KAPPA,
    IvfBqIndexParams,
    IvfBqSearchParams,
)

Slots = List[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DistributedIvfBq:
    """List-sharded IVF-BQ index (RaBitQ construction), every field a
    per-slot list. ``center_norms`` and ``centers_rot`` (the rotated
    centers) are computed once over all lists and dealt with them."""

    comms: Comms
    centers: Slots            # (n_local, dim)
    center_norms: Slots       # (n_local,)
    centers_rot: Slots        # (n_local, dim_ext)
    rotation: Slots           # (dim_ext, dim) replicated
    codes: Slots              # (n_local, max, bits·dim_ext/32) int32
    rnorm: Slots              # (n_local, max)
    cfac: Slots               # (n_local, max, bits)
    errw: Slots               # (n_local, max)
    indices: Slots            # (n_local, max) int32
    list_sizes: Slots         # (n_local,) int32
    metric: DistanceType
    shard_rel_err: tuple = ()
    data: Optional[Slots] = None          # (n_local, max, dim) f32
    data_norms: Optional[Slots] = None    # (n_local, max)

    @property
    def n_lists(self) -> int:
        return self.centers[0].shape[0] * self.comms.size

    @property
    def dim(self) -> int:
        return self.centers[0].shape[1]

    @property
    def dim_ext(self) -> int:
        return self.rotation[0].shape[0]

    @property
    def bits(self) -> int:
        return self.cfac[0].shape[2]

    @property
    def size(self) -> int:
        return int(self.comms.assemble(self.list_sizes).sum())


def shard_rel_err_from_arrays(errw, rnorm, indices, dim_ext: int, perm,
                              r: int) -> tuple:
    """Measured per-shard relative estimator error of a dealt layout
    (``bq.py:~125``): shard s owns lists ``perm[s·L:(s+1)·L]``; its
    statistic is ``2·mean(errw) / (sqrt(dim_ext)·sqrt(mean(‖r‖²)))`` over
    its live rows — the one implementation build and checkpoint restore
    share. Host arrays in the pre-deal (global list id) order."""
    perm = np.asarray(perm)
    valid = np.asarray(indices) >= 0
    errw = np.asarray(errw)
    rn2 = np.square(np.asarray(rnorm))
    n_local = len(perm) // r
    out = []
    for s in range(r):
        lists = perm[s * n_local:(s + 1) * n_local]
        v = valid[lists]
        cnt = max(int(v.sum()), 1)
        mean_e = float(errw[lists][v].sum()) / cnt
        mean_rn2 = float(rn2[lists][v].sum()) / cnt
        rel = (2.0 * mean_e / (math.sqrt(dim_ext)
                               * math.sqrt(max(mean_rn2, 1e-20)))
               if mean_rn2 > 0 else 0.0)
        out.append(rel)
    return tuple(out)


def merge_overfetch(index: DistributedIvfBq, k: int, *,
                    confidence: float = 1.0) -> int:
    """Variance-corrected merge budget (``bq.py:~160``): ``k`` on an
    index with the rerank plane (exact distances, lossless merge), else
    ``ceil(k (1 + confidence · kappa · worst per-shard rel err))``."""
    expect(k >= 1, "k must be >= 1")
    if index.data is not None:
        return k
    worst = max(index.shard_rel_err) if index.shard_rel_err else 1.0
    return int(math.ceil(k * (1.0 + confidence * _OVERFETCH_KAPPA * worst)))


def build_bq(res: Optional[Resources], comms: Comms,
             params: IvfBqIndexParams, dataset) -> DistributedIvfBq:
    """Single-device build, then deal + shard (``bq.py:~185``);
    ``params.n_lists`` is rounded up to a multiple of the mesh axis."""
    res = ensure_resources(res)
    r = comms.size
    params = dataclasses.replace(params, n_lists=-(-params.n_lists // r) * r)
    with tracing.range("raft_tpu.distributed.ivf_bq.build"):
        index = ivf_bq_mod.build(res, params, dataset)
        return from_bq_index(comms, index)


def from_bq_index(comms: Comms, index) -> DistributedIvfBq:
    """Deal a single-device :class:`~raft_tpu_torch.neighbors.ivf_bq.
    IvfBqIndex` over ``comms``."""
    r = comms.size
    expect(index.n_lists % r == 0,
           f"the mesh axis ({r}) must divide n_lists {index.n_lists}")
    perm = deal_order(index.list_sizes.cpu().numpy(), r)
    rel = shard_rel_err_from_arrays(
        index.errw.cpu().numpy(), index.rnorm.cpu().numpy(),
        index.indices.cpu().numpy(), index.dim_ext, perm, r)
    admit_deal((index.centers, index.codes, index.rnorm, index.cfac,
                index.errw, index.indices, index.list_sizes, index.data,
                index.data_norms), r, "distributed.ivf_bq.build.deal")

    def place(a):
        return None if a is None else place_dealt(a, perm, comms)

    return DistributedIvfBq(
        comms=comms, centers=place(index.centers),
        center_norms=place(_norms(index.centers)),
        centers_rot=place(index.centers @ index.rotation.T),
        rotation=comms.replicate(index.rotation), codes=place(index.codes),
        rnorm=place(index.rnorm), cfac=place(index.cfac),
        errw=place(index.errw), indices=place(index.indices),
        list_sizes=place(index.list_sizes), metric=index.metric,
        shard_rel_err=rel, data=place(index.data),
        data_norms=place(index.data_norms))


def from_numpy_bq(comms: Comms, centers, rotation, codes, rnorm, cfac, errw,
                  indices, list_sizes,
                  metric: DistanceType = DistanceType.L2Expanded, data=None,
                  shard_rel_err: tuple = ()) -> DistributedIvfBq:
    """A list-sharded IVF-BQ index from host arrays already dealt (a JAX
    ``DistributedIvfBq``'s): sharded arguments as per-shard lists in rank
    order (or global arrays in dealt order), ``rotation`` one array. The
    norm planes and rotated centers are recomputed over all lists."""
    dev = comms.mesh.slot_devices()[0]
    cat = _concat_shards

    def put(a, dtype):
        return torch.as_tensor(cat(a), dtype=dtype).to(dev)

    c = put(centers, torch.float32)
    rot = torch.as_tensor(np.asarray(rotation), dtype=torch.float32).to(dev)
    ids = put(indices, torch.int32)
    x = None if data is None else put(data, torch.float32)
    sh = comms.shard
    return DistributedIvfBq(
        comms=comms, centers=sh(c), center_norms=sh(_norms(c)),
        centers_rot=sh(c @ rot.T), rotation=comms.replicate(rot),
        codes=sh(put(codes, torch.int32)), rnorm=sh(put(rnorm, torch.float32)),
        cfac=sh(put(cfac, torch.float32)), errw=sh(put(errw, torch.float32)),
        indices=sh(ids), list_sizes=sh(put(list_sizes, torch.int32)),
        metric=DistanceType(int(metric)), shard_rel_err=tuple(shard_rel_err),
        data=None if x is None else sh(x),
        data_norms=(None if x is None
                    else sh(ivf_bq_mod._slot_norms(x, ids))))


def _dist_search_bq_fn(queries, centers, center_norms, centers_rot,
                       rotation, codes, rnorm, cfac, errw, indices, data,
                       data_norms, probe_counts=None, n_valid=None,
                       row_probes=None, *, comms: Comms, n_probes: int,
                       k: int, metric: DistanceType, probe_mode: str,
                       query_axis=None, coarse_algo: str = "exact",
                       scan_engine: str = "torch", epsilon: float = 3.0,
                       query_bits: int = 0, wire_dtype: str = "f32",
                       probe_wire_dtype: str = "f32"):
    """The fused shard body (``bq.py:~240``): lean probe selection, per
    slot the fused estimate-then-rerank scan over the shard's lists
    (not-owned probes at the sentinel), the lossless (distance, id)
    merge, the L2Sqrt epilog. ``probe_counts`` / ``row_probes`` as in
    :func:`raft_tpu_torch.distributed.ivf._dist_search_fn`."""
    from raft_tpu_torch.ops.bq_scan import auto_query_bits, bq_list_major_scan

    axis = comms.axis
    select_min = is_min_close(metric)
    ip_metric = metric == DistanceType.InnerProduct
    qb = query_bits or auto_query_bits(cfac[0].shape[2])
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
        for s in range(len(qf)):
            n_local = centers[s].shape[0]
            masked = torch.where(mine[s], local[s],
                                 torch.full_like(local[s], n_local))
            qrot = qf[s] @ rotation[s].T
            d, i, _ = bq_list_major_scan(
                qf[s], qrot, centers_rot[s], codes[s], rnorm[s], cfac[s],
                errw[s], indices[s], data[s], data_norms[s], masked, None,
                k=k, metric=metric, epsilon=epsilon, engine=scan_engine,
                query_bits=qb)
            best.append((d, i))
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


def _dist_search_ragged_bq_fn(queries, row_probes, centers, center_norms,
                              centers_rot, rotation, codes, rnorm, cfac,
                              errw, indices, data, data_norms,
                              probe_counts=None, n_valid=None, *,
                              comms: Comms, n_probes: int, k: int,
                              metric: DistanceType, probe_mode: str,
                              scan_engine: str = "torch",
                              epsilon: float = 3.0, query_bits: int = 0,
                              wire_dtype: str = "f32",
                              probe_wire_dtype: str = "f32"):
    """The packed ragged-batch mesh BQ body (``bq.py:~395``): per-row
    budgets fold into the ownership mask; the fused engines carry exact
    distances, so the merge stays lossless at the class cap ``k``."""
    del n_valid
    expect(scan_engine in ("cuda", "torch"),
           "mesh ragged BQ serving needs a fused engine (cuda|torch), got "
           f"{scan_engine!r}")
    return _dist_search_bq_fn(
        queries, centers, center_norms, centers_rot, rotation, codes, rnorm,
        cfac, errw, indices, data, data_norms, probe_counts, None,
        row_probes, comms=comms, n_probes=n_probes, k=k, metric=metric,
        probe_mode=probe_mode, coarse_algo="exact", scan_engine=scan_engine,
        epsilon=epsilon, query_bits=query_bits, wire_dtype=wire_dtype,
        probe_wire_dtype=probe_wire_dtype)


def resolve_bq_serving_engine(params: IvfBqSearchParams, index, k: int
                              ) -> str:
    """The fused engine of a mesh IVF-BQ search, for the direct
    :func:`search_bq` and the executor's mesh plan alike."""
    from raft_tpu_torch.ops.bq_scan import resolve_bq_engine

    expect(index.data is not None,
           "distributed IVF-BQ search needs the rerank plane "
           "(store_vectors=True): the estimate-only rank scan is not "
           "ported to the mesh")
    expect(params.scan_engine in ("auto", "cuda", "torch"),
           "distributed scan_engine must be auto|cuda|torch (the rank "
           f"scan is not ported to the mesh), got {params.scan_engine!r}")
    engine = resolve_bq_engine(params.scan_engine, data=index.data[0], k=k)
    expect(engine != "cuda" or index.data[0].device.type == "cuda",
           "scan_engine='cuda' needs an index on a CUDA device")
    return engine


def search_bq(res: Optional[Resources], params: IvfBqSearchParams,
              index: DistributedIvfBq, queries, k: int,
              probe_mode: str = "global", query_axis: Optional[str] = None,
              query_tile: int = 4096, wire_dtype: str = "f32",
              probe_wire_dtype: str = "f32",
              trace_id: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed BQ search at depth ``k`` (``bq.py:~425``) with exact
    distances (the fused engines: kernel #4 on a CUDA index, its plain
    version on the CPU). Large query sets run in ``query_tile`` batches
    (not with ``query_axis``, whose grid is itself the large-batch
    form). Needs the rerank plane: an estimate-only index's rank scan is
    not ported to the mesh."""
    res = ensure_resources(res)
    comms = index.comms
    queries = torch.as_tensor(queries).to(index.centers[0].device)
    n_probes, wire_dtype, probe_wire_dtype = _resolve_search(
        comms, queries, k, index.dim, index.n_lists, params, probe_mode,
        query_axis, wire_dtype, probe_wire_dtype)
    engine = resolve_bq_serving_engine(params, index, k)
    with tracing.range("raft_tpu.distributed.ivf_bq.search"):
        def run(qt, _fw):
            return _dist_search_bq_fn(
                qt, index.centers, index.center_norms, index.centers_rot,
                index.rotation, index.codes, index.rnorm, index.cfac,
                index.errw, index.indices, index.data, index.data_norms,
                comms=comms, n_probes=n_probes, k=k, metric=index.metric,
                probe_mode=probe_mode, query_axis=query_axis,
                coarse_algo=params.coarse_algo, scan_engine=engine,
                epsilon=params.epsilon, query_bits=params.query_bits,
                wire_dtype=wire_dtype, probe_wire_dtype=probe_wire_dtype)

        model = lambda: collective_payload_model(  # noqa: E731
            queries.shape[0], k, n_probes, index.n_lists, comms.size,
            wire_dtype, probe_mode, probe_wire_dtype)
        if query_axis is not None:
            return record_dispatch("dist_ivf_bq", model, trace_id,
                                   lambda: run(queries, None),
                                   axis=comms.axis)
        return record_dispatch(
            "dist_ivf_bq", model, trace_id,
            lambda: tile_queries(run, queries, None, query_tile),
            axis=comms.axis)
