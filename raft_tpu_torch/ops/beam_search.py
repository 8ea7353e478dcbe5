"""One-launch CAGRA beam search — the port of
``raft_tpu/ops/beam_search.py``.

``beam_search`` runs the whole graph walk of every query in one launch
of the hand-written kernel ``csrc/beam_search.cu`` on a CUDA device,
which replaces the JAX package's Pallas kernel ``_beam_kernel``
(reached through ``beam_search``), and the plain version
:func:`beam_search_plain` on the CPU. It never goes from one to the
other. The kernel walks each query on a thread block cluster of
:func:`beam_cluster_size` CTAs: the first holds the walk, all of them
score the round's rows. Both compute, per query:

- the buffer of L = itopk entries (id, distance, explored) starts as
  (-1, +inf, 0); the seeds merge in C = w·deg wide chunks, in order;
- each iteration ``it < max_iters``: the w unexplored entries with the
  smallest (distance, id) are the parents, valid while ``it <
  row_iters[q]``, and are marked explored; their adjacency rows are the
  candidates (-1 for an invalid parent); a candidate equal to a live
  buffer id or to an earlier candidate is dropped; the rest are scored
  ``max((‖x‖² − 2⟨q,x⟩) + ‖q‖², 0)`` (L2) or ``−⟨q,x⟩`` (IP), each sum
  taken in :func:`raft_tpu_torch.ops.bq_scan.tree_sum`'s order over
  rounded float32 products; the buffer keeps the L smallest of the L + C
  entries by (distance, id), an infinite distance taking id -1;
- with the BQ record plane (``bq_records``), a candidate is scored only
  when its RaBitQ estimate minus the margin beats the buffer's L-th
  distance as it stands before the merge (``_block_estimate``'s
  arithmetic on the record's code words and corrections); the others
  score +inf, which is what the TPU kernel's masking gives, and their
  rows are never read;
- the output is the first k of (distances, ids), id -1 where the
  distance is not finite. Distances are min-form: the caller takes the
  square root (L2Sqrt) or the sign back (IP).

A query whose buffer holds no unexplored entry, or that has reached its
``row_iters``, only has no-op iterations left: both versions stop it
there, with the same result.

Both also return per query ``(live iterations, distinct valid
candidates, rows scored exactly)``, the counts that say what the walk
read, and they are equal between the two: the kernel takes every sum in
the plain version's order, so ids and distances are bit-identical on any
data.

The JAX wrapper's ``beam_search_fits``, ``ds_mode``, ``vmem_mb``,
``block_q`` and ``interpret`` place the dataset and record plane in TPU
VMEM. They have no counterpart on this card: a row always comes from
global memory through L2, and the record plane has no size rule.

``beam_search.launches`` counts the kernel's launches and
``beam_search.last_cluster`` holds the cluster size of the last one.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors._exact import dedup_candidate_mask
from raft_tpu_torch.ops.bq_scan import (
    _block_estimate,
    bq_record_geometry,
    tree_sum,
)

SUPPORTED_METRICS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
                     DistanceType.InnerProduct)

#: dataset types the kernel reads (widened to float32 exactly)
CUDA_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
#: largest itopk buffer, candidate width and dimension the kernel takes
#: (buffer and candidates live in shared memory; the tree sums hold
#: dim / 32 values per lane, at most 32)
CUDA_MAX_L = 512
CUDA_MAX_C = 256
CUDA_MAX_DIM = 1024
#: cluster sizes the kernel takes (16 is the H100's non-portable largest)
CLUSTER_SIZES = (1, 2, 4, 8, 16)


def beam_cluster_size(q: int, *, n_sm: int, ctas_per_sm: int) -> int:
    """The kernel's cluster size for a batch of ``q`` queries: the largest
    of :data:`CLUSTER_SIZES` whose ``q x size`` CTAs do not exceed
    ``ctas_per_sm x n_sm`` (1 when even one CTA a query does), where
    ``ctas_per_sm`` is the kernel's resident CTAs per SM (the library's
    ``raft_beam_ctas_per_sm()``). The rule of ``ops.bq_scan``'s walk: a
    small batch spreads each query's scoring over up to 16 SMs, a large
    one fills the card with one CTA a query."""
    budget = ctas_per_sm * n_sm
    return max([c for c in CLUSTER_SIZES if max(q, 1) * c <= budget],
               default=1)


def pad_graph(graph: torch.Tensor) -> torch.Tensor:
    """Adjacency rows padded to the next multiple of 128 with -1 (the
    JAX package's DMA unit). The kernel takes any row stride, so the
    port's search passes the graph unpadded; ``beam_search`` takes a
    padded one with its ``deg``."""
    deg = graph.shape[1]
    gp = -(-deg // 128) * 128
    if gp == deg:
        return graph
    return F.pad(graph, (0, gp - deg), value=-1)


def _lex_first(dist: torch.Tensor, ids: torch.Tensor, k: int):
    """Positions of the k smallest (distance, id) pairs of each row (the
    order of the JAX package's ``_extract_topk``)."""
    by_id = torch.argsort(ids, dim=1, stable=True)
    by_d = torch.argsort(torch.gather(dist, 1, by_id), dim=1, stable=True)
    return torch.gather(by_id, 1, by_d[:, :k])


def _check_args(queries, dataset, graph, seeds, k, L, w, metric, deg,
                row_iters, bq_records, bq_qrot, bq_crot, bq_bits):
    q, d = queries.shape
    n, gw = graph.shape
    deg = deg or gw
    expect(deg <= gw, "beam_search: deg exceeds graph width")
    c = w * deg
    expect(DistanceType(metric) in SUPPORTED_METRICS,
           f"beam_search: unsupported {metric!r}")
    expect(dataset.ndim == 2 and dataset.shape == (n, d),
           "beam_search: dataset must be (n, dim) with one graph row each")
    expect(seeds.ndim == 2 and seeds.shape[0] == q
           and seeds.shape[1] >= c and seeds.shape[1] % c == 0,
           "beam_search: seeds must be (q, m*w*deg)")
    expect(0 < k <= L, "beam_search: k must be in (0, itopk L]")
    expect(row_iters is None or tuple(row_iters.shape) == (q,),
           "beam_search: row_iters must be (q,)")
    dim_ext = -(-d // 32) * 32
    geometry = None
    if bq_records is not None:
        expect(1 <= bq_bits <= 8,
               "beam_search: bq_records needs bq_bits in 1..8")
        words = bq_bits * dim_ext // 32
        geometry = bq_record_geometry(words, bq_bits)
        expect(tuple(bq_records.shape) == (-(-n // geometry[2]), geometry[3]),
               "beam_search: bq_records does not match "
               f"bq_record_geometry(words={words}, bits={bq_bits}) "
               f"for n={n}")
        expect(bq_qrot is not None and tuple(bq_qrot.shape) == (q, dim_ext),
               "beam_search: bq_qrot must be the (q, dim_ext) rotated "
               "queries")
        expect(bq_crot is not None and tuple(bq_crot.shape) == (1, dim_ext),
               "beam_search: bq_crot must be the (1, dim_ext) rotated "
               "center")
    return deg, c, dim_ext, geometry


def beam_search(queries: torch.Tensor, dataset: torch.Tensor,
                graph: torch.Tensor, seeds: torch.Tensor, k: int, L: int,
                w: int, max_iters: int, metric: DistanceType, *,
                row_iters: Optional[torch.Tensor] = None,
                bq_records: Optional[torch.Tensor] = None,
                bq_qrot: Optional[torch.Tensor] = None,
                bq_crot: Optional[torch.Tensor] = None,
                bq_bits: int = 0, bq_query_bits: int = 4,
                bq_epsilon: float = 3.0, deg: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-launch graph beam search (see the module docstring): returns
    min-form (q, k) float32 distances, int32 ids and the (q, 3) int32
    counts.

    ``seeds`` is (q, m·w·deg) int32 for an integer m >= 1, -1 for none.
    ``row_iters``: optional (q,) int32 per-row iteration budgets (None:
    every row runs ``max_iters``). ``bq_records``/``bq_qrot``/``bq_crot``
    and ``bq_bits`` switch on the BQ-coded traversal: the
    :func:`raft_tpu_torch.ops.bq_scan.pack_bq_records` plane over the
    whole dataset, the (q, dim_ext) rotated queries and the (1, dim_ext)
    rotated center. ``deg``: the logical degree of a graph whose rows
    are padded (:func:`pad_graph`); 0 means the width.

    CPU tensors run :func:`beam_search_plain`; CUDA tensors launch the
    kernel, which takes L <= 512, w·deg <= 256 and dim <= 1024 and a
    float32, bfloat16 or int8 dataset, and raises past that."""
    metric = DistanceType(metric)
    args = _check_args(queries, dataset, graph, seeds, k, L, w, metric, deg,
                       row_iters, bq_records, bq_qrot, bq_crot, bq_bits)
    kw = dict(row_iters=row_iters, bq_records=bq_records, bq_qrot=bq_qrot,
              bq_crot=bq_crot, bq_bits=bq_bits, bq_query_bits=bq_query_bits,
              bq_epsilon=bq_epsilon, deg=args[0])
    if dataset.device.type == "cpu":
        return beam_search_plain(queries, dataset, graph, seeds, k, L, w,
                                 max_iters, metric, **kw)
    return _beam_search_cuda(queries, dataset, graph, seeds, k, L, w,
                             max_iters, metric, args, **kw)


beam_search.launches = 0
beam_search.last_cluster = 0


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def beam_search_plain(queries: torch.Tensor, dataset: torch.Tensor,
                      graph: torch.Tensor, seeds: torch.Tensor, k: int,
                      L: int, w: int, max_iters: int, metric: DistanceType,
                      *, row_iters: Optional[torch.Tensor] = None,
                      bq_records: Optional[torch.Tensor] = None,
                      bq_qrot: Optional[torch.Tensor] = None,
                      bq_crot: Optional[torch.Tensor] = None,
                      bq_bits: int = 0, bq_query_bits: int = 4,
                      bq_epsilon: float = 3.0, deg: int = 0,
                      rows_read: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`beam_search`, step for step
    ``_beam_kernel``, all queries at once. ``rows_read``, an optional
    (n, 2) bool tensor, gets column 0 set for every row scored exactly
    and column 1 for every row whose adjacency was read (a valid
    parent): what the walk must read. It exists for the bound that
    ``chip_smoke.py`` computes from a request's data; no search path
    sets it, and no other should."""
    metric = DistanceType(metric)
    deg, c, dim_ext, geometry = _check_args(
        queries, dataset, graph, seeds, k, L, w, metric, deg, row_iters,
        bq_records, bq_qrot, bq_crot, bq_bits)
    q = queries.shape[0]
    dev = queries.device
    ip_metric = metric == DistanceType.InnerProduct
    qf = queries.to(torch.float32)
    qn = tree_sum(qf * qf)
    inf = float("inf")
    if row_iters is None:
        row_iters = torch.full((q,), max_iters, dtype=torch.int32, device=dev)
    if bq_records is not None:
        words = bq_bits * dim_ext // 32
        recs = bq_records.reshape(-1, geometry[1])
        qrot = bq_qrot.to(torch.float32)
        crot = bq_crot.to(torch.float32)

    def survivors(cand, kth):
        """The BQ prune of a (q, c) candidate block: estimate minus
        margin beats the buffer's L-th distance."""
        r = recs[cand.clamp(min=0).to(torch.int64)]        # (q, c, rec_pad)
        scal = r[..., words:words + bq_bits + 2].contiguous().view(
            torch.float32)
        est, margin = _block_estimate(
            qrot, crot, scal[..., 0], scal[..., 1 + bq_bits],
            scal[..., 1:1 + bq_bits].permute(2, 0, 1), r[..., :words],
            dim_ext=dim_ext, bits=bq_bits, query_bits=bq_query_bits,
            epsilon=bq_epsilon, ip_metric=ip_metric)
        return (est - margin) < kth

    def step(ids, dvals, expl, cand, counts):
        """Score a (q, c) candidate block and merge it into the buffer."""
        buf_ids = torch.where(ids >= 0, ids, torch.full_like(ids, -2))
        fresh = (cand >= 0) & ~dedup_candidate_mask(cand, buf_ids)
        scored = fresh
        if bq_records is not None:
            scored = fresh & survivors(cand, dvals[:, L - 1:L])
        counts[:, 1] += fresh.sum(dim=1)
        counts[:, 2] += scored.sum(dim=1)
        qi, ci = torch.nonzero(scored, as_tuple=True)
        rid = cand[qi, ci].to(torch.int64)
        rows = dataset[rid].to(torch.float32)
        ip = tree_sum(qf[qi] * rows)
        if ip_metric:
            v = -ip
        else:
            v = torch.clamp((tree_sum(rows * rows) - 2.0 * ip) + qn[qi],
                            min=0.0)
        cd = torch.full(cand.shape, inf, device=dev)
        cd[qi, ci] = v
        if rows_read is not None:
            rows_read[rid, 0] = True
        all_d = torch.cat([dvals, cd], dim=1)
        all_i = torch.cat([ids, cand], dim=1)
        all_e = torch.cat([expl, torch.zeros_like(cand, dtype=torch.bool)],
                          dim=1)
        pos = _lex_first(all_d, all_i, L)
        nd = torch.gather(all_d, 1, pos)
        fin = torch.isfinite(nd)
        ni = torch.where(fin, torch.gather(all_i, 1, pos),
                         torch.full_like(pos, -1, dtype=torch.int32))
        return ni, nd, torch.gather(all_e, 1, pos) & fin

    ids = torch.full((q, L), -1, dtype=torch.int32, device=dev)
    dvals = torch.full((q, L), inf, device=dev)
    expl = torch.zeros((q, L), dtype=torch.bool, device=dev)
    counts = torch.zeros((q, 3), dtype=torch.int64, device=dev)
    seeds = seeds.to(torch.int32)
    for chunk in range(seeds.shape[1] // c):
        ids, dvals, expl = step(ids, dvals, expl,
                                seeds[:, chunk * c:(chunk + 1) * c], counts)

    for it in range(max_iters):
        masked = torch.where(expl | (ids < 0), torch.full_like(dvals, inf),
                             dvals)
        ppos = _lex_first(masked, ids, w)                   # (q, w)
        parents = torch.where(torch.isfinite(torch.gather(masked, 1, ppos)),
                              torch.gather(ids, 1, ppos),
                              torch.full_like(ppos, -1, dtype=torch.int32))
        pvalid = (parents >= 0) & (it < row_iters)[:, None]
        if not bool(pvalid.any()):
            break       # every later iteration is a no-op for every row
        counts[:, 0] += pvalid.any(dim=1)
        expl = expl | (ids[:, :, None] == torch.where(
            pvalid, parents, torch.full_like(parents, -3))[:, None, :]).any(
                dim=2)
        if rows_read is not None:
            rows_read[parents[pvalid].to(torch.int64), 1] = True
        adj = graph[parents.clamp(min=0).to(torch.int64), :deg]  # (q, w, deg)
        cand = torch.where(pvalid[:, :, None], adj.to(torch.int32),
                           torch.full_like(adj, -1, dtype=torch.int32))
        ids, dvals, expl = step(ids, dvals, expl, cand.reshape(q, c), counts)

    outd = dvals[:, :k].contiguous()
    outi = torch.where(torch.isfinite(outd), ids[:, :k],
                       torch.full_like(ids[:, :k], -1))
    return outd, outi, counts.to(torch.int32)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


def _beam_search_cuda(queries, dataset, graph, seeds, k, L, w, max_iters,
                      metric, args, *, row_iters, bq_records, bq_qrot,
                      bq_crot, bq_bits, bq_query_bits, bq_epsilon, deg,
                      cluster=None):
    """The kernel's wrapper. ``cluster`` forces a cluster size of
    :data:`CLUSTER_SIZES`; None takes :func:`beam_cluster_size` of the
    batch. The size launched is kept in ``beam_search.last_cluster``."""
    _, c, dim_ext, geometry = args
    dev = dataset.device
    q, d = queries.shape
    use_bq = bq_records is not None
    ins = [queries, graph, seeds] + ([row_iters] if row_iters is not None
                                     else [])
    if use_bq:
        ins += [bq_records, bq_qrot, bq_crot]
    expect(all(t.device == dev for t in ins),
           "beam_search: all inputs must be on the dataset's device")
    expect(dataset.dtype in CUDA_DTYPES,
           f"beam_search: kernel takes float32/bfloat16/int8 datasets, got "
           f"{dataset.dtype}")
    expect(L <= CUDA_MAX_L, f"beam_search: kernel takes itopk L <= "
           f"{CUDA_MAX_L}, got {L}")
    expect(c <= CUDA_MAX_C, f"beam_search: kernel takes w*deg <= "
           f"{CUDA_MAX_C}, got {c}")
    expect(dim_ext <= CUDA_MAX_DIM,
           f"beam_search: kernel takes dim <= {CUDA_MAX_DIM}, got {d}")
    expect(graph.dtype == torch.int32 and dataset.is_contiguous()
           and graph.is_contiguous(),
           "beam_search: kernel takes a contiguous dataset and int32 graph")
    expect(max_iters >= 0, "beam_search: max_iters must be >= 0")
    if use_bq:
        expect(bq_records.dtype == torch.int32 and 1 <= bq_query_bits <= 8,
               "beam_search: kernel takes an int32 record plane and "
               "query bits 1..8")
    from raft_tpu_torch.ops import _build

    launch = _build.load("beam_search")
    if cluster is None:
        cluster = beam_cluster_size(
            q, n_sm=torch.cuda.get_device_properties(dev)
            .multi_processor_count,
            ctas_per_sm=_build.constant("beam_search",
                                        "raft_beam_ctas_per_sm"))
    expect(cluster in CLUSTER_SIZES,
           f"beam_search: cluster size must be one of {CLUSTER_SIZES}, "
           f"got {cluster}")
    qf = queries.to(torch.float32).contiguous()
    sd = seeds.to(torch.int32).contiguous()
    ri = (torch.full((q,), max_iters, dtype=torch.int32, device=dev)
          if row_iters is None else row_iters.to(torch.int32).contiguous())
    words = rec_pad = 0
    recs = qrot = crot = None
    if use_bq:
        words = bq_bits * dim_ext // 32
        rec_pad = geometry[1]
        recs = bq_records.contiguous()
        qrot = bq_qrot.to(torch.float32).contiguous()
        crot = bq_crot.to(torch.float32).contiguous()
    outd = torch.empty((q, k), dtype=torch.float32, device=dev)
    outi = torch.empty((q, k), dtype=torch.int32, device=dev)
    counts = torch.empty((q, 3), dtype=torch.int32, device=dev)
    used = ctypes.c_int(0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = launch(qf.data_ptr(), dataset.data_ptr(), CUDA_DTYPES[dataset.dtype],
                 graph.data_ptr(), graph.shape[1], deg, sd.data_ptr(),
                 sd.shape[1], ri.data_ptr(), q, d, k, L, w, max_iters,
                 int(metric == DistanceType.InnerProduct), ptr(recs), rec_pad,
                 words, bq_bits if use_bq else 0, bq_query_bits, dim_ext,
                 ptr(qrot), ptr(crot), 2.0 * bq_epsilon, outd.data_ptr(),
                 outi.data_ptr(), counts.data_ptr(), cluster,
                 ctypes.addressof(used), stream)
    _build.check(err, "beam_search")
    beam_search.launches += 1
    beam_search.last_cluster = used.value
    return outd, outi, counts
