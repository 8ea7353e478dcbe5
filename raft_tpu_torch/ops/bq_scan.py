"""Fused estimate-then-rerank IVF-BQ probe scan — the port of
``raft_tpu/ops/bq_scan.py`` (the list-major engine family of
:mod:`raft_tpu_torch.neighbors.ivf_bq`, IVF-RaBitQ).

For each query, in ascending list id over the lists it probed:

1. **estimate** every row of the list from its packed sign words: the
   rotated query side ``q~ = Rq - Rc`` (L2) or ``Rq`` (IP) quantizes to
   ``2^query_bits - 1`` uniform levels per (query, list), its bit-planes
   pack into int32 words, and each plane scores against the code words
   as ``<u_j, s> = popcount(c) - popcount(u_j XOR c)``: exact integers;
2. **prune** with the RaBitQ margin (:func:`estimator_margin`): a row
   survives when ``est - margin`` beats the query's k-th *exact*
   distance, read once at the start of the list;
3. **rerank** the survivors exactly against the raw-vector plane and
   merge them in (distance, smallest id) order.

Engines (``bq_list_major_scan``):

- ``cuda``: the hand-written kernel ``csrc/bq_scan.cu``, which replaces
  the JAX package's Pallas kernel ``_bq_scan_kernel`` (reached through
  ``_bq_scan_pallas``). A first kernel computes the query side of every
  (query, probed list) pair in parallel; then a thread block cluster of
  :func:`bq_cluster_size` CTAs walks one query's sorted probes: its CTAs
  split each list's live rows, estimate them against the threshold the
  list started with, rerank their survivors, and the leader CTA merges
  them into the query's top-k. A raw vector is read only for a
  survivor.
- ``torch``: the plain version ``_bq_scan_torch``, the twin of
  ``_bq_scan_xla``: one step per list of the sorted probed-list union,
  the same estimate, margin, prune and exact rerank, and
  ``_merge_smallest_id``. CPU tensors always run it.

Both return the number of rows each query reranked (its survivors), the
number that says what the scan read. Every sum the prune reads (``‖q‖²``,
``Σ q~²``, ``<Rq, Rc>`` and the exact dot products) is taken by
:func:`tree_sum`'s fixed order over rounded products in both engines,
and the rest of the float work is op for op the same: the two engines'
prune decisions, survivor counts, distances and ids are bit-identical.

``bq_list_major_scan.launches`` counts the kernel's launches.

The per-row **record plane** of the CAGRA beam search's BQ traversal
(:func:`bq_record_geometry`, :func:`pack_bq_records`,
:func:`unpack_bq_records`) lives here too, byte for byte the JAX
package's layout, and :func:`_block_estimate` also scores a separate row
set per query (the beam's candidates).
"""

from __future__ import annotations

import ctypes
import math

import torch

from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors.filters import test_filter
from raft_tpu_torch.ops.ivf_scan import (
    _merge_smallest_id,
    live_rows,
    sorted_probes,
    union_id_planes,
    unique_lists,
)

#: ivf_bq ``scan_engine`` values: ``rank`` is the estimate-only engine
BQ_ENGINES = ("auto", "cuda", "torch", "rank")

#: default query quantization width (RaBitQ's asymmetric query grid)
_QUERY_BITS = 4

#: largest k the kernel takes (its per-query list lives in shared memory)
CUDA_MAX_K = 128

#: largest dimension the kernel takes (its tree sums hold dim_ext / 32
#: lanes per thread, at most 32)
CUDA_MAX_DIM = 1024

#: cluster sizes the kernel takes (16 is the H100's non-portable largest)
CLUSTER_SIZES = (1, 2, 4, 8, 16)


def bq_cluster_size(q: int, *, n_sm: int, ctas_per_sm: int) -> int:
    """The kernel's cluster size for a batch of ``q`` queries: the largest
    of :data:`CLUSTER_SIZES` whose ``q x size`` CTAs do not exceed
    ``ctas_per_sm x n_sm`` (1 when even one CTA a query does), where
    ``ctas_per_sm`` is the walk kernel's resident CTAs per SM (the
    library's ``raft_bq_walk_ctas_per_sm()``). A small batch spreads each
    query's walk over up to 16 SMs; a large one fills the card with one
    CTA a query."""
    budget = ctas_per_sm * n_sm
    return max([c for c in CLUSTER_SIZES if max(q, 1) * c <= budget],
               default=1)


def auto_query_bits(bits: int) -> int:
    """Query quantization width matched to the code ladder: 4 bits below
    3 code bits, 8 from 3 on, where the code estimate is sharp enough
    that the 4-bit query grid would dominate the noise."""
    return 4 if bits < 3 else 8


def resolve_bq_engine(engine: str, *, data=None, filter_words=None,
                      k=None) -> str:
    """Resolve an ivf_bq ``scan_engine`` to ``cuda``, ``torch`` or
    ``rank``, before any launch.

    ``auto`` is the CUDA kernel for an index on a CUDA device and the
    plain engine otherwise. An index without the raw-vector plane
    (``data is None``) always takes ``rank``: the fused engines have
    nothing to rerank. ``cuda`` goes to ``torch`` where the kernel does
    not apply: a per-query (2-D) filter (the id fold needs one shared id
    plane), ``k`` past :data:`CUDA_MAX_K`, a dimension past
    :data:`CUDA_MAX_DIM`, or a vector plane that is not float32 (the
    exact-rerank contract)."""
    expect(engine in BQ_ENGINES,
           f"scan_engine must be one of {BQ_ENGINES}, got {engine!r}")
    if engine == "rank" or data is None:
        return "rank"
    if engine == "auto":
        engine = "cuda" if data.device.type == "cuda" else "torch"
    if engine != "cuda":
        return engine
    if filter_words is not None and filter_words.ndim == 2:
        return "torch"
    if k is not None and k > CUDA_MAX_K:
        return "torch"
    if data.shape[-1] > CUDA_MAX_DIM:
        return "torch"
    if data.dtype != torch.float32:
        return "torch"
    return engine


def _div(x: torch.Tensor, c) -> torch.Tensor:
    """``x / c`` for a Python number ``c``, correctly rounded on every
    device. PyTorch's CUDA division by a host scalar multiplies by the
    scalar's float32 reciprocal, an ulp off for c = 12 or 15: enough to
    move a query lane to another quantization level, and so a prune
    decision, away from the kernel's and the JAX package's."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dimension in the order the kernel takes it:
    zero-padded to a power of two lanes, the upper half is added to the
    lower half until one lane is left. Padding further with zeros changes
    no rounding, so the kernel's wider padding gives the same sum."""
    n = x.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        x = torch.nn.functional.pad(x, (0, width - n))
    while width > 1:
        width //= 2
        x = x[..., :width] + x[..., width:]
    return x[..., 0]


def estimator_margin(qc_norm, rnorm, errw, delta, dim_ext: int,
                     epsilon: float):
    """Per-candidate distance-error bound at confidence ``epsilon`` (the
    fused prune's margin): the rotation term ``‖q~‖·errw/√D`` and the
    query-quantization term ``delta²·(rnorm² + errw²)/12`` add in
    quadrature; 2 is the cross term's weight in the squared distance."""
    recon2 = rnorm * rnorm + errw * errw
    return 2.0 * epsilon * torch.sqrt(
        _div(torch.square(qc_norm * errw), dim_ext)
        + _div(torch.square(delta) * recon2, 12.0))


def _pack_words(signs: torch.Tensor) -> torch.Tensor:
    """(..., D) bool -> (..., D // 32) int32 words: bit b of word w is
    component 32w + b (the JAX package's ``ivf_bq._pack_words``; the
    scan packs the query's bit-planes with it too)."""
    d = signs.shape[-1]
    b = signs.reshape(*signs.shape[:-1], d // 32, 32).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=signs.device) << \
        torch.arange(32, device=signs.device)
    v = (b * weights).sum(dim=-1)        # the word's unsigned value
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """Population count of int32 lanes (int64 result) by the SWAR ladder
    of the JAX package's ``_popcount32``, taken on the lanes' unsigned
    32-bit values in int64 so that no step overflows."""
    v = v.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def _estimate_block(qt, codes_wb, rnorm_row, cfac_t, *, dim_ext: int,
                    bits: int, query_bits: int):
    """Popcount estimate of the cross term ``Σ_l a_l·<q~, s_l>`` of one
    list: ``qt`` (q, >= dim_ext) the rotated query side, ``codes_wb``
    (m, bits·W) the packed sign words, ``rnorm_row`` (1, m) and
    ``cfac_t`` (bits, m) the corrections. Returns ``(cross (q, m),
    delta (q, 1))``, op for op as the JAX package's ``_estimate_block``:
    ``<q~, s> = delta·<u, s> + lo·Σs`` with the integer parts exact.

    Each query may instead score its own m rows (the beam search's
    candidates): ``codes_wb`` (q, m, bits·W), ``rnorm_row`` (q, m) and
    ``cfac_t`` (bits, q, m); the arithmetic is the same, element by
    element."""
    qt = qt[:, :dim_ext]
    q = qt.shape[0]
    w_cnt = dim_ext // 32
    lo = qt.amin(dim=1, keepdim=True)
    hi = qt.amax(dim=1, keepdim=True)
    levels = (1 << query_bits) - 1
    delta = torch.clamp(_div(hi - lo, levels), min=1e-30)
    # clip before the integer cast: the JAX cast saturates, torch's does not
    u = torch.clamp(torch.round((qt - lo) / delta), 0, levels).to(torch.int64)
    # packed query bit-planes: (q, W) int32 words per plane
    uw = [_pack_words(((u >> jbit) & 1).to(torch.bool))
          for jbit in range(query_bits)]
    m = codes_wb.shape[-2]
    cross = qt.new_zeros((q, m))
    for lev in range(bits):
        cw = codes_wb[..., lev * w_cnt:(lev + 1) * w_cnt]      # (.., m, W)
        pcc = _popcount32(cw).sum(dim=-1)                      # (.., m)
        ius = torch.zeros((q, m), dtype=torch.int64, device=qt.device)
        for jbit in range(query_bits):
            acc = _popcount32(uw[jbit][:, None, :] ^ cw).sum(
                dim=-1)                                        # (q, m)
            ius = ius + ((pcc - acc) << jbit)
        ssum = (2 * pcc - dim_ext).to(torch.float32)
        qs = delta * ius.to(torch.float32) + lo * ssum
        a = rnorm_row * cfac_t[lev]
        cross = cross + a * qs
    return cross, delta


def _block_estimate(qrot, crot, rnorm_row, errw_row, cfac_t, codes_wb, *,
                    dim_ext: int, bits: int, query_bits: int, epsilon: float,
                    ip_metric: bool):
    """Min-space estimate and margin of one list for every query;
    ``crot`` is the (1, dim_ext) rotated center. Returns
    ``(est (q, m), margin (q, m))``."""
    qrot = qrot[:, :dim_ext]
    crot = crot[:, :dim_ext]
    if ip_metric:
        qt = qrot
        base_ip = tree_sum(qrot * crot)[:, None]
    else:
        qt = qrot - crot
    cross, delta = _estimate_block(qt, codes_wb, rnorm_row, cfac_t,
                                   dim_ext=dim_ext, bits=bits,
                                   query_bits=query_bits)
    qc2 = tree_sum(torch.square(qt))[:, None]
    qcn = torch.sqrt(qc2)
    if ip_metric:
        est = -(base_ip + cross)
    else:
        est = torch.clamp(qc2, min=0.0) + torch.square(rnorm_row) \
            - 2.0 * cross
    margin = estimator_margin(qcn, rnorm_row, errw_row, delta, dim_ext,
                              epsilon)
    return est, margin


# ---------------------------------------------------------------------------
# the per-row record plane of the beam search's BQ traversal
# ---------------------------------------------------------------------------


def bq_record_geometry(words: int, bits: int):
    """Row geometry of the packed per-row BQ record plane, byte for byte
    the JAX package's (the v5 CAGRA file carries it): a record is
    ``words`` int32 code words, then ``rnorm | cfac[bits] | errw`` as
    float32 bit patterns; records pad to a multiple of 4 lanes
    (``rec_pad``) and ``rpt = 128 / gcd(rec_pad, 128)`` of them fill one
    plane row of ``pw`` lanes. Returns ``(rec, rec_pad, rpt, pw)``."""
    rec = words + bits + 2
    rec_pad = -(-rec // 4) * 4
    rpt = 128 // math.gcd(rec_pad, 128)
    return rec, rec_pad, rpt, rpt * rec_pad


def pack_bq_records(codes: torch.Tensor, rnorm: torch.Tensor,
                    cfac: torch.Tensor, errw: torch.Tensor) -> torch.Tensor:
    """Pack per-row estimator inputs into the record plane of
    :func:`bq_record_geometry`: ``(ceil(n / rpt), pw)`` int32, pad
    records all zero."""
    n, words = codes.shape
    bits = cfac.shape[1]
    _, rec_pad, rpt, pw = bq_record_geometry(words, bits)
    scal = torch.cat([rnorm[:, None], cfac, errw[:, None]], dim=1).to(
        torch.float32).contiguous()
    n_pad = -(-n // rpt) * rpt
    rows = torch.zeros((n_pad, rec_pad), dtype=torch.int32,
                       device=codes.device)
    rows[:n, :words] = codes.to(torch.int32)
    rows[:n, words:words + bits + 2] = scal.view(torch.int32)
    return rows.reshape(n_pad // rpt, pw)


def unpack_bq_records(records: torch.Tensor, n: int, words: int, bits: int):
    """Exact inverse of :func:`pack_bq_records`: ``(codes (n, words)
    int32, rnorm (n,), cfac (n, bits), errw (n,))``."""
    _, rec_pad, _, _ = bq_record_geometry(words, bits)
    rows = records.reshape(-1, rec_pad)[:n]
    scal = rows[:, words:words + bits + 2].contiguous().view(torch.float32)
    return rows[:, :words], scal[:, 0], scal[:, 1:1 + bits], scal[:, 1 + bits]


def bq_list_major_scan(qf, qrot, centers_rot, codes, rnorm, cfac, errw,
                       indices, data, data_norms, probes, filter_words=None,
                       cold_planes=None, hot_slot_map=None,
                       cold_slot_map=None, *, k: int, metric: DistanceType,
                       epsilon: float, engine: str = "torch",
                       query_bits: int = _QUERY_BITS):
    """Run the fused estimate-then-rerank scan. Returns ``(best_d,
    best_i, survivors)``: the (q, k) top-k with **exact** distances
    (full squared L2 with +inf pads, or raw inner products with -inf
    pads), ids with -1 in unfilled slots, and the (q,) int32 count of
    rows each query reranked. Probe slots holding the sentinel
    ``n_lists`` are ignored, and a repeated probe counts once.
    ``engine`` is resolved (``cuda`` or ``torch``); CPU tensors always
    take the plain engine.

    ``cold_planes`` (a tiered index, :class:`~raft_tpu_torch.neighbors
    .tiered.TieredIvfBq`) holds the cold halves ``(codes, rnorm, cfac,
    errw, data)`` of the five record planes, whose hot halves are then
    the arguments of the same names; each step takes all five planes of
    its list from one tier through one ``(hot_slot_map, cold_slot_map)``
    pair, so an estimate and its rerank rows never split across tiers.
    The plain engine only: the kernel has no dual-source variant
    (``resolve_tier_bq_engine`` resolves tiered searches to ``torch``
    before any launch), and the wrapper refuses ``cuda`` with them."""
    expect(engine in ("cuda", "torch"),
           f"bq_list_major_scan engine must be cuda|torch, got {engine!r}")
    expect(data is not None and data_norms is not None,
           "the fused BQ scan needs the raw-vector rerank plane "
           "(build with store_vectors=True)")
    args = (qf, qrot, centers_rot, codes, rnorm, cfac, errw, indices, data,
            data_norms, probes, filter_words)
    kw = dict(k=k, metric=metric, epsilon=epsilon, query_bits=query_bits)
    if cold_planes is not None:
        expect(engine == "torch",
               "tiered BQ record planes need the plain fused engine "
               "(resolve_tier_bq_engine): the kernel has no dual-source "
               "variant")
        expect(hot_slot_map is not None and cold_slot_map is not None,
               "tiered BQ record planes need both slot maps")
        return _bq_scan_torch(*args, **kw, tier=(cold_planes, hot_slot_map,
                                                  cold_slot_map))
    if engine == "torch" or data.device.type == "cpu":
        return _bq_scan_torch(*args, **kw)
    return _bq_scan_cuda(*args, **kw)


# ---------------------------------------------------------------------------
# plain engine
# ---------------------------------------------------------------------------


def _bq_scan_torch(qf, qrot, centers_rot, codes, rnorm, cfac, errw, indices,
                   data, data_norms, probes, filter_words, *, k: int,
                   metric: DistanceType, epsilon: float, query_bits: int,
                   rows_read=None, tier=None):
    """The plain engine. ``rows_read``, an optional (n_lists, m) bool
    tensor, gets every slot that some query reranked set: the rows of
    the vector plane the scan must read. With ``tier`` (the cold record
    planes, the hot and cold slot maps) each list's five record planes
    come from its tier, one block of each per probed list and request,
    copied to the queries' device when cold."""
    q = qf.shape[0]
    n_lists = indices.shape[0]
    dim_ext = centers_rot.shape[1]
    bits = cfac.shape[2]
    ip_metric = metric == DistanceType.InnerProduct
    qf = qf.to(torch.float32)
    qrot = qrot.to(torch.float32)
    uniq = unique_lists(probes, n_lists)
    # a shared (1-D) filter folds into the id planes; a per-query one
    # tests in the step
    filter_2d = filter_words is not None and filter_words.ndim == 2
    ids_g = union_id_planes(indices, uniq,
                            None if filter_2d else filter_words)
    qn = tree_sum(qf * qf)
    best_d = qf.new_full((q, k), float("inf"))
    best_i = torch.full((q, k), -1, dtype=torch.int32, device=qf.device)
    survivors = torch.zeros((q,), dtype=torch.int64, device=qf.device)
    hot = (codes, rnorm, cfac, errw, data)
    if tier is not None:
        from raft_tpu_torch.ops.tier_scan import (
            tier_block_select,
            tier_slot_pair,
        )

        cold = tier[0]
        hot_map, cold_map = tier[1].tolist(), tier[2].tolist()
    for j, lid in enumerate(uniq.tolist()):
        if lid >= n_lists:          # sentinel steps match no query
            continue
        if tier is None:
            l_codes, l_rnorm, l_cfac, l_errw, l_data = (p[lid] for p in hot)
        else:
            # one slot decision for all five planes of the list
            hs, cs = tier_slot_pair(hot_map, cold_map, lid)
            l_codes, l_rnorm, l_cfac, l_errw, l_data = (
                tier_block_select(h, c, hs, cs) for h, c in zip(hot, cold))
        est, margin = _block_estimate(
            qrot, centers_rot[lid:lid + 1].to(torch.float32),
            l_rnorm[None, :], l_errw[None, :], l_cfac.T, l_codes,
            dim_ext=dim_ext, bits=bits, query_bits=query_bits,
            epsilon=epsilon, ip_metric=ip_metric)
        ids_b = ids_g[j][None, :].expand(q, -1)
        probed = (probes == lid).any(dim=1)
        ok = (ids_b >= 0) & probed[:, None]
        if filter_2d:
            ok = ok & test_filter(filter_words, ids_b)
        est = torch.where(ok, est, torch.full_like(est, float("inf")))
        # the prune: the k-th exact distance as it stands at the list start
        cand = (est - margin) < best_d[:, k - 1:k]
        survivors += cand.sum(dim=1)
        if not bool(cand.any()):
            continue                # an all-inf merge changes nothing
        if rows_read is not None:
            rows_read[lid] |= cand.any(dim=0)
        # exact distances of the survivors only, each dot product a
        # tree_sum of rounded products (no matmul: its order is its own)
        qi, ri = torch.nonzero(cand, as_tuple=True)
        dot = tree_sum(qf[qi] * l_data[ri].to(torch.float32))
        if ip_metric:
            pair = -dot
        else:
            pair = torch.clamp(qn[qi] + data_norms[lid][ri] - 2.0 * dot,
                               min=0.0)
        exact = torch.full_like(est, float("inf"))
        exact[qi, ri] = pair
        best_d, best_i = _merge_smallest_id(best_d, best_i, exact, ids_b, k)
    if ip_metric:
        best_d = -best_d            # inf (unfilled) -> -inf
    return best_d, best_i, survivors.to(torch.int32)


# ---------------------------------------------------------------------------
# CUDA engine
# ---------------------------------------------------------------------------


def _walk_plan(probes: torch.Tensor, n_lists: int):
    """What the kernel walks: the probed-list union ``uniq`` and, per
    query, its probes sorted by list id as positions into ``uniq``, with
    -1 for sentinel slots and for repeats of a list."""
    pr = sorted_probes(probes, n_lists)
    uniq = unique_lists(pr, n_lists)
    upos = torch.searchsorted(uniq.to(torch.int64), pr)
    upos = torch.where(pr < n_lists, upos, torch.full_like(upos, -1))
    return uniq, upos.to(torch.int32).contiguous()


def _bq_scan_cuda(qf, qrot, centers_rot, codes, rnorm, cfac, errw, indices,
                  data, data_norms, probes, filter_words, *, k: int,
                  metric: DistanceType, epsilon: float, query_bits: int,
                  cluster=None):
    """The kernel's wrapper. ``cluster`` forces a cluster size of
    :data:`CLUSTER_SIZES` (the card tests run each); by default it is
    :func:`bq_cluster_size` of the batch. The size launched is kept in
    ``bq_list_major_scan.last_cluster``."""
    dev = data.device
    q, d = qf.shape
    n_lists, m, words = codes.shape
    dim_ext = centers_rot.shape[1]
    bits = cfac.shape[2]
    p = probes.shape[1]
    planes = (qrot, centers_rot, codes, rnorm, cfac, errw, indices,
              data_norms, probes)
    expect(all(t.device == dev for t in (qf,) + planes),
           "bq_list_major_scan: all inputs must be on the data's device")
    floats = (data, data_norms, rnorm, cfac, errw)
    expect(all(t.dtype == torch.float32 for t in floats)
           and codes.dtype == torch.int32,
           "bq_list_major_scan: kernel takes float32 vector and correction "
           "planes and int32 code words")
    expect(all(t.is_contiguous() for t in floats + (codes,)),
           "bq_list_major_scan: index planes must be contiguous")
    per_slot = (n_lists, m)
    expect(data.shape == (n_lists, m, d) and cfac.shape == per_slot + (bits,)
           and all(t.shape == per_slot for t in (indices, data_norms, rnorm,
                                                 errw))
           and tuple(centers_rot.shape) == (n_lists, dim_ext)
           and tuple(qrot.shape) == (q, dim_ext)
           and words == bits * dim_ext // 32 and dim_ext % 32 == 0,
           "bq_list_major_scan: shape mismatch")
    expect(0 < k <= CUDA_MAX_K,
           f"bq_list_major_scan: kernel takes 0 < k <= {CUDA_MAX_K}, got {k}")
    expect(dim_ext <= CUDA_MAX_DIM,
           f"bq_list_major_scan: kernel takes dim_ext <= {CUDA_MAX_DIM}")
    expect(1 <= bits <= 4 and 1 <= query_bits <= 8,
           "bq_list_major_scan: kernel takes bits 1..4, query_bits 1..8")
    expect(filter_words is None or filter_words.ndim == 1,
           "bq_list_major_scan: kernel takes a shared (1-D) filter only")
    from raft_tpu_torch.ops import _build

    launch = _build.load("bq_scan")
    if cluster is None:
        props = torch.cuda.get_device_properties(dev)
        cluster = bq_cluster_size(
            q, n_sm=props.multi_processor_count,
            ctas_per_sm=_build.constant("bq_scan", "raft_bq_walk_ctas_per_sm"))
    expect(cluster in CLUSTER_SIZES,
           f"bq_list_major_scan: cluster size must be one of "
           f"{CLUSTER_SIZES}, got {cluster}")
    uniq, upos = _walk_plan(probes, n_lists)
    ids_g = union_id_planes(indices, uniq, filter_words).to(
        torch.int32).contiguous()
    live = live_rows(ids_g).contiguous()
    qf = qf.to(torch.float32).contiguous()
    qrot = qrot.to(torch.float32).contiguous()
    crot = centers_rot.to(torch.float32).contiguous()
    # the query side of every (query, probe slot): bit-planes and scalars
    side_words = torch.empty((q * p * query_bits * dim_ext // 32,),
                             dtype=torch.int32, device=dev)
    side_scal = torch.empty((q * p * 5,), dtype=torch.float32, device=dev)
    outd = torch.empty((q, k), dtype=torch.float32, device=dev)
    outi = torch.empty((q, k), dtype=torch.int32, device=dev)
    surv = torch.zeros((q,), dtype=torch.int32, device=dev)
    used = ctypes.c_int(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = launch(qf.data_ptr(), qrot.data_ptr(), crot.data_ptr(),
                 codes.data_ptr(), rnorm.data_ptr(), cfac.data_ptr(),
                 errw.data_ptr(), data.data_ptr(), data_norms.data_ptr(),
                 ids_g.data_ptr(), uniq.data_ptr(), upos.data_ptr(),
                 live.data_ptr(), side_words.data_ptr(),
                 side_scal.data_ptr(), q, p, d, dim_ext, m, bits, query_bits,
                 k, int(metric == DistanceType.InnerProduct), cluster,
                 2.0 * epsilon, outd.data_ptr(), outi.data_ptr(),
                 surv.data_ptr(), ctypes.addressof(used), stream)
    _build.check(err, "bq_list_major_scan")
    bq_list_major_scan.launches += 1
    bq_list_major_scan.last_cluster = used.value
    return outd, outi, surv


bq_list_major_scan.launches = 0
bq_list_major_scan.last_cluster = 0
