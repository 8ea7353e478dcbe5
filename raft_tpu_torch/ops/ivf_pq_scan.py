"""IVF-PQ list scan with lookup tables — the list-major engine family of
:mod:`raft_tpu_torch.neighbors.ivf_pq`.

The JAX package scores PQ codes in XLA (``raft_tpu/neighbors/ivf_pq.py``
``_search_impl_fn``, ``scan_engine="xla"``): for each list of the probed
union, every query builds the list's lookup table (LUT) and scores the
list's code rows as ``Σ_s lut[s, code_s]``. It has no Pallas kernel, so
this engine replaces no TPU kernel: on the H100 the plain version of
that scan is a gather from device memory, and the kernel keeps the LUT
in shared memory instead, as RAFT's ``compute_similarity`` does.

One contract (:func:`ivf_pq_scan`), per query: the top-k by (distance,
smallest id) over the rows of the lists it probed, in the metric's own
values (inner products for IP, the ADC squared distance for L2; no
sqrt). Probe slots holding the sentinel ``n_lists`` (masked or ragged
slots), ids ``< 0`` and filtered ids match nothing; unfilled slots carry
id -1. A row's slots name each list at most once, as coarse select gives
them (:func:`dedup_slots` makes hand-built slots so).

- ``cuda``: ``csrc/ivf_pq_scan.cu``, list-major. A plan kernel lays out
  work items on the device (:func:`_pq_items` is its plain twin): (probed
  list, chunk of its live rows, group of up to 16 of the (query, probe
  slot) pairs that probe it), sized by the C library's
  ``raft_ivf_pq_plan`` for the table shape (:func:`_pq_plan`). A block
  builds the group's whole tables in shared memory once, streams the
  chunk's rows past them (a row's codes in registers), keeps a filtered
  top-k queue a warp and writes one partial top-k per pair and chunk; a
  last launch merges each query's partial lists. A table too large for
  the block (gist-960's pq_dim 240 in fp32) takes a per-pair instance
  that builds it in parts keeping the order of the sum. The C entry alone
  decides whether a shape fits, and a shape that does not raises. A
  tiered index's cold code lists (pinned host memory) are staged first:
  ``_launch_tiered`` plans a device ring with the tiered IVF-Flat scan's
  ``tier_stage_plan`` and the library's tiered entry copies each probed
  cold list once, then launches the hot lists and each wave after its
  copies, every block reading its list's rows through a per-list table
  (counters ``tier.{cold_bytes_staged,cold_lists_staged,stage_waves}``).
- ``torch``: the plain version, the twin of the JAX ``xla`` engine: a
  loop over the probed-list union that builds every query's LUT for the
  list, gathers, sums and merges by ``_merge_smallest_id``. CPU tensors
  run it.

Both take every sum in one order, so they agree bit for bit: the LUT's
``Σ_l`` terms in ascending ``l`` with separately rounded products and
sums (``__f*_rn`` in the kernel), ``Σ_s`` in :func:`tree_sum`'s halving
order over :func:`tree_width` lanes, the fp8 scale one rounded product
by ``1 / fmax`` in float32, each entry's division by it correctly
rounded, and an fp8 IP score's ``Σ * scale + q·c`` one fused multiply-add
(:func:`scale_and_base`). The rotated residuals ``q~ = R(q - c)`` of every
(query, probe slot) come from one batched product that both share.

``ivf_pq_scan.launches`` counts the kernel's launches.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.neighbors.filters import test_filter
from raft_tpu_torch.ops.bq_scan import tree_sum
from raft_tpu_torch.ops.ivf_scan import _merge_smallest_id, unique_lists

#: largest k the kernel takes; past it ``resolve_scan_engine`` sends the
#: search to the plain engine before any launch
CUDA_MAX_K = 512

#: the LUT dtypes, in the order of the kernel's codes for them
LUT_DTYPES = (torch.float32, torch.bfloat16, torch.float8_e4m3fn,
              torch.float8_e5m2)
_FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def tree_width(pq_dim: int) -> int:
    """Lanes of the ``Σ_s`` tree: ``pq_dim`` rounded up to a power of two,
    at least 8 (the kernel sums groups of eight subspaces)."""
    return max(8, 1 << max(pq_dim - 1, 0).bit_length())


# ---------------------------------------------------------------------------
# LUT and scoring (shared by the engines and neighbors/ivf_pq.py)
# ---------------------------------------------------------------------------


def _seq_sum(terms):
    """Σ of a list of tensors in list order, each add rounded."""
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def codebook_norms(codebooks: torch.Tensor) -> torch.Tensor:
    """(B, J) ``Σ_l cb[b, j, l]²`` in ascending ``l``."""
    return _seq_sum([codebooks[..., l] * codebooks[..., l]
                     for l in range(codebooks.shape[-1])])


def probe_lut(qsub: torch.Tensor, cb: torch.Tensor, cb_norms,
              ip_metric: bool, per_query: bool) -> torch.Tensor:
    """(q, S, J) float32 LUT of one probe for each query. ``qsub`` (q, S,
    L) is the rotated residual (L2) or the rotated query (IP) by
    subspace; ``cb`` the codebook, (S, J, L) for every query or, with
    ``per_query`` (per-cluster codebooks), (q, J, L) one a query;
    ``cb_norms`` its (S, J) or (q, J) norms (:func:`codebook_norms`).
    L2: ``(‖q~_s‖² - 2 q~_s·cb_sj) + ‖cb_sj‖²``; IP: ``q~_s·cb_sj``."""
    L = qsub.shape[-1]
    cbb = cb[:, None] if per_query else cb[None]          # (., ., J, L)
    x = qsub[:, :, None, :]                               # (q, S, 1, L)
    dot = _seq_sum([x[..., l] * cbb[..., l] for l in range(L)])
    if ip_metric:
        return dot
    qn = _seq_sum([qsub[..., l] * qsub[..., l] for l in range(L)])
    cbn = cb_norms[:, None] if per_query else cb_norms[None]
    return (qn[:, :, None] - 2.0 * dot) + cbn


def quantize_lut(lut: torch.Tensor, lut_dtype):
    """Round the (q, S, J) LUT to ``lut_dtype`` — the reference's
    fp32/fp16/fp8 LUT ladder (``ivf_pq_compute_similarity-inl.cuh:125-177``)
    — and back to float32 for the sums. fp8's range cannot hold raw
    squared distances, so each query's table is scaled into it by
    ``max |lut| * (1 / fmax)`` (at least 1e-30), the reciprocal rounded to
    float32: XLA folds the JAX package's ``max / fmax`` into that product,
    and an ulp of scale moves integer tables onto fp8 rounding ties.
    Returns ``(lut, scale)`` with ``scale`` (q,) to multiply into the
    summed scores, or None."""
    expect(lut_dtype in LUT_DTYPES,
           f"lut_dtype must be float32/bfloat16/float8_e4m3fn/float8_e5m2, "
           f"got {lut_dtype}")
    if lut_dtype in _FP8_MAX:
        # a 0-d CPU tensor: a float32 scalar operand on any device
        inv = torch.tensor(1.0 / _FP8_MAX[lut_dtype], dtype=torch.float32)
        scale = lut.abs().amax(dim=(1, 2)) * inv
        scale = torch.clamp(scale, min=1e-30)
        return (lut / scale[:, None, None]).to(lut_dtype).to(
            torch.float32), scale
    return lut.to(lut_dtype).to(torch.float32), None


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in float32 with one rounding, as ``__fmaf_rn`` on the
    card: the float64 product is exact, the float64 sum is rounded to odd
    (exact ``TwoSum`` error, the last bit set when it is not zero), and
    the one rounding to float32 is then correct."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    even = (s.view(torch.int64) & 1) == 0
    bump = torch.nextafter(s, torch.where(err > 0, float("inf"),
                                          float("-inf")).to(s.dtype))
    s = torch.where((err != 0) & even, bump, s)
    return s.to(torch.float32)


def scale_and_base(dist: torch.Tensor, scale, base) -> torch.Tensor:
    """A probe's summed codes to its score: ``dist * scale`` (fp8 tables)
    plus ``base`` (IP's ``q·c``), either one may be None. With both, one
    rounding (:func:`fma32`), as XLA's CPU backend contracts the JAX
    package's ``dist * scale + base`` into a fused multiply-add."""
    if scale is not None and base is not None:
        return fma32(dist, scale, base)
    if scale is not None:
        dist = dist * scale
    if base is not None:
        dist = dist + base
    return dist


def _score_gather(lut: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``dist[q, r] = Σ_s lut[q, s, rows[., r, s]]`` in :func:`tree_sum`'s
    order over :func:`tree_width` lanes: the kernel's formulation. ``rows``
    is (q, m, S), or (m, S) shared by every query."""
    q, S, J = lut.shape
    flat = lut.reshape(q, S * J)
    offs = torch.arange(S, device=lut.device) * J
    if rows.dim() == 2:
        m = rows.shape[0]
        g = flat[:, (rows.to(torch.int64) + offs).reshape(-1)]
    else:
        m = rows.shape[1]
        g = torch.gather(flat, 1, (rows.to(torch.int64) + offs).reshape(q, -1))
    g = g.reshape(q, m, S)
    W = tree_width(S)
    if W != S:
        g = torch.nn.functional.pad(g, (0, W - S))
    return tree_sum(g)


def dedup_slots(probes: torch.Tensor, n_lists: int) -> torch.Tensor:
    """Hand-built probe slots made fit for :func:`ivf_pq_scan`: out-of-range
    ids and repeats of an earlier slot's list become the sentinel
    ``n_lists`` (slot order kept), so a list counts once per query, as
    the JAX engine's membership test ``any(probes == lid)`` does. The
    search never needs it: coarse select gives distinct lists."""
    pr = probes.to(torch.int64)
    pr = torch.where((pr < 0) | (pr >= n_lists), torch.full_like(pr, n_lists),
                     pr)
    p = pr.shape[1]
    earlier = torch.ones(p, p, dtype=torch.bool, device=pr.device).tril(-1)
    dup = ((pr[:, :, None] == pr[:, None, :]) & earlier).any(dim=2)
    return torch.where(dup, torch.full_like(pr, n_lists), pr).to(torch.int32)


def unpack_codes(rows: torch.Tensor, packed: bool) -> torch.Tensor:
    """Code bytes -> one code per subspace: two 4-bit codes a byte when
    ``packed``, the even subspace in the low nibble."""
    if not packed:
        return rows
    lo = rows & 0x0F
    hi = rows >> 4
    return torch.stack([lo, hi], dim=-1).reshape(
        *rows.shape[:-1], rows.shape[-1] * 2)


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------


def ivf_pq_scan(qres, base, codebooks, cb_norms, codes, indices, probes,
                filter_words=None, cold_codes=None, hot_slot_map=None,
                cold_slot_map=None, *, k: int, ip_metric: bool,
                per_cluster: bool, lut_dtype, packed: bool,
                engine: str = "torch", score=None,
                workspace_bytes: Optional[int] = None):
    """The LUT scan of every query's probed lists. Returns ``(best_d,
    best_i)`` (q, k) float32 and int32 (see the module docstring).

    ``qres``: L2 (q, p, dim_ext) float32, the rotated residual of each
    (query, probe slot); IP (q, dim_ext), the rotated query. ``base``:
    IP (q, p), ``q·c`` of each slot's list; L2 None. ``codebooks``
    (pq_dim or n_lists, J, L) float32 with ``cb_norms`` (pq_dim or
    n_lists, J) (L2). ``codes`` (n_lists, m, row_bytes) uint8, ``indices``
    (n_lists, m) int32, ``probes`` (q, p) int32 list ids in ``[0,
    n_lists]``, no list twice in a row (the module docstring). ``engine`` is
    resolved (``cuda`` or ``torch``); CPU tensors take the plain version.
    ``score`` is the plain engine's scoring formulation (the gather by
    default; the kernel computes the gather).

    A tiered index passes ``cold_codes`` (n_cold, m, row_bytes), with
    ``codes`` its hot plane (n_hot, m, row_bytes) and the (n_lists,)
    ``hot_slot_map`` / ``cold_slot_map`` (each list's slot in its tier, -1
    in the other): each probed list's code rows come from its tier
    (:func:`~raft_tpu_torch.ops.tier_scan.tier_block_select` in the plain
    version; in the kernel's, a per-list table into the hot plane or a
    staging ring of ``workspace_bytes``, ``Resources.workspace_limit_bytes``
    by default, that each probed cold list is copied into once, from
    pinned host memory). The results equal the all-device scan's."""
    expect(engine in ("cuda", "torch"),
           f"ivf_pq_scan engine must be cuda|torch, got {engine!r}")
    tier = None
    if cold_codes is not None:
        expect(hot_slot_map is not None and cold_slot_map is not None,
               "ivf_pq_scan: tiered codes need both slot maps")
        tier = (cold_codes, hot_slot_map, cold_slot_map)
    if engine == "torch" or codes.device.type == "cpu":
        return _scan_torch(qres, base, codebooks, cb_norms, codes, indices,
                           probes, filter_words, k=k, ip_metric=ip_metric,
                           per_cluster=per_cluster, lut_dtype=lut_dtype,
                           packed=packed, score=score or _score_gather,
                           tier=tier)
    expect(score is None or score is _score_gather,
           "ivf_pq_scan: the kernel computes the gather formulation")
    return _scan_cuda(qres, base, codebooks, cb_norms, codes, indices,
                      probes, filter_words, k=k, ip_metric=ip_metric,
                      per_cluster=per_cluster, lut_dtype=lut_dtype,
                      packed=packed, tier=tier,
                      workspace_bytes=workspace_bytes)


def _scan_torch(qres, base, codebooks, cb_norms, codes, indices, probes,
                filter_words, *, k: int, ip_metric: bool, per_cluster: bool,
                lut_dtype, packed: bool, score, tier=None):
    """The plain list-major twin: one step a list of the probed union.
    With ``tier`` (cold codes, hot and cold slot maps) each list's code
    rows come from its tier, the one divergence from the all-device
    twin."""
    q, p = probes.shape
    n_lists = indices.shape[0]
    L = codebooks.shape[2]
    dev = codes.device
    if tier is not None:
        from raft_tpu_torch.ops.tier_scan import (
            tier_block_select,
            tier_slot_pair,
        )

        cold_codes = tier[0]
        hot_map, cold_map = tier[1].tolist(), tier[2].tolist()
    qidx = torch.arange(q, device=dev)
    best_d = torch.full((q, k), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((q, k), -1, dtype=torch.int32, device=dev)
    for lid in unique_lists(probes, n_lists).tolist():
        if lid >= n_lists:
            continue                  # sentinel steps match no query
        member = probes == lid                                  # (q, p)
        probed = member.any(dim=1)
        slot = torch.argmax(member.to(torch.int32), dim=1)
        qr = qres if ip_metric else qres[qidx, slot]            # (q, D)
        qsub = qr.reshape(q, -1, L)
        if per_cluster:
            cb = codebooks[lid][None].expand(q, -1, -1)
            cbn = None if ip_metric else cb_norms[lid][None].expand(q, -1)
        else:
            cb, cbn = codebooks, cb_norms
        lut = probe_lut(qsub, cb, cbn, ip_metric, per_query=per_cluster)
        lut, scale = quantize_lut(lut, lut_dtype)
        if tier is None:
            block = codes[lid]
        else:
            block = tier_block_select(
                codes, cold_codes, *tier_slot_pair(hot_map, cold_map, lid))
        rows = unpack_codes(block, packed)                      # (m, S)
        dist = score(lut, rows[None].expand(q, -1, -1)
                     if score is not _score_gather else rows)
        dist = scale_and_base(
            dist, None if scale is None else scale[:, None],
            base[qidx, slot][:, None] if ip_metric else None)
        if ip_metric:
            dist = -dist                                        # min-space
        ids = indices[lid][None, :].expand(q, -1)
        ok = (ids >= 0) & probed[:, None]
        if filter_words is not None:
            ok = ok & test_filter(filter_words, ids)
        dist = torch.where(ok, dist, torch.full_like(dist, float("inf")))
        best_d, best_i = _merge_smallest_id(best_d, best_i, dist, ids, k)
    if ip_metric:
        best_d = -best_d          # inf (unfilled) -> -inf, ip exact
    return best_d, best_i


def _lut_code(lut_dtype) -> int:
    return LUT_DTYPES.index(lut_dtype)


#: (pq_dim, pq_len, book, k, lut code, wide) -> (rows, group) of the C
#: plan ("wide": the library's kWidePairs test on q * p), and "items", the
#: bound plan-kernel entry
_PLANS: dict = {}
_WIDE_PAIRS = 4096


def _pq_plan(pq_dim: int, pq_len: int, book: int, k: int, lut: int,
             pairs: int):
    """``(rows, group)`` of the kernel's work items for this table shape:
    the C library's choice (``raft_ivf_pq_plan``), which its entry holds
    the launch to; ``(0, 0)`` when one pair's table does not fit the
    list-major block and the per-pair instance scans. Raises for a shape
    no block fits."""
    key = (pq_dim, pq_len, book, k, lut, pairs >= _WIDE_PAIRS)
    if key not in _PLANS:
        import ctypes

        from raft_tpu_torch.ops import _build

        fn = _build.function("ivf_pq_scan", "raft_ivf_pq_plan",
                             [ctypes.c_int] * 5 + [ctypes.c_longlong,
                                                   ctypes.c_void_p])
        out = (ctypes.c_int * 4)()
        _build.check(fn(pq_dim, pq_len, book, k, lut, pairs, out),
                     f"ivf_pq_scan: no block fits pq_dim {pq_dim}, "
                     f"pq_len {pq_len}, book {book}, k {k}")
        _PLANS[key] = (out[0], out[1])
    return _PLANS[key]


def _pq_items(probes, indices, k: int, rows: int, group: int):
    """The kernel's work-item plan in plain PyTorch, the twin of the
    library's ``raft_ivf_pq_items`` (which the wrapper runs on the card);
    no host sync. Every list is a step: ``offs`` (n_lists + 1,) CSR over
    the (list, query)-sorted pairs ``pair_q`` / ``pair_slot`` (a pair's
    own probe slot; sentinel slots form no pair), ``live`` each list's
    rows up to its last live id, ``item_off`` (n_lists + 1,) int64 the
    first item of each list: its items are (chunk of ``rows`` live rows,
    group of ``group`` pairs), from
    :func:`~raft_tpu_torch.ops.ivf_scan._scan_items`; ``slot_off`` (q * p
    + 1,) the first partial list of each (query, probe slot), one a chunk
    of its list, and partial buffers of a bound from the shapes alone
    (``q * p * ceil(m / rows)`` lists of k). The device plan orders a
    list's pairs by arrival, which changes no result."""
    from raft_tpu_torch.ops.ivf_scan import _scan_items, live_rows

    q, p = probes.shape
    n_lists, m = indices.shape
    dev = probes.device
    pr = probes.to(torch.int64)
    pr = torch.where((pr < 0) | (pr >= n_lists), torch.full_like(pr, n_lists),
                     pr)
    rows_of = torch.arange(q, device=dev)[:, None]
    skey, order = torch.sort((pr * q + rows_of).reshape(-1))
    counts = torch.zeros(n_lists + 1, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, skey // q, torch.ones_like(skey))
    offs = torch.zeros(n_lists + 1, dtype=torch.int64, device=dev)
    offs[1:] = torch.cumsum(counts[:n_lists], 0)
    pair_q = (skey % q).to(torch.int32)
    pair_slot = (order % p).to(torch.int32)
    live = live_rows(indices)
    _, item_off, slot_off = _scan_items(offs, pair_q, pair_slot, live, q, p,
                                        chunk=rows, group=group)
    n_part = q * p * max(1, -(-m // rows)) * k
    return dict(offs=offs.to(torch.int32), pair_q=pair_q,
                pair_slot=pair_slot, live=live.contiguous(),
                item_off=item_off, slot_off=slot_off,
                pd=torch.empty((n_part,), dtype=torch.float32, device=dev),
                pi=torch.empty((n_part,), dtype=torch.int32, device=dev))


def _pq_items_cuda(probes, indices, k: int, rows: int, group: int):
    """:func:`_pq_items` by the library's plan kernel (one launch): the
    same arrays, in one int32 workspace."""
    import ctypes

    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.ops.ivf_scan import live_rows

    q, p = probes.shape
    n_lists, m = indices.shape
    dev = probes.device
    live = live_rows(indices).contiguous()
    probes = probes.to(torch.int32).contiguous()
    # item_off (int64) first, then offs, pair_q, pair_slot, slot_off, cursor
    n_i64 = 2 * (n_lists + 1)
    sizes = (n_i64, n_lists + 1, q * p, q * p, q * p + 1, n_lists)
    ws = torch.empty((sum(sizes),), dtype=torch.int32, device=dev)
    parts, at = [], 0
    for n in sizes:
        parts.append(ws[at:at + n])
        at += n
    item_off = parts[0].view(torch.int64)
    fn = _PLANS.get("items")
    if fn is None:
        fn = _PLANS["items"] = _build.function(
            "ivf_pq_scan", "raft_ivf_pq_items",
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 7)
    _build.check(fn(probes.data_ptr(), q, p, n_lists, live.data_ptr(), rows,
                    group, parts[1].data_ptr(), parts[2].data_ptr(),
                    parts[3].data_ptr(), item_off.data_ptr(),
                    parts[4].data_ptr(), parts[5].data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream),
                 "ivf_pq_scan plan")
    n_part = q * p * max(1, -(-m // rows)) * k
    return dict(offs=parts[1], pair_q=parts[2], pair_slot=parts[3],
                live=live, item_off=item_off, slot_off=parts[4],
                pd=torch.empty((n_part,), dtype=torch.float32, device=dev),
                pi=torch.empty((n_part,), dtype=torch.int32, device=dev))


def _scan_cuda(qres, base, codebooks, cb_norms, codes, indices, probes,
               filter_words, *, k: int, ip_metric: bool, per_cluster: bool,
               lut_dtype, packed: bool, tier=None,
               workspace_bytes: Optional[int] = None):
    dev = codes.device
    q, p = probes.shape
    n_lists, m = indices.shape
    row_bytes = codes.shape[2]
    book, L = codebooks.shape[1], codebooks.shape[2]
    pq_dim = row_bytes * 2 if packed else row_bytes
    expect(lut_dtype in LUT_DTYPES, f"ivf_pq_scan: bad lut_dtype {lut_dtype}")
    expect(codes.dtype == torch.uint8 and indices.dtype == torch.int32,
           "ivf_pq_scan: codes must be uint8 and indices int32")
    expect(codes.shape[1] == m and (tier is not None
                                    or codes.shape[0] == n_lists),
           "ivf_pq_scan: codes and indices do not match")
    expect(qres.dtype == torch.float32 and codebooks.dtype == torch.float32,
           "ivf_pq_scan: residuals and codebooks must be float32")
    expect(0 < k <= CUDA_MAX_K,
           f"ivf_pq_scan: kernel takes 0 < k <= {CUDA_MAX_K}, got {k}")
    expect(qres.shape == ((q, pq_dim * L) if ip_metric
                          else (q, p, pq_dim * L)),
           "ivf_pq_scan: residuals do not match the probes")
    expect(not ip_metric or (base is not None and base.shape == (q, p)),
           "ivf_pq_scan: IP needs the (q, p) base plane")
    tensors = [qres, codebooks, codes, indices, probes]
    if base is not None:
        tensors.append(base)
    if not ip_metric:
        tensors.append(cb_norms)
    if filter_words is not None:
        tensors.append(filter_words)
    if tier is not None:
        tensors += [tier[1], tier[2]]
    expect(all(t.device == dev for t in tensors),
           "ivf_pq_scan: all inputs but the cold tier must be on the codes' "
           "device")
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.ops.ivf_scan import live_rows

    outd = torch.empty((q, k), dtype=torch.float32, device=dev)
    outi = torch.empty((q, k), dtype=torch.int32, device=dev)
    if q == 0:
        return outd, outi
    launch = _build.load("ivf_pq_scan")
    lut = _lut_code(lut_dtype)
    rows, group = _pq_plan(pq_dim, L, book, k, lut, q * p)
    qres = qres.contiguous()
    codebooks = codebooks.contiguous()
    codes = codes.contiguous()
    indices = indices.contiguous()
    probes = probes.to(torch.int32).contiguous()
    if group:
        g = _pq_items_cuda(probes, indices, k, rows, group)
    else:  # the per-pair instance: no items, one partial list a pair
        g = dict(live=live_rows(indices).contiguous(),
                 pd=torch.empty((q * p * k,), dtype=torch.float32,
                                device=dev),
                 pi=torch.empty((q * p * k,), dtype=torch.int32, device=dev))
    base_t = None if base is None else base.to(torch.float32).contiguous()
    cbn = None if ip_metric else cb_norms.to(torch.float32).contiguous()
    fw = None
    fw_stride = 0
    if filter_words is not None:
        fw = filter_words.to(torch.int32).contiguous()
        fw_stride = fw.shape[1] if fw.dim() == 2 else 0
    # a host bound on the item count sizes the grid (no sync)
    max_items = (q * p // max(group, 1) + n_lists) * max(1, -(-m // max(
        rows, 1)))

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (qres.data_ptr(), ptr(base_t), codebooks.data_ptr(), ptr(cbn),
            codes.data_ptr(), indices.data_ptr(), probes.data_ptr(), ptr(fw),
            fw_stride,
            *(ptr(g.get(n)) for n in (
                "offs", "pair_q", "pair_slot", "live", "item_off",
                "slot_off")),
            q, p, n_lists, m, row_bytes, pq_dim, L, book, k,
            int(ip_metric), int(per_cluster), int(packed), lut,
            max_items, rows, group, g["pd"].data_ptr(),
            g["pi"].data_ptr(), outd.data_ptr(), outi.data_ptr())
    if tier is None:
        err = launch(*args, stream)
    else:
        err = _launch_tiered(args, tier, codes, probes, g["live"], m,
                             row_bytes, workspace_bytes, stream)
    _build.check(err, "ivf_pq_scan")
    ivf_pq_scan.launches += 1
    return outd, outi


def _launch_tiered(args, tier, hot_codes, probes, live, m: int,
                   row_bytes: int, workspace_bytes, stream) -> int:
    """The dual-source launch: stage the probed cold lists' code rows
    into a device ring (:func:`~raft_tpu_torch.ops.tier_scan
    .tier_stage_plan`, the plan of the tiered IVF-Flat scan), build the
    per-list table (each list's first code row in the hot plane or the
    ring, and the launch that scans it), and call the library's tiered
    entry, which copies, launches and merges. The request's one host
    sync reads the slot maps, the live rows and the probed lists."""
    import ctypes

    from raft_tpu_torch.core.resources import Resources
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.ops.tier_scan import (
        _side_stream_handles,
        count_staging,
        tier_stage_plan,
    )

    cold_codes, hot_slot_map, cold_slot_map = tier
    dev = hot_codes.device
    n_lists = live.shape[0]
    expect(cold_codes.dtype == torch.uint8
           and cold_codes.shape[1:] == hot_codes.shape[1:],
           "ivf_pq_scan: the cold codes must match the hot plane's rows")
    expect(cold_codes.numel() == 0 or (cold_codes.device.type == "cpu"
                                       and cold_codes.is_pinned()),
           "ivf_pq_scan: the cold codes must be pinned host memory "
           "(torch.Tensor.pin_memory()); the kernel stages them with "
           "asynchronous copies, which a pageable plane would serialize")
    expect(cold_codes.is_contiguous()
           and hot_slot_map.shape == (n_lists,)
           and cold_slot_map.shape == (n_lists,),
           "ivf_pq_scan: tier shape mismatch")
    pr = probes.to(torch.int64)
    pr = torch.where((pr < 0) | (pr >= n_lists), n_lists, pr)
    probed = torch.zeros(n_lists + 1, dtype=torch.int64, device=dev)
    probed.index_fill_(0, pr.reshape(-1), 1)
    hot_h, cold_h, live_h, probed_h = torch.stack(
        [hot_slot_map.to(torch.int64), cold_slot_map.to(torch.int64),
         live.to(torch.int64), probed[:n_lists]]).cpu().numpy()
    cold_fetch = np.where(probed_h > 0, cold_h, -1)
    if workspace_bytes is None:
        workspace_bytes = Resources.workspace_limit_bytes
    plan = tier_stage_plan(cold_fetch, live_h, m, workspace_bytes,
                           row_bytes=row_bytes)
    ring = (torch.empty((plan.ring_rows * row_bytes,), dtype=torch.uint8,
                        device=dev) if plan.ring_rows else None)
    # each list's first code row and its launch: hot lists -1, staged
    # cold lists their wave, unprobed cold lists -2 (never scanned)
    addr = np.zeros(n_lists, np.int64)
    wave = np.full(n_lists, -2, np.int64)
    hot = hot_h >= 0
    addr[hot] = hot_codes.data_ptr() + hot_h[hot] * (m * row_bytes)
    wave[hot] = -1
    if len(plan.steps):
        addr[plan.steps] = ring.data_ptr() + plan.offsets * row_bytes
        wave[plan.steps] = np.searchsorted(plan.wave_end,
                                           np.arange(len(plan.steps)),
                                           side="right")
    table = torch.from_numpy(np.concatenate([addr, wave])).to(dev)
    fn = _PLANS.get("tiered")
    if fn is None:
        fn = _PLANS["tiered"] = _build.function(
            "ivf_pq_scan", "raft_ivf_pq_scan_tiered",
            _build.SIGNATURES["ivf_pq_scan"][1][:-1]
            + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
            + [ctypes.c_void_p] * 6)
    staged = plan.n_waves > 0
    err = fn(*args, table.data_ptr(),
             cold_codes.data_ptr() if staged else None,
             ring.data_ptr() if staged else None, plan.n_waves,
             int(plan.reuse), plan.wave_end.ctypes.data,
             plan.slots.ctypes.data, plan.offsets.ctypes.data,
             plan.rows.ctypes.data, stream, _side_stream_handles(dev)[0])
    count_staging(plan)
    _launch_tiered.last_plan = plan
    return err


_launch_tiered.last_plan = None


ivf_pq_scan.launches = 0
