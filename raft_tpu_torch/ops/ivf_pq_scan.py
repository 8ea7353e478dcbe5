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

- ``cuda``: ``csrc/ivf_pq_scan.cu``. One block for each (query, probe
  slot) builds that pair's LUT in shared memory, streams the list's code
  rows through a shared tile, scores each row, keeps a per-warp filtered
  top-k (``topk_common.cuh``), merges the warps' lists and writes one
  partial list; a second launch merges each query's partial lists. A LUT
  too large for shared memory is built and scored in parts that keep the
  order of the sum. The C entry alone decides whether a shape fits, and
  a shape that does not raises.
- ``torch``: the plain version, the twin of the JAX ``xla`` engine: a
  loop over the probed-list union that builds every query's LUT for the
  list, gathers, sums and merges by ``_merge_smallest_id``. CPU tensors
  run it.

Both take every sum in one order, so they agree bit for bit: the LUT's
``Σ_l`` terms in ascending ``l`` with separately rounded products and
sums (``__f*_rn`` in the kernel), ``Σ_s`` in :func:`tree_sum`'s halving
order over :func:`tree_width` lanes, and the fp8 scale and its division
correctly rounded. The rotated residuals ``q~ = R(q - c)`` of every
(query, probe slot) come from one batched product that both share.

``ivf_pq_scan.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.neighbors.filters import test_filter
from raft_tpu_torch.ops.bq_scan import _div, tree_sum
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
    ``max |lut| / fmax`` (at least 1e-30). Returns ``(lut, scale)`` with
    ``scale`` (q,) to multiply into the summed scores, or None."""
    expect(lut_dtype in LUT_DTYPES,
           f"lut_dtype must be float32/bfloat16/float8_e4m3fn/float8_e5m2, "
           f"got {lut_dtype}")
    if lut_dtype in _FP8_MAX:
        scale = _div(lut.abs().amax(dim=(1, 2)), _FP8_MAX[lut_dtype])
        scale = torch.clamp(scale, min=1e-30)
        return (lut / scale[:, None, None]).to(lut_dtype).to(
            torch.float32), scale
    return lut.to(lut_dtype).to(torch.float32), None


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
                filter_words=None, *, k: int, ip_metric: bool,
                per_cluster: bool, lut_dtype, packed: bool,
                engine: str = "torch", score=None):
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
    default; the kernel computes the gather)."""
    expect(engine in ("cuda", "torch"),
           f"ivf_pq_scan engine must be cuda|torch, got {engine!r}")
    if engine == "torch" or codes.device.type == "cpu":
        return _scan_torch(qres, base, codebooks, cb_norms, codes, indices,
                           probes, filter_words, k=k, ip_metric=ip_metric,
                           per_cluster=per_cluster, lut_dtype=lut_dtype,
                           packed=packed, score=score or _score_gather)
    expect(score is None or score is _score_gather,
           "ivf_pq_scan: the kernel computes the gather formulation")
    return _scan_cuda(qres, base, codebooks, cb_norms, codes, indices,
                      probes, filter_words, k=k, ip_metric=ip_metric,
                      per_cluster=per_cluster, lut_dtype=lut_dtype,
                      packed=packed)


def _scan_torch(qres, base, codebooks, cb_norms, codes, indices, probes,
                filter_words, *, k: int, ip_metric: bool, per_cluster: bool,
                lut_dtype, packed: bool, score):
    """The plain list-major twin: one step a list of the probed union."""
    q, p = probes.shape
    n_lists = indices.shape[0]
    L = codebooks.shape[2]
    dev = codes.device
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
        rows = unpack_codes(codes[lid], packed)                 # (m, S)
        dist = score(lut, rows[None].expand(q, -1, -1)
                     if score is not _score_gather else rows)
        if scale is not None:
            dist = dist * scale[:, None]
        if ip_metric:
            dist = -(dist + base[qidx, slot][:, None])          # min-space
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


def _scan_cuda(qres, base, codebooks, cb_norms, codes, indices, probes,
               filter_words, *, k: int, ip_metric: bool, per_cluster: bool,
               lut_dtype, packed: bool):
    dev = codes.device
    q, p = probes.shape
    n_lists, m, row_bytes = codes.shape
    book, L = codebooks.shape[1], codebooks.shape[2]
    pq_dim = row_bytes * 2 if packed else row_bytes
    expect(lut_dtype in LUT_DTYPES, f"ivf_pq_scan: bad lut_dtype {lut_dtype}")
    expect(codes.dtype == torch.uint8 and indices.dtype == torch.int32,
           "ivf_pq_scan: codes must be uint8 and indices int32")
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
    expect(all(t.device == dev for t in tensors),
           "ivf_pq_scan: all inputs must be on the codes' device")
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.ops.ivf_scan import live_rows

    launch = _build.load("ivf_pq_scan")
    qres = qres.contiguous()
    codebooks = codebooks.contiguous()
    codes = codes.contiguous()
    indices = indices.contiguous()
    probes = probes.contiguous()
    base_t = None if base is None else base.to(torch.float32).contiguous()
    cbn = None if ip_metric else cb_norms.to(torch.float32).contiguous()
    fw = None
    fw_stride = 0
    if filter_words is not None:
        fw = filter_words.to(torch.int32).contiguous()
        fw_stride = fw.shape[1] if fw.dim() == 2 else 0
    live = live_rows(indices).contiguous()
    pd = torch.empty((q * p * k,), dtype=torch.float32, device=dev)
    pi = torch.empty((q * p * k,), dtype=torch.int32, device=dev)
    outd = torch.empty((q, k), dtype=torch.float32, device=dev)
    outi = torch.empty((q, k), dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(dev).cuda_stream
    err = launch(qres.data_ptr(), ptr(base_t), codebooks.data_ptr(),
                 ptr(cbn), codes.data_ptr(), indices.data_ptr(),
                 live.data_ptr(), probes.data_ptr(), ptr(fw), fw_stride,
                 q, p, n_lists, m, row_bytes, pq_dim, L, book, k,
                 int(ip_metric), int(per_cluster), int(packed),
                 _lut_code(lut_dtype), pd.data_ptr(), pi.data_ptr(),
                 outd.data_ptr(), outi.data_ptr(), stream)
    _build.check(err, "ivf_pq_scan")
    ivf_pq_scan.launches += 1
    return outd, outi


ivf_pq_scan.launches = 0
