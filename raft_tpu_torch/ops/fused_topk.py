"""Fused distance + top-k: exact kNN that never materializes the (q, n)
distance matrix, and exact k-selection over wide rows.

``fused_knn`` replaces the JAX package's Pallas kernel ``_knn_kernel``
(``raft_tpu/ops/fused_topk.py``, reached through ``_fused_knn_impl`` /
``fused_knn``) with the hand-written CUDA kernel ``csrc/fused_knn.cu``.
On the H100 the work is 2*q*n*d float32 operations (no TF32: exact kNN
needs full float32 products, as the JAX kernel's ``Precision.HIGHEST``),
so at serving batch sizes the kernel is bound by CUDA-core arithmetic,
not by the one read of the dataset per 64-query tile. Its design is two
passes: dataset splits score in parallel blocks that each keep a
per-query top-k in shared memory, then one warp per query merges the
splits in (distance, smallest id) order. See the source for details.

``select_k_tiles`` replaces the JAX package's Pallas kernel
``_select_kernel`` (reached through ``_select_k_tiles_impl``) with
``csrc/select_k.cu``: column chunks of each row are scanned by warps in
parallel, each keeping a top-k in shared memory, and the per-chunk lists
merge per row in (value, smallest column) order. It is bound by one
read of the (b, n) input.

``stream_read_sum`` replaces the JAX package's Pallas kernel
``_stream_kernel`` (reached through ``_stream_read_impl``) with
``csrc/stream_read.cu``: a column sum of (n, d) that reads each element
once, the device-memory roofline probe. Blocks sum contiguous row ranges
with 16-byte loads, then a second pass adds the per-block rows in a
fixed order (the result is the same from run to run).

Each wrapper runs its kernel for CUDA tensors and its plain version
(``fused_knn_plain``, ``select_k_tiles_plain``, ``stream_read_sum_plain``)
for CPU tensors; it never falls back from one to the other.
``fused_knn.launches``, ``select_k_tiles.launches`` and
``stream_read_sum.launches`` count the kernels' launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.distance.types import DistanceType

_SUPPORTED_METRICS = (
    DistanceType.L2Expanded,
    DistanceType.L2SqrtExpanded,
    DistanceType.L2Unexpanded,
    DistanceType.L2SqrtUnexpanded,
    DistanceType.InnerProduct,
    DistanceType.CosineExpanded,
)
_SQRT_METRICS = (DistanceType.L2SqrtExpanded, DistanceType.L2SqrtUnexpanded)

_PLAIN_TILE = 65536   # dataset rows per matmul in the plain version

#: largest k the kernel takes (its per-query lists live in shared memory)
MAX_K = 64

# kernel metric kinds / final steps (csrc/fused_knn.cu, topk_common.cuh)
_KIND_L2, _KIND_IP, _KIND_COSINE = 0, 1, 2
_EPILOG_NONE, _EPILOG_SQRT, _EPILOG_NEGATE = 0, 1, 2


def _prepare(queries: torch.Tensor, dataset: torch.Tensor,
             dataset_norms: Optional[torch.Tensor]):
    """Queries in the dataset's precision (bf16 datasets take bf16-rounded
    queries, as the JAX kernel casts them), as float32, plus both norm
    planes in float32."""
    if dataset.dtype == torch.bfloat16:
        qs = queries.to(torch.bfloat16).to(torch.float32)
    else:
        qs = queries.to(torch.float32)
    qn = (qs * qs).sum(dim=1)
    if dataset_norms is None:
        xf = dataset.to(torch.float32)
        xn = (xf * xf).sum(dim=1)
    else:
        xn = dataset_norms.to(torch.float32).reshape(-1)
    return qs.contiguous(), qn.contiguous(), xn.contiguous()


def min_space_distances(ip, qn, xn, metric: DistanceType):
    """The kernel's epilog on a (q, t) block of inner products, in
    min-space (smaller is closer): clamped expanded L2, ``-ip``, or
    cosine distance — ``_knn_kernel``'s ``dist`` (``fused_topk.py:92-98``)."""
    if metric == DistanceType.InnerProduct:
        return -ip
    if metric == DistanceType.CosineExpanded:
        inv = 1.0 / torch.sqrt(torch.clamp(qn[:, None] * xn[None, :],
                                           min=1e-30))
        return 1.0 - ip * inv
    return torch.clamp((qn[:, None] + xn[None, :]) - 2.0 * ip, min=0.0)


def finish(dist, ids, metric: DistanceType):
    """Final step shared with the kernel: non-finite slots get id -1,
    sqrt metrics take the root, inner products get their sign back."""
    ids = torch.where(torch.isfinite(dist), ids, torch.full_like(ids, -1))
    if metric in _SQRT_METRICS:
        dist = torch.sqrt(dist)
    elif metric == DistanceType.InnerProduct:
        dist = -dist
    return dist, ids


def fused_knn_plain(queries: torch.Tensor, dataset: torch.Tensor, k: int,
                    metric: DistanceType = DistanceType.L2Expanded, *,
                    dataset_norms: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`fused_knn`: the same epilog on
    ``torch.matmul`` products, selection in (distance, smallest id) order
    by stable sorts over dataset tiles (``_extract_topk``'s semantics,
    ``fused_topk.py:48-63``)."""
    metric = DistanceType(metric)
    qs, qn, xn = _prepare(queries, dataset, dataset_norms)
    n = dataset.shape[0]
    best_d = qs.new_full((qs.shape[0], 0), float("inf"))
    best_i = torch.zeros((qs.shape[0], 0), dtype=torch.int64,
                         device=qs.device)
    for start in range(0, n, _PLAIN_TILE):
        xt = dataset[start : start + _PLAIN_TILE].to(torch.float32)
        ip = qs @ xt.T
        dist = min_space_distances(ip, qn, xn[start : start + _PLAIN_TILE],
                                   metric)
        # running state first: its ids are all smaller than this tile's,
        # so a stable sort on distance keeps the smallest id first on ties
        cat_d = torch.cat([best_d, dist], dim=1)
        cat_i = torch.cat([best_i, start + torch.arange(
            xt.shape[0], device=qs.device).expand(qs.shape[0], -1)], dim=1)
        sd, pos = torch.sort(cat_d, dim=1, stable=True)
        best_d = sd[:, :k]
        best_i = torch.gather(cat_i, 1, pos[:, :k])
    return finish(best_d, best_i.to(torch.int32), metric)


def _check_cuda_inputs(queries, dataset, dataset_norms, k):
    dev = dataset.device
    expect(queries.device == dev, "fused_knn: queries and dataset on "
           "different devices")
    expect(dataset.dtype in (torch.float32, torch.bfloat16),
           f"fused_knn: dataset dtype {dataset.dtype} (kernel takes "
           "float32 or bfloat16)")
    expect(dataset.is_contiguous(), "fused_knn: dataset must be contiguous")
    expect(k <= MAX_K, f"fused_knn: kernel takes k <= {MAX_K}, got {k}")
    if dataset_norms is not None:
        expect(dataset_norms.device == dev
               and dataset_norms.numel() == dataset.shape[0],
               "fused_knn: dataset_norms must be (n,) on the dataset's device")


def fused_knn(queries: torch.Tensor, dataset: torch.Tensor, k: int,
              metric: DistanceType = DistanceType.L2Expanded, *,
              dataset_norms: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN: (q, k) float32 distances and int32 ids, -1 for slots no
    finite candidate filled. Inner products come back as similarities
    (largest first).

    CUDA tensors run ``csrc/fused_knn.cu``; CPU tensors run
    :func:`fused_knn_plain`."""
    metric = DistanceType(metric)
    expect(metric in _SUPPORTED_METRICS,
           f"fused_knn: unsupported metric {metric!r}")
    expect(queries.ndim == 2 and dataset.ndim == 2
           and queries.shape[1] == dataset.shape[1], "fused_knn: dim mismatch")
    n, d = dataset.shape
    expect(0 < k <= n, "fused_knn: bad k")
    if dataset.device.type == "cpu":
        return fused_knn_plain(queries, dataset, k, metric,
                               dataset_norms=dataset_norms)
    _check_cuda_inputs(queries, dataset, dataset_norms, k)
    from raft_tpu_torch.ops import _build

    launch = _build.load("fused_knn")
    qs, qn, xn = _prepare(queries, dataset, dataset_norms)
    q = qs.shape[0]
    q_tiles = -(-q // 64)
    # dataset splits scored in parallel: about four blocks per SM
    sms = torch.cuda.get_device_properties(dataset.device)\
        .multi_processor_count
    splits = max(1, min(-(-4 * sms // q_tiles), -(-n // 64)))
    rows = -(-n // splits)
    chunk = -(-rows // 64) * 64        # rows per split, 64-aligned
    splits = -(-n // chunk)
    kind = (_KIND_IP if metric == DistanceType.InnerProduct
            else _KIND_COSINE if metric == DistanceType.CosineExpanded
            else _KIND_L2)
    epilog = (_EPILOG_SQRT if metric in _SQRT_METRICS
              else _EPILOG_NEGATE if metric == DistanceType.InnerProduct
              else _EPILOG_NONE)
    pd = torch.empty((q, splits, k), dtype=torch.float32, device=qs.device)
    pi = torch.empty((q, splits, k), dtype=torch.int32, device=qs.device)
    outd = torch.empty((q, k), dtype=torch.float32, device=qs.device)
    outi = torch.empty((q, k), dtype=torch.int32, device=qs.device)
    stream = torch.cuda.current_stream(dataset.device).cuda_stream
    err = launch(qs.data_ptr(), qn.data_ptr(), dataset.data_ptr(),
                 xn.data_ptr(), int(dataset.dtype == torch.bfloat16), q, n, d,
                 k, kind, epilog, splits, chunk, pd.data_ptr(), pi.data_ptr(),
                 outd.data_ptr(), outi.data_ptr(), stream)
    _build.check(err, "fused_knn")
    fused_knn.launches += 1
    return outd, outi


fused_knn.launches = 0


# ---------------------------------------------------------------------------
# wide-row k-selection
# ---------------------------------------------------------------------------

#: largest k the selection kernel takes
SELECT_MAX_K = 128
_SELECT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SELECT_UNROLL_COLS = 256   # columns a warp covers per step (select_k.cu)


def select_k_tiles_plain(values: torch.Tensor, k: int,
                         select_min: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`select_k_tiles`: values in
    float32 min-space (select-max negated), non-finite entries left out,
    a stable sort so that equal values keep the smaller column first;
    slots no finite value filled come out (+inf, -1), negated back for
    select-max."""
    vals = values.to(torch.float32)
    if not select_min:
        vals = -vals
    vals = torch.where(torch.isfinite(vals), vals,
                       torch.full_like(vals, float("inf")))
    sd, pos = torch.sort(vals, dim=1, stable=True)
    sd, pos = sd[:, :k], pos[:, :k].to(torch.int32)
    ids = torch.where(torch.isfinite(sd), pos, torch.full_like(pos, -1))
    return (sd if select_min else -sd), ids


def select_k_tiles(values: torch.Tensor, k: int, select_min: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-selection over wide (b, n) rows: (b, k) float32 values and
    int32 columns, ties to the first occurrence; a row with fewer than k
    finite values fills the rest with index -1.

    CUDA tensors run ``csrc/select_k.cu``; CPU tensors run
    :func:`select_k_tiles_plain`."""
    expect(values.ndim == 2, "select_k_tiles expects (batch, n) values")
    b, n = values.shape
    expect(0 < k <= n, f"select_k_tiles: k must be in (0, {n}], got {k}")
    if values.device.type == "cpu":
        return select_k_tiles_plain(values, k, select_min)
    expect(values.dtype in _SELECT_DTYPES,
           f"select_k_tiles: kernel takes float32/bfloat16/float16, got "
           f"{values.dtype}")
    expect(k <= SELECT_MAX_K,
           f"select_k_tiles: kernel takes k <= {SELECT_MAX_K}, got {k}")
    from raft_tpu_torch.ops import _build

    launch = _build.load("select_k")
    values = values.contiguous()
    out_d = torch.empty((b, k), dtype=torch.float32, device=values.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=values.device)
    if b == 0:
        return out_d, out_i
    # one warp per (row, column chunk): about 16 warps per SM, chunks of
    # at least 4096 columns so the per-row merge stays short
    sms = torch.cuda.get_device_properties(values.device)\
        .multi_processor_count
    splits = max(1, min(-(-16 * sms // b), -(-n // 4096)))
    chunk = -(-(-(-n // splits)) // _SELECT_UNROLL_COLS) * _SELECT_UNROLL_COLS
    splits = -(-n // chunk)
    pd = torch.empty((b, splits, k), dtype=torch.float32,
                     device=values.device)
    pi = torch.empty((b, splits, k), dtype=torch.int32, device=values.device)
    stream = torch.cuda.current_stream(values.device).cuda_stream
    err = launch(values.data_ptr(), _SELECT_DTYPES[values.dtype], b, n, k,
                 int(not select_min), splits, chunk, pd.data_ptr(),
                 pi.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), stream)
    _build.check(err, "select_k_tiles")
    select_k_tiles.launches += 1
    return out_d, out_i


select_k_tiles.launches = 0


# ---------------------------------------------------------------------------
# stream probe
# ---------------------------------------------------------------------------

_STREAM_BLOCKS_PER_SM = 4   # row ranges per SM (csrc/stream_read.cu)


def stream_read_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`stream_read_sum`: the float32
    column sum, (1, d)."""
    return torch.sum(x, dim=0, keepdim=True, dtype=torch.float32)


def stream_read_sum(x: torch.Tensor) -> torch.Tensor:
    """Column sum of ``x`` (n, d), float32 or bfloat16, accumulated in
    float32 and returned as (1, d) float32 — a pure streamed read of
    ``x``, the probe that bandwidth-bound kernels are held against.

    CUDA tensors run ``csrc/stream_read.cu`` and must be contiguous (a
    copy would measure the copy); CPU tensors run
    :func:`stream_read_sum_plain`."""
    expect(x.ndim == 2, "stream_read_sum expects (n, d)")
    if x.device.type == "cpu":
        return stream_read_sum_plain(x)
    expect(x.dtype in (torch.float32, torch.bfloat16),
           f"stream_read_sum: kernel takes float32/bfloat16, got {x.dtype}")
    expect(x.is_contiguous(), "stream_read_sum: x must be contiguous")
    n, d = x.shape
    if n == 0 or d == 0:
        return torch.zeros((1, d), dtype=torch.float32, device=x.device)
    vec = (d * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0
    out = _stream_launch(x.data_ptr(), x.dtype == torch.bfloat16, vec, n, d,
                         x.device)
    stream_read_sum.launches += 1
    return out


def _stream_launch(ptr: int, bf16: bool, vec: bool, n: int, d: int,
                   device: torch.device) -> torch.Tensor:
    """Launch ``csrc/stream_read.cu`` on the (n, d) rows at address
    ``ptr`` (device memory, or pinned host memory read in place through
    the unified address space); returns the (1, d) float32 sums on
    ``device``. ``vec`` takes the 16-byte loads (the caller checks the
    row width and alignment)."""
    from raft_tpu_torch.ops import _build

    launch = _build.load("stream_read")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = max(1, min(_STREAM_BLOCKS_PER_SM * sms, -(-n // 64)))
    rows = -(-n // blocks)
    blocks = -(-n // rows)
    partial = torch.empty((blocks, d), dtype=torch.float32, device=device)
    out = torch.empty((1, d), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = launch(ptr, int(bf16), int(vec), n, d, rows, blocks,
                 partial.data_ptr(), out.data_ptr(), stream)
    _build.check(err, "stream_read_sum")
    return out


stream_read_sum.launches = 0
