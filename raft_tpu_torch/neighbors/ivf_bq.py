"""IVF-BQ — inverted file with RaBitQ binary quantization; port of
``raft_tpu/neighbors/ivf_bq.py``.

Each vector is stored in its list as the packed sign words of its
rotated residual ``R(x - c)`` (``bits`` levels of residual sign
quantization) plus three scalars: ``rnorm = ‖r‖``, ``cfac_l = a_l/‖r‖``
(per-level scales, rescaled so that ``<r, Σ a_l s_l> = ‖r‖²``) and
``errw = ‖r - recon‖``, the estimator's whole error budget. The rotation
is a pinned numpy PCG64 draw (:func:`_pinned_rotation`), byte for byte
the JAX package's, so both packages encode a vector to the same codes.

Two search modes, as in the JAX package:

- **fused** (``scan_engine``: ``auto | cuda | torch``, an index built
  with ``store_vectors=True``, the default): the list-major
  estimate-then-rerank scan of :mod:`raft_tpu_torch.ops.bq_scan` (the
  CUDA kernel on the card, its plain version on the CPU) returns
  **exact** distances;
- **estimate-only** (``scan_engine="rank"``, or any index without the
  vector plane): the rank-major scan of :func:`score_probe`; over-fetch
  by :func:`overfetch_budget` and rerank with
  :func:`raft_tpu_torch.neighbors.refine.refine`.

Supported metrics: L2Expanded / L2SqrtExpanded / InnerProduct.

The executor (:mod:`raft_tpu_torch.core.executor`) and :func:`search`
both run :func:`_search_impl_fn` as :func:`serving_plan` sets it up; the
executor's ragged plans run :func:`_search_ragged_fn`, the same body
with a per-row probe budget. The same body serves the tiered family
(:mod:`raft_tpu_torch.neighbors.tiered`, ``TieredIvfBq``: the five record
planes split between a hot tier and pinned host memory, ``cold_planes``).
:func:`build_streaming` builds from a dataset file chunk by chunk; the
list-sharded index is :mod:`raft_tpu_torch.distributed.bq`. Not ported
yet: the opt-in ``memwatch.admit`` capacity gate of ``extend``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.cluster.kmeans_balanced import KMeansBalancedParams
from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.resources import Resources, ensure_resources
from raft_tpu_torch.core.serialize import (
    check_version,
    deserialize_array,
    deserialize_scalar,
    open_maybe_path,
    serialize_array,
    serialize_scalar,
)
from raft_tpu_torch.core.validation import expect
from raft_tpu_torch.distance.types import DistanceType, is_min_close
from raft_tpu_torch.matrix.select_k import merge_topk
from raft_tpu_torch.neighbors._batching import coarse_select, tile_queries
from raft_tpu_torch.neighbors._packing import pack_padded_lists, padded_extent
from raft_tpu_torch.neighbors.ann_types import IndexParams, SearchParams
from raft_tpu_torch.neighbors.filters import resolve_filter_words, test_filter
from raft_tpu_torch.neighbors.ivf_flat import _kmeans_metric, _slot_norms
from raft_tpu_torch.ops.bq_scan import (  # noqa: F401 - estimator_margin
    _pack_words,
    auto_query_bits,
    bq_list_major_scan,
    estimator_margin,
    resolve_bq_engine,
)
from raft_tpu_torch.ops.ivf_scan import probe_histogram, ragged_probes

# v3: RaBitQ corrections (rnorm/cfac/errw), int32 sign words, optional
# raw-vector rerank plane — the JAX package's format
_SERIALIZATION_VERSION = 3

# entangled into the pinned rotation stream (the JAX package's)
_ROTATION_STREAM = 0

# candidates displaced per unit of relative estimator error (the JAX
# package's one calibration constant of the over-fetch budgets)
_OVERFETCH_KAPPA = 25.0


def _pinned_rotation(seed: int, dim_ext: int, dim: int) -> np.ndarray:
    """Random orthogonal rotation dim -> dim_ext, (dim_ext, dim) float32,
    from numpy's PCG64 stream exactly as the JAX package draws it (same
    ``SeedSequence([seed, 0])``, QR, and sign normalization of the QR
    columns), so the two packages hold the same rotation bytes."""
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, _ROTATION_STREAM]))
    g = rng.standard_normal((max(dim_ext, dim), dim_ext))
    q, r = np.linalg.qr(g)
    d = np.sign(np.diag(r))
    d[d == 0] = 1.0
    q = q * d
    return np.ascontiguousarray(q[:dim, :].T, dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class IvfBqIndexParams(IndexParams):
    """The JAX package's ``IvfBqIndexParams``."""

    n_lists: int = 1024
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    # residual sign-quantization levels (bits per dimension, 1..4)
    bits: int = 1
    # keep the raw vectors in list layout: the fused scan's rerank plane
    store_vectors: bool = True


@dataclasses.dataclass(frozen=True)
class IvfBqSearchParams(SearchParams):
    """The JAX package's ``IvfBqSearchParams``. ``scan_engine``:
    ``auto`` is the CUDA kernel for an index on a CUDA device and the
    plain engine otherwise (on an index with the vector plane);
    ``cuda``/``torch`` force one (``cuda`` goes to ``torch`` where the
    kernel does not apply, see ``resolve_bq_engine``); ``rank`` is the
    estimate-only scan. ``coarse_algo="approx"`` runs the exact
    selection."""

    n_probes: int = 20
    coarse_algo: str = "exact"
    scan_engine: str = "auto"    # "auto" | "cuda" | "torch" | "rank"
    # error-bound confidence of the fused prune (est - margin must beat
    # the running k-th exact distance for a rerank)
    epsilon: float = 3.0
    # query quantization grid; 0 resolves per code ladder (auto_query_bits)
    query_bits: int = 0


@dataclasses.dataclass(frozen=True)
class IvfBqIndex:
    """Binary-quantized IVF index (RaBitQ construction)."""

    centers: torch.Tensor      # (n_lists, dim) f32
    rotation: torch.Tensor     # (dim_ext, dim) f32 orthogonal
    codes: torch.Tensor        # (n_lists, max_list_size, bits·dim_ext/32) i32
    rnorm: torch.Tensor        # (n_lists, max_list_size) f32
    cfac: torch.Tensor         # (n_lists, max_list_size, bits) f32
    errw: torch.Tensor         # (n_lists, max_list_size) f32
    indices: torch.Tensor      # (n_lists, max_list_size) i32, -1 pad
    list_sizes: torch.Tensor   # (n_lists,) i32
    metric: DistanceType
    # the rerank plane (store_vectors=True): raw vectors in list layout
    # and per-slot squared norms (+inf at padding)
    data: Optional[torch.Tensor] = None
    data_norms: Optional[torch.Tensor] = None

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def dim_ext(self) -> int:
        return self.rotation.shape[0]

    @property
    def bits(self) -> int:
        return self.cfac.shape[2]

    @property
    def max_list_size(self) -> int:
        return self.codes.shape[1]

    @property
    def size(self) -> int:
        return int(self.list_sizes.sum())


def _unpack_pm1(words: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """(..., n_words) int32 -> (..., 32·n_words) ±1 in ``dtype``."""
    bits = (words[..., None] >> torch.arange(32, dtype=torch.int32,
                                             device=words.device)) & 1
    pm1 = bits.to(dtype) * 2 - 1
    return pm1.reshape(*words.shape[:-1], words.shape[-1] * 32)


def _encode(rot_residuals: torch.Tensor, bits: int = 1):
    """Rotated residuals -> (sign words of every level, ‖r‖, per-level
    scales / ‖r‖, unexplained-residual norm), the JAX package's
    ``_encode``: level 0 sign-encodes r with the least-squares scale,
    each further level encodes what the earlier ones left, and one
    global rescale makes ``<r, Σ a_l s_l> = ‖r‖²`` exactly."""
    d = rot_residuals.shape[-1]
    rn2 = torch.square(rot_residuals).sum(dim=-1)
    rnorm = torch.sqrt(rn2)
    level_codes, level_scales = [], []
    resid = rot_residuals
    recon = torch.zeros_like(rot_residuals)
    for _ in range(bits):
        signs = resid >= 0
        s = torch.where(signs, 1.0, -1.0).to(rot_residuals.dtype)
        a = (resid * s).sum(dim=-1) / d
        level_codes.append(_pack_words(signs))
        level_scales.append(a)
        recon = recon + a[..., None] * s
        resid = resid - a[..., None] * s
    gamma = rn2 / torch.clamp((rot_residuals * recon).sum(dim=-1), min=1e-20)
    codes = torch.cat(level_codes, dim=-1)
    scales = torch.stack(level_scales, dim=-1) * gamma[..., None]
    errw = torch.linalg.vector_norm(rot_residuals - recon * gamma[..., None],
                                    dim=-1)
    cfac = scales / torch.clamp(rnorm, min=1e-20)[..., None]
    return (codes, rnorm.to(torch.float32), cfac.to(torch.float32),
            errw.to(torch.float32))


def _pack_lists(codes, rnorm, cfac, errw, ids, labels, n_lists, max_size,
                vectors=None, sizes=None):
    """Scatter rows into the padded [n_lists, max_list_size] layout (the
    shared sort-and-rank packing); ``vectors`` rides along as the rerank
    plane."""
    payloads = [(codes, 0), (rnorm, 0.0), (cfac, 0.0), (errw, 0.0),
                (ids, -1)]
    if vectors is not None:
        payloads.append((vectors, 0.0))
    return pack_padded_lists(labels, n_lists, max_size, payloads, sizes=sizes)


def from_numpy(centers, rotation, codes, rnorm, cfac, errw, indices,
               list_sizes, metric: DistanceType = DistanceType.L2Expanded,
               data=None, res: Optional[Resources] = None) -> IvfBqIndex:
    """An index from host arrays (e.g. the JAX index's), placed on the
    handle's device; the norm plane is recomputed, as ``load`` does."""
    res = ensure_resources(res)
    indices = res.put(indices, torch.int32)
    data = None if data is None else res.put(data, torch.float32)
    return IvfBqIndex(
        centers=res.put(centers, torch.float32),
        rotation=res.put(rotation, torch.float32),
        codes=res.put(codes, torch.int32),
        rnorm=res.put(rnorm, torch.float32),
        cfac=res.put(cfac, torch.float32),
        errw=res.put(errw, torch.float32),
        indices=indices,
        list_sizes=res.put(list_sizes, torch.int32),
        metric=DistanceType(int(metric)),
        data=data,
        data_norms=None if data is None else _slot_norms(data, indices),
    )


# ---------------------------------------------------------------------------
# build / extend
# ---------------------------------------------------------------------------


def build(res: Optional[Resources], params: IvfBqIndexParams,
          dataset) -> IvfBqIndex:
    """Train the coarse centers, draw the pinned rotation, and encode the
    dataset (keeping the raw vectors as the rerank plane by default)."""
    res = ensure_resources(res)
    dataset = res.put(dataset)
    expect(dataset.ndim == 2, "dataset must be (n, d)")
    n, dim = dataset.shape
    expect(params.n_lists <= n, "n_lists > n_rows")
    expect(params.metric in (DistanceType.L2Expanded,
                             DistanceType.L2SqrtExpanded,
                             DistanceType.InnerProduct),
           f"ivf_bq supports L2/L2Sqrt/InnerProduct, got {params.metric!r}")
    expect(1 <= params.bits <= 4, "bits must be in [1, 4]")
    dim_ext = -(-dim // 32) * 32
    with tracing.range("raft_tpu.ivf_bq.build"):
        frac = min(max(params.kmeans_trainset_fraction, 0.0), 1.0)
        n_train = min(n, max(params.n_lists * 2, int(n * frac)))
        stride = max(1, n // n_train)
        trainset = dataset[::stride][:n_train].to(torch.float32)
        km = KMeansBalancedParams(n_iters=params.kmeans_n_iters,
                                  metric=_kmeans_metric(params.metric),
                                  seed=res.seed)
        centers = kmeans_balanced.fit(res, km, trainset, params.n_lists)
        rotation = res.put(_pinned_rotation(res.seed, dim_ext, dim))
        nl, dev = params.n_lists, res.device
        empty = IvfBqIndex(
            centers=centers, rotation=rotation,
            codes=torch.zeros((nl, 0, params.bits * dim_ext // 32),
                              dtype=torch.int32, device=dev),
            rnorm=torch.zeros((nl, 0), device=dev),
            cfac=torch.zeros((nl, 0, params.bits), device=dev),
            errw=torch.zeros((nl, 0), device=dev),
            indices=torch.full((nl, 0), -1, dtype=torch.int32, device=dev),
            list_sizes=torch.zeros((nl,), dtype=torch.int32, device=dev),
            metric=DistanceType(params.metric),
            data=(torch.zeros((nl, 0, dim), device=dev)
                  if params.store_vectors else None),
            data_norms=(torch.zeros((nl, 0), device=dev)
                        if params.store_vectors else None),
        )
        if not params.add_data_on_build:
            return empty
        return extend(res, empty, dataset,
                      torch.arange(n, dtype=torch.int32, device=dev))


def extend(res: Optional[Resources], index: IvfBqIndex, new_vectors,
           new_indices=None) -> IvfBqIndex:
    """Encode and add vectors: a functional rebuild of the padded lists,
    as in the JAX package."""
    res = ensure_resources(res)
    new_vectors = res.put(new_vectors)
    expect(new_vectors.ndim == 2 and new_vectors.shape[1] == index.dim,
           "new_vectors must be (n, dim)")
    n_new = new_vectors.shape[0]
    if new_indices is None:
        start = index.size
        new_indices = torch.arange(start, start + n_new, dtype=torch.int32,
                                   device=res.device)
    else:
        new_indices = res.put(new_indices, torch.int32)

    with tracing.range("raft_tpu.ivf_bq.extend"):
        km = KMeansBalancedParams(metric=_kmeans_metric(index.metric))
        newf = new_vectors.to(torch.float32)
        labels = kmeans_balanced.predict(res, km, index.centers, newf)
        resid = newf - index.centers[labels.to(torch.int64)]
        rot = resid @ index.rotation.T                      # (n, dim_ext)
        codes, rnorm, cfac, errw = _encode(rot, index.bits)
        with_vectors = index.data is not None

        if index.max_list_size > 0:
            keep = index.indices.reshape(-1) >= 0
            old_labels = torch.arange(
                index.n_lists, dtype=torch.int32, device=res.device
            ).repeat_interleave(index.max_list_size)
            nw = index.codes.shape[2]
            all_codes = torch.cat([index.codes.reshape(-1, nw)[keep], codes])
            all_rn = torch.cat([index.rnorm.reshape(-1)[keep], rnorm])
            all_cf = torch.cat([index.cfac.reshape(-1, index.bits)[keep],
                                cfac])
            all_ew = torch.cat([index.errw.reshape(-1)[keep], errw])
            all_ids = torch.cat([index.indices.reshape(-1)[keep],
                                 new_indices])
            all_labels = torch.cat([old_labels[keep], labels])
            all_vecs = None
            if with_vectors:
                all_vecs = torch.cat(
                    [index.data.reshape(-1, index.dim)[keep], newf])
        else:
            all_codes, all_rn, all_cf, all_ew = codes, rnorm, cfac, errw
            all_ids, all_labels = new_indices, labels
            all_vecs = newf if with_vectors else None

        sizes = torch.bincount(all_labels.to(torch.int64),
                               minlength=index.n_lists).to(torch.int32)
        max_size = padded_extent(sizes)     # one host sync per extend
        packed, sizes = _pack_lists(all_codes, all_rn, all_cf, all_ew,
                                    all_ids, all_labels, index.n_lists,
                                    max_size, vectors=all_vecs, sizes=sizes)
        c, rn, cf, ew, ids = packed[:5]
        data = packed[5] if with_vectors else None
        return dataclasses.replace(
            index, codes=c, rnorm=rn, cfac=cf, errw=ew, indices=ids,
            list_sizes=sizes, data=data,
            data_norms=_slot_norms(data, ids) if with_vectors else None)


def build_streaming(res: Optional[Resources], params: IvfBqIndexParams,
                    source, chunk_rows: int = 1 << 20,
                    train_rows: int = 1 << 18) -> IvfBqIndex:
    """Streamed BQ build over a :class:`raft_tpu_torch.io.BinDataset` —
    ``ivf_bq.py:361`` of the JAX package (the passes of the flat/PQ
    streaming builds: train sample -> centers and rotation by
    :func:`build` on it, labels + sizes, then encode + scatter into the
    padded planes in place, ``index_put_``). With ``store_vectors=False``
    only the sign codes and per-vector scalars live on the device
    (searches are then estimate-only); by default the raw rows stream
    into the rerank plane too. Each chunk is a cancellation point."""
    from raft_tpu_torch.core import memwatch
    from raft_tpu_torch.neighbors._streaming import (
        label_pass,
        sample_trainset,
        scatter_pass,
    )

    res = ensure_resources(res)
    n, dim = source.n_rows, source.dim
    expect(params.n_lists <= n, "n_lists > n_rows")
    with tracing.range("raft_tpu.ivf_bq.build_streaming"):
        train_rows = max(params.n_lists * 2, min(train_rows, n))
        trainset = sample_trainset(source, train_rows, chunk_rows)
        empty = build(res, dataclasses.replace(params,
                                               add_data_on_build=False),
                      trainset)
        km = KMeansBalancedParams(metric=_kmeans_metric(params.metric))
        labels_np, sizes_np = label_pass(res, km, empty.centers, source,
                                         chunk_rows, params.n_lists)
        max_size = padded_extent(sizes_np)
        dim_ext, bits, nl = empty.dim_ext, params.bits, params.n_lists
        # one slot: packed words, the three correction scalars and the id
        # (+ the raw vector and its norm when the rerank plane streams)
        slot = (bits * dim_ext // 32) * 4 + 4 + bits * 4 + 4 + 4
        if params.store_vectors:
            slot += dim * 4 + 4
        memwatch.admit(nl * int(max_size) * slot, "ivf_bq.build_streaming")
        dev = res.device
        codes = torch.zeros((nl, max_size, bits * dim_ext // 32),
                            dtype=torch.int32, device=dev)
        rnorm = torch.zeros((nl, max_size), device=dev)
        cfac = torch.zeros((nl, max_size, bits), device=dev)
        errw = torch.zeros((nl, max_size), device=dev)
        indices = torch.full((nl, max_size), -1, dtype=torch.int32,
                             device=dev)
        data = (torch.zeros((nl, max_size, dim), device=dev)
                if params.store_vectors else None)

        def scatter(rows, lists, ranks, ids):
            rot = (rows - empty.centers[lists]) @ empty.rotation.T
            c, rn, cf, ew = _encode(rot, bits)
            slots = (lists, ranks)
            codes.index_put_(slots, c)
            rnorm.index_put_(slots, rn)
            cfac.index_put_(slots, cf)
            errw.index_put_(slots, ew)
            indices.index_put_(slots, ids)
            if data is not None:
                data.index_put_(slots, rows)

        scatter_pass(res, source, labels_np, chunk_rows, nl, scatter)
        return dataclasses.replace(
            empty, codes=codes, rnorm=rnorm, cfac=cfac, errw=errw,
            indices=indices, list_sizes=res.put(sizes_np, torch.int32),
            data=data,
            data_norms=(None if data is None
                        else _slot_norms(data, indices)))


# ---------------------------------------------------------------------------
# estimator statistics and bound-derived over-fetch budgets
# ---------------------------------------------------------------------------


def estimator_stats(index: IvfBqIndex) -> dict:
    """Measured estimator-error statistics of the index: ``mean_errw``,
    ``mean_rnorm2`` and ``rel_err = 2·mean_errw / (√D·√mean_rnorm2)``,
    the per-candidate distance-error std over the distance scale."""
    valid = (index.indices >= 0).to(torch.float32)
    cnt = torch.clamp(valid.sum(), min=1.0)
    mean_e = float((index.errw * valid).sum() / cnt)
    mean_rn2 = float((torch.square(index.rnorm) * valid).sum() / cnt)
    rel = (2.0 * mean_e / (math.sqrt(index.dim_ext)
                           * math.sqrt(max(mean_rn2, 1e-20)))
           if mean_rn2 > 0 else 0.0)
    return {"mean_errw": mean_e, "mean_rnorm2": mean_rn2,
            "rel_err": rel, "dim_ext": index.dim_ext}


def overfetch_budget(index: IvfBqIndex, k: int, *, confidence: float = 1.0,
                     query_bits: int = 4) -> int:
    """Candidate budget for the estimate-only path so that the true top-k
    survive the exact rerank: ``ceil(k·(1 + confidence·κ_eff·ρ))`` with
    ``ρ`` the measured relative error and ``κ_eff = κ·(2^(4-query_bits)
    + 1)/2``. An index with the rerank plane needs none: the budget is
    ``k``."""
    expect(k >= 1, "k must be >= 1")
    expect(1 <= query_bits <= 8,
           f"query_bits must be 1..8, got {query_bits}")
    if index.data is not None:
        return k
    stats = estimator_stats(index)
    kappa_eff = _OVERFETCH_KAPPA * (2.0 ** (4 - query_bits) + 1.0) / 2.0
    budget = math.ceil(k * (1.0 + confidence * kappa_eff * stats["rel_err"]))
    return max(k, min(budget, index.size))


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


def score_probe(lists, qrot, centers_rot, ip, cn, qnorm, codes, rnorm, cfac,
                indices, ip_metric: bool, pad_val, valid=None):
    """The per-probe step of the rank-major estimate-only scan: gather one
    probed list per query, unpack its sign words, one batched product for
    the cross term, and the estimator. The query side crosses in
    bfloat16, as in the JAX package (the ±1 codes are exact). Rows that
    are padding (or not ``valid``) score ``pad_val``. Returns ``(dist
    (q, m), row_ids)``."""
    q = qrot.shape[0]
    qidx = torch.arange(q, device=qrot.device)
    li = lists.to(torch.int64)
    cf = cfac[li]                                  # (q, m, bits)
    rn = rnorm[li]                                 # (q, m)
    bits = cf.shape[-1]
    a = rn[..., None] * cf
    pm1 = _unpack_pm1(codes[li], torch.float32)    # (q, m, bits·D)
    m = pm1.shape[1]
    pm1 = pm1.reshape(q, m, bits, -1)
    row_ids = indices[li]
    if ip_metric:
        qb = qrot.to(torch.bfloat16).to(torch.float32)
        crosses = torch.einsum("qd,qmld->qml", qb, pm1)
        dist = ip[qidx, li][:, None] + (a * crosses).sum(dim=-1)
    else:
        qsub = (qrot - centers_rot[li]).to(torch.bfloat16).to(torch.float32)
        crosses = torch.einsum("qd,qmld->qml", qsub, pm1)
        qc2 = qnorm + cn[li] - 2.0 * ip[qidx, li]
        dist = (torch.clamp(qc2, min=0.0)[:, None]
                - 2.0 * (a * crosses).sum(dim=-1) + torch.square(rn))
    ok = row_ids >= 0
    if valid is not None:
        ok = ok & valid[:, None]
    return torch.where(ok, dist, torch.full_like(dist, pad_val)), row_ids


def coarse_probes(index: IvfBqIndex, qf: torch.Tensor, n_probes: int,
                  coarse_algo: str = "exact"):
    """The coarse step of :func:`search`: the (q, n_probes) int32 lists
    each float32 query probes, with the (q, n_lists) query-center inner
    products and the centers' squared norms (None for IP) it scored
    them by."""
    return _coarse(index.centers, index.metric, qf, n_probes, coarse_algo)


def _coarse(centers, metric: DistanceType, qf, n_probes: int,
            coarse_algo: str):
    ip = qf @ centers.T
    if metric == DistanceType.InnerProduct:
        return coarse_select(ip, n_probes, coarse_algo), ip, None
    c_norms = torch.square(centers).sum(dim=1)
    probes = coarse_select(-(c_norms[None, :] - 2.0 * ip), n_probes,
                           coarse_algo)
    return probes, ip, c_norms


def _search_arrays(queries, centers, rotation, codes, rnorm, cfac, errw,
                   indices, data, data_norms, filter_words, *,
                   metric: DistanceType, n_probes: int, k: int,
                   coarse_algo: str, scan_engine: str, epsilon: float,
                   query_bits: int, row_probes=None, cold_planes=None,
                   hot_slot_map=None, cold_slot_map=None):
    """Coarse select, then the fused estimate-then-rerank scan (``cuda``
    or ``torch``: exact distances) or the rank-major estimate-only scan
    (``rank``), over the index's arrays. ``row_probes`` (the ragged
    front) masks each row's probe slots past its own budget to the
    sentinel id, which the fused engines skip. ``cold_planes`` (a tiered
    index) holds the cold halves of the five record planes, whose hot
    halves are then ``codes``/``rnorm``/``cfac``/``errw``/``data``, and
    each probed list reads all five from its tier (the plain fused engine
    only). Returns ``(best_d, best_i, survivors, probes)``: survivors is
    the fused scan's (q,) count of reranked rows, None for ``rank``."""
    expect(cold_planes is None or scan_engine == "torch",
           "tiered BQ record planes need the plain fused engine, got "
           f"{scan_engine!r}")
    q = queries.shape[0]
    select_min = is_min_close(metric)
    ip_metric = metric == DistanceType.InnerProduct
    qf = queries.to(torch.float32)
    probes, ip, c_norms = _coarse(centers, metric, qf, n_probes,
                                  coarse_algo)
    if row_probes is not None:
        probes = ragged_probes(probes, row_probes, centers.shape[0])
    qnorm = None if ip_metric else torch.square(qf).sum(dim=1)
    pad_val = float("inf") if select_min else float("-inf")
    # probe-invariant: q~ = R(q - c) = Rq - Rc needs a rotated-centers table
    qrot = qf @ rotation.T
    centers_rot = centers @ rotation.T

    survivors = None
    if scan_engine != "rank":
        qb = query_bits if query_bits else auto_query_bits(cfac.shape[2])
        best_d, best_i, survivors = bq_list_major_scan(
            qf, qrot, centers_rot, codes, rnorm, cfac, errw, indices, data,
            data_norms, probes, filter_words, cold_planes, hot_slot_map,
            cold_slot_map, k=k, metric=metric, epsilon=epsilon,
            engine=scan_engine, query_bits=qb)
    else:
        best_d = qf.new_full((q, k), pad_val)
        best_i = torch.full((q, k), -1, dtype=torch.int32, device=qf.device)
        for rank in range(n_probes):
            dist, row_ids = score_probe(
                probes[:, rank], qrot, None if ip_metric else centers_rot,
                ip, c_norms, qnorm, codes, rnorm, cfac, indices, ip_metric,
                pad_val)
            if filter_words is not None:
                ok = test_filter(filter_words, row_ids) & (row_ids >= 0)
                dist = torch.where(ok, dist, torch.full_like(dist, pad_val))
            best_d, best_i = merge_topk(best_d, best_i, dist, row_ids, k,
                                        select_min)
    if metric == DistanceType.L2SqrtExpanded:
        best_d = torch.where(torch.isfinite(best_d),
                             torch.sqrt(torch.clamp(best_d, min=0.0)), best_d)
    return best_d, best_i, survivors, probes


def _search_impl_fn(queries, centers, rotation, codes, rnorm, cfac, errw,
                    indices, data, data_norms, filter_words,
                    probe_counts=None, n_valid=None, row_probes=None,
                    cold_planes=None, hot_slot_map=None, cold_slot_map=None,
                    *, n_probes: int, k: int, metric: DistanceType,
                    coarse_algo: str = "exact", scan_engine: str = "rank",
                    epsilon: float = 3.0, query_bits: int = 0):
    """The serving body: :func:`_search_arrays` in the order
    :func:`serving_plan` passes the arrays, returning ``(distances,
    indices)``. With ``probe_counts``, an (n_lists,) int32 probe plane,
    the batch's selected lists are added to it (rows at and past
    ``n_valid`` left out) and the new plane is a third output.
    ``row_probes`` is the ragged front's per-row probe budget (see
    :func:`_search_ragged_fn`); masked slots count nothing, so
    ``n_valid`` is not needed with it. The CUDA and ``rank`` engines
    have no host sync on a CUDA index, so the executor captures the body
    in a CUDA graph. ``cold_planes`` / ``hot_slot_map`` /
    ``cold_slot_map`` are the tiered family's split record planes
    (:func:`_search_arrays`)."""
    best_d, best_i, _, probes = _search_arrays(
        queries, centers, rotation, codes, rnorm, cfac, errw, indices, data,
        data_norms, filter_words, metric=metric, n_probes=n_probes, k=k,
        coarse_algo=coarse_algo, scan_engine=scan_engine, epsilon=epsilon,
        query_bits=query_bits, row_probes=row_probes,
        cold_planes=cold_planes, hot_slot_map=hot_slot_map,
        cold_slot_map=cold_slot_map)
    if probe_counts is not None:
        if row_probes is not None:
            n_valid = None
        return best_d, best_i, probe_histogram(probes, probe_counts, n_valid)
    return best_d, best_i


def _search_ragged_fn(queries, row_probes, centers, rotation, codes, rnorm,
                      cfac, errw, indices, data, data_norms, filter_words,
                      probe_counts=None, n_valid=None, *, n_probes: int,
                      k: int, metric: DistanceType, scan_engine: str = "torch",
                      epsilon: float = 3.0, query_bits: int = 0):
    """The ragged IVF-BQ serving body (the packing contract of
    :func:`raft_tpu_torch.neighbors.ivf_flat._search_ragged_fn`):
    ``n_probes``/``k`` are the params class's caps, ``row_probes`` each
    packed row's budget, which reaches the fused engines' membership
    test as sentinel slots. The margin prune compares a row's estimates
    with its own running k-th exact distance, so a row's result does not
    depend on the rows beside it. It compares at the class cap's k,
    though: where every margin holds, both runs return the exact top-k_j
    of the probed rows, but a row a solo ``k_j`` run pruned on a failed
    margin may survive at the cap (``chip_smoke.py`` counts such rows).
    Fused engines only: the rank-major estimate scan has no membership
    mask (a codes-only index resolves to it and stays bucketed)."""
    del n_valid
    expect(scan_engine in ("cuda", "torch"),
           "ragged IVF-BQ serving needs a fused engine, got "
           f"{scan_engine!r}")
    return _search_impl_fn(
        queries, centers, rotation, codes, rnorm, cfac, errw, indices, data,
        data_norms, filter_words, probe_counts, None, row_probes,
        n_probes=n_probes, k=k, metric=metric, coarse_algo="exact",
        scan_engine=scan_engine, epsilon=epsilon, query_bits=query_bits)


def serving_plan(params: IvfBqSearchParams, index: IvfBqIndex, k: int,
                 filter_words=None) -> Tuple[Callable, tuple, dict]:
    """``(fn, arrays, static)``: the body a query block runs, called as
    ``fn(queries, *arrays, filter_words, **static)``, with ``n_probes``
    clamped to the index and the scan engine and query bits resolved."""
    expect(index.max_list_size > 0, "index is empty — extend() it first")
    expect(params.coarse_algo in ("exact", "approx"),
           f"coarse_algo must be 'exact' or 'approx', got "
           f"{params.coarse_algo!r}")
    expect(params.query_bits == 0 or 1 <= params.query_bits <= 8,
           f"query_bits must be 0 (auto) or 1..8, got {params.query_bits}")
    engine = resolve_bq_engine(params.scan_engine, data=index.data,
                               filter_words=filter_words, k=k)
    static = {"n_probes": min(params.n_probes, index.n_lists), "k": k,
              "metric": index.metric, "coarse_algo": params.coarse_algo,
              "scan_engine": engine, "epsilon": params.epsilon,
              "query_bits": params.query_bits or auto_query_bits(index.bits)}
    arrays = (index.centers, index.rotation, index.codes, index.rnorm,
              index.cfac, index.errw, index.indices, index.data,
              index.data_norms)
    return _search_impl_fn, arrays, static


def search(res: Optional[Resources], params: IvfBqSearchParams,
           index: IvfBqIndex, queries, k: int, sample_filter=None,
           query_tile: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """ANN search over RaBitQ codes. With the fused engines (the default
    on an index with the rerank plane) the distances are **exact**; on a
    codes-only index (or ``scan_engine="rank"``) they are unbiased
    estimates: over-fetch by :func:`overfetch_budget` and refine."""
    res = ensure_resources(res)
    queries = res.put(queries)
    expect(queries.ndim == 2 and queries.shape[1] == index.dim,
           "queries must be (q, dim)")
    filter_words = resolve_filter_words(sample_filter)
    if filter_words is not None:
        filter_words = filter_words.to(res.device)
    fn, arrays, static = serving_plan(params, index, k, filter_words)
    with tracing.range("raft_tpu.ivf_bq.search"):
        return tile_queries(lambda qt, fw: fn(qt, *arrays, fw, **static),
                            queries, filter_words, query_tile)


# ---------------------------------------------------------------------------
# serialization (versioned npy stream, the JAX package's v3 layout)
# ---------------------------------------------------------------------------


def save(index: IvfBqIndex, fh_or_path) -> None:
    fh, own = open_maybe_path(fh_or_path, "wb")
    try:
        serialize_scalar(fh, _SERIALIZATION_VERSION, np.int32)
        serialize_scalar(fh, int(index.metric), np.int32)
        serialize_scalar(fh, index.bits, np.int32)
        serialize_scalar(fh, int(index.data is not None), np.int32)
        for arr in (index.centers, index.rotation, index.codes, index.rnorm,
                    index.cfac, index.errw, index.indices, index.list_sizes):
            serialize_array(fh, arr)
        if index.data is not None:
            serialize_array(fh, index.data)
    finally:
        if own:
            fh.close()


def load(res: Optional[Resources], fh_or_path) -> IvfBqIndex:
    fh, own = open_maybe_path(fh_or_path, "rb")
    try:
        check_version(deserialize_scalar(fh), _SERIALIZATION_VERSION,
                      "ivf_bq")
        metric = DistanceType(int(deserialize_scalar(fh)))
        int(deserialize_scalar(fh))   # bits: recorded, shape-derivable
        has_data = bool(deserialize_scalar(fh))
        arrays = [deserialize_array(fh) for _ in range(8)]
        data = deserialize_array(fh) if has_data else None
    finally:
        if own:
            fh.close()
    return from_numpy(*arrays, metric=metric, data=data, res=res)
