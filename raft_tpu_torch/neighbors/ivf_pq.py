"""IVF-PQ — inverted file with product quantization; port of
``raft_tpu/neighbors/ivf_pq.py`` (``raft::neighbors::ivf_pq``).

Build: balanced k-means coarse centers; residuals rotated by
:func:`make_rotation_matrix` (the identity where ``pq_dim`` divides the
dimension, unless a random rotation is forced); product codebooks
trained per subspace or per cluster by a batched fixed-iteration Lloyd
(:func:`_vmapped_lloyd`); codes in one padded ``(n_lists,
max_list_size, pq_dim)`` uint8 tensor, nibble-packed two a byte at 4
bits. The random draws (rotation, initial codewords) come from
generators seeded with the handle's seed (streams 7 and 11, as the JAX
package folds them into its key): two builds from one seed on one device
are equal; the two packages draw different numbers, so their builds
agree in quality, not bit for bit.

Search: coarse top-``n_probes``, then one of the engines of
:func:`resolve_scan_engine`:

- ``cuda``: the LUT scan kernel of :mod:`raft_tpu_torch.ops.ivf_pq_scan`
  (``auto`` on a CUDA index);
- ``torch``: its plain version, the twin of the JAX package's ``xla``
  list-major engine;
- ``rank``: the twin of the JAX ``rank`` engine: one gathered list per
  query and probe rank, merged by ``merge_topk`` (``auto`` on the CPU).

``lut_dtype`` takes ``torch.float32``, ``torch.bfloat16``,
``torch.float8_e4m3fn`` or ``torch.float8_e5m2`` (:func:`quantize_lut`).
The JAX package's per-probe LUT build ``_probe_lut`` is
:func:`raft_tpu_torch.ops.ivf_pq_scan.probe_lut`, shared by every engine.
The executor and :func:`search` both run :func:`_search_impl_fn` as
:func:`serving_plan` sets it up; the executor's ragged plans run
:func:`_search_ragged_fn`. The same body serves the tiered family
(:mod:`raft_tpu_torch.neighbors.tiered`, ``TieredIvfPq``) with its codes
split between a hot plane and pinned host memory.
:func:`build_streaming` builds from a dataset file chunk by chunk.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.cluster.kmeans_balanced import (
    KMeansBalancedParams,
    segment_sum,
)
from raft_tpu_torch.core import memwatch, tracing
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
from raft_tpu_torch.neighbors._batching import tile_queries
from raft_tpu_torch.neighbors._packing import (
    pack_padded_lists,
    padded_extent,
    streaming_ranks,
)
from raft_tpu_torch.neighbors.ann_types import IndexParams, SearchParams
from raft_tpu_torch.neighbors.filters import resolve_filter_words, test_filter
from raft_tpu_torch.neighbors.ivf_bq import _coarse
from raft_tpu_torch.neighbors.ivf_flat import _kmeans_metric
from raft_tpu_torch.ops.bq_scan import tree_sum
from raft_tpu_torch.ops.ivf_pq_scan import (
    CUDA_MAX_K,
    LUT_DTYPES,
    _score_gather,
    codebook_norms,
    ivf_pq_scan,
    probe_lut,
    quantize_lut,
    scale_and_base,
    unpack_codes,
)
from raft_tpu_torch.ops.ivf_scan import probe_histogram, ragged_probes

_SERIALIZATION_VERSION = 4  # v4: adds the 4-bit nibble-packed codes flag

#: ivf_pq ``scan_engine`` values
SCAN_ENGINES = ("auto", "rank", "torch", "cuda")

# generator streams of the build's draws (the JAX package's fold_in ids)
_ROTATION_STREAM = 7
_CODEBOOK_STREAM = 11

# Lloyd iterations of the codebook training (the JAX package's)
_CODEBOOK_ITERS = 25

# floats of one distance plane the trainers and the encoder hold at once
_PLANE_ELEMS = 1 << 28


class CodebookKind(enum.IntEnum):
    """Mirrors ``ivf_pq::codebook_gen``."""

    PER_SUBSPACE = 0
    PER_CLUSTER = 1


@dataclasses.dataclass(frozen=True)
class IvfPqIndexParams(IndexParams):
    """The JAX package's ``IvfPqIndexParams``."""

    n_lists: int = 1024
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    pq_bits: int = 8              # 4..8
    pq_dim: int = 0               # 0 -> auto: dim/4 rounded to a multiple of 8
    codebook_kind: CodebookKind = CodebookKind.PER_SUBSPACE
    force_random_rotation: bool = False


@dataclasses.dataclass(frozen=True)
class IvfPqSearchParams(SearchParams):
    """The JAX package's ``IvfPqSearchParams``. ``scan_engine``: ``auto``
    is the CUDA kernel for an index on a CUDA device and ``rank`` on the
    CPU; ``cuda`` / ``torch`` / ``rank`` force one (see
    :func:`resolve_scan_engine`). ``score_mode``: ``gather`` (``auto``)
    is the kernel's formulation; ``onehot`` and ``select`` are plain
    formulations for the ``torch`` and ``rank`` engines.
    ``coarse_algo="approx"`` runs the exact selection."""

    n_probes: int = 20
    coarse_algo: str = "exact"
    scan_engine: str = "auto"
    lut_dtype: torch.dtype = torch.float32
    score_mode: str = "auto"


@dataclasses.dataclass(frozen=True)
class IvfPqIndex:
    """PQ-compressed IVF index (role of ``ivf_pq::index``)."""

    centers: torch.Tensor      # (n_lists, dim) f32
    rotation: torch.Tensor     # (dim_ext, dim) f32
    codebooks: torch.Tensor    # PER_SUBSPACE (pq_dim, 2^bits, pq_len);
                               # PER_CLUSTER (n_lists, 2^bits, pq_len)
    codes: torch.Tensor        # (n_lists, max_list_size, pq_dim) uint8, or
                               # (..., pq_dim // 2) nibble-packed
    indices: torch.Tensor      # (n_lists, max_list_size) i32, -1 pad
    list_sizes: torch.Tensor   # (n_lists,) i32
    metric: DistanceType
    codebook_kind: CodebookKind
    pq_bits: int
    packed: bool = False       # two 4-bit codes a byte

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
    def pq_dim(self) -> int:
        return self.codes.shape[2] * 2 if self.packed else self.codes.shape[2]

    @property
    def pq_len(self) -> int:
        return self.codebooks.shape[2]

    @property
    def pq_book_size(self) -> int:
        return 1 << self.pq_bits

    @property
    def max_list_size(self) -> int:
        return self.codes.shape[1]

    @property
    def size(self) -> int:
        return int(self.list_sizes.sum())


def from_numpy(centers, rotation, codebooks, codes, indices, list_sizes,
               metric: DistanceType = DistanceType.L2Expanded,
               codebook_kind: CodebookKind = CodebookKind.PER_SUBSPACE,
               pq_bits: int = 8, packed: bool = False,
               res: Optional[Resources] = None) -> IvfPqIndex:
    """An index from host arrays (e.g. the JAX index's), placed on the
    handle's device."""
    res = ensure_resources(res)
    return IvfPqIndex(
        centers=res.put(centers, torch.float32),
        rotation=res.put(rotation, torch.float32),
        codebooks=res.put(codebooks, torch.float32),
        codes=res.put(codes, torch.uint8),
        indices=res.put(indices, torch.int32),
        list_sizes=res.put(list_sizes, torch.int32),
        metric=DistanceType(int(metric)),
        codebook_kind=CodebookKind(int(codebook_kind)),
        pq_bits=int(pq_bits), packed=bool(packed))


# ---------------------------------------------------------------------------
# build helpers
# ---------------------------------------------------------------------------


def _auto_pq_dim(dim: int) -> int:
    """Reference heuristic: dim/4 rounded up to a multiple of 8."""
    pq = max(1, dim // 4)
    return max(8, -(-pq // 8) * 8) if dim >= 32 else max(1, pq)


def _generator(res: Resources, stream: int) -> torch.Generator:
    gen = torch.Generator(device=res.device)
    gen.manual_seed(res.seed * 1000 + stream)
    return gen


def make_rotation_matrix(gen: torch.Generator, dim_ext: int, dim: int,
                         force_random: bool,
                         device=None) -> torch.Tensor:
    """Orthogonal projection dim -> dim_ext, (dim_ext, dim) float32: the
    identity when the dimensions agree and randomness is not forced,
    otherwise the QR of a Gaussian draw from ``gen``."""
    device = gen.device if device is None else device
    if not force_random and dim_ext == dim:
        return torch.eye(dim, dtype=torch.float32, device=device)
    g = torch.randn((dim_ext, max(dim_ext, dim)), generator=gen,
                    device=device, dtype=torch.float32)
    qmat, _ = torch.linalg.qr(g.T)       # (max, dim_ext) orthonormal columns
    return qmat[:dim, :].T.contiguous()  # (dim_ext, dim)


def _vmapped_lloyd(trainsets: torch.Tensor, gen: torch.Generator,
                   n_centers: int, n_iters: int) -> torch.Tensor:
    """Fixed-iteration Lloyd EM over the leading axis: (B, n, L)
    trainsets -> (B, n_centers, L) codebooks (role of
    ``train_per_subset``/``train_per_cluster``). Initial codewords are
    drawn rows (without replacement when there are enough); each step
    labels rows by ``‖c‖² - 2 x·c`` (first center on ties), sums them by
    :func:`segment_sum` (a fixed order) and keeps a center with no rows.
    The batch is cut so that one distance plane stays bounded."""
    B, n, L = trainsets.shape
    dev = trainsets.device
    if n >= n_centers:
        idx = torch.argsort(torch.rand((B, n), generator=gen, device=dev),
                            dim=1)[:, :n_centers]
    else:
        idx = torch.randint(0, n, (B, n_centers), generator=gen, device=dev)
    centers = torch.gather(trainsets, 1, idx[..., None].expand(-1, -1, L))
    step = max(1, _PLANE_ELEMS // max(1, n * n_centers))
    out = []
    for b0 in range(0, B, step):
        x = trainsets[b0:b0 + step]
        c = centers[b0:b0 + step]
        nb = x.shape[0]
        off = (torch.arange(nb, device=dev) * n_centers)[:, None]
        for _ in range(n_iters):
            d = ((c * c).sum(dim=2)[:, None, :]
                 - 2.0 * torch.bmm(x, c.transpose(1, 2)))
            flat = (torch.argmin(d, dim=2) + off).reshape(-1)
            sums = segment_sum(x.reshape(-1, L), flat, nb * n_centers)
            counts = torch.bincount(flat, minlength=nb * n_centers).to(
                torch.float32)
            new = sums / torch.clamp(counts, min=1.0)[:, None]
            c = torch.where((counts > 0)[:, None], new,
                            c.reshape(-1, L)).reshape(nb, n_centers, L)
        out.append(c)
    return torch.cat(out)


def _rotate_residuals(vectors, labels, centers, rotation):
    """R (x - c_label), (n, dim_ext) float32."""
    res = vectors.to(torch.float32) - centers[labels.to(torch.int64)]
    return res @ rotation.T


def _encode(rot_residuals, codebooks, labels, codebook_kind: CodebookKind,
            pq_dim: int, pq_len: int) -> torch.Tensor:
    """Nearest codeword of every subspace, (n, pq_dim) uint8 (role of
    ``process_and_fill_codes_kernel``): a loop over subspaces, so the
    score plane is (rows, 2^bits) a step and never (n, pq_dim, 2^bits);
    rows are cut into chunks that bound it. Scores are ``‖cb‖² - 2 v·cb``
    (``‖v‖²`` moves no argmin); ties go to the first codeword."""
    n = rot_residuals.shape[0]
    J = codebooks.shape[1]
    out = torch.empty((n, pq_dim), dtype=torch.uint8,
                      device=rot_residuals.device)
    chunk = max(1024, _PLANE_ELEMS // 4 // J)
    per_cluster = codebook_kind == CodebookKind.PER_CLUSTER
    if not per_cluster:
        cb_norms = torch.square(codebooks).sum(dim=-1)          # (S, J)
    for r0 in range(0, n, chunk):
        sub = rot_residuals[r0:r0 + chunk].reshape(-1, pq_dim, pq_len)
        if per_cluster:
            cb_rows = codebooks[labels[r0:r0 + chunk].to(torch.int64)]
            cbn = torch.square(cb_rows).sum(dim=-1)             # (c, J)
        for s in range(pq_dim):
            v = sub[:, s]                                       # (c, L)
            if per_cluster:
                scores = cbn - 2.0 * torch.bmm(cb_rows, v[:, :, None])[..., 0]
            else:
                cb = codebooks[s]
                scores = cb_norms[s][None, :] - 2.0 * (v @ cb.T)
            out[r0:r0 + chunk, s] = torch.argmin(scores, dim=1).to(
                torch.uint8)
    return out


def _pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """Two 4-bit codes a byte along the last axis, the even subspace in
    the low nibble."""
    return (codes[..., 0::2] | (codes[..., 1::2] << 4)).to(torch.uint8)


def _unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_pack_nibbles` -> (..., 2 * packed.shape[-1])."""
    return unpack_codes(packed, True)


def _pack_codes(codes, ids, labels, n_lists: int, max_list_size: int,
                sizes=None):
    """Scatter code rows into the padded [n_lists, max_list_size] layout
    (the shared sort-and-rank packing)."""
    (packed, indices), sizes = pack_padded_lists(
        labels, n_lists, max_list_size, [(codes, 0), (ids, -1)], sizes=sizes)
    return packed, indices, sizes


# ---------------------------------------------------------------------------
# build / extend
# ---------------------------------------------------------------------------


def build(res: Optional[Resources], params: IvfPqIndexParams,
          dataset) -> IvfPqIndex:
    """Train the coarse centers, rotation and codebooks, then encode the
    dataset — ``ivf_pq::build``."""
    res = ensure_resources(res)
    dataset = res.put(dataset)
    expect(dataset.ndim == 2, "dataset must be (n, d)")
    n, dim = dataset.shape
    expect(4 <= params.pq_bits <= 8, "pq_bits must be in [4, 8]")
    expect(params.n_lists <= n, "n_lists > n_rows")
    expect(params.metric in (DistanceType.L2Expanded,
                             DistanceType.L2SqrtExpanded,
                             DistanceType.InnerProduct),
           f"ivf_pq supports L2/L2Sqrt/InnerProduct, got {params.metric!r}")
    pq_dim = params.pq_dim if params.pq_dim > 0 else _auto_pq_dim(dim)
    pq_len = -(-dim // pq_dim)
    dim_ext = pq_dim * pq_len
    dev = res.device

    with tracing.range("raft_tpu.ivf_pq.build"):
        frac = min(max(params.kmeans_trainset_fraction, 0.0), 1.0)
        # the trainset must cover both the coarse clusters and the books
        n_train = max(params.n_lists * 2, 1 << params.pq_bits, int(n * frac))
        n_train = min(n, n_train)
        stride = max(1, n // n_train)
        trainset = dataset[::stride][:n_train].to(torch.float32)
        km = KMeansBalancedParams(n_iters=params.kmeans_n_iters,
                                  metric=_kmeans_metric(params.metric),
                                  seed=res.seed)
        centers = kmeans_balanced.fit(res, km, trainset, params.n_lists)
        rotation = make_rotation_matrix(
            _generator(res, _ROTATION_STREAM), dim_ext, dim,
            params.force_random_rotation or dim != dim_ext, device=dev)

        # codebooks from the rotated trainset residuals
        train_labels = kmeans_balanced.predict(res, km, centers, trainset)
        rot = _rotate_residuals(trainset, train_labels, centers, rotation)
        book = 1 << params.pq_bits
        gen = _generator(res, _CODEBOOK_STREAM)
        if params.codebook_kind == CodebookKind.PER_SUBSPACE:
            sub = rot.reshape(-1, pq_dim, pq_len).transpose(0, 1)
            codebooks = _vmapped_lloyd(sub.contiguous(), gen, book,
                                       _CODEBOOK_ITERS)
        else:
            # per cluster: the cluster's own subvectors (all subspaces
            # pooled); rows are taken modulo the cluster's segment length,
            # so no other cluster's residuals leak in
            per = max(book * 4 // pq_dim + 1, 64)
            order = torch.argsort(train_labels.to(torch.int64), stable=True)
            sorted_lab = train_labels.to(torch.int64)[order]
            firsts = torch.searchsorted(
                sorted_lab, torch.arange(params.n_lists, device=dev))
            ends = torch.cat([firsts[1:], firsts.new_tensor([n_train])])
            seg_len = torch.clamp(ends - firsts, min=1)
            take = firsts[:, None] + (torch.arange(per, device=dev)[None, :]
                                      % seg_len[:, None])
            rows = rot[order][take.clamp(max=n_train - 1)]
            pooled = rows.reshape(params.n_lists, per * pq_dim, pq_len)
            codebooks = _vmapped_lloyd(pooled, gen, book, _CODEBOOK_ITERS)

        empty = IvfPqIndex(
            centers=centers, rotation=rotation, codebooks=codebooks,
            codes=torch.zeros((params.n_lists, 0, pq_dim), dtype=torch.uint8,
                              device=dev),
            indices=torch.full((params.n_lists, 0), -1, dtype=torch.int32,
                               device=dev),
            list_sizes=torch.zeros((params.n_lists,), dtype=torch.int32,
                                   device=dev),
            metric=DistanceType(params.metric),
            codebook_kind=CodebookKind(params.codebook_kind),
            pq_bits=params.pq_bits)
        if not params.add_data_on_build:
            return empty
        return extend(res, empty, dataset,
                      torch.arange(n, dtype=torch.int32, device=dev))


def build_streaming(res: Optional[Resources], params: IvfPqIndexParams,
                    source, chunk_rows: int = 1 << 20,
                    train_rows: int = 1 << 18) -> IvfPqIndex:
    """Streamed PQ build over a :class:`raft_tpu_torch.io.BinDataset` —
    ``ivf_pq.py:405`` of the JAX package: the dataset never fully
    materializes host-side (role of the reference's managed-memory
    trainset spill, ``ivf_pq_build.cuh:1542-1554``).

    Passes: (1) a strided train sample -> centers, rotation and codebooks
    by :func:`build` on it; (2) per-chunk labels + list sizes; (3)
    per-chunk encode + scatter into the padded code planes, written in
    place (``index_put_``). Only the codes live on the device; they stay
    unpacked (one byte a code) at every ``pq_bits``, as in the JAX
    package. Each chunk is a cancellation point."""
    from raft_tpu_torch.neighbors._streaming import (
        label_pass,
        sample_trainset,
        scatter_pass,
    )

    res = ensure_resources(res)
    expect(params.codebook_kind == CodebookKind.PER_SUBSPACE,
           "build_streaming supports PER_SUBSPACE codebooks")
    n, dim = source.n_rows, source.dim
    expect(params.n_lists <= n, "n_lists > n_rows")
    pq_dim = params.pq_dim if params.pq_dim > 0 else _auto_pq_dim(dim)
    pq_len = -(-dim // pq_dim)
    with tracing.range("raft_tpu.ivf_pq.build_streaming"):
        train_rows = max(params.n_lists * 2, 1 << params.pq_bits,
                         min(train_rows, n))
        trainset = sample_trainset(source, train_rows, chunk_rows)
        empty = build(res, dataclasses.replace(params,
                                               add_data_on_build=False),
                      trainset)
        km = KMeansBalancedParams(metric=_kmeans_metric(params.metric))
        labels_np, sizes_np = label_pass(res, km, empty.centers, source,
                                         chunk_rows, params.n_lists)
        max_size = padded_extent(sizes_np)
        memwatch.admit(
            memwatch.packed_layout_bytes(params.n_lists, int(max_size),
                                         pq_dim, norms=False),
            "ivf_pq.build_streaming")
        dev = res.device
        codes = torch.zeros((params.n_lists, max_size, pq_dim),
                            dtype=torch.uint8, device=dev)
        indices = torch.full((params.n_lists, max_size), -1,
                             dtype=torch.int32, device=dev)

        def scatter(rows, lists, ranks, ids):
            rot = _rotate_residuals(rows, lists, empty.centers,
                                    empty.rotation)
            codes.index_put_((lists, ranks), _encode(
                rot, empty.codebooks, lists, CodebookKind.PER_SUBSPACE,
                pq_dim, pq_len))
            indices.index_put_((lists, ranks), ids)

        scatter_pass(res, source, labels_np, chunk_rows, params.n_lists,
                     scatter)
        return dataclasses.replace(
            empty, codes=codes, indices=indices,
            list_sizes=res.put(sizes_np, torch.int32), packed=False)


def extend(res: Optional[Resources], index: IvfPqIndex, new_vectors,
           new_indices=None, donate: bool = False) -> IvfPqIndex:
    """Encode and add vectors — ``ivf_pq::extend``. When the new rows fit
    the existing padding they are scattered in (O(new)); with
    ``donate=True`` that scatter writes the old index's tensors in place
    (the old index object must not be used afterwards). Otherwise every
    row is repacked. Both paths give the same slots."""
    res = ensure_resources(res)
    new_vectors = res.put(new_vectors)
    expect(new_vectors.ndim == 2 and new_vectors.shape[1] == index.dim,
           "new_vectors must be (n, dim)")
    n_new = new_vectors.shape[0]
    dev = res.device
    if new_indices is None:
        start = index.size
        new_indices = torch.arange(start, start + n_new, dtype=torch.int32,
                                   device=dev)
    else:
        new_indices = res.put(new_indices, torch.int32)

    with tracing.range("raft_tpu.ivf_pq.extend"):
        km = KMeansBalancedParams(metric=_kmeans_metric(index.metric))
        labels = kmeans_balanced.predict(res, km, index.centers,
                                         new_vectors.to(torch.float32))
        rot = _rotate_residuals(new_vectors, labels, index.centers,
                                index.rotation)
        new_codes = _encode(rot, index.codebooks, labels, index.codebook_kind,
                            index.pq_dim, index.pq_len)

        # incremental path: the new codes fit the existing padding; the
        # slots are those the full repack gives
        if index.max_list_size > 0:
            sizes_new = (index.list_sizes + torch.bincount(
                labels.to(torch.int64), minlength=index.n_lists)).to(
                    torch.int32)
            if padded_extent(sizes_new) <= index.max_list_size:
                lab_np = labels.cpu().numpy()
                fill = index.list_sizes.cpu().numpy().astype(np.int64)
                ranks = torch.from_numpy(
                    streaming_ranks(lab_np, fill, index.n_lists)).to(
                        device=dev, dtype=torch.int64)
                lists = labels.to(torch.int64)
                rows = _pack_nibbles(new_codes) if index.packed else new_codes
                codes, indices = ((index.codes, index.indices) if donate
                                  else (index.codes.clone(),
                                        index.indices.clone()))
                codes[lists, ranks] = rows
                indices[lists, ranks] = new_indices
                return dataclasses.replace(index, codes=codes,
                                           indices=indices,
                                           list_sizes=sizes_new)

        if index.max_list_size > 0:
            stored = (_unpack_nibbles(index.codes) if index.packed
                      else index.codes)
            old_codes = stored.reshape(-1, index.pq_dim)
            old_ids = index.indices.reshape(-1)
            old_labels = torch.arange(
                index.n_lists, dtype=torch.int32, device=dev
            ).repeat_interleave(index.max_list_size)
            keep = old_ids >= 0
            all_codes = torch.cat([old_codes[keep], new_codes])
            all_ids = torch.cat([old_ids[keep], new_indices])
            all_labels = torch.cat([old_labels[keep], labels])
        else:
            all_codes, all_ids, all_labels = new_codes, new_indices, labels

        sizes = torch.bincount(all_labels.to(torch.int64),
                               minlength=index.n_lists).to(torch.int32)
        max_size = padded_extent(sizes)       # one host sync per extend
        should_pack = index.pq_bits == 4 and index.pq_dim % 2 == 0
        # the opt-in capacity gate: the repack makes the unpacked planes,
        # and a packed index its half-width copy before they free, so the
        # peak is what must fit (no norms plane in the PQ layout)
        slot_width = index.pq_dim + (index.pq_dim // 2 if should_pack else 0)
        memwatch.admit(
            memwatch.packed_layout_bytes(index.n_lists, int(max_size),
                                         slot_width, norms=False),
            "ivf_pq.extend")
        codes, indices, sizes = _pack_codes(all_codes, all_ids, all_labels,
                                            index.n_lists, max_size,
                                            sizes=sizes)
        if should_pack:
            codes = _pack_nibbles(codes)
        return dataclasses.replace(index, codes=codes, indices=indices,
                                   list_sizes=sizes, packed=should_pack)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


def resolve_scan_engine(engine: str, index: Optional[IvfPqIndex] = None,
                        k: Optional[int] = None,
                        score_mode: str = "auto") -> str:
    """Resolve a ``scan_engine`` search param, before any launch.

    ``auto`` is ``cuda`` for an index on a CUDA device and ``rank`` on
    the CPU (the JAX package's ``auto`` is ``rank`` off the TPU).
    ``cuda`` on an index on the CPU raises; ``cuda`` (and so ``auto`` on
    a CUDA index) goes to the plain ``torch`` engine for ``k`` past
    :data:`CUDA_MAX_K` (512) and for nothing else: the kernel builds a
    LUT too large for shared memory in parts. The kernel computes the
    ``gather`` formulation: with
    ``score_mode`` ``onehot`` or ``select`` the ``cuda`` engine raises
    (ask for ``torch`` or ``rank``)."""
    expect(engine in SCAN_ENGINES,
           f"scan_engine must be one of {SCAN_ENGINES}, got {engine!r}")
    on_cuda = index is not None and index.codes.device.type == "cuda"
    if engine == "auto":
        engine = "cuda" if on_cuda else "rank"
    if engine != "cuda":
        return engine
    expect(index is None or on_cuda,
           "scan_engine='cuda' needs an index on a CUDA device")
    expect(resolve_score_mode(score_mode) == "gather",
           f"scan_engine='cuda' scores by gather; score_mode "
           f"{score_mode!r} is a plain formulation (use 'torch' or 'rank')")
    if k is not None and k > CUDA_MAX_K:
        return "torch"
    return engine


def resolve_score_mode(score_mode: str, book_size: int = 256) -> str:
    """``auto`` is ``gather`` (the per-element lookup, the GPU's
    shared-memory LUT pattern); ``onehot`` and ``select`` are the JAX
    package's gather-free formulations for the TPU."""
    del book_size
    expect(score_mode in ("auto", "gather", "onehot", "select"),
           f"score_mode must be auto|gather|onehot|select, got {score_mode!r}")
    return "gather" if score_mode == "auto" else score_mode


def score_fn(score_mode: str, book_size: int = 256):
    """The scoring function of a score_mode (incl. ``auto``)."""
    mode = resolve_score_mode(score_mode, book_size)
    return {"onehot": _score_onehot, "gather": _score_gather,
            "select": _score_select}[mode]


#: one-hot elements a block of :func:`_score_onehot` materializes (256 MiB
#: of float32)
_ONEHOT_BLOCK_ELEMS = 1 << 26


def _score_onehot(lut, rows):
    """``Σ_s Σ_j lut[q, s, j]·[rows[q, m, s] == j]`` as float32
    contractions: the one-hot operand is exact, and the LUT already holds
    its ``lut_dtype`` values (:func:`quantize_lut`). The one-hot operand is
    built for blocks of rows at a time (at most ``_ONEHOT_BLOCK_ELEMS``
    elements), so the formulation's memory stays bounded; each row's
    contraction is the same whatever the block."""
    q, m, S = rows.shape
    J = lut.shape[2]
    step = max(1, _ONEHOT_BLOCK_ELEMS // max(1, q * S * J))
    cols = torch.arange(J, device=rows.device)
    out = []
    for s0 in range(0, m, step):
        oh = (rows[:, s0:s0 + step, :, None].to(torch.int64) == cols)
        out.append(torch.einsum("qmsj,qsj->qm", oh.to(torch.float32), lut))
    return out[0] if len(out) == 1 else torch.cat(out, dim=1)


def _score_select(lut, rows):
    """A masked sum over codewords: ``acc[q, m, s] = Σ_j lut[q, s, j]·
    (rows[q, m, s] == j)``, then ``Σ_s``."""
    J = lut.shape[2]
    expect(J <= 32, "score_mode='select' unrolls J terms — use "
           f"onehot/gather for book_size {J} > 32")
    acc = torch.zeros(rows.shape, dtype=torch.float32, device=lut.device)
    for j in range(J):
        acc = acc + torch.where(rows == j, lut[:, :, j][:, None, :],
                                torch.zeros((), device=lut.device))
    return tree_sum(acc)


def _scan_rank(qres, base, probes, codebooks, cb_norms, codes, indices,
               filter_words, *, k: int, metric: DistanceType,
               per_cluster: bool, lut_dtype, packed: bool, score,
               valid=None):
    """The rank-major engine, the twin of the JAX ``rank`` engine: for each
    probe rank, every query's list gathered, scored and merged by
    ``merge_topk`` (stable: the running state first on ties). ``valid``
    ((q, p) bool, the mesh shard bodies' ownership mask) pads every row of
    a slot it clears."""
    q, p = probes.shape
    L = codebooks.shape[2]
    ip_metric = metric == DistanceType.InnerProduct
    select_min = is_min_close(metric)
    pad_val = float("inf") if select_min else float("-inf")
    n_lists = indices.shape[0]
    best_d = torch.full((q, k), pad_val, dtype=torch.float32,
                        device=codes.device)
    best_i = torch.full((q, k), -1, dtype=torch.int32, device=codes.device)
    for r in range(p):
        lists = probes[:, r].to(torch.int64).clamp(0, n_lists - 1)
        rows = unpack_codes(codes[lists], packed)          # (q, m, S)
        row_ids = indices[lists]                           # (q, m)
        qsub = (qres if ip_metric else qres[:, r]).reshape(q, -1, L)
        if per_cluster:
            cb = codebooks[lists]
            cbn = None if ip_metric else cb_norms[lists]
        else:
            cb, cbn = codebooks, cb_norms
        lut, scale = quantize_lut(
            probe_lut(qsub, cb, cbn, ip_metric, per_cluster), lut_dtype)
        dist = score(lut, rows)
        dist = scale_and_base(
            dist, None if scale is None else scale[:, None],
            base[:, r][:, None] if ip_metric else None)
        ok = row_ids >= 0
        if valid is not None:
            ok = ok & valid[:, r][:, None]
        if filter_words is not None:
            ok = ok & test_filter(filter_words, row_ids)
        dist = torch.where(ok, dist, torch.full_like(dist, pad_val))
        best_d, best_i = merge_topk(best_d, best_i, dist, row_ids, k,
                                    select_min)
    return best_d, best_i


def _search_impl_fn(queries, centers, rotation, codebooks, codes, indices,
                    filter_words, probe_counts=None, n_valid=None,
                    row_probes=None, cold_codes=None, hot_slot_map=None,
                    cold_slot_map=None, *, n_probes: int, k: int,
                    metric: DistanceType, codebook_kind: CodebookKind,
                    lut_dtype=torch.float32, score_mode: str = "gather",
                    packed: bool = False, coarse_algo: str = "exact",
                    scan_engine: str = "rank",
                    workspace_bytes: Optional[int] = None):
    """The ADC serving body: coarse select, the rotated residuals of every
    (query, probe slot) in one product (the rotated query for IP, with
    ``q·c`` of each slot from the coarse products), then the resolved
    engine. With ``probe_counts``, an (n_lists,) int32 probe plane, the
    batch's selected lists are added to it (rows at and past ``n_valid``
    left out) and the new plane is a third output. ``row_probes`` is the
    ragged front's per-row budget (:func:`_search_ragged_fn`): slots past
    it become the sentinel id, which the list-major engines skip. The
    ``cuda`` engine has no host sync, so the executor captures the body
    in a CUDA graph.

    ``cold_codes`` / ``hot_slot_map`` / ``cold_slot_map`` (the tiered
    family, :class:`~raft_tpu_torch.neighbors.tiered.TieredIvfPq`) split
    the codes plane: ``codes`` is then the hot plane (n_hot, m, .) and each
    probed list's codes come from its tier, in the plain engine and in the
    kernel (staged through a ring of ``workspace_bytes``; one host sync,
    so the executor runs the tiered body eagerly). Everything else is this
    body, so the results equal the all-device index's bit for bit. The
    rank-major engine has no per-list fetch step and raises."""
    tiered = cold_codes is not None
    expect(not tiered or (hot_slot_map is not None
                          and cold_slot_map is not None),
           "tiered IVF-PQ codes need both slot maps")
    expect(not (tiered and scan_engine == "rank"),
           "tiered IVF-PQ codes need a list-major engine (cuda or torch): "
           "the rank-major scan has no per-list fetch step")
    n_lists = centers.shape[0]
    ip_metric = metric == DistanceType.InnerProduct
    per_cluster = codebook_kind == CodebookKind.PER_CLUSTER
    qf = queries.to(torch.float32)
    probes, ip, _ = _coarse(centers, metric, qf, n_probes, coarse_algo)
    if row_probes is not None:
        probes = ragged_probes(probes, row_probes, n_lists)
        n_valid = None
    slot_lists = probes.to(torch.int64).clamp(0, n_lists - 1)
    if ip_metric:
        qres = qf @ rotation.T                              # (q, dim_ext)
        base = torch.gather(ip, 1, slot_lists)              # (q, p)
        cb_norms = None
    else:
        qres = (qf[:, None, :] - centers[slot_lists]) @ rotation.T
        base = None
        cb_norms = codebook_norms(codebooks)
    score = score_fn(score_mode, codebooks.shape[1])
    if scan_engine == "rank":
        best_d, best_i = _scan_rank(
            qres, base, probes, codebooks, cb_norms, codes, indices,
            filter_words, k=k, metric=metric, per_cluster=per_cluster,
            lut_dtype=lut_dtype, packed=packed, score=score)
    else:
        tier_kw = {} if not tiered else dict(
            cold_codes=cold_codes, hot_slot_map=hot_slot_map,
            cold_slot_map=cold_slot_map, workspace_bytes=workspace_bytes)
        best_d, best_i = ivf_pq_scan(
            qres, base, codebooks, cb_norms, codes, indices, probes,
            filter_words, k=k, ip_metric=ip_metric, per_cluster=per_cluster,
            lut_dtype=lut_dtype, packed=packed, engine=scan_engine,
            score=None if scan_engine == "cuda" else score, **tier_kw)
    if metric == DistanceType.L2SqrtExpanded:
        best_d = torch.where(torch.isfinite(best_d),
                             torch.sqrt(torch.clamp(best_d, min=0.0)), best_d)
    if probe_counts is not None:
        return best_d, best_i, probe_histogram(probes, probe_counts, n_valid)
    return best_d, best_i


def _search_ragged_fn(queries, row_probes, centers, rotation, codebooks,
                      codes, indices, filter_words, probe_counts=None,
                      n_valid=None, *, n_probes: int, k: int,
                      metric: DistanceType, codebook_kind: CodebookKind,
                      lut_dtype=torch.float32, score_mode: str = "gather",
                      packed: bool = False, scan_engine: str = "torch"):
    """The ragged IVF-PQ serving body (the packing contract of
    :func:`raft_tpu_torch.neighbors.ivf_flat._search_ragged_fn`):
    ``n_probes``/``k`` are the params class's caps, ``row_probes`` each
    packed row's budget, which reaches the list-major engines as sentinel
    slots. Each LUT depends only on its own (row, list) pair, so a row's
    result does not depend on the rows beside it. List-major engines
    only: the rank-major scan has no membership mask."""
    del n_valid
    expect(scan_engine in ("cuda", "torch"),
           "ragged IVF-PQ serving needs a list-major engine, got "
           f"{scan_engine!r}")
    return _search_impl_fn(
        queries, centers, rotation, codebooks, codes, indices, filter_words,
        probe_counts, None, row_probes, n_probes=n_probes, k=k,
        metric=metric, codebook_kind=codebook_kind, lut_dtype=lut_dtype,
        score_mode=score_mode, packed=packed, coarse_algo="exact",
        scan_engine=scan_engine)


def serving_plan(params: IvfPqSearchParams, index: IvfPqIndex, k: int,
                 filter_words=None) -> Tuple[Callable, tuple, dict]:
    """``(fn, arrays, static)``: the body a query block runs, called as
    ``fn(queries, *arrays, filter_words, **static)``, with ``n_probes``
    clamped to the index and the engine and score mode resolved."""
    del filter_words      # the kernel takes shared and per-query filters
    expect(index.max_list_size > 0, "index is empty — extend() it first")
    expect(params.coarse_algo in ("exact", "approx"),
           f"coarse_algo must be 'exact' or 'approx', got "
           f"{params.coarse_algo!r}")
    expect(params.lut_dtype in LUT_DTYPES,
           f"lut_dtype must be float32/bfloat16/float8_e4m3fn/float8_e5m2, "
           f"got {params.lut_dtype}")
    score_mode = resolve_score_mode(params.score_mode, index.pq_book_size)
    engine = resolve_scan_engine(params.scan_engine, index, k, score_mode)
    static = {"n_probes": min(params.n_probes, index.n_lists), "k": k,
              "metric": index.metric, "codebook_kind": index.codebook_kind,
              "lut_dtype": params.lut_dtype, "score_mode": score_mode,
              "packed": index.packed, "coarse_algo": params.coarse_algo,
              "scan_engine": engine}
    arrays = (index.centers, index.rotation, index.codebooks, index.codes,
              index.indices)
    return _search_impl_fn, arrays, static


def search(res: Optional[Resources], params: IvfPqSearchParams,
           index: IvfPqIndex, queries, k: int, sample_filter=None,
           query_tile: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """ANN search — ``ivf_pq::search``; large query sets run in
    ``query_tile`` batches. For L2 metrics the distances are approximate
    (residual-PQ) squared L2, or its sqrt; re-rank with
    :func:`raft_tpu_torch.neighbors.refine.refine` for exact ones."""
    res = ensure_resources(res)
    queries = res.put(queries)
    expect(queries.ndim == 2 and queries.shape[1] == index.dim,
           "queries must be (q, dim)")
    filter_words = resolve_filter_words(sample_filter)
    if filter_words is not None:
        filter_words = filter_words.to(res.device)
    fn, arrays, static = serving_plan(params, index, k, filter_words)
    with tracing.range("raft_tpu.ivf_pq.search"):
        return tile_queries(lambda qt, fw: fn(qt, *arrays, fw, **static),
                            queries, filter_words, query_tile)


# ---------------------------------------------------------------------------
# serialization (versioned npy stream, the JAX package's v4 layout)
# ---------------------------------------------------------------------------


def save(index: IvfPqIndex, fh_or_path) -> None:
    """``ivf_pq::serialize``."""
    fh, own = open_maybe_path(fh_or_path, "wb")
    try:
        serialize_scalar(fh, _SERIALIZATION_VERSION, np.int32)
        serialize_scalar(fh, int(index.packed), np.int32)
        serialize_scalar(fh, int(index.metric), np.int32)
        serialize_scalar(fh, int(index.codebook_kind), np.int32)
        serialize_scalar(fh, index.pq_bits, np.int32)
        for arr in (index.centers, index.rotation, index.codebooks,
                    index.codes, index.indices, index.list_sizes):
            serialize_array(fh, arr)
    finally:
        if own:
            fh.close()


def load(res: Optional[Resources], fh_or_path) -> IvfPqIndex:
    fh, own = open_maybe_path(fh_or_path, "rb")
    try:
        check_version(deserialize_scalar(fh), _SERIALIZATION_VERSION,
                      "ivf_pq")
        packed = bool(int(deserialize_scalar(fh)))
        metric = DistanceType(int(deserialize_scalar(fh)))
        kind = CodebookKind(int(deserialize_scalar(fh)))
        pq_bits = int(deserialize_scalar(fh))
        arrays = [deserialize_array(fh) for _ in range(6)]
    finally:
        if own:
            fh.close()
    return from_numpy(*arrays, metric=metric, codebook_kind=kind,
                      pq_bits=pq_bits, packed=packed, res=res)
