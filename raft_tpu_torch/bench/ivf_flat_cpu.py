"""CPU IVF-Flat exact-scan competitor baseline — the role of the
reference's FAISS wrapper in the ANN benchmark
(``cpp/bench/ann/src/faiss/faiss_benchmark.cu:1``, a *second*
non-RAFT series on the recall-vs-QPS pareto beside hnswlib,
``docs/source/raft_ann_benchmarks.md:229``).

This environment has no FAISS, so the baseline is a from-scratch
numpy IVF-Flat: Lloyd-trained coarse centroids over a training
subsample, inverted lists as contiguous row blocks with their squared
norms precomputed at build, and a per-query exact scan of the
``n_probes`` closest lists (coarse scoring is one BLAS gemm per query
batch; the fine scan is one gemv per probed list span against the
precomputed norms — the same per-query scan-selected-lists structure
as FAISS's CPU ``IndexIVFFlat``). Pure numpy, no torch compute: the
competitor must not ride the subject library's compute path. Port of
``raft_tpu/bench/ivf_flat_cpu.py``: the same arithmetic and the same
file format (``RTIVFCPU`` v1), so a cache file written by either
package loads in the other.
"""

from __future__ import annotations

import numpy as np

from raft_tpu_torch.distance.types import DistanceType

_L2_METRICS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
               DistanceType.L2Unexpanded)
_MAGIC = b"RTIVFCPU"
_VERSION = 1


class IvfFlatCpuIndex:
    """Trained centroids + per-list contiguous row blocks."""

    def __init__(self, centroids, list_rows, list_ids, list_offsets,
                 metric: DistanceType):
        self.centroids = centroids      # (n_lists, dim) f32
        self.list_rows = list_rows      # (n, dim) f32, rows grouped by list
        self.list_ids = list_ids        # (n,) int32 original row ids
        self.list_offsets = list_offsets  # (n_lists + 1,) int64
        self.metric = metric
        # squared row norms, precomputed once: the L2 fine scan's
        # ||x||^2 term must not be recomputed per query
        self.list_row_sq = (list_rows * list_rows).sum(axis=1)

    @property
    def dim(self) -> int:
        return self.centroids.shape[1]


def _pairwise_sq_l2(a, b_t, b_sq):
    """(m, d) x (d, n) -> (m, n) squared L2 via the expanded form —
    one gemm, the scan's hot loop."""
    return np.maximum(
        (a * a).sum(axis=1, keepdims=True) - 2.0 * (a @ b_t) + b_sq, 0.0)


def build(base, metric: DistanceType, *, n_lists: int = 1024,
          train_iters: int = 10, trainset_fraction: float = 0.1,
          seed: int = 0) -> IvfFlatCpuIndex:
    """Lloyd k-means on a subsample, then assign every row to its
    nearest centroid and pack the inverted lists contiguously."""
    base = np.ascontiguousarray(base, np.float32)
    n, dim = base.shape
    if metric not in _L2_METRICS + (DistanceType.InnerProduct,):
        raise ValueError(f"ivf_flat_cpu: unsupported metric {metric}")
    n_lists = min(n_lists, n)
    rng = np.random.default_rng(seed)
    n_train = max(n_lists, min(n, int(n * trainset_fraction)))
    train = base[rng.choice(n, n_train, replace=False)] \
        if n_train < n else base
    cent = train[rng.choice(n_train, n_lists, replace=False)].copy()

    def assign(rows, chunk=65536):
        out = np.empty(rows.shape[0], np.int64)
        c_t = np.ascontiguousarray(cent.T)
        c_sq = (cent * cent).sum(axis=1)[None, :]
        for s in range(0, rows.shape[0], chunk):
            d = _pairwise_sq_l2(rows[s:s + chunk], c_t, c_sq)
            out[s:s + chunk] = d.argmin(axis=1)
        return out

    for _ in range(train_iters):
        lbl = assign(train)
        # batched centroid update; empty lists keep their old centroid
        sums = np.zeros((n_lists, dim), np.float64)
        np.add.at(sums, lbl, train)
        counts = np.bincount(lbl, minlength=n_lists)
        nz = counts > 0
        cent[nz] = (sums[nz] / counts[nz, None]).astype(np.float32)

    lbl = assign(base)
    order = np.argsort(lbl, kind="stable")
    list_ids = order.astype(np.int32)
    list_rows = base[order]
    counts = np.bincount(lbl, minlength=n_lists)
    offsets = np.zeros(n_lists + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    return IvfFlatCpuIndex(cent, list_rows, list_ids, offsets, metric)


def search(index: IvfFlatCpuIndex, queries, k: int, *,
           n_probes: int = 32):
    """Exact scan of the ``n_probes`` closest lists per query.
    Returns (q, k) distances + int32 ids; L2 metrics return squared L2
    (sqrt applied for L2SqrtExpanded), InnerProduct the similarity."""
    queries = np.ascontiguousarray(queries, np.float32)
    if queries.ndim != 2 or queries.shape[1] != index.dim:
        raise ValueError("queries must be (q, dim)")
    q = queries.shape[0]
    n_lists = index.centroids.shape[0]
    n_probes = min(n_probes, n_lists)
    ip_metric = index.metric == DistanceType.InnerProduct

    c_t = np.ascontiguousarray(index.centroids.T)
    if ip_metric:
        cd = -(queries @ c_t)  # min-form coarse scores
    else:
        c_sq = (index.centroids * index.centroids).sum(axis=1)[None, :]
        cd = _pairwise_sq_l2(queries, c_t, c_sq)
    probes = np.argpartition(cd, n_probes - 1, axis=1)[:, :n_probes]

    out_d = np.full((q, k), np.inf, np.float32)
    out_i = np.full((q, k), -1, np.int32)
    offs = index.list_offsets
    q_sq = (queries * queries).sum(axis=1)
    for qi in range(q):
        spans = [(offs[p], offs[p + 1]) for p in probes[qi]]
        total = int(sum(e - s for s, e in spans))
        if total == 0:
            continue
        # per-span gemvs against precomputed norms: no per-query copy
        # of the row data, no per-query norm recompute
        qv = queries[qi]
        d = np.empty(total, np.float32)
        ids = np.empty(total, np.int32)
        pos = 0
        for s, e in spans:
            seg = index.list_rows[s:e]
            if ip_metric:
                d[pos:pos + (e - s)] = -(seg @ qv)
            else:
                d[pos:pos + (e - s)] = (index.list_row_sq[s:e]
                                        - 2.0 * (seg @ qv) + q_sq[qi])
            ids[pos:pos + (e - s)] = index.list_ids[s:e]
            pos += e - s
        if not ip_metric:
            np.maximum(d, 0.0, out=d)
        kk = min(k, total)
        top = np.argpartition(d, kk - 1)[:kk]
        top = top[np.argsort(d[top], kind="stable")]
        out_d[qi, :kk] = d[top]
        out_i[qi, :kk] = ids[top]
    if index.metric == DistanceType.L2SqrtExpanded:
        out_d = np.sqrt(np.maximum(out_d, 0.0))
    elif ip_metric:
        out_d = -out_d
    return out_d, out_i


def save(index: IvfFlatCpuIndex, path) -> None:
    with open(path, "wb") as fh:
        fh.write(_MAGIC)
        np.save(fh, np.int64([_VERSION, int(index.metric)]))
        np.save(fh, index.centroids)
        np.save(fh, index.list_rows)
        np.save(fh, index.list_ids)
        np.save(fh, index.list_offsets)


def load(path, dim: int, metric: DistanceType) -> IvfFlatCpuIndex:
    with open(path, "rb") as fh:
        if fh.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"{path}: not an ivf_flat_cpu index")
        version, stored_metric = np.load(fh)
        if version != _VERSION:
            raise ValueError(f"{path}: unsupported version {version}")
        cent = np.load(fh)
        rows = np.load(fh)
        ids = np.load(fh)
        offs = np.load(fh)
    if (cent.ndim != 2 or rows.ndim != 2 or rows.shape[1] != cent.shape[1]
            or ids.shape[0] != rows.shape[0]
            or offs.shape[0] != cent.shape[0] + 1
            or offs[0] != 0 or offs[-1] != rows.shape[0]
            or np.any(np.diff(offs) < 0)):
        raise ValueError(f"{path}: corrupt ivf_flat_cpu index")
    # cross-check the file's recorded geometry/metric against the
    # caller's (same contract as hnsw_cpu.load)
    if cent.shape[1] != dim or stored_metric != int(metric):
        raise ValueError(
            f"{path}: cache holds dim={cent.shape[1]} "
            f"metric={stored_metric}, caller expects dim={dim} "
            f"metric={int(metric)} ({metric.name}) — stale or "
            f"mismatched cache file")
    return IvfFlatCpuIndex(cent, rows, ids, offs, DistanceType(metric))
