"""CPU HNSW competitor baseline — the role of the reference's hnswlib
wrapper (``cpp/bench/ann/src/hnswlib/hnswlib_wrapper.h:1``): the
benchmark harness's non-RAFT comparison point on the recall-vs-QPS
pareto plot (``docs/source/raft_ann_benchmarks.md:229``); port of
``raft_tpu/bench/hnsw_cpu.py``.

The baseline is a from-scratch C++17 HNSW (``csrc/hnsw.cpp``, Malkov &
Yashunin arXiv:1603.09320), the port's own copy of the JAX package's
source, built by ``g++`` at first use into ``raft_tpu_torch/_build/``
(:func:`raft_tpu_torch.ops._build.host_library`, as the dataset I/O
library is) and loaded with ctypes: a real graph-search competitor
measured on the host CPU the way the reference measures hnswlib. Same
source, same flags: an index file written by either package loads in
the other, byte for byte.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from raft_tpu_torch.distance.types import DistanceType

_lib = None
_lib_lock = threading.Lock()
_build_error = None

_METRIC_CODES = {
    DistanceType.L2Expanded: 0,
    DistanceType.L2SqrtExpanded: 0,   # same graph; sqrt applied on top
    DistanceType.L2Unexpanded: 0,
    DistanceType.InnerProduct: 1,
}


def _bind(lib):
    lib.hnsw_create.restype = ctypes.c_void_p
    lib.hnsw_create.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                ctypes.c_int64, ctypes.c_int,
                                ctypes.c_uint64]
    lib.hnsw_add.restype = ctypes.c_int
    lib.hnsw_add.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_int64]
    lib.hnsw_size.restype = ctypes.c_int64
    lib.hnsw_size.argtypes = [ctypes.c_void_p]
    lib.hnsw_dim.restype = ctypes.c_int64
    lib.hnsw_dim.argtypes = [ctypes.c_void_p]
    lib.hnsw_metric.restype = ctypes.c_int
    lib.hnsw_metric.argtypes = [ctypes.c_void_p]
    lib.hnsw_search.restype = ctypes.c_int
    lib.hnsw_search.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int64, ctypes.c_int64,
                                ctypes.c_int64, ctypes.c_void_p,
                                ctypes.c_void_p]
    lib.hnsw_save.restype = ctypes.c_int
    lib.hnsw_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.hnsw_load.restype = ctypes.c_void_p
    lib.hnsw_load.argtypes = [ctypes.c_char_p]
    lib.hnsw_free.argtypes = [ctypes.c_void_p]
    lib.hnsw_last_error.restype = ctypes.c_char_p


def _load():
    """The native library, built on first use; None when it cannot be
    built (no compiler). The build is tried once a process."""
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        from raft_tpu_torch.ops import _build

        try:
            lib = _build.host_library("hnsw")
        except (OSError, RuntimeError) as e:
            _build_error = str(e)
            return None
        _bind(lib)
        _lib = lib
        return _lib


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native HNSW library unavailable ({_build_error});"
                           f" cannot run the CPU baseline")
    return lib


def available() -> bool:
    return _load() is not None


def _err(lib) -> str:
    return lib.hnsw_last_error().decode(errors="replace")


class HnswCpuIndex:
    """Owns the native handle; frees it on GC."""

    def __init__(self, handle, dim: int, metric: DistanceType):
        self._h = handle
        self._free = _require().hnsw_free  # bound now: _load() and module
        self.dim = dim                  # globals may be gone at GC time
        self.metric = metric

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            try:
                self._free(h)
            except TypeError:  # interpreter teardown already unloaded it
                pass
            self._h = None


def build(base, metric: DistanceType, *, M: int = 16,
          ef_construction: int = 200, seed: int = 0) -> HnswCpuIndex:
    """Insert every base row (single-threaded, like a 1-thread hnswlib
    build). ``base`` must be float32 (n, dim)."""
    lib = _require()
    base = np.ascontiguousarray(base, np.float32)
    n, dim = base.shape
    code = _METRIC_CODES.get(metric)
    if code is None:
        raise ValueError(f"hnsw_cpu: unsupported metric {metric}")
    h = lib.hnsw_create(dim, M, ef_construction, code, seed)
    if not h:
        raise RuntimeError(f"hnsw_create failed: {_err(lib)}")
    if lib.hnsw_add(h, base.ctypes.data_as(ctypes.c_void_p), n) != 0:
        lib.hnsw_free(h)
        raise RuntimeError(f"hnsw_add failed: {_err(lib)}")
    return HnswCpuIndex(h, dim, metric)


def search(index: HnswCpuIndex, queries, k: int, *, ef: int = 64):
    """(q, k) distances + ids. L2 metrics return squared L2 (sqrt for
    L2SqrtExpanded); InnerProduct returns the (positive) similarity."""
    lib = _require()
    queries = np.ascontiguousarray(queries, np.float32)
    q = queries.shape[0]
    if queries.ndim != 2 or queries.shape[1] != index.dim:
        raise ValueError("queries must be (q, dim)")
    out_d = np.empty((q, k), np.float32)
    out_i = np.empty((q, k), np.int64)
    rc = lib.hnsw_search(index._h,
                         queries.ctypes.data_as(ctypes.c_void_p), q, k,
                         max(ef, k),
                         out_d.ctypes.data_as(ctypes.c_void_p),
                         out_i.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"hnsw_search failed: {_err(lib)}")
    if index.metric == DistanceType.L2SqrtExpanded:
        out_d = np.sqrt(np.maximum(out_d, 0.0))
    elif index.metric == DistanceType.InnerProduct:
        out_d = -out_d  # native stores min-form
    return out_d, out_i.astype(np.int32)


def save(index: HnswCpuIndex, path: str) -> None:
    lib = _require()
    if lib.hnsw_save(index._h, str(path).encode()) != 0:
        raise RuntimeError(f"hnsw_save failed: {_err(lib)}")


def load(path: str, dim: int, metric: DistanceType) -> HnswCpuIndex:
    lib = _require()
    h = lib.hnsw_load(str(path).encode())
    if not h:
        raise RuntimeError(f"hnsw_load failed: {_err(lib)}")
    # cross-check the file's recorded geometry/metric against the
    # caller's: search() validates queries against the caller-supplied
    # dim while the native side strides by the FILE's dim, so accepting
    # a mismatched cache (stale, hand-placed, name collision) would read
    # past the query buffer or score under the wrong metric
    stored_dim = lib.hnsw_dim(h)
    stored_metric = lib.hnsw_metric(h)
    want_metric = _METRIC_CODES.get(metric)
    if stored_dim != dim or stored_metric != want_metric:
        lib.hnsw_free(h)
        raise RuntimeError(
            f"hnsw_load: cache {path} holds dim={stored_dim} "
            f"metric_code={stored_metric}, caller expects dim={dim} "
            f"metric_code={want_metric} ({metric.name}) — stale or "
            f"mismatched cache file")
    return HnswCpuIndex(h, dim, metric)
