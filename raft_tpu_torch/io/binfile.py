"""``.fbin`` / ``.u8bin`` / ``.i8bin`` / ``.ibin`` readers and writers;
port of ``raft_tpu/io/binfile.py``.

Primary path: the port's own copy of the native C++ library
(``raft_tpu_torch/csrc/io.cpp``: mmap, threaded reads, a background
prefetch thread, the ``BinFile<T>`` analog of the reference's
``bench/ann/src/common/dataset.hpp:45-145``), compiled by ``g++`` at
first use into ``raft_tpu_torch/_build/`` (:func:`raft_tpu_torch.ops.
_build.host_library`) and loaded with ctypes. Fallback: numpy memmap.

``use_native``: ``None`` takes the library where it builds and numpy
otherwise; ``True`` raises when the library cannot be built; ``False``
takes numpy. Both paths read and write the same bytes.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import threading
from typing import Optional

import numpy as np

_SUFFIX_DTYPES = {
    ".fbin": np.float32,
    ".u8bin": np.uint8,
    ".i8bin": np.int8,
    ".ibin": np.int32,   # groundtruth index files
}

_lib = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "rt_io_open": (_P, [ctypes.c_char_p, _I64]),
    "rt_io_rows": (_I64, [_P]),
    "rt_io_dim": (_I64, [_P]),
    "rt_io_last_error": (ctypes.c_char_p, []),
    "rt_io_read_rows": (ctypes.c_int, [_P, _I64, _I64, _P, ctypes.c_int]),
    "rt_io_close": (None, [_P]),
    "rt_io_create": (_P, [ctypes.c_char_p, _I64, _I64, _I64]),
    "rt_io_append_rows": (ctypes.c_int, [_P, _P, _I64]),
    "rt_io_close_writer": (ctypes.c_int, [_P]),
    "rt_io_pipeline_start": (_P, [_P, _I64, ctypes.c_int]),
    "rt_io_pipeline_next": (ctypes.c_int, [
        _P, ctypes.POINTER(_P), ctypes.POINTER(_I64), ctypes.POINTER(_I64)]),
    "rt_io_pipeline_close": (None, [_P]),
}


def _dtype_for(path: str):
    suffix = pathlib.Path(path).suffix
    if suffix not in _SUFFIX_DTYPES:
        raise ValueError(
            f"unknown dataset suffix {suffix!r}; expected one of "
            f"{sorted(_SUFFIX_DTYPES)}"
        )
    return np.dtype(_SUFFIX_DTYPES[suffix])


def _load_native():
    """The native I/O library (built on first use), or None when it
    cannot be built; the build is tried once a process."""
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        from raft_tpu_torch.ops import _build

        try:
            lib = _build.host_library("io")
        except (OSError, RuntimeError) as e:
            _build_error = str(e)
            return None
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return _lib


def native_available() -> bool:
    """True when the native library is built (or builds now)."""
    return _load_native() is not None


def _resolve_native(use_native: Optional[bool]) -> bool:
    if use_native is None:
        return native_available()
    if use_native and not native_available():
        raise IOError(
            "use_native=True but the native IO library could not be built "
            f"({_build_error}); pass use_native=None to allow the numpy "
            "fallback")
    return bool(use_native)


def _error(lib) -> str:
    return lib.rt_io_last_error().decode()


class BinDataset:
    """Windowed access to a big-ann bin file — the ``BinFile<T>`` +
    subset view combination the reference bench uses for 100M+ row
    datasets (``dataset.hpp`` subset ctor). ``native`` says which path
    reads it."""

    def __init__(self, path, *, use_native: Optional[bool] = None):
        self.path = str(path)
        self.dtype = _dtype_for(self.path)
        self._handle = None
        self.native = _resolve_native(use_native)
        if self.native:
            lib = _load_native()
            handle = lib.rt_io_open(self.path.encode(), self.dtype.itemsize)
            if not handle:
                raise IOError(f"native open failed: {_error(lib)}")
            self._handle = handle
            self.n_rows = int(lib.rt_io_rows(handle))
            self.dim = int(lib.rt_io_dim(handle))
        else:
            header = np.fromfile(self.path, np.int32, 2)
            if header.size != 2 or header[1] <= 0 or header[0] < 0:
                raise IOError(f"bad bin header in {self.path}")
            self.n_rows, self.dim = int(header[0]), int(header[1])
            expected = 8 + self.n_rows * self.dim * self.dtype.itemsize
            actual = os.path.getsize(self.path)
            if expected > actual:
                raise IOError(
                    f"truncated bin file {self.path}: header promises "
                    f"{expected} bytes, file has {actual}"
                )

    @property
    def shape(self):
        return (self.n_rows, self.dim)

    def read(self, row_start: int = 0, n_rows: Optional[int] = None,
             n_threads: int = 0) -> np.ndarray:
        """Copy rows [row_start, row_start + n_rows) into a fresh array."""
        if n_rows is None:
            n_rows = self.n_rows - row_start
        if row_start < 0 or n_rows < 0 or row_start + n_rows > self.n_rows:
            raise IndexError("read out of bounds")
        out = np.empty((n_rows, self.dim), self.dtype)
        if self.native:
            lib = _load_native()
            rc = lib.rt_io_read_rows(self._handle, row_start, n_rows,
                                     out.ctypes.data_as(_P), n_threads)
            if rc != 0:
                raise IOError(_error(lib))
        else:
            mm = np.memmap(self.path, self.dtype, mode="r", offset=8,
                           shape=(self.n_rows, self.dim))
            out[:] = mm[row_start:row_start + n_rows]
            del mm
        return out

    def iter_chunks(self, chunk_rows: int, n_threads: int = 0,
                    copy: bool = True):
        """Yield ``(first_row, array)`` chunks in order.

        On the native path a background C++ thread reads chunk i+1
        while chunk i is consumed (double-buffered). With ``copy=False``
        the yielded array is a view of the prefetch buffer, valid only
        until the next iteration (enough when the next step copies it to
        the device)."""
        if chunk_rows <= 0:
            raise ValueError("chunk_rows must be positive")
        if not self.native:
            for start in range(0, self.n_rows, chunk_rows):
                n = min(chunk_rows, self.n_rows - start)
                yield start, self.read(start, n)
            return
        lib = _load_native()
        pipe = lib.rt_io_pipeline_start(self._handle, chunk_rows, n_threads)
        if not pipe:
            raise IOError(_error(lib))
        try:
            data_p = _P()
            first = _I64()
            nrows = _I64()
            while True:
                rc = lib.rt_io_pipeline_next(pipe, ctypes.byref(data_p),
                                             ctypes.byref(first),
                                             ctypes.byref(nrows))
                if rc == 1:
                    return
                if rc != 0:
                    raise IOError(_error(lib))
                n = int(nrows.value)
                buf = (ctypes.c_char * (n * self.dim * self.dtype.itemsize)
                       ).from_address(data_p.value)
                arr = np.frombuffer(buf, self.dtype).reshape(n, self.dim)
                yield int(first.value), (arr.copy() if copy else arr)
        finally:
            lib.rt_io_pipeline_close(pipe)

    def close(self):
        if self.native and self._handle is not None:
            _load_native().rt_io_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        # best effort at interpreter exit, when the module may be gone
        try:
            self.close()
        except (AttributeError, TypeError):
            pass


def read_bin(path, row_start: int = 0, n_rows: Optional[int] = None,
             **kwargs) -> np.ndarray:
    with BinDataset(path, **kwargs) as ds:
        return ds.read(row_start, n_rows)


def write_bin(path, data, *, use_native: Optional[bool] = None) -> bool:
    """Write a (n, d) array in big-ann bin layout (dtype from the
    suffix). Returns True when the native library wrote it."""
    data = np.ascontiguousarray(np.asarray(data), dtype=_dtype_for(str(path)))
    if data.ndim != 2:
        raise ValueError("write_bin expects (n, d) data")
    native = _resolve_native(use_native)
    if native:
        lib = _load_native()
        h = lib.rt_io_create(str(path).encode(), data.shape[0],
                             data.shape[1], data.dtype.itemsize)
        if not h:
            raise IOError(_error(lib))
        if lib.rt_io_append_rows(h, data.ctypes.data_as(_P),
                                 data.shape[0]) != 0:
            lib.rt_io_close_writer(h)
            raise IOError(_error(lib))
        if lib.rt_io_close_writer(h) != 0:
            raise IOError(_error(lib))
    else:
        with open(path, "wb") as fh:
            np.asarray(data.shape, np.int32).tofile(fh)
            data.tofile(fh)
    return native
