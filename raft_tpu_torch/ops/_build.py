"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``. The
build happens at first use, into ``raft_tpu_torch/_build/`` (listed in
``.gitignore``), keyed on a hash of the sources and flags, so a stale
library is never loaded. :func:`build_all` starts one ``nvcc`` per
source at once and waits for all of them.

There is no fallback: a CUDA call on a machine without ``nvcc`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
#: C signature of each library's entry: name -> (symbol, argtypes)
SIGNATURES = {
    "fused_knn": ("raft_fused_knn",
                  [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                   _P, _P, _P, _P, _P]),
    "ivf_scan": ("raft_ivf_scan",
                 [_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                  _I, _I, _I, _P, _P, _P, _P, _P]),
    "bq_scan": ("raft_bq_scan",
                [_P] * 12 + [_I] * 9 + [_F] + [_P] * 4),
    "select_k": ("raft_select_k",
                 [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]),
    "beam_search": ("raft_beam_search",
                    [_P, _P, _I, _P, _I, _I, _P, _I, _P] + [_I] * 7 + [_P]
                    + [_I] * 5 + [_P, _P, _F, _P, _P, _P, _P]),
    "tier_scan": ("raft_tier_scan", [_P] * 11 + [_I] * 8 + [_P] * 5),
    "stream_read": ("raft_stream_read_sum",
                    [_P, _I, _I, _L, _I, _L, _I, _P, _P, _P]),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        path = cand if os.path.exists(cand) else None
    if path is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
            "raft_tpu_torch are built from source at first use")
    return path


def _library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _start(name: str, out: str) -> subprocess.Popen:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, out: str, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    with open(out + ".log", "w") as f:
        f.write(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(f"{out}.{os.getpid()}.tmp", out)


def build_all(names: List[str] = None) -> Dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source in
    parallel; returns name -> library path."""
    names = list(SIGNATURES) if names is None else names
    paths = {n: _library_path(n) for n in names}
    procs = {n: _start(n, p) for n, p in paths.items()
             if not os.path.exists(p)}
    for n, proc in procs.items():
        _finish(n, paths[n], proc)
    return paths


def load(name: str):
    """The C entry point of library ``name``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(path)
            symbol, argtypes = SIGNATURES[name]
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = lib
    return getattr(lib, SIGNATURES[name][0])


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
