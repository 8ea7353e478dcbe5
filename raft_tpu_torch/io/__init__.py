"""Dataset I/O — the big-ann-benchmarks binary formats through the
native C++ reader and writer (``csrc/io.cpp``), with a numpy fallback;
port of ``raft_tpu/io`` (the reference's ``bench/ann/src/common/
dataset.hpp`` ``BinFile<T>`` loader and the ``raft-ann-bench`` dataset
tooling)."""

from raft_tpu_torch.io.binfile import (
    BinDataset,
    native_available,
    read_bin,
    write_bin,
)

__all__ = ["BinDataset", "native_available", "read_bin", "write_bin"]
