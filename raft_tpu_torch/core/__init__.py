"""Core utilities: resources, validation, bitset, serialization, tracing,
logging and the element-wise operator vocabulary (the names
``raft_tpu/core/__init__.py`` exports, but the executor, which lives in
:mod:`raft_tpu_torch.core.executor` and at the package's top level)."""

from raft_tpu_torch.core import operators
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.logger import LogLevel, logger, set_level
from raft_tpu_torch.core.resources import DeviceResources, Resources
from raft_tpu_torch.core.serialize import (
    deserialize_array,
    deserialize_scalar,
    serialize_array,
    serialize_scalar,
)
from raft_tpu_torch.core.validation import expect

__all__ = [
    "Resources",
    "DeviceResources",
    "logger",
    "set_level",
    "LogLevel",
    "serialize_array",
    "deserialize_array",
    "serialize_scalar",
    "deserialize_scalar",
    "Bitset",
    "operators",
    "expect",
]
