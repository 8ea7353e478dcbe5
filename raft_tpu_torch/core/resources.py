"""Resources handle — the PyTorch analog of ``raft::resources``.

What the JAX package's handle carries across calls, minus what XLA
owned (the compile cache, the mesh): the target **device**, a **seed**
with a ``torch.Generator`` on that device, and the tunables
``matmul_precision`` and ``workspace_limit_bytes``.

The device defaults to ``cuda``. A handle that asks for CUDA on a
machine without it raises at construction: it never quietly runs on the
CPU. Callers that want the CPU (the tests) say ``device="cpu"``.
Callers that pass no handle share one a device from
:data:`resources_manager` (:class:`ResourcesManager`).
"""

from __future__ import annotations

import dataclasses
import threading
import warnings
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch


@dataclasses.dataclass
class Resources:
    """Shared execution context threaded through every raft_tpu_torch call.

    Attributes:
      device: where indexes live and kernels run (``"cuda"`` by default).
      seed: base seed of the handle-owned ``generator``.
      matmul_precision: the distance products' precision
        (:func:`raft_tpu_torch.distance.pairwise.matmul`): ``"highest"``
        (also ``"float32"``, ``"default"``) keeps float32 products in full
        float32 (no TF32), as the JAX package's ``Precision.HIGHEST``;
        ``"bfloat16"`` takes one bfloat16 pass with float32 sums.
      workspace_limit_bytes: soft budget that batching heuristics use
        when sizing tiles (the reference's workspace memory resource).
    """

    device: Union[str, torch.device] = "cuda"
    seed: int = 0
    matmul_precision: str = "highest"
    workspace_limit_bytes: int = 2 * 1024**3

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Resources(device='cuda') but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain versions")
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)

    def put(self, x, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Place an array (numpy, tensor, sequence) on this handle's device."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        arr = np.asarray(x)
        if not arr.flags.writeable:   # e.g. a view of a JAX array
            arr = arr.copy()
        return torch.as_tensor(arr).to(device=self.device, dtype=dtype)


# the JAX package's alias, after ``raft::handle_t`` == device_resources
DeviceResources = Resources


class ResourcesManager:
    """Process-wide pool of shared :class:`Resources`, one a device — the
    analog of ``raft::device_resources_manager`` (``core/
    device_resources_manager.hpp:49-154``), which hands a multi-threaded
    server one pre-configured handle per GPU.

    Set-then-freeze, as the reference's manager: the ``set_*`` defaults
    apply to every handle the manager builds, and once it has built one
    they are frozen (a later ``set_*`` warns and changes nothing). Handles
    are built under the manager's lock, so threads asking at once get
    one handle."""

    def __init__(self):
        self._lock = threading.Lock()
        self._handles: Dict[Tuple[str, Optional[int]], Resources] = {}
        self._defaults: Dict[str, Any] = {}

    def _set(self, name: str, value) -> None:
        with self._lock:
            if self._handles:
                warnings.warn(
                    f"ResourcesManager.set_{name} after a handle was built "
                    "is ignored: the defaults are frozen", RuntimeWarning,
                    stacklevel=3)
                return
            self._defaults[name] = value

    def set_seed(self, seed: int) -> None:
        self._set("seed", int(seed))

    def set_matmul_precision(self, precision: str) -> None:
        self._set("matmul_precision", precision)

    def set_workspace_limit_bytes(self, n: int) -> None:
        self._set("workspace_limit_bytes", int(n))

    def set_compilation_cache_dir(self, path: str) -> None:
        """A no-op kept for the JAX package's API: the port compiles no
        XLA programs, and its kernels' build cache is ``ops/_build``'s."""
        del path

    def get_device_resources(
            self, device: Union[None, int, str, torch.device] = None
    ) -> Resources:
        """The shared handle of ``device``: a CUDA device index, a torch
        device (or its string), or None for the current CUDA device.
        Handles are keyed by the CUDA device index; ``"cpu"`` has one of
        its own. Asking for CUDA without a card raises, and caches
        nothing."""
        if isinstance(device, int):
            device = torch.device("cuda", device)
        device = torch.device("cuda" if device is None else device)
        index = device.index
        if device.type == "cuda" and index is None \
                and torch.cuda.is_available():
            index = torch.cuda.current_device()
        key = (device.type, index)
        with self._lock:
            if key not in self._handles:
                dev = device if index is None else torch.device(
                    device.type, index)
                self._handles[key] = Resources(device=dev, **self._defaults)
            return self._handles[key]


resources_manager = ResourcesManager()


def get_default_resources() -> Resources:
    """The process-wide default handle (the current CUDA device), shared
    by every caller that passes no handle."""
    return resources_manager.get_device_resources(None)


def ensure_resources(res: Optional[Resources]) -> Resources:
    """``res`` itself, or the process-wide default handle (on CUDA)."""
    return res if res is not None else get_default_resources()
