"""raft_tpu_torch — the PyTorch/CUDA port of ``raft_tpu`` for NVIDIA
Hopper GPUs.

It mirrors the JAX package's layout and names (``core``, ``distance``,
``cluster``, ``neighbors``, ``ops``, ``serving``, ``spatial``, ``utils``); every Pallas kernel of the JAX
package becomes a hand-written CUDA kernel under ``csrc/``, built with
``nvcc`` at first use. Entry points run on ``cuda`` unless the caller's
:class:`Resources` says ``device="cpu"``, where the kernels' plain
PyTorch versions run. The package imports neither JAX nor ``raft_tpu``.
"""

from raft_tpu_torch.core.executor import SearchExecutor
from raft_tpu_torch.core.resources import (
    DeviceResources,
    Resources,
    ensure_resources,
)

__all__ = ["DeviceResources", "Resources", "SearchExecutor",
           "ensure_resources"]
