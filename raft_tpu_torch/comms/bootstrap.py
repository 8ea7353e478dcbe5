"""Bootstrap — port of ``raft_tpu/comms/bootstrap.py`` (raft-dask's
NCCL-uniqueId rendezvous, ``raft_dask/common/comms.py:137-215``, and
``initialize_mpi_comms``, ``comms/mpi_comms.hpp:60``).

:func:`initialize` joins a ``torch.distributed`` process group: gloo
between CPU processes, NCCL between processes that each hold their own
card. Nothing on the card machine tells a program of a cluster, so the
caller gives the address, the world size and the rank. Within one
process the mesh is a grid of shard slots (:class:`~raft_tpu_torch.comms.
comms.Mesh`), made by :func:`make_mesh` / :func:`local_comms`.
"""

from __future__ import annotations

import datetime
from typing import Optional, Sequence

import numpy as np
import torch

from raft_tpu_torch.comms.comms import Comms, Mesh
from raft_tpu_torch.core.validation import expect


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               backend: Optional[str] = None,
               timeout_s: float = 120.0) -> None:
    """Join the multi-process group (``torch.distributed.
    init_process_group``; role of ``Comms.init``, ``raft_dask/common/
    comms.py:172-215``). ``coordinator_address`` is ``host:port`` (or a
    full ``tcp://`` URL); ``backend`` defaults to ``nccl`` when this
    process has a card and ``gloo`` otherwise. ``local_device_ids``
    names this process's card (its first entry becomes the current CUDA
    device)."""
    expect(coordinator_address is not None and num_processes is not None
           and process_id is not None,
           "initialize needs coordinator_address, num_processes and "
           "process_id: nothing on the machine names a cluster")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl" and local_device_ids:
        torch.cuda.set_device(int(local_device_ids[0]))
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    torch.distributed.init_process_group(
        backend=backend, init_method=url, world_size=int(num_processes),
        rank=int(process_id), timeout=datetime.timedelta(seconds=timeout_s))


def make_mesh(axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None, devices=None,
              device=None) -> Mesh:
    """A mesh of shard slots. ``devices`` lists each slot's device; with
    none given, ``shape`` slots all on ``device`` (default ``"cuda"``,
    one card holding every slot, as the JAX tests stack virtual devices),
    or with no shape either, one slot a visible card. With more axes the
    grid is the 2-D row/col process grid the reference builds with
    ``comm_split``."""
    if devices is None:
        if shape is None:
            n = torch.cuda.device_count()
            expect(n > 0, "make_mesh without devices or shape needs a CUDA "
                   "device (pass device='cpu' and a shape for CPU slots)")
            devices = [torch.device("cuda", i) for i in range(n)]
        else:
            dev = torch.device(device or "cuda")
            expect(dev.type != "cuda" or torch.cuda.is_available(),
                   "make_mesh(device='cuda') but torch.cuda.is_available() "
                   "is False; pass device='cpu' for CPU slots")
            devices = [dev] * int(np.prod(shape))
    devs = list(devices)
    if shape is None:
        shape = (len(devs),) + (1,) * (len(axis_names) - 1)
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(tuple(shape)), tuple(axis_names))


def local_comms(axis_names: Sequence[str] = ("data",),
                shape: Optional[Sequence[int]] = None, devices=None,
                device=None) -> Comms:
    """Comms over a local mesh (:func:`make_mesh`) on its first axis —
    the test-time analog of the reference's LocalCUDACluster trick."""
    return Comms(make_mesh(axis_names, shape, devices, device),
                 axis_names[0])
