"""Distributed communication — port of ``raft_tpu/comms`` (the
reference's ``raft/comms/``: ``comms_t``, ``core/comms.hpp:242``).

Within a process the mesh is a grid of shard slots, each bound to a
``torch.device`` (:class:`Mesh`; every slot ``cuda:0`` on one card), and
a collective is a function of the per-slot list (:mod:`.comms`).
Between processes, :func:`initialize` joins a ``torch.distributed``
group (gloo on the CPU, NCCL across cards).
"""

from raft_tpu_torch.comms.comms import (
    Comms,
    Mesh,
    Op,
    P,
    allgather,
    allgather_quantized,
    allgather_wire,
    allreduce,
    allreduce_quantized,
    alltoall,
    barrier,
    bcast,
    device_recv,
    device_send,
    device_sendrecv,
    gather,
    mark_varying,
    reduce,
    reducescatter,
    reducescatter_quantized,
    resolve_probe_wire_dtype,
    resolve_wire_dtype,
)
from raft_tpu_torch.comms.bootstrap import (
    initialize,
    local_comms,
    make_mesh,
)

__all__ = [
    "Comms",
    "Mesh",
    "Op",
    "P",
    "allreduce",
    "allreduce_quantized",
    "allgather",
    "allgather_quantized",
    "allgather_wire",
    "resolve_probe_wire_dtype",
    "resolve_wire_dtype",
    "alltoall",
    "barrier",
    "bcast",
    "gather",
    "reduce",
    "reducescatter",
    "reducescatter_quantized",
    "device_send",
    "device_recv",
    "device_sendrecv",
    "mark_varying",
    "initialize",
    "local_comms",
    "make_mesh",
]
