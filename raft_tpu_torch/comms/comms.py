"""``comms_t``-shaped collectives over a mesh of shard slots — port of
``raft_tpu/comms/comms.py`` (reference ``core/comms.hpp:125-215``
``comms_iface``, ``:242`` ``comms_t``).

**The mesh is one process's shard slots.** The JAX package runs one
``shard_map`` body over a device mesh (its tests stack 8 virtual CPU
devices). Here a :class:`Mesh` is a grid of R slots with named axes,
each slot bound to a ``torch.device``; on one card every slot is
``cuda:0``, as the JAX tests stack virtual devices on one host. Sharded
state is a per-slot list of tensors (slot ``s`` at index ``s``,
row-major over the grid). A mapped body runs slot by slot, and a
collective here is a function of the per-slot list: it takes every
slot's value and returns every slot's result (each on its slot's
device), so the collectives are the boundaries between a body's per-slot
loops. Everything runs on one thread and the current stream; NCCL will
not put two ranks of one group on one GPU, so ``torch.distributed`` is
used only where processes really are separate
(:func:`raft_tpu_torch.comms.bootstrap.initialize`, the ``*_multihost``
checkpoints).

The collectives take ``axis`` (a mesh axis name) and find the mesh of
the enclosing :meth:`Comms.run` or :meth:`Comms.active` scope (the
mapped-program context the JAX versions read implicitly), or ``mesh=``.
A group of an axis is the slots that share every other coordinate,
ordered by their coordinate on the axis (their rank).

Arithmetic: a SUM over ranks adds in rank order, left to right; the
quantized wires compute as the JAX package writes them (a product by the
constant reciprocal ``1/127`` or ``1/254``, never a division), and the
int8 codes are the same numbers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch.core import tracing
from raft_tpu_torch.core.validation import expect


class P(tuple):
    """A partition spec, after ``jax.sharding.PartitionSpec``: entry i
    names the mesh axis dimension i is split over (``None``: not
    split). ``P()`` is replicated."""

    def __new__(cls, *names):
        return super().__new__(cls, names)


class Mesh:
    """A grid of shard slots with named axes (``jax.sharding.Mesh``'s
    role): ``devices`` is an array (any nesting) of ``torch.device`` (or
    device strings) of the grid's shape."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.empty(np.shape(np.asarray(devices, dtype=object)),
                       dtype=object)
        for idx, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            arr[idx] = torch.device(d)
        self.axis_names = tuple(axis_names)
        expect(arr.ndim == len(self.axis_names),
               f"mesh of rank {arr.ndim} needs {arr.ndim} axis names, got "
               f"{self.axis_names}")
        self.devices = arr
        self.shape = dict(zip(self.axis_names, arr.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def slot_devices(self) -> List[torch.device]:
        """Each slot's device, slot order (row-major over the grid)."""
        return list(self.devices.reshape(-1))

    def _ids(self) -> np.ndarray:
        return np.arange(self.size).reshape(self.devices.shape)

    def groups(self, axis: str) -> List[List[int]]:
        """The slot ids of each group of ``axis``, each in rank order."""
        ax = self.axis_names.index(axis)
        ids = np.moveaxis(self._ids(), ax, -1)
        return [list(map(int, g)) for g in ids.reshape(-1, ids.shape[-1])]

    def coord(self, slot: int, axis: str) -> int:
        """Slot ``slot``'s coordinate (rank) on ``axis``."""
        idx = np.unravel_index(slot, self.devices.shape)
        return int(idx[self.axis_names.index(axis)])

    def __repr__(self) -> str:
        devs = sorted(set(map(str, self.slot_devices())))
        return f"Mesh({self.shape}, devices={devs})"


_active = threading.local()


def _mesh(mesh: Optional[Mesh]) -> Mesh:
    if mesh is not None:
        return mesh
    stack = getattr(_active, "stack", None)
    expect(bool(stack), "a collective needs a mesh: call it inside "
           "Comms.run / Comms.active, or pass mesh=")
    return stack[-1]


@contextlib.contextmanager
def _scope(mesh: Mesh):
    stack = getattr(_active, "stack", None)
    if stack is None:
        stack = _active.stack = []
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def _payload_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(_payload_bytes(t) for t in tree)
    return 0


def _count_collective(family: str, tree) -> None:
    """Calls/bytes accounting for one collective veneer call: bumps
    ``comms.<family>.calls`` by one and ``comms.<family>.modeled_bytes``
    by one shard's payload (the JAX package counts the same per-shard
    bytes once per traced program; the port counts per call)."""
    tracing.inc_counters({
        f"comms.{family}.calls": 1.0,
        f"comms.{family}.modeled_bytes": float(_payload_bytes(tree)),
    })


def timed_dispatch(family: str, thunk: Callable, axis: str = "data", *,
                   modeled_bytes: float = 0.0,
                   trace_ids: Tuple[int, ...] = (),
                   attrs: Optional[dict] = None):
    """Host-side timed dispatch of one collective-bearing call: records a
    ``comms.dispatch.<family>`` span and bumps
    ``comms.dispatch.<family>.{calls,seconds,modeled_bytes}``. Returns
    ``thunk()``'s result unchanged; the time covers what the thunk
    blocks on (the traced direct searches synchronize inside it)."""
    t0 = time.perf_counter()
    out = thunk()
    t1 = time.perf_counter()
    a = {"axis": axis, "modeled_bytes": float(modeled_bytes)}
    a.update(attrs or {})
    tracing.record_span(f"comms.dispatch.{family}", t0, t1,
                        trace_ids=trace_ids, attrs=a)
    tracing.inc_counters({
        f"comms.dispatch.{family}.calls": 1.0,
        f"comms.dispatch.{family}.seconds": t1 - t0,
        f"comms.dispatch.{family}.modeled_bytes": float(modeled_bytes),
    })
    return out


class Op(enum.Enum):
    """Reduction ops (``core/comms.hpp`` ``op_t``: SUM/PROD/MIN/MAX)."""

    SUM = "sum"
    PROD = "prod"
    MIN = "min"
    MAX = "max"


# ---------------------------------------------------------------------------
# the group machinery: every collective is a function of the per-slot list
# ---------------------------------------------------------------------------


def _by_group(xs, axis: str, mesh: Optional[Mesh], fn) -> list:
    """Apply ``fn(values_in_rank_order, home_device)`` to each group of
    ``axis``; ``fn`` returns one result per member (rank order), or one
    result every member shares. Each result lands on its slot's device."""
    mesh = _mesh(mesh)
    xs = list(xs)
    expect(len(xs) == mesh.size,
           f"a collective takes one value a slot ({mesh.size}), got "
           f"{len(xs)}")
    devs = mesh.slot_devices()
    out = [None] * mesh.size
    for g in mesh.groups(axis):
        home = devs[g[0]]
        vals = [_to(xs[s], home) for s in g]
        res = fn(vals, home)
        per = res if isinstance(res, list) else [res] * len(g)
        for s, r in zip(g, per):
            out[s] = _to(r, devs[s])
    return out


def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple):
        return tuple(_to(t, device) for t in x)
    return x


def _sum_ranks(vals):
    """The rank-order sum ``((v0 + v1) + v2) + ...``."""
    acc = vals[0]
    for v in vals[1:]:
        acc = acc + v
    return acc


def _reduce_vals(vals, op: "Op"):
    if op == Op.SUM:
        return _sum_ranks(vals)
    st = torch.stack(vals)
    if op == Op.MAX:
        return st.amax(dim=0)
    if op == Op.MIN:
        return st.amin(dim=0)
    return torch.prod(st, dim=0)


def axis_size(axis: str, mesh: Optional[Mesh] = None) -> int:
    return _mesh(mesh).shape[axis]


def rank(axis: str = "data", mesh: Optional[Mesh] = None) -> List[int]:
    """``comms_t::get_rank``: each slot's rank on ``axis``."""
    m = _mesh(mesh)
    return [m.coord(s, axis) for s in range(m.size)]


def size(axis: str = "data", mesh: Optional[Mesh] = None) -> int:
    """``comms_t::get_size``."""
    return axis_size(axis, mesh)


def allreduce(xs, op: Op = Op.SUM, axis: str = "data", mesh=None):
    """``comms_t::allreduce``."""
    _count_collective("allreduce", xs[0])
    return _by_group(xs, axis, mesh, lambda v, _h: _reduce_vals(v, op))


def bcast(xs, root: int = 0, axis: str = "data", mesh=None):
    """``comms_t::bcast``: every rank ends with root's value."""
    _count_collective("bcast", xs[0])
    return _by_group(xs, axis, mesh, lambda v, _h: v[root])


def reduce(xs, root: int = 0, op: Op = Op.SUM, axis: str = "data",
           mesh=None):
    """``comms_t::reduce``: the reduced value on every rank (a superset
    of the reference's root-only guarantee, as in the JAX package)."""
    _count_collective("reduce", xs[0])
    return _by_group(xs, axis, mesh, lambda v, _h: _reduce_vals(v, op))


def allgather(xs, axis: str = "data", tiled: bool = False, mesh=None):
    """``comms_t::allgather``: every rank's block stacked on a new
    leading axis (concatenated when ``tiled``)."""
    _count_collective("allgather", xs[0])
    return _by_group(xs, axis, mesh,
                     lambda v, _h: torch.cat(v) if tiled else torch.stack(v))


def gather(xs, root: int = 0, axis: str = "data", tiled: bool = False,
           mesh=None):
    """``comms_t::gather``: valid on every rank, a superset of the
    reference's root-only result (as in the JAX package)."""
    del root
    _count_collective("gather", xs[0])
    return _by_group(xs, axis, mesh,
                     lambda v, _h: torch.cat(v) if tiled else torch.stack(v))


# low-precision wire formats for result-carrying collectives — the
# EQuARX move (PAPERS.md): the payload shrinks, the math around the
# collective stays full precision. "f32" is the identity.
WIRE_DTYPES = ("f32", "bf16")


def resolve_wire_dtype(wire_dtype: str) -> torch.dtype:
    """Map a ``wire_dtype`` param to its torch dtype (validating)."""
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(
            f"wire_dtype must be one of {WIRE_DTYPES}, got {wire_dtype!r}")
    return torch.float32 if wire_dtype == "f32" else torch.bfloat16


def allgather_wire(xs, axis: str = "data", wire_dtype: str = "f32",
                   mesh=None):
    """:func:`allgather` with an optional low-precision wire: cast to
    ``wire_dtype`` before the gather, back after."""
    wd = resolve_wire_dtype(wire_dtype)
    src = xs[0].dtype
    if src == wd:
        _count_collective("allgather_wire", xs[0])
        return _by_group(xs, axis, mesh, lambda v, _h: torch.stack(v))
    xw = [x.to(wd) for x in xs]
    _count_collective("allgather_wire", xw[0])
    return _by_group(xw, axis, mesh,
                     lambda v, _h: torch.stack(v).to(src))


REDUCE_WIRE_DTYPES = ("f32", "bf16", "int8")

# feature-block width of the EQuARX block-wise scales: one f32 scale per
# 128 payload elements
QUANT_BLOCK = 128

_TINY = float(torch.finfo(torch.float32).tiny)


def resolve_reduce_wire_dtype(wire_dtype: str) -> str:
    if wire_dtype not in REDUCE_WIRE_DTYPES:
        raise ValueError(
            f"reduce wire_dtype must be one of {REDUCE_WIRE_DTYPES}, "
            f"got {wire_dtype!r}")
    return wire_dtype


def _quantize_blocks(x, block: int):
    """Symmetric block quantization along the last axis: pad to a
    multiple of ``block``, one f32 scale (``max|block|``) per feature
    block; codes ``clip(round(x * (127 / scale)))``. Returns ``(codes
    int8 (..., nb, block), scales f32 (..., nb, 1))``."""
    n = x.shape[-1]
    nb = -(-n // block)
    pad = nb * block - n
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    xb = x.reshape(*x.shape[:-1], nb, block)
    scale = torch.clamp(xb.abs().amax(dim=-1, keepdim=True), min=_TINY)
    q8 = torch.clamp(torch.round(xb * (127.0 / scale)), -127, 127)
    return q8.to(torch.int8), scale


def _dequantize_blocks(xb, n: int):
    flat = xb.reshape(*xb.shape[:-2], xb.shape[-2] * xb.shape[-1])
    return flat[..., :n]


def _is_int(x) -> bool:
    return not (x.is_floating_point() or x.is_complex())


def _int8_sum(all_q, all_s):
    """The dequantized rank-order sum of int8 code stacks:
    ``Σ_r q_r * (s_r * (1/127))``."""
    deq = all_q.to(torch.float32) * (all_s * (1.0 / 127.0))
    return _sum_ranks(list(deq))


def allreduce_quantized(xs, op: Op = Op.SUM, axis: str = "data",
                        wire_dtype: str = "f32", block: int = QUANT_BLOCK,
                        mesh=None):
    """:func:`allreduce` with an opt-in quantized wire: integer payloads
    always take the exact int32 wire; ``f32`` is exact; ``bf16`` moves
    bf16 and sums the upcast contributions in one f32 epilog; ``int8``
    moves int8 codes plus block-wise f32 scales (:data:`QUANT_BLOCK`
    features a scale) and sums in one dequantized f32 epilog. Narrow
    wires are SUM-only."""
    resolve_reduce_wire_dtype(wire_dtype)
    x0 = xs[0]
    if _is_int(x0):
        xi = [x.to(torch.int32) for x in xs]
        _count_collective("allreduce_quantized", xi[0])
        return _by_group(xi, axis, mesh,
                         lambda v, _h: _reduce_vals(v, op).to(x0.dtype))
    if wire_dtype == "f32":
        _count_collective("allreduce_quantized", x0)
        return _by_group(xs, axis, mesh, lambda v, _h: _reduce_vals(v, op))
    if op != Op.SUM:
        raise ValueError(f"quantized allreduce wires are SUM-only, got {op}")
    if wire_dtype == "bf16":
        xw = [x.to(torch.bfloat16) for x in xs]
        _count_collective("allreduce_quantized", xw[0])
        return _by_group(xw, axis, mesh, lambda v, _h: _sum_ranks(
            [t.to(torch.float32) for t in v]))
    qs = [_quantize_blocks(x, block) for x in xs]
    _count_collective("allreduce_quantized", qs[0])
    n = x0.shape[-1]
    return _by_group(qs, axis, mesh, lambda v, _h: _dequantize_blocks(
        _int8_sum(torch.stack([q for q, _ in v]),
                  torch.stack([s for _, s in v])), n))


def _alltoall_vals(vals):
    """Rank r receives block r of every rank, stacked in rank order."""
    n = len(vals)
    blocks = [v.reshape(n, v.shape[0] // n, *v.shape[1:]) for v in vals]
    return [torch.stack([b[r] for b in blocks]) for r in range(n)]


def reducescatter_quantized(xs, op: Op = Op.SUM, axis: str = "data",
                            wire_dtype: str = "f32",
                            block: int = QUANT_BLOCK, fold=None,
                            mesh=None):
    """:func:`reducescatter` with an opt-in quantized wire: rank r
    returns the ``op``-reduction of every rank's r-th row block, summed
    in one dequantized f32 epilog on a narrow wire. ``fold`` replaces the
    reduction with the caller's merge over the dequantized ``(R,
    rows/R, ...)`` rank stack (the 2-D grid's top-k scatter-merge)."""
    resolve_reduce_wire_dtype(wire_dtype)
    x0 = xs[0]
    if _is_int(x0):
        xi = [x.to(torch.int32) for x in xs]
        _count_collective("reducescatter_quantized", xi[0])
        stacks = _by_group(xi, axis, mesh, lambda v, _h: [
            s.to(x0.dtype) for s in _alltoall_vals(v)])
    elif wire_dtype == "f32":
        _count_collective("reducescatter_quantized", x0)
        stacks = _by_group(xs, axis, mesh,
                           lambda v, _h: _alltoall_vals(v))
    elif wire_dtype == "bf16":
        xw = [x.to(torch.bfloat16) for x in xs]
        _count_collective("reducescatter_quantized", xw[0])
        stacks = _by_group(xw, axis, mesh, lambda v, _h: [
            s.to(torch.float32) for s in _alltoall_vals(v)])
    else:
        if op != Op.SUM and fold is None:
            raise ValueError(
                f"quantized reducescatter wires are SUM-only, got {op}")
        qs = [_quantize_blocks(x, block) for x in xs]
        _count_collective("reducescatter_quantized", qs[0])
        n = x0.shape[-1]

        def deq(v, _h):
            all_q = _alltoall_vals([q for q, _ in v])
            all_s = _alltoall_vals([s for _, s in v])
            return [_dequantize_blocks(
                q.to(torch.float32) * (s * (1.0 / 127.0)), n)
                for q, s in zip(all_q, all_s)]

        stacks = _by_group(qs, axis, mesh, deq)
    if fold is not None:
        return [fold(st) for st in stacks]
    return [_reduce_vals(list(st), op) for st in stacks]


PROBE_WIRE_DTYPES = ("f32", "bf16", "int8")


def resolve_probe_wire_dtype(wire_dtype: str) -> str:
    if wire_dtype not in PROBE_WIRE_DTYPES:
        raise ValueError(
            f"probe wire_dtype must be one of {PROBE_WIRE_DTYPES}, "
            f"got {wire_dtype!r}")
    return wire_dtype


def allgather_quantized(xs, axis: str = "data", wire_dtype: str = "f32",
                        scale_ref=None, mesh=None):
    """:func:`allgather` of (rows, n) score blocks with an opt-in
    quantized wire, dequantized after the gather: ``f32``/``bf16`` are
    :func:`allgather_wire`; ``int8`` is affine per row — codes
    ``clip(round((x - lo) * (254 / span)) - 127)`` plus the row's
    minimum and range, dequantized as ``(q + 127) * (span * (1/254)) +
    lo``. ``scale_ref`` (a per-slot list) supplies the block the scales
    derive from (the full pre-selection score block), so a candidate's
    code does not depend on which candidates were selected."""
    if wire_dtype != "int8":
        return allgather_wire(xs, axis, wire_dtype, mesh=mesh)
    refs = xs if scale_ref is None else scale_ref
    packed = []
    for x, ref in zip(xs, refs):
        lo = ref.amin(dim=-1, keepdim=True)
        span = torch.clamp(ref.amax(dim=-1, keepdim=True) - lo, min=_TINY)
        q8 = torch.clamp(torch.round((x - lo) * (254.0 / span)) - 127.0,
                         -127, 127).to(torch.int8)
        packed.append((q8, lo, span))
    _count_collective("allgather_quantized", packed[0])

    def deq(v, _h):
        all_q = torch.stack([q for q, _, _ in v]).to(torch.float32)
        all_lo = torch.stack([lo for _, lo, _ in v])
        all_sp = torch.stack([sp for _, _, sp in v])
        return (all_q + 127.0) * (all_sp * (1.0 / 254.0)) + all_lo

    return _by_group(packed, axis, mesh, deq)


def allgatherv(xs, valid_sizes, axis: str = "data", mesh=None):
    """``comms_t::allgatherv``: the padded blocks stacked, with every
    rank's valid size. Returns ``(stacks, sizes)`` per slot."""
    sizes = [torch.as_tensor(v, dtype=torch.int32, device=x.device)
             for v, x in zip(valid_sizes, xs)]
    _count_collective("allgatherv", (xs[0], sizes[0]))
    return (_by_group(xs, axis, mesh, lambda v, _h: torch.stack(v)),
            _by_group(sizes, axis, mesh, lambda v, _h: torch.stack(v)))


def reducescatter(xs, op: Op = Op.SUM, axis: str = "data", mesh=None):
    """``comms_t::reducescatter``: rank r gets the reduction of every
    rank's r-th row block."""
    _count_collective("reducescatter", xs[0])
    return _by_group(xs, axis, mesh, lambda v, _h: [
        _reduce_vals(list(st), op) for st in _alltoall_vals(v)])


def alltoall(xs, axis: str = "data", mesh=None):
    """``comms_t`` alltoall: rank r receives block r of every rank,
    stacked ``(R, rows/R, ...)``."""
    _count_collective("alltoall", xs[0])
    return _by_group(xs, axis, mesh, lambda v, _h: _alltoall_vals(v))


def _permute(vals, perm):
    out = [torch.zeros_like(v) for v in vals]
    for src, dst in perm:
        out[dst] = vals[src]
    return out


def _ring(vals, offset: int):
    n = len(vals)
    return _permute(vals, [(i, (i + offset) % n) for i in range(n)])


def device_send(xs, dest_offset: int = 1, axis: str = "data", mesh=None):
    """Ring send: rank r's value moves to rank (r + dest_offset) % n."""
    _count_collective("device_send", xs[0])
    return _by_group(xs, axis, mesh, lambda v, _h: _ring(v, dest_offset))


def device_recv(xs, src_offset: int = 1, axis: str = "data", mesh=None):
    """Ring recv, the JAX package's ``device_recv``: the same shift as
    :func:`device_send` by ``src_offset``."""
    _count_collective("device_recv", xs[0])
    return _by_group(xs, axis, mesh, lambda v, _h: _ring(v, src_offset))


def device_sendrecv(xs, perm: Sequence[tuple], axis: str = "data",
                    mesh=None):
    """``comms_t::device_sendrecv``: explicit (src, dst) rank pairs; a
    rank nothing is sent to receives zeros (``ppermute``). ``xs`` may
    hold tuples of tensors (each element moves the same way)."""
    _count_collective("device_sendrecv", xs[0])
    perm = list(perm)

    def move(v, _h):
        if isinstance(v[0], tuple):
            cols = [_permute([t[j] for t in v], perm)
                    for j in range(len(v[0]))]
            return [tuple(c[r] for c in cols) for r in range(len(v))]
        return _permute(v, perm)

    return _by_group(xs, axis, mesh, move)


def mark_varying(xs, axis: str = "data"):
    """The JAX package's validity-check marker: nothing to mark here."""
    del axis
    return xs


def barrier(axis: str = "data", mesh=None):
    """``comms_t::barrier``: every slot gets the rank count."""
    m = _mesh(mesh)
    n = m.shape[axis]
    return [torch.tensor(n, dtype=torch.int32, device=d)
            for d in m.slot_devices()]


# ---------------------------------------------------------------------------
# the handle
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Comms:
    """Mesh + axis handle (role of ``std_comms``,
    ``comms/std_comms.hpp:69``, and raft-dask's ``Comms``). ``axis`` is
    the mesh axis this communicator spans; :meth:`split` carves
    sub-communicators out of a multi-axis mesh (``comm_split``)."""

    mesh: Mesh
    axis: str = "data"

    @property
    def size(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def nranks(self) -> int:
        return self.size

    @property
    def process_rank(self) -> int:
        """This process's rank in the ``torch.distributed`` group (0
        outside one)."""
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
        return 0

    def active(self):
        """A scope in which the collectives find this comms' mesh."""
        return _scope(self.mesh)

    # -- placement -----------------------------------------------------

    def shard(self, x: torch.Tensor, spec: P = None) -> list:
        """Split a global tensor per ``spec`` (default: dim 0 over this
        axis) into the per-slot list, each block on its slot's device."""
        spec = P(self.axis) if spec is None else spec
        devs = self.mesh.slot_devices()
        out = []
        for s, dev in enumerate(devs):
            blk = x
            for dim, name in enumerate(spec):
                if name is None:
                    continue
                n = self.mesh.shape[name]
                expect(blk.shape[dim] % n == 0,
                       f"dim {dim} ({blk.shape[dim]}) must divide the "
                       f"{name!r} axis ({n})")
                w = blk.shape[dim] // n
                c = self.mesh.coord(s, name)
                blk = blk.narrow(dim, c * w, w)
            out.append(blk.to(dev))
        return out

    def replicate(self, x: torch.Tensor) -> list:
        """Every slot gets ``x`` (on its device)."""
        return self.shard(x, P())

    def assemble(self, parts: list, spec: P = None) -> torch.Tensor:
        """The global tensor of a per-slot list: the inverse of
        :meth:`shard` (replicated dims read from coordinate 0)."""
        spec = P(self.axis) if spec is None else spec
        names = [n for n in spec if n is not None]

        def collect(fixed: dict, depth: int):
            if depth == len(names):
                for s in range(self.mesh.size):
                    if all(self.mesh.coord(s, a) == fixed.get(a, 0)
                           for a in self.mesh.axis_names):
                        return parts[s]
                raise AssertionError("unreachable")
            name = names[depth]
            dim = list(spec).index(name)
            blocks = [collect({**fixed, name: c}, depth + 1)
                      for c in range(self.mesh.shape[name])]
            return torch.cat([b.to(blocks[0].device) for b in blocks], dim)

        return collect({}, 0)

    def run(self, fn: Callable, *args, in_specs, out_specs):
        """Run ``fn`` over per-slot lists (the ``shard_map`` role): each
        argument is split by its spec (an argument that is already a
        per-slot list passes as it is), ``fn`` gets the lists and may call
        the collectives with ``axis=self.axis``, and each output list is
        assembled by its out spec."""
        if isinstance(in_specs, P):
            in_specs = (in_specs,)
        lists = [a if isinstance(a, list) else self.shard(a, spec)
                 for a, spec in zip(args, in_specs)]
        with self.active():
            outs = fn(*lists)
        if isinstance(out_specs, P):
            return self.assemble(outs, out_specs)
        return tuple(self.assemble(o, spec)
                     for o, spec in zip(outs, out_specs))

    def split(self, axis: str) -> "Comms":
        """Sub-communicator over another axis of the same mesh."""
        if axis not in self.mesh.axis_names:
            raise ValueError(
                f"axis {axis!r} not in mesh {self.mesh.axis_names}")
        return Comms(self.mesh, axis)

    # -- self-tests (role of comms/comms_test.hpp:34-118) --------------

    def _first_device(self):
        return self.mesh.slot_devices()[0]

    def test_allreduce(self) -> bool:
        x = torch.arange(self.size, dtype=torch.float32,
                         device=self._first_device())
        out = self.run(lambda v: allreduce(v, Op.SUM, self.axis), x,
                       in_specs=P(self.axis), out_specs=P(self.axis))
        return bool((out == x.sum()).all())

    def test_bcast(self, root: int = 0) -> bool:
        x = torch.arange(self.size, dtype=torch.float32,
                         device=self._first_device()) + 3
        out = self.run(lambda v: bcast(v, root, self.axis), x,
                       in_specs=P(self.axis), out_specs=P(self.axis))
        return bool((out == x[root]).all())

    def test_pointToPoint_simple_send_recv(self) -> bool:
        x = torch.arange(self.size, dtype=torch.float32,
                         device=self._first_device())
        out = self.run(lambda v: device_send(v, 1, self.axis), x,
                       in_specs=P(self.axis), out_specs=P(self.axis))
        return bool((out == torch.roll(x, 1)).all())
