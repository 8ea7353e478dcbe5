"""R3 — collective discipline.

Every collective of the port goes through the
``raft_tpu_torch.comms.comms`` veneer: it is where the mesh's slot
groups are resolved, where wire-dtype policy is applied, and where the
collective-payload accounting (``comms.<family>.calls``) hooks. A raw
``torch.distributed`` collective anywhere else bypasses all three — it
moves data no counter sees and pairs ranks the mesh does not know.

Checks:

- raw ``torch.distributed`` collectives (``all_reduce``,
  ``all_gather*``, ``broadcast*``, ``reduce_scatter*``,
  ``all_to_all*``, ``send``/``recv``/``isend``/``irecv``, ``barrier``,
  …) anywhere but the veneer module, in every import spelling
  (``torch.distributed.x``, ``import torch.distributed as dist``,
  ``dist = torch.distributed``, ``from torch.distributed import x``)
  and the ``getattr(torch.distributed, "x")`` probe. Rank and world
  queries (``get_rank``, ``get_world_size``, ``is_initialized``) move
  no data and stay clean;
- axis-name literals passed to veneer collectives that name no axis
  this module's meshes declare (a typo'd axis fails only on the path
  a multi-slot test actually reaches).
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set

from raft_tpu_torch.analysis import astutil
from raft_tpu_torch.analysis.core import PACKAGE, Finding, Project, rule

VENEER_REL = PACKAGE + "/comms/comms.py"
DIST_MODULE = "torch.distributed"

# the data-moving members of torch.distributed
DIST_COLLECTIVES = {
    "all_reduce", "broadcast", "reduce", "gather", "scatter",
    "reduce_scatter", "all_to_all", "send", "recv", "isend", "irecv",
    "barrier", "monitored_barrier", "batch_isend_irecv",
}
# families whose variants share a prefix (all_gather_into_tensor,
# reduce_scatter_tensor, all_to_all_single, broadcast_object_list, …)
DIST_PREFIXES = ("all_gather", "reduce_scatter", "all_to_all",
                 "broadcast", "all_reduce")

# veneer function name -> positional index of its axis argument
VENEER_AXIS_POS = {
    "allreduce": 2, "bcast": 2, "reduce": 3, "gather": 2, "allgather": 1,
    "allgather_wire": 1, "allgatherv": 2, "reducescatter": 2,
    "alltoall": 1, "device_send": 2, "device_recv": 2,
    "device_sendrecv": 2, "barrier": 0, "rank": 0, "size": 0,
    "axis_size": 0, "mark_varying": 1, "timed_dispatch": 2,
    "allreduce_quantized": 2, "reducescatter_quantized": 2,
    "allgather_quantized": 1,
}


def is_collective(member: str) -> bool:
    return member in DIST_COLLECTIVES or member.startswith(DIST_PREFIXES)


def _dist_aliases(tree: ast.AST):
    """(names bound to the ``torch.distributed`` module, bare names
    bound to its collectives) in this module — every spelling."""
    mods: Set[str] = {DIST_MODULE}
    bare: Set[str] = set()
    for node in astutil.nodes(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == DIST_MODULE and a.asname:
                    mods.add(a.asname)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "torch":
                for a in node.names:
                    if a.name == "distributed":
                        mods.add(a.asname or a.name)
            elif node.module == DIST_MODULE:
                for a in node.names:
                    if is_collective(a.name):
                        bare.add(a.asname or a.name)
    # `dist = torch.distributed` (module or function scope)
    for node in astutil.nodes(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and astutil.dotted(node.value) in mods:
            mods.add(node.targets[0].id)
    return mods, bare


def _comms_imports(tree: ast.AST) -> Set[str]:
    """Local names this module imported from raft_tpu_torch.comms*."""
    names: Set[str] = set()
    for node in astutil.nodes(tree):
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.startswith(PACKAGE + ".comms"):
            for a in node.names:
                names.add(a.asname or a.name)
    return names


def _str_consts(node: ast.AST):
    for c in ast.walk(node):
        if isinstance(c, ast.Constant) and isinstance(c.value, str):
            yield c.value


def _known_axes(tree: ast.AST) -> Set[str]:
    """Axis names this module's meshes / specs / signatures declare."""
    axes: Set[str] = set()
    for node in astutil.nodes(tree):
        if isinstance(node, ast.Call):
            nm = (astutil.call_name(node) or "").split(".")[-1]
            if nm in ("Mesh", "make_mesh"):
                # Mesh(devices, axis_names) / make_mesh(axis_names, ...)
                pos = 1 if nm == "Mesh" else 0
                if len(node.args) > pos:
                    axes.update(_str_consts(node.args[pos]))
                for kw in node.keywords:
                    if kw.arg in ("axis_names", "axis"):
                        axes.update(_str_consts(kw.value))
            if nm in ("P", "PartitionSpec"):
                for a in node.args:
                    if isinstance(a, ast.Constant) \
                            and isinstance(a.value, str):
                        axes.add(a.value)
            if nm == "Comms" and len(node.args) >= 2 \
                    and isinstance(node.args[1], ast.Constant) \
                    and isinstance(node.args[1].value, str):
                axes.add(node.args[1].value)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # `axis: str = "data"` parameter defaults declare vocabulary
            args = node.args
            pos = args.posonlyargs + args.args
            defaults = args.defaults
            for p, d in zip(pos[len(pos) - len(defaults):], defaults):
                if "axis" in p.arg and isinstance(d, ast.Constant) \
                        and isinstance(d.value, str):
                    axes.add(d.value)
            for p, d in zip(args.kwonlyargs, args.kw_defaults):
                if d is not None and "axis" in p.arg \
                        and isinstance(d, ast.Constant) \
                        and isinstance(d.value, str):
                    axes.add(d.value)
    return axes


def _axis_arg(call: ast.Call, leaf: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == "axis":
            return kw.value
    pos = VENEER_AXIS_POS[leaf]
    if pos < len(call.args):
        return call.args[pos]
    return None


@rule("R3", "collective-discipline")
def check_collectives(project: Project) -> Iterable[Finding]:
    """Raw torch.distributed collectives outside the comms veneer (any
    import spelling); axis-name literals that no mesh in the module
    declares."""
    out: List[Finding] = []
    for f in project.lib():
        if f.tree is None or f.rel == VENEER_REL:
            continue
        mods, bare = _dist_aliases(f.tree)
        for node in astutil.nodes(f.tree):
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.ctx, ast.Load) \
                    and is_collective(node.attr) \
                    and astutil.dotted(node.value) in mods:
                out.append(Finding(
                    "R3", f.rel, node.lineno,
                    f"raw torch.distributed.{node.attr} outside the comms "
                    "veneer — route it through raft_tpu_torch.comms.comms "
                    "so the mesh's groups and payload accounting apply"))
            elif isinstance(node, ast.Call):
                nm = astutil.call_name(node) or ""
                if nm in bare:
                    out.append(Finding(
                        "R3", f.rel, node.lineno,
                        f"raw torch.distributed collective {nm}() outside "
                        "the comms veneer — route it through "
                        "raft_tpu_torch.comms.comms"))
                elif nm == "getattr" and len(node.args) >= 2 \
                        and astutil.dotted(node.args[0]) in mods \
                        and isinstance(node.args[1], ast.Constant) \
                        and isinstance(node.args[1].value, str) \
                        and is_collective(node.args[1].value):
                    out.append(Finding(
                        "R3", f.rel, node.lineno,
                        f"getattr(torch.distributed, "
                        f"{node.args[1].value!r}) probe outside the comms "
                        "veneer — the collective belongs in "
                        "raft_tpu_torch.comms.comms"))

        # axis literal discipline on veneer calls
        veneer_names = _comms_imports(f.tree) & set(VENEER_AXIS_POS)
        axes = _known_axes(f.tree)
        if not axes:
            continue
        for node in astutil.nodes(f.tree):
            if not isinstance(node, ast.Call):
                continue
            nm = astutil.call_name(node) or ""
            leaf = nm.split(".")[-1]
            if leaf not in VENEER_AXIS_POS:
                continue
            # only calls provably bound to the comms veneer
            if not (nm.startswith("comms.") or leaf in veneer_names):
                continue
            arg = _axis_arg(node, leaf)
            if isinstance(arg, ast.Constant) and isinstance(
                    arg.value, str) and arg.value not in axes:
                out.append(Finding(
                    "R3", f.rel, node.lineno,
                    f"collective {leaf}() names axis {arg.value!r} but "
                    f"this module's meshes declare {sorted(axes)} — a "
                    "typo'd axis only fails on the multi-slot path"))
    return out
