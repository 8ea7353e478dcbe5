"""R1 capture hazard and R2 graph-buffer aliasing — the capture
discipline defending the executor's one-replay-a-request contract.

R1 has two teeth:

- **capture hazards**: Python control flow on a tensor value inside a
  body the executor captures into a CUDA graph (a ``*_fn`` serving
  impl, or the closure ``SearchExecutor`` runs between
  ``capture_begin`` and ``capture_end``), and ``.item()``/``.tolist()``
  there. On the card a host read inside a capture invalidates it (the
  executor raises); where it slips through, the branch taken for the
  captured request is frozen into the graph and every replay repeats it
  whatever the new request's values are. Shape/metadata conditions
  (``x.ndim == 2``, ``fw is None``, ``x.size(0)``) are static and
  exempt, and so are keyword-only statics (``engine``, ``k``).
  :data:`~raft_tpu_torch.analysis.astutil.EAGER_BODIES` names the
  ``*_fn`` bodies that run eagerly by design (the tiered plans).
- **cache-key discipline**: the executor's cache keys (``_Plan``'s
  ``key=`` tuples and any ``key = (...)`` feeding them) must stay
  hashable statics — a bare list/set/dict display (not folded through
  ``tuple()``/``frozenset()``), or a ``float()``/``int()``/``.item()``
  of runtime data, makes the key unhashable or data-dependent and turns
  every search into a cache miss + capture. The serving frontend's
  coalescing keys (``coalesce_key``/``compat_key``/``ragged_key``/
  ``packing_key`` tuples, ``SearchRequest(compat_key=)``) and every
  return of a key-returning function carry the same contract.

R2 is the port's counterpart of the JAX lint's donation safety.
PyTorch has no donation; the same hazard class — storage reused under a
live reference — is a captured entry's static buffers. A replay writes
its outputs into the same storage every time, and reads its inputs from
the storage the capture saw. So, in every module that captures a graph:

- a captured entry's ``outputs`` leave only through ``.clone()``, taken
  while the executor's lock is held (lexically, or in a private helper
  every caller reaches with the lock held); a reference that escapes is
  overwritten by the next replay;
- ``static_q``/``static_fw``/``static_b``/``static_nv`` are written in
  place (``copy_``/``fill_``); they are bound only in ``__init__`` or
  before ``capture_begin`` in the capturing function — a rebinding after
  capture leaves the graph reading the old storage.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set

from raft_tpu_torch.analysis import astutil, proggraph, rules_locks
from raft_tpu_torch.analysis.core import Finding, Project, rule

_KEY_WRAPPERS = ("tuple", "frozenset")
_BANNED_DISPLAYS = (ast.List, ast.Set, ast.Dict, ast.ListComp,
                    ast.SetComp, ast.DictComp)


def _check_key_expr(f, expr: ast.AST, out: List[Finding]) -> None:
    """Flag unhashable displays and data-dependent scalars in a cache
    key expression."""

    def visit(n: ast.AST, wrapped: bool) -> None:
        if isinstance(n, _BANNED_DISPLAYS) and not wrapped:
            out.append(Finding(
                "R1", f.rel, n.lineno,
                f"unhashable {type(n).__name__.lower()} in an executor "
                "cache key — wrap it in tuple()/frozenset() so the AOT "
                "cache can hash it"))
            return
        if isinstance(n, ast.Call):
            nm = astutil.call_name(n) or ""
            leaf = nm.split(".")[-1]
            if leaf in ("float", "int") and n.args and not isinstance(
                    n.args[0], ast.Constant):
                out.append(Finding(
                    "R1", f.rel, n.lineno,
                    f"{leaf}() of runtime data in an executor cache key "
                    "— keys must be built from hashable statics, not "
                    "values pulled off arrays"))
            if leaf == "item":
                out.append(Finding(
                    "R1", f.rel, n.lineno,
                    ".item() in an executor cache key — a host sync per "
                    "lookup and a data-dependent key"))
            wrapped = wrapped or leaf in _KEY_WRAPPERS
        for child in ast.iter_child_nodes(n):
            visit(child, wrapped)

    visit(expr, False)


@rule("R1", "capture-hazard")
def check_capture_hazard(project: Project) -> Iterable[Finding]:
    """Python control flow on tensor values and .item()/.tolist() inside
    the bodies captured into a CUDA graph, and unhashable /
    data-dependent executor cache keys."""
    out: List[Finding] = []
    for f in project.lib():
        if f.tree is None:
            continue
        for fn, traced, origin in astutil.captured_bodies(f.tree, f.rel):
            name = getattr(fn, "name", "<lambda>")
            body = fn.body if isinstance(fn.body, list) else []
            reads: Set[int] = set()
            for stmt in astutil.walk_in_order(body):
                if isinstance(stmt, (ast.If, ast.While)):
                    hot = astutil.value_names(stmt.test) & traced
                    if hot:
                        kind = ("if" if isinstance(stmt, ast.If)
                                else "while")
                        out.append(Finding(
                            "R1", f.rel, stmt.lineno,
                            f"python `{kind}` on tensor value(s) "
                            f"{sorted(hot)} inside {origin} body "
                            f"'{name}' — the capture freezes one "
                            "request's branch; use torch.where, or hoist "
                            "the decision to a static"))
                elif isinstance(stmt, ast.For):
                    # iterating a tensor (or a list of slot tensors) has
                    # a static trip count; range() over a tensor value
                    # reads it on the host
                    hot = set()
                    for c in ast.walk(stmt.iter):
                        if isinstance(c, ast.Call) \
                                and astutil.call_name(c) == "range":
                            for a in c.args:
                                hot |= astutil.value_names(a) & traced
                    if hot:
                        out.append(Finding(
                            "R1", f.rel, stmt.lineno,
                            f"python `for` over range() of tensor value(s) "
                            f"{sorted(hot)} inside {origin} body "
                            f"'{name}' — the trip count is read on the "
                            "host; loop over a static bound"))
                for node in ast.walk(stmt):
                    if isinstance(node, ast.Call) \
                            and isinstance(node.func, ast.Attribute) \
                            and node.func.attr in ("item", "tolist") \
                            and not node.args \
                            and node.lineno not in reads:
                        reads.add(node.lineno)
                        out.append(Finding(
                            "R1", f.rel, node.lineno,
                            f".{node.func.attr}() inside {origin} body "
                            f"'{name}' — a host read invalidates the "
                            "capture on the card"))

        # cache-key discipline: `_Plan(key=...)` + the serving layer's
        # `SearchRequest(compat_key=...)`, the named key tuples that
        # feed either, and — since the mesh ragged plan family keys on
        # (mesh devices, params-class tuples, wire-knob kw) — every
        # RETURN of a key-returning function (`ragged_key` /
        # `coalesce_key` / `packing_key` / `mesh_key` spellings): a
        # list of device ids or a float() of runtime data in a mesh
        # ragged key is exactly as cache-fatal as in a `_Plan(key=)`
        # expression, and those keys are built in return position
        for node in astutil.nodes(f.tree):
            if isinstance(node, ast.Call):
                nm = astutil.call_name(node) or ""
                if nm.split(".")[-1] in ("_Plan", "SearchRequest"):
                    for kw in node.keywords:
                        if kw.arg in ("key", "compat_key"):
                            _check_key_expr(f, kw.value, out)
            elif isinstance(node, ast.Assign):
                if (len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and node.targets[0].id in (
                            "key", "cache_key", "coalesce_key",
                            "compat_key", "ragged_key", "packing_key",
                            "mesh_ragged_key", "mesh_key")
                        and isinstance(node.value, ast.Tuple)):
                    _check_key_expr(f, node.value, out)
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                # lstrip covers private spellings like _mesh_key — the
                # 2-D mesh identity tuple feeds every dist plan key, so
                # a lossy coercion there is cache-fatal mesh-wide
                if node.name.lstrip("_") in (
                        "ragged_key", "coalesce_key", "packing_key",
                        "mesh_ragged_key", "mesh_key"):
                    for stmt in ast.walk(node):
                        if (isinstance(stmt, ast.Return)
                                and isinstance(stmt.value, (
                                    ast.Tuple, ast.BinOp)
                                    + _BANNED_DISPLAYS)):
                            _check_key_expr(f, stmt.value, out)
    return out


# ---------------------------------------------------------------------------
# R2 — graph-buffer aliasing
# ---------------------------------------------------------------------------

#: a captured entry's static input buffers
STATIC_BUFFERS = ("static_q", "static_fw", "static_b", "static_nv")
#: a captured entry's static outputs
OUTPUTS = "outputs"


def _parents(fn: ast.AST) -> Dict[int, ast.AST]:
    return {id(c): p for p in ast.walk(fn) for c in ast.iter_child_nodes(p)}


def _cloned(node: ast.AST, parents: Dict[int, ast.AST]) -> bool:
    """``node`` (an ``x.outputs`` load) is the receiver chain of a
    ``.clone()`` call — ``x.outputs[0][:n].clone()`` — or an identity
    test (``x.outputs is None``)."""
    cur = node
    while True:
        par = parents.get(id(cur))
        if isinstance(par, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in par.ops):
            return True
        if isinstance(par, ast.Subscript) and par.value is cur:
            cur = par
            continue
        if isinstance(par, ast.Attribute) and par.value is cur:
            if par.attr == "clone":
                call = parents.get(id(par))
                return isinstance(call, ast.Call) and call.func is par
            cur = par
            continue
        return False


def _held_by_node(ctx: "rules_locks._ClassCtx",
                  fn: ast.AST) -> Dict[int, frozenset]:
    """``{id(node): lock ids held}`` for every node of ``fn``'s body
    outside nested defs, from the ``with <lock>:`` blocks around it."""
    out: Dict[int, frozenset] = {}

    def mark(tree: ast.AST, held: frozenset) -> None:
        for n in ast.walk(tree):
            out[id(n)] = held

    def walk(body, held: frozenset) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(stmt, ast.With):
                inner = set(held)
                for item in stmt.items:
                    ld = ctx.lock_for_withitem(item.context_expr)
                    if ld is not None:
                        inner.add(ld.lock_id)
                    else:
                        mark(item.context_expr, held)
                walk(stmt.body, frozenset(inner))
                continue
            for field, value in ast.iter_fields(stmt):
                if field in ("body", "orelse", "finalbody", "handlers"):
                    continue
                for v in value if isinstance(value, list) else [value]:
                    if isinstance(v, ast.AST):
                        mark(v, held)
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if isinstance(sub, list):
                    walk(sub, held)
            for h in getattr(stmt, "handlers", []) or []:
                walk(h.body, held)

    walk(fn.body, frozenset())
    return out


def _capture_line(fn: ast.AST) -> Optional[int]:
    lines = [n.lineno for n in ast.walk(fn)
             if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute)
             and n.func.attr == "capture_begin"]
    return min(lines) if lines else None


def _check_scope(graph, mod, cls, out: List[Finding]) -> None:
    """R2 over one class's methods (or a module's functions)."""
    ctx = rules_locks._ClassCtx(graph, mod, cls)
    members = cls.methods if cls is not None else mod.functions
    scans = {name: rules_locks._scan_function(ctx, fi)
             for name, fi in members.items()}
    escaping: Set[str] = set()
    for scan in scans.values():
        escaping |= scan.self_refs

    def private_ok(name: str) -> bool:
        return name.startswith("_") and not name.startswith("__") \
            and name not in escaping

    entry = rules_locks._entry_held(
        scans, scans.keys(), {ld.lock_id for ld in ctx.locks.values()},
        private_ok)
    owner = f"{cls.name}." if cls is not None else ""
    for name, fi in members.items():
        fn = fi.node
        parents = _parents(fn)
        held = _held_by_node(ctx, fn)
        base = entry.get(name, frozenset())
        capture = _capture_line(fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Attribute) \
                    or (isinstance(node.value, ast.Name)
                        and node.value.id == "self"):
                continue
            if node.attr == OUTPUTS and isinstance(node.ctx, ast.Load):
                if not _cloned(node, parents):
                    out.append(Finding(
                        "R2", mod.rel, node.lineno,
                        f"'{astutil.dotted(node) or OUTPUTS}' leaves "
                        f"{owner}{name} without .clone() — a captured "
                        "entry's outputs are overwritten by the next "
                        "replay; return a clone"))
                elif not (held.get(id(node), frozenset()) | base):
                    out.append(Finding(
                        "R2", mod.rel, node.lineno,
                        f"'{astutil.dotted(node) or OUTPUTS}' is cloned "
                        f"in {owner}{name} without the executor lock "
                        "held — another thread's replay can overwrite "
                        "it mid-copy"))
            elif node.attr in STATIC_BUFFERS \
                    and isinstance(node.ctx, ast.Store) \
                    and name != "__init__" \
                    and (capture is None or node.lineno > capture):
                out.append(Finding(
                    "R2", mod.rel, node.lineno,
                    f"'{astutil.dotted(node) or node.attr}' is rebound "
                    f"in {owner}{name} after capture — the graph keeps "
                    "reading the old storage; write it in place with "
                    "copy_/fill_"))


@rule("R2", "graph-buffer-aliasing", scope="program")
def check_graph_buffers(project: Project) -> Iterable[Finding]:
    """In every module that captures a CUDA graph: a captured entry's
    ``outputs`` leave only through ``.clone()`` under the executor's
    lock, and its static input buffers are never rebound after
    capture."""
    out: List[Finding] = []
    graph = proggraph.get_graph(project)
    for rel, mod in sorted(graph.modules.items()):
        if not any(isinstance(n, ast.Call)
                   and isinstance(n.func, ast.Attribute)
                   and n.func.attr == "capture_begin"
                   for n in ast.walk(mod.tree)):
            continue
        _check_scope(graph, mod, None, out)
        for cls in mod.classes.values():
            _check_scope(graph, mod, cls, out)
    return out
