"""Shared AST machinery for the graftlint rules.

The load-bearing abstraction is the *tensor-name dataflow*: given a
body the executor captures into a CUDA graph (a ``*_fn`` serving impl,
or the closure ``SearchExecutor`` runs between ``capture_begin`` and
``capture_end``), which local names hold tensors? The repo's signature
convention makes the seed set syntactic — tensor operands are
**positional** parameters, unannotated or annotated as tensors;
statics are keyword-only (or annotated otherwise) — and a forward pass
propagates tensor-ness through assignments, treating shape/dtype/device
metadata as laundering (``x.shape[0]`` and ``x.size(0)`` are Python
ints, not device values).
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Sequence, Set, Tuple

# attribute accesses (and metadata methods) that yield static metadata,
# not a device value
METADATA_ATTRS = {"shape", "ndim", "dtype", "size", "itemsize", "device",
                  "is_cuda", "layout", "numel", "dim", "stride",
                  "element_size", "data_ptr", "is_contiguous", "nbytes",
                  "is_floating_point", "requires_grad"}
# calls whose result is static metadata regardless of the arguments
METADATA_FNS = {"len", "isinstance", "type", "getattr", "hasattr",
                "str", "repr", "id", "hash", "callable", "torch.is_tensor",
                "np.shape", "np.ndim", "np.result_type", "np.dtype"}

# serving bodies that follow the ``*_fn`` convention but run eagerly on
# the card by design, so they are not captured (``core/executor.py``
# builds their plans with ``capturable=False``). Like the JAX lint's
# host-side build paths they are outside the capture rules; unlike a
# silent gap, they are named here, each with its reason.
EAGER_BODIES = {
    # the tiered plans read their staging plan on the host and wait on
    # copy-stream events
    "raft_tpu_torch/neighbors/tiered.py": {
        "_tiered_search_fn", "_tiered_search_ragged_fn",
        "_tiered_pq_search_fn", "_tiered_pq_search_ragged_fn",
        "_tiered_bq_search_fn", "_tiered_bq_search_ragged_fn",
    },
    # CAGRA's plain ``torch`` engine: a plan that resolves to it runs
    # eagerly, and its walk stops on a host read of the frontier
    "raft_tpu_torch/neighbors/cagra.py": {"_search_batch_fn"},
}
# annotations that mark a positional parameter as a tensor operand
_TENSOR_ANNOTATIONS = ("Tensor",)


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def call_name(call: ast.Call) -> Optional[str]:
    return dotted(call.func)


def walk_in_order(body: Sequence[ast.stmt]) -> Iterable[ast.stmt]:
    """Statements in source order, recursing into compound statements
    but NOT into nested function/class definitions (separate scopes)."""
    for stmt in body:
        yield stmt
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        for field in ("body", "orelse", "finalbody"):
            yield from walk_in_order(getattr(stmt, field, []) or [])
        for h in getattr(stmt, "handlers", []) or []:
            yield from walk_in_order(h.body)


def value_names(expr: ast.AST) -> Set[str]:
    """Bare names whose *runtime value* the expression consumes.

    Names consumed only through metadata (``x.shape``, ``len(x)``),
    identity checks (``x is None``), or other laundering constructs do
    not count — conditioning on those is shape-static and capture-safe.
    """
    out: Set[str] = set()

    def visit(n: ast.AST, value: bool) -> None:
        if isinstance(n, ast.Name):
            if value and isinstance(n.ctx, ast.Load):
                out.add(n.id)
            return
        if isinstance(n, ast.Attribute):
            visit(n.value, value and n.attr not in METADATA_ATTRS)
            return
        if isinstance(n, ast.Compare):
            identity_only = all(isinstance(op, (ast.Is, ast.IsNot))
                                for op in n.ops)
            visit(n.left, value and not identity_only)
            for c in n.comparators:
                visit(c, value and not identity_only)
            return
        if isinstance(n, ast.Call):
            fname = call_name(n)
            launders = fname in METADATA_FNS
            # the callee itself: `x.astype(...)` consumes x's value
            visit(n.func, value)
            for a in n.args:
                visit(a, value and not launders)
            for kw in n.keywords:
                visit(kw.value, value and not launders)
            return
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            return  # separate scope
        for child in ast.iter_child_nodes(n):
            visit(child, value)

    visit(expr, True)
    return out


def assigned_names(target: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for n in ast.walk(target):
        if isinstance(n, ast.Name):
            out.add(n.id)
    return out


def _is_tensor_annotation(ann: Optional[ast.AST]) -> bool:
    if ann is None:
        return True
    text = ast.unparse(ann)
    return any(t in text for t in _TENSOR_ANNOTATIONS)


def seed_traced_params(fn) -> Set[str]:
    """The repo convention: positional params that are unannotated or
    annotated as tensors hold device values; keyword-only params and
    params annotated otherwise are statics."""
    traced: Set[str] = set()
    args = fn.args
    pos = list(getattr(args, "posonlyargs", [])) + list(args.args)
    for p in pos:
        if p.arg in ("self", "cls", "res"):
            continue
        if _is_tensor_annotation(getattr(p, "annotation", None)):
            traced.add(p.arg)
    if args.vararg is not None \
            and _is_tensor_annotation(args.vararg.annotation):
        traced.add(args.vararg.arg)
    return traced


def traced_names(fn) -> Set[str]:
    """Seed + two forward propagation passes over the body (two passes
    give loop-carried names a chance to converge)."""
    traced = seed_traced_params(fn)
    body = fn.body if isinstance(fn.body, list) else [ast.Return(fn.body)]
    for _ in range(2):
        for stmt in walk_in_order(body):
            if isinstance(stmt, ast.Assign):
                hot = bool(value_names(stmt.value) & traced)
                for t in stmt.targets:
                    names = assigned_names(t)
                    if hot:
                        traced |= names
                    elif isinstance(t, ast.Name):
                        traced.discard(t.id)
            elif isinstance(stmt, ast.AugAssign):
                if value_names(stmt.value) & traced:
                    traced |= assigned_names(stmt.target)
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                if value_names(stmt.value) & traced:
                    traced |= assigned_names(stmt.target)
            elif isinstance(stmt, ast.For):
                if value_names(stmt.iter) & traced:
                    traced |= assigned_names(stmt.target)
    return traced


def nodes(tree: ast.AST) -> List[ast.AST]:
    """Every node of a module's tree in ``ast.walk`` order, listed once
    a tree: the rules walk each module many times."""
    cached = getattr(tree, "_graftlint_nodes", None)
    if cached is None:
        cached = list(ast.walk(tree))
        tree._graftlint_nodes = cached
    return cached


def collect_functions(tree: ast.AST) -> List[ast.FunctionDef]:
    return [n for n in nodes(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _calls_capture(fn) -> bool:
    return any(isinstance(n, ast.Call)
               and isinstance(n.func, ast.Attribute)
               and n.func.attr == "capture_begin"
               for n in ast.walk(fn))


def captured_bodies(tree: ast.AST, rel: str = ""
                    ) -> List[Tuple[ast.AST, Set[str], str]]:
    """Bodies the executor captures into a CUDA graph, with their
    tensor-name sets:

    - ``*_fn`` serving impls (repo naming convention), except the ones
      :data:`EAGER_BODIES` names for ``rel``;
    - the nested defs a function that calls ``graph.capture_begin``
      runs (``SearchExecutor._capture_locked``'s ``body``).

    Returns (node, tensor names, origin tag).
    """
    eager = EAGER_BODIES.get(rel, ())
    out: List[Tuple[ast.AST, Set[str], str]] = []
    seen: Set[int] = set()

    def add(fn, origin):
        if id(fn) not in seen:
            seen.add(id(fn))
            out.append((fn, traced_names(fn), origin))

    for f in collect_functions(tree):
        if f.name.endswith("_fn") and f.name not in eager:
            add(f, "captured")
        if _calls_capture(f):
            nested = {n.name: n for n in walk_in_order(f.body)
                      if isinstance(n, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))}
            called = {call_name(c) for c in ast.walk(f)
                      if isinstance(c, ast.Call)}
            for name, node in nested.items():
                if name in called:
                    add(node, "graph-capture")
    return out
