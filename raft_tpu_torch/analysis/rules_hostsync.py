"""R5 — host-sync lint for the serving hot path.

A captured request costs one replay; one stray host read on the serving
path turns it back into a blocking round trip per call (``.item()`` in
a scan loop serializes every dispatch), and inside a captured body it
makes the capture itself raise on the card. A tensor placed on the
device inside a Python loop issues one copy per iteration where one
batched copy would do.

Scope — the hot modules of the serving stack: ``core/executor.py``,
``core/memwatch.py`` (its watermark sample runs per dispatch),
``raft_tpu_torch/ops/*``, ``raft_tpu_torch/distributed/*`` (except
``checkpoint.py``, the host-IO module by design),
``raft_tpu_torch/neighbors/*``, ``raft_tpu_torch/serving/*`` and
``raft_tpu_torch/fleet/*``. Within them:

- inside the serving scopes — the bodies the executor captures
  (:func:`~raft_tpu_torch.analysis.astutil.captured_bodies`) and the
  host-side ``search*`` entries, less the eager-by-design bodies
  :data:`~raft_tpu_torch.analysis.astutil.EAGER_BODIES` names:
  ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``torch.cuda.synchronize()``, ``np.asarray`` /
  ``np.array``, and ``float()`` / ``int()`` / ``bool()`` of tensor
  values or a truth test of ``.any()`` / ``.all()`` on them
  (``Tensor.__bool__``) — host fetches the steady state must not pay
  (build/save/load paths are host-side by contract and exempt);
- anywhere in a hot module: ``.to("cpu")`` and ``torch.tensor(...,
  device=...)`` inside a ``for``/``while`` loop — one transfer per
  iteration; batch them into one call per step.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Set

from raft_tpu_torch.analysis import astutil
from raft_tpu_torch.analysis.core import PACKAGE, Finding, Project, rule

HOT_PREFIXES = tuple(f"{PACKAGE}/{d}/" for d in (
    "ops", "distributed", "neighbors", "serving", "fleet"))
# the executor dispatches every request; the memory ledger's watermark
# sample runs on its dispatch path
HOT_FILES = (f"{PACKAGE}/core/executor.py", f"{PACKAGE}/core/memwatch.py")
EXEMPT = (f"{PACKAGE}/distributed/checkpoint.py",)

# tensor methods that copy device data to the host and wait for it
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_SYNC_CALLS = {"torch.cuda.synchronize", "cuda.synchronize"}
_FETCH_CALLS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
# reductions whose truth value is read on the host
_TRUTH_METHODS = {"any", "all"}


def _is_hot(rel: str) -> bool:
    if rel in EXEMPT:
        return False
    return rel in HOT_FILES or rel.startswith(HOT_PREFIXES)


def _serving_scopes(tree: ast.AST, rel: str):
    """Captured bodies plus host-side ``search*`` orchestration."""
    scopes = list(astutil.captured_bodies(tree, rel))
    seen = {id(fn) for fn, _, _ in scopes}
    eager = astutil.EAGER_BODIES.get(rel, ())
    for fn in astutil.collect_functions(tree):
        if id(fn) not in seen and fn.name not in eager and (
                fn.name == "search"
                                   or fn.name.startswith("search_")
                                   or fn.name.startswith("_search")):
            scopes.append((fn, astutil.traced_names(fn), "search-entry"))
    return scopes


def _truth_tests(stmt: ast.AST):
    """Expressions whose truth value Python reads in ``stmt``."""
    if isinstance(stmt, (ast.If, ast.While, ast.Assert)):
        yield stmt.test
    for n in ast.walk(stmt):
        if isinstance(n, ast.BoolOp):
            yield from n.values
        elif isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.Not):
            yield n.operand
        elif isinstance(n, ast.IfExp):
            yield n.test


def _is_transfer(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` / ``torch.tensor(...,
    device=...)``."""
    nm = astutil.call_name(call) or ""
    if isinstance(call.func, ast.Attribute) and call.func.attr == "to":
        vals = list(call.args[:1]) + [kw.value for kw in call.keywords
                                      if kw.arg == "device"]
        return any(isinstance(v, ast.Constant) and v.value == "cpu"
                   for v in vals)
    return nm in ("torch.tensor", "torch.as_tensor") and any(
        kw.arg == "device" for kw in call.keywords)


@rule("R5", "host-sync")
def check_host_sync(project: Project) -> Iterable[Finding]:
    """Host round-trips (.item/.tolist/.cpu/.numpy, cuda.synchronize,
    np.asarray, float/int/bool or truth of tensor values) in the
    serving scopes of the hot modules, and per-iteration transfers in
    their loops."""
    out: List[Finding] = []
    for f in project.lib():
        if f.tree is None or not _is_hot(f.rel):
            continue

        # per-iteration transfers inside python loops
        reported_loop: Set[int] = set()
        for loop in astutil.nodes(f.tree):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            for node in ast.walk(loop):
                if node is loop or not isinstance(node, ast.Call) \
                        or id(node) in reported_loop:
                    continue
                if _is_transfer(node):
                    reported_loop.add(id(node))
                    out.append(Finding(
                        "R5", f.rel, node.lineno,
                        "device transfer inside a python loop — one copy "
                        "per iteration; batch the transfers into one "
                        "call per step"))

        # host reads inside serving scopes
        for fn, traced, origin in _serving_scopes(f.tree, f.rel):
            body = fn.body if isinstance(fn.body, list) else []
            where = f"{origin} '{getattr(fn, 'name', '<lambda>')}'"
            reported: Set[int] = set()

            def flag(node, msg):
                if node.lineno not in reported:
                    reported.add(node.lineno)
                    out.append(Finding("R5", f.rel, node.lineno, msg))

            for stmt in astutil.walk_in_order(body):
                for test in _truth_tests(stmt):
                    if isinstance(test, ast.Call) \
                            and isinstance(test.func, ast.Attribute) \
                            and test.func.attr in _TRUTH_METHODS:
                        hot = astutil.value_names(test.func.value) & traced
                        if hot:
                            flag(test, f"truth of .{test.func.attr}() of "
                                 f"tensor value(s) {sorted(hot)} inside "
                                 f"{where} — Tensor.__bool__ waits for the "
                                 "device; keep the decision on device")
                for node in ast.walk(stmt):
                    if not isinstance(node, ast.Call):
                        continue
                    nm = astutil.call_name(node) or ""
                    if isinstance(node.func, ast.Attribute) \
                            and node.func.attr in _SYNC_METHODS \
                            and not node.args:
                        flag(node, f".{node.func.attr}() inside {where} — "
                             "a blocking host read per call on the "
                             "serving path")
                    elif nm in _SYNC_CALLS:
                        flag(node, f"{nm}() inside {where} — blocks the "
                             "host on the whole device per call")
                    elif nm in _FETCH_CALLS:
                        flag(node, f"{nm}() inside {where} — fetches "
                             "device data to host on the serving path")
                    elif nm in ("float", "int", "bool") and node.args:
                        hot = astutil.value_names(node.args[0]) & traced
                        if hot:
                            flag(node, f"{nm}() of tensor value(s) "
                                 f"{sorted(hot)} inside {where} — forces "
                                 "a device sync; keep it as a tensor")
    return out
