"""R9 metric-inventory conformance — ends silent metric/doc drift.

The registry convention names every counter, gauge, and histogram with
a dotted string at the registration site:
``tracing.inc_counter("serving.evictions")``, a module constant
(``CAPTURES = "profiling.captures"``), a prefix composition
(``PREFIX + "batches"``, ``f"{base}list.{lid}"``), or a dict built up
and handed to ``inc_counters``/``set_gauges`` whole. Three artifacts
restate that inventory by hand and drift silently when code moves:

- the **``raft_tpu_torch/METRICS.md`` tables** (the operator contract,
  in ``ARCHITECTURE.md``'s table format; the port keeps its own, since
  it has names the JAX package has not);
- a benchmark gate's **``SNAPSHOT_FLOORS``** (``core.BENCH_GATE``; the
  port has none yet, so this check is quiet);
- the exporter's **``_HELP_PREFIXES``** table (a prefix matching no
  live family is dead HELP text).

R9 extracts every registered metric-name *pattern* (prefix
composition resolved one level deep through the program graph's
constants; unresolvable interpolations become ``*`` wildcards;
fully-dynamic names are dropped, never guessed) and cross-checks:

1. every registered pattern matches a documented pattern — an
   undocumented gauge is a finding at its registration site;
2. every ``SNAPSHOT_FLOORS`` key matches a registered counter;
3. every ``_HELP_PREFIXES`` prefix matches some registered metric.

Doc-side patterns come from the inventory tables' backtick spans with
brace groups expanded (``{a,b}``), placeholders (``<label>``) and
``*`` as wildcards, and the tables' ``/``-continuation shorthand
(`` `profiling.captures` / `.device_ops` ``) resolved. The rule is
quiet when the aux files are absent, so fixture projects opt in via
``Project.from_texts(..., aux=...)``.
"""

from __future__ import annotations

import ast
import functools
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from raft_tpu_torch.analysis import astutil, proggraph
from raft_tpu_torch.analysis.core import (
    BENCH_GATE,
    METRICS_DOC,
    PACKAGE,
    Finding,
    Project,
    rule,
)

#: the exporter whose HELP table is checked
EXPORTER_REL = PACKAGE + "/serving/exporter.py"

_COUNTER_FNS = {"inc_counter", "inc_counters", "max_counter"}
_GAUGE_FNS = {"set_gauge", "set_gauges"}
_HIST_FNS = {"observe", "get_histogram"}
_DICT_FNS = {"inc_counters", "set_gauges"}
_NAME_FNS = (_COUNTER_FNS | _GAUGE_FNS | _HIST_FNS) - _DICT_FNS

_MAX_PATTERNS = 16
_MAX_DEPTH = 6


def _family(leaf: str) -> str:
    if leaf in _COUNTER_FNS:
        return "counter"
    if leaf in _GAUGE_FNS:
        return "gauge"
    return "histogram"


# ---------------------------------------------------------------------------
# pattern algebra
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _compat(a: str, b: str) -> bool:
    """Could ONE concrete metric name match both patterns? ``*`` spans
    any (possibly empty) run of characters on either side."""
    memo: Dict[Tuple[int, int], bool] = {}

    def go(i: int, j: int) -> bool:
        key = (i, j)
        if key in memo:
            return memo[key]
        if i == len(a) and j == len(b):
            r = True
        elif i < len(a) and a[i] == "*":
            r = go(i + 1, j) or (j < len(b) and go(i, j + 1))
        elif j < len(b) and b[j] == "*":
            r = go(i, j + 1) or (i < len(a) and go(i + 1, j))
        elif i < len(a) and j < len(b) and a[i] == b[j]:
            r = go(i + 1, j + 1)
        else:
            r = False
        memo[key] = r
        return r

    return go(0, 0)


def _normalize(p: str) -> Optional[str]:
    """Collapse wildcard runs; drop fully-dynamic patterns (nothing
    literal left to check)."""
    p = re.sub(r"\*+", "*", p.strip())
    if not re.search(r"[A-Za-z0-9]", p.replace("*", "")):
        return None
    return p


def _product(parts: List[Set[str]]) -> Set[str]:
    out = {""}
    for p in parts:
        out = {a + b for a in out for b in p}
        if len(out) > _MAX_PATTERNS:
            out = set(sorted(out)[:_MAX_PATTERNS])
    return out


# ---------------------------------------------------------------------------
# registration extraction
# ---------------------------------------------------------------------------


def _collect_scope(body) -> Tuple[list, Dict[str, list], list, list]:
    """Calls, name assigns, subscript-store keys, and ``.update()``
    sites lexically in one scope (not descending into nested defs)."""
    calls: list = []
    assigns: Dict[str, list] = {}
    subs: list = []          # (var, key expr)
    updates: list = []       # (var, arg expr)
    stack = list(body)
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        if isinstance(n, ast.Call):
            calls.append(n)
            if (isinstance(n.func, ast.Attribute)
                    and n.func.attr == "update"
                    and isinstance(n.func.value, ast.Name) and n.args):
                updates.append((n.func.value.id, n.args[0]))
        if isinstance(n, ast.Assign) and len(n.targets) == 1:
            t = n.targets[0]
            if isinstance(t, ast.Name):
                assigns.setdefault(t.id, []).append((n.lineno, n.value))
            elif isinstance(t, ast.Subscript) and isinstance(
                    t.value, ast.Name):
                subs.append((t.value.id, t.slice))
        if isinstance(n, ast.AugAssign) and isinstance(
                n.target, ast.Subscript) and isinstance(
                    n.target.value, ast.Name):
            subs.append((n.target.value.id, n.target.slice))
        stack.extend(ast.iter_child_nodes(n))
    return calls, assigns, subs, updates


def _patterns(expr, graph, mod, assigns: Dict[str, list],
              visiting: frozenset, depth: int = 0) -> Optional[Set[str]]:
    """Resolve a metric-name expression to patterns (``*`` = dynamic
    part). None = fully dynamic, drop."""
    if expr is None or depth > _MAX_DEPTH:
        return None
    if isinstance(expr, ast.Constant):
        return {expr.value} if isinstance(expr.value, str) else None
    if isinstance(expr, ast.JoinedStr):
        parts: List[Set[str]] = []
        resolved = False
        for v in expr.values:
            if isinstance(v, ast.Constant):
                parts.append({str(v.value)})
                resolved = True
            elif isinstance(v, ast.FormattedValue):
                sub = _patterns(v.value, graph, mod, assigns, visiting,
                                depth + 1)
                if sub:
                    resolved = True
                parts.append(sub or {"*"})
            else:
                parts.append({"*"})
        return _product(parts) if resolved else None
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        left = _patterns(expr.left, graph, mod, assigns, visiting,
                         depth + 1)
        right = _patterns(expr.right, graph, mod, assigns, visiting,
                          depth + 1)
        if left is None and right is None:
            return None
        return _product([left or {"*"}, right or {"*"}])
    if isinstance(expr, ast.IfExp):
        a = _patterns(expr.body, graph, mod, assigns, visiting,
                      depth + 1) or set()
        b = _patterns(expr.orelse, graph, mod, assigns, visiting,
                      depth + 1) or set()
        return (a | b) or None
    if isinstance(expr, ast.Name):
        if expr.id in visiting:
            return None
        inner = visiting | {expr.id}
        # line-aware: a reassigned local (``base = "memory.index..."``
        # … ``base = "memory.device..."``) resolves to the NEAREST
        # preceding assignment, not the union — the union cross-products
        # every prefix with every suffix. No preceding one (loop
        # carry-around) falls back to all of them.
        cands = assigns.get(expr.id, ())
        ref = getattr(expr, "lineno", 0)
        prior = [a for a in cands if a[0] <= ref]
        if prior:
            cands = [max(prior, key=lambda a: a[0])]
        out: Set[str] = set()
        for _ln, v in cands:
            sub = _patterns(v, graph, mod, assigns, inner, depth + 1)
            if sub:
                out |= sub
        if out:
            return out
        g = mod.globals.get(expr.id)
        if g is not None and g.value is not None:
            return _patterns(g.value, graph, mod, {}, inner, depth + 1)
        sym = graph.resolve_symbol(mod, expr.id)
        return {sym} if isinstance(sym, str) else None
    if isinstance(expr, ast.Attribute):
        name = astutil.dotted(expr)
        if name is None:
            return None
        s = graph.string_constant(mod, expr)
        if s is not None:
            return {s}
        # `alias.CONST` where CONST is a composed (non-literal) global
        parts = name.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            ref = mod.imports.get(".".join(parts[:cut]))
            if (ref is not None and ref[0] == "module"
                    and len(parts) - cut == 1):
                target = graph._lookup_module(ref[1])
                if target is not None:
                    g = target.globals.get(parts[-1])
                    if g is not None and g.value is not None:
                        return _patterns(g.value, graph, target, {},
                                         visiting, depth + 1)
        return None
    return None


def _callee_dict_keys(graph, callee: proggraph.FunctionInfo
                      ) -> Set[str]:
    """One level into a dict-returning helper: every dict-display key
    and subscript-store key in its body (over-approximates, which is
    safe — these names ARE registered when the helper's result is)."""
    mod = graph.modules.get(callee.rel)
    if mod is None:
        return set()
    _calls, assigns, subs, _updates = _collect_scope(callee.node.body)
    keys: Set[str] = set()
    for node in ast.walk(callee.node):
        if isinstance(node, ast.Dict):
            for k in node.keys:
                keys |= _patterns(k, graph, mod, assigns,
                                  frozenset()) or set()
        elif isinstance(node, ast.DictComp):
            keys |= _patterns(node.key, graph, mod, assigns,
                              frozenset()) or set()
    for var, key in subs:
        keys |= _patterns(key, graph, mod, assigns, frozenset()) or set()
    return keys


def _dict_key_patterns(expr, graph, mod, assigns, subs, updates,
                       resolve_call, depth: int = 0) -> Set[str]:
    """Metric-name patterns for a dict handed to
    ``inc_counters``/``set_gauges``: a display, a comprehension, a
    local accumulator (``vals = {...}``, ``vals[k] = v``,
    ``vals.update(helper())``), or a dict-returning helper call."""
    if depth > 2 or expr is None:
        return set()
    keys: Set[str] = set()
    if isinstance(expr, ast.Dict):
        for k in expr.keys:
            keys |= _patterns(k, graph, mod, assigns,
                              frozenset()) or set()
    elif isinstance(expr, ast.DictComp):
        keys |= _patterns(expr.key, graph, mod, assigns,
                          frozenset()) or set()
    elif isinstance(expr, ast.Name):
        for _ln, v in assigns.get(expr.id, ()):
            keys |= _dict_key_patterns(v, graph, mod, assigns, subs,
                                       updates, resolve_call, depth + 1)
        for var, key in subs:
            if var == expr.id:
                keys |= _patterns(key, graph, mod, assigns,
                                  frozenset()) or set()
        for var, arg in updates:
            if var == expr.id:
                keys |= _dict_key_patterns(arg, graph, mod, assigns,
                                           subs, updates, resolve_call,
                                           depth + 1)
    elif isinstance(expr, ast.Call):
        callee = resolve_call(expr)
        if callee is not None:
            keys |= _callee_dict_keys(graph, callee)
    return keys


def registered_metrics(project: Project
                       ) -> List[Tuple[str, str, str, int]]:
    """Every metric-name pattern the library registers:
    ``(pattern, family, rel, lineno)`` — cached on the project."""
    cached = getattr(project, "_metric_inventory", None)
    if cached is not None:
        return cached
    graph = proggraph.get_graph(project)
    regs: List[Tuple[str, str, str, int]] = []
    for f in project.lib():
        if f.tree is None or f.rel not in graph.modules:
            continue
        mod = graph.modules[f.rel]
        scopes = [f.tree] + astutil.collect_functions(f.tree)
        for scope in scopes:
            body = scope.body if isinstance(scope.body, list) else []
            calls, assigns, subs, updates = _collect_scope(body)

            def resolve_call(call, _mod=mod):
                func = call.func
                if isinstance(func, ast.Name):
                    sym = graph.resolve_symbol(_mod, func.id)
                elif isinstance(func, ast.Attribute):
                    sym = graph.resolve_attr(
                        _mod, astutil.dotted(func) or "")
                else:
                    sym = None
                return sym if isinstance(
                    sym, proggraph.FunctionInfo) else None

            for call in calls:
                leaf = (astutil.call_name(call) or "").split(".")[-1]
                if leaf not in _NAME_FNS and leaf not in _DICT_FNS:
                    continue
                if not call.args:
                    continue
                fam = _family(leaf)
                if leaf in _DICT_FNS:
                    pats = _dict_key_patterns(
                        call.args[0], graph, mod, assigns, subs,
                        updates, resolve_call)
                else:
                    pats = _patterns(call.args[0], graph, mod, assigns,
                                     frozenset()) or set()
                for p in pats:
                    norm = _normalize(p)
                    if norm is not None:
                        regs.append((norm, fam, f.rel, call.lineno))
    project._metric_inventory = regs
    return regs


# ---------------------------------------------------------------------------
# documentation-side inventories
# ---------------------------------------------------------------------------

_SPAN_RE = re.compile(r"`([^`]+)`")
_PATTERN_OK_RE = re.compile(r"^[A-Za-z0-9_.*:-]+$")


def _expand_braces(s: str) -> Set[str]:
    m = re.search(r"\{([^{}]*)\}", s)
    if m is None:
        return {s}
    out: Set[str] = set()
    for alt in m.group(1).split(","):
        out |= _expand_braces(s[:m.start()] + alt.strip() + s[m.end():])
    return out


def _span_pieces(span: str, prev: Optional[str]) -> List[str]:
    """Resolve the tables' ``/``-continuation shorthand:
    `` `fleet.scrapes` / `.scrape_errors` `` and in-span
    ``coverage_p01/p10`` both complete against the previous name."""
    out: List[str] = []
    for piece in span.split("/"):
        piece = piece.strip()
        if not piece:
            continue
        if piece.startswith(".") and prev and "." in prev:
            piece = prev.rsplit(".", 1)[0] + piece
        elif piece.startswith("_") and prev and "_" in prev:
            piece = prev.rsplit("_", 1)[0] + piece
        elif out and prev:
            # bare alternative ("p10"): swap the previous name's last
            # _-or-.-separated component
            cut = max(prev.rfind("_"), prev.rfind("."))
            if cut >= 0:
                piece = prev[:cut + 1] + piece
        out.append(piece)
        prev = piece
    return out


def doc_patterns(text: str) -> Set[str]:
    """Metric patterns documented in the markdown inventory tables."""
    pats: Set[str] = set()
    prev: Optional[str] = None
    for line in text.splitlines():
        if not line.lstrip().startswith("|"):
            continue
        prev = None
        for m in _SPAN_RE.finditer(line):
            for piece in _span_pieces(m.group(1), prev):
                prev = piece
                for raw in _expand_braces(piece):
                    p = re.sub(r"<[^<>]*>", "*", raw)
                    if "." not in p or not _PATTERN_OK_RE.match(p):
                        continue
                    norm = _normalize(p)
                    if norm is not None:
                        pats.add(norm)
    return pats


def _snapshot_floors(text: str) -> List[Tuple[str, int]]:
    try:
        tree = ast.parse(text)
    except SyntaxError:
        return []
    for node in astutil.nodes(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "SNAPSHOT_FLOORS"
                and isinstance(node.value, ast.Dict)):
            return [(k.value, k.lineno) for k in node.value.keys
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str)]
    return []


def _help_prefixes(tree) -> List[Tuple[str, int]]:
    for node in astutil.nodes(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "_HELP_PREFIXES"
                and isinstance(node.value, (ast.Tuple, ast.List))):
            out = []
            for el in node.value.elts:
                if (isinstance(el, (ast.Tuple, ast.List)) and el.elts
                        and isinstance(el.elts[0], ast.Constant)
                        and isinstance(el.elts[0].value, str)):
                    out.append((el.elts[0].value, el.lineno))
            return out
    return []


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------


@rule("R9", "metric-inventory", scope="program")
def check_metric_inventory(project: Project) -> Iterable[Finding]:
    """Registered metric names, the raft_tpu_torch/METRICS.md inventory
    tables, a bench gate's ``SNAPSHOT_FLOORS``, and the exporter HELP
    table must agree."""
    regs = registered_metrics(project)
    out: List[Finding] = []

    arch = project.aux.get(METRICS_DOC)
    if arch is not None and regs:
        docs = doc_patterns(arch)
        seen: Set[Tuple[str, str]] = set()
        for pattern, fam, rel, line in regs:
            if (pattern, fam) in seen:
                continue
            seen.add((pattern, fam))
            if not any(_compat(pattern, d) for d in docs):
                out.append(Finding(
                    "R9", rel, line,
                    f"{fam} '{pattern}' is registered here but matches "
                    "nothing in the METRICS.md metric inventory "
                    "tables — document it or retire it"))

    bench = project.aux.get(BENCH_GATE)
    if bench is not None and regs:
        counters = {p for p, fam, _r, _l in regs if fam == "counter"}
        for key, line in _snapshot_floors(bench):
            if not any(_compat(key, p) for p in counters):
                out.append(Finding(
                    "R9", BENCH_GATE, line,
                    f"SNAPSHOT_FLOORS names '{key}' but no code path "
                    "registers that counter — the floor can never be "
                    "exercised"))

    exporter = project.by_rel.get(EXPORTER_REL)
    if exporter is not None and exporter.tree is not None and regs:
        everything = {p for p, _f, _r, _l in regs}
        for prefix, line in _help_prefixes(exporter.tree):
            if not any(_compat(prefix + "*", p) for p in everything):
                out.append(Finding(
                    "R9", exporter.rel, line,
                    f"_HELP_PREFIXES entry '{prefix}' matches no "
                    "registered metric family — dead HELP text"))
    return out
