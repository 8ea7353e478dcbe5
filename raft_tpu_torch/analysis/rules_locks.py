"""R8 — lock discipline: the serving stack's concurrency contracts as
a machine-checked annotation convention plus a static lock-order graph.

**Guarded state.** An instance field (or module global) whose mutations
the code protects with a lock carries a ``# guarded-by: <lockname>``
trailing comment on its initialising assignment::

    def __init__(self):
        self._lock = threading.Lock()
        self._groups = {}      # guarded-by: _lock
        self._n = 0            # guarded-by: _lock

Every later read or write of ``self._groups`` must then happen with
``self._lock`` held — lexically inside ``with self._lock:``, or inside
a private helper (leading underscore) whose *every* intra-class call
site holds the lock (resolved through the program graph's self-call
edges, so the ``_flush_locked()`` idiom conforms without annotations).
``__init__``/``__del__`` are exempt (construction/teardown
happen-before publication). Public methods never inherit a caller's
lock — they are the API surface, and the analyzer cannot see external
callers.

**Lock order.** Every ``with``-acquisition while another known lock is
held — including acquisitions transitively reachable through resolved
intra-repo calls — is an edge in a static lock-acquisition graph. A
cycle in that graph is a lint failure (a latent lock-order inversion),
and acquiring a non-reentrant ``threading.Lock`` while already holding
it is a self-deadlock finding. The graph dumps as JSON via
``--lockgraph``.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterable, List, Optional, Set, Tuple

from raft_tpu_torch.analysis import proggraph
from raft_tpu_torch.analysis.core import Finding, Project, rule

EXEMPT_METHODS = {"__init__", "__del__"}


@dataclasses.dataclass
class LockDef:
    """One known lock object (class field or module global)."""

    lock_id: str           # "<rel>::Class.name" / "<rel>::name"
    name: str              # attribute / global name
    kind: str              # Lock | RLock | Condition
    rel: str
    lineno: int


@dataclasses.dataclass
class _Access:
    name: str              # guarded field / global
    lineno: int
    store: bool
    held: frozenset


@dataclasses.dataclass
class _Scan:
    """Everything one function walk produced."""

    accesses: List[_Access] = dataclasses.field(default_factory=list)
    self_calls: List[Tuple[str, int, frozenset]] = dataclasses.field(
        default_factory=list)
    calls: List[Tuple[str, int, frozenset]] = dataclasses.field(
        default_factory=list)    # resolved callee qualname
    acquires: List[Tuple[str, int, frozenset]] = dataclasses.field(
        default_factory=list)    # lock_id, line, held-before
    self_refs: Set[str] = dataclasses.field(default_factory=set)
    local_calls: List[Tuple[str, int, frozenset]] = dataclasses.field(
        default_factory=list)    # bare-name module-local calls


def _lock_kind(value: ast.AST) -> Optional[str]:
    if not isinstance(value, ast.Call):
        return None
    name = (proggraph._dotted(value.func) or "").split(".")[-1]
    if name in ("Lock", "RLock", "Condition"):
        return name
    if name == "field":  # dataclasses.field(default_factory=…Lock)
        for kw in value.keywords:
            if kw.arg == "default_factory":
                fac = (proggraph._dotted(kw.value) or "").split(".")[-1]
                if fac in ("Lock", "RLock", "Condition"):
                    return fac
    return None


class _ClassCtx:
    """Lock/guard inventory for one class (or one module's globals)."""

    def __init__(self, graph, mod, cls: Optional[proggraph.ClassInfo]):
        self.graph = graph
        self.mod = mod
        self.cls = cls
        self.locks: Dict[str, LockDef] = {}     # local name → def
        self.guards: Dict[str, str] = {}        # field/global → lock name
        fields = cls.fields if cls is not None else mod.globals
        scope = f"{mod.rel}::{cls.name}." if cls is not None \
            else f"{mod.rel}::"
        for name, fi in fields.items():
            kind = _lock_kind(fi.value) if fi.value is not None else None
            if kind is not None:
                self.locks[name] = LockDef(
                    lock_id=scope + name, name=name, kind=kind,
                    rel=mod.rel, lineno=fi.lineno)
            if fi.guarded_by is not None:
                self.guards[name] = fi.guarded_by
        # module-level locks are acquirable from methods too
        if cls is not None:
            for name, fi in mod.globals.items():
                kind = _lock_kind(fi.value) if fi.value is not None \
                    else None
                if kind is not None and name not in self.locks:
                    self.locks[name] = LockDef(
                        lock_id=f"{mod.rel}::{name}", name=name,
                        kind=kind, rel=mod.rel, lineno=fi.lineno)

    def lock_for_withitem(self, expr: ast.AST) -> Optional[LockDef]:
        # with self._lock:
        if self.cls is not None and isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self":
            return self.locks.get(expr.attr)
        # with _MODULE_LOCK:
        if isinstance(expr, ast.Name):
            ld = self.locks.get(expr.id)
            if ld is not None and "." not in ld.lock_id.split("::")[1]:
                return ld
            # class ctx: module lock by bare name
            if self.cls is not None:
                return self.locks.get(expr.id)
        return None


def _scan_function(ctx: _ClassCtx, fn: proggraph.FunctionInfo) -> _Scan:
    """Walk ``fn`` tracking the lexically-held lock set."""
    scan = _Scan()
    graph = ctx.graph
    guarded = set(ctx.guards)
    is_method = ctx.cls is not None

    # names that shadow guarded globals inside this function
    shadowed: Set[str] = set()
    if not is_method:
        declared_global: Set[str] = set()
        for n in ast.walk(fn.node):
            if isinstance(n, (ast.Global, ast.Nonlocal)):
                declared_global.update(n.names)
        params = fn.node.args
        for a in (params.posonlyargs + params.args + params.kwonlyargs
                  + ([params.vararg] if params.vararg else [])
                  + ([params.kwarg] if params.kwarg else [])):
            shadowed.add(a.arg)
        for n in ast.walk(fn.node):
            if isinstance(n, ast.Name) and isinstance(
                    n.ctx, (ast.Store, ast.Del)) \
                    and n.id not in declared_global:
                shadowed.add(n.id)
        shadowed -= declared_global

    def visit_expr(expr: ast.AST, held: frozenset) -> None:
        # an Attribute that is the func of a Call is an invocation,
        # not a value reference — exclude it from self_refs
        call_funcs = {id(c.func) for c in ast.walk(expr)
                      if isinstance(c, ast.Call)}
        for n in ast.walk(expr):
            if isinstance(n, (ast.Lambda, ast.FunctionDef,
                              ast.AsyncFunctionDef)):
                continue
            if is_method and isinstance(n, ast.Attribute) \
                    and isinstance(n.value, ast.Name) \
                    and n.value.id == "self":
                if n.attr in guarded:
                    scan.accesses.append(_Access(
                        n.attr, n.lineno,
                        isinstance(n.ctx, (ast.Store, ast.Del)), held))
                elif n.attr in (ctx.cls.methods if ctx.cls else {}) \
                        and id(n) not in call_funcs:
                    scan.self_refs.add(n.attr)
            if not is_method and isinstance(n, ast.Name) \
                    and n.id in guarded and n.id not in shadowed:
                scan.accesses.append(_Access(
                    n.id, n.lineno,
                    isinstance(n.ctx, (ast.Store, ast.Del)), held))
            if isinstance(n, ast.Call):
                callee = graph.resolve_call(fn, n)
                if callee is not None:
                    scan.calls.append((callee.qualname, n.lineno, held))
                if is_method and isinstance(n.func, ast.Attribute) \
                        and isinstance(n.func.value, ast.Name) \
                        and n.func.value.id == "self":
                    scan.self_calls.append((n.func.attr, n.lineno, held))
                elif not is_method and isinstance(n.func, ast.Name):
                    scan.local_calls.append((n.func.id, n.lineno, held))

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
                        scan.acquires.append(
                            (ld.lock_id, stmt.lineno, frozenset(inner)))
                        inner.add(ld.lock_id)
                    else:
                        visit_expr(item.context_expr, frozenset(inner))
                walk(stmt.body, frozenset(inner))
                continue
            for field in ("test", "iter", "value", "exc", "msg"):
                sub = getattr(stmt, field, None)
                if isinstance(sub, ast.AST):
                    visit_expr(sub, held)
            if isinstance(stmt, ast.Expr):
                visit_expr(stmt.value, held)
            elif isinstance(stmt, (ast.Assign, ast.AugAssign,
                                   ast.AnnAssign)):
                targets = stmt.targets if isinstance(stmt, ast.Assign) \
                    else [stmt.target]
                for t in targets:
                    visit_expr(t, held)
            elif isinstance(stmt, (ast.Return, ast.Delete)):
                for sub in getattr(stmt, "targets", []):
                    visit_expr(sub, held)
            elif isinstance(stmt, ast.For):
                visit_expr(stmt.target, held)
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if isinstance(sub, list):
                    walk(sub, held)
            for h in getattr(stmt, "handlers", []) or []:
                walk(h.body, held)
    walk(fn.node.body, frozenset())
    return scan


def _entry_held(scans: Dict[str, _Scan], names: Iterable[str],
                all_locks: Set[str], private_ok) -> Dict[str, frozenset]:
    """Fixed point: the lock set guaranteed held at each function's
    entry — the intersection over every intra-scope call site's
    effective held set. Only private (underscore) helpers that are
    exclusively called (never referenced as values) qualify; everyone
    else is an entry point with nothing guaranteed."""
    names = list(names)
    entry = {n: frozenset(all_locks) if private_ok(n) else frozenset()
             for n in names}
    for _ in range(len(names) + 1):
        changed = False
        incoming: Dict[str, List[frozenset]] = {}
        for caller, scan in scans.items():
            base = entry.get(caller, frozenset())
            for callee, _line, held in scan.self_calls \
                    + scan.local_calls:
                if callee in entry:
                    incoming.setdefault(callee, []).append(held | base)
        for n in names:
            if not private_ok(n):
                continue
            sites = incoming.get(n)
            new = frozenset.intersection(*sites) if sites \
                else frozenset()
            if new != entry[n]:
                entry[n] = new
                changed = True
        if not changed:
            break
    return entry


def _analyze_scope(graph, mod, cls, out: List[Finding],
                   lock_graph: "LockGraph") -> None:
    ctx = _ClassCtx(graph, mod, cls)
    if cls is not None:
        members = cls.methods
    else:
        members = mod.functions
    if not ctx.guards and not ctx.locks:
        return
    lock_by_name = ctx.locks
    for ld in lock_by_name.values():
        lock_graph.add_lock(ld)

    # annotation hygiene: guarded-by must name a known lock in scope
    fields = cls.fields if cls is not None else mod.globals
    for fname, lname in ctx.guards.items():
        if lname not in lock_by_name:
            where = f"{cls.name}.{fname}" if cls is not None else fname
            out.append(Finding(
                "R8", mod.rel, fields[fname].lineno,
                f"'{where}' is annotated guarded-by: {lname}, but no "
                f"lock of that name exists in scope — name a "
                "threading.Lock/RLock/Condition field or module lock"))

    scans = {name: _scan_function(ctx, fn)
             for name, fn in members.items()}

    # a method referenced as a value (callback) can be called from
    # anywhere — it never inherits a caller's lock
    escaping: Set[str] = set()
    for scan in scans.values():
        escaping |= scan.self_refs

    def private_ok(name: str) -> bool:
        return name.startswith("_") and not name.startswith("__") \
            and name not in escaping

    all_lock_ids = {ld.lock_id for ld in lock_by_name.values()}
    entry = _entry_held(scans, scans.keys(), all_lock_ids, private_ok)

    guarded_locks = {f: lock_by_name[ln].lock_id
                     for f, ln in ctx.guards.items()
                     if ln in lock_by_name}
    owner = f"{cls.name}." if cls is not None else ""
    spell = "self." if cls is not None else ""
    for name, scan in scans.items():
        if name in EXEMPT_METHODS:
            continue
        base = entry.get(name, frozenset())
        flagged: Set[str] = set()
        for acc in scan.accesses:
            need = guarded_locks.get(acc.name)
            if need is None or need in acc.held or need in base \
                    or acc.name in flagged:
                continue
            flagged.add(acc.name)
            lockname = ctx.guards[acc.name]
            verb = "write" if acc.store else "read"
            out.append(Finding(
                "R8", mod.rel, acc.lineno,
                f"{verb} of '{spell}{acc.name}' (guarded-by "
                f"{lockname}) in {owner}{name} without holding "
                f"{spell}{lockname} — wrap it in `with "
                f"{spell}{lockname}:` or reach it only from call "
                "sites that hold the lock"))
        # lock-order edges: direct acquisitions under held locks,
        # plus held-at-call-site edges resolved interprocedurally
        fn = members[name]
        for lock_id, line, held_before in scan.acquires:
            lock_graph.add_acquire(fn.qualname, lock_id, mod.rel, line,
                                   held_before | base)
        for callee, line, held in scan.calls:
            eff = held | base
            if eff:
                lock_graph.add_call(fn.qualname, callee, mod.rel, line,
                                    eff)


class LockGraph:
    """The static lock-acquisition graph: nodes = known locks, edges =
    'acquired while holding', resolved through the call graph."""

    def __init__(self):
        self.locks: Dict[str, LockDef] = {}
        #: direct acquisitions per function qualname
        self._acquires: Dict[str, List[Tuple[str, str, int, frozenset]]]\
            = {}
        #: call sites under held locks
        self._calls: List[Tuple[str, str, str, int, frozenset]] = []
        self.edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
        self.self_deadlocks: List[Tuple[str, str, int]] = []

    def add_lock(self, ld: LockDef) -> None:
        self.locks.setdefault(ld.lock_id, ld)

    def add_acquire(self, fn_qual: str, lock_id: str, rel: str,
                    line: int, held: frozenset) -> None:
        self._acquires.setdefault(fn_qual, []).append(
            (lock_id, rel, line, held))
        for h in held:
            self._edge(h, lock_id, rel, line)

    def add_call(self, fn_qual: str, callee_qual: str, rel: str,
                 line: int, held: frozenset) -> None:
        self._calls.append((fn_qual, callee_qual, rel, line, held))

    def _edge(self, frm: str, to: str, rel: str, line: int) -> None:
        if frm == to:
            kind = self.locks[to].kind if to in self.locks else "Lock"
            if kind != "RLock":
                self.self_deadlocks.append((to, rel, line))
            return
        self.edges.setdefault((frm, to), (rel, line))

    def resolve(self, graph: proggraph.ProgramGraph) -> None:
        """Fold call sites in: an acquisition anywhere in the callee's
        transitive call tree happens under the caller's held set."""
        # transitive acquires per function, fixed point
        direct: Dict[str, Set[str]] = {
            q: {a[0] for a in acqs}
            for q, acqs in self._acquires.items()}
        trans: Dict[str, Set[str]] = {q: set(s)
                                      for q, s in direct.items()}
        for _ in range(64):
            changed = False
            for qual, fn in graph.functions.items():
                acc = trans.get(qual, set())
                before = len(acc)
                for callee, _call in graph.callees(fn):
                    acc |= trans.get(callee.qualname, set())
                if len(acc) != before:
                    trans[qual] = acc
                    changed = True
                elif acc and qual not in trans:
                    trans[qual] = acc
            if not changed:
                break
        for _fn_qual, callee_qual, rel, line, held in self._calls:
            for inner in trans.get(callee_qual, ()):
                for h in held:
                    self._edge(h, inner, rel, line)

    def cycles(self) -> List[List[str]]:
        """Elementary cycles via iterative DFS over the edge set —
        returns each cycle once as a lock-id list."""
        adj: Dict[str, List[str]] = {}
        for frm, to in self.edges:
            adj.setdefault(frm, []).append(to)
        seen_cycles: Set[frozenset] = set()
        out: List[List[str]] = []

        def dfs(start: str) -> None:
            stack: List[Tuple[str, List[str]]] = [(start, [start])]
            while stack:
                node, path = stack.pop()
                for nxt in adj.get(node, ()):
                    if nxt == start and len(path) > 1:
                        key = frozenset(path)
                        if key not in seen_cycles:
                            seen_cycles.add(key)
                            out.append(path + [start])
                    elif nxt not in path and nxt > start:
                        # visit only ids > start: each cycle is found
                        # from its smallest node exactly once
                        stack.append((nxt, path + [nxt]))

        for node in sorted(adj):
            dfs(node)
        return out

    def to_dict(self) -> dict:
        return {
            "locks": [dataclasses.asdict(ld) for _key, ld in
                      sorted(self.locks.items())],
            "edges": [{"from": frm, "to": to, "path": rel, "line": line}
                      for (frm, to), (rel, line) in
                      sorted(self.edges.items())],
            "cycles": self.cycles(),
            "self_deadlocks": [
                {"lock": lk, "path": rel, "line": line}
                for lk, rel, line in self.self_deadlocks],
        }


def build_lock_graph(project: Project) -> LockGraph:
    """Build (and cache on the project) the repo's lock-acquisition
    graph — the JSON behind ``--lockgraph``."""
    cached = getattr(project, "_lockgraph", None)
    if cached is not None:
        return cached
    graph = proggraph.get_graph(project)
    lg = LockGraph()
    findings: List[Finding] = []
    for mod in graph.modules.values():
        _analyze_scope(graph, mod, None, findings, lg)
        for cls in mod.classes.values():
            _analyze_scope(graph, mod, cls, findings, lg)
    lg.resolve(graph)
    project._lockgraph = lg
    project._lockgraph_findings = findings
    return lg


@rule("R8", "lock-discipline", scope="program")
def check_lock_discipline(project: Project) -> Iterable[Finding]:
    """Reads/writes of ``# guarded-by:`` annotated state outside the
    named lock (helper calls resolved through the program graph), plus
    lock-order-inversion cycles and self-deadlocks in the static
    lock-acquisition graph."""
    lg = build_lock_graph(project)
    out: List[Finding] = list(project._lockgraph_findings)
    for cyc in lg.cycles():
        edge = (cyc[0], cyc[1])
        rel, line = lg.edges.get(edge, ("", 0))
        pretty = " -> ".join(c.split("::")[-1] for c in cyc)
        out.append(Finding(
            "R8", rel or cyc[0].split("::")[0], line,
            f"lock-order cycle {pretty} — a thread taking these locks "
            "in different orders can deadlock; impose one global "
            "order (dump the graph with --lockgraph)"))
    for lock_id, rel, line in lg.self_deadlocks:
        out.append(Finding(
            "R8", rel, line,
            f"'{lock_id.split('::')[-1]}' (non-reentrant Lock) is "
            "acquired while already held on this path — guaranteed "
            "self-deadlock; use an RLock or split the critical "
            "section"))
    return out
