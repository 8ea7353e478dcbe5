"""Whole-program graph — the cross-module core that R8 (lock
discipline), R6 (plain-twin coverage) and R9 (metric-inventory
conformance) share.

One parse pass over the project resolves:

- a **repo-wide symbol table**: every module's top-level functions,
  classes, and string constants, plus its import aliases resolved to
  intra-repo modules/symbols;
- a **class field inventory**: every ``self.<field> = ...`` assignment,
  with the ``# guarded-by: <lock>`` annotation (R8's contract), the
  lock fields themselves (``threading.Lock/RLock/Condition``), and a
  one-level type guess (``self._q = AdmissionQueue(...)`` binds the
  field to that class) powering attribute-aware call resolution;
- an **intra-repo call graph**: self-calls, module-local calls,
  imported-symbol calls, ``module.func`` calls through import aliases,
  and ``self.<typed-field>.method()`` calls through the field
  inventory. Unresolvable calls stay unresolved — the analyses built
  on top are *sound about what they claim* precisely because the graph
  never guesses by bare method name.

The graph is built lazily once per :class:`~.core.Project` and cached
on it, mirroring how ``astutil`` serves the per-file rules.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from typing import Dict, List, Optional, Tuple

from raft_tpu_torch.analysis.core import PACKAGE

GUARDED_BY_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][A-Za-z0-9_]*)")

_LOCK_CTORS = {"Lock", "RLock", "Condition"}


def _is_lock_ctor(expr: ast.AST) -> bool:
    """``threading.Lock()`` / ``threading.RLock()`` /
    ``threading.Condition(...)`` (any import spelling), or the
    dataclass spelling ``dataclasses.field(default_factory=
    threading.Lock)``."""
    if not isinstance(expr, ast.Call):
        return False
    name = _dotted(expr.func) or ""
    if name.split(".")[-1] in _LOCK_CTORS:
        return True
    if name.split(".")[-1] == "field":
        for kw in expr.keywords:
            if kw.arg == "default_factory" and (
                    _dotted(kw.value) or "").split(".")[-1] \
                    in _LOCK_CTORS:
                return True
    return False


def _dotted(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


@dataclasses.dataclass
class FieldInfo:
    """One instance field of a class, from its ``self.X = ...`` sites."""

    name: str
    lineno: int                      # first assignment
    guarded_by: Optional[str] = None  # lock name from `# guarded-by:`
    is_lock: bool = False            # assigned a threading lock ctor
    class_name: Optional[str] = None  # `self.x = ClassName(...)` guess
    value: Optional[ast.AST] = None  # first assigned expression


@dataclasses.dataclass
class FunctionInfo:
    """A function or method, addressable repo-wide."""

    qualname: str                    # "<rel>::Class.method" / "<rel>::func"
    rel: str
    name: str
    node: ast.AST                    # FunctionDef / AsyncFunctionDef
    cls: Optional["ClassInfo"] = None

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"<fn {self.qualname}>"


@dataclasses.dataclass
class ClassInfo:
    name: str
    rel: str
    node: ast.ClassDef
    fields: Dict[str, FieldInfo] = dataclasses.field(default_factory=dict)
    methods: Dict[str, FunctionInfo] = dataclasses.field(
        default_factory=dict)
    bases: List[str] = dataclasses.field(default_factory=list)

    @property
    def qualname(self) -> str:
        return f"{self.rel}::{self.name}"


@dataclasses.dataclass
class ModuleInfo:
    rel: str
    tree: ast.AST
    classes: Dict[str, ClassInfo] = dataclasses.field(default_factory=dict)
    functions: Dict[str, FunctionInfo] = dataclasses.field(
        default_factory=dict)
    constants: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: module-level names → (guarded_by, is_lock, lineno)
    globals: Dict[str, FieldInfo] = dataclasses.field(default_factory=dict)
    #: import alias → ("module", rel) or ("symbol", rel, name)
    imports: Dict[str, tuple] = dataclasses.field(default_factory=dict)
    #: comment line → guarded-by lock name
    guard_comments: Dict[int, str] = dataclasses.field(default_factory=dict)


def _in_package(dotted_mod: str) -> bool:
    """An import of the port itself — by package, not by string prefix:
    ``raft_tpu`` (the JAX package, which a parity test imports beside
    the port) starts with the same letters and is not intra-repo here."""
    return dotted_mod == PACKAGE or dotted_mod.startswith(PACKAGE + ".")


def _module_rel(dotted_mod: str) -> str:
    """``raft_tpu_torch.serving.admission`` → repo-relative path
    candidates (module file or package __init__)."""
    return dotted_mod.replace(".", "/")


def _guard_comments(text: str) -> Dict[int, str]:
    out: Dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = GUARDED_BY_RE.search(tok.string)
            if m:
                out[tok.start[0]] = m.group(1)
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass
    return out


def _stmt_guard(stmt: ast.stmt, comments: Dict[int, str]) -> Optional[str]:
    """The guarded-by annotation covering ``stmt``: a trailing comment
    on any line the statement spans."""
    end = getattr(stmt, "end_lineno", stmt.lineno)
    for ln in range(stmt.lineno, end + 1):
        if ln in comments:
            return comments[ln]
    return None


class ProgramGraph:
    """The resolved repo: modules, classes, fields, and the call graph."""

    def __init__(self, project):
        self.project = project
        self.modules: Dict[str, ModuleInfo] = {}
        #: qualname → FunctionInfo
        self.functions: Dict[str, FunctionInfo] = {}
        #: qualname → list of (callee FunctionInfo, call node)
        self._callees: Dict[str, List[Tuple[FunctionInfo, ast.Call]]] = {}
        #: qualname → {local name: its single-target assignments}
        self._assigns: Dict[str, Dict[str, List[ast.Assign]]] = {}
        for f in project.files:
            if f.kind != "lib" or f.tree is None:
                continue
            self.modules[f.rel] = self._index_module(f)
        self._link_imports()
        for mod in self.modules.values():
            self._build_edges(mod)

    # -- indexing -----------------------------------------------------------

    def _index_module(self, f) -> ModuleInfo:
        mod = ModuleInfo(rel=f.rel, tree=f.tree,
                         guard_comments=_guard_comments(f.text))
        for stmt in f.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                info = FunctionInfo(
                    qualname=f"{f.rel}::{stmt.name}", rel=f.rel,
                    name=stmt.name, node=stmt)
                mod.functions[stmt.name] = info
                self.functions[info.qualname] = info
            elif isinstance(stmt, ast.ClassDef):
                mod.classes[stmt.name] = self._index_class(f, mod, stmt)
            elif isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                name = stmt.targets[0].id
                if isinstance(stmt.value, ast.Constant) and isinstance(
                        stmt.value.value, str):
                    mod.constants[name] = stmt.value.value
                mod.globals[name] = FieldInfo(
                    name=name, lineno=stmt.lineno,
                    guarded_by=_stmt_guard(stmt, mod.guard_comments),
                    is_lock=_is_lock_ctor(stmt.value), value=stmt.value)
            elif isinstance(stmt, ast.AnnAssign) and isinstance(
                    stmt.target, ast.Name):
                mod.globals[stmt.target.id] = FieldInfo(
                    name=stmt.target.id, lineno=stmt.lineno,
                    guarded_by=_stmt_guard(stmt, mod.guard_comments),
                    is_lock=_is_lock_ctor(stmt.value)
                    if stmt.value is not None else False, value=stmt.value)
            elif isinstance(stmt, (ast.Import, ast.ImportFrom)):
                self._index_import(mod, stmt)
        return mod

    def _index_import(self, mod: ModuleInfo, stmt) -> None:
        if isinstance(stmt, ast.Import):
            for a in stmt.names:
                if not _in_package(a.name):
                    continue
                alias = a.asname or a.name.split(".")[0]
                if a.asname is None and "." in a.name:
                    # `import raft_tpu_torch.core.tracing` binds the top;
                    # attribute chains resolve through the full path
                    mod.imports[a.name] = ("module", _module_rel(a.name))
                else:
                    mod.imports[alias] = ("module", _module_rel(a.name))
        else:
            base = stmt.module or ""
            if stmt.level:
                # relative import: anchor at this module's package
                pkg = mod.rel.rsplit("/", stmt.level)[0]
                base = pkg.replace("/", ".") + ("." + base if base else "")
            if not _in_package(base):
                return
            for a in stmt.names:
                if a.name == "*":
                    continue
                alias = a.asname or a.name
                sub = _module_rel(f"{base}.{a.name}")
                mod.imports[alias] = ("maybe", _module_rel(base), a.name,
                                      sub)

    def _index_class(self, f, mod: ModuleInfo,
                     node: ast.ClassDef) -> ClassInfo:
        cls = ClassInfo(name=node.name, rel=f.rel, node=node,
                        bases=[_dotted(b) or "" for b in node.bases])
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                info = FunctionInfo(
                    qualname=f"{f.rel}::{node.name}.{stmt.name}",
                    rel=f.rel, name=stmt.name, node=stmt, cls=cls)
                cls.methods[stmt.name] = info
                self.functions[info.qualname] = info
            elif isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                # dataclass-style class-body fields
                targets = stmt.targets if isinstance(stmt, ast.Assign) \
                    else [stmt.target]
                value = getattr(stmt, "value", None)
                for t in targets:
                    if isinstance(t, ast.Name) \
                            and t.id not in cls.fields:
                        cls.fields[t.id] = FieldInfo(
                            name=t.id, lineno=stmt.lineno,
                            guarded_by=_stmt_guard(
                                stmt, mod.guard_comments),
                            is_lock=_is_lock_ctor(value)
                            if value is not None else False,
                            value=value)
        # field inventory: every `self.X = ...` in any method (the
        # first assignment wins for type/lock info; a guarded-by
        # annotation anywhere sticks)
        for m in cls.methods.values():
            for stmt in ast.walk(m.node):
                if isinstance(stmt, ast.Assign):
                    targets = stmt.targets
                elif isinstance(stmt, ast.AnnAssign):
                    targets = [stmt.target]
                else:
                    continue
                value = getattr(stmt, "value", None)
                for t in targets:
                    if not (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        continue
                    fi = cls.fields.get(t.attr)
                    if fi is None:
                        fi = FieldInfo(name=t.attr, lineno=stmt.lineno)
                        cls.fields[t.attr] = fi
                        if value is not None:
                            fi.value = value
                            fi.is_lock = _is_lock_ctor(value)
                            if isinstance(value, ast.Call):
                                cn = _dotted(value.func) or ""
                                fi.class_name = cn.split(".")[-1] or None
                    guard = _stmt_guard(stmt, mod.guard_comments)
                    if guard and fi.guarded_by is None:
                        fi.guarded_by = guard
        return cls

    def _link_imports(self) -> None:
        """Second pass: 'maybe' imports become module or symbol refs
        now that every module is indexed."""
        for mod in self.modules.values():
            for alias, ref in list(mod.imports.items()):
                if ref[0] != "maybe":
                    continue
                _, base_rel, name, sub_rel = ref
                if self._lookup_module(sub_rel) is not None:
                    mod.imports[alias] = ("module", sub_rel)
                else:
                    mod.imports[alias] = ("symbol", base_rel, name)

    def _lookup_module(self, rel_noext: str) -> Optional[ModuleInfo]:
        for cand in (rel_noext + ".py", rel_noext + "/__init__.py"):
            if cand in self.modules:
                return self.modules[cand]
        return None

    # -- resolution ---------------------------------------------------------

    def resolve_symbol(self, mod: ModuleInfo, name: str):
        """A bare name in ``mod`` → FunctionInfo / ClassInfo /
        ModuleInfo / str-constant, following one import hop."""
        if name in mod.functions:
            return mod.functions[name]
        if name in mod.classes:
            return mod.classes[name]
        if name in mod.constants:
            return mod.constants[name]
        ref = mod.imports.get(name)
        if ref is None:
            return None
        if ref[0] == "module":
            return self._lookup_module(ref[1])
        target = self._lookup_module(ref[1])
        if target is None:
            return None
        tname = ref[2]
        if tname in target.functions:
            return target.functions[tname]
        if tname in target.classes:
            return target.classes[tname]
        if tname in target.constants:
            return target.constants[tname]
        return None

    def resolve_attr(self, mod: ModuleInfo, dotted_name: str):
        """``alias.attr[.attr2]`` through a module import."""
        parts = dotted_name.split(".")
        # longest import-alias prefix wins (handles `import a.b.c`)
        for cut in range(len(parts) - 1, 0, -1):
            prefix = ".".join(parts[:cut])
            ref = mod.imports.get(prefix)
            if ref is None or ref[0] != "module":
                continue
            target = self._lookup_module(ref[1])
            rest = parts[cut:]
            while target is not None and len(rest) > 1:
                nxt = target.imports.get(rest[0])
                if nxt is not None and nxt[0] == "module":
                    target = self._lookup_module(nxt[1])
                    rest = rest[1:]
                else:
                    break
            if target is None or len(rest) != 1:
                return None
            leaf = rest[0]
            if leaf in target.functions:
                return target.functions[leaf]
            if leaf in target.classes:
                return target.classes[leaf]
            if leaf in target.constants:
                return target.constants[leaf]
            return None
        return None

    def class_of_name(self, mod: ModuleInfo, name: str
                      ) -> Optional[ClassInfo]:
        sym = self.resolve_symbol(mod, name)
        return sym if isinstance(sym, ClassInfo) else None

    def resolve_call(self, fn: FunctionInfo,
                     call: ast.Call) -> Optional[FunctionInfo]:
        """Best-effort resolution of a call inside ``fn`` to an
        intra-repo function/method; None when unsure (never guesses by
        bare method name)."""
        mod = self.modules.get(fn.rel)
        if mod is None:
            return None
        func = call.func
        if isinstance(func, ast.Name):
            sym = self.resolve_symbol(mod, func.id)
            if isinstance(sym, FunctionInfo):
                return sym
            if isinstance(sym, ClassInfo):
                return sym.methods.get("__init__")
            return None
        if not isinstance(func, ast.Attribute):
            return None
        base = func.value
        # self.method(...)
        if isinstance(base, ast.Name) and base.id == "self" \
                and fn.cls is not None:
            m = fn.cls.methods.get(func.attr)
            if m is not None:
                return m
            return self._base_method(mod, fn.cls, func.attr)
        # self.field.method(...) via the typed field inventory
        if isinstance(base, ast.Attribute) and isinstance(
                base.value, ast.Name) and base.value.id == "self" \
                and fn.cls is not None:
            fi = fn.cls.fields.get(base.attr)
            if fi is not None and fi.class_name:
                target = self.class_of_name(mod, fi.class_name)
                if target is not None:
                    return target.methods.get(func.attr)
            return None
        # module_alias.func(...) / pkg.mod.func(...)
        name = _dotted(func)
        if name is not None:
            resolved = self.resolve_attr(mod, name)
            if isinstance(resolved, FunctionInfo):
                return resolved
            if isinstance(resolved, ClassInfo):
                return resolved.methods.get("__init__")
        # local_var.method(...) where local_var = ClassName(...) in
        # this function body (single-assignment, attribute-aware)
        if isinstance(base, ast.Name):
            cls = self._local_instance_class(fn, mod, base.id)
            if cls is not None:
                return cls.methods.get(func.attr)
        return None

    def _base_method(self, mod: ModuleInfo, cls: ClassInfo,
                     name: str) -> Optional[FunctionInfo]:
        for b in cls.bases:
            if not b:
                continue
            sym = self.resolve_symbol(mod, b.split(".")[-1])
            if isinstance(sym, ClassInfo) and name in sym.methods:
                return sym.methods[name]
        return None

    def _local_instance_class(self, fn: FunctionInfo, mod: ModuleInfo,
                              var: str) -> Optional[ClassInfo]:
        """Single-assignment ``var = ClassName(...)`` in ``fn``'s body;
        None when the name is rebound or not a known-class ctor."""
        by_var = self._assigns.get(fn.qualname)
        if by_var is None:
            by_var = {}
            for stmt in ast.walk(fn.node):
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name):
                    by_var.setdefault(stmt.targets[0].id, []).append(stmt)
            self._assigns[fn.qualname] = by_var
        assigns = by_var.get(var, [])
        if len(assigns) != 1 or not isinstance(assigns[0].value, ast.Call):
            return None
        cn = (_dotted(assigns[0].value.func) or "").split(".")[-1]
        return self.class_of_name(mod, cn) if cn else None

    # -- call graph ---------------------------------------------------------

    def _build_edges(self, mod: ModuleInfo) -> None:
        fns = list(mod.functions.values())
        for cls in mod.classes.values():
            fns.extend(cls.methods.values())
        for fn in fns:
            edges: List[Tuple[FunctionInfo, ast.Call]] = []
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                callee = self.resolve_call(fn, node)
                if callee is not None:
                    edges.append((callee, node))
            self._callees[fn.qualname] = edges

    def callees(self, fn: FunctionInfo):
        return self._callees.get(fn.qualname, [])

    # -- constants (R9's one-level prefix resolution) -----------------------

    def string_constant(self, mod: ModuleInfo,
                        expr: ast.AST) -> Optional[str]:
        """Resolve ``expr`` to a string constant one level deep:
        literals, module constants, and ``alias.CONST`` imports."""
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return expr.value
        if isinstance(expr, ast.Name):
            sym = self.resolve_symbol(mod, expr.id)
            return sym if isinstance(sym, str) else None
        if isinstance(expr, ast.Attribute):
            name = _dotted(expr)
            if name is not None:
                sym = self.resolve_attr(mod, name)
                return sym if isinstance(sym, str) else None
        return None


def get_graph(project) -> ProgramGraph:
    """The project's (lazily built, cached) program graph — one parse
    pass shared by every whole-program rule."""
    graph = getattr(project, "_proggraph", None)
    if graph is None:
        graph = ProgramGraph(project)
        project._proggraph = graph
    return graph
