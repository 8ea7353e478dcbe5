"""R4 launch budget and R6 plain-twin coverage — the kernel-discipline
rules, the port's counterparts of the JAX lint's Pallas budget and
interpret-mode coverage.

R4 reads the CUDA sources under ``raft_tpu_torch/csrc/`` as text (after
blanking comments) and enforces what a launch on the card assumes:

- every ``__global__`` states ``__launch_bounds__`` — without it ptxas
  may give a kernel more registers than its launch size leaves, and the
  launch is refused (``cudaErrorLaunchOutOfResources``) on the first
  shape that needs the full block;
- every kernel that declares ``extern __shared__`` is reached, in each
  translation unit that names it (the ``.cu`` and the ``.cuh`` files it
  includes), by ``cudaFuncSetAttribute(<kernel or an alias of it>,
  cudaFuncAttributeMaxDynamicSharedMemorySize, …)`` — above 48 KiB a
  launch without the opt-in is refused — and that call's error is
  returned (assigned and then tested, returned, or wrapped in a checking
  macro), not dropped;
- the ``__shared__`` arrays of a kernel whose extents fold to constants
  (``constexpr int`` and ``#define`` of the unit) stay within 48 KiB a
  block, the most a block gets without the opt-in.

R6 holds every kernel wrapper — each entry of
``core/executor._kernel_wrappers()`` — to the port's contract beside a
kernel: its module launches a kernel built by ``ops/_build`` (``load``
or ``function``), the wrapper reaches a plain PyTorch version
(``<wrapper>_plain``, or a ``*_plain``/``*_torch`` function it calls,
the ``"torch"`` engine), some CUDA-gated ``tests/test_torch_cuda_*.py``
calls it, and ``chip_smoke.py``'s kernels phase (``phase_kernels``)
names it.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from raft_tpu_torch.analysis import astutil
from raft_tpu_torch.analysis.core import (
    PACKAGE,
    Finding,
    Project,
    SourceFile,
    rule,
)

#: shared memory a block gets without the dynamic opt-in
STATIC_SMEM_BYTES = 48 << 10

_TYPE_BYTES = {
    "char": 1, "int8_t": 1, "uint8_t": 1, "bool": 1,
    "short": 2, "half": 2, "__half": 2, "__nv_bfloat16": 2,
    "int16_t": 2, "uint16_t": 2,
    "float": 4, "int": 4, "unsigned": 4, "int32_t": 4, "uint32_t": 4,
    "double": 8, "long": 8, "int64_t": 8, "uint64_t": 8, "float2": 8,
    "int2": 8, "float4": 16, "int4": 16, "uint4": 16,
}
_OPTIN = "cudaFuncAttributeMaxDynamicSharedMemorySize"
_INCLUDE_RE = re.compile(r'#\s*include\s+"([^"]+)"')
_CONST_RE = re.compile(
    r"(?:constexpr|const)\s+(?:static\s+)?(?:unsigned\s+)?"
    r"(?:int|long long|long|size_t|unsigned)\s+(\w+)\s*=\s*([^;]+);")
_DEFINE_RE = re.compile(r"#\s*define\s+(\w+)\s+([^\n]+)")
_SHARED_RE = re.compile(
    r"(?<!extern )__shared__\s+(?:__align__\(\d+\)\s+)?"
    r"((?:unsigned\s+|signed\s+|long\s+)*\w+)\s+([^;]+);")


def blank_comments(text: str) -> str:
    """``text`` with comments and string literals replaced by spaces
    (newlines kept, so offsets and line numbers hold)."""
    out = list(text)
    i, n = 0, len(text)
    while i < n:
        if text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
        elif text[i] == '"' and not text[max(0, i - 8):i].rstrip(
                ).endswith("include"):
            j = i + 1
            while j < n and text[j] != '"':
                j += 2 if text[j] == "\\" else 1
            j += 1
        else:
            i += 1
            continue
        for m in range(i, min(j, n)):
            if out[m] != "\n":
                out[m] = " "
        i = j
    return "".join(out)


def _match_close(text: str, i: int, open_c: str, close_c: str) -> int:
    """Index just past the bracket that closes the one at ``i``."""
    depth = 0
    for j in range(i, len(text)):
        if text[j] == open_c:
            depth += 1
        elif text[j] == close_c:
            depth -= 1
            if depth == 0:
                return j + 1
    return len(text)


@dataclasses.dataclass
class Kernel:
    """One ``__global__`` function of a CUDA source."""

    name: str
    rel: str
    line: int
    bounded: bool          # carries __launch_bounds__
    body: str
    dynamic_smem: bool     # declares extern __shared__


def _line_of(text: str, pos: int) -> int:
    return text.count("\n", 0, pos) + 1


def kernels_of(f: SourceFile) -> List[Kernel]:
    text = blank_comments(f.text)
    out: List[Kernel] = []
    for m in re.finditer(r"\b__global__\b", text):
        brace = text.find("{", m.end())
        semi = text.find(";", m.end())
        if brace < 0 or (0 <= semi < brace):
            continue  # a declaration, not a definition
        header = text[m.end():brace]
        bounded = "__launch_bounds__" in header
        lb = header.find("__launch_bounds__")
        if lb >= 0:
            p = header.find("(", lb)
            header = header[:lb] + header[_match_close(header, p, "(", ")"):]
        nm = re.search(r"(\w+)\s*\(", header)
        if nm is None:
            continue
        body = text[brace:_match_close(text, brace, "{", "}")]
        out.append(Kernel(nm.group(1), f.rel, _line_of(text, m.start()),
                          bounded, body, "extern __shared__" in body))
    return out


def _closures(project: Project) -> Dict[str, List[SourceFile]]:
    """Each CUDA source → its files: itself first, then the ``.cuh`` it
    includes, transitively. A ``.cu``'s is its translation unit."""
    by_base = {os.path.basename(f.rel): f for f in project.csrc()}
    out: Dict[str, List[SourceFile]] = {}
    for f in project.csrc():
        seen = [f]
        stack = [f]
        while stack:
            cur = stack.pop()
            for inc in _INCLUDE_RE.findall(cur.text):
                sub = by_base.get(os.path.basename(inc))
                if sub is not None and sub not in seen:
                    seen.append(sub)
                    stack.append(sub)
        out[f.rel] = seen
    return out


def _constants(texts: Iterable[str]) -> Dict[str, str]:
    consts: Dict[str, str] = {}
    for t in texts:
        for name, expr in _CONST_RE.findall(t):
            consts.setdefault(name, expr)
        for name, expr in _DEFINE_RE.findall(t):
            consts.setdefault(name, expr)
    return consts


def fold(expr: str, consts: Dict[str, str], depth: int = 0
         ) -> Optional[int]:
    """An integer C constant expression, names resolved through
    ``consts``; None when anything stays unknown."""
    if depth > 8:
        return None
    expr = expr.strip()

    def sub(m):
        v = fold(consts[m.group(0)], consts, depth + 1) \
            if m.group(0) in consts else None
        return "None" if v is None else str(v)

    expr = re.sub(r"sizeof\s*\(\s*(\w+)\s*\)",
                  lambda m: str(_TYPE_BYTES.get(m.group(1), 4)), expr)
    expr = re.sub(r"(?<=\d)[uUlL]+\b", "", expr)
    expr = re.sub(r"[A-Za-z_]\w*", sub, expr)
    if "None" in expr or not re.fullmatch(r"[\d\s+\-*/%()<>]*", expr):
        return None
    try:
        tree = ast.parse(expr.replace("/", "//"), mode="eval")
    except SyntaxError:
        return None
    if not all(isinstance(n, (ast.Expression, ast.BinOp, ast.UnaryOp,
                              ast.Constant, ast.operator, ast.unaryop))
               for n in ast.walk(tree)):
        return None
    try:
        return int(eval(compile(tree, "<c-expr>", "eval"), {}, {}))
    except (ZeroDivisionError, ValueError, TypeError, OverflowError):
        return None


def static_smem_bytes(body: str, consts: Dict[str, str]) -> Optional[int]:
    """Bytes of the ``__shared__`` variables of a kernel body when every
    extent folds, else None."""
    total = 0
    for ctype, decls in _SHARED_RE.findall(body):
        size = _TYPE_BYTES.get(ctype.split()[-1], 4)
        for decl in decls.split(","):
            n = 1
            for ext in re.findall(r"\[([^\]]*)\]", decl):
                v = fold(ext, consts)
                if v is None:
                    return None
                n *= v
            total += n * size
    return total


def _enclosing_function(text: str, pos: int) -> str:
    """The body of the outermost function definition around ``pos``
    (braces whose header holds a parameter list), else the whole
    text."""
    depth_stack: List[int] = []
    best = None
    for j, c in enumerate(text[:pos]):
        if c == "{":
            depth_stack.append(j)
        elif c == "}" and depth_stack:
            depth_stack.pop()
    for start in depth_stack:
        k = max(text.rfind(";", 0, start), text.rfind("}", 0, start),
                text.rfind("{", 0, start))
        header = text[k + 1:start]
        if ")" in header and not re.match(r"\s*(namespace|struct|class)",
                                          header):
            best = start
            break
    if best is None:
        return text
    return text[best:_match_close(text, best, "{", "}")]


# the first statement that reads an opt-in's error variable must test it
# (``if (err ...``, ``err != cudaSuccess``), return it, or hand it to a
# checking macro (``RAFT_TRY(err)``)
_CHECK_TEMPLATES = (r"\bif\s*\(\s*!?\s*\(?\s*{v}\b",
                    r"\b{v}\s*!=\s*cudaSuccess",
                    r"\breturn\s+\(?\s*(?:\(int\)\s*)?{v}\b",
                    r"\w+\s*\(\s*{v}\s*\)")


def _optin_calls(text: str):
    """``(position, first argument, error checked)`` of every dynamic
    shared-memory opt-in in ``text`` (comments blanked)."""
    for m in re.finditer(r"\bcudaFuncSetAttribute\s*\(", text):
        close = _match_close(text, m.end() - 1, "(", ")")
        args = text[m.end():close - 1]
        if _OPTIN not in args:
            continue
        first = args.split(",")[0].strip()
        k = max(text.rfind(";", 0, m.start()),
                text.rfind("{", 0, m.start()),
                text.rfind("}", 0, m.start()))
        prefix = text[k + 1:m.start()].strip()
        checked = False
        if prefix.endswith("(") or prefix.startswith("return"):
            checked = True  # wrapped in a checking macro, or returned
        elif prefix.endswith("="):
            var = re.findall(r"(\w+)\s*=$", prefix)
            if var:
                end = text.find(";", close)
                rest = text[end + 1:]
                use = re.search(rf"\b{var[0]}\b", rest)
                if use is not None:
                    stmt_start = max(rest.rfind(";", 0, use.start()),
                                     rest.rfind("{", 0, use.start()),
                                     rest.rfind("}", 0, use.start()))
                    stmt = rest[stmt_start + 1:rest.find(";", use.start())]
                    checked = any(re.search(t.format(v=var[0]), stmt)
                                  for t in _CHECK_TEMPLATES)
        yield m.start(), first, checked


def _aliases(scope: str, name: str) -> Set[str]:
    """Kernel names an alias ``name`` is bound to in ``scope``
    (``auto kernel = k<...>``, ``void (*kernel)(A) = k<...>``,
    ``kernel = c ? k1<...> : k2<...>``)."""
    out: Set[str] = set()
    pat = rf"(?:\b{name}\b|\(\s*\*\s*{name}\s*\)\s*\([^)]*\))\s*=(?!=)([^;]+);"
    for m in re.finditer(pat, scope):
        out |= set(re.findall(r"\b\w+\b", m.group(1)))
    return out


@rule("R4", "launch-budget", scope="program")
def check_launch_budget(project: Project) -> Iterable[Finding]:
    """Every __global__ states __launch_bounds__; every kernel with
    extern __shared__ is reached, in each unit that names it, by a
    checked cudaFuncSetAttribute(..., MaxDynamicSharedMemorySize, ...);
    static __shared__ arrays of constant extent fit 48 KiB."""
    out: List[Finding] = []
    files = project.csrc()
    kernels: Dict[str, List[Kernel]] = {f.rel: kernels_of(f) for f in files}
    closures = _closures(project)
    units = {rel: members for rel, members in closures.items()
             if rel.endswith(".cu")}
    for f in files:
        consts = _constants(m.text for m in closures[f.rel])
        for k in kernels[f.rel]:
            if not k.bounded:
                out.append(Finding(
                    "R4", f.rel, k.line,
                    f"__global__ {k.name} has no __launch_bounds__ — "
                    "state the block size it is launched with, so ptxas "
                    "never spends more registers than that block "
                    "leaves"))
            smem = static_smem_bytes(k.body, consts)
            if smem is not None and smem > STATIC_SMEM_BYTES:
                out.append(Finding(
                    "R4", f.rel, k.line,
                    f"__global__ {k.name} declares {smem} bytes of static "
                    f"__shared__ memory, over the {STATIC_SMEM_BYTES} a "
                    "block gets without the opt-in — move it to dynamic "
                    "shared memory"))

    # the dynamic shared-memory opt-in, unit by unit
    for tu, members in sorted(units.items()):
        text = "\n".join(blank_comments(m.text) for m in members)
        reached: Set[str] = set()
        for pos, first, checked in _optin_calls(text):
            name = first.split("<")[0].strip()
            names = {name} | _aliases(_enclosing_function(text, pos), name)
            reached |= names
            if not checked:
                rel, line = _locate(members, pos)
                out.append(Finding(
                    "R4", rel, line,
                    f"cudaFuncSetAttribute({first}, {_OPTIN}, ...)'s error "
                    "is dropped — assign and test it, or return it; a "
                    "refused opt-in makes the launch fail with no "
                    "reason"))
        for m in members:
            for k in kernels.get(m.rel, []):
                if not k.dynamic_smem or k.name in reached:
                    continue
                named = len(re.findall(rf"\b{k.name}\b", text)) > 1
                if named or m.rel == tu:
                    out.append(Finding(
                        "R4", k.rel, k.line,
                        f"__global__ {k.name} declares extern __shared__ "
                        f"but no {_OPTIN} opt-in reaches it in {tu} — a "
                        "launch above 48 KiB is refused"))
    # one finding per (path, line, message)
    uniq = {(fd.path, fd.line, fd.message): fd for fd in out}
    return list(uniq.values())


def _locate(members: List[SourceFile], pos: int) -> Tuple[str, int]:
    """(file, line) of offset ``pos`` in the members' joined texts."""
    for m in members:
        n = len(m.text) + 1
        if pos < n:
            return m.rel, m.text.count("\n", 0, pos) + 1
        pos -= n
    return members[-1].rel, 1


# ---------------------------------------------------------------------------
# R6 — plain-twin coverage
# ---------------------------------------------------------------------------

EXECUTOR_REL = PACKAGE + "/core/executor.py"
REGISTRY_FN = "_kernel_wrappers"
SMOKE_REL = "chip_smoke.py"
SMOKE_PHASE = "phase_kernels"


def kernel_wrappers(project: Project) -> List[Tuple[str, str, int]]:
    """``(module rel, wrapper name, registry line)`` for every entry of
    ``_kernel_wrappers()``."""
    f = project.by_rel.get(EXECUTOR_REL)
    if f is None or f.tree is None:
        return []
    out = []
    for fn in astutil.collect_functions(f.tree):
        if fn.name != REGISTRY_FN:
            continue
        imported: Dict[str, str] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    imported[a.asname or a.name] = (node.module, a.name)
        for node in ast.walk(fn):
            if isinstance(node, ast.Return) \
                    and isinstance(node.value, ast.Dict):
                for v in node.value.values:
                    if isinstance(v, ast.Name) and v.id in imported:
                        mod, name = imported[v.id]
                        out.append((mod.replace(".", "/") + ".py", name,
                                    v.lineno))
    return out


def _names_in(node: ast.AST) -> Set[str]:
    names: Set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            names.add(n.id)
        elif isinstance(n, ast.Attribute):
            names.add(n.attr)
        elif isinstance(n, ast.Constant) and isinstance(n.value, str):
            names.add(n.value)
    return names


def _called(node: ast.AST) -> Set[str]:
    return {(astutil.call_name(c) or "").split(".")[-1]
            for c in ast.walk(node) if isinstance(c, ast.Call)}


@rule("R6", "plain-twin-coverage", scope="program")
def check_plain_twins(project: Project) -> Iterable[Finding]:
    """Every kernel wrapper of ``_kernel_wrappers()`` launches an
    ``ops/_build`` kernel, reaches a plain PyTorch version, is called in
    a CUDA-gated ``tests/test_torch_cuda_*.py``, and is named in
    ``chip_smoke.py``'s ``phase_kernels``."""
    out: List[Finding] = []
    cuda_tests: Set[str] = set()
    for t in project.tests():
        if t.tree is not None and os.path.basename(t.rel).startswith(
                "test_torch_cuda_"):
            cuda_tests |= _called(t.tree)
    smoke = project.by_rel.get(SMOKE_REL)
    phase_names: Optional[Set[str]] = None
    if smoke is not None and smoke.tree is not None:
        # the phase and the module's functions it calls, transitively
        top = {n.name: n for n in smoke.tree.body
               if isinstance(n, ast.FunctionDef)}
        phase_names = set()
        todo = [SMOKE_PHASE] if SMOKE_PHASE in top else []
        done: Set[str] = set()
        while todo:
            cur = todo.pop()
            done.add(cur)
            phase_names |= _names_in(top[cur])
            todo += [c for c in _called(top[cur])
                     if c in top and c not in done and c not in todo]
    for rel, name, reg_line in kernel_wrappers(project):
        f = project.by_rel.get(rel)
        fn = None
        if f is not None and f.tree is not None:
            fn = next((n for n in f.tree.body
                       if isinstance(n, ast.FunctionDef)
                       and n.name == name), None)
        if fn is None:
            out.append(Finding(
                "R6", EXECUTOR_REL, reg_line,
                f"kernel wrapper '{name}' is not a function of {rel}"))
            continue
        top = {n.name for n in f.tree.body
               if isinstance(n, ast.FunctionDef)}
        builds = any((astutil.call_name(c) or "").endswith(
            ("_build.load", "_build.function"))
            for c in astutil.nodes(f.tree) if isinstance(c, ast.Call))
        if not builds:
            out.append(Finding(
                "R6", rel, fn.lineno,
                f"kernel wrapper '{name}': its module launches no kernel "
                "built by ops/_build (load/function)"))
        twins = {c for c in _called(fn) & top
                 if c.endswith(("_plain", "_torch"))}
        if name + "_plain" not in top and not twins:
            out.append(Finding(
                "R6", rel, fn.lineno,
                f"kernel wrapper '{name}' reaches no plain PyTorch version "
                f"— define {name}_plain or call the module's *_torch "
                "engine for CPU tensors"))
        if name not in cuda_tests:
            out.append(Finding(
                "R6", rel, fn.lineno,
                f"kernel wrapper '{name}' is called in no CUDA-gated "
                "tests/test_torch_cuda_*.py — nothing holds the kernel "
                "to its plain version on the card in the tests"))
        if phase_names is not None and name not in phase_names:
            out.append(Finding(
                "R6", rel, fn.lineno,
                f"kernel wrapper '{name}' is not named in "
                f"{SMOKE_REL}'s {SMOKE_PHASE} — the chip smoke does not "
                "hold it to its plain version"))
    return out
