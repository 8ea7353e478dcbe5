"""R0 — style & hygiene: syntax, unused imports, whitespace discipline,
no ``print`` in library code, no ``NotImplementedError`` stubs. The
CUDA sources are held to the whitespace checks only.

Pragma hygiene (malformed / unused ``graftlint: disable`` comments) is
reported under R0 as well, by the runner in :mod:`.core`.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from raft_tpu_torch.analysis import astutil
from raft_tpu_torch.analysis.core import Finding, Project, rule

# printing is these components' job
PRINT_EXEMPT = ("bench", "examples", "scripts", "__main__")


class _ImportTracker(ast.NodeVisitor):
    """Collect imported names and every name read anywhere."""

    def __init__(self) -> None:
        self.imported = {}
        self.used = set()

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            name = (a.asname or a.name).split(".")[0]
            self.imported[name] = node.lineno

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module == "__future__":
            return
        for a in node.names:
            if a.name == "*":
                continue
            self.imported[a.asname or a.name] = node.lineno

    def visit_Name(self, node: ast.Name) -> None:
        if isinstance(node.ctx, ast.Load):
            self.used.add(node.id)


@rule("R0", "style")
def check_style(project: Project) -> Iterable[Finding]:
    """Every file parses; no unused imports (``# noqa`` and re-export
    manifests exempt); no tabs / trailing whitespace / missing EOF
    newline; no ``print()`` in library code; no NotImplementedError
    stubs in ``raft_tpu_torch/``; CUDA sources get the whitespace
    checks."""
    out: List[Finding] = []

    def err(f, line, msg):
        out.append(Finding("R0", f.rel, line, msg))

    for f in project.files:
        if f.syntax_error is not None:
            err(f, f.syntax_error.lineno or 0,
                f"does not parse: {f.syntax_error.msg}")
            continue

        noqa = {i + 1 for i, ln in enumerate(f.lines) if "# noqa" in ln}
        for i, ln in enumerate(f.lines, 1):
            if "\t" in ln:
                err(f, i, "tab character")
            if ln != ln.rstrip():
                err(f, i, "trailing whitespace")
        if f.text and not f.text.endswith("\n"):
            err(f, len(f.lines), "no newline at end of file")
        if f.tree is None:
            continue

        base = f.rel.rsplit("/", 1)[-1]
        if base not in ("__init__.py", "conftest.py"):
            tracker = _ImportTracker()
            tracker.visit(f.tree)
            all_strings = {
                s.value for s in astutil.nodes(f.tree)
                if isinstance(s, ast.Constant) and isinstance(s.value, str)
            }
            for name, line in tracker.imported.items():
                if line in noqa or name.startswith("_"):
                    continue
                if name not in tracker.used and name not in all_strings:
                    err(f, line, f"unused import '{name}'")

        in_lib = f.kind == "lib"
        exempt = (base == "__main__.py"
                  or any(p in f.rel.split("/") for p in PRINT_EXEMPT))
        if not in_lib or exempt:
            continue
        for node in astutil.nodes(f.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "print"
                    and node.lineno not in noqa):
                err(f, node.lineno,
                    "print() in library code — use the logger")
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a function whose whole body is `raise NotImplementedError`
                # is a stub; a terminal raise after dispatch is fine
                body = [s for s in node.body
                        if not (isinstance(s, ast.Expr)
                                and isinstance(s.value, ast.Constant))]
                if len(body) == 1 and isinstance(body[0], ast.Raise):
                    exc = body[0].exc
                    name = (exc.func.id if isinstance(exc, ast.Call)
                            and isinstance(exc.func, ast.Name) else
                            exc.id if isinstance(exc, ast.Name) else None)
                    if name == "NotImplementedError":
                        err(f, node.lineno, "NotImplementedError stub")
    return out
