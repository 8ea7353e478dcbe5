"""CLI: ``python -m raft_tpu_torch.analysis`` — lint the port, exit
non-zero on any unsuppressed finding. Imports nothing of JAX."""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from raft_tpu_torch.analysis import LintCache, Project, ruleset_version, run
from raft_tpu_torch.analysis.core import PACKAGE
from raft_tpu_torch.analysis.report import (
    render_ci,
    render_rules,
    render_suppressions,
    render_text,
)


#: the incremental cache, beside the kernels' builds (gitignored)
CACHE_REL = PACKAGE + "/_build/graftlint_cache.json"


def _default_root() -> pathlib.Path:
    """The repo root: cwd when it holds the package, else the directory
    that holds this package."""
    cwd = pathlib.Path.cwd()
    if (cwd / PACKAGE).is_dir():
        return cwd
    return pathlib.Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.analysis",
        description="graftlint for raft_tpu_torch — serving-path "
                    "invariants as lint rules")
    ap.add_argument("--root", default=None,
                    help="repo root (default: auto-detect)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids (default: all)")
    ap.add_argument("--format", dest="fmt", default="text",
                    choices=("text", "json", "ci"))
    ap.add_argument("--output", default=None,
                    help="also write the JSON report to this path")
    ap.add_argument("--no-cache", action="store_true",
                    help="bypass the incremental content-hash cache "
                         "(raft_tpu_torch/_build/graftlint_cache.json)")
    ap.add_argument("--lockgraph", default=None, metavar="PATH",
                    help="also dump the R8 static lock-acquisition "
                         "graph (locks, edges, cycles) as JSON")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--list-suppressions", action="store_true",
                    help="print the suppression inventory instead of "
                         "the findings (JSON with --format=json — the "
                         "same [path, rule, reason] rows the report "
                         "and the snapshot test read)")
    args = ap.parse_args(argv)

    if args.list_rules:
        sys.stdout.write(render_rules())
        return 0

    root = pathlib.Path(args.root) if args.root else _default_root()
    rules = args.rules.split(",") if args.rules else None
    project = Project.from_root(root)
    cache = None
    if not args.no_cache:
        cache = LintCache(root / CACHE_REL, ruleset_version())
    try:
        report = run(project, rules=rules, cache=cache)
    except ValueError as e:
        sys.stderr.write(f"graftlint: {e}\n")
        return 2

    if args.lockgraph:
        from raft_tpu_torch.analysis.rules_locks import build_lock_graph

        graph = build_lock_graph(project)
        pathlib.Path(args.lockgraph).write_text(
            json.dumps(graph.to_dict(), indent=2) + "\n")
    if args.output:
        pathlib.Path(args.output).write_text(report.to_json())
    if args.list_suppressions:
        if args.fmt == "json":
            sys.stdout.write(json.dumps(
                report.suppression_inventory(), indent=2) + "\n")
        else:
            sys.stdout.write(render_suppressions(report))
        return 0
    if args.fmt == "json":
        sys.stdout.write(report.to_json())
    elif args.fmt == "ci":
        sys.stdout.write(render_ci(report))
    else:
        sys.stdout.write(render_text(report))
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
