"""graftlint for the port — the JAX package's static analyzer,
re-targeted at ``raft_tpu_torch/`` and its CUDA sources.

The serving guarantees of the port are invariants of how its code is
written, and the card raises a breach only at run time, on the path
that happens to hit it. The rules:

- R0 style: every file parses; no unused imports, tabs, trailing
  whitespace or ``print`` in library code; pragma hygiene;
- R1 capture hazard: Python control flow on tensor values, and host
  reads, inside the bodies the executor captures into a CUDA graph; the
  executor's cache keys stay hashable statics;
- R2 graph-buffer aliasing: a captured entry's static outputs leave
  only as clones taken under the executor lock, and its static inputs
  are written in place, never rebound after capture;
- R3 collectives: every ``torch.distributed`` collective goes through
  the ``comms`` veneer, and axis literals name a declared mesh axis;
- R4 launch budget (CUDA sources): every ``__global__`` states
  ``__launch_bounds__``, dynamic shared memory is opted into with a
  checked ``cudaFuncSetAttribute``, static shared memory fits 48 KiB;
- R5 host sync: no ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``/
  ``torch.cuda.synchronize``/tensor truth on the serving path, no
  per-iteration transfer in a hot loop;
- R6 plain-twin coverage: every kernel wrapper keeps a plain PyTorch
  version, a CUDA-gated test and a place in ``chip_smoke.py``'s kernels
  phase;
- R7 clock discipline in ``serving/`` and ``fleet/``;
- R8 lock discipline: ``# guarded-by:`` state and an acyclic static lock
  graph;
- R9 metric inventory: registered names, ``raft_tpu_torch/METRICS.md``
  and the exporter's HELP table agree.

Run::

    python -m raft_tpu_torch.analysis               # exit 1 on findings
    python -m raft_tpu_torch.analysis --format=ci   # + suppressions
    python -m raft_tpu_torch.analysis --lockgraph lockgraph.json

Repo runs keep an incremental content-hash cache at
``raft_tpu_torch/_build/graftlint_cache.json`` (``--no-cache`` bypasses
it). Suppress a finding only with a written reason, in a file of the
package or in ``chip_smoke.py``::

    risky_line()  # graftlint: disable=R5(one host read a request)
"""

from raft_tpu_torch.analysis.core import (
    Finding,
    LintCache,
    Project,
    Report,
    RULES,
    Rule,
    Suppression,
    parse_pragma_items,
    rule,
    ruleset_version,
    run,
)

# importing the rule modules registers them
from raft_tpu_torch.analysis import rules_style  # noqa: F401
from raft_tpu_torch.analysis import rules_capture  # noqa: F401
from raft_tpu_torch.analysis import rules_mesh  # noqa: F401
from raft_tpu_torch.analysis import rules_kernels  # noqa: F401
from raft_tpu_torch.analysis import rules_hostsync  # noqa: F401
from raft_tpu_torch.analysis import rules_clock  # noqa: F401
from raft_tpu_torch.analysis import rules_locks  # noqa: F401
from raft_tpu_torch.analysis import rules_metrics  # noqa: F401


def lint_texts(texts, rules=None, aux=None) -> Report:
    """Lint an in-memory {relative path: source} mapping — the fixture
    corpus entry point. ``aux`` opts a fixture into the doc-conformance
    checks (R9)."""
    return run(Project.from_texts(texts, aux=aux), rules=rules)


def lint_root(root, rules=None) -> Report:
    """Lint a repo checkout rooted at ``root``."""
    return run(Project.from_root(root), rules=rules)


__all__ = [
    "Finding", "LintCache", "Project", "Report", "RULES", "Rule",
    "Suppression", "parse_pragma_items", "rule", "ruleset_version", "run",
    "lint_texts", "lint_root",
]
