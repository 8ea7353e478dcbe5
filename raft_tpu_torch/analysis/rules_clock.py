"""R7 — clock discipline in the serving frontend.

The serving fault suite is deterministic because virtual time is the
ONLY time: ``DynamicBatcher`` takes an injectable clock, the manual
clock (``serving/harness.ManualClock``) advances when the test says so,
and every deadline / max-wait / arrival-rate / span timestamp is
computed from ``clock.now()``. One direct ``time.time()`` /
``time.monotonic()`` / ``time.perf_counter()`` in a serving module
silently re-couples that logic to the wall clock: the manual-clock
harness keeps passing, but the quantity it thinks it controls is now
measured in a different time domain and drifts under load.

Scope: ``raft_tpu_torch/serving/*`` and ``raft_tpu_torch/fleet/*``, plus
``core/memwatch.py`` (the ledger publishes through the same scrape
machinery). The one blessed location is the injectable-clock plumbing
itself — a class whose name ends in ``Clock`` (``serving/batcher.
MonotonicClock`` is the production implementation). Every import
spelling is covered — ``time.monotonic()``, ``import time as t;
t.monotonic()``, ``from time import time`` — and so are the
``datetime`` module's wall-clock reads (``datetime.datetime.now()``,
``.utcnow()``, ``date.today()``). ``time.sleep`` is not flagged:
sleeping reads no clock.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Set

from raft_tpu_torch.analysis import astutil
from raft_tpu_torch.analysis.core import Finding, Project, rule

SERVING_PREFIXES = ("raft_tpu_torch/serving/", "raft_tpu_torch/fleet/")
# the memory ledger publishes through the serving scrape machinery: a
# wall-clock read there would split that surface across two time domains
EXTRA_FILES = ("raft_tpu_torch/core/memwatch.py",)

# the clock-reading members of the time module
CLOCK_FNS = {"time", "monotonic", "perf_counter",
             "time_ns", "monotonic_ns", "perf_counter_ns"}

# the clock-reading constructors of the datetime module's classes
DATETIME_CLOCK_FNS = {"now", "utcnow", "today"}
DATETIME_CLASSES = {"datetime", "date"}


def _clock_class_spans(tree: ast.AST) -> List[tuple]:
    """(first, last) line ranges of ``class *Clock`` definitions — the
    injectable-clock plumbing where direct clock reads belong."""
    spans = []
    for node in astutil.nodes(tree):
        if isinstance(node, ast.ClassDef) and node.name.endswith("Clock"):
            spans.append((node.lineno,
                          getattr(node, "end_lineno", node.lineno)))
    return spans


def _time_module_aliases(tree: ast.AST) -> Set[str]:
    """Local names bound to the ``time`` module (``import time``,
    ``import time as t``) — aliasing must not evade the rule."""
    aliases = set()
    for node in astutil.nodes(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "time":
                    aliases.add(a.asname or "time")
    return aliases


def _clock_fn_imports(tree: ast.AST) -> Set[str]:
    """Local names bound to clock functions via ``from time import
    ...`` (``from time import time``, ``from time import monotonic as
    now``) — the bare-call evasion route."""
    names = set()
    for node in astutil.nodes(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "time":
            for a in node.names:
                if a.name in CLOCK_FNS:
                    names.add(a.asname or a.name)
    return names


def _datetime_aliases(tree: ast.AST) -> Set[str]:
    """Local names bound to the ``datetime`` MODULE (``import
    datetime``, ``import datetime as dt``)."""
    aliases = set()
    for node in astutil.nodes(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "datetime":
                    aliases.add(a.asname or "datetime")
    return aliases


def _datetime_class_names(tree: ast.AST) -> Set[str]:
    """Local names bound to the ``datetime``/``date`` CLASSES via
    ``from datetime import ...`` — ``datetime.now()`` spelled bare."""
    names = set()
    for node in astutil.nodes(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "datetime":
            for a in node.names:
                if a.name in DATETIME_CLASSES:
                    names.add(a.asname or a.name)
    return names


def _is_datetime_clock_read(nm: str, mod_aliases: Set[str],
                            class_names: Set[str]) -> bool:
    """True when dotted call name ``nm`` reads the wall clock through
    the datetime module: ``<mod>.datetime.now()``, ``<mod>.date
    .today()``, or ``<class>.now()``/``.utcnow()``/``.today()``.
    Constructors that transform an existing timestamp VALUE
    (``fromtimestamp``, ``combine``…) read no clock and stay exempt."""
    if "." not in nm:
        return False
    parts = nm.split(".")
    if parts[-1] not in DATETIME_CLOCK_FNS:
        return False
    if parts[0] in mod_aliases and len(parts) == 3 \
            and parts[1] in DATETIME_CLASSES:
        return True
    return parts[0] in class_names and len(parts) == 2


@rule("R7", "clock-discipline")
def check_clock_discipline(project: Project) -> Iterable[Finding]:
    """Direct ``time.time()``/``time.monotonic()``/``time.perf_counter()``
    calls (any import spelling) in ``raft_tpu_torch/serving/``,
    ``fleet/`` and ``core/memwatch.py`` outside a
    ``*Clock`` class — they bypass the injectable clock, so the
    manual-clock fault harness no longer controls the quantity being
    measured."""
    out: List[Finding] = []
    for f in project.lib():
        if f.tree is None or (not f.rel.startswith(SERVING_PREFIXES)
                              and f.rel not in EXTRA_FILES):
            continue
        clock_spans = _clock_class_spans(f.tree)
        mod_aliases = _time_module_aliases(f.tree)
        bare_names = _clock_fn_imports(f.tree)
        dt_mod_aliases = _datetime_aliases(f.tree)
        dt_class_names = _datetime_class_names(f.tree)
        for node in astutil.nodes(f.tree):
            if not isinstance(node, ast.Call):
                continue
            nm = astutil.call_name(node)
            if nm is None:
                continue
            if _is_datetime_clock_read(nm, dt_mod_aliases,
                                       dt_class_names):
                pass
            elif "." in nm:
                mod, fn = nm.split(".", 1)
                if mod not in mod_aliases or fn not in CLOCK_FNS:
                    continue
            elif nm not in bare_names:
                # a bare name is a clock read only when this module
                # imported it from `time` — locals stay exempt
                continue
            if any(lo <= node.lineno <= hi for lo, hi in clock_spans):
                continue
            out.append(Finding(
                "R7", f.rel, node.lineno,
                f"{nm}() in a serving module bypasses the injectable "
                "clock — take timestamps from the batcher clock "
                "(clock.now() / req.arrival) or put this inside the "
                "*Clock plumbing, or the manual-clock fault harness "
                "stops being deterministic"))
    return out
