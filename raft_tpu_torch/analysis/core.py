"""graftlint core model for the port — source files, suppression
pragmas, the rule registry, and the runner.

The analyzer is self-contained (stdlib ``ast`` only); it never
*executes* the code it checks, it only parses it, so the CLI
(``python -m raft_tpu_torch.analysis``) runs where JAX is absent.

A project holds two kinds of source: Python files (parsed to an AST)
and the CUDA sources under ``raft_tpu_torch/csrc/`` (``*.cu``,
``*.cuh``), which are kept as text for the launch-budget rule (R4).

Suppressions are written next to the finding they silence::

    x = risky()  # graftlint: disable=R5(one host read a request)

or on their own line, covering the next statement::

    # graftlint: disable=R3(process-group barrier between writers)
    dist.barrier()

In a CUDA source the comment starts with ``//`` instead of ``#``.
The rule id must match and the parenthesized reason is mandatory —
a pragma without a reason, and a pragma that silences nothing, are
themselves findings (rule R0), so the suppression inventory can only
grow deliberately and is snapshot-tested.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import io
import json
import pathlib
import re
import tokenize
from typing import Callable, Dict, Iterable, List, Optional, Sequence

PRAGMA_RE = re.compile(r"#\s*graftlint:\s*disable=(.*?)\s*$")
PRAGMA_ID_RE = re.compile(r"\s*([A-Z][A-Z0-9]*)\s*")


def parse_pragma_items(payload: str):
    """Parse ``R1(reason), R5(reason with (parens))`` — returns
    ([(rule, reason-or-None)], trailing-garbage-flag). Reasons may
    contain balanced parentheses."""
    items = []
    pos, bad = 0, False
    while pos < len(payload):
        m = PRAGMA_ID_RE.match(payload, pos)
        if not m:
            bad = bad or bool(payload[pos:].strip(", \t"))
            break
        rule_id = m.group(1)
        pos = m.end()
        reason = None
        if pos < len(payload) and payload[pos] == "(":
            depth, start = 1, pos + 1
            pos += 1
            while pos < len(payload) and depth:
                if payload[pos] == "(":
                    depth += 1
                elif payload[pos] == ")":
                    depth -= 1
                pos += 1
            if depth:
                bad = True
                break
            reason = payload[start:pos - 1]
        items.append((rule_id, reason))
        rest = payload[pos:].lstrip()
        if rest.startswith(","):
            pos = len(payload) - len(rest) + 1
        elif rest:
            bad = True
            break
        else:
            break
    return items, bad

#: the port's package: its Python modules are the library (kind
#: ``lib``), its CUDA sources (kind ``csrc``) are read as text
PACKAGE = "raft_tpu_torch"
#: what a repo run scans, as (directory, glob) relative to the root —
#: the package, the port's own tests and scripts, and the chip smoke
SCAN_GLOBS = (
    (PACKAGE, "**/*.py"),
    (PACKAGE + "/csrc", "*.cu"),
    (PACKAGE + "/csrc", "*.cuh"),
    ("tests", "test_torch_*.py"),
    ("scripts", "torch_*.py"),
    (".", "chip_smoke.py"),
)
#: the suffixes of the sources kept as text, not parsed
TEXT_SUFFIXES = (".cu", ".cuh")

#: the port's metric inventory, which R9 holds the registered names to
METRICS_DOC = PACKAGE + "/METRICS.md"
#: the port's benchmark gate (its ``SNAPSHOT_FLOORS``), which R9 reads
#: when the file exists; the port has none yet, so that check is quiet
BENCH_GATE = "ci/torch_bench_compare.py"
#: non-scanned files the whole-program rules read as evidence
AUX_FILES = (METRICS_DOC, BENCH_GATE)


def file_kind(rel: str) -> str:
    """``lib`` / ``csrc`` for the package, ``tests`` / ``scripts`` /
    ``smoke`` for the rest of the scan set, else ``other``."""
    parts = rel.split("/")
    if parts[0] == PACKAGE:
        return "csrc" if rel.endswith(TEXT_SUFFIXES) else "lib"
    if parts[0] in ("tests", "scripts"):
        return parts[0]
    if rel == "chip_smoke.py":
        return "smoke"
    return "other"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str  # repo-relative posix path
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


@dataclasses.dataclass
class Suppression:
    """One ``# graftlint: disable=RULE(reason)`` pragma."""

    rule: str
    path: str
    line: int          # code line the pragma covers
    pragma_line: int   # line the comment physically sits on
    reason: str
    used: bool = False


def _cxx_comment_col(line: str) -> int:
    """Column of the ``//`` that starts a comment on a C++ line (outside
    string and character literals), else -1."""
    quote = None
    i = 0
    while i < len(line):
        c = line[i]
        if quote:
            if c == "\\":
                i += 1
            elif c == quote:
                quote = None
        elif c in "\"'":
            quote = c
        elif line.startswith("//", i):
            return i
        i += 1
    return -1


class SourceFile:
    """A source file (parsed, or kept as text for a CUDA source) plus
    its suppression pragmas."""

    def __init__(self, rel: str, text: str):
        self.rel = rel.replace("\\", "/")
        self.kind = file_kind(self.rel)
        #: a CUDA source: text only, ``//`` pragmas
        self.is_text = self.rel.endswith(TEXT_SUFFIXES)
        self.text = text
        self.lines = text.splitlines()
        self.syntax_error: Optional[SyntaxError] = None
        self.tree: Optional[ast.AST] = None
        if not self.is_text:
            try:
                self.tree = ast.parse(text)
            except SyntaxError as e:
                self.syntax_error = e
        self.suppressions: List[Suppression] = []
        self.bad_pragmas: List[tuple] = []  # (line, why)
        self._parse_pragmas()

    # -- pragmas ------------------------------------------------------------

    def _stmt_start(self, line: int) -> int:
        """First line of the innermost statement spanning ``line`` —
        findings anchor to a node's first line, so a pragma trailing a
        *continuation* line of a multi-line statement must map back to
        the statement start to suppress anything."""
        if self.tree is None:
            return line
        best = line
        best_span = None
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.stmt):
                continue
            end = getattr(node, "end_lineno", node.lineno)
            if node.lineno <= line <= end:
                span = end - node.lineno
                if best_span is None or span <= best_span:
                    best, best_span = node.lineno, span
        return best

    def _covered_line(self, pragma_line: int, own_line: bool) -> int:
        """A trailing pragma covers its statement; a comment-only
        pragma covers the statement starting at (or spanning) the next
        non-blank, non-comment line."""
        if own_line:
            return self._stmt_start(pragma_line)
        comment = "//" if self.is_text else "#"
        for j in range(pragma_line, len(self.lines)):
            nxt = self.lines[j].strip()
            if nxt and not nxt.startswith(comment):
                return self._stmt_start(j + 1)
        return pragma_line

    def _comment_tokens(self):
        """Real COMMENT tokens only — a pragma quoted inside a
        docstring (e.g. this module's own examples) is not a pragma.
        In a CUDA source, the ``//`` comments (``#`` there starts a
        preprocessor line, never a pragma)."""
        if self.is_text:
            for i, line in enumerate(self.lines, 1):
                col = _cxx_comment_col(line)
                if col >= 0:
                    yield i, col, "#" + line[col + 2:]
            return
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(self.text).readline):
                if tok.type == tokenize.COMMENT:
                    yield tok.start[0], tok.start[1], tok.string
        except (tokenize.TokenError, IndentationError, SyntaxError):
            return

    def _parse_pragmas(self) -> None:
        for i, col, comment in self._comment_tokens():
            m = PRAGMA_RE.search(comment)
            if not m:
                continue
            own_line = bool(self.lines[i - 1][:col].strip())
            covered = self._covered_line(i, own_line)
            items, bad = parse_pragma_items(m.group(1))
            for rule_id, reason in items:
                if reason is None or not reason.strip():
                    self.bad_pragmas.append(
                        (i, f"suppression of {rule_id} carries no reason "
                            "— write disable="
                            f"{rule_id}(why this is safe)"))
                    continue
                self.suppressions.append(Suppression(
                    rule=rule_id, path=self.rel, line=covered,
                    pragma_line=i, reason=reason.strip()))
            if bad or not items:
                self.bad_pragmas.append(
                    (i, "malformed graftlint pragma — expected "
                        "disable=RULE(reason)"))

    def suppression_for(self, rule: str, line: int) -> Optional[Suppression]:
        # findings anchor to a node's own line, which for a multi-line
        # statement may be a continuation line — normalize both sides
        # to the statement start so a trailing pragma anywhere in the
        # statement suppresses any finding inside it
        stmt = self._stmt_start(line)
        for s in self.suppressions:
            if s.rule == rule and s.line in (line, stmt):
                return s
        return None


class Project:
    """The set of files one analysis run sees.

    ``aux`` carries the non-Python evidence whole-program rules
    cross-check against (the port's ``METRICS.md`` tables, a bench
    gate's ``SNAPSHOT_FLOORS``) as ``{repo-relative path: text}`` —
    absent entries simply disable the corresponding check, so fixture
    projects opt in per test.
    """

    def __init__(self, files: Sequence[SourceFile],
                 root: Optional[pathlib.Path] = None,
                 aux: Optional[Dict[str, str]] = None):
        self.files = list(files)
        self.root = root
        self.by_rel = {f.rel: f for f in self.files}
        self.aux = dict(aux or {})

    @classmethod
    def from_root(cls, root, globs: Sequence[tuple] = SCAN_GLOBS
                  ) -> "Project":
        root = pathlib.Path(root).resolve()
        files = []
        for d, pattern in globs:
            base = root / d
            if not base.is_dir():
                continue
            for path in sorted(base.glob(pattern)):
                if "__pycache__" in path.parts or not path.is_file():
                    continue
                rel = path.relative_to(root).as_posix()
                files.append(SourceFile(rel, path.read_text()))
        aux = {}
        for rel in AUX_FILES:
            p = root / rel
            if p.exists():
                aux[rel] = p.read_text()
        return cls(files, root, aux)

    @classmethod
    def from_texts(cls, texts: Dict[str, str],
                   aux: Optional[Dict[str, str]] = None) -> "Project":
        """Synthetic project for the fixture corpus: path -> source."""
        return cls([SourceFile(rel, text)
                    for rel, text in sorted(texts.items())], aux=aux)

    def lib(self) -> List[SourceFile]:
        return [f for f in self.files if f.kind == "lib"]

    def csrc(self) -> List[SourceFile]:
        return [f for f in self.files if f.kind == "csrc"]

    def tests(self) -> List[SourceFile]:
        return [f for f in self.files if f.kind == "tests"]


# ---------------------------------------------------------------------------
# rule registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    name: str
    doc: str
    check: Callable[[Project], Iterable[Finding]]
    #: "file" — findings for a file depend only on that file's text, so
    #: the incremental cache can key them per (file sha, rule-set
    #: version); "program" — findings depend on the whole tree (cross
    #: -module graph, test↔lib coverage, doc cross-checks), cached per
    #: project digest instead
    scope: str = "file"


RULES: Dict[str, Rule] = {}


def rule(rule_id: str, name: str, scope: str = "file"):
    """Register a checker under a rule id. The checker's docstring is
    the rule's documentation (surfaced by ``--list-rules``)."""
    assert scope in ("file", "program"), scope

    def deco(fn):
        doc = " ".join((fn.__doc__ or "").split())
        RULES[rule_id] = Rule(rule_id, name, doc, fn, scope)
        return fn

    return deco


# ---------------------------------------------------------------------------
# incremental cache
# ---------------------------------------------------------------------------


def _sha1(text: str) -> str:
    return hashlib.sha1(text.encode("utf-8", "replace")).hexdigest()


def ruleset_version(package_dir: Optional[pathlib.Path] = None) -> str:
    """Content hash of the analysis package itself — any edit to a rule
    or this runner invalidates every cache entry, so a stale cache can
    never mask a new rule's findings."""
    base = package_dir or pathlib.Path(__file__).resolve().parent
    h = hashlib.sha1()
    for p in sorted(base.glob("*.py")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


class LintCache:
    """Content-hash finding cache
    (``raft_tpu_torch/_build/graftlint_cache.json``).

    File-scope rules key per ``(file sha, rule-set version)``;
    whole-program rules key on the project digest (every file sha +
    every aux text). Raw findings are cached *pre-suppression* — the
    pragma fold is cheap and always runs fresh, so editing only a
    pragma still flips a finding's suppressed state on a full cache
    hit.
    """

    def __init__(self, path, version: str):
        self.path = pathlib.Path(path)
        self.version = version
        self.hits = 0
        self.misses = 0
        self._dirty = False
        data: dict = {}
        try:
            data = json.loads(self.path.read_text())
        except (OSError, ValueError):
            data = {}
        if data.get("version") != version:
            data = {}
        self._files: dict = data.get("files", {})
        self._program: dict = data.get("program", {})

    @staticmethod
    def _load(items) -> List[Finding]:
        return [Finding(**d) for d in items]

    def get_file(self, rule_id: str, rel: str,
                 sha: str) -> Optional[List[Finding]]:
        entry = self._files.get(rel)
        if entry is None or entry.get("sha") != sha:
            return None
        found = entry.get("rules", {}).get(rule_id)
        return None if found is None else self._load(found)

    def put_file(self, rule_id: str, rel: str, sha: str,
                 findings: List[Finding]) -> None:
        entry = self._files.setdefault(rel, {"sha": sha, "rules": {}})
        if entry.get("sha") != sha:
            self._files[rel] = entry = {"sha": sha, "rules": {}}
        entry["rules"][rule_id] = [dataclasses.asdict(f)
                                   for f in findings]
        self._dirty = True

    def get_program(self, rule_id: str,
                    digest: str) -> Optional[List[Finding]]:
        entry = self._program.get(rule_id)
        if entry is None or entry.get("digest") != digest:
            return None
        return self._load(entry.get("findings", []))

    def put_program(self, rule_id: str, digest: str,
                    findings: List[Finding]) -> None:
        self._program[rule_id] = {
            "digest": digest,
            "findings": [dataclasses.asdict(f) for f in findings]}
        self._dirty = True

    def prune(self, live_rels: Iterable[str]) -> None:
        """Drop entries for files no longer in the project."""
        live = set(live_rels)
        for rel in list(self._files):
            if rel not in live:
                del self._files[rel]
                self._dirty = True

    def save(self) -> None:
        if not self._dirty:
            return
        payload = {"version": self.version, "files": self._files,
                   "program": self._program}
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self.path.write_text(json.dumps(payload) + "\n")
        except OSError:
            pass  # a read-only checkout still lints, just uncached


def project_digest(project: Project) -> str:
    """One hash over every file and aux text — the whole-program cache
    key component."""
    h = hashlib.sha1()
    for f in sorted(project.files, key=lambda f: f.rel):
        h.update(f.rel.encode())
        h.update(_sha1(f.text).encode())
    for rel in sorted(project.aux):
        h.update(rel.encode())
        h.update(_sha1(project.aux[rel]).encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Report:
    findings: List[Finding]                 # unsuppressed — gate on these
    suppressed: List[tuple]                 # (Finding, reason)
    suppressions: List[Suppression]         # full inventory
    rules_run: List[str]
    n_files: int
    cache_hits: int = 0
    cache_misses: int = 0
    cache_enabled: bool = False

    @property
    def ok(self) -> bool:
        return not self.findings

    def suppression_inventory(self) -> List[List[str]]:
        """The canonical ``[path, rule, reason]`` inventory, sorted —
        the ONE shape the snapshot test, ``--list-suppressions``, and
        the ``--output`` JSON report all read."""
        return sorted([s.path, s.rule, s.reason]
                      for s in self.suppressions)

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "rules_run": self.rules_run,
            "n_files": self.n_files,
            "cache": {"enabled": self.cache_enabled,
                      "hits": self.cache_hits,
                      "misses": self.cache_misses},
            "findings": [dataclasses.asdict(f) for f in self.findings],
            "suppressed": [
                dict(dataclasses.asdict(f), reason=reason)
                for f, reason in self.suppressed
            ],
            "suppressions": [dataclasses.asdict(s)
                             for s in self.suppressions],
            "suppression_inventory": self.suppression_inventory(),
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2) + "\n"


def _run_rules(project: Project, selected: Sequence[str],
               cache: Optional[LintCache]) -> List[Finding]:
    """Raw (pre-suppression) findings, served from the cache where the
    content hashes allow."""
    raw: List[Finding] = []
    if cache is None:
        for rid in selected:
            raw.extend(RULES[rid].check(project))
        return raw

    digest = project_digest(project)
    shas = {f.rel: _sha1(f.text) for f in project.files}
    cache.prune(shas)
    for rid in selected:
        r = RULES[rid]
        if r.scope == "program":
            cached = cache.get_program(rid, digest)
            if cached is not None:
                cache.hits += 1
                raw.extend(cached)
            else:
                cache.misses += 1
                found = list(r.check(project))
                cache.put_program(rid, digest, found)
                raw.extend(found)
            continue
        # file scope: serve per-file hits, re-lint only the misses as
        # a sub-project (sound because a file-scope rule's findings
        # for a file depend only on that file's text)
        missing: List[SourceFile] = []
        for f in project.files:
            cached = cache.get_file(rid, f.rel, shas[f.rel])
            if cached is not None:
                cache.hits += 1
                raw.extend(cached)
            else:
                cache.misses += 1
                missing.append(f)
        if not missing:
            continue
        sub = Project(missing, project.root, project.aux)
        fresh = list(r.check(sub))
        by_rel: Dict[str, List[Finding]] = {f.rel: [] for f in missing}
        for fd in fresh:
            by_rel.setdefault(fd.path, []).append(fd)
        for f in missing:
            cache.put_file(rid, f.rel, shas[f.rel],
                           by_rel.get(f.rel, []))
        raw.extend(fresh)
    return raw


def run(project: Project, rules: Optional[Sequence[str]] = None,
        cache: Optional[LintCache] = None) -> Report:
    """Run ``rules`` (default: all registered) over ``project`` and
    fold in suppression pragmas + pragma hygiene. With ``cache``,
    unchanged (file sha, rule-set version) work is served from the
    content-hash cache and the hit/miss counts land in the report."""
    selected = list(rules) if rules is not None else sorted(RULES)
    unknown = [r for r in selected if r not in RULES]
    if unknown:
        raise ValueError(f"unknown rule(s) {unknown}; have {sorted(RULES)}")

    raw = _run_rules(project, selected, cache)

    findings: List[Finding] = []
    suppressed: List[tuple] = []
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.rule)):
        sf = project.by_rel.get(f.path)
        sup = sf.suppression_for(f.rule, f.line) if sf else None
        if sup is not None:
            sup.used = True
            suppressed.append((f, sup.reason))
        else:
            findings.append(f)

    # pragma hygiene rides rule R0 (it is style discipline); an unused
    # pragma only counts against rules that actually ran this pass
    inventory: List[Suppression] = []
    for sf in project.files:
        if "R0" in selected:
            for line, why in sf.bad_pragmas:
                findings.append(Finding("R0", sf.rel, line, why))
        for s in sf.suppressions:
            inventory.append(s)
            if "R0" not in selected:
                continue
            if s.rule not in RULES:
                findings.append(Finding(
                    "R0", sf.rel, s.pragma_line,
                    f"suppression names unknown rule {s.rule!r} "
                    f"(registered: {', '.join(sorted(RULES))}) — a "
                    "typo'd id silences nothing"))
            elif not s.used and s.rule in selected:
                findings.append(Finding(
                    "R0", sf.rel, s.pragma_line,
                    f"unused suppression of {s.rule} — the rule no "
                    "longer fires here; delete the pragma"))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    if cache is not None:
        cache.save()
    return Report(findings=findings, suppressed=suppressed,
                  suppressions=inventory, rules_run=selected,
                  n_files=len(project.files),
                  cache_hits=cache.hits if cache else 0,
                  cache_misses=cache.misses if cache else 0,
                  cache_enabled=cache is not None)
