"""Report rendering for graftlint — text for humans, JSON for build
artifacts, and a CI mode that prints both the findings and the full
suppression inventory (so every ``disable=`` shows up in the build log
next to its reason)."""

from __future__ import annotations

from raft_tpu_torch.analysis.core import RULES, Report


def render_text(report: Report, verbose: bool = False) -> str:
    lines = []
    for f in report.findings:
        lines.append(f.render())
    if verbose and report.suppressed:
        lines.append("")
        lines.append(f"suppressed ({len(report.suppressed)}):")
        for f, reason in report.suppressed:
            lines.append(f"  {f.render()}  [suppressed: {reason}]")
    status = "OK" if report.ok else "FAIL"
    lines.append(
        f"graftlint: {status} — {len(report.findings)} finding(s), "
        f"{len(report.suppressed)} suppressed, "
        f"{report.n_files} files, rules {','.join(report.rules_run)}")
    return "\n".join(lines) + "\n"


def render_suppressions(report: Report) -> str:
    """The suppression inventory — one line per pragma, with reason."""
    if not report.suppressions:
        return "graftlint: no suppressions\n"
    lines = [f"graftlint: {len(report.suppressions)} suppression(s):"]
    for s in sorted(report.suppressions,
                    key=lambda s: (s.path, s.pragma_line)):
        flag = "" if s.used else "  [UNUSED]"
        lines.append(
            f"  {s.path}:{s.pragma_line}: {s.rule} — {s.reason}{flag}")
    return "\n".join(lines) + "\n"


def render_ci(report: Report) -> str:
    return render_text(report, verbose=True) + render_suppressions(report)


def render_rules() -> str:
    lines = ["graftlint rules:"]
    for rid in sorted(RULES):
        r = RULES[rid]
        lines.append(f"  {rid} {r.name}: {r.doc}")
    return "\n".join(lines) + "\n"
