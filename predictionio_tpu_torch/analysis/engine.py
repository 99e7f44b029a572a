"""Checker SPI, baseline semantics, and reports for `pio check`.

A checker is a class with a ``rule`` id and a ``run(project)`` that
yields :class:`Finding` s. Per-file checkers subclass
:class:`FileChecker` (one ``check_file`` per module); whole-program
checkers subclass :class:`Checker` directly and read
``project.functions`` — the cross-module call/import index.

Suppressions are applied by the engine, never by checkers; a rule
author cannot forget them. The committed baseline grandfathers
pre-existing findings by (rule, path, line-content) — NOT line number —
so unrelated edits above a baselined finding don't resurface it, while
any edit to the offending line itself does.
"""

from __future__ import annotations

import json
import pathlib
from collections import Counter
from dataclasses import asdict, dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.analysis.model import Project, SourceFile

BASELINE_VERSION = 1
#: the port's own baseline, beside the reference's
#: ``conf/pio_check_baseline.json``
DEFAULT_BASELINE = "conf/pio_check_baseline_torch.json"


@dataclass(frozen=True, order=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str
    snippet: str = ""           #: stripped offending source line
    col: int = 0

    @property
    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.snippet)


class Checker:
    """Whole-program checker base; subclasses set rule/title and
    implement :meth:`run`."""

    rule: str = ""
    title: str = ""

    def run(self, project: Project) -> Iterable[Finding]:
        raise NotImplementedError

    # -- helpers -------------------------------------------------------------

    def finding(self, f: SourceFile, node, message: str) -> Finding:
        line = getattr(node, "lineno", node if isinstance(node, int) else 0)
        col = getattr(node, "col_offset", 0)
        return Finding(rule=self.rule, path=f.path, line=line, col=col,
                       message=message, snippet=f.line_text(line))


class FileChecker(Checker):
    """Per-file AST checker base."""

    def run(self, project: Project) -> Iterable[Finding]:
        for f in project.files:
            yield from self.check_file(f, project)

    def check_file(self, f: SourceFile, project: Project
                   ) -> Iterable[Finding]:
        raise NotImplementedError


class SuppressionHygiene(Checker):
    """PIO090: malformed suppression comments.

    A suppression with no rule id or no reason is itself a finding —
    the escape hatch must always carry its justification."""

    rule = "PIO090"
    title = "malformed `# pio: ignore` suppression"

    def run(self, project: Project) -> Iterable[Finding]:
        for f in project.files:
            for line, msg in f.malformed:
                yield Finding(rule=self.rule, path=f.path, line=line,
                              message=msg, snippet=f.line_text(line))


class Baseline:
    """Multiset of grandfathered findings keyed (rule, path, snippet)."""

    def __init__(self, entries: Optional[Counter] = None):
        self.entries: Counter = Counter(entries or ())

    @classmethod
    def from_findings(cls, findings: Iterable[Finding]) -> "Baseline":
        return cls(Counter(f.key for f in findings))

    @classmethod
    def load(cls, path) -> "Baseline":
        doc = json.loads(pathlib.Path(path).read_text(encoding="utf-8"))
        entries: Counter = Counter()
        for e in doc.get("findings", []):
            entries[(e["rule"], e["path"], e.get("snippet", ""))] += \
                int(e.get("count", 1))
        return cls(entries)

    def save(self, path) -> None:
        findings = [{"rule": r, "path": p, "snippet": s, "count": n}
                    for (r, p, s), n in sorted(self.entries.items())]
        doc = {"version": BASELINE_VERSION,
               "comment": "grandfathered `pio check` findings — shrink "
                          "this file, never grow it (new findings must "
                          "be fixed or suppressed with a reason)",
               "findings": findings}
        pathlib.Path(path).write_text(
            json.dumps(doc, indent=2, sort_keys=True) + "\n",
            encoding="utf-8")

    def split(self, findings: Sequence[Finding]
              ) -> Tuple[List[Finding], List[Finding]]:
        """(new, baselined): each baseline entry absorbs up to `count`
        matching findings."""
        budget = Counter(self.entries)
        new, matched = [], []
        for f in findings:
            if budget[f.key] > 0:
                budget[f.key] -= 1
                matched.append(f)
            else:
                new.append(f)
        return new, matched


@dataclass
class Report:
    findings: List[Finding]             #: NEW findings (not baselined)
    baselined: List[Finding]
    rules: List[str]
    files_checked: int
    parse_errors: List[Tuple[str, str]]

    @property
    def ok(self) -> bool:
        return not self.findings and not self.parse_errors

    def to_json(self) -> dict:
        return {
            "version": 1,
            "ok": self.ok,
            "rules": self.rules,
            "filesChecked": self.files_checked,
            "findings": [asdict(f) for f in self.findings],
            "baselinedCount": len(self.baselined),
            "parseErrors": [{"path": p, "error": e}
                            for p, e in self.parse_errors],
        }

    def render(self) -> str:
        lines = []
        for f in self.findings:
            lines.append(f"{f.path}:{f.line}:{f.col}: {f.rule} {f.message}")
            if f.snippet:
                lines.append(f"    {f.snippet}")
        for p, e in self.parse_errors:
            lines.append(f"{p}: unparseable: {e}")
        n = len(self.findings)
        lines.append(
            f"{n} finding{'s' if n != 1 else ''} "
            f"({len(self.baselined)} baselined, "
            f"{self.files_checked} files, "
            f"{len(self.rules)} rules)")
        return "\n".join(lines)


def all_checkers() -> List[Checker]:
    from predictionio_tpu_torch.analysis.checkers import ALL_CHECKERS

    return [cls() for cls in ALL_CHECKERS] + [SuppressionHygiene()]


def all_rules() -> Dict[str, str]:
    """rule id -> title, for --rule validation and docs."""
    return {c.rule: c.title for c in all_checkers()}


def run_check(project: Project,
              rules: Optional[Sequence[str]] = None,
              baseline: Optional[Baseline] = None,
              paths: Optional[Sequence[str]] = None) -> Report:
    """Run checkers over a project; returns the report with suppressions
    and baseline already applied.

    ``paths`` filters which files findings are REPORTED for — the whole
    project is still parsed and indexed, so whole-program rules
    (committer reachability, builder routing, docs drift) see the full
    tree even when the operator asks about one file."""
    checkers = all_checkers()
    if rules:
        wanted = set(rules)
        unknown = wanted - {c.rule for c in checkers}
        if unknown:
            raise ValueError(f"unknown rule(s): {sorted(unknown)}")
        checkers = [c for c in checkers if c.rule in wanted]
    raw: List[Finding] = []
    for checker in checkers:
        raw.extend(checker.run(project))
    wanted = [p.rstrip("/") for p in paths] if paths else None

    def in_scope(path: str) -> bool:
        return wanted is None or any(
            path == p or path.startswith(p + "/") for p in wanted)

    kept = []
    for f in sorted(raw):
        if not in_scope(f.path):
            continue
        sf = project.file(f.path)
        if sf is not None and sf.is_suppressed(f.rule, f.line):
            continue
        kept.append(f)
    new, matched = (baseline or Baseline()).split(kept)
    return Report(findings=new, baselined=matched,
                  rules=sorted(c.rule for c in checkers),
                  files_checked=len(project.files),
                  parse_errors=list(project.parse_errors))
