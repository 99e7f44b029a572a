"""Source model for the static-analysis engine.

A :class:`Project` is the unit every checker runs against: parsed
:class:`SourceFile` s plus lazily-built whole-program indexes. Projects
come from the real tree (:meth:`Project.from_root`) or from in-memory
fixture strings (:meth:`Project.from_sources`) so rule tests never have
to depend on repository files.

Suppression grammar (parsed with :mod:`tokenize`, so strings and
docstrings can never false-positive)::

    x = risky()          # pio: ignore[PIO002]: one-shot marker file
    # pio: ignore[PIO001, PIO007]: probe jit, result cached forever
    y = risky2()         # <- a standalone comment suppresses the NEXT line
    # pio: ignore-file[PIO100]: generated module, prints by design

A reason after the closing bracket is REQUIRED — a suppression that
does not say why is itself reported (rule PIO090), so silencing a rule
always leaves its argument in the code.
"""

from __future__ import annotations

import ast
import io
import pathlib
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

SUPPRESS_RE = re.compile(
    r"#\s*pio:\s*(?P<kind>ignore|ignore-file)\s*"
    r"\[(?P<rules>[A-Za-z0-9_,\s]*)\]\s*(?P<sep>[:—-]?)\s*"
    r"(?P<reason>.*)$")
#: anything that *looks* like it wants to be a suppression — used to
#: catch malformed spellings (missing brackets, unknown kind) as PIO090
SUPPRESS_HINT_RE = re.compile(r"#\s*pio:\s*ignore")

RULE_ID_RE = re.compile(r"^PIO\d{3}$")


@dataclass(frozen=True)
class Suppression:
    line: int                 #: line the suppression comment sits on
    rules: Tuple[str, ...]
    reason: str
    file_level: bool
    standalone: bool          #: comment is the only thing on its line


@dataclass
class SourceFile:
    """One parsed module plus its suppression table."""

    path: str                 #: project-root-relative posix path
    text: str
    tree: ast.AST
    lines: List[str]
    suppressions: List[Suppression] = field(default_factory=list)
    malformed: List[Tuple[int, str]] = field(default_factory=list)

    #: line -> rules suppressed on that line (directly or by a
    #: standalone comment on the line above); filled by _index()
    _line_rules: Dict[int, Set[str]] = field(default_factory=dict)
    _file_rules: Set[str] = field(default_factory=set)

    @classmethod
    def parse(cls, path: str, text: str) -> "SourceFile":
        tree = ast.parse(text, filename=path)
        sf = cls(path=path, text=text, tree=tree,
                 lines=text.splitlines())
        sf._collect_suppressions()
        sf._index()
        return sf

    def _collect_suppressions(self) -> None:
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO(self.text).readline))
        except (tokenize.TokenError, SyntaxError):
            return
        #: lines holding any non-comment, non-whitespace token
        code_lines: Set[int] = set()
        comments: List[tokenize.TokenInfo] = []
        for tok in tokens:
            if tok.type == tokenize.COMMENT:
                comments.append(tok)
            elif tok.type not in (tokenize.NL, tokenize.NEWLINE,
                                  tokenize.INDENT, tokenize.DEDENT,
                                  tokenize.ENDMARKER):
                code_lines.add(tok.start[0])
        for tok in comments:
            m = SUPPRESS_RE.search(tok.string)
            if not m:
                if SUPPRESS_HINT_RE.search(tok.string):
                    self.malformed.append(
                        (tok.start[0],
                         "unparseable suppression (expected "
                         "`# pio: ignore[RULE]: reason`)"))
                continue
            rules = tuple(r.strip() for r in m.group("rules").split(",")
                          if r.strip())
            reason = m.group("reason").strip()
            bad = [r for r in rules if not RULE_ID_RE.match(r)]
            if not rules or bad:
                self.malformed.append(
                    (tok.start[0],
                     f"suppression names no valid rule ids: {bad or '[]'}"))
                continue
            if not reason:
                self.malformed.append(
                    (tok.start[0],
                     f"suppression of {', '.join(rules)} has no reason — "
                     "`# pio: ignore[RULE]: why it is safe` is required"))
                continue
            self.suppressions.append(Suppression(
                line=tok.start[0], rules=rules, reason=reason,
                file_level=(m.group("kind") == "ignore-file"),
                standalone=tok.start[0] not in code_lines))

    def _index(self) -> None:
        for sup in self.suppressions:
            if sup.file_level:
                self._file_rules.update(sup.rules)
            elif sup.standalone:
                # a standalone comment shields the next line
                self._line_rules.setdefault(
                    sup.line + 1, set()).update(sup.rules)
            else:
                self._line_rules.setdefault(
                    sup.line, set()).update(sup.rules)

    def is_suppressed(self, rule: str, line: int) -> bool:
        if rule in self._file_rules:
            return True
        return rule in self._line_rules.get(line, ())

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""


class Project:
    """Everything the checkers see: sources + lazy whole-program indexes.

    ``aux`` maps non-Python project documents (README.md,
    OBSERVABILITY.md) to their text — the docs-drift checkers read them
    through :meth:`doc_text` so fixture projects can inject fakes.
    """

    def __init__(self, files: Sequence[SourceFile],
                 root: Optional[pathlib.Path] = None,
                 aux: Optional[Dict[str, str]] = None):
        self.files = list(files)
        self.root = root
        self._aux = dict(aux or {})
        self._functions = None          # callgraph.FunctionIndex, lazy
        self.parse_errors: List[Tuple[str, str]] = []

    # -- construction --------------------------------------------------------

    DEFAULT_DOCS = ("README.md", "OBSERVABILITY.md")

    @classmethod
    def from_root(cls, root, paths: Optional[Sequence[str]] = None
                  ) -> "Project":
        """Scan the real tree: ``predictionio_tpu_torch/**/*.py`` plus
        ``chip_smoke.py``, the port's counterpart of the reference's
        bench script (it has its own temp-write and env-knob surfaces).
        ``paths`` restricts the scan to specific root-relative files."""
        root = pathlib.Path(root).resolve()
        if paths:
            candidates = [root / p for p in paths]
        else:
            candidates = sorted((root / "predictionio_tpu_torch").rglob("*.py"))
            smoke = root / "chip_smoke.py"
            if smoke.is_file():
                candidates.append(smoke)
        files, errors = [], []
        for p in candidates:
            rel = p.relative_to(root).as_posix()
            try:
                files.append(SourceFile.parse(
                    rel, p.read_text(encoding="utf-8")))
            except (OSError, SyntaxError, ValueError) as e:
                errors.append((rel, str(e)))
        aux = {}
        for doc in cls.DEFAULT_DOCS:
            dp = root / doc
            if dp.is_file():
                aux[doc] = dp.read_text(encoding="utf-8")
        project = cls(files, root=root, aux=aux)
        project.parse_errors = errors
        return project

    @classmethod
    def from_sources(cls, sources: Dict[str, str],
                     aux: Optional[Dict[str, str]] = None) -> "Project":
        """A virtual project compiled from strings (rule fixtures)."""
        files = [SourceFile.parse(path, text)
                 for path, text in sorted(sources.items())]
        return cls(files, root=None, aux=aux)

    # -- lookups -------------------------------------------------------------

    def doc_text(self, name: str) -> Optional[str]:
        return self._aux.get(name)

    def file(self, path: str) -> Optional[SourceFile]:
        for f in self.files:
            if f.path == path:
                return f
        return None

    @property
    def functions(self):
        """The whole-program function/call index (built on first use)."""
        if self._functions is None:
            from predictionio_tpu_torch.analysis.callgraph import FunctionIndex

            self._functions = FunctionIndex(self)
        return self._functions
