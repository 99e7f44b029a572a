"""PIO100/PIO101/PIO102 — the three pre-framework static gates, ported.

These were the reference's ad-hoc tests (no stray ``print``, the
metric-docs drift gate, the engines' per-event ``find`` check) before
its engine existed; the logic lives here in one place.
"""

from __future__ import annotations

import ast
import io
import re
import token
import tokenize
from typing import Dict, Iterable, List, Set, Tuple

from predictionio_tpu_torch.analysis import registry
from predictionio_tpu_torch.analysis.callgraph import module_str_constants
from predictionio_tpu_torch.analysis.engine import Checker, FileChecker, Finding
from predictionio_tpu_torch.analysis.model import Project, SourceFile

# -- PIO100: no stray print() ------------------------------------------------


def print_call_lines(source: str) -> List[int]:
    """Line numbers where the print *builtin* is called. Tokenize-based
    (not regex) so string literals, comments, ``x.print(`` and names
    merely ending in "print" can never false-positive, and the
    ``print=None`` kwarg to aiohttp's run_app never matches."""
    toks = [t for t in tokenize.generate_tokens(io.StringIO(source).readline)
            if t.type not in (token.NL, token.NEWLINE, token.INDENT,
                              token.DEDENT, tokenize.COMMENT)]
    out = []
    for i, t in enumerate(toks):
        if t.type != token.NAME or t.string != "print":
            continue
        if i + 1 >= len(toks) or toks[i + 1].string != "(":
            continue
        if i > 0 and toks[i - 1].string in (".", "def"):
            continue
        out.append(t.start[0])
    return out


class StrayPrint(FileChecker):
    rule = "PIO100"
    title = "stray print() call (use logging or the obs registry)"

    def check_file(self, f: SourceFile, project: Project
                   ) -> Iterable[Finding]:
        if not f.path.startswith(registry.PKG_PREFIX):
            return
        try:
            lines = print_call_lines(f.text)
        except (tokenize.TokenError, SyntaxError):
            return                       # parse errors surface elsewhere
        for line in lines:
            yield Finding(
                rule=self.rule, path=f.path, line=line,
                message="print() bypasses log-level control and corrupts "
                        "stdout-protocol subprocesses; use logging or "
                        "the obs metrics registry",
                snippet=f.line_text(line))


# -- PIO101: OBSERVABILITY.md metric inventory drift -------------------------

REGISTRY_METHODS = {"counter", "gauge", "gauge_callback", "histogram"}
METRIC_RE = re.compile(r"^pio_[a-z0-9_]+$")
DOC_TOKEN_RE = re.compile(r"\bpio_[a-z0-9_]+\b")

#: names OBSERVABILITY.md uses ONLY as illustrative examples in the
#: "Using it from new code" section — not part of the real inventory
DOC_EXAMPLE_WHITELIST = {"pio_cache_hits_total", "pio_upload_seconds"}

#: series OBSERVABILITY.md documents that the port leaves out by design:
#: the jit-compile ledger and JAX's live-buffer and device gauges have
#: no torch subject (ROADMAP: no ``pio_jax_*`` series; the capacity
#: ledger reads the CUDA allocator instead). PIO101 holds the port to
#: every other documented series, in both directions.
SERIES_NOT_PORTED = {"pio_jax_compile_total", "pio_jax_device_count",
                     "pio_jax_live_buffer_bytes",
                     "pio_jax_live_buffer_count"}

#: workflow_run_metrics(workflow, metric_prefix) registers
#: f"{prefix}_runs_total" + f"{prefix}_duration_seconds" — the one
#: dynamic naming pattern in the tree, expanded per literal call site
RUN_METRIC_SUFFIXES = ("_runs_total", "_duration_seconds")


def registered_metric_names(project: Project
                            ) -> Dict[str, Tuple[str, int]]:
    """metric name -> (path, line) of its first registration site."""
    names: Dict[str, Tuple[str, int]] = {}
    for f in project.files:
        if not f.path.startswith(registry.PKG_PREFIX):
            continue
        consts = module_str_constants(f.tree)
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            fn = node.func
            fn_name = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else None)
            if fn_name == "workflow_run_metrics" and len(node.args) >= 2:
                prefix = node.args[1]
                if isinstance(prefix, ast.Constant) \
                        and isinstance(prefix.value, str):
                    for suffix in RUN_METRIC_SUFFIXES:
                        names.setdefault(prefix.value + suffix,
                                         (f.path, node.lineno))
                continue
            if fn_name == "_get_or_create" and len(node.args) >= 2:
                arg = node.args[1]
            elif fn_name in REGISTRY_METHODS:
                arg = node.args[0]
            else:
                continue
            candidates: Set[str] = set()
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                candidates.add(arg.value)
            elif isinstance(arg, ast.Name):
                candidates.update(consts.get(arg.id, ()))
            for v in candidates:
                if METRIC_RE.match(v):
                    names.setdefault(v, (f.path, node.lineno))
    return names


def documented_metric_names(doc_text: str) -> Set[str]:
    tokens = set(DOC_TOKEN_RE.findall(doc_text))
    return {t for t in tokens
            if t not in DOC_EXAMPLE_WHITELIST and t not in SERIES_NOT_PORTED}


class MetricDocsDrift(Checker):
    rule = "PIO101"
    title = "pio_* metric inventory drift vs OBSERVABILITY.md"

    DOC = "OBSERVABILITY.md"

    def run(self, project: Project) -> Iterable[Finding]:
        doc_text = project.doc_text(self.DOC)
        if doc_text is None:
            return
        registered = registered_metric_names(project)
        documented = documented_metric_names(doc_text)
        for name in sorted(set(registered) - documented):
            path, line = registered[name]
            yield Finding(
                rule=self.rule, path=path, line=line,
                message=f"metric {name} is registered here but absent "
                        f"from {self.DOC} — add it to the inventory",
                snippet=(project.file(path) or SourceFile
                         .parse("x.py", "")).line_text(line))
        doc_lines = doc_text.splitlines()
        for name in sorted(documented - set(registered)):
            line = next((i + 1 for i, text in enumerate(doc_lines)
                         if name in text), 0)
            yield Finding(
                rule=self.rule, path=self.DOC, line=line,
                message=f"{self.DOC} documents {name} but no code "
                        "registers it — the inventory rotted; remove "
                        "or fix it",
                snippet=doc_lines[line - 1].strip() if line else "")


# -- PIO102: no per-Event row scans in engine training reads -----------------

ROW_STORES = ("EventStoreClient", "PEventStore", "LEventStore")


class EngineRowFind(FileChecker):
    rule = "PIO102"
    title = "per-Event row scan in an engine (use the columnar path)"

    def check_file(self, f: SourceFile, project: Project
                   ) -> Iterable[Finding]:
        if not f.path.startswith(registry.ENGINES_PREFIX):
            return
        for node in ast.walk(f.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "find"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in ROW_STORES):
                yield self.finding(
                    f, node,
                    f"{node.func.value.id}.find is the per-Event "
                    "serving-era iterator; training reads go through "
                    "the columnar path (find_columnar / training_scan "
                    "/ aggregate_scan)")
