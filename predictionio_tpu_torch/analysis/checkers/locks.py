"""PIO004 — no blocking work under a held lock.

The serving tier's p99 story depends on its locks being metadata-only:
the atomic-swap cutover holds ``_swap_lock`` for ONE reference
assignment, the metrics registry lock guards dict lookups, the fold-in
lock shuffles pending maps. A ``time.sleep``, a future ``.result()``,
file I/O, or an HTTP call inside such a ``with`` block turns every
reader of that lock into a convoy — the exact tail-latency cliff the
micro-batcher exists to avoid.

Scope is the latency-critical tree (``deploy/``, ``obs/``,
``data/write_buffer.py``, ``server/query_server.py``); lock-shaped
names (``*lock*``) in a ``with`` head put the body in scope. Code that
runs LATER (nested ``def``/``lambda`` bodies) is exempt — defining a
function under a lock is free.
"""

from __future__ import annotations

import ast
from typing import Iterable, Iterator

from predictionio_tpu_torch.analysis import registry
from predictionio_tpu_torch.analysis.callgraph import attr_path
from predictionio_tpu_torch.analysis.engine import FileChecker, Finding
from predictionio_tpu_torch.analysis.model import Project, SourceFile


def _is_lock_expr(expr: ast.expr) -> bool:
    name = None
    if isinstance(expr, ast.Attribute):
        name = expr.attr
    elif isinstance(expr, ast.Name):
        name = expr.id
    return bool(name and registry.LOCK_NAME_RE.search(name))


def _walk_immediate(body) -> Iterator[ast.AST]:
    """Walk statements, not descending into deferred-execution scopes."""
    todo = list(body)
    while todo:
        node = todo.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        todo.extend(ast.iter_child_nodes(node))


def _is_blocking(node: ast.Call) -> str:
    path = attr_path(node.func)
    if path in registry.BLOCKING_DOTTED:
        return path
    if isinstance(node.func, ast.Name) \
            and node.func.id in registry.BLOCKING_BUILTINS:
        return node.func.id
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr in registry.BLOCKING_ATTRS:
        return f".{node.func.attr}"
    if isinstance(node.func, ast.Attribute) and node.func.attr == "open" \
            and path is not None and ".fs." in f".{path}.":
        return path
    return ""


class BlockingUnderLock(FileChecker):
    rule = "PIO004"
    title = "blocking call lexically under a held lock"

    def check_file(self, f: SourceFile, project: Project
                   ) -> Iterable[Finding]:
        if not (f.path.startswith(registry.LOCK_SCOPE_PREFIXES)
                or f.path in registry.LOCK_SCOPE_FILES):
            return
        for node in ast.walk(f.tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            locks = [item.context_expr for item in node.items
                     if _is_lock_expr(item.context_expr)]
            if not locks:
                continue
            held = attr_path(locks[0]) or "lock"
            for sub in _walk_immediate(node.body):
                if isinstance(sub, ast.Call):
                    what = _is_blocking(sub)
                    if what:
                        yield self.finding(
                            f, sub,
                            f"{what}(...) while holding `{held}` convoys "
                            "every other holder; move the blocking work "
                            "outside the critical section")
