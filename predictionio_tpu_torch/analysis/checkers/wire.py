"""PIO008 — serialized wire paths must be deterministic.

Two shapes of accidental nondeterminism reach the wire:

* mutable default arguments — ``def serve(q, extras=[])`` shares ONE
  list across every call on the process, so one request's mutation
  leaks into the next (and differs per replica with traffic order);
  flagged package-wide, it is never what anyone means;
* iteration over an unordered ``set`` while building a wire document —
  set order varies per process (PYTHONHASHSEED), so two replicas
  serialize the same answer differently, breaking response diffing,
  batchpredict output parity, and the canary comparator. Flagged in
  the wire modules (``data/event.py``, ``data/columnar.py``,
  ``workflow/serialization.py``, ``obs/fleet.py``); sort the set at
  the boundary instead.
"""

from __future__ import annotations

import ast
from typing import Iterable

from predictionio_tpu_torch.analysis import registry
from predictionio_tpu_torch.analysis.callgraph import attr_path
from predictionio_tpu_torch.analysis.engine import FileChecker, Finding
from predictionio_tpu_torch.analysis.model import Project, SourceFile

MUTABLE_CALLS = frozenset({"list", "dict", "set", "defaultdict",
                           "OrderedDict", "Counter", "deque"})


def _is_mutable_default(node: ast.expr) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        path = attr_path(node.func)
        return bool(path and path.split(".")[-1] in MUTABLE_CALLS)
    return False


def _is_set_expr(node: ast.expr) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        name = attr_path(node.func)
        return name in ("set", "frozenset")
    return False


class WireNondeterminism(FileChecker):
    rule = "PIO008"
    title = "mutable default arg / unordered-set iteration on wire path"

    def check_file(self, f: SourceFile, project: Project
                   ) -> Iterable[Finding]:
        for node in ast.walk(f.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                args = node.args
                defaults = list(args.defaults) + \
                    [d for d in args.kw_defaults if d is not None]
                for d in defaults:
                    if _is_mutable_default(d):
                        name = getattr(node, "name", "<lambda>")
                        yield self.finding(
                            f, d,
                            f"mutable default argument on `{name}` is "
                            "shared across every call on the process; "
                            "default to None and build inside")
            if f.path in registry.WIRE_MODULES \
                    and isinstance(node, (ast.For, ast.AsyncFor)) \
                    and _is_set_expr(node.iter):
                yield self.finding(
                    f, node,
                    "iterating a set while building wire output makes "
                    "byte order differ per process (PYTHONHASHSEED); "
                    "wrap it in sorted(...)")
