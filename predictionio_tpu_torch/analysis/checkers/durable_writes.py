"""PIO002 — every durable write rides temp-write + rename.

The storage layer's crash-safety story (group commit, snapshot
registry, batchpredict fragment merge) rests on one rule: a reader may
only ever observe a COMMITTED file, so writers write a temp name and
``os.replace``/``fs.mv`` it into place. A bare ``open(path, "w")`` to a
durable path can expose a torn half-write to a concurrent reader (or a
crash-restart) that then serves it as truth.

Lexically, a write is fine when its own function (or class — sinks
open in ``__init__`` and commit in ``commit()``) also performs the
rename. The whole-program side accepts writer helpers that are reached
from a committer: ``merge() -> _write_parts(tmp)`` then
``os.replace(tmp, final)`` in ``merge`` keeps ``_write_parts`` safe.
``os.fdopen`` is exempt by design: the fd's creation (``O_EXCL`` claim
files, ``mkstemp``) already chose its own discipline.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional, Set

from predictionio_tpu_torch.analysis import registry
from predictionio_tpu_torch.analysis.callgraph import attr_path
from predictionio_tpu_torch.analysis.engine import Checker, Finding
from predictionio_tpu_torch.analysis.model import Project, SourceFile

WRITE_MODES = frozenset("wxa")


def _write_mode(node: ast.Call) -> Optional[str]:
    """The mode string when this call opens a file for writing."""
    mode: Optional[ast.expr] = None
    fn_path = attr_path(node.func)
    if isinstance(node.func, ast.Name) and node.func.id == "open":
        if len(node.args) >= 2:
            mode = node.args[1]
    elif isinstance(node.func, ast.Attribute) and node.func.attr == "open" \
            and fn_path is not None and ".fs." in f".{fn_path}.":
        # fs.open / self.fs.open / self.client.fs.open
        if len(node.args) >= 2:
            mode = node.args[1]
    else:
        return None
    for kw in node.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
        if set(mode.value) & WRITE_MODES:
            return mode.value
    return None


def _is_commit_call(node: ast.Call) -> bool:
    path = attr_path(node.func)
    if path in registry.COMMIT_DOTTED:
        return True
    return (isinstance(node.func, ast.Attribute)
            and node.func.attr in registry.COMMIT_ATTRS)


def _subtree_commits(fn_node) -> bool:
    return any(isinstance(n, ast.Call) and _is_commit_call(n)
               for n in ast.walk(fn_node))


class UncommittedDurableWrite(Checker):
    rule = "PIO002"
    title = "durable write without the temp-write+rename commit"

    def run(self, project: Project) -> Iterable[Finding]:
        idx = project.functions
        committers = {info for info in idx.infos
                      if _subtree_commits(info.node)}
        #: module-level commit calls, per file
        module_commits: Set[str] = set()
        for f in project.files:
            for node in ast.walk(f.tree):
                if isinstance(node, ast.Call) and _is_commit_call(node) \
                        and idx.enclosing(f, node) is None:
                    module_commits.add(f.path)
        reached = idx.reachable_from(committers)

        def committer_class(f: SourceFile, info) -> bool:
            if info.class_name is None:
                return False
            return any(m in committers
                       for m in idx.methods_of(f, info.class_name))

        for f in project.files:
            for node in ast.walk(f.tree):
                if not isinstance(node, ast.Call):
                    continue
                mode = _write_mode(node)
                if mode is None:
                    continue
                info = idx.enclosing(f, node)
                if info is None:
                    if f.path in module_commits:
                        continue
                elif any(fn in committers or fn in reached
                         for fn in info.chain()) \
                        or committer_class(f, info):
                    continue
                where = f"`{info.name}`" if info else "module level"
                yield self.finding(
                    f, node,
                    f"open(..., {mode!r}) in {where} writes a durable "
                    "path with no temp-write+rename commit in reach; "
                    "write a tmp name and os.replace()/fs.mv() it (or "
                    "have a committing caller own the final name)")
