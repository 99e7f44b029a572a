"""PIO005 — kill points must stay lethal.

The chaos suite's crash-safety proofs work by raising
:class:`~predictionio_tpu_torch.storage.faults.CrashError` — deliberately a
``BaseException`` — at armed points and asserting the process dies
there, so recovery paths get exercised for real. A bare ``except:`` or
``except BaseException:`` that neither re-raises nor relays the
exception object turns the kill point into a no-op and quietly voids
every crash test downstream of it.

Allowed shapes: the handler ``raise``s (anywhere in its body), or it
binds the exception and *uses* it — ``f.set_exception(e)``,
``errs.append(e)`` — which relays the kill to a waiter that will
re-raise it.
"""

from __future__ import annotations

import ast
from typing import Iterable

from predictionio_tpu_torch.analysis.callgraph import attr_path
from predictionio_tpu_torch.analysis.engine import FileChecker, Finding
from predictionio_tpu_torch.analysis.model import Project, SourceFile


def _catches_base(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:
        return True                      # bare except:
    path = attr_path(handler.type)
    return path is not None and path.split(".")[-1] == "BaseException"


def _handler_ok(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if handler.name and isinstance(node, ast.Name) \
                and node.id == handler.name \
                and isinstance(node.ctx, ast.Load):
            return True                  # exception object is relayed
    return False


class SwallowedKillPoint(FileChecker):
    rule = "PIO005"
    title = "bare/BaseException handler that swallows kill points"

    def check_file(self, f: SourceFile, project: Project
                   ) -> Iterable[Finding]:
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if _catches_base(node) and not _handler_ok(node):
                what = "bare `except:`" if node.type is None \
                    else "`except BaseException:`"
                yield self.finding(
                    f, node,
                    f"{what} neither re-raises nor relays — it swallows "
                    "CrashError kill points (and KeyboardInterrupt); "
                    "catch Exception, or re-raise/relay the object")
