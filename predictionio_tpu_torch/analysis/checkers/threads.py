"""PIO003 — every thread hop carries the trace plane.

The one-trace-id-per-request property holds only while every
``threading.Thread`` / executor ``submit`` either captures the
submitter's context (``tracing.capture_context()``) or re-enters it on
the worker (``tracing.carried()`` / ``adopt()``). A hop that does
neither silently detaches everything downstream from the flight
recorder — the request "ends" at the queue and the device work becomes
unattributable.

The check is call-graph deep: the hop is fine when the *submitting*
function captures context, or when the hop's TARGET (transitively)
re-enters one — ``Thread(target=self._worker)`` passes because
``_worker -> _flush -> with carried(...)``.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from predictionio_tpu_torch.analysis import registry
from predictionio_tpu_torch.analysis.callgraph import attr_path
from predictionio_tpu_torch.analysis.engine import Checker, Finding
from predictionio_tpu_torch.analysis.model import Project


def _thread_target(node: ast.Call) -> Optional[ast.expr]:
    path = attr_path(node.func)
    if path is None or not path.split(".")[-1] == "Thread":
        return None
    for kw in node.keywords:
        if kw.arg == "target":
            return kw.value
    if len(node.args) >= 2:        # Thread(group, target, ...)
        return node.args[1]
    return None


def _submit_target(node: ast.Call) -> Optional[ast.expr]:
    fn = node.func
    if not (isinstance(fn, ast.Attribute) and fn.attr == "submit"):
        return None
    recv = attr_path(fn.value)
    if recv is None or not registry.EXECUTOR_NAME_RE.search(recv):
        return None
    return node.args[0] if node.args else None


class UncarriedThreadHop(Checker):
    rule = "PIO003"
    title = "thread hop that drops the trace plane"

    def run(self, project: Project) -> Iterable[Finding]:
        idx = project.functions
        carriers = {info for info in idx.infos
                    if info.called_names & registry.TRACE_CARRIERS}

        def target_infos(f, target: ast.expr) -> List:
            if isinstance(target, ast.Lambda):
                info = idx.by_node.get(id(target))
                return [info] if info else []
            name = None
            if isinstance(target, ast.Name):
                name = target.id
            elif isinstance(target, ast.Attribute):
                name = target.attr
            if name is None:
                return []
            infos = idx.by_name.get(name, [])
            same_file = [i for i in infos if i.file is f]
            return same_file or infos

        for f in project.files:
            for node in ast.walk(f.tree):
                if not isinstance(node, ast.Call):
                    continue
                target = _thread_target(node)
                if target is None:
                    target = _submit_target(node)
                    if target is None:
                        continue
                site = idx.enclosing(f, node)
                if site is not None and any(
                        fn in carriers for fn in site.chain()):
                    continue            # submitter captures the context
                targets = target_infos(f, target)
                if targets and idx.reachable_from(targets) & carriers:
                    continue            # worker re-enters the context
                yield self.finding(
                    f, node,
                    "thread hop neither captures nor re-enters the "
                    "trace context — the request's trace dies at this "
                    "queue; wrap the target in tracing.carried"
                    "(capture_context(), ...)")
