"""PIO009 — telemetry segment writers ride the committed-write helpers.

The durable-telemetry store (obs/tsdb.py) holds the fleet's only
restart-surviving observability state, and its crash-safety story is
NOT the PIO002 temp-write+rename rule: the append path is deliberately
append-in-place, made safe by length-prefixed checksummed records and
torn-tail truncation on recovery, while every multi-record rewrite
(segment roll, compaction) IS temp-write+rename. Both disciplines live
in named helpers — ``_append_payload``, ``_commit_file``,
``_ensure_active`` — registered in
``analysis.registry.SEGMENT_WRITE_HELPERS``.

This rule pins that: in the telemetry modules, ANY call opening a file
for writing outside a registered helper is a finding. A future "quick
fix" that writes a segment byte without the checksum framing (or
renames without going through the commit helper) would silently break
the kill-at-every-point recovery contract the chaos suite asserts —
the same machine-checked-invariant treatment the rest of the fleet
gets.
"""

from __future__ import annotations

import ast
from typing import Iterable

from predictionio_tpu_torch.analysis import registry
from predictionio_tpu_torch.analysis.checkers.durable_writes import _write_mode
from predictionio_tpu_torch.analysis.engine import Checker, Finding
from predictionio_tpu_torch.analysis.model import Project


class UncommittedSegmentWrite(Checker):
    rule = "PIO009"
    title = "telemetry segment write outside the committed-write helpers"

    def run(self, project: Project) -> Iterable[Finding]:
        idx = project.functions
        for f in project.files:
            helpers = registry.SEGMENT_WRITE_HELPERS.get(f.path)
            if helpers is None:
                continue
            for node in ast.walk(f.tree):
                if not isinstance(node, ast.Call):
                    continue
                mode = _write_mode(node)
                if mode is None:
                    continue
                info = idx.enclosing(f, node)
                if info is not None and any(fn.name in helpers
                                            for fn in info.chain()):
                    continue
                where = f"`{info.name}`" if info else "module level"
                yield self.finding(
                    f, node,
                    f"open(..., {mode!r}) in {where} writes a telemetry "
                    "segment outside the committed-write helpers "
                    f"({', '.join(helpers) or 'none registered'}); "
                    "route it through _append_payload/_commit_file (or "
                    "register it in analysis.registry."
                    "SEGMENT_WRITE_HELPERS with a justification)")
