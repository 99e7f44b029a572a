"""PIO006 — every ``PIO_*`` knob is registered, and read by its owner.

Config precedence (env > engine.json > server.json) lives in
``utils/server_config.py``; a module that reads ``os.environ`` directly
opts its knob out of that chain — the same name set in server.json
silently stops working, and the knob disappears from every config dump.
Plumbing knobs that legitimately bypass config files (process wiring,
chaos injection, kill switches) are registered in
``analysis/registry.KNOB_OWNERS`` with the module(s) allowed to read
them; everything else must go through ``ServerConfig``.

The collected read sites double as the knob-docs drift gate (see
``tests/test_staticcheck.py``): every knob read anywhere must appear in
README.md/OBSERVABILITY.md, and every documented knob must still be
read — the env-var inventory can no longer rot in either direction.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from predictionio_tpu_torch.analysis import registry
from predictionio_tpu_torch.analysis.callgraph import attr_path, \
    module_str_constants
from predictionio_tpu_torch.analysis.engine import Checker, Finding
from predictionio_tpu_torch.analysis.model import Project, SourceFile

#: receivers whose .get()/[] is an environment read
ENV_RECEIVERS = frozenset({"os.environ", "environ", "env"})
ENV_METHODS = frozenset({"get", "setdefault"})


def _knob_values(arg: ast.expr, consts: Dict[str, Set[str]]
                 ) -> List[str]:
    vals: Set[str] = set()
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        vals.add(arg.value)
    elif isinstance(arg, ast.Name):
        vals.update(consts.get(arg.id, ()))
    return [v for v in vals if registry.KNOB_RE.match(v)]


def env_knob_reads(project: Project) -> List[Tuple[str, int, str]]:
    """Every (path, line, knob) where a PIO_* env var is read."""
    reads: List[Tuple[str, int, str]] = []
    for f in project.files:
        consts = module_str_constants(f.tree)

        def record(arg: Optional[ast.expr], node: ast.AST) -> None:
            if arg is None:
                return
            for knob in _knob_values(arg, consts):
                reads.append((f.path, node.lineno, knob))

        for node in ast.walk(f.tree):
            if isinstance(node, ast.Call):
                path = attr_path(node.func)
                if path == "os.getenv" and node.args:
                    record(node.args[0], node)
                elif isinstance(node.func, ast.Attribute) \
                        and node.func.attr in ENV_METHODS \
                        and attr_path(node.func.value) in ENV_RECEIVERS \
                        and node.args:
                    record(node.args[0], node)
            elif isinstance(node, ast.Subscript) \
                    and isinstance(node.ctx, ast.Load) \
                    and attr_path(node.value) in ENV_RECEIVERS:
                record(node.slice, node)
            elif isinstance(node, ast.Compare) \
                    and len(node.ops) == 1 \
                    and isinstance(node.ops[0], (ast.In, ast.NotIn)) \
                    and attr_path(node.comparators[0]) in ENV_RECEIVERS:
                record(node.left, node)
    return reads


class UnregisteredKnobRead(Checker):
    rule = "PIO006"
    title = "PIO_* env read outside server_config / the knob registry"

    def run(self, project: Project) -> Iterable[Finding]:
        table = registry.knob_table(project)
        for path, line, knob in env_knob_reads(project):
            f = project.file(path)
            if f is None:
                continue
            owners = registry.owner_for(table, knob)
            if owners is None:
                yield Finding(
                    rule=self.rule, path=path, line=line,
                    message=(
                        f"{knob} is read here but registered nowhere — "
                        "route it through utils/server_config or add it "
                        "to analysis/registry.KNOB_OWNERS with an owner"),
                    snippet=f.line_text(line))
            elif not any(path == o or path.startswith(o) for o in owners):
                owner_names = ", ".join(owners) or "utils/server_config.py"
                yield Finding(
                    rule=self.rule, path=path, line=line,
                    message=(
                        f"{knob} belongs to {owner_names}; reading it "
                        "here forks the env > engine.json > server.json "
                        "precedence — consume the resolved value "
                        "instead"),
                    snippet=f.line_text(line))
