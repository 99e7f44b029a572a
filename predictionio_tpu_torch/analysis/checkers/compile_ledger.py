"""PIO001 / PIO007 — the compile ledger and what may live inside it.

PIO001: a ``jax.jit``/``jax.pmap`` built inside a function body creates
a FRESH traced callable per call — jit's own cache keys on function
identity, so every call re-traces and the compile ledger
(``pio_jax_compile_total``) grows without bound on a long-lived server.
The sanctioned shapes are: module-level jits (bounded: one per import)
and builders routed through ``ops/fn_cache``'s ``mesh_cached_fn``/
``shape_cached_fn`` (bounded LRU per family). The whole-program side
walks the call graph from every registered builder, so a builder that
delegates (``build() -> make_train_fn() -> jax.jit(train)``) is still
recognized as routed.

PIO007: values computed at trace time FREEZE into the compiled program.
``time.time()``, ``random.random()``, an argless ``datetime.now()``
inside a traced function silently bake one trace's answer into every
later dispatch — and differ between processes, breaking the replicated
fleet's answer parity.

The port compiles nothing at trace time (no ``torch.compile``; the one
CUDA graph it captures is in a measuring tool), so both rules find
nothing on its tree. They keep the reference's matching so that the same
fixture gives the same findings through either package's engine.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set

from predictionio_tpu_torch.analysis import registry
from predictionio_tpu_torch.analysis.callgraph import attr_path
from predictionio_tpu_torch.analysis.engine import Checker, Finding
from predictionio_tpu_torch.analysis.model import Project

JIT_PATHS = frozenset({"jax.jit", "jax.pmap", "pjit"})


def _is_jit_ref(node: ast.expr) -> bool:
    """``jax.jit`` / ``jax.pmap`` as a bare reference (decorator use)."""
    return attr_path(node) in JIT_PATHS


def _jit_call_kind(node: ast.Call) -> Optional[str]:
    """"jit" when the call itself builds a traced fn: ``jax.jit(f)``,
    ``functools.partial(jax.jit, ...)``."""
    path = attr_path(node.func)
    if path in JIT_PATHS:
        return path
    if path in ("functools.partial", "partial") and node.args \
            and _is_jit_ref(node.args[0]):
        return attr_path(node.args[0])
    return None


def _builder_arg(node: ast.Call) -> Optional[ast.expr]:
    """The ``build`` argument of a ``mesh_cached_fn``/``shape_cached_fn``
    call, positional or keyword."""
    name = node.func.attr if isinstance(node.func, ast.Attribute) else (
        node.func.id if isinstance(node.func, ast.Name) else None)
    pos = registry.FN_CACHE_BUILDERS.get(name or "")
    if pos is None:
        return None
    for kw in node.keywords:
        if kw.arg == "build":
            return kw.value
    if len(node.args) > pos:
        return node.args[pos]
    return None


def _routed_functions(project: Project) -> Set:
    """Every function reachable from a builder registered with the
    compile-ledger cache — jits inside these are ledger-bounded."""
    idx = project.functions
    seeds: List = []
    for f in project.files:
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            arg = _builder_arg(node)
            if arg is None:
                continue
            if isinstance(arg, ast.Name):
                seeds.append(arg.id)
            elif isinstance(arg, ast.Lambda):
                info = idx.by_node.get(id(arg))
                if info is not None:
                    seeds.append(info)
                    seeds.extend(info.called_names)
            elif isinstance(arg, ast.Attribute):
                seeds.append(arg.attr)
    return idx.reachable_from(seeds)


class BareJit(Checker):
    rule = "PIO001"
    title = "bare jax.jit/jax.pmap outside the ops/fn_cache ledger"

    def run(self, project: Project) -> Iterable[Finding]:
        idx = project.functions
        routed = _routed_functions(project)

        def is_routed(f, node) -> bool:
            info = idx.enclosing(f, node)
            if info is None:
                return True                      # module level: bounded
            return any(fn in routed for fn in info.chain())

        for f in project.files:
            if f.path == registry.FN_CACHE_PATH:
                continue
            for node in ast.walk(f.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    for dec in node.decorator_list:
                        target = dec if not isinstance(dec, ast.Call) \
                            else None
                        if target is not None and _is_jit_ref(target) \
                                and not is_routed(f, node):
                            yield self.finding(
                                f, dec,
                                f"@{attr_path(target)} on a nested "
                                "function re-traces per enclosing call; "
                                "route it through ops/fn_cache "
                                "(mesh_cached_fn/shape_cached_fn)")
                if isinstance(node, ast.Call):
                    kind = _jit_call_kind(node)
                    if kind is not None and not is_routed(f, node):
                        yield self.finding(
                            f, node,
                            f"{kind}(...) built per call leaks compile-"
                            "ledger entries; route it through "
                            "ops/fn_cache (mesh_cached_fn/shape_cached_fn)")


def _traced_functions(project: Project) -> Set:
    """Functions that run under jax tracing: jit-decorated, or passed
    (by name or as a lambda) to a jit call."""
    idx = project.functions
    traced: Set = set()
    for f in project.files:
        for node in ast.walk(f.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    if _is_jit_ref(dec) or (
                            isinstance(dec, ast.Call)
                            and _jit_call_kind(dec)):
                        info = idx.by_node.get(id(node))
                        if info is not None:
                            traced.add(info)
            if isinstance(node, ast.Call) and _jit_call_kind(node):
                for arg in node.args:
                    if isinstance(arg, ast.Name):
                        traced.update(
                            i for i in idx.by_name.get(arg.id, [])
                            if i.file is f)
                    elif isinstance(arg, ast.Lambda):
                        info = idx.by_node.get(id(arg))
                        if info is not None:
                            traced.add(info)
    return traced


class TracedNondeterminism(Checker):
    rule = "PIO007"
    title = "wall-clock/random nondeterminism inside a traced function"

    def run(self, project: Project) -> Iterable[Finding]:
        for info in _traced_functions(project):
            body = info.node.body
            for stmt in (body if isinstance(body, list) else [body]):
                for node in ast.walk(stmt):
                    if not isinstance(node, ast.Call):
                        continue
                    path = attr_path(node.func)
                    if path is None:
                        continue
                    nondet = path in registry.NONDET_DOTTED or any(
                        path.startswith(p)
                        for p in registry.NONDET_MODULE_PREFIXES)
                    if nondet:
                        yield self.finding(
                            info.file, node,
                            f"{path}() inside traced fn "
                            f"`{info.name}` freezes one trace-time value "
                            "into the compiled program (and diverges "
                            "across fleet replicas); pass it in as an "
                            "argument instead")
