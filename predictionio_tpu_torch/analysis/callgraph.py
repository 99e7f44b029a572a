"""Cross-module function/call index for whole-program passes.

The graph is deliberately name-resolved, not type-resolved: an edge
``f -> g`` exists when ``f``'s body calls *any* function named ``g``
(plain call or method call). That over-approximates reachability, which
is the safe direction for the rules built on it — "is this writer
reached from a committer" (PIO002) and "is this jit routed through a
fn_cache builder" (PIO001) only ever gain extra safe paths from the
approximation, never lose real ones. Precision comes from the rules'
lexical sides; escape hatches (suppressions, baseline) cover the rest.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple, Union

from predictionio_tpu_torch.analysis.model import Project, SourceFile

FunctionNode = Union[ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda]


def call_name(node: ast.Call) -> Optional[str]:
    """The called function's simple name: ``f(...)`` -> f,
    ``a.b.f(...)`` -> f; None for computed callees (``fns[k](...)``)."""
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


def attr_path(node: ast.expr) -> Optional[str]:
    """Dotted path of a Name/Attribute chain (``os.path.join`` ->
    "os.path.join"); None once anything non-trivial appears."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def module_str_constants(tree: ast.AST) -> Dict[str, Set[str]]:
    """NAME -> possible string literal values for assignments anywhere
    in the module (module constants and function-local bindings alike;
    scope-naive, which is fine for drift gates). Shared by the knob
    collector and the metric collector — one resolver, one behavior."""
    out: Dict[str, Set[str]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            vals = {n.value for n in ast.walk(node.value)
                    if isinstance(n, ast.Constant)
                    and isinstance(n.value, str)}
            if not vals:
                continue
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.setdefault(t.id, set()).update(vals)
    return out


@dataclass(eq=False)        # identity semantics: infos live in sets
class FunctionInfo:
    """One function/method (lambdas are indexed too, under ``<lambda>``)."""

    file: SourceFile
    node: FunctionNode
    name: str
    qualname: str               #: "path.py::Class.method" / "path.py::fn"
    class_name: Optional[str] = None
    class_bases: Tuple[str, ...] = ()
    parent: Optional["FunctionInfo"] = None
    called_names: Set[str] = field(default_factory=set)

    @property
    def line(self) -> int:
        return self.node.lineno

    def chain(self) -> List["FunctionInfo"]:
        """This function plus every lexically enclosing one."""
        out, cur = [], self
        while cur is not None:
            out.append(cur)
            cur = cur.parent
        return out


@dataclass
class ClassInfo:
    file: SourceFile
    name: str
    bases: Tuple[str, ...]
    methods: List[FunctionInfo] = field(default_factory=list)


class FunctionIndex:
    """All functions in a project + the name-resolved call graph."""

    def __init__(self, project: Project):
        self.project = project
        self.infos: List[FunctionInfo] = []
        self.by_name: Dict[str, List[FunctionInfo]] = {}
        self.by_node: Dict[int, FunctionInfo] = {}
        self.classes: Dict[str, List[ClassInfo]] = {}
        #: innermost enclosing function for every AST node, per file
        self._owner: Dict[str, Dict[int, Optional[FunctionInfo]]] = {}
        for f in project.files:
            self._index_file(f)

    # -- construction --------------------------------------------------------

    def _index_file(self, f: SourceFile) -> None:
        owner: Dict[int, Optional[FunctionInfo]] = {}
        self._owner[f.path] = owner

        def walk(node: ast.AST, fn: Optional[FunctionInfo],
                 cls: Optional[ClassInfo]) -> None:
            owner[id(node)] = fn
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                name = getattr(node, "name", "<lambda>")
                qual = (f"{f.path}::{cls.name}.{name}" if cls
                        else f"{f.path}::{name}")
                info = FunctionInfo(
                    file=f, node=node, name=name, qualname=qual,
                    class_name=cls.name if cls else None,
                    class_bases=cls.bases if cls else (),
                    parent=fn)
                self.infos.append(info)
                self.by_name.setdefault(name, []).append(info)
                self.by_node[id(node)] = info
                if cls is not None and fn is None:
                    cls.methods.append(info)
                # decorators/defaults evaluate in the ENCLOSING scope
                for dec in getattr(node, "decorator_list", []):
                    walk(dec, fn, None)
                body = node.body if isinstance(node.body, list) \
                    else [node.body]
                for child in body:
                    walk(child, info, None)
                args = node.args
                for d in list(args.defaults) + \
                        [d for d in args.kw_defaults if d is not None]:
                    walk(d, fn, None)
                return
            if isinstance(node, ast.ClassDef):
                bases = tuple(b for b in
                              (attr_path(base) or "" for base in node.bases)
                              if b)
                cinfo = ClassInfo(file=f, name=node.name, bases=bases)
                self.classes.setdefault(node.name, []).append(cinfo)
                for dec in node.decorator_list:
                    walk(dec, fn, None)
                for child in node.body:
                    walk(child, fn, cinfo)
                return
            if isinstance(node, ast.Call):
                name = call_name(node)
                if name and fn is not None:
                    fn.called_names.add(name)
            for child in ast.iter_child_nodes(node):
                walk(child, fn, cls)

        walk(f.tree, None, None)

    # -- lookups -------------------------------------------------------------

    def enclosing(self, f: SourceFile, node: ast.AST
                  ) -> Optional[FunctionInfo]:
        """Innermost function lexically containing ``node`` (None at
        module level)."""
        return self._owner.get(f.path, {}).get(id(node))

    def methods_of(self, f: SourceFile, class_name: str,
                   with_bases: bool = True) -> List[FunctionInfo]:
        """Methods of a class, following base-class names resolvable in
        the project (one hop per name, cycle-safe)."""
        out: List[FunctionInfo] = []
        seen: Set[str] = set()
        todo = [class_name]
        while todo:
            cname = todo.pop()
            if cname in seen:
                continue
            seen.add(cname)
            for cinfo in self.classes.get(cname, []):
                out.extend(cinfo.methods)
                if with_bases:
                    todo.extend(b.split(".")[-1] for b in cinfo.bases)
        return out

    def reachable_from(self, seeds: Iterable[Union[str, FunctionInfo]]
                       ) -> Set[FunctionInfo]:
        """Every function reachable (by called-name edges) from the
        seeds. String seeds are function names; FunctionInfo seeds are
        included themselves."""
        todo: List[FunctionInfo] = []
        for s in seeds:
            if isinstance(s, FunctionInfo):
                todo.append(s)
            else:
                todo.extend(self.by_name.get(s, []))
        seen: Set[int] = set()
        out: Set[FunctionInfo] = set()
        while todo:
            fn = todo.pop()
            if id(fn) in seen:
                continue
            seen.add(id(fn))
            out.add(fn)
            for name in fn.called_names:
                todo.extend(self.by_name.get(name, []))
        return out
