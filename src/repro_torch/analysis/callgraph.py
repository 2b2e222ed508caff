"""A plain-`ast` view of the port's package, for `lint`: its modules,
functions and imports, the functions the serving hot path reaches, and a
local, flow-insensitive guess of which expressions of a function are
tensors.

The reference's `repro.analysis.callgraph` propagates jit tracers through
the package; eager PyTorch has no tracers, so this module keeps only what
the port's rules need:

* **The hot path** (`hot_functions`): every function of the modules that
  drive a serving step (`HOT_MODULES`, `HOT_PREFIXES`), and every function
  of `REACHED_PREFIXES` (models, the LoRA delta, sampling) that they reach.
  Reachability is conservative: a reference to a package function or
  class (a class brings its methods), a method call `x.m(...)` reaches
  every method `m` of those modules, and a call of a value that is no
  known function (a layer held in a list) reaches every `forward` and
  `__call__` there. `reachable` follows the same edges from other roots
  (the captured steps, for `lint`'s tracer-if), into the training
  modules too where asked.
* **Tensor expressions** (`TensorScope`): `torch.*` calls other than the
  host queries in `HOST_TORCH`, methods, indexing and arithmetic of a
  tensor, names bound to one, `self.x` attributes a method of the class
  sets to one, and calls of package functions that return one. Static
  extractors (`.shape`, `.dtype`, `len()`, ...) and what a host transfer
  returns (`.cpu()`, `.numpy()`, `.item()`, `.tolist()`) are host values.

Run on source only: nothing of the package is imported.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Set

PACKAGE = "repro_torch"
HOT_MODULES = ("repro_torch.core.backend", "repro_torch.core.engine",
               "repro_torch.core.graphs", "repro_torch.serving.cache")
HOT_PREFIXES = ("repro_torch.kernels.",)
REACHED_PREFIXES = ("repro_torch.models.", "repro_torch.core.lora",
                    "repro_torch.serving.sampling")
# torch functions whose result is a host value, not a tensor
HOST_TORCH = ("torch.cuda.", "torch.backends.", "torch.profiler.",
              "torch.utils.", "torch.is_", "torch.get_", "torch.set_",
              "torch.device", "torch.dtype", "torch.Generator",
              "torch.no_grad", "torch.enable_grad", "torch.promote_types",
              "torch.finfo", "torch.iinfo", "torch.Size",
              "torch.distributed.device_mesh.", "torch.distributed.get_",
              "torch.distributed.is_")
# attributes and methods of a tensor that are host values (no sync)
STATIC_ATTRS = {"shape", "dtype", "device", "is_cuda", "ndim", "nbytes",
                "requires_grad", "layout", "grad_fn", "itemsize",
                "device_mesh", "placements"}
STATIC_METHODS = {"size", "dim", "numel", "stride", "data_ptr",
                  "element_size", "is_contiguous", "storage_offset",
                  "get_device", "nelement", "ndimension", "is_floating_point",
                  "cuda_stream"}
# methods whose result lives on the host (the transfer itself is a sync
# primitive of `lint`)
HOST_RESULT_METHODS = {"cpu", "numpy", "item", "tolist"}


@dataclass(eq=False)
class FuncInfo:
    qname: str                       # package.module[.Class].name
    node: ast.AST                    # FunctionDef / AsyncFunctionDef
    module: "ModuleInfo"
    cls_name: Optional[str] = None
    parent: Optional["FuncInfo"] = None

    @property
    def name(self) -> str:
        return self.node.name

    @property
    def positional_params(self) -> List[str]:
        a = self.node.args
        names = [p.arg for p in a.posonlyargs + a.args]
        return names[1:] if self.cls_name is not None and names \
            and names[0] in ("self", "cls") else names


@dataclass(eq=False)
class ModuleInfo:
    fq: str
    path: str
    tree: ast.Module
    lines: List[str]
    funcs: Dict[str, FuncInfo] = field(default_factory=dict)
    classes: Dict[str, ast.ClassDef] = field(default_factory=dict)
    # local name -> fully qualified name (a module, or a name in one)
    imports: Dict[str, str] = field(default_factory=dict)


class Project:
    """Every module of one package, parsed."""

    def __init__(self, modules: Dict[str, ModuleInfo]):
        self.modules = modules
        self.funcs: Dict[str, FuncInfo] = {
            q: f for m in modules.values() for q, f in m.funcs.items()}

    @classmethod
    def load(cls, src_root: str) -> "Project":
        mods: Dict[str, ModuleInfo] = {}
        base = os.path.join(src_root, PACKAGE)
        for dirpath, _, files in sorted(os.walk(base)):
            for fn in sorted(files):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, src_root)[:-3].split(os.sep)
                if rel[-1] == "__init__":
                    rel = rel[:-1]
                fq = ".".join(rel)
                with open(path) as f:
                    text = f.read()
                mod = ModuleInfo(fq, path, ast.parse(text, filename=path),
                                 text.splitlines())
                _index(mod)
                mods[fq] = mod
        return cls(mods)

    def resolve(self, mod: ModuleInfo, expr: ast.AST) -> Optional[str]:
        """The fully qualified name a Name / Attribute chain refers to, with
        the module's import aliases expanded (None: not a static name)."""
        if isinstance(expr, ast.Name):
            if expr.id in mod.imports:
                return mod.imports[expr.id]
            if f"{mod.fq}.{expr.id}" in self.funcs \
                    or expr.id in mod.classes:
                return f"{mod.fq}.{expr.id}"
            return None
        if isinstance(expr, ast.Attribute):
            base = self.resolve(mod, expr.value)
            return f"{base}.{expr.attr}" if base else None
        return None


def _index(mod: ModuleInfo) -> None:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    mod.imports[a.asname] = a.name
                else:
                    top = a.name.split(".")[0]
                    mod.imports[top] = top
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            for a in node.names:
                mod.imports[a.asname or a.name] = f"{node.module}.{a.name}"

    def visit(body, prefix, cls_name, parent):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}.{node.name}"
                fi = FuncInfo(q, node, mod, cls_name, parent)
                mod.funcs[q] = fi
                visit(node.body, q, None, fi)
            elif isinstance(node, ast.ClassDef):
                if parent is None and cls_name is None:
                    mod.classes[node.name] = node
                visit(node.body, f"{prefix}.{node.name}", node.name, parent)

    visit(mod.tree.body, mod.fq, None, None)


def own_nodes(root: ast.AST) -> Iterator[ast.AST]:
    """Walk `root` without descending into nested function/class defs."""
    stack = list(ast.iter_child_nodes(root))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def is_hot_module(fq: str) -> bool:
    return fq in HOT_MODULES or fq.startswith(HOT_PREFIXES)


def _reached_module(fq: str) -> bool:
    return fq.startswith(REACHED_PREFIXES)


def hot_functions(project: Project) -> Set[FuncInfo]:
    """The functions of the serving hot path (see the module docstring)."""
    return reachable(project, [f for f in project.funcs.values()
                               if is_hot_module(f.module.fq)])


def reachable(project: Project, roots, also=()) -> Set[FuncInfo]:
    """`roots` and every function of the hot and reached modules, and of
    the modules under the prefixes `also`, that they reach (as
    `hot_functions` follows calls)."""
    also = tuple(also)

    def followed(fq: str) -> bool:
        return _reached_module(fq) or (bool(also) and fq.startswith(also))

    scope = [f for f in project.funcs.values() if followed(f.module.fq)]
    by_method: Dict[str, List[FuncInfo]] = {}
    for f in scope:
        if f.cls_name is not None:
            by_method.setdefault(f.name, []).append(f)
    callables = by_method.get("forward", []) + by_method.get("__call__", [])

    def targets(f: FuncInfo) -> Iterator[FuncInfo]:
        mod = f.module
        for node in own_nodes(f.node):
            if isinstance(node, (ast.Name, ast.Attribute)) and \
                    isinstance(getattr(node, "ctx", None), ast.Load):
                fq = project.resolve(mod, node)
                if fq in project.funcs:
                    yield project.funcs[fq]
                elif fq is not None:
                    pre = fq + "."
                    yield from (g for q, g in project.funcs.items()
                                if q.startswith(pre)
                                and g.cls_name is not None)
            if isinstance(node, ast.Call):
                fn = node.func
                if isinstance(fn, ast.Attribute) and \
                        project.resolve(mod, fn) is None:
                    if isinstance(fn.value, ast.Name) and \
                            fn.value.id == "self" and f.cls_name:
                        own = f"{mod.fq}.{f.cls_name}.{fn.attr}"
                        if own in project.funcs:
                            yield project.funcs[own]
                            continue
                    yield from by_method.get(fn.attr, [])
                elif isinstance(fn, ast.Name) and \
                        project.resolve(mod, fn) is None:
                    yield from callables
        # nested functions run when their parent does
        for g in mod.funcs.values():
            if g.parent is f:
                yield g

    seen: Set[FuncInfo] = set(roots)
    todo = list(seen)
    while todo:
        f = todo.pop()
        for g in targets(f):
            if g not in seen and (is_hot_module(g.module.fq)
                                  or followed(g.module.fq)):
                seen.add(g)
                todo.append(g)
    return seen


# ------------------------------------------------------------ tensors ----

class TensorScope:
    """Which expressions of one function are tensors, as far as a local
    look can tell (see the module docstring)."""

    def __init__(self, project: Project, f: FuncInfo,
                 returns: Dict[str, object], self_attrs: Set[str],
                 params: Set[str] = frozenset(),
                 any_attrs: Set[str] = frozenset()):
        self.project, self.f, self.mod = project, f, f.module
        self.returns = returns            # qname -> True / tuple of bools
        self.self_attrs = self_attrs      # tensor attributes of f's class
        # tensor attributes of any class: `pipe.pos` read outside the class
        self.any_attrs = any_attrs
        self.names: Set[str] = set(params)
        for p in f.node.args.args + f.node.args.kwonlyargs:
            ann = p.annotation
            if ann is not None and self._fq(ann) == "torch.Tensor":
                self.names.add(p.arg)
        changed = True
        while changed:
            changed = False
            for node in own_nodes(f.node):
                for tgt, val in _bindings(node):
                    for name in self._bound(tgt, val):
                        if name not in self.names:
                            self.names.add(name)
                            changed = True

    def _fq(self, expr) -> Optional[str]:
        return self.project.resolve(self.mod, expr)

    def _bound(self, tgt, val) -> Iterator[str]:
        if isinstance(tgt, ast.Name):
            if val is not None and self.expr(val):
                yield tgt.id
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            parts = self._parts(val, len(tgt.elts))
            for t, p in zip(tgt.elts, parts):
                if isinstance(t, ast.Name) and p:
                    yield t.id

    def _parts(self, val, n) -> List[bool]:
        if isinstance(val, (ast.Tuple, ast.List)) and len(val.elts) == n:
            return [self.expr(v) for v in val.elts]
        if isinstance(val, ast.Call):
            r = self.returns.get(self._fq(val.func) or "")
            if isinstance(r, tuple) and len(r) == n:
                return list(r)
        return [False] * n

    def expr(self, e: Optional[ast.AST]) -> bool:
        """True when `e` evaluates to a tensor."""
        if e is None:
            return False
        if isinstance(e, ast.Name):
            return e.id in self.names
        if isinstance(e, ast.Attribute):
            if e.attr in STATIC_ATTRS:
                return False
            if isinstance(e.value, ast.Name) and e.value.id == "self":
                return e.attr in self.self_attrs
            return e.attr in self.any_attrs or self.expr(e.value)
        if isinstance(e, ast.Subscript):
            return self.expr(e.value)
        if isinstance(e, ast.BinOp):
            return self.expr(e.left) or self.expr(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.expr(e.operand)
        if isinstance(e, ast.BoolOp):
            return any(self.expr(v) for v in e.values)
        if isinstance(e, ast.Compare):
            if all(isinstance(o, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for o in e.ops) or any(
                       isinstance(c, ast.Constant) and isinstance(c.value, str)
                       for c in [e.left, *e.comparators]):
                return False
            return self.expr(e.left) or any(self.expr(c)
                                             for c in e.comparators)
        if isinstance(e, ast.IfExp):
            return self.expr(e.body) or self.expr(e.orelse)
        if isinstance(e, ast.Call):
            return self._call(e)
        return False

    def _call(self, e: ast.Call) -> bool:
        fq = self._fq(e.func)
        if fq is not None:
            if fq.startswith("torch."):
                return not fq.startswith(HOST_TORCH)
            r = self.returns.get(fq)
            return r is True or (isinstance(r, tuple) and any(r))
        if isinstance(e.func, ast.Attribute):
            m = e.func.attr
            if m in STATIC_METHODS or m in HOST_RESULT_METHODS:
                return False
            if self.expr(e.func.value):
                return True
        # a layer or closure called on a tensor gives a tensor
        return any(self.expr(a) for a in e.args)


def _bindings(node) -> Iterator[tuple]:
    if isinstance(node, ast.Assign):
        for t in node.targets:
            yield t, node.value
    elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
        yield node.target, node.value
    elif isinstance(node, ast.NamedExpr):
        yield node.target, node.value


def tensor_scopes(project: Project,
                  funcs: Set[FuncInfo]) -> Dict[FuncInfo, TensorScope]:
    """A `TensorScope` for each of `funcs`, with what every package
    function returns (a tensor, or a tuple of which parts are), which
    `self` attributes each class sets to a tensor, and which parameters
    some call in the package passes a tensor, worked out to a fixed point
    over the whole package."""
    returns: Dict[str, object] = {}
    attrs: Dict[tuple, Set[str]] = {}
    params: Dict[str, Set[str]] = {}
    changed = True
    while changed:
        changed = False
        for f in project.funcs.values():
            key = (f.module.fq, f.cls_name)
            sc = TensorScope(project, f, returns, attrs.get(key, set()),
                             params.get(f.qname, set()),
                             set().union(*attrs.values()))
            for node in own_nodes(f.node):
                if isinstance(node, ast.Call):
                    callee = project.funcs.get(
                        project.resolve(f.module, node.func) or "")
                    if callee is not None and _pass_params(
                            sc, node, callee,
                            params.setdefault(callee.qname, set())):
                        changed = True
                if isinstance(node, ast.Return) and node.value is not None:
                    v = node.value
                    r = tuple(sc.expr(x) for x in v.elts) \
                        if isinstance(v, ast.Tuple) else sc.expr(v)
                    old = returns.get(f.qname)
                    new = _join(old, r)
                    if new != old:
                        returns[f.qname] = new
                        changed = True
                for tgt, val in _bindings(node):
                    if isinstance(tgt, ast.Attribute) and \
                            isinstance(tgt.value, ast.Name) and \
                            tgt.value.id == "self" and f.cls_name and \
                            val is not None and sc.expr(val):
                        s = attrs.setdefault(key, set())
                        if tgt.attr not in s:
                            s.add(tgt.attr)
                            changed = True
    every = set().union(*attrs.values())
    return {f: TensorScope(project, f, returns,
                           attrs.get((f.module.fq, f.cls_name), set()),
                           params.get(f.qname, set()), every)
            for f in funcs}


def _pass_params(sc: TensorScope, call: ast.Call, callee: FuncInfo,
                 into: Set[str]) -> bool:
    """Add to `into` the parameters of `callee` that `call` passes a
    tensor; True if that added any."""
    pos = callee.positional_params
    names = [p for p, a in zip(pos, call.args)
             if not isinstance(a, ast.Starred) and sc.expr(a)]
    names += [k.arg for k in call.keywords if k.arg and sc.expr(k.value)]
    new = set(names) - into
    into |= new
    return bool(new)


def _join(old, new):
    """The least upper bound of two return facts, ordered False < a tuple
    of facts per part < True (so the fixed point terminates)."""
    if old is None or old == new:
        return new
    if old is True or new is True:
        return True
    if isinstance(old, tuple) and isinstance(new, tuple):
        if len(old) != len(new):
            return True
        return tuple(a or b for a, b in zip(old, new))
    return old if isinstance(old, tuple) else new
