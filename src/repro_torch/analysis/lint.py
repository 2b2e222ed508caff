"""Lint of the port's package, over the `callgraph` view.

    python -m repro_torch.analysis.lint src/ [--strict-waivers] [--json F]

Rules (waive a finding with ``# lint: allow-<rule> — <reason>`` on the
finding line or in the comment block right above it, as in the
reference's `repro.analysis.lint`):

* ``host-sync``     — a device->host synchronisation anywhere on the
  serving hot path (`callgraph.hot_functions`): the explicit primitives
  ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
  ``.synchronize()`` (events, streams, ``torch.cuda.synchronize``) and
  ``.nonzero()`` / ``torch.nonzero``; a copy of a host value to the
  device (`_host_to_device`: ``.to(<device>)`` / ``.cuda()`` of
  ``torch.from_numpy`` / ``torch.as_tensor`` / ``torch.tensor`` made on
  the host, or ``torch.as_tensor`` / ``torch.tensor`` given a
  ``device=``), which from pageable memory blocks the host until the copy
  is done; and ``int()``, ``float()``,
  ``bool()``, ``if`` / ``while`` / a conditional expression on a value the
  local analysis takes for a tensor (`callgraph.TensorScope`). A designed
  sync point carries a waiver that says why it is there.
* ``bare-assert``   — ``assert`` in library code (stripped under
  ``python -O``; invariants must raise).
* ``kernel-oracle`` — a function in ``kernels/`` that launches a kernel
  through ``lib.rt_<name>`` without a plain version ``<name>_ref`` in
  ``kernels/ref.py`` of the same positional parameters (the counterpart
  of the reference's ``pallas-oracle``).

* ``jit-spec``      — a CUDA-graph capture (``torch.cuda.graph``,
  ``torch.cuda.CUDAGraph``, ``torch.cuda.make_graphed_callables``)
  outside ``core/graphs.py``: every capture goes through the one place
  that declares its static inputs (the port's counterpart of a jit
  without an explicit static / donate spec).
* ``donated-reuse`` — rebinding, by assignment, a buffer that the
  captured decode step reads: the decode pipeline's buffers
  (``pipe.last_tok = ...``, ``pipe.active = ...``), the backend's KV
  plane (``self.cache``, or one of its leaves) or the LoRA pool
  (``DevicePool.pool``, or one of its leaves). The graph replays the old
  address; the write must go in place (the counterpart of reading a
  donated buffer). ``__init__`` allocates them and is exempt.
* ``tracer-if``     — ``if`` / ``while`` / a conditional expression /
  ``int()`` / ``bool()`` / ``float()`` / ``.item()`` on a tensor inside a
  function reachable from the captured step (`callgraph.reachable` from
  ``NumericsBackend._fused_step``): a graph would bake one value in. A
  ``host-sync`` waiver does not waive it.

The reference's kernel-* rules have their counterparts in
`kernel_model` and `kernel_verify`.

Waivers are audited: one that matched no finding in the run, or that
gives no reason, is reported by ``--strict-waivers`` (stale waivers hide
regressions). Exit status 1 on any finding (and, with
``--strict-waivers``, any such waiver).
"""
from __future__ import annotations

import argparse
import ast
import io
import json
import os
import re
import sys
import tokenize
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Set, Tuple

from repro_torch.analysis import callgraph as cg

SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize", "nonzero"}
SYNC_FQS = {"torch.nonzero", "torch.cuda.synchronize"}
# torch functions that make a tensor from a host value (on the host,
# unless given a device)
HOST_MAKERS = {"torch.from_numpy", "torch.as_tensor", "torch.tensor"}
WAIVER_RE = re.compile(r"#\s*lint:\s*allow-([a-z-]+)(.*)")
REF_MODULE = "repro_torch.kernels.ref"
LAUNCH_PREFIX = "rt_"
QUERY_SUFFIXES = ("_fits", "_info")        # lib queries that launch nothing
SRC = str(Path(__file__).resolve().parents[2])
# the captured steps (`core.graphs`) and the buffers they read
GRAPH_MODULE = "repro_torch.core.graphs"
GRAPH_FQS = {f"torch.cuda.{m}{n}" for m in ("", "graphs.")
             for n in ("graph", "CUDAGraph", "make_graphed_callables")}
STEP_ROOTS = tuple(f"repro_torch.{q}" for q in (
    "core.backend.NumericsBackend._fused_step",
    "core.backend.NumericsBackend._prefill_step",
    "core.backend.NumericsBackend._chunk_step",
    "launch.train.Trainer._captured_step",
    "training.train.make_train_step_",
    "training.train.make_lora_train_step_"))
# modules the training step's capture reaches beyond the hot path's
STEP_MODULES = ("repro_torch.training.", "repro_torch.launch.train")
PIPE_BUFFERS = {"last_tok", "pos", "target", "active", "idx",
                "block_table", "gen"}
# a trainer's leaves the captured training step writes in place
TRAINER_BUFFERS = {"adapter", "state", "metrics", "batch", "params"}


@dataclass
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"[{self.rule}] {self.message}")


def _has_reason(rest: str) -> bool:
    return bool(re.sub(r"^[\s\-—:,;.]*", "", rest))


def _is_cpu(v: ast.AST) -> bool:
    """`"cpu"` or `torch.device("cpu")`."""
    if isinstance(v, ast.Call) and v.args:
        v = v.args[0]
    return isinstance(v, ast.Constant) and v.value == "cpu"


def _to_cpu(call: ast.Call) -> bool:
    """`.to("cpu")`, `.to(device="cpu")` or `.to(torch.device("cpu"))`."""
    return any(_is_cpu(v) for v in list(call.args) + [
        k.value for k in call.keywords if k.arg == "device"])


def _device_kw(call: ast.Call) -> Optional[ast.AST]:
    return next((k.value for k in call.keywords if k.arg == "device"), None)


class Linter:
    def __init__(self, src_root: str = SRC):
        self.project = cg.Project.load(src_root)
        self.findings: List[Finding] = []
        self.waived: List[Finding] = []
        self.used_waiver_lines: Set[Tuple[str, int]] = set()

    def _emit(self, mod: cg.ModuleInfo, node: ast.AST, rule: str,
              message: str) -> None:
        f = Finding(mod.path, getattr(node, "lineno", 0),
                    getattr(node, "col_offset", 0), rule, message)
        ln = f.line - 1
        lines = [ln] if 0 <= ln < len(mod.lines) else []
        ln -= 1
        while 0 <= ln < len(mod.lines) and \
                mod.lines[ln].lstrip().startswith("#"):
            lines.append(ln)
            ln -= 1
        for i in lines:
            m = WAIVER_RE.search(mod.lines[i])
            if m and m.group(1) == rule:
                self.used_waiver_lines.add((mod.path, i + 1))
                self.waived.append(f)
                return
        self.findings.append(f)

    def run(self) -> List[Finding]:
        self.hot = cg.hot_functions(self.project)
        roots = [self.project.funcs[q] for q in STEP_ROOTS
                 if q in self.project.funcs]
        self.step = cg.reachable(self.project, roots, also=STEP_MODULES)
        self.scopes = cg.tensor_scopes(self.project, self.hot | self.step)
        self.rule_bare_assert()
        self.rule_host_sync()
        self.rule_kernel_oracle()
        self.rule_jit_spec()
        self.rule_donated_reuse()
        self.rule_tracer_if()
        self.findings.sort(key=lambda f: (f.path, f.line, f.col))
        return self.findings

    # -------------------------------------------------------------- rules --
    def rule_bare_assert(self) -> None:
        for mod in self.project.modules.values():
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Assert):
                    self._emit(mod, node, "bare-assert",
                               "bare assert in library code (stripped "
                               "under python -O) — raise ValueError/"
                               "RuntimeError instead")

    def _host_made(self, mod, e: ast.AST, host_names: Set[str]) -> bool:
        """`e` is a tensor made on the host from a host value: a
        `HOST_MAKERS` call with no device (or the CPU), or a name the
        function binds to one."""
        if isinstance(e, ast.Name):
            return e.id in host_names
        if not isinstance(e, ast.Call) or \
                self.project.resolve(mod, e.func) not in HOST_MAKERS:
            return False
        dev = _device_kw(e)
        return dev is None or _is_cpu(dev)

    def _host_to_device(self, mod, node: ast.Call,
                        host_names: Set[str]) -> Optional[str]:
        """A copy of a host value to the device: `.cuda()`, or `.to(x)`
        with x no dtype (`torch.<dtype>` or a name with "dtype" in it) and
        not the CPU, of a host-made tensor; or a `HOST_MAKERS` call given a
        device other than the CPU."""
        f = node.func
        fq = self.project.resolve(mod, f)
        if fq in HOST_MAKERS:
            dev = _device_kw(node)
            if dev is not None and not _is_cpu(dev):
                return f"{fq}(..., device=) of a host value"
            return None
        if not (isinstance(f, ast.Attribute) and f.attr in ("to", "cuda")
                and self._host_made(mod, f.value, host_names)):
            return None
        if f.attr == "to":
            dest = _device_kw(node) or (node.args[0] if node.args else None)
            if dest is None or _is_cpu(dest):
                return None
            dfq = self.project.resolve(mod, dest) or ""
            name = dest.id if isinstance(dest, ast.Name) else \
                dest.attr if isinstance(dest, ast.Attribute) else ""
            if (dfq.startswith("torch.") and dfq != "torch.device") \
                    or "dtype" in name:
                return None
        return f"a copy of a host value to the device (.{f.attr}())"

    def _sync_kind(self, mod, node: ast.Call) -> Optional[str]:
        fq = self.project.resolve(mod, node.func)
        if fq in SYNC_FQS:
            return fq
        if isinstance(node.func, ast.Attribute):
            m = node.func.attr
            if m in SYNC_METHODS:
                return f".{m}()"
            if m == "to" and _to_cpu(node):
                return '.to("cpu")'
        return None

    def rule_host_sync(self) -> None:
        hot, scopes = self.hot, self.scopes
        for f in sorted(hot, key=lambda g: g.qname):
            mod, sc = f.module, scopes[f]
            where = f"in {f.qname[len(mod.fq) + 1:]}, on the hot path"
            host_names = {t.id for node in cg.own_nodes(f.node)
                          if isinstance(node, ast.Assign)
                          and self._host_made(mod, node.value, set())
                          for t in node.targets if isinstance(t, ast.Name)}
            for node in cg.own_nodes(f.node):
                kind = None
                if isinstance(node, ast.Call):
                    kind = self._sync_kind(mod, node) or \
                        self._host_to_device(mod, node, host_names)
                    if kind is None and isinstance(node.func, ast.Name) \
                            and node.func.id in ("int", "float", "bool") \
                            and any(sc.expr(a) for a in node.args):
                        kind = f"{node.func.id}() on a tensor"
                elif isinstance(node, (ast.If, ast.While, ast.IfExp)) \
                        and sc.expr(node.test):
                    kind = {ast.If: "if", ast.While: "while",
                            ast.IfExp: "a conditional expression"}[
                                type(node)] + " on a tensor"
                if kind is not None:
                    self._emit(mod, node, "host-sync",
                               f"{kind} ({where}) blocks the host on the "
                               "device; "
                               "waive with the reason if it is designed")

    def rule_kernel_oracle(self) -> None:
        ref = self.project.modules.get(REF_MODULE)
        for mod in self.project.modules.values():
            if not mod.fq.startswith("repro_torch.kernels.") \
                    or mod.fq == REF_MODULE:
                continue
            for f in mod.funcs.values():
                if f.parent is not None or f.cls_name is not None:
                    continue
                for node in cg.own_nodes(f.node):
                    if not (isinstance(node, ast.Call) and
                            isinstance(node.func, ast.Attribute)):
                        continue
                    sym = node.func.attr
                    if not sym.startswith(LAUNCH_PREFIX) or \
                            sym.endswith(QUERY_SUFFIXES):
                        continue
                    name = sym[len(LAUNCH_PREFIX):] + "_ref"
                    oracle = None if ref is None else \
                        ref.funcs.get(f"{REF_MODULE}.{name}")
                    if oracle is None:
                        self._emit(mod, f.node, "kernel-oracle",
                                   f"`{f.name}` launches `{sym}` but "
                                   f"kernels/ref.py has no `{name}`")
                    elif oracle.positional_params != f.positional_params:
                        self._emit(mod, f.node, "kernel-oracle",
                                   f"`{f.name}` positional parameters "
                                   f"{f.positional_params} differ from "
                                   f"`{name}` {oracle.positional_params}")

    def rule_jit_spec(self) -> None:
        for mod in self.project.modules.values():
            if mod.fq == GRAPH_MODULE:
                continue
            for node in ast.walk(mod.tree):
                if isinstance(node, (ast.Name, ast.Attribute)) and \
                        isinstance(node.ctx, ast.Load) and \
                        self.project.resolve(mod, node) in GRAPH_FQS:
                    self._emit(mod, node, "jit-spec",
                               f"`{self.project.resolve(mod, node)}` "
                               "outside core/graphs.py — capture through "
                               "`core.graphs.StepGraphs`, which declares "
                               "the step's static inputs")

    def rule_donated_reuse(self) -> None:
        for mod in self.project.modules.values():
            for f in mod.funcs.values():
                if f.name == "__init__":
                    continue
                for node in cg.own_nodes(f.node):
                    if isinstance(node, ast.Assign):
                        targets = node.targets
                    elif isinstance(node, ast.AnnAssign):
                        targets = [node.target]
                    else:
                        continue
                    for t in targets:
                        for sub in _unpacked(t):
                            what = _step_buffer(f, sub)
                            if what:
                                self._emit(
                                    mod, sub, "donated-reuse",
                                    f"{what} rebound by assignment in "
                                    f"`{f.name}` — a captured step "
                                    "replays the old address; write "
                                    "it in place (copy_, an indexed "
                                    "write)")

    def rule_tracer_if(self) -> None:
        for f in sorted(self.step, key=lambda g: g.qname):
            mod, sc = f.module, self.scopes[f]
            for node in cg.own_nodes(f.node):
                kind = None
                if isinstance(node, (ast.If, ast.While, ast.IfExp)) and \
                        sc.expr(node.test):
                    kind = {ast.If: "if", ast.While: "while",
                            ast.IfExp: "a conditional expression"}[
                                type(node)]
                elif isinstance(node, ast.Call):
                    fn = node.func
                    if isinstance(fn, ast.Name) and \
                            fn.id in ("int", "bool", "float") and \
                            any(sc.expr(a) for a in node.args):
                        kind = f"{fn.id}()"
                    elif isinstance(fn, ast.Attribute) and \
                            fn.attr == "item" and sc.expr(fn.value):
                        kind = ".item()"
                if kind is not None:
                    self._emit(mod, node, "tracer-if",
                               f"{kind} on a tensor in "
                               f"`{f.qname[len(mod.fq) + 1:]}`, reachable "
                               "from a captured step — a CUDA "
                               "graph bakes in the value of its capture; "
                               "compute it on the device (torch.where)")

    # ------------------------------------------------------------ waivers --
    def unused_waivers(self) -> List[Finding]:
        """Waiver comments that matched no finding in this run, or that
        give no reason. Only real comment tokens count (docstrings that
        show the syntax are not waivers). Call after run()."""
        out: List[Finding] = []
        for mod in self.project.modules.values():
            toks = tokenize.generate_tokens(
                io.StringIO("\n".join(mod.lines)).readline)
            for tok in toks:
                m = WAIVER_RE.search(tok.string) \
                    if tok.type == tokenize.COMMENT else None
                if m is None:
                    continue
                line = tok.start[0]
                if (mod.path, line) not in self.used_waiver_lines:
                    msg = (f"waiver `allow-{m.group(1)}` matched no finding "
                           "in this run — remove it or fix the marker")
                elif not _has_reason(m.group(2)):
                    msg = f"waiver `allow-{m.group(1)}` gives no reason"
                else:
                    continue
                out.append(Finding(mod.path, line, tok.start[1],
                                   "unused-waiver", msg))
        out.sort(key=lambda f: (f.path, f.line, f.col))
        return out


def _unpacked(t: ast.AST) -> List[ast.AST]:
    if isinstance(t, (ast.Tuple, ast.List)):
        return [x for e in t.elts for x in _unpacked(e)]
    if isinstance(t, ast.Starred):
        return _unpacked(t.value)
    return [t]


def _self_of(f: cg.FuncInfo, e: ast.AST, cls: str) -> bool:
    return isinstance(e, ast.Name) and e.id == "self" and f.cls_name == cls


def _is_pipe(f, e) -> bool:
    """The decode pipeline: `pipe`, `<x>.pipe`, or `self` in it."""
    return (isinstance(e, ast.Name) and e.id == "pipe") or \
        (isinstance(e, ast.Attribute) and e.attr == "pipe") or \
        _self_of(f, e, "DecodePipeline")


def _is_backend(f, e) -> bool:
    return (isinstance(e, ast.Name) and e.id in ("be", "backend")) or \
        (isinstance(e, ast.Attribute) and e.attr == "backend") or \
        _self_of(f, e, "NumericsBackend")


def _is_device_pool(f, e) -> bool:
    """A `DevicePool`: `<x>.pool` (whose `.pool` is the tree), or `self`
    in the class."""
    return (isinstance(e, ast.Attribute) and e.attr == "pool") or \
        _self_of(f, e, "DevicePool")


def _is_trainer(f, e) -> bool:
    """A `launch.train.Trainer`: `trainer`, or `self` in the class."""
    return (isinstance(e, ast.Name) and e.id == "trainer") or \
        _self_of(f, e, "Trainer")


def _tree_root(f, e) -> Optional[str]:
    """What `e` is, if it is a tree a captured step reads."""
    if isinstance(e, ast.Attribute):
        if e.attr == "cache" and _is_backend(f, e.value):
            return "the backend's KV plane"
        if e.attr == "stage" and _is_backend(f, e.value):
            return "the prefill's LoRA staging pool"
        if e.attr == "pool" and _is_device_pool(f, e.value):
            return "the LoRA pool"
        if e.attr in TRAINER_BUFFERS and _is_trainer(f, e.value):
            return f"the trainer's `{e.attr}`"
        if e.attr == "views":
            return "a captured step's static inputs"
    return None


def _step_buffer(f: cg.FuncInfo, t: ast.AST) -> Optional[str]:
    """The step buffer an assignment target rebinds, or None: a pipeline
    buffer, a static inputs' `flat`, a tree (`cache`, `stage`, `pool`, a
    trainer's leaves, a static inputs' `views`), or a leaf of one (keys
    that are all strings, or one key: a dict's entry; an index into a
    tensor writes it in place)."""
    if isinstance(t, ast.Attribute):
        if t.attr in PIPE_BUFFERS and _is_pipe(f, t.value):
            return f"the decode pipeline's `{t.attr}`"
        if t.attr == "flat":
            return "a captured step's static inputs"
        return _tree_root(f, t)
    if not isinstance(t, ast.Subscript):
        return None
    keys = []
    while isinstance(t, ast.Subscript):
        keys.append(t.slice)
        t = t.value
    root = _tree_root(f, t)
    if root and (len(keys) == 1 or all(
            isinstance(k, ast.Constant) and isinstance(k.value, str)
            for k in keys)):
        return f"a leaf of {root}"
    return None


@dataclass
class LintReport:
    findings: List[Finding]
    waived: List[Finding]
    unused_waivers: List[Finding]

    def to_dict(self) -> dict:
        return {k: [asdict(f) for f in getattr(self, k)]
                for k in ("findings", "waived", "unused_waivers")}

    @classmethod
    def from_dict(cls, d: dict) -> "LintReport":
        return cls(**{k: [Finding(**f) for f in d[k]]
                      for k in ("findings", "waived", "unused_waivers")})


def run_lint_report(src_root: str = SRC,
                    targets: Optional[Sequence[str]] = None) -> LintReport:
    """Lint the package `repro_torch` under `src_root`; report only files
    under `targets` (the analysis is always of the whole package)."""
    linter = Linter(src_root)
    findings = linter.run()
    report = LintReport(findings, linter.waived, linter.unused_waivers())
    if targets:
        roots = [os.path.abspath(t) for t in targets]

        def keep(fs):
            return [f for f in fs if any(
                os.path.abspath(f.path) == r
                or os.path.abspath(f.path).startswith(r.rstrip(os.sep)
                                                      + os.sep)
                for r in roots)]

        report = LintReport(keep(report.findings), keep(report.waived),
                            keep(report.unused_waivers))
    return report


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Lint the port's package (src/repro_torch).")
    ap.add_argument("paths", nargs="*", help="report findings under these "
                    "paths (default: the whole package)")
    ap.add_argument("--strict-waivers", action="store_true",
                    help="also fail on waivers that matched nothing or "
                    "give no reason")
    ap.add_argument("--json", metavar="F", help="write the report as JSON")
    args = ap.parse_args(argv)
    missing = [p for p in args.paths if not os.path.exists(p)]
    if missing:      # a wrong path would filter every finding away
        ap.error(f"no such path: {missing}")
    report = run_lint_report(SRC, args.paths)
    fail = bool(report.findings) or (args.strict_waivers
                                     and bool(report.unused_waivers))
    for f in report.findings:
        print(f.render())
    if args.strict_waivers:
        for f in report.unused_waivers:
            print(f.render())
    if args.json:
        payload = dict(report.to_dict(), exit=int(fail))
        with open(args.json, "w") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
            fh.write("\n")
    print(f"{len(report.findings)} finding(s), {len(report.waived)} "
          f"waived, {len(report.unused_waivers)} waiver(s) audited",
          file=sys.stderr)
    return int(fail)


if __name__ == "__main__":
    sys.exit(main())
