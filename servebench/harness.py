"""A run of a cell, from the benchmark's description to its result line."""
from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

from servebench import check, roofline, stats, trace
from servebench.cell import Cell, forbidden_modules, power_limit_w

HERE = Path(__file__).resolve().parent


class RunError(RuntimeError):
    """A run that must print no result."""


def load_benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise RunError(f"no workload {name!r} in BENCHMARK.json")


def metrics_for(bench: dict, section: str, cell: str) -> List[dict]:
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]


def load_reader(name: str, root: Path = HERE):
    """`servebench/metrics/<name>.py`'s `read(ctx)`."""
    path = root / "metrics" / f"{name}.py"
    if not path.is_file():
        raise RunError(f"no reader for per-layer metric {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(
        "servebench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run(bench: dict, name: str, seed: int, seconds: float, trace_on: bool,
        t_process: float, *, device: str = "cuda", control: bool = False,
        root: Path = HERE, log: Callable = print, cell_kw=None) -> dict:
    import torch
    wl = workload(bench, name)
    cell = Cell(wl, seed, seconds, device=device, root=root,
                log=log, **(cell_kw or {}))
    t = cell._lap("import", t_process)
    t = cell.build(t)
    t = cell.warm(t)
    be = cell.server.backend
    captures_before = sum(e.captures for e in be.graphs.entries.values())
    if trace_on:
        cell.recorder = trace.Recorder(torch, cell.server, cell.rank_of)
        cell.recorder.wrap()
        cell.recorder.profiler_init()
    t = cell.preroll(t)
    if cell.device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_process
    log("setup " + json.dumps({k: round(v, 3) for k, v in
                               cell.setup.items()} | {"total": setup_s}))
    stats0 = dict(be.transfer_stats)
    cell.window()
    log("program counters over the window: " + json.dumps(
        {k: v - stats0.get(k, 0) for k, v in be.transfer_stats.items()}))
    bad = forbidden_modules()
    if bad:
        print("forbidden modules loaded: " + ", ".join(bad), file=sys.stderr)
        raise RunError("forbidden modules loaded")
    captured = sum(e.captures for e in be.graphs.entries.values()) \
        - captures_before
    if captured:
        keys = [k for k, e in be.graphs.entries.items()
                if k not in cell.warm_keys and e.captures]
        log(f"graphs captured inside the window: {captured} ({keys})")
    peak = int(torch.cuda.max_memory_allocated(cell.device)) \
        if cell.device.type == "cuda" else 0
    e2e = cell.e2e()
    log(f"window: {cell.attempted()} attempted, {len(cell.finished())} "
        f"finished, {stats.tokens_in(cell.reqs, cell.t0, cell.t1)} tokens; "
        f"closed {1e3 * (cell.t_close - cell.t1):.1f} ms late")
    out = {"correct": False, "attempted": cell.attempted(),
           "failed": cell.failed()}
    dev_name = torch.cuda.get_device_name(cell.device) \
        if cell.device.type == "cuda" else "cpu"
    device_info = {"platform": "gpu" if cell.device.type == "cuda"
                   else "cpu", "kind": dev_name, "count": 1,
                   "memory_peak_bytes": peak,
                   "power_limit_w": power_limit_w()}
    if trace_on:
        cell.recorder.read_profile()
        metrics, breakdown = per_layer(bench, cell, dev_name)
        prof = cell.recorder.profile
        device_info["busy_s"] = prof.busy_s
        device_info["window_s"] = prof.window_s
    else:
        metrics = {}
        for m in metrics_for(bench, "end_to_end", name):
            v = setup_s if m["name"] == "setup_s" else e2e[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    finished = cell.finished()
    cell.free_program()
    limits = check.load_limits(name, root)
    sample = check.choose(finished, check.SAMPLE, seed)
    t_ref = time.perf_counter()
    got = check.gaps(torch, cell.spec, cell.weights, cell.adapters, sample,
                     control=control)
    log(f"reference: {len(sample)} requests, {got['served_tokens']} served "
        f"tokens, {time.perf_counter() - t_ref:.1f} s; "
        + json.dumps(got["requests"]))
    missing = len(set(a.rank for a in cell.traffic.adapters)
                  - {r.rank for r in sample})
    limit = limits["max_logit_gap"]

    def verdict(gap: float) -> bool:
        return gap <= limit and missing == 0 and not math.isnan(gap)

    # the control's tokens take the served tokens' place in the comparison
    gap = got["control_max_logit_gap"] if control else got["max_logit_gap"]
    checks = {"max_logit_gap": {"value": gap, "limit": limit},
              "ranks_missing": {"value": missing, "limit": 0}}
    out["correct"] = verdict(gap)
    out["metrics"] = metrics
    out["device"] = device_info
    if trace_on:
        out["breakdown"] = breakdown
    if control:
        out["program_max_logit_gap"] = got["max_logit_gap"]
        out["program_correct"] = verdict(got["max_logit_gap"])
    out["checks"] = checks
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    return out


def per_layer(bench: dict, cell: Cell, dev_name: str):
    rec = cell.recorder
    prof = rec.profile
    families = trace.load_families(cell.root)
    ctx = SimpleNamespace(
        spec=cell.spec, mix=cell.mix, recorder=rec, profile=prof,
        reqs=cell.reqs, t0=cell.t0, t1=cell.t1, t_prof=cell.t_prof,
        families=families,
        peaks=roofline.peaks(dev_name) if "H100" in dev_name
        else roofline.PEAKS["H100 SXM"])
    metrics: Dict[str, dict] = {}
    for m in metrics_for(bench, "per_layer", cell.name):
        v = load_reader(m["name"], cell.root)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    by_name: Dict[str, float] = {}
    for k in prof.kernels:
        by_name[k.name] = by_name.get(k.name, 0.0) + (k.end - k.start) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(prof.gaps.items(), key=lambda kv: -kv[1])[:10]
    fams: Dict[str, float] = {}
    for k in prof.kernels:
        f = trace.family_of(k.name, families)
        fams[f] = fams.get(f, 0.0) + (k.end - k.start) / 1e6
    cell.log("device time by family in the traced span (s): "
             + json.dumps(dict(sorted(fams.items(), key=lambda kv: -kv[1]))))
    return metrics, {"device_ops": [[n[:160], s] for n, s in ops],
                     "idle_gaps": [[n, s] for n, s in gaps]}


def window_calls(ctx, kind: Optional[str] = None, profiled: bool = False):
    """The recorder's calls made in the window (and, with `profiled`,
    inside the traced span; without, outside it)."""
    return [c for c in ctx.recorder.calls
            if ctx.t0 <= c.host_start and c.host_end <= ctx.t1
            and c.in_profile == profiled
            and (kind is None or c.kind == kind)]


def family_seconds(ctx, family: str, call_kind: str) -> float:
    fam = {family: ctx.families[family]}
    return sum((k.end - k.start) / 1e6 for k in ctx.profile.kernels
               if k.call == call_kind and trace.family_of(k.name, fam)
               == family)

