"""Multi-pod dry run: lay every (architecture x input shape) out on the
production meshes and measure one rank's step without a device. Mirrors
`repro.launch.dryrun`.

A combo runs in the process that calls `run_combo` (the CLI's), under a
"fake" process group of 256 ranks (pod16x16) or 512 (pod2x16x16) that it
starts there, and under `FakeTensorMode`, so no tensor is allocated and no
byte moves. Parameters, optimizer state, cache, LoRA pool and batch are
DTensors laid out by their logical axes (`repro_torch.sharding`;
`serve_rules()` under `serve_tp`), and the step is built as the
reference's `build_train` / `build_prefill` / `build_decode` build it,
then run once through the port's entry points (`model.loss` and the
train step, `model.prefill`, `model.decode`) under the current mesh.

The record's numbers:
  * analytic_input_bytes_per_chip: the step's inputs over their
    shardings (arithmetic; the reference's, up to the pool's rank pad);
  * bytes_per_chip: one rank's peak from `MemTracker` (fits_80g: below an
    H100's 80 GiB);
  * hlo_flops_per_dev: one rank's FLOPs from `FlopCounterMode` counting
    the local ops DTensor runs; hlo_bytes_per_dev: the bytes those ops
    read and write; collective_bytes: from the collectives `CommDebugMode`
    sees (`roofline.comm_bytes`);
  * all of them from the reference's 1- and 2-unit probes (`cfg.probe`),
    extrapolated to the full depth as it does (`scan_corrected`); the
    peak of a train step from probes that keep its microbatches;
    model_flops and roofline from `roofline`.
These are counts made on the host, not device times.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
      --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch import roofline, sharding as shd
from repro_torch.configs.base import (INPUT_SHAPES, ModelConfig,
                                      all_arch_ids, combo_is_supported,
                                      get_config)
from repro_torch.core import lora as lora_lib
from repro_torch.models import model as model_lib
from repro_torch.models.param import split
from repro_torch.training import optim
from repro_torch.training import train as train_lib

OPTS = ("serve_tp", "kv8", "moe2d", "moe_gather", "moe_ep", "seqpar")
GIB = 2 ** 30


def apply_opts(cfg: ModelConfig, opts) -> ModelConfig:
    """The reference's perf-iteration knobs."""
    names = {"serve_tp": ("serve_tp", True), "kv8": ("kv_cache_dtype", "int8"),
             "moe2d": ("moe_2d_ff", True),
             "moe_gather": ("moe_gather_weights", True),
             "moe_ep": ("moe_ep", True), "seqpar": ("seq_parallel", True)}
    kw = dict(names[o] for o in opts)
    return dataclasses.replace(cfg, **kw) if kw else cfg


# ----------------------------------------------------------- the inputs ----

def _rules(cfg, shape):
    return shd.serve_rules() if cfg.serve_tp and shape.kind != "train" \
        else None


def inputs(cfg: ModelConfig, shape):
    """The step's persistent inputs as [(name, meta tree, axes tree)]:
    parameters (and, training, the AdamW moments and step), then the batch
    (training, prefill) or the cache and the new tokens and positions
    (decode), then the LoRA pool and the rows' slots (serving). The
    reference's build_train / build_prefill / build_decode hold these."""
    meta, axes = model_lib.abstract_params(cfg)
    out = [("params", meta, axes)]
    specs = model_lib.input_specs(cfg, shape)
    if shape.kind == "train":
        mdt = getattr(torch, cfg.opt_moments_dtype)
        mom = train_lib.tree_lib.map_(
            lambda p: torch.empty(p.shape, dtype=mdt, device="meta"), meta)
        out += [("mu", mom, axes), ("nu", mom, axes),
                ("step", torch.empty((), dtype=torch.int32, device="meta"),
                 ())]
    if shape.kind in ("train", "prefill"):
        out.append(("batch", specs["batch"],
                    model_lib.batch_logical_axes(specs["batch"])))
    else:
        out += [("cache", specs["cache"],
                 model_lib.cache_logical_axes(cfg, specs["cache"])),
                ("tokens_t", specs["tokens_t"], ("batch", None)),
                ("pos", specs["pos"], ("batch",))]
    if shape.kind != "train":
        pool, pool_axes = split(lora_lib.pool_abstract(cfg))
        out += [("pool", pool, pool_axes),
                ("idx", torch.empty((shape.global_batch,), dtype=torch.int32,
                                    device="meta"), ("batch",))]
    return out


def analytic_bytes(cfg: ModelConfig, shape, mesh) -> float:
    """One rank's share of the step's persistent inputs: each leaf's bytes
    over the pieces its spec cuts it into (arithmetic; any mesh with
    named axis sizes, the reference tests' duck-typed one included)."""
    rules, total = _rules(cfg, shape), 0.0
    for name, meta, axes in inputs(cfg, shape):
        r = rules if name in ("params", "pool") else None
        for t, ax in _pairs(meta, axes):
            spec = shd.logical_to_physical(ax, tuple(t.shape), mesh, r)
            total += t.numel() * t.element_size() / shd.shard_count(spec,
                                                                     mesh)
    return total


def _pairs(meta, axes):
    if shd.is_axes(axes):
        return [(meta, axes)]
    if isinstance(axes, dict):
        return [p for k in axes for p in _pairs(meta[k], axes[k])]
    return [p for m, a in zip(meta, axes) for p in _pairs(m, a)]


def build(cfg: ModelConfig, shape, mesh):
    """(step, its DTensor inputs): the inputs of `inputs` laid out on
    `mesh` by their axes (each rank allocating its shard; under
    FakeTensorMode, none), the parameters in the port's modules, and the
    step the reference's `build_*` functions build: AdamW full
    fine-tuning; a prefill of the whole prompt with the LoRA pool
    (mbgmv) and a cache of its length, last logits only; one decode step
    with the pool."""
    from repro_torch.models.weights import _build
    rules = _rules(cfg, shape)
    held = {name: shd.distribute_empty(
        meta, axes, mesh, rules if name in ("params", "pool") else None)
        for name, meta, axes in inputs(cfg, shape)}
    params = _build(cfg, held["params"])
    if shape.kind == "train":
        state = optim.AdamWState(held["step"], held["mu"], held["nu"])
        step = train_lib.make_train_step(
            cfg, optim.AdamWConfig(moments_dtype=cfg.opt_moments_dtype))
        return (lambda: step(params, state, held["batch"])), \
            [params, state, held["batch"]]
    lora = {"pool": held["pool"], "idx": held["idx"], "mode": "mbgmv"}
    if shape.kind == "prefill":
        def fn():
            return model_lib.prefill(cfg, params, held["batch"], lora=lora,
                                     cache_slots=shape.seq_len,
                                     last_only=True)
        return fn, [params, held["batch"], held["pool"], held["idx"]]
    window = model_lib.decode_window(cfg, shape.seq_len)

    def fn():
        return model_lib.decode(cfg, params, held["cache"], held["tokens_t"],
                                held["pos"], lora=lora, window=window)

    return fn, [params, held["cache"], held["tokens_t"], held["pos"],
                held["pool"], held["idx"]]


# ------------------------------------------------------------ counting ----

def _counters():
    """(FLOP counter of the local ops, collective recorder, byte counter
    of the local ops): torch dispatch modes that step aside for DTensor,
    so they see the ops and collectives one rank runs."""
    from torch._guards import active_fake_mode
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import FlopCounterMode

    class LocalFlops(FlopCounterMode):
        def __enter__(self):
            self.fake = active_fake_mode()
            return super().__enter__()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(t is DTensor for t in types):
                return NotImplemented
            if active_fake_mode() is not self.fake:    # DTensor's own
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    class CommBytes(CommDebugMode):
        """CommDebugMode, also recording each collective's kind and the
        bytes of its result (the HLO convention)."""

        def __init__(self):
            super().__init__()
            self.records = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            kind = _collective_kind(func)
            if out is not NotImplemented and kind is not None:
                t = out if isinstance(out, torch.Tensor) else args[0]
                if isinstance(t, (list, tuple)):
                    t = t[0]
                self.records.append((kind, t.numel() * t.element_size()))
            return out

    class Traffic(TorchDispatchMode):
        """Bytes read and written by the local ops that are no views."""

        def __enter__(self):
            self.fake, self.bytes = active_fake_mode(), 0
            return super().__enter__()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(t is DTensor for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            if active_fake_mode() is self.fake and not any(
                    r.alias_info for r in func._schema.returns) \
                    and _collective_kind(func) is None:
                self.bytes += _tensor_bytes((args, kwargs, out))
            return out

    return LocalFlops(display=False), CommBytes(), Traffic()


def _collective_kind(func):
    ns = getattr(func, "namespace", "")
    if ns not in ("_c10d_functional", "_c10d_functional_autograd", "c10d",
                  "_dtensor"):
        return None
    name = func.__name__.split(".")[0]
    for key, kind in (("all_gather", "all-gather"),
                      ("allgather", "all-gather"),
                      ("reduce_scatter", "reduce-scatter"),
                      ("all_reduce", "all-reduce"),
                      ("allreduce", "all-reduce"),
                      ("alltoall", "all-to-all"), ("all_to_all", "all-to-all")):
        if key in name:
            return kind
    return None


def _tensor_bytes(x) -> int:
    """Bytes of the tensors in x, each at most its storage's (a broadcast
    view reads its storage once)."""
    if isinstance(x, torch.Tensor):
        return min(x.numel() * x.element_size(),
                   x.untyped_storage().nbytes())
    if isinstance(x, dict):
        return sum(_tensor_bytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(v) for v in x)
    return 0


def measure(cfg: ModelConfig, shape, mesh):
    """Build the step on `mesh`, run it once uncounted, then once under
    the counters: {flops, bytes, collectives (per kind), peak_bytes,
    trace_s}. DTensor works out an op's output layout the first time it
    meets the op at those input layouts by running it at global shapes
    under the ambient fake mode, where the counters would see it; the
    uncounted run meets every such op first."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True), shd.use_mesh(mesh):
        fn, live = build(cfg, shape, mesh)
        fn()
        flops, comm, traffic = _counters()
        mem = MemTracker()
        mem.track_external(*_leaves(live))
        with flops, comm, traffic, mem:
            fn()
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(traffic.bytes),
            "collectives": roofline.comm_bytes(comm.records),
            "peak_bytes": float(mem.get_tracker_snapshot("peak")[
                torch.device("cpu")]["Total"]),
            "trace_s": time.time() - t0}


def _leaves(tree):
    """Modules and tensors of a tree (dicts, lists, tuples)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# --------------------------------------------------------------- combos ----

def _group(world: int):
    """A "fake" default process group of `world` ranks (this process is
    rank 0), started here; one of another size is replaced."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs a process of its own: a "
                               "real process group is running here")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _extrapolate(v1, v2, units):
    """A count at 1 and 2 layer-units, carried on to `units` of them."""
    return v1 + (units - 1) * (v2 - v1)


def _probes(cfg: ModelConfig, shape, mesh):
    """The reference's scan correction: costs from 1- and 2-unit probes
    (`cfg.probe`, one microbatch) extrapolated to the full depth; the peak
    memory likewise, from probes that keep the config's microbatches (a
    train step's peak is one microbatch's)."""
    units = cfg.n_layers / (cfg.probe(2).n_layers - cfg.probe(1).n_layers)
    m = [measure(cfg.probe(k), shape, mesh) for k in (1, 2)]
    mem = m
    if shape.kind == "train" and cfg.accum_steps > 1:
        mcfg = [dataclasses.replace(cfg.probe(k), accum_steps=cfg.accum_steps)
                for k in (1, 2)]
        mem = [measure(c, shape, mesh) for c in mcfg]
    coll = [sum(x["collectives"].values()) for x in m]
    return {
        "flops": _extrapolate(m[0]["flops"], m[1]["flops"], units),
        "bytes": _extrapolate(m[0]["bytes"], m[1]["bytes"], units),
        "coll": max(_extrapolate(*coll, units), 0.0),
        "collectives": {k: max(_extrapolate(m[0]["collectives"][k],
                                            m[1]["collectives"][k], units), 0)
                        for k in m[0]["collectives"]},
        "peak_bytes": _extrapolate(mem[0]["peak_bytes"], mem[1]["peak_bytes"],
                                   units),
        "trace_s": sum(x["trace_s"] for x in m + (mem if mem is not m
                                                   else [])),
        "per_layer": {"flops": m[1]["flops"] - m[0]["flops"],
                      "bytes": m[1]["bytes"] - m[0]["bytes"],
                      "coll": coll[1] - coll[0],
                      "peak_bytes": mem[1]["peak_bytes"]
                      - mem[0]["peak_bytes"]}}


def run_combo(arch: str, shape_name: str, multi_pod: bool = False,
              opts=()):
    """One (arch x shape x mesh) record, as the reference's `run_combo`
    writes it (with probes: `scan_corrected`)."""
    from repro_torch.launch.mesh import make_production_mesh
    cfg = apply_opts(get_config(arch), opts)
    shape = INPUT_SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    tagext = ("+" + "+".join(sorted(opts))) if opts else ""
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name + tagext,
           "status": "ok", "opts": sorted(opts)}
    ok, why = combo_is_supported(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    chips = 512 if multi_pod else 256
    _group(chips)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    m = _probes(cfg, shape, mesh)
    rec["probe_per_layer"] = m["per_layer"]
    rec["scan_corrected"] = True
    flops, bytes_hbm, coll_total = m["flops"], m["bytes"], m["coll"]
    terms = roofline.roofline_terms(flops, bytes_hbm, coll_total, chips,
                                    per_device=True)
    mflops = roofline.model_flops(cfg, shape)
    rec.update({
        "chips": chips,
        "analytic_input_bytes_per_chip": analytic_bytes(cfg, shape, mesh),
        "trace_s": round(m["trace_s"], 2),
        "hlo_flops_per_dev": flops,
        "hlo_flops_total": flops * chips,
        "hlo_bytes_per_dev": bytes_hbm,
        "collective_bytes": m["collectives"],
        "collective_total_per_dev": coll_total,
        "roofline": terms,
        "model_flops": mflops,
        "useful_flops_ratio": (mflops / (flops * chips)) if flops else None,
        "bytes_per_chip": m["peak_bytes"],
        "fits_80g": m["peak_bytes"] < 80 * GIB,
    })
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--opt", default="",
                    help="comma-separated perf knobs: " + ",".join(OPTS))
    args = ap.parse_args(argv)
    opts = tuple(o for o in args.opt.split(",") if o)
    torch.set_num_threads(1)

    archs = all_arch_ids() if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}" \
                    + (f" [{args.opt}]" if opts else "")
                try:
                    rec = run_combo(arch, shape, mp, opts=opts)
                except Exception as e:          # a failure here is a bug
                    mname = ("pod2x16x16" if mp else "pod16x16") \
                        + (("+" + "+".join(sorted(opts))) if opts else "")
                    rec = {"arch": arch, "shape": shape, "mesh": mname,
                           "status": "FAILED", "error": repr(e),
                           "trace": traceback.format_exc()[-2000:]}
                results.append(rec)
                path = os.path.join(
                    args.out, f"{rec['arch']}_{rec['shape']}_{rec['mesh']}.json")
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1, default=str)
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    print(f"[ok] {tag}: trace={rec['trace_s']}s "
                          f"bytes_per_chip={rec['bytes_per_chip'] / GIB:.2f}"
                          f"GiB fits_80g={rec['fits_80g']} "
                          f"dominant={r['dominant']} "
                          f"c/m/x={r['compute_s']:.4f}/{r['memory_s']:.4f}/"
                          f"{r['collective_s']:.4f}s", flush=True)
                else:
                    print(f"[{rec['status']}] {tag}: "
                          f"{rec.get('reason', rec.get('error', ''))}",
                          flush=True)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_fail = sum(r["status"] == "FAILED" for r in results)
    print(f"\n{n_ok} ok / {n_skip} skipped / {n_fail} FAILED")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
