"""Checks of the port's CUDA kernels on the card (chip_smoke.py, phase S).

The reference's `repro.analysis.kernel_verify` proves five TPU invariants
statically, over the BlockSpec models of `kernel_model`. The port's
kernels run on the real card, so each rule has a counterpart that runs
them, or reads what the compiler and the CUDA runtime report:

* ``kernel-vmem`` -> `footprint`: every launch `kernel_model` gives for
  every registered config, described by the library itself
  (`rt_*_info`: the launch the entry point would make, no kernel runs):
  threads, dynamic shared memory (the launch code's own number), and the
  kernel's registers, static shared memory and local memory
  (`cudaFuncGetAttributes`), its resident blocks an SM
  (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`) and spills (the ptxas
  report of the build, `build.build_log`). Held to the card's limits
  (`rt_device_limits`): shared memory a block may opt in to, 65,536
  registers an SM and a block, threads a block; a spill fails unless
  `ALLOWED_SPILLS` gives its reason. The persistent bf16 flash launch's
  grid must be min(work tiles, SMs) (`flash.persistent_grid`), the
  persistent shrink's the plan's, every cluster on the card at once, and
  `flash.tile_order`, the CPU's copy of its walk over query tiles, must
  equal the library's (`flash_order_findings`).
* ``kernel-scratch`` -> the canaries' fills: each launch runs with its
  outputs and workspace filled with NaN, then with another pattern; the
  results must be bitwise equal (an element the kernel does not write
  keeps the fill). The bf16 flash kernel writes its output by TMA stores
  through a map of the guarded view, so the same fills and guard bands
  see what the map writes, clipped or not, on launches whose blocks walk
  one tile and many.
* ``kernel-bounds`` -> guard bands and poisoned inputs: sentinels before
  and after every output and workspace must survive; NaN in every input
  region the launch must not read (pages of no row, the rows of idx -1,
  slots no row uses, rank columns past a slot's live width under MBGMV,
  rows past the end) must leave the result bitwise equal.
* ``kernel-race`` -> phase 2's bitwise repeat, and here each launch
  repeated beside a matrix product on a second stream (which changes
  which blocks run when): bitwise equal.
* ``kernel-dtype`` -> phase 2's f32 tolerances (the kernels accumulate in
  f32 and cast once), and here each LoRA path's first run held to its
  plain version row by row (`rows_close`), which a split shrink whose
  blocks miss part of d_in fails.

`mutants` proves the checks fire, at the ctypes boundary with no change
to any .cu: a launch told one row more than its output holds must trip
the guard band, one told a row fewer the fill check, an idx that points
at a poisoned slot the poison check, a shrink (decode or row tiles)
told half its split the entry point's refusal, and one told d_in 64
short the plain check. Every function here returns
its findings (strings); chip_smoke.py fails the run on any.
"""
from __future__ import annotations

import ctypes
import math
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.analysis import kernel_model
from repro_torch.kernels import bgmv, build, flash, paged, ref

REGS_PER_SM = 65536
MAX_CLUSTER = 8                # blocks a cluster without opting in
# kernels (ptxas entry names, by substring) allowed to spill, with why
# (PERF.md lists them with the spill sizes of the last card run)
ALLOWED_SPILLS: Dict[str, str] = {
    "flash_f32_kernel": (
        "the f32 flash kernel on CUDA cores spills 16-32 B a thread at hd "
        "32 / 64 / 128; it runs only in f32 (the accuracy arms and tests), "
        "never on a registered config's bf16 path"),
    # the f32 element-copy instantiations (a width that is no multiple of
    # 8: kVec false), by their mangled template arguments
    "paged_attention_kernelIfLb0E": (
        "f32 paged attention at an hd that is no multiple of 8 spills 8 B "
        "stored / 16 B loaded a thread; f32 runs only in the accuracy arms "
        "and tests, and no registered config has such an hd"),
}
GUARD = 4096                   # sentinel elements before and after a buffer
SENTINEL_BITS = {torch.float32: 0x7FA5A5A5, torch.bfloat16: 0x7FA5}
PATTERN = -12288.0             # the second fill (exact in bf16)
_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


# ----------------------------------------------------------- footprint ----

@dataclass
class Footprint:
    launch: kernel_model.Launch
    part: str                  # the launch's kernel, or "combine"
    threads: int
    dyn_smem: int
    registers: int
    static_smem: int
    local_bytes: int
    blocks_per_sm: int
    cluster: int               # blocks a cluster (1: none)
    max_clusters: int          # clusters the card holds at once (cluster > 1)


def device_limits(lib, device: int = 0) -> Dict[str, int]:
    out = (ctypes.c_longlong * 6)()
    build.check_launch(lib.rt_device_limits(device, out), "rt_device_limits")
    keys = ("smem_block_optin", "smem_sm", "regs_sm", "regs_block",
            "threads_sm", "sms")
    return dict(zip(keys, (int(v) for v in out)))


def _describe(lib, launch: kernel_model.Launch) -> List[Dict[str, int]]:
    a, dt = launch.args, build.DTYPE_CODE[launch.dtype]
    n = len(build.INFO_FIELDS)
    out = (ctypes.c_longlong * (2 * n))()
    if launch.kernel == "lora_shrink":
        rc = lib.rt_lora_shrink_info(a["rows"], a["d_in"], a["r_max"],
                                     a["slots"], a["tile"], a["d_chunk"],
                                     a["split"], a["grid"], dt, out)
    elif launch.kernel == "lora_expand":
        rc = lib.rt_lora_expand_info(a["rows"], a["r_max"], a["d_out"],
                                     a["blocks"], a["cols"], dt,
                                     build.DTYPE_CODE[a["y_dtype"]], out)
    elif launch.kernel == "paged_attention":
        rc = lib.rt_paged_attention_info(a["B"], a["H"], a["KV"], a["ps"],
                                         a["hd"], a["W"], a["nsplit"], dt,
                                         out)
    else:
        rc = lib.rt_flash_attention_info(a["B"], a["H"], a["Lq"], a["Lk"],
                                         a["hd"], a["causal"], a["window"],
                                         dt, out)
    build.check_launch(rc, f"{launch.label}: describe")
    recs = [dict(zip(build.INFO_FIELDS, out[:n]))]
    if launch.kernel == "paged_attention" and a["nsplit"] > 1:
        recs.append(dict(zip(build.INFO_FIELDS, out[n:])))
    return recs


def ptxas_spills(log: str) -> Dict[str, Tuple[int, int]]:
    """(spill store bytes, spill load bytes) per compiled entry function,
    from nvcc's `-Xptxas -v` report."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name] = (int(m.group(1)), int(m.group(2)))
            name = None
    return out


def footprint(lib, log: str, sms: int) -> Tuple[List[Footprint],
                                                Dict[str, int], List[str]]:
    """Every accepted launch of every config case and every shape case
    (`kernel_model.shape_cases`), described and held to the card's limits.
    Returns (footprints, the limits, findings)."""
    lim = device_limits(lib)
    rows, findings = [], []
    room = bgmv.cluster_room(torch.device("cuda"))
    for case in [*kernel_model.config_cases(), *kernel_model.shape_cases()]:
        for launch in kernel_model.launches(case, sms, room):
            if launch.refusal:
                findings.append(f"{launch.label}: the wrapper refuses a "
                                f"registered config: {launch.refusal}")
                continue
            for i, r in enumerate(_describe(lib, launch)):
                fp = Footprint(
                    launch, "combine" if i else launch.kernel,
                    r["threads"], r["dyn_smem"], r["registers"],
                    r["static_smem"], r["local_bytes"], r["blocks_per_sm"],
                    r["cluster"], r["max_clusters"])
                rows.append(fp)
                where = f"{launch.label} ({fp.part})"
                smem = fp.dyn_smem + fp.static_smem
                if fp.threads > r["max_threads_per_block"]:
                    findings.append(f"{where}: {fp.threads} threads > the "
                                    f"kernel's {r['max_threads_per_block']}")
                if smem > lim["smem_block_optin"]:
                    findings.append(f"{where}: {smem} B of shared memory > "
                                    f"{lim['smem_block_optin']}")
                regs = fp.registers * fp.threads
                if regs > min(REGS_PER_SM, lim["regs_sm"],
                              lim["regs_block"]):
                    findings.append(f"{where}: {regs} registers a block > "
                                    f"{min(REGS_PER_SM, lim['regs_block'])}")
                if fp.blocks_per_sm == 0:
                    findings.append(f"{where}: no block fits on an SM")
                if fp.cluster > MAX_CLUSTER:
                    findings.append(f"{where}: a cluster of {fp.cluster} "
                                    f"blocks > the portable {MAX_CLUSTER}")
                if r["grid_x"] % fp.cluster:
                    findings.append(f"{where}: grid x {r['grid_x']} is no "
                                    f"multiple of its cluster {fp.cluster}")
                if fp.cluster > 1 and fp.max_clusters < 1:
                    findings.append(f"{where}: no cluster of {fp.cluster} "
                                    f"blocks fits on the card "
                                    f"({fp.max_clusters})")
                if launch.kernel == "lora_expand" and launch.args["cols"]:
                    a = launch.args
                    want = bgmv.expand_plan(a["rows"], a["d_out"], sms,
                                            launch.dtype)
                    if (r["grid_x"], r["grid_y"], r["grid_z"]) != \
                            (want.grid, 1, 1):
                        findings.append(
                            f"{where}: grid {r['grid_x']} x {r['grid_y']} x "
                            f"{r['grid_z']}, not the persistent "
                            f"{want.grid} of expand_plan")
                if launch.kernel == "lora_shrink" and launch.args["tile"] \
                        and launch.args["per_tile"] == 0:
                    # the persistent shrink: the plan's grid, every
                    # cluster on the card at once (one wave)
                    a = launch.args
                    if (r["grid_x"], r["grid_y"], r["grid_z"]) != \
                            (a["grid"], 1, 1) or \
                            a["grid"] // a["split"] > fp.max_clusters > 0 \
                            or a["grid"] > fp.blocks_per_sm * lim["sms"]:
                        findings.append(
                            f"{where}: grid {r['grid_x']} x {r['grid_y']} x "
                            f"{r['grid_z']} in clusters of {fp.cluster}, not "
                            f"the plan's {a['grid']} in one wave "
                            f"({fp.max_clusters} clusters, "
                            f"{fp.blocks_per_sm} blocks an SM)")
                if launch.kernel == "flash_attention" and \
                        launch.dtype == torch.bfloat16:
                    a = launch.args
                    want = flash.persistent_grid(a["B"], a["H"], a["Lq"],
                                                 lim["sms"])
                    if (r["grid_x"], r["grid_y"], r["grid_z"]) != \
                            (want, 1, 1):
                        findings.append(
                            f"{where}: grid {r['grid_x']} x {r['grid_y']} x "
                            f"{r['grid_z']}, not the persistent {want} "
                            f"(min(work tiles, {lim['sms']} SMs))")
    if not log:
        findings.append("no ptxas report (build.build_log is empty), so "
                        "spills cannot be read")
    for name, (st, ld) in ptxas_spills(log).items():
        if (st or ld) and not any(k in name for k in ALLOWED_SPILLS):
            findings.append(f"{name}: spills {st} B stored / {ld} B loaded "
                            "with no recorded reason (ALLOWED_SPILLS)")
    return rows, lim, findings


def paged_rule_findings(lib) -> List[str]:
    """`paged.fits`, `paged.group_tiles` and `paged.route` (the CPU's
    copies) against `rt_paged_attention_fits`, `rt_paged_attention_tiles`
    and `rt_paged_attention_route` over every (G, hd) with G 0-160 and hd
    0-300, the route in bf16 and f32."""
    grid = [(G, hd) for G in range(0, 161) for hd in range(0, 301)]
    bad = [x for x in grid
           if bool(lib.rt_paged_attention_fits(*x)) != paged.fits(*x)]
    tiles = [x for x in grid if paged.fits(*x) and
             lib.rt_paged_attention_tiles(*x) != paged.group_tiles(*x)]
    routes = [(*x, str(dt).split(".")[-1]) for x in grid
              for dt in build.DTYPE_CODE
              if lib.rt_paged_attention_route(*x, build.DTYPE_CODE[dt])
              != paged.route(*x, dt)]
    return ([f"paged.fits disagrees with rt_paged_attention_fits at (G, hd) "
             f"in {bad[:8]}"] if bad else []) + \
        ([f"paged.group_tiles disagrees with rt_paged_attention_tiles at "
          f"(G, hd) in {tiles[:8]}"] if tiles else []) + \
        ([f"paged.route disagrees with rt_paged_attention_route at (G, hd, "
          f"dtype) in {routes[:8]}"] if routes else [])


# (Lq, Lk, causal, window, hd) of the flash walk check: one tile and
# many, Lq != Lk, windows inside a tile and straddling several, no
# visible key, both key tiles (128 up to hd 128, 64 at 256)
FLASH_ORDER_CASES = [
    (Lq, Lk, causal, window, hd)
    for Lq, Lk in ((1, 1), (127, 127), (129, 129), (512, 512),
                   (4096, 4096), (1000, 333), (300, 2000), (777, 0))
    for causal in (True, False)
    for window in (None, 1, 100, 128, 300, 2048)
    for hd in (128, 256)]


def flash_order_findings(lib) -> List[str]:
    """`flash.tile_order` (the CPU's copy of the bf16 kernel's walk over
    query tiles, heaviest first) against `rt_flash_attention_order`,
    which runs the kernel's own TileOrder on the host."""
    bad = []
    for Lq, Lk, causal, window, hd in FLASH_ORDER_CASES:
        n = -(-Lq // flash.BQ)
        out = (ctypes.c_int * n)()
        build.check_launch(lib.rt_flash_attention_order(
            Lq, Lk, hd, int(causal), window or 0, out),
            "rt_flash_attention_order")
        if list(out) != flash.tile_order(Lq, Lk, causal, window,
                                         flash.key_tile(hd)):
            bad.append((Lq, Lk, causal, window, hd))
    return [f"flash.tile_order disagrees with rt_flash_attention_order at "
            f"(Lq, Lk, causal, window, hd) in {bad[:8]}"] if bad else []


# ------------------------------------------------------------ canaries ----

class Guarded:
    """A tensor of `shape` inside a buffer with GUARD sentinel elements
    before and after it. With `row_pad`, each row of the last dim is
    followed by that many sentinel elements too (the tensor is then a
    strided view), so a write past a row's width is caught on every
    row."""

    def __init__(self, shape, dtype, device, row_pad=0):
        n = math.prod(shape[:-1]) * (shape[-1] + row_pad)
        self.dtype = dtype
        self.buf = torch.empty(2 * GUARD + n, dtype=dtype, device=device)
        rows = self.buf[GUARD:GUARD + n].view(*shape[:-1],
                                              shape[-1] + row_pad)
        self.t = rows[..., :shape[-1]]
        self.gaps = rows[..., shape[-1]:]

    def _sentinels(self):
        bits = self.buf.view(_BITS[self.dtype])
        return (bits[:GUARD], bits[-GUARD:],
                self.gaps.view(_BITS[self.dtype]))

    def fill(self, value: float) -> None:
        self.buf.fill_(value)
        for part in self._sentinels():
            part.fill_(SENTINEL_BITS[self.dtype])

    def guards_intact(self) -> bool:
        s = SENTINEL_BITS[self.dtype]
        return all(bool((part == s).all()) for part in self._sentinels())

    def bits(self) -> torch.Tensor:
        return self.t.reshape(-1).view(_BITS[self.dtype]).clone()


@dataclass
class Path:
    """One launch path of one kernel: `launch(ins, outs)` calls the C entry
    point on `ins` (tensors) into `outs` (Guarded) on the current stream;
    `poisoned` is `ins` with NaN in every region the launch must not
    read; `want` (where given) the plain version's outputs on `ins`,
    which the first run must match row by row (`rows_close`)."""
    name: str
    launch: Callable
    ins: dict
    poisoned: dict
    outs: Dict[str, Guarded]
    want: Dict[str, torch.Tensor] = None


def rows_close(got: torch.Tensor, want: torch.Tensor) -> bool:
    """chip_smoke's row rule: max |got - want| of each row within 1e-2 of
    the row's max |want| in bf16, within 1e-5 x max(1, it) in f32."""
    g, w = got.float(), want.float()
    err = (g - w).abs().flatten(1).amax(1)
    scale = w.abs().flatten(1).amax(1)
    lim = 1e-2 * scale if want.dtype == torch.bfloat16 \
        else 1e-5 * scale.clamp(min=1.0)
    return bool(torch.isfinite(g).all()) and bool((err <= lim).all())


def _run(path: Path, ins: dict, fill: float) -> Dict[str, torch.Tensor]:
    for g in path.outs.values():
        g.fill(fill)
    path.launch(ins, path.outs)
    torch.cuda.synchronize()
    return {k: g.bits() for k, g in path.outs.items()}


def _same(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


def check_path(path: Path, busy: Callable) -> List[str]:
    """The canary protocol on one path (module docstring); its findings."""
    found = []
    first = _run(path, path.ins, float("nan"))
    for k, w in (path.want or {}).items():
        if not rows_close(path.outs[k].t, w):
            found.append(f"{path.name}: {k} differs from the plain version")
    broke = [k for k, g in path.outs.items() if not g.guards_intact()]
    if broke:
        found.append(f"{path.name}: wrote past its output ({broke})")
    second = _run(path, path.ins, PATTERN)
    if not _same(first, second):
        found.append(f"{path.name}: left output elements unwritten (the "
                     "result depends on the fill)")
    for g in path.outs.values():
        g.fill(float("nan"))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        busy()
    path.launch(path.ins, path.outs)
    torch.cuda.synchronize()
    if not _same(first, {k: g.bits() for k, g in path.outs.items()}):
        found.append(f"{path.name}: differs when repeated beside a kernel "
                     "on a second stream")
    if not _same(first, _run(path, path.poisoned, float("nan"))):
        found.append(f"{path.name}: read a region it must not (NaN there "
                     "changed the result)")
    return found


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _nan_rows(t: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    t = t.clone()
    t[rows] = float("nan")
    return t


def lora_inputs(rows, d_in, d_out, r_max, ranks, rank_block, dtype, seg,
                seed=0):
    """Shrink and expand inputs with one slot more than the rows use (the
    poisoned one) and one row more than the launch takes (the '+1'
    mutant's), MBGMV live widths, idx -1 rows, and `pad` rows past the
    end; returns (clean, poisoned) dicts."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    slots = len(ranks) + 1
    pad = 8
    a = torch.zeros(slots, d_in, r_max, dtype=dtype, device="cuda")
    b = torch.zeros(slots, r_max, d_out, dtype=dtype, device="cuda")
    for s, r in enumerate(ranks):
        a[s, :, :r] = (torch.randn(d_in, r, generator=g, device="cuda")
                       * d_in ** -0.5).to(dtype)
        b[s, :r] = (torch.randn(r, d_out, generator=g, device="cuda")
                    * r ** -0.5).to(dtype)
    n = rows + 1 + pad
    x = torch.randn(n, d_in, generator=g, device="cuda").to(dtype)
    y = torch.randn(n, r_max, generator=g, device="cuda").to(dtype)
    ar = torch.arange(n, device="cuda")
    idx = (ar // seg % slots - 1).to(torch.int32)      # -1 and slots 0..S-2
    ranks_t = torch.tensor(list(ranks) + [r_max], dtype=torch.int32,
                           device="cuda")
    live = ref.mbgmv_live(idx, ranks_t, rank_block).clamp(max=r_max)
    live = live.to(torch.int32)
    clean = dict(x=x, y=y, a=a, b=b, idx=idx, live=live, rows=rows,
                 slots=slots)
    # poison: the unused slot, rows of idx -1 and past the end, and the
    # columns (A) / rank rows (B) past each slot's live width, 8-aligned
    pa, pb = a.clone(), b.clone()
    pa[-1] = float("nan")
    pb[-1] = float("nan")
    for s in range(slots - 1):
        w = -(-int(ref.mbgmv_live(torch.tensor([s]), ranks_t.cpu(),
                                  rank_block)) // 8) * 8
        pa[s, :, w:] = float("nan")
        pb[s, w:] = float("nan")
    dead = (idx < 0) | (ar >= rows + 1)
    clean["y32"] = y.float()              # the decode expand's f32 y
    poisoned = dict(clean, x=_nan_rows(x, dead), y=_nan_rows(y, dead),
                    y32=_nan_rows(clean["y32"], dead), a=pa, b=pb)
    return clean, poisoned


def shrink_plan(rows, d_in, slots, sms, r_max, dtype) -> bgmv.ShrinkPlan:
    """`bgmv.shrink_plan` as the wrapper makes it on this card (with the
    clusters it holds at once, `bgmv.cluster_room`)."""
    return bgmv.shrink_plan(rows, d_in, slots, sms, r_max, dtype,
                            bgmv.cluster_room(torch.device("cuda")))


def shrink_path(lib, name, ins, poisoned, plan, rows_told=None,
                split_told=None, d_in_told=None):
    rows, r_max = ins["rows"], ins["a"].shape[-1]
    told = rows if rows_told is None else rows_told
    split = plan.split if split_told is None else split_told
    d_in = ins["x"].shape[1] if d_in_told is None else d_in_told

    def launch(i, outs):
        rc = lib.rt_lora_shrink(
            i["x"].data_ptr(), i["a"].data_ptr(), i["idx"].data_ptr(),
            i["live"].data_ptr(), outs["y"].t.data_ptr(), told, d_in, r_max,
            i["slots"], plan.tile, plan.d_chunk, split, plan.grid,
            build.DTYPE_CODE[i["x"].dtype], _stream())
        build.check_launch(rc, name)

    want = ref.lora_shrink_ref(ins["x"][:rows], ins["a"], ins["idx"][:rows],
                               ins["live"][:rows])
    return Path(name, launch, ins, poisoned,
                {"y": Guarded((rows, r_max), torch.float32, "cuda")},
                {"y": want})


def expand_path(lib, name, ins, poisoned, plan, rows_told=None,
                y32=None):
    """`plan`: a `bgmv.ExpandPlan`. y32 (default: on the decode and the
    wgmma paths, as `ops.lora_delta` launches them): the expand takes the
    f32 y and rounds it as it loads it; the inputs' f32 y holds exactly
    their y in B's dtype. The wgmma kernel stores through a tensor map of
    the (told rows, d_out) output, so a launch told a row more writes it
    into the guard band."""
    rows, (_, r_max, d_out) = ins["rows"], ins["b"].shape
    told = rows if rows_told is None else rows_told
    f32_y = plan.grid == 0 or plan.cols > 0
    key = "y32" if (f32_y if y32 is None else y32) else "y"

    def launch(i, outs):
        rc = lib.rt_lora_expand(
            i[key].data_ptr(), i["b"].data_ptr(), i["idx"].data_ptr(),
            i["live"].data_ptr(), outs["out"].t.data_ptr(), told, r_max,
            d_out, i["slots"], plan.grid, plan.cols,
            build.DTYPE_CODE[i["b"].dtype], build.DTYPE_CODE[i[key].dtype],
            _stream())
        build.check_launch(rc, name)

    want = ref.lora_expand_ref(ins["y"][:rows], ins["b"], ins["idx"][:rows],
                               ins["live"][:rows])
    return Path(name, launch, ins, poisoned,
                {"out": Guarded((rows, d_out), ins["b"].dtype, "cuda")},
                {"out": want})


def lora_paths(lib, sms) -> List[Path]:
    """Every launch path of the shrink and the expand: split and row tiles
    of 64 and 128 (shrink), decode and row tiles with one rank pass and
    several (expand), bf16 and f32, at widths that are multiples of 8 and
    at tails that are not."""
    bf, f32 = torch.bfloat16, torch.float32
    out = []
    # (label, rows, d_in, d_out, r_max, ranks, rank_block, dtype, seg)
    cases = [("decode bf16", 8, 4096, 4096, 64, (64, 16, 33, 8), 16, bf, 1),
             # the decode kernels at their largest rows: runs of 17 rows a
             # slot (two 16-row tiles of a slot), and 4 column groups
             ("decode 64 rows runs of 17 bf16", 64, 1024, 1024, 64,
              (64, 16, 33, 8), 16, bf, 17),
             ("decode r_max 128 bf16", 8, 512, 1024, 128, (128, 16, 100, 8),
              16, bf, 1),
             ("decode 64 rows runs of 17 f32", 64, 256, 136, 24,
              (24, 3, 9, 1), 8, f32, 17),
             ("prefill bf16", 300, 1024, 1024, 64, (64, 16, 33, 8), 16, bf,
              17),
             ("prefill many tiles bf16", 128 * sms + 77, 512, 512, 64,
              (64, 16, 33, 8), 16, bf, 4096),
             # training's shape: one slot's rows (and idx -1) in tiles of
             # 64, each split over a cluster of 2
             ("train bf16", 4096, 4096, 4096, 64, (64,), 16, bf, 2048),
             ("prefill r_max 128 bf16", 300, 512, 1024, 128,
              (128, 16, 100, 8), 16, bf, 17),
             # the wgmma expand: the yi-9b chunk's one slot at d_out 512,
             # a column tile past d_out (136) and MBGMV rank blocks of 4
             # (live widths that end inside an 8-row group of B)
             ("chunk k/v bf16", 512, 1024, 512, 64, (64,), 16, bf, 256),
             ("prefill d_out 136 rank blocks of 4 bf16", 300, 256, 136, 24,
              (24, 3, 9, 1), 4, bf, 17),
             ("decode f32", 8, 256, 136, 24, (24, 3, 9, 1), 8, f32, 1),
             ("prefill f32", 300, 256, 136, 24, (24, 3, 9, 1), 8, f32, 17),
             # tails: d_in and d_out no multiple of 8 (element copies)
             *[(f"tail {kind} d_in 4100 d_out 1000 bf16", rows, 4100, 1000,
                64, (64, 16, 33, 8), 16, bf, seg)
               for kind, rows, seg in (("decode", 8, 1), ("prefill", 300,
                                                          17))],
             ("tail prefill d_in 130 d_out 131 f32", 300, 130, 131, 24,
              (24, 3, 9, 1), 8, f32, 17)]
    for label, rows, d_in, d_out, r_max, ranks, rb, dt, seg in cases:
        clean, pois = lora_inputs(rows, d_in, d_out, r_max, ranks, rb, dt,
                                  seg, seed=rows)
        sp = shrink_plan(rows, d_in, clean["slots"], sms, r_max, dt)
        kind = "decode" if sp.tile == 0 else f"tile {sp.tile} x{sp.split}"
        out.append(shrink_path(lib, f"lora_shrink[{kind}] {label}", clean,
                               pois, sp))
        ep = bgmv.expand_plan(rows, d_out, sms, dt)
        kind = ("decode" if ep.grid == 0 else
                f"wgmma tiles of {ep.cols}" if ep.cols else "row tiles") + \
            f" r_max {r_max}"
        f32_y = ep.grid == 0 or ep.cols > 0
        out.append(expand_path(lib, f"lora_expand[{kind}"
                               + (" f32 y" if f32_y else "") + f"] {label}",
                               clean, pois, ep))
        if f32_y:                          # y in B's dtype too
            out.append(expand_path(lib, f"lora_expand[{kind}] {label}",
                                   clean, pois, ep, y32=False))
    return out


def paged_path(lib, label, B, H, KV, hd, ps, W, P, dt, ctx, sms,
               rows_told=None) -> Path:
    """One paged launch at these shapes, with row b holding ctx[b] tokens:
    NaN in every page no row's table names. The inputs hold one row more
    than the launch takes (all its entries unclaimed: the '+1' mutant's),
    which `rows_told` may tell the launch to take."""
    f32 = torch.float32
    told = B if rows_told is None else rows_told
    g = torch.Generator(device="cuda").manual_seed(B * H + W)
    q = torch.randn(B + 1, H, hd, generator=g, device="cuda").to(dt)
    k = torch.randn(P, KV, ps, hd, generator=g, device="cuda").to(dt)
    v = torch.randn(P, KV, ps, hd, generator=g, device="cuda").to(dt)
    pp = torch.full((P, ps), -1, dtype=torch.int32)
    bt = torch.full((B + 1, W), -1, dtype=torch.int32)
    pos = torch.zeros(B + 1, dtype=torch.int32)
    free = list(range(P))
    for b_, n_tok in enumerate(ctx):
        for j in range(-(-n_tok // ps)):
            pg = free.pop((b_ * 7 + j * 3) % len(free))
            bt[b_, j] = pg
            pp[pg] = torch.where(torch.arange(ps) + j * ps < n_tok,
                                 torch.arange(ps) + j * ps, -1).int()
        pos[b_] = max(n_tok - 1, 0)
    owned = torch.zeros(P, dtype=torch.bool)
    owned[bt[bt >= 0].long()] = True
    ins = dict(q=q, k=k, v=v, pp=pp.cuda(), bt=bt.cuda(), pos=pos.cuda())
    foreign = ~owned.cuda()
    nan = float("nan")
    pois = dict(ins, k=torch.where(foreign[:, None, None, None], nan, k),
                v=torch.where(foreign[:, None, None, None], nan, v),
                pp=torch.where(foreign[:, None], 0, ins["pp"]))
    tiles = paged.launch_tiles(H // KV, hd, dt)
    nsplit = paged.split_plan(told, KV, W, sms, tiles)
    outs = {"out": Guarded((B, H, hd), dt, "cuda")}
    if nsplit > 1:
        outs["ws"] = Guarded((told * H * nsplit * (hd + 2),), f32, "cuda")

    def launch(i, o):
        rc = lib.rt_paged_attention(
            i["q"].data_ptr(), i["k"].data_ptr(), i["v"].data_ptr(),
            i["pp"].data_ptr(), i["bt"].data_ptr(), i["pos"].data_ptr(),
            o["out"].t.data_ptr(),
            o["ws"].t.data_ptr() if "ws" in o else None, told, H, KV, P,
            ps, hd, W, nsplit, build.DTYPE_CODE[i["q"].dtype], _stream())
        build.check_launch(rc, label)

    kind = "one split" if nsplit == 1 else f"{nsplit} splits + combine"
    if paged.route(H // KV, hd, dt) == 1:
        kind += ", group kernel"
    elif tiles > 1:
        kind += f", {tiles} group tiles"
    return Path(f"paged_attention[{kind}] {label}", launch, ins, pois, outs)


# (label, B, H, KV, hd, ps, W, P, dtype, tokens a row)
PAGED_CASES = [
    ("one split bf16", 8, 32, 32, 128, 32, 16, 140, torch.bfloat16,
     [0, 1, 500, 37, 256, 100, 31, 511]),
    ("splits bf16", 3, 12, 2, 128, 32, 96, 120, torch.bfloat16,
     [0, 2500, 9]),
    ("splits f32", 3, 8, 1, 64, 16, 160, 200, torch.float32, [2400, 0, 30]),
    ("one split f32", 4, 4, 2, 32, 8, 5, 24, torch.float32, [0, 1, 33, 40]),
    # MQA at G 32, hd 128 and G 71, hd 64 (the group kernel's 2 and 5 M
    # tiles) and head dims that are no multiple of 8 (element copies into
    # padded ring rows)
    ("MQA G 32 hd 128 bf16", 8, 32, 1, 128, 32, 16, 140, torch.bfloat16,
     [0, 1, 500, 37, 256, 100, 31, 511]),
    ("MQA G 71 hd 64 long rows bf16", 3, 71, 1, 64, 32, 96, 120,
     torch.bfloat16, [0, 2500, 9]),
    ("hd 100 GQA 2 bf16", 4, 8, 4, 100, 32, 8, 40, torch.bfloat16,
     [0, 1, 200, 77]),
    ("hd 12 GQA 4 splits f32", 3, 8, 2, 12, 8, 64, 100, torch.float32,
     [0, 500, 9]),
    # the lane kernel's group tiles with splits (f32 at MQA), and the
    # group kernel streaming pages larger than a ring stage in chunks
    ("MQA G 32 hd 128 splits f32", 3, 32, 1, 128, 32, 96, 120,
     torch.float32, [0, 2500, 9]),
    ("GQA 8 pages of 128 bf16", 3, 16, 2, 128, 128, 24, 40, torch.bfloat16,
     [0, 2500, 9]),
    ("GQA 4 hd 256 pages of 48 bf16", 3, 8, 2, 256, 48, 64, 80,
     torch.bfloat16, [0, 2500, 9]),
]


def paged_paths(lib, sms) -> List[Path]:
    """One split and many (with the combine), bf16 and f32, both kernels,
    group tiles, head dims no multiple of 8 and pages larger than the
    group kernel's ring stage: NaN in every page no row's table names."""
    return [paged_path(lib, *case, sms) for case in PAGED_CASES]


def flash_path(lib, dt, hd, causal, window, hd_told=None, B=2, H=4, KV=2,
               L=300) -> Path:
    """One flash launch at head dim `hd` (tensors of hd rounded up to 8
    columns, the pad zero, as the wrapper passes them): q / k / v views of
    buffers PAD rows longer a head and 16 columns wider a row, NaN in
    both margins; out a view whose rows are followed by sentinels, so a
    write past the tensors' columns is caught on every row (the bf16
    kernel writes out by TMA stores through a map of that view, which
    must clip rows at L and columns at the tensors' width). `hd_told` (a
    mutant) tells the launch another hd."""
    pad, wide = 40, 16
    cols = -(-hd // 8) * 8
    g = torch.Generator(device="cuda").manual_seed(hd)

    def mk(heads):
        full = torch.zeros(B, heads, L + pad, cols + wide, device="cuda",
                           dtype=dt)
        full[..., :hd] = torch.randn(B, heads, L + pad, hd, generator=g,
                                     device="cuda").to(dt)
        nan = full.clone()
        nan[:, :, L:] = float("nan")
        nan[..., cols:] = float("nan")
        return full[:, :, :L, :cols], nan[:, :, :L, :cols]

    (q, pq), (k, pk), (v, pv) = mk(H), mk(KV), mk(KV)
    ins, pois = dict(q=q, k=k, v=v), dict(q=pq, k=pk, v=pv)
    outs = {"out": Guarded((B, H, L, cols), dt, "cuda", row_pad=8)}
    told = hd if hd_told is None else hd_told

    def launch(i, o):
        t_out = o["out"].t
        strides = (ctypes.c_longlong * 12)(
            *i["q"].stride()[:3], *i["k"].stride()[:3],
            *i["v"].stride()[:3], *t_out.stride()[:3])
        rc = lib.rt_flash_attention(
            i["q"].data_ptr(), i["k"].data_ptr(), i["v"].data_ptr(),
            t_out.data_ptr(), strides, B, H, KV, L, L, told, int(causal),
            window or 0, build.DTYPE_CODE[i["q"].dtype], _stream())
        build.check_launch(rc, "flash_attention")

    kind = "bf16 wgmma" if dt == torch.bfloat16 else "f32"
    width = flash.padded_width(hd, dt)
    at = "" if width == hd else f" at {width}"
    mask = ("causal" if causal else "non-causal") + \
        (f" window {window}" if window else "")
    return Path(f"flash_attention[{kind}] hd {hd}{at} B {B} H {H} KV {KV} "
                f"L {L} {mask}", launch, ins, pois, outs)


def flash_paths(lib) -> List[Path]:
    """bf16 (wgmma + TMA) at hd 64 / 96 / 128 / 256 and at widths padded to
    them (80, 100), f32 (CUDA cores) at 64 / 128 and a padded 72; and the
    bf16 kernel's persistent walk: 512 and 256 work tiles over the SMs
    (each block takes several tiles of unequal weight, causal and under a
    non-causal window) and a single tile (a grid of one)."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = [(bf, hd, True, None) for hd in (64, 96, 128, 256, 80)]
    cases += [(bf, 100, True, 48), (f32, 64, True, 48),
              (f32, 128, False, None), (f32, 72, True, None)]
    walks = [dict(dt=bf, hd=128, causal=True, window=None, H=32, KV=8,
                  L=1000),
             dict(dt=bf, hd=64, causal=False, window=200, H=16, KV=4,
                  L=1000),
             dict(dt=bf, hd=256, causal=True, window=None, B=1, H=1, KV=1,
                  L=100)]
    return [flash_path(lib, *case) for case in cases] + \
        [flash_path(lib, **kw) for kw in walks]


def busy_kernel() -> Callable:
    a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    return lambda: a @ a


def canaries(lib, sms) -> Tuple[List[str], List[str]]:
    """Every launch path of the six TPU kernels' counterparts through the
    canary protocol. Returns (paths checked, findings)."""
    busy = busy_kernel()
    names, found = [], []
    for path in lora_paths(lib, sms) + paged_paths(lib, sms) + \
            flash_paths(lib):
        names.append(path.name)
        found += check_path(path, busy)
    return names, found


# ------------------------------------------------------------- mutants ----

def refused(run: Callable[[], List[str]]) -> List[str]:
    """run()'s findings, or the entry point's refusal as one."""
    try:
        return run()
    except RuntimeError as e:
        return [f"refused: {e}"]


def mutants(lib, sms) -> List[Tuple[str, List[str]]]:
    """Each mutant and what the checks found; a mutant with no finding
    means a check that does not fire."""
    busy = busy_kernel()
    out = []
    for label, rows, d_in, d_out, seg in (
            ("decode", 8, 1024, 1024, 1), ("prefill", 300, 1024, 512, 17),
            ("tail decode", 8, 4100, 1000, 1),
            ("tail prefill", 300, 4100, 1000, 17)):
        clean, pois = lora_inputs(rows, d_in, d_out, 64, (64, 16, 33, 8),
                                  16, torch.bfloat16, seg, seed=rows + 1)
        sp = shrink_plan(rows, d_in, clean["slots"], sms, 64,
                         torch.bfloat16)
        rb = bgmv.expand_plan(rows, d_out, sms, torch.bfloat16)
        for told, what in ((rows + 1, "one row more"),
                           (rows - 1, "one row fewer")):
            out.append((f"lora_shrink {label}: told {what}", check_path(
                shrink_path(lib, "shrink", clean, pois, sp, told), busy)))
            out.append((f"lora_expand {label}: told {what}", check_path(
                expand_path(lib, "expand", clean, pois, rb, told), busy)))
        # a row (of slot 0) pointed at the poisoned slot, with a live width
        bad = dict(pois, idx=pois["idx"].clone(), live=pois["live"].clone())
        row = int((clean["idx"][:rows] == 0).nonzero()[0])
        bad["idx"][row] = clean["slots"] - 1
        bad["live"][row] = 16
        out.append((f"lora_shrink {label}: idx at the poisoned slot",
                    check_path(shrink_path(lib, "shrink", clean, bad, sp),
                               busy)))
        if sp.split > 1:
            # a split told half its blocks: its slices miss half of d_in,
            # which the entry point refuses; told d_in 64 short, its
            # slices miss d_in's last box, which the plain version sees
            out.append((f"lora_shrink {label}: told split {sp.split // 2} "
                        f"of {sp.split}", refused(lambda: check_path(
                            shrink_path(lib, "shrink", clean, pois, sp,
                                        split_told=sp.split // 2), busy))))
            out.append((f"lora_shrink {label}: told d_in {d_in - 64}",
                        check_path(shrink_path(
                            lib, "shrink", clean, pois, sp,
                            d_in_told=d_in - 64), busy)))
        out.append((f"lora_expand {label}: idx at the poisoned slot",
                    check_path(expand_path(lib, "expand", clean, bad, rb),
                               busy)))
    # group tiles: a launch told one row more writes past its output, one
    # row fewer leaves a row unwritten
    mqa = PAGED_CASES[4]
    for told, what in ((mqa[1] + 1, "one row more"),
                       (mqa[1] - 1, "one row fewer")):
        out.append((f"paged_attention {mqa[0]}: told {what}", check_path(
            paged_path(lib, *mqa, sms, rows_told=told), busy)))
    # a padded width told 8 columns more reads the NaN margin and writes
    # past the tensors' columns
    out.append(("flash_attention hd 80: told hd 88", check_path(
        flash_path(lib, torch.bfloat16, 80, True, None, hd_told=88), busy)))
    return out
