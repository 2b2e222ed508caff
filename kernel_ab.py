#!/usr/bin/env python3
"""Time the port's kernels at shipped shapes in two trees on one card.

    git archive <parent> src | tar -x -C build/parent
    python3 kernel_ab.py build/parent

runs the timing in the order parent, this tree, this tree, parent, each
in a process of its own that imports that tree's `repro_torch` (each
tree builds its kernels into `<tree>/build/repro_torch`), and prints one
`AB <tree> {...}` JSON line a run: microseconds a launch (CUDA events,
the L2 flushed before each launch) of flash attention at yi-9b's 8 x
4,096 prefill, at 8 x 512 (hd 128), at 4 x 256 (hd 96) and at 4 x 256
(hd 256, 10 heads over 1, window 2,048), of paged attention at
llama2-7b's decode (8 rows, 32 x 32 heads, 16 pages of 32; also in a
CUDA graph) and at the four GQA decode shapes of `GQA_SHAPES` (yi-9b's
long row: 32 heads over 4, 116 pages in one row; mistral-large's 96
over 8, 6 pages; MQA 32 over 1 at hd 128, 38 pages over 8 rows; 71 over
1 at hd 64, 41 pages) and the loaded batches of `LOADED_SHAPES` (yi-9b
64 rows x 2,048 tokens, mistral-large 32 x 1,024, dbrx's G 6 at 8 x
4,096, groups of 4 and 2 at 32 x 2,048 and 8 x 300, yi-9b at pages of
128, G 8 at hd 256 and pages of 64), each per launch and in a CUDA
graph, with SDPA over the gathered, group-repeated K/V in a graph
beside, and of the
LoRA shrink and expand (d 4,096, r_max 64) at 8 rows, at the training
step's 4,096 rows of one slot, at the yi-9b chunk's 512 rows of one slot
of 8 (the shrink), at the yi-9b prefill's 32,768 rows (8 slots) and at
2,048 and 4,096 rows in runs of 32 over 8 slots (tiles of several slots:
a packed prefill of short prompts). `--tree ROOT` runs one tree.

    python3 kernel_ab.py --paged-probe

splits, in this tree, paged attention's time at the GQA shapes: the
wrapper in a graph with L2 flushed and warm, each kernel's device time
from a profiled replay (the attention kernel and the combine), the
attention kernel alone with one split, and both at 1, 4 and 16 claimed
pages in every row; SDPA in a graph beside.

    python3 kernel_ab.py --paged-loaded

times, in this tree, the group kernel at the loaded batches of
`LOADED_SHAPES` under forced split counts (1 to 16), beside a gather of
the claimed pages, a flat copy of as many bytes and the bound
(`paged_bound_us`).

    python3 kernel_ab.py --flash build/parent [OTHER_TREE ...]

times bf16 flash attention at the shapes of `FLASH_SHAPES` in CUDA
graphs (20 launches a graph, each after an L2 flush, less the flushes
alone), the trees in the order parent, this tree, the others, then the
same backwards (parent, change, change, parent with no other tree), each
in a process of its own; every run prints one `FLASH <tree> {...}` line
with each row's graph microseconds, SDPA's over K/V repeated across the
GQA group in a graph (timed only: the port never calls it), the row's
bound (`flash_bound_us`) and the bf16 kernel's registers and spills from
that tree's ptxas report.

    python3 kernel_ab.py --lora build/parent [OTHER_TREE ...]

times the decode LoRA pair in CUDA graphs (20 launches a graph, each
after an L2 flush, less the flushes alone: `graph_us`), the trees in the
order parent, this tree, the others, then the same backwards, each in a
process of its own; every run prints one `LORA <tree> {...}` line. Rows
(`lora_tree`): 1, 8, 32 and 64 rows (`LORA_ROWS`) at d_in = d_out 4,096
and the 4,100 tail, a pool of 8 slots of ranks 8/16/32/64 (r_max 64),
row r at slot r % 8 (rows share slots past 8) and the last row of a
batch without an adapter, under BGMV and MBGMV live widths: the shrink,
the expand of y in the pool's dtype, the expand of the shrink's f32 y
(the launch the model makes; null in a tree whose expand refuses f32
y), and the pair as the model calls it (`ops.lora_delta`), with
torch.bmm over the gathered pools in a graph (timed only: the port
never calls it) and the bytes bound (`lora_bound_us`) beside. At d 4,096
and 8 and 64 rows the same again for two other batches (`LORA_PATTERNS`):
row 0 idle too ("idle first": a finished request's row waiting to be
refilled) and slots drawn with weights 1 / (s + 1) ("zipf": skewed
adapter popularity, rows sharing slots at any batch size).

    python3 kernel_ab.py --lora-probe

splits, in this tree, the decode pair's time into fixed cost, barriers
and bytes, each figure in a graph after L2 flushes and with L2 warm: an
empty kernel with and without programmatic dependent launch (and the
programmatic edges its capture holds) and at 128 blocks in clusters of
1 to 8 that pass two cluster barriers; a read and a copy of the A pool's
4 MiB; the shrink and the expand at 1, 8 and 64 rows with every adapted
row's live width 8 and 64 (the expand also on the shrink's f32 y), with
torch.bmm beside; each kernel's device time from a profiled replay; the
bf16 row-tile shrink launched directly at those rows; and the decode
shrink at splits 1, 2, 4 and 8 (`decode_direct`).

    python3 kernel_ab.py --expand build/parent [OTHER_TREE ...]

times the row-tile expand (more than 64 rows) at the rows of
`EXPAND_SHAPES` in CUDA graphs (20 launches a graph, each after an L2
flush, less the flushes alone), the trees built in parallel first, then
timed in the order parent, this tree, the others, then the same
backwards, each in a process of its own; every run prints one `EXPAND
<tree> {...}` line (`expand_tree`): the training step's 4,096 rows of
one slot, the yi-9b chunk's 512 rows of one slot of 8 at d_out 4,096 (q)
and 512 (k / v), the yi-9b prefill's 32,768 rows (8 slots), 2,048 and
4,096 rows in runs of 32 over 8 slots, 8 slots of ranks 8/16/32/64 under
BGMV and MBGMV, r_max 128, a partial tile (4,133 rows), f32 and d_out
4,100; each the expand of y in B's dtype and of the shrink's f32 y (the
launch the model makes), with torch.matmul in a graph and the bytes bound
(`expand_bound_us`) beside.

    python3 kernel_ab.py --expand-probe

times, in this tree, how fast the card takes the one-slot expand's
output stream (`expand_probe`): the expand at the training shape, a
store-only kernel writing the same 33.5 MB from shared memory by
16-byte st.global and by TMA stores at one and two blocks an SM
(`rt_store_probe`), torch.matmul, a fill of the output and an empty
kernel, each in a graph after L2 flushes and with L2 warm.

    python3 kernel_ab.py --shrink build/parent [OTHER_TREE ...]

times the row-tile shrink (more than 64 rows) at the rows of
`SHRINK_SHAPES` in CUDA graphs (20 launches a graph, each after an L2
flush, less the flushes alone), the trees built in parallel first, then
timed in the order parent, this tree, the others, then the same
backwards, each in a process of its own; every run prints one `SHRINK
<tree> {...}` line (`shrink_tree`): the training step's 4,096 rows of
one slot, the yi-9b chunk's 512 rows of one slot of 8, the yi-9b
prefill's 32,768 rows (8 slots in runs of 4,096), 2,048 and 4,096 rows
in runs of 32 over 8 slots, 8 slots of ranks 8/16/32/64 in runs of 512
under BGMV and MBGMV, r_max 128, a partial tile (4,133 rows), and the
cp.async kernel's f32 and d_in 4,100 as controls; torch.matmul in a
graph and the bytes bound (`shrink_bound_us`) beside.

    python3 kernel_ab.py --shrink-probe

splits, in this tree, the row-tile shrink's time (`shrink_probe`) at the
training, chunk and prefill shapes: the shrink beside a load-only TMA
stream of x (`rt_load_probe`) at 132 / 264 blocks and 4-24 boxes in
flight and torch.matmul; then, from a build with -DLORA_SHRINK_STAMPS,
the microseconds a block spends in each phase of the persistent kernel
(waits for loads, products, the cluster's barrier and reduction).

    python3 kernel_ab.py --sweep

times, in this tree, the persistent shrink at the training, chunk and
prefill shapes under every split, with the clusters the card holds at
once (and fewer at the training shape), beside the plan's choice and
matmul, and asks the CUDA profiler (CUPTI) for the LoRA pair's counters
(its trace goes to build/kernel_ab_cupti.json). Needs one NVIDIA card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path


def time_tree(root: str) -> dict:
    sys.path.insert(0, str(Path(root) / "src"))
    import torch
    from repro_torch.kernels import bgmv, build, flash, paged
    build.library()
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")

    def us(fn, n=20, warm=3):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(n):
            flush_buf.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            total += s.elapsed_time(e)
        return 1e3 * total / n

    g = torch.Generator(device="cuda").manual_seed(0)

    def views(B, L, n, hd):
        return torch.randn(B, L, n, hd, generator=g,
                           device="cuda").bfloat16().transpose(1, 2)

    def fl(B, H, KV, L, hd, window=None, n=20):
        q, k, v = views(B, L, H, hd), views(B, L, KV, hd), views(B, L, KV, hd)
        return us(lambda: flash.flash_attention(q, k, v, window=window), n=n)

    out = {"flash yi-9b 8x4096 hd128 us": fl(8, 32, 4, 4096, 128, n=10),
           "flash 8x512 hd128 us": fl(8, 32, 32, 512, 128),
           "flash 4x256 hd96 us": fl(4, 32, 32, 256, 96),
           "flash 4x256 hd256 w2048 us": fl(4, 10, 1, 256, 256, 2048)}
    B, H, KV, hd, ps, W, P = 8, 32, 32, 128, 32, 16, 200
    q = torch.randn(B, H, hd, generator=g, device="cuda").bfloat16()
    k = torch.randn(P, KV, ps, hd, generator=g, device="cuda").bfloat16()
    v = torch.randn(P, KV, ps, hd, generator=g, device="cuda").bfloat16()
    bt = torch.arange(B * W, device="cuda", dtype=torch.int32).reshape(B, W)
    pp = (torch.arange(P * ps, device="cuda", dtype=torch.int32)
          .reshape(P, ps) % (W * ps))
    pos = torch.full((B,), 300, device="cuda", dtype=torch.int32)
    out["paged llama2-7b us"] = us(
        lambda: paged.paged_attention(q, k, v, pp, bt, pos), n=100)
    out["paged llama2-7b graph us"] = graph_us(
        torch, lambda: paged.paged_attention(q, k, v, pp, bt, pos),
        flush_buf.zero_)
    # the GQA decode rows (GQA_SHAPES): the wrapper in a graph and per
    # launch, SDPA over the gathered, group-repeated K/V in a graph
    for name, (B, H, KV, hd, ps, W, ctx) in {**GQA_SHAPES,
                                              **LOADED_SHAPES}.items():
        args = paged_args(torch, B, H, KV, hd, ps, W, ctx)
        call = (lambda a: lambda: paged.paged_attention(*a))(args)
        out[f"paged {name} graph us"] = graph_us(torch, call,
                                                 flush_buf.zero_)
        out[f"paged {name} us"] = us(call, n=50)
        out[f"sdpa {name} graph us"] = graph_us(
            torch, sdpa_call(torch, args), flush_buf.zero_)
        del args, call
        torch.cuda.empty_cache()
    x = torch.randn(8, 4096, generator=g, device="cuda").bfloat16()
    a = torch.randn(8, 4096, 64, generator=g, device="cuda").bfloat16()
    b = torch.randn(8, 64, 4096, generator=g, device="cuda").bfloat16()
    idx = torch.arange(8, device="cuda", dtype=torch.int32)
    live = torch.full((8,), 64, device="cuda", dtype=torch.int32)
    y = bgmv.lora_shrink(x, a, idx, live).bfloat16()
    out["shrink decode us"] = us(lambda: bgmv.lora_shrink(x, a, idx, live),
                                 n=100)
    out["expand decode us"] = us(lambda: bgmv.lora_expand(y, b, idx, live),
                                 n=100)
    # the row tiles: training (4,096 rows of one slot), the yi-9b chunk
    # (512 rows of one slot of 8) and the yi-9b prefill (8 slots, 4,096
    # rows each)
    for label, rows, slots, run, pair in (("train", 4096, 1, 4096, True),
                                          ("chunk", 512, 8, 512, False),
                                          ("prefill", 32768, 8, 4096, True),
                                          ("mixed 2048", 2048, 8, 32, True),
                                          ("mixed 4096", 4096, 8, 32, True)):
        x = torch.randn(rows, 4096, generator=g, device="cuda").bfloat16()
        a = (torch.randn(slots, 4096, 64, generator=g, device="cuda")
             / 64).bfloat16()
        b = (torch.randn(slots, 64, 4096, generator=g, device="cuda")
             / 8).bfloat16()
        idx = (torch.arange(rows, device="cuda") // run % slots).to(
            torch.int32)
        if slots > 1 and not pair:
            idx.fill_(slots - 1)
        live = torch.full((rows,), 64, device="cuda", dtype=torch.int32)
        out[f"shrink {label} us"] = us(
            lambda: bgmv.lora_shrink(x, a, idx, live), n=50)
        if pair:
            y = bgmv.lora_shrink(x, a, idx, live).bfloat16()
            out[f"expand {label} us"] = us(
                lambda: bgmv.lora_expand(y, b, idx, live), n=50)
        del x, a, b
    return out


def capture(torch, body, n):
    """A CUDA graph of n calls of body (the garbage collector off while
    capturing: a graph destroyed mid-capture voids it), replayed once."""
    import gc
    body()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    gc.collect()
    gc.disable()
    try:
        with torch.cuda.graph(g):
            for _ in range(n):
                body()
    finally:
        gc.enable()
    g.replay()
    torch.cuda.synchronize()
    return g


def graph_us(torch, fn, flush, n=20, reps=5):
    """Microseconds a launch of fn in a CUDA graph: n launches, each after
    an L2 flush, replayed `reps` times, less a graph of the flushes alone
    (chip_smoke.graph_ms). With `flush` None: n launches back to back, L2
    warm."""
    per = []
    bodies = (fn,) if flush is None else ((lambda: (flush(), fn())), flush)
    for body in bodies:
        g = capture(torch, body, n)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            g.replay()
        e.record()
        e.synchronize()
        per.append(1e3 * s.elapsed_time(e) / (reps * n))
        del g
    return per[0] - (per[1] if len(per) > 1 else 0.0)


def kernel_us(torch, fn, flush, n=20):
    """Device microseconds by kernel name a call of fn, each call after an
    L2 flush, from one replay of a CUDA graph of n calls under
    torch.profiler (the flush's own kernel listed too)."""
    from torch.profiler import ProfilerActivity, profile
    g = capture(torch, lambda: (flush(), fn()), n)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        g.replay()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0 and "CUDA" in str(ev.device_type):
            out[ev.key[:72]] = us / n
    return out or "the profiler's trace holds no device time"


# GQA decode shapes as run 99 of chip_smoke.py served them (PERF.md §6):
# (B, H, KV, hd, ps, W, tokens of each row); page ids drawn at random.
# yi-9b's first decode step holds one row at pos >= 2,048 (116 pages).
GQA_SHAPES = {
    "yi-9b": (8, 32, 4, 128, 32, 128, [3684] + [0] * 7),
    "mistral-large": (8, 96, 8, 128, 32, 16, [183] + [0] * 7),
    "MQA G 32 hd 128": (8, 32, 1, 128, 32, 16,
                        [246, 224, 160, 128, 120, 96, 97, 80]),
    "G 71 hd 64": (8, 71, 1, 64, 32, 16,
                   [246, 224, 192, 160, 128, 112, 97, 73]),
}


# Decode batches that fill the card (B x KV blocks past the SM count, so
# one split where the rows are equal), the groups of 2 and 4 no served
# config has, and pages larger than the group kernel's 32-slot ring
# stage: (B, H, KV, hd, ps, W, tokens of each row).
LOADED_SHAPES = {
    "yi-9b 64 x 2,048": (64, 32, 4, 128, 32, 64, [2048] * 64),
    "mistral-large 32 x 1,024": (32, 96, 8, 128, 32, 32, [1024] * 32),
    "dbrx G 6 8 x 4,096": (8, 48, 8, 128, 32, 128, [4096] * 8),
    "G 4 32 x 2,048": (32, 32, 8, 128, 32, 64, [2048] * 32),
    "G 2 32 x 2,048": (32, 16, 8, 128, 32, 64, [2048] * 32),
    "G 4 8 x 300": (8, 32, 8, 128, 32, 16, [300] * 8),
    "G 2 8 x 300": (8, 16, 8, 128, 32, 16, [300] * 8),
    "yi-9b ps 128 64 x 2,048": (64, 32, 4, 128, 128, 16, [2048] * 64),
    "G 8 hd 256 ps 64 16 x 2,048": (16, 32, 4, 256, 64, 32, [2048] * 16),
}


def paged_bound_us(B, H, KV, hd, ps, W, ctx, esz=2):
    """Microseconds the card needs at least for a paged launch at this
    shape: every claimed page's K, V and positions, q, out, the block
    table and pos moved once at the H100 data sheet's 3.35 TB/s."""
    pages = sum(-(-c // ps) for c in ctx)
    nbytes = (2 * pages * KV * ps * hd * esz + 4 * pages * ps
              + 2 * B * H * hd * esz + 4 * B * W + 4 * B)
    return 1e6 * nbytes / 3.35e12


def paged_args(torch, B, H, KV, hd, ps, W, ctx, seed=0):
    """Seeded paged-attention arguments: row b holds ctx[b] tokens in
    pages drawn at random from a pool of the pages claimed + 4."""
    import numpy as np
    rng = np.random.default_rng(seed)
    need = [-(-c // ps) for c in ctx]
    P = sum(need) + 4
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, H, hd, generator=g, device="cuda").bfloat16()
    k = torch.randn(P, KV, ps, hd, generator=g, device="cuda").bfloat16()
    v = torch.randn(P, KV, ps, hd, generator=g, device="cuda").bfloat16()
    pp = torch.full((P, ps), -1, dtype=torch.int32)
    bt = torch.full((B, W), -1, dtype=torch.int32)
    free = [int(x) for x in rng.permutation(P)]
    for b, n_tok in enumerate(ctx):
        for j in range(need[b]):
            pg = free.pop()
            bt[b, j] = pg
            filled = torch.arange(ps) + j * ps
            pp[pg] = torch.where(filled < n_tok, filled, -1).int()
    pos = torch.tensor([max(c - 1, 0) for c in ctx], dtype=torch.int32)
    return [q, k, v, pp.cuda(), bt.cuda(), pos.cuda()]


def sdpa_call(torch, args):
    """SDPA over each row's gathered pages with K/V repeated across the
    GQA group (the library yardstick, as chip_smoke.paged_row times it)."""
    import torch.nn.functional as F
    q, k, v, pp, bt, pos = args
    B, H, hd = q.shape
    P, KV, ps, _ = k.shape
    safe = bt.clamp(min=0).long()
    kd = k[safe].permute(0, 2, 1, 3, 4).reshape(B, KV, -1, hd)
    vd = v[safe].permute(0, 2, 1, 3, 4).reshape(B, KV, -1, hd)
    kd = kd.repeat_interleave(H // KV, dim=1)
    vd = vd.repeat_interleave(H // KV, dim=1)
    kp = torch.where(bt[:, :, None] >= 0, pp[safe], -1).reshape(B, -1)
    mask = ((kp >= 0) & (kp <= pos[:, None]))[:, None, None, :]
    qs = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(qs, kd, vd,
                                                  attn_mask=mask)


def paged_direct(torch, lib, build, args, nsplit):
    """rt_paged_attention at a given split count, outputs allocated once;
    the stream is read inside the call, so a capture records the launch."""
    q, k, v, pp, bt, pos = args
    B, H, hd = q.shape
    P, KV, ps, _ = k.shape
    W = bt.shape[1]
    out = torch.empty_like(q)
    ws = torch.empty(max(1, B * H * nsplit * (hd + 2)), device="cuda")

    def call():
        rc = lib.rt_paged_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pp.data_ptr(),
            bt.data_ptr(), pos.data_ptr(), out.data_ptr(), ws.data_ptr(),
            B, H, KV, P, ps, hd, W, nsplit, build.DTYPE_CODE[q.dtype],
            build.stream_handle(q.device))
        assert rc == 0, rc
    return call


def paged_probe() -> dict:
    """Where paged attention's time goes at the GQA shapes (GQA_SHAPES),
    in this tree, each figure in a CUDA graph after an L2 flush: the
    wrapper as shipped (attention and, with splits, the combine), the
    same with L2 warm and no flush, the device time of each kernel from
    a profiled replay, the attention kernel alone with one split, and
    the same at 1, 4 and 16 claimed pages in every row; SDPA beside."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch
    from repro_torch.kernels import build, paged
    from repro_torch.kernels.bgmv import sm_count
    lib = build.library()
    sms = sm_count(torch.device("cuda"))
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                        device="cuda").zero_
    res = {}
    for name, (B, H, KV, hd, ps, W, ctx) in GQA_SHAPES.items():
        tiles = paged.group_tiles(H // KV, hd)
        args = paged_args(torch, B, H, KV, hd, ps, W, ctx)
        wrap = (lambda a: lambda: paged.paged_attention(*a))(args)
        r = {"splits": paged.split_plan(B, KV, W, sms, tiles),
             "group_tiles": tiles,
             "graph_us": graph_us(torch, wrap, flush),
             "graph_us_warm": graph_us(torch, wrap, None),
             "kernels_us": kernel_us(torch, wrap, flush),
             "one_split_graph_us": graph_us(
                 torch, paged_direct(torch, lib, build, args, 1), flush),
             "sdpa_graph_us": graph_us(torch, sdpa_call(torch, args),
                                       flush)}
        for n in (1, 4, 16):
            if n > W:
                continue
            a = paged_args(torch, B, H, KV, hd, ps, W, [n * ps] * B)
            r[f"{n} pages a row"] = {
                "splits": paged.split_plan(B, KV, W, sms, tiles),
                "graph_us": graph_us(
                    torch, (lambda a: lambda: paged.paged_attention(*a))(a),
                    flush),
                "one_split_graph_us": graph_us(
                    torch, paged_direct(torch, lib, build, a, 1), flush)}
        res[name] = r
        print("PROBE", name, json.dumps(r), flush=True)
    return res


def paged_loaded() -> dict:
    """The loaded decode batches (LOADED_SHAPES), in this tree, each in a
    CUDA graph after an L2 flush: the kernel at forced split counts (the
    shipped count beside), and the same K/V bytes read without attention:
    the claimed pages gathered (`index_select`, which writes them too) and
    a flat copy of as many bytes (half read, half written)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch
    from repro_torch.kernels import build, paged
    from repro_torch.kernels.bgmv import sm_count
    lib = build.library()
    sms = sm_count(torch.device("cuda"))
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                        device="cuda").zero_
    res = {}
    for name, (B, H, KV, hd, ps, W, ctx) in LOADED_SHAPES.items():
        args = paged_args(torch, B, H, KV, hd, ps, W, ctx)
        k, v, bt = args[1], args[2], args[4]
        idx = bt[bt >= 0].long()
        kv_bytes = 2 * idx.numel() * k[0].numel() * k.element_size()
        r = {"shipped_splits": paged.split_plan(B, KV, W, sms, 1),
             "kv_bytes": kv_bytes,
             "bound_us": paged_bound_us(B, H, KV, hd, ps, W, ctx)}
        for n in (1, 2, 3, 4, 8, 16):
            if n <= W:
                r[f"{n} splits graph_us"] = graph_us(
                    torch, paged_direct(torch, lib, build, args, n), flush)
        ko = torch.empty((idx.numel(),) + tuple(k.shape[1:]),
                         dtype=k.dtype, device="cuda")
        vo = torch.empty_like(ko)
        r["gather graph_us"] = graph_us(
            torch, lambda: (torch.index_select(k, 0, idx, out=ko),
                            torch.index_select(v, 0, idx, out=vo)), flush)
        src = torch.empty(kv_bytes // 2, dtype=torch.uint8, device="cuda")
        dst = torch.empty_like(src)
        r["flat copy graph_us"] = graph_us(torch, lambda: dst.copy_(src),
                                           flush)
        res[name] = r
        print("LOADED", name, json.dumps(r), flush=True)
        del args, k, v, ko, vo, src, dst
        torch.cuda.empty_cache()
    return res


# bf16 flash rows of --flash: (B, H, KV, L, hd, window), causal, the
# (B, L, H, hd) tensors passed as (B, H, L, hd) views as the model does
FLASH_SHAPES = {
    "yi-9b 8 x 4,096 GQA 8 hd 128": (8, 32, 4, 4096, 128, None),
    "8 x 512 hd 128 (training, llama2-7b largest buckets)":
        (8, 32, 32, 512, 128, None),
    "llama2-7b 8 x 256 hd 128 (P4)": (8, 32, 32, 256, 128, None),
    "K2 8 x 256 hd 80 (at width 96)": (8, 32, 32, 256, 80, None),
    "4 x 256 hd 96": (4, 32, 32, 256, 96, None),
    "4 x 256 hd 256 MQA 10 window 2,048": (4, 10, 1, 256, 256, 2048),
}


def flash_bound_us(B, H, KV, L, hd, window=None):
    """Microseconds the card needs at least for a causal flash launch:
    max(q, k, v read and out written once at 3.35 TB/s, 4 B H hd x the
    causal (query, key) pairs inside the window at 989 TFLOP/s)."""
    pairs = sum(min(i + 1, window or L) for i in range(L))
    nbytes = 2 * (2 * B * H * L * hd + 2 * B * KV * L * hd)
    return 1e6 * max(nbytes / 3.35e12, 4 * B * H * hd * pairs / 989e12)


def flash_ptxas(log: str) -> dict:
    """Registers and spill bytes (stored / loaded) of each bf16 flash
    kernel in a ptxas report, and ptxas's performance advisories on them
    (wgmma serialized, and why)."""
    import re
    out, name, spill = {}, None, ""
    for line in log.splitlines():
        m = re.search(r"flash_bf16_kernelILi(\d+)E", line)
        if m and "Performance Loss" in line:
            why = line.split("Performance Loss:", 1)[1].split(" in the func")
            out.setdefault(f"flash_bf16<{m.group(1)}> advisories",
                           []).append(why[0].strip())
            continue
        m = re.search(r"Compiling entry function '\S*flash_bf16_kernelILi"
                      r"(\d+)E", line)
        if m:
            name = f"flash_bf16<{m.group(1)}>"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = f"{m.group(1)} registers, spills {spill} B"
            name, spill = None, ""
    return out


def flash_tree(root: str) -> dict:
    """--flash's run in one tree (see the module docstring)."""
    sys.path.insert(0, str(Path(root) / "src"))
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build, flash
    build.library()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                        device="cuda").zero_
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"ptxas": flash_ptxas(build.build_log)}
    for name, (B, H, KV, L, hd, window) in FLASH_SHAPES.items():
        q, k, v = (torch.randn(B, L, n, hd, generator=g, device="cuda")
                   .bfloat16().transpose(1, 2) for n in (H, KV, KV))
        kr = k.repeat_interleave(H // KV, dim=1)
        vr = v.repeat_interleave(H // KV, dim=1)
        kern = (lambda q, k, v, w: lambda: flash.flash_attention(
            q, k, v, window=w))(q, k, v, window)
        # the window (2,048) is past L (256): causal alone masks the same
        lib = (lambda q, k, v: lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True))(q, kr, vr)
        out[name] = {"graph_us": graph_us(torch, kern, flush),
                     "sdpa_graph_us": graph_us(torch, lib, flush),
                     "bound_us": flash_bound_us(B, H, KV, L, hd, window)}
        del q, k, v, kr, vr, kern, lib
        torch.cuda.empty_cache()
    return out


# The decode LoRA rows of --lora and --lora-probe: d_in = d_out = 4,096 (and
# the 4,100 tail), r_max 64, a pool of 8 slots of ranks 8/16/32/64 (two
# each, zero past each rank), rows of 1 to 64 (rows share slots past 8)
LORA_RANKS = (8, 16, 32, 64, 8, 16, 32, 64)
LORA_ROWS = (1, 8, 32, 64)
LORA_R_MAX = 64
# the other batches of --lora (lora_case's `pattern`), at d 4,096
LORA_PATTERNS = ("idle first", "zipf")
LORA_PATTERN_ROWS = (8, 64)


def lora_case(torch, rows, d, seed=0, pattern="round"):
    """Seeded decode LoRA inputs at width d: x (rows, d), the A and B pools,
    idx and the pool's ranks. idx: row r takes slot r % 8 ("round"), or
    the same with row 0 idle as well ("idle first"), or slots drawn with
    weights 1 / (s + 1) ("zipf"); the last row of a batch of more than
    one has no adapter."""
    g = torch.Generator(device="cuda").manual_seed(seed + rows + d)
    n = len(LORA_RANKS)
    a = torch.zeros(n, d, LORA_R_MAX, device="cuda")
    b = torch.zeros(n, LORA_R_MAX, d, device="cuda")
    for s, r in enumerate(LORA_RANKS):
        a[s, :, :r] = torch.randn(d, r, generator=g, device="cuda") * d ** -.5
        b[s, :r] = torch.randn(r, d, generator=g, device="cuda") * r ** -.5
    x = torch.randn(rows, d, generator=g, device="cuda").bfloat16()
    if pattern == "zipf":
        w = 1.0 / torch.arange(1, n + 1, device="cuda", dtype=torch.float32)
        idx = torch.multinomial(w, rows, replacement=True,
                                generator=g).to(torch.int32)
    else:
        idx = torch.arange(rows, device="cuda", dtype=torch.int32) % n
        if pattern == "idle first":
            idx[0] = -1
    if rows > 1:
        idx[-1] = -1
    ranks = torch.tensor(LORA_RANKS, dtype=torch.int32, device="cuda")
    return x, a.bfloat16(), b.bfloat16(), idx, ranks


def lora_bound_us(x, a, b, idx, live):
    """Microseconds the card needs at least for the decode shrink and the
    expand at these inputs: x and each distinct slot's live columns of A
    read once, y (f32) written once; y (in x's dtype) and the live rank
    rows of B read once, out written once; idx and live read once; at the
    H100 data sheet's 3.35 TB/s (both are far below the 989 TFLOP/s)."""
    rows, d_in = x.shape
    d_out, r_max = b.shape[-1], a.shape[-1]
    widths = {}
    for s, lv in zip(idx.tolist(), live.tolist()):
        if s >= 0:
            widths[s] = max(widths.get(s, 0), lv)
    cols, esz = sum(widths.values()), x.element_size()
    shrink = (x.numel() + cols * d_in) * esz + rows * r_max * 4 + 8 * rows
    expand = (rows * r_max + cols * d_out + rows * d_out) * esz + 8 * rows
    return 1e6 * shrink / 3.35e12, 1e6 * expand / 3.35e12


def lora_tree(root: str) -> dict:
    """--lora's run in one tree: the decode shrink, the expand (y in x's
    dtype, and the shrink's f32 y) and the pair as the model calls it
    (`ops.lora_delta`) at LORA_ROWS rows, d 4,096 and 4,100, and at d
    4,096 for LORA_PATTERNS, under BGMV and MBGMV, each in a CUDA graph
    after L2 flushes (`graph_us`); torch.bmm over the gathered pools in a
    graph and the bound beside."""
    sys.path.insert(0, str(Path(root) / "src"))
    import torch
    from repro_torch.kernels import bgmv, build, ops
    build.library()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                        device="cuda").zero_
    cases = [(d, rows, "round") for d in (4096, 4100) for rows in LORA_ROWS]
    cases += [(4096, rows, p) for p in LORA_PATTERNS
              for rows in LORA_PATTERN_ROWS]
    out = {}
    for d, rows, pattern in cases:
        x, a, b, idx, ranks = lora_case(torch, rows, d, pattern=pattern)
        safe = idx.clamp(min=0).long()
        a_g, b_g = a[safe], b[safe]
        yb = torch.randn(rows, LORA_R_MAX, device="cuda").bfloat16()
        lib_s = graph_us(torch, lambda: torch.bmm(x[:, None], a_g), flush)
        lib_e = graph_us(torch, lambda: torch.bmm(yb[:, None], b_g), flush)
        for mode in ("bgmv", "mbgmv"):
            live = ops.lora_live(idx, ranks, mode, LORA_R_MAX, 16)
            yf = bgmv.lora_shrink(x, a, idx, live)
            y = yf.to(x.dtype)
            s_us, e_us = lora_bound_us(x, a, b, idx, live)
            try:                    # a tree whose expand takes f32 y
                bgmv.lora_expand(yf, b, idx, live)
                e32 = graph_us(torch, lambda: bgmv.lora_expand(
                    yf, b, idx, live), flush)
            except ValueError:
                e32 = None
            key = f"{mode} d {d} rows {rows}"
            out[key if pattern == "round" else f"{key} {pattern}"] = {
                "shrink": graph_us(torch, lambda: bgmv.lora_shrink(
                    x, a, idx, live), flush),
                "expand": graph_us(torch, lambda: bgmv.lora_expand(
                    y, b, idx, live), flush),
                "expand_f32": e32,
                "pair": graph_us(torch, lambda: ops.lora_delta(
                    x, a, b, idx, live=live), flush),
                "bmm_shrink": lib_s, "bmm_expand": lib_e,
                "bound_shrink": s_us, "bound_expand": e_us,
                "slots": len(set(idx.tolist()) - {-1})}
        del x, a, b, a_g, b_g
        torch.cuda.empty_cache()
    return out


def graph_edges(torch, lib, body) -> dict:
    """Nodes, edges and programmatic edges of a CUDA graph captured from
    one call of body (`rt_graph_edges`)."""
    import ctypes
    body()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        body()
    out = (ctypes.c_longlong * 3)()
    rc = lib.rt_graph_edges(ctypes.c_void_p(g.raw_cuda_graph()), out)
    if rc:
        return {"error": rc}
    return dict(zip(("nodes", "edges", "programmatic_edges"), out))


def decode_direct(torch, lib, build, x, a, idx, live, y, split):
    """rt_lora_shrink's decode path at a given split (d_chunk: d_in over
    split in whole 16-wide k-steps); the stream is read inside the call."""
    rows, d = x.shape
    d_chunk = -(-(-(-d // split)) // 16) * 16

    def call():
        rc = lib.rt_lora_shrink(
            x.data_ptr(), a.data_ptr(), idx.data_ptr(), live.data_ptr(),
            y.data_ptr(), rows, d, a.shape[-1], a.shape[0], 0, d_chunk,
            split, 0, build.DTYPE_CODE[x.dtype],
            build.stream_handle(x.device))
        assert rc == 0, rc
    return call


def lora_probe() -> dict:
    """Where the decode LoRA pair's time goes, in this tree, each figure in
    a CUDA graph after L2 flushes and with L2 warm (`graph_us`): an empty
    kernel (with and without programmatic dependent launch, and the edges
    its capture holds; 128 blocks in clusters of 1 to 8), a read of the A pool's bytes (torch.sum) and a
    copy of them, the decode shrink and expand at 1, 8 and 64 rows with
    every adapted row's live width 8 and 64, torch.bmm over the gathered
    pools beside, the shrink's and the expand's device time from a
    profiled replay, the bf16 row-tile shrink (the persistent kernel: one
    64-row tile, a cluster of 8 over d) and the decode shrink at splits 1
    to 8 launched directly at the same rows."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch
    from repro_torch.kernels import bgmv, build
    lib = build.library()
    dev = torch.device("cuda")
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                        device="cuda").zero_
    res = {"torch": torch.__version__, "cuda": torch.version.cuda}

    def empty(pdl, blocks=1, cluster=1):
        def call():
            rc = lib.rt_empty(pdl, blocks, cluster, build.stream_handle(dev))
            assert rc == 0, rc
        return call
    for pdl in (0, 1):
        res[f"empty pdl {pdl}"] = {
            "graph_us": graph_us(torch, empty(pdl), flush),
            "graph_us_warm": graph_us(torch, empty(pdl), None)}
    res["empty pdl capture"] = graph_edges(
        torch, lib, lambda: (flush(), empty(1)(), empty(1)()))
    # a launch of 128 blocks in clusters of 1 to 8 that pass two cluster
    # barriers, as a cluster's reduction does
    for cluster in (1, 2, 4, 8):
        res[f"empty 128 blocks cluster {cluster} graph_us"] = graph_us(
            torch, empty(0, 128, cluster), flush)
    d = 4096
    for rows in (1, 8, 64):
        x, a, b, idx, _ = lora_case(torch, rows, d)
        safe = idx.clamp(min=0).long()
        a_g, b_g = a[safe], b[safe]
        r = {"slots_used": len(set(idx.tolist()) - {-1})}
        if rows == 8:
            dst = torch.empty_like(a)
            res["A pool bytes"] = a.numel() * 2
            res["sum of A graph_us"] = graph_us(torch, lambda: a.sum(),
                                                flush)
            res["copy of A graph_us"] = graph_us(torch,
                                                 lambda: dst.copy_(a), flush)
        for lv in (8, 64):
            live = torch.where(idx >= 0, lv, 0).to(torch.int32)
            y = bgmv.lora_shrink(x, a, idx, live).to(x.dtype)
            ag, bg = a_g[..., :lv].contiguous(), b_g[:, :lv].contiguous()
            yl = y[:, None, :lv].contiguous()
            calls = {
                "shrink": lambda: bgmv.lora_shrink(x, a, idx, live),
                "expand": lambda: bgmv.lora_expand(y, b, idx, live),
                "bmm_shrink": lambda: torch.bmm(x[:, None], ag),
                "bmm_expand": lambda: torch.bmm(yl, bg)}
            if hasattr(bgmv, "col_groups"):     # the expand takes f32 y
                yf = bgmv.lora_shrink(x, a, idx, live)
                calls["expand f32 y"] = lambda: bgmv.lora_expand(yf, b, idx,
                                                                 live)
            for name, fn in calls.items():
                r[f"live {lv} {name} graph_us"] = graph_us(torch, fn, flush)
                r[f"live {lv} {name} graph_us_warm"] = graph_us(torch, fn,
                                                                None)
            if lv == 64:
                r["kernels_us"] = {
                    "shrink": kernel_us(torch, calls["shrink"], flush),
                    "expand": kernel_us(torch, calls["expand"], flush)}
                yt = torch.empty(rows, LORA_R_MAX, device="cuda")

                def tile():
                    rc = lib.rt_lora_shrink(
                        x.data_ptr(), a.data_ptr(), idx.data_ptr(),
                        live.data_ptr(), yt.data_ptr(), rows, d, LORA_R_MAX,
                        a.shape[0], 64, 512, 8, 8, 1,
                        build.stream_handle(dev))
                    assert rc == 0, rc
                r["tile 64 x8 graph_us"] = graph_us(torch, tile, flush)
                r["tile 64 x8 graph_us_warm"] = graph_us(torch, tile, None)
                if hasattr(bgmv, "col_groups"):
                    # the decode shrink at each split it takes
                    for split in (1, 2, 4, 8):
                        r[f"decode split {split} graph_us"] = graph_us(
                            torch, decode_direct(torch, lib, build, x, a,
                                                 idx, live, yt, split),
                            flush)
        res[f"rows {rows}"] = r
        print("LORA-PROBE", f"rows {rows}", json.dumps(r), flush=True)
    return res


def expand_probe() -> dict:
    """How fast this card takes the one-slot expand's output stream, in
    this tree, each figure in a CUDA graph after L2 flushes and with L2
    warm (`graph_us`): the row-tile expand at the training shape (4,096
    rows of one slot, d_out 4,096, r_max 64, y in bf16; and on the
    shrink's f32 y, the launch the model makes), a store-only kernel that
    writes the same 33.5 MB from shared memory in 64 x 128 tiles by 16-byte
    st.global and by TMA bulk stores at one and two blocks an SM
    (`rt_store_probe`), torch.matmul(y, B[0]) and a fill of the output
    (the library's own stream of writes), and an empty kernel; with the
    bytes bound (`expand_bound_us`) and each figure's write rate."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch
    from repro_torch.kernels import bgmv, build
    lib = build.library()
    dev = torch.device("cuda")
    sms = bgmv.sm_count(dev)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                        device="cuda").zero_
    g = torch.Generator(device="cuda").manual_seed(0)
    rows, d, r = 4096, 4096, 64
    yf = torch.randn(rows, r, generator=g, device="cuda")
    yb = yf.bfloat16()
    b = (torch.randn(1, r, d, generator=g, device="cuda") / 8).bfloat16()
    idx = torch.zeros(rows, device="cuda", dtype=torch.int32)
    live = torch.full((rows,), r, device="cuda", dtype=torch.int32)
    out = torch.empty(rows, d, device="cuda", dtype=torch.bfloat16)
    out_bytes = out.numel() * 2
    res = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "sms": sms, "out_bytes": out_bytes,
           "bound_us": expand_bound_us(yb, b, idx, live)}

    def store(tma, blocks):
        def call():
            rc = lib.rt_store_probe(out.data_ptr(), rows, d, tma, blocks,
                                    build.stream_handle(dev))
            assert rc == 0, rc
        return call

    def empty():
        rc = lib.rt_empty(0, 1, 1, build.stream_handle(dev))
        assert rc == 0, rc

    calls = {"expand bf16 y": lambda: bgmv.lora_expand(yb, b, idx, live),
             "expand f32 y": lambda: bgmv.lora_expand(yf, b, idx, live),
             "matmul": lambda: torch.matmul(yb, b[0]),
             "fill": lambda: out.fill_(1.0),
             "empty kernel": empty}
    for blocks in (sms, 2 * sms):
        calls[f"store st.global {blocks} blocks"] = store(0, blocks)
        calls[f"store TMA {blocks} blocks"] = store(1, blocks)
    for name, fn in calls.items():
        cold, warm = graph_us(torch, fn, flush), graph_us(torch, fn, None)
        res[name] = {"graph_us": cold, "graph_us_warm": warm,
                     "TB_per_s_written": out_bytes / cold / 1e6
                     if cold > 0 else None}
        print("EXPAND-PROBE", name, json.dumps(res[name]), flush=True)
    return res


# The row-tile expand rows of --expand: (rows, d_out, r_max, slot ranks,
# rows a run of one slot, dtype), the pool zero past each rank, idx cycling
# through the slots in runs (a run of `rows`: every row at the last slot)
EXPAND_SHAPES = {
    "training 4,096 rows, 1 slot": (4096, 4096, 64, [64], 4096, "bf16"),
    "yi-9b chunk q: 512 rows, 1 slot of 8": (512, 4096, 64, [64] * 8, 512,
                                             "bf16"),
    "yi-9b chunk k/v: 512 rows, d_out 512": (512, 512, 64, [64] * 8, 512,
                                             "bf16"),
    "yi-9b prefill: 32,768 rows, 8 slots": (32768, 4096, 64, [64] * 8, 4096,
                                            "bf16"),
    "mixed 2,048 rows, runs of 32": (2048, 4096, 64, [64] * 8, 32, "bf16"),
    "mixed 4,096 rows, runs of 32": (4096, 4096, 64, [64] * 8, 32, "bf16"),
    "ranks 8/16/32/64, 4,096 rows, runs of 512": (
        4096, 4096, 64, [8, 16, 32, 64] * 2, 512, "bf16"),
    "r_max 128, 4,096 rows, 1 slot": (4096, 4096, 128, [128], 4096, "bf16"),
    "4,133 rows, 1 slot": (4133, 4096, 64, [64], 4133, "bf16"),
    "f32, 4,096 rows, 1 slot": (4096, 4096, 64, [64], 4096, "f32"),
    "d_out 4,100, 4,096 rows, 1 slot": (4096, 4100, 64, [64], 4096, "bf16"),
}


def expand_tree(root: str) -> dict:
    """--expand's run in one tree: each row of EXPAND_SHAPES under BGMV
    (and MBGMV live widths at the mixed-rank row) in a CUDA graph after L2
    flushes (`graph_us`): the expand of y in B's dtype and of the shrink's
    f32 y (what `ops.lora_delta` launches: in a tree whose row tiles take
    only B's dtype, with the wrapper's cast launch), with torch.matmul in
    a graph (one slot's B, or Y_bd x B_cat over the slots: each row's y
    in its slot's r_max columns, the same function at slots x the flops)
    and the bound (`expand_bound_us`) beside."""
    sys.path.insert(0, str(Path(root) / "src"))
    import torch
    from repro_torch.kernels import bgmv, build, ops
    build.library()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                        device="cuda").zero_
    out = {}
    for name, (rows, d_out, r_max, ranks, run, dt) in EXPAND_SHAPES.items():
        dtype = torch.float32 if dt == "f32" else torch.bfloat16
        g = torch.Generator(device="cuda").manual_seed(rows + d_out + r_max)
        slots = len(ranks)
        b = torch.zeros(slots, r_max, d_out, device="cuda")
        for s, r in enumerate(ranks):
            b[s, :r] = torch.randn(r, d_out, generator=g,
                                   device="cuda") * r ** -.5
        b = b.to(dtype)
        yf = torch.randn(rows, r_max, generator=g, device="cuda")
        yd = yf.to(dtype)
        idx = (torch.arange(rows, device="cuda") // run % slots).to(
            torch.int32)
        if run >= rows:
            idx.fill_(slots - 1)
        ranks_t = torch.tensor(ranks, dtype=torch.int32, device="cuda")
        modes = ("bgmv", "mbgmv") if len(set(ranks)) > 1 else ("bgmv",)
        used = sorted(set(idx.tolist()))
        if len(used) == 1:
            lib = (lambda y_, b_: lambda: torch.matmul(y_, b_))(
                yd, b[used[0]])
        else:
            y_bd = torch.zeros(rows, slots, r_max, dtype=dtype,
                               device="cuda")
            y_bd[torch.arange(rows, device="cuda"), idx.long()] = yd
            y_bd = y_bd.reshape(rows, slots * r_max)
            b_cat = b.reshape(slots * r_max, d_out)
            lib = (lambda y_, b_: lambda: torch.matmul(y_, b_))(y_bd, b_cat)
        lib_us = graph_us(torch, lib, flush)
        for mode in modes:
            live = ops.lora_live(idx, ranks_t, mode, r_max, 16)
            out[f"{name} {mode}"] = {
                "graph_us": graph_us(torch, lambda: bgmv.lora_expand(
                    yd, b, idx, live), flush),
                "f32_y_graph_us": graph_us(torch, lambda: bgmv.lora_expand(
                    yf, b, idx, live), flush),
                "matmul_graph_us": lib_us,
                "bound_us": expand_bound_us(yd, b, idx, live)}
        del b, yf, yd, lib
        torch.cuda.empty_cache()
    return out


def expand_bound_us(y, b, idx, live):
    """Microseconds the card needs at least for a row-tile expand at these
    inputs: y read once (its own dtype), the live rank rows of each slot
    in use read once, idx and live read once, out (rows x d_out in B's
    dtype) written once, at the H100 data sheet's 3.35 TB/s (the flops,
    2 x live x d_out a row, are far below 989 TFLOP/s)."""
    rows, d_out = y.shape[0], b.shape[-1]
    widths = {}
    for s, lv in zip(idx.tolist(), live.tolist()):
        if s >= 0:
            widths[s] = max(widths.get(s, 0), lv)
    nbytes = (y.numel() * y.element_size()
              + sum(widths.values()) * d_out * b.element_size()
              + 8 * rows + rows * d_out * b.element_size())
    return 1e6 * nbytes / 3.35e12


# The row-tile shrink rows of --shrink: (rows, d_in, r_max, slot ranks,
# rows a run of one slot, dtype), as EXPAND_SHAPES lays them out
SHRINK_SHAPES = {
    "training 4,096 rows, 1 slot": (4096, 4096, 64, [64], 4096, "bf16"),
    "yi-9b chunk: 512 rows, 1 slot of 8": (512, 4096, 64, [64] * 8, 512,
                                           "bf16"),
    "yi-9b prefill: 32,768 rows, 8 slots": (32768, 4096, 64, [64] * 8, 4096,
                                            "bf16"),
    "mixed 2,048 rows, runs of 32": (2048, 4096, 64, [64] * 8, 32, "bf16"),
    "mixed 4,096 rows, runs of 32": (4096, 4096, 64, [64] * 8, 32, "bf16"),
    "ranks 8/16/32/64, 4,096 rows, runs of 512": (
        4096, 4096, 64, [8, 16, 32, 64] * 2, 512, "bf16"),
    "r_max 128, 4,096 rows, 1 slot": (4096, 4096, 128, [128], 4096, "bf16"),
    "4,133 rows, 1 slot": (4133, 4096, 64, [64], 4133, "bf16"),
    "f32, 4,096 rows, 1 slot": (4096, 4096, 64, [64], 4096, "f32"),
    "d_in 4,100, 4,096 rows, 1 slot": (4096, 4100, 64, [64], 4096, "bf16"),
}


def shrink_case(torch, rows, d_in, r_max, ranks, run, dt):
    """x, the A pool (zero past each slot's rank), idx (runs of `run` rows
    a slot; a run of `rows`: every row at the last slot) and the ranks,
    seeded from the shape, on the card."""
    dtype = torch.float32 if dt == "f32" else torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(rows + d_in + r_max)
    slots = len(ranks)
    a = torch.zeros(slots, d_in, r_max, device="cuda")
    for s, r in enumerate(ranks):
        a[s, :, :r] = torch.randn(d_in, r, generator=g,
                                  device="cuda") * d_in ** -.5
    x = torch.randn(rows, d_in, generator=g, device="cuda").to(dtype)
    idx = (torch.arange(rows, device="cuda") // run % slots).to(torch.int32)
    if run >= rows:
        idx.fill_(slots - 1)
    return x, a.to(dtype), idx, torch.tensor(ranks, dtype=torch.int32,
                                             device="cuda")


def shrink_library(torch, x, a, idx):
    """torch.matmul computing the shrink's function at these inputs (timed
    only: the port never calls it): x @ A[s] where one slot is used, else
    x @ A_cat (d_in, slots x r_max), every slot's columns for every row."""
    used = sorted(set(idx.tolist()))
    a_ = a[used[0]] if len(used) == 1 else \
        a.permute(1, 0, 2).reshape(a.shape[1], -1).contiguous()
    return lambda: torch.matmul(x, a_)


def shrink_tree(root: str) -> dict:
    """--shrink's run in one tree: each row of SHRINK_SHAPES under BGMV
    (and MBGMV live widths at the mixed-rank row) in a CUDA graph after L2
    flushes (`graph_us`), with torch.matmul in a graph (`shrink_library`)
    and the bound (`shrink_bound_us`) beside."""
    sys.path.insert(0, str(Path(root) / "src"))
    import torch
    from repro_torch.kernels import bgmv, build, ops
    build.library()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                        device="cuda").zero_
    out = {}
    for name, shape in SHRINK_SHAPES.items():
        x, a, idx, ranks = shrink_case(torch, *shape)
        lib_us = graph_us(torch, shrink_library(torch, x, a, idx), flush)
        modes = ("bgmv", "mbgmv") if len(set(shape[3])) > 1 else ("bgmv",)
        for mode in modes:
            live = ops.lora_live(idx, ranks, mode, shape[2], 16)
            out[f"{name} {mode}"] = {
                "graph_us": graph_us(torch, lambda: bgmv.lora_shrink(
                    x, a, idx, live), flush),
                "matmul_graph_us": lib_us,
                "bound_us": shrink_bound_us(x, a, idx, live)}
        del x, a
        torch.cuda.empty_cache()
    return out


def shrink_bound_us(x, a, idx, live):
    """Microseconds the card needs at least for a row-tile shrink at these
    inputs: x read once, the live columns of each slot in use read once,
    idx and live read once, y (rows x r_max f32) written once, at the H100
    data sheet's 3.35 TB/s (the flops, 2 x live x d_in a row, are far
    below 989 TFLOP/s)."""
    rows, d_in = x.shape
    widths = {}
    for s, lv in zip(idx.tolist(), live.tolist()):
        if s >= 0:
            widths[s] = max(widths.get(s, 0), lv)
    nbytes = (x.numel() * x.element_size()
              + sum(widths.values()) * d_in * a.element_size()
              + 8 * rows + rows * a.shape[-1] * 4)
    return 1e6 * nbytes / 3.35e12


# --shrink-probe's shapes: (rows, slots a run of 4,096 rows cycles over)
SHRINK_PROBE_SHAPES = {"training 4,096 rows, 1 slot": (4096, 1),
                       "yi-9b chunk: 512 rows, 1 slot of 8": (512, 8),
                       "yi-9b prefill: 32,768 rows, 8 slots": (32768, 8)}
# csrc/lora.cu's stamps of the persistent shrink (kSt*), in order
SHRINK_STAMPS = ["other", "full", "mma", "wait", "reduce", "extra", "put",
                 "cycles", "ns", "blocks", "exchanges"]


def shrink_probe() -> dict:
    """Where this tree's row-tile shrink spends its time, at
    SHRINK_PROBE_SHAPES (d_in 4,096, r_max 64, bf16): the shrink, a
    load-only kernel (`rt_load_probe`) that streams x of the shape by TMA
    at one and two blocks an SM with 4 to 24 boxes of 8 KB in flight a
    block, torch.matmul and the bytes bound, each in a graph after L2
    flushes and with L2 warm; then the library built again with
    -DLORA_SHRINK_STAMPS, whose shrink adds each block's phases
    (SHRINK_STAMPS: thread 0 of the consumers, by clock64(), scaled to the
    block's %globaltimer span) over 5 replays of a graph of 20 launches
    after L2 flushes: the microseconds a block spends in each, and the
    stamped launch's own graph time."""
    import ctypes
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch
    from repro_torch.kernels import bgmv, build
    lib = build.library()
    dev = torch.device("cuda")
    sms = bgmv.sm_count(dev)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                        device="cuda").zero_
    cases, res = {}, {}
    for name, (rows, slots) in SHRINK_PROBE_SHAPES.items():
        x, a, idx, _ = shrink_case(torch, rows, 4096, 64, [64] * slots,
                                   4096 if rows > 512 else 512, "bf16")
        live = torch.full((rows,), 64, dtype=torch.int32, device="cuda")
        cases[name] = (x, a, idx, live)
        row = {"x_bytes": x.numel() * 2,
               "bound_us": shrink_bound_us(x, a, idx, live)}

        def load(blocks, stages):
            def call():
                rc = lib.rt_load_probe(x.data_ptr(), rows, 4096, blocks,
                                       stages, build.stream_handle(dev))
                assert rc == 0, rc
            return call
        calls = {"shrink": (lambda x_, a_, i_, l_: lambda: bgmv.lora_shrink(
                     x_, a_, i_, l_))(x, a, idx, live),
                 "matmul": shrink_library(torch, x, a, idx)}
        for blocks in (sms, 2 * sms):
            for stages in (4, 8, 12, 24):
                if blocks > sms and stages > 12:
                    continue                # two blocks an SM: <= 113 KB
                calls[f"load {blocks} blocks, {stages} stages"] = \
                    load(blocks, stages)
        for what, fn in calls.items():
            cold, warm = graph_us(torch, fn, flush), graph_us(torch, fn, None)
            row[what] = {"graph_us": cold, "graph_us_warm": warm,
                         "TB_per_s_x": row["x_bytes"] / cold / 1e6
                         if cold > 0 else None}
        res[name] = row
        print("SHRINK-PROBE", name, json.dumps(row), flush=True)
    # the stamped build: a library of its own (the flags name its file)
    build.NVCC_FLAGS = [*build.NVCC_FLAGS, "-DLORA_SHRINK_STAMPS"]
    build._lib = None
    lib = build.library()
    out = (ctypes.c_longlong * len(SHRINK_STAMPS))()
    for name, (x, a, idx, live) in cases.items():
        fn = (lambda x_, a_, i_, l_: lambda: bgmv.lora_shrink(
            x_, a_, i_, l_))(x, a, idx, live)
        stamped_us = graph_us(torch, fn, flush)
        g = capture(torch, lambda: (flush(), fn()), 20)
        assert lib.rt_lora_shrink_stamps(out) == 0   # the capture's calls
        for _ in range(5):
            g.replay()
        torch.cuda.synchronize()
        assert lib.rt_lora_shrink_stamps(out) == 0
        del g
        t = dict(zip(SHRINK_STAMPS, out))
        per_block_us = t["ns"] / t["blocks"] / 1e3
        row = {"stamped_graph_us": stamped_us,
               "launches": 100, "blocks_a_launch": t["blocks"] / 100,
               "exchanges_a_block": t["exchanges"] / t["blocks"],
               "block_span_us": per_block_us,
               "phase_us_a_block": {
                   k: per_block_us * t[k] / t["cycles"]
                   for k in SHRINK_STAMPS[:7]}}
        res[name]["stamps"] = row
        print("SHRINK-STAMPS", name, json.dumps(row), flush=True)
    return res


# CUPTI range-profiler counters asked of torch.profiler in --sweep
CUPTI_METRICS = ["dram__bytes_read.sum", "dram__bytes_write.sum",
                 "sm__throughput.avg.pct_of_peak_sustained_elapsed",
                 "sm__pipe_tensor_op_hmma_cycles_active.avg.pct_of_peak_"
                 "sustained_active"]


def sweep() -> dict:
    """The persistent bf16 shrink (d 4,096, r_max 64) of this tree at the
    training step's 4,096 rows of one slot, the yi-9b chunk's 512 rows and
    the 32,768-row prefill (8 slots in runs of 4,096), under every split
    it takes, each with as many clusters as the card holds at once (no
    more than the tiles) and, at the training shape, with half and a
    quarter of them; each in a CUDA graph after L2 flushes, beside the
    plan's choice; then the CUDA profiler (CUPTI) is asked for the
    training pair's counters."""
    import ctypes
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch
    from repro_torch.kernels import bgmv, build
    lib = build.library()
    dev = torch.device("cuda")
    sms = bgmv.sm_count(dev)
    room = bgmv.cluster_room(dev)
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    info = (ctypes.c_longlong * len(build.INFO_FIELDS))()
    res = {"sms": sms, "room": room, "shrink": []}
    d, r = 4096, 64
    for name, (rows, slots) in {"training": (4096, 1), "chunk": (512, 8),
                                "prefill": (32768, 8)}.items():
        x, a, idx, _ = shrink_case(torch, rows, d, r, [r] * slots, 4096,
                                   "bf16")
        live = torch.full((rows,), r, device="cuda", dtype=torch.int32)
        y = torch.empty(rows, r, device="cuda")
        plan = bgmv.shrink_plan(rows, d, slots, sms, r, torch.bfloat16, room)
        tiles = -(-rows // bgmv.SHRINK_ROWS)
        for split in (1, 2, 4, 8):
            d_chunk = -(-(-(-d // split)) // 64) * 64
            most = min(room[split], tiles)
            counts = (most, most // 2, most // 4) if name == "training" \
                else (most,)
            for clusters in counts:
                blocks = clusters * split

                def shrink():
                    rc = lib.rt_lora_shrink(
                        x.data_ptr(), a.data_ptr(), idx.data_ptr(),
                        live.data_ptr(), y.data_ptr(), rows, d, r, slots,
                        bgmv.SHRINK_ROWS, d_chunk, split, blocks, 1,
                        build.stream_handle(dev))
                    assert rc == 0, rc
                rc = lib.rt_lora_shrink_info(rows, d, r, slots,
                                             bgmv.SHRINK_ROWS, d_chunk, split,
                                             blocks, 1, info)
                assert rc == 0, rc
                f = dict(zip(build.INFO_FIELDS, info))
                us = graph_us(torch, shrink, flush)
                res["shrink"].append({
                    "shape": name, "split": split, "clusters": clusters,
                    "tiles_a_cluster": -(-tiles // clusters),
                    "plan": (split, blocks) == (plan.split, plan.grid),
                    "registers": f["registers"],
                    "blocks_per_sm": f["blocks_per_sm"], "us_graph": us,
                    "x_TB_per_s": x.numel() * 2 / us / 1e6})
                print("SWEEP", json.dumps(res["shrink"][-1]), flush=True)
        res[f"{name} matmul_us_graph"] = graph_us(
            torch, shrink_library(torch, x, a, idx), flush)
        del x, a, y
        torch.cuda.empty_cache()
    rows = 4096
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(rows, d, generator=g, device="cuda").bfloat16()
    a = (torch.randn(1, d, r, generator=g, device="cuda") / 64).bfloat16()
    b = (torch.randn(1, r, d, generator=g, device="cuda") / 8).bfloat16()
    idx = torch.zeros(rows, device="cuda", dtype=torch.int32)
    live = torch.full((rows,), r, device="cuda", dtype=torch.int32)
    yb = bgmv.lora_shrink(x, a, idx, live).bfloat16()
    try:
        from torch.profiler import ProfilerActivity, _ExperimentalConfig, \
            profile
        cfg = _ExperimentalConfig(profiler_metrics=CUPTI_METRICS,
                                  profiler_measure_per_kernel=True)
        with profile(activities=[ProfilerActivity.CUDA],
                     experimental_config=cfg) as prof:
            bgmv.lora_shrink(x, a, idx, live)
            bgmv.lora_expand(yb, b, idx, live)
            torch.cuda.synchronize()
        trace = Path(__file__).resolve().parent / "build" / \
            "kernel_ab_cupti.json"
        trace.parent.mkdir(exist_ok=True)
        prof.export_chrome_trace(str(trace))
        found = [{"name": ev.get("name", "")[:60], "args": {
            k: v for k, v in ev.get("args", {}).items()
            if any(m.split(".")[0] in k for m in CUPTI_METRICS)}}
            for ev in json.loads(trace.read_text()).get("traceEvents", [])]
        res["cupti"] = [f for f in found if f["args"]] or \
            "the trace holds no counter of " + ", ".join(CUPTI_METRICS)
    except Exception as e:                  # noqa: BLE001 - reported
        res["cupti"] = f"{type(e).__name__}: {e}"
    return res


def main() -> int:
    if sys.argv[1:2] == ["--paged-probe"]:
        paged_probe()
        return 0
    if sys.argv[1:2] == ["--paged-loaded"]:
        paged_loaded()
        return 0
    if sys.argv[1:2] == ["--lora-probe"]:
        print("LORA-PROBE", json.dumps(lora_probe()), flush=True)
        return 0
    if sys.argv[1:2] == ["--expand-probe"]:
        print("EXPAND-PROBE", json.dumps(expand_probe()), flush=True)
        return 0
    if sys.argv[1:2] == ["--shrink-probe"]:
        shrink_probe()
        return 0
    if sys.argv[1:2] == ["--shrink-tree"]:
        print("SHRINK", sys.argv[2], json.dumps(shrink_tree(sys.argv[2])),
              flush=True)
        return 0
    if sys.argv[1:2] == ["--expand-tree"]:
        print("EXPAND", sys.argv[2], json.dumps(expand_tree(sys.argv[2])),
              flush=True)
        return 0
    if sys.argv[1:2] == ["--build-tree"]:
        sys.path.insert(0, str(Path(sys.argv[2]) / "src"))
        from repro_torch.kernels import build
        build.library()
        return 0
    if sys.argv[1:2] == ["--lora-tree"]:
        print("LORA", sys.argv[2], json.dumps(lora_tree(sys.argv[2])),
              flush=True)
        return 0
    if sys.argv[1:2] == ["--sweep"]:
        print("SWEEP", json.dumps(sweep()), flush=True)
        return 0
    if sys.argv[1:2] == ["--tree"]:
        print("AB", sys.argv[2], json.dumps(time_tree(sys.argv[2])),
              flush=True)
        return 0
    if sys.argv[1:2] == ["--flash-tree"]:
        print("FLASH", sys.argv[2], json.dumps(flash_tree(sys.argv[2])),
              flush=True)
        return 0
    here = str(Path(__file__).resolve().parent)
    if sys.argv[1:2] == ["--flash"] and len(sys.argv) >= 3:
        trees = [sys.argv[2], here, *sys.argv[3:]]
        mode = "--flash-tree"
    elif sys.argv[1:2] == ["--lora"] and len(sys.argv) >= 3:
        trees = [sys.argv[2], here, *sys.argv[3:]]
        mode = "--lora-tree"
    elif sys.argv[1:2] == ["--expand"] and len(sys.argv) >= 3:
        trees = [sys.argv[2], here, *sys.argv[3:]]
        mode = "--expand-tree"
    elif sys.argv[1:2] == ["--shrink"] and len(sys.argv) >= 3:
        trees = [sys.argv[2], here, *sys.argv[3:]]
        mode = "--shrink-tree"
    elif len(sys.argv) == 2 and not sys.argv[1].startswith("--"):
        trees, mode = [sys.argv[1], here], "--tree"
    else:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    builds = [subprocess.Popen([sys.executable, __file__, "--build-tree",
                                tree]) for tree in trees]
    if any(p.wait() for p in builds):
        return 1
    for tree in trees + trees[::-1]:
        subprocess.run([sys.executable, __file__, mode, tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
