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
llama2-7b's decode (8 rows, 32 x 32 heads, 16 pages of 32), and of the
LoRA shrink and expand (d 4,096, r_max 64) at 8 rows, at the training
step's 4,096 rows of one slot, at the yi-9b chunk's 512 rows of one slot
of 8 (the shrink), at the yi-9b prefill's 32,768 rows (8 slots) and at
2,048 and 4,096 rows in runs of 32 over 8 slots (tiles of several slots:
a packed prefill of short prompts). `--tree ROOT` runs one tree.

    python3 kernel_ab.py --sweep

times, in this tree, the training step's one-slot shrink under every row
tile and split the kernel takes and its expand under several row-block
counts, each in a CUDA graph, with the blocks, the clusters the card
holds at once, the waves and the bytes a microsecond, and asks the CUDA
profiler (CUPTI) for the kernels' counters (its trace goes to
build/kernel_ab_cupti.json). Needs one NVIDIA card.
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


def graph_us(torch, fn, flush, n=20, reps=5):
    """Microseconds a launch of fn in a CUDA graph: n launches, each after
    an L2 flush, replayed `reps` times, less a graph of the flushes alone
    (chip_smoke.graph_ms)."""
    per = []
    for body in (lambda: (flush(), fn()), flush):
        body()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(n):
                body()
        g.replay()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            g.replay()
        e.record()
        e.synchronize()
        per.append(1e3 * s.elapsed_time(e) / (reps * n))
    return per[0] - per[1]


# CUPTI range-profiler counters asked of torch.profiler in --sweep
CUPTI_METRICS = ["dram__bytes_read.sum", "dram__bytes_write.sum",
                 "sm__throughput.avg.pct_of_peak_sustained_elapsed",
                 "sm__pipe_tensor_op_hmma_cycles_active.avg.pct_of_peak_"
                 "sustained_active"]


def sweep() -> dict:
    """The training shape's one-slot LoRA pair (4,096 rows, d 4,096,
    r_max 64, bf16) under each launch the kernels take."""
    import ctypes
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch
    from repro_torch.kernels import bgmv, build
    lib = build.library()
    sms = bgmv.sm_count(torch.device("cuda"))
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    g = torch.Generator(device="cuda").manual_seed(0)
    rows, d, r = 4096, 4096, 64
    x = torch.randn(rows, d, generator=g, device="cuda").bfloat16()
    a = (torch.randn(1, d, r, generator=g, device="cuda") / 64).bfloat16()
    b = (torch.randn(1, r, d, generator=g, device="cuda") / 8).bfloat16()
    idx = torch.zeros(rows, device="cuda", dtype=torch.int32)
    live = torch.full((rows,), r, device="cuda", dtype=torch.int32)
    y = torch.empty(rows, r, device="cuda")
    out = torch.empty(rows, d, device="cuda", dtype=torch.bfloat16)
    info = (ctypes.c_longlong * len(build.INFO_FIELDS))()
    res = {"sms": sms, "plan": bgmv.shrink_plan(rows, d, 1, sms)._asdict(),
           "expand_plan": bgmv.expand_plan(rows, d, sms), "shrink": [],
           "expand": []}
    shrink_bytes = (x.numel() + a.numel()) * 2 + y.numel() * 4
    for tile in (64, 128):
        for split in (1, 2, 4, 8):
            d_chunk = -(-(-(-d // split)) // 64) * 64

            def shrink():
                rc = lib.rt_lora_shrink(
                    x.data_ptr(), a.data_ptr(), idx.data_ptr(),
                    live.data_ptr(), y.data_ptr(), rows, d, r, 1, tile,
                    d_chunk, split, 1, build.stream_handle(x.device))
                assert rc == 0, rc
            rc = lib.rt_lora_shrink_info(rows, d, r, 1, tile, d_chunk, split,
                                         1, info)
            assert rc == 0, rc
            f = dict(zip(build.INFO_FIELDS, info))
            working = -(-rows // tile) * split       # blocks that do work
            at_once = f["max_clusters"] * split if split > 1 \
                else f["blocks_per_sm"] * sms
            us = graph_us(torch, shrink, flush)
            res["shrink"].append({
                "tile": tile, "split": split, "working_blocks": working,
                "blocks_at_once": at_once, "waves": -(-working // at_once),
                "us_graph": us, "GB_per_s": shrink_bytes / us / 1e3})
    expand_bytes = (y.numel() + b.numel() + out.numel()) * 2
    yb = y.bfloat16()
    for rb in (8, 16, 32, 64):
        def expand():
            rc = lib.rt_lora_expand(
                yb.data_ptr(), b.data_ptr(), idx.data_ptr(), live.data_ptr(),
                out.data_ptr(), rows, r, d, 1, rb, 1,
                build.stream_handle(x.device))
            assert rc == 0, rc
        us = graph_us(torch, expand, flush)
        res["expand"].append({"row_blocks": rb, "blocks": rb * (d // 256),
                              "us_graph": us,
                              "GB_per_s": expand_bytes / us / 1e3})
    res["shrink_matmul_us_graph"] = graph_us(
        torch, lambda: torch.matmul(x, a[0]), flush)
    res["expand_matmul_us_graph"] = graph_us(
        torch, lambda: torch.matmul(yb, b[0]), flush)
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
    if sys.argv[1:2] == ["--sweep"]:
        print("SWEEP", json.dumps(sweep()), flush=True)
        return 0
    if sys.argv[1:2] == ["--tree"]:
        print("AB", sys.argv[2], json.dumps(time_tree(sys.argv[2])),
              flush=True)
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    here = str(Path(__file__).resolve().parent)
    for tree in (sys.argv[1], here, here, sys.argv[1]):
        subprocess.run([sys.executable, __file__, "--tree", tree],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
