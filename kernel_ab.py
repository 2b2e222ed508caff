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
LoRA shrink and expand at 8 rows (d 4,096, r_max 64). `--tree ROOT` runs
one tree. Needs one NVIDIA card.
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
    return out


def main() -> int:
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
