#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. print the card's name and power limit; build the CUDA kernels from
     src/repro_torch/csrc with nvcc (sm_90a) and print the build time;
  2. hold each kernel against its plain PyTorch version on the card:
     llama2-7b shapes in bf16 and smoke shapes in f32, with unclaimed
     pages, pos = 0 rows, a row with no claimed page, claimed-but-empty
     pages, GQA groups > 1, NaN in every page a row does not own, idx = -1
     rows and ranks 8/16/32/64 under BGMV and MBGMV;
  3. serve full-width llama2-7b (32 layers, d_model 4096, bf16, seeded
     random weights on the card) through `InferenceServer`: 16 requests
     with kernel="bgmv", then 6 with kernel="mbgmv"; every request must
     finish with its tokens and every kernel's launch count must move.
     Prints prefill and decode times taken with CUDA events around the
     backend's calls, with no synchronization added (the host runs ahead
     of the card as in service), and the run's wall time;
  4. one decode step's logits through the kernels vs through the plain
     versions, on the card;
  5. per-kernel timing at the decode shapes of phase 4 (CUDA events, L2
     flushed between launches) beside its bound, the plain version and a
     PyTorch library call, as one {"kernels": [...]} line; then the last
     line {"ok": true, "device": {...}}.

Tolerances (kernel vs plain version on the same inputs), per output row b:
bf16 max|kernel[b] - plain[b]| <= 1e-2 * max|plain[b]|; f32 <= 1e-5 *
max(1, max|plain[b]|).
Decode-step logits: max|kernels - plain| <= 5e-2 * max|plain|.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
BF16_TOL, F32_TOL, LOGIT_TOL = 1e-2, 1e-5, 5e-2
SEED = 0


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "build.py").is_file():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    built = "found" if build.build_seconds is None \
        else f"nvcc {build.build_seconds:.1f} s"
    print(f"kernels ready in {time.perf_counter() - t0:.1f} s ({built}) -> "
          f"{build.library_path().name}", flush=True)

    errs = kernel_checks(torch)
    from repro_torch.configs.base import get_config
    cfg = get_config("llama2-7b")
    serving, params = serve_phase(torch, cfg)
    step = logits_phase(torch, cfg, params)
    kernels = timing_phase(torch, step, errs, serving)
    print(json.dumps({"serving": serving,
                      "decode_logits": step["logits"],
                      "decode_profile": step["profile"],
                      "lora_rank_sweep": step["rank_sweep"]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ------------------------------------------------------------ phase 2 ----

def check_close(name, got, want, dtype):
    """Each row b (leading axis) is held to its own scale: max|got[b] -
    want[b]| <= tol * max|want[b]| in bf16, <= tol * max(1, max|want[b]|)
    in f32. A row whose plain output is all zero must come out exactly
    zero. Returns the largest absolute error over all rows."""
    import torch
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
    if not g.numel():
        return 0.0
    err = (g - w).abs().flatten(1).amax(1)
    scale = w.abs().flatten(1).amax(1)
    lim = BF16_TOL * scale if dtype == torch.bfloat16 \
        else F32_TOL * scale.clamp(min=1.0)
    bad = (err > lim).nonzero()
    if bad.numel():
        b = int(bad[0])
        check(False, f"{name}: row {b} max abs err {float(err[b]):.3e} > "
              f"{float(lim[b]):.3e}")
    ratio = torch.where(lim > 0, err / lim.clamp(min=1e-30), 0.0)
    pos = lim[lim > 0]
    span = f"{float(pos.min()):.3e} to {float(pos.max()):.3e}" \
        if pos.numel() else "all 0"
    print(f"  {name}: max abs err {float(err.max()):.3e}, at most "
          f"{float(ratio.max()):.3f} of its row's limit (row limits {span})",
          flush=True)
    return float(err.max())


def paged_case(torch, np_rng, B, H, KV, hd, ps, W, P, dtype, ctx):
    """Pages of P (+1 write sink) with row b holding ctx[b] tokens (0 = no
    claimed page) in pages drawn at random; returns kernel arguments."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(int(np_rng.integers(1 << 30)))
    q = torch.randn(B, H, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(P + 1, KV, ps, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(P + 1, KV, ps, hd, generator=g, device=dev).to(dtype)
    pp = torch.full((P + 1, ps), -1, dtype=torch.int32)
    bt = torch.full((B, W), -1, dtype=torch.int32)
    pos = torch.zeros(B, dtype=torch.int32)
    free = [int(p) for p in np_rng.permutation(P)]
    for b, n_tok in enumerate(ctx):
        for j in range(-(-n_tok // ps)):
            pg = free.pop()
            bt[b, j] = pg
            filled = torch.arange(ps) + j * ps
            pp[pg] = torch.where(filled < n_tok, filled, -1).int()
        pos[b] = max(n_tok - 1, 0)
    return [q, k, v, pp.to(dev), bt.to(dev), pos.to(dev)], free


def kernel_checks(torch):
    """Phase 2. Returns the worst error per kernel at llama2-7b shapes."""
    import numpy as np
    from repro_torch.kernels import ref
    from repro_torch.kernels.bgmv import lora_expand, lora_shrink
    from repro_torch.kernels.paged import paged_attention
    print("phase 2: kernels vs plain versions on the card", flush=True)
    rng = np.random.default_rng(SEED)
    worst = {"paged_attention": 0.0, "lora_shrink": 0.0,
             "lora_expand": 0.0}

    def note(name, err, full):
        if full:
            worst[name] = max(worst[name], err)

    # paged attention: (label, B, H, KV, hd, ps, W, P, dtype, full-width)
    bf, f32 = torch.bfloat16, torch.float32
    cases = [("llama2-7b bf16", 8, 32, 32, 128, 32, 16, 176, bf, True),
             ("GQA 4 bf16", 8, 32, 8, 128, 32, 16, 176, bf, True),
             ("smoke f32", 4, 4, 4, 32, 32, 2, 10, f32, False),
             ("GQA 2 ps 8 f32", 4, 4, 2, 32, 8, 5, 24, f32, False),
             ("GQA 4 hd 16 f32", 4, 8, 2, 16, 8, 5, 24, f32, False)]
    for label, B, H, KV, hd, ps, W, P, dt, full in cases:
        cap = W * ps
        ctx = [0, 1] + [int(rng.integers(2, cap + 1)) for _ in range(B - 2)]
        args, free = paged_case(torch, rng, B, H, KV, hd, ps, W, P, dt, ctx)
        q, k, v, pp, bt, pos = args
        # a claimed-but-empty page, and an unclaimed hole mid-table
        last = B - 1
        nl = int((bt[last] >= 0).sum())
        if nl < W:
            pg = free.pop()
            bt[last, nl] = pg
            pp[pg] = -1
        if W > 2 and int(bt[2, 2]) >= 0:
            bt[2, 1] = -1
        got = paged_attention(*args)
        want = ref.paged_attention_ref(*args)
        note("paged_attention",
             check_close(f"paged_attention {label}", got, want, dt), full)
        check(bool((got[0] == 0).all()), "row with no claimed page != 0")
        if full and label.startswith("llama2-7b"):
            # tenant isolation: NaN in every page a row does not own must
            # leave that row's output bitwise unchanged
            for b in range(B):
                own = bt[b][bt[b] >= 0].long()
                keep = torch.zeros(P + 1, dtype=torch.bool, device="cuda")
                keep[own] = True
                kk = torch.where(keep[:, None, None, None], k, float("nan"))
                vv = torch.where(keep[:, None, None, None], v, float("nan"))
                ppp = torch.where(keep[:, None], pp, 0)
                out = paged_attention(q, kk, vv, ppp, bt, pos)
                check(bool(torch.equal(out[b], got[b])),
                      f"paged_attention: row {b} read a page it does not "
                      "own")
            print("  paged_attention: NaN in foreign pages leaves every "
                  "row bitwise unchanged", flush=True)

    # LoRA shrink / expand: (label, rows, d_in, d_out, r_max, ranks, rb,
    # dtype, full-width)
    lcases = [("decode bf16", 8, 4096, 4096, 64, [8, 16, 32, 64] * 2, 16,
               bf, True),
              ("prefill 1024 rows bf16", 1024, 4096, 4096, 64,
               [8, 16, 32, 64] * 2, 16, bf, True),
              ("smoke f32", 8, 128, 128, 8, [8, 3, 5, 1], 4, f32, False),
              ("smoke prefill f32", 96, 128, 128, 8, [8, 3, 5, 1], 4, f32,
               False)]
    for label, rows, d_in, d_out, r_max, ranks, rb, dt, full in lcases:
        g = torch.Generator(device="cuda").manual_seed(len(label))
        slots = len(ranks)
        a = torch.zeros(slots, d_in, r_max, device="cuda", dtype=dt)
        b = torch.zeros(slots, r_max, d_out, device="cuda", dtype=dt)
        for s, r in enumerate(ranks):
            a[s, :, :r] = (torch.randn(d_in, r, generator=g, device="cuda")
                           * d_in ** -0.5).to(dt)
            b[s, :r] = (torch.randn(r, d_out, generator=g, device="cuda")
                        * r ** -0.5).to(dt)
        x = torch.randn(rows, d_in, generator=g, device="cuda").to(dt)
        idx = torch.as_tensor(rng.integers(-1, slots, rows),
                              dtype=torch.int32, device="cuda")
        idx[0] = -1
        ranks_t = torch.as_tensor(ranks, dtype=torch.int32, device="cuda")
        for mode, live in (("bgmv", ref.bgmv_live(idx, r_max)),
                           ("mbgmv", ref.mbgmv_live(idx, ranks_t, rb))):
            y = lora_shrink(x, a, idx, live)
            note("lora_shrink", check_close(
                f"lora_shrink {mode} {label}", y,
                ref.lora_shrink_ref(x, a, idx, live), f32), full)
            dead = torch.arange(r_max, device="cuda")[None] >= live[:, None]
            check(bool((y[dead] == 0).all()), "shrink: dead columns != 0")
            yd = y.to(dt)
            out = lora_expand(yd, b, idx, live)
            note("lora_expand", check_close(
                f"lora_expand {mode} {label}", out,
                ref.lora_expand_ref(yd, b, idx, live), dt), full)
            check(bool((out[idx < 0] == 0).all()), "expand: idx -1 row != 0")
    torch.cuda.synchronize()
    return worst


# ------------------------------------------------------------ phase 3 ----

ADAPTER_RANKS = (8, 16, 32, 64)


def make_server(torch, cfg, kernel, params):
    from repro_torch.core.engine import InferenceServer
    from repro_torch.core.lora import AdapterSpec
    srv = InferenceServer(cfg, mode="caraserve", kernel=kernel, max_batch=8,
                          cache_slots=512, page_size=32, params=params,
                          seed=SEED, device="cuda")
    uids = []
    for r in ADAPTER_RANKS:
        for i in range(2):
            spec = AdapterSpec(f"lora-r{r}-{i}", r, cfg.name)
            srv.register_adapter(spec)
            uids.append(spec.uid)
    return srv, uids


def make_requests(cfg, uids, n, seed, spacing_ms=2.0):
    import numpy as np
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=i, adapter_uid=uids[i % len(uids)],
                    prompt=rng.integers(0, cfg.vocab,
                                        int(rng.integers(32, 257))
                                        ).astype(np.int32),
                    max_new_tokens=32, arrival_ms=spacing_ms * i)
            for i in range(n)]


def _counters():
    from repro_torch.kernels import bgmv, paged
    return {"paged_attention": paged.paged_attention,
            "lora_shrink": bgmv.lora_shrink,
            "lora_expand": bgmv.lora_expand}


def serve_phase(torch, cfg):
    """Phase 3: drive the main path through InferenceServer, once per LoRA
    kernel mode, with every launch count zeroed just before and read just
    after. Prefill and decode times are the card's: a CUDA event is
    recorded on the stream at the start and end of each backend call, with
    no host synchronization added, so the host queues step N+1 while the
    card runs step N as it does in service; the spans are read after the
    run's one synchronize. A call's span runs from when the card reaches
    its first work (or the host records the start, if the card is idle) to
    when its last work ends, so host gaps inside a call count and gaps
    between calls do not; `wall_s` covers the whole run."""
    import numpy as np
    print("phase 3: serving full-width llama2-7b on the card", flush=True)
    out, params = [], None
    for kernel, n_req in (("bgmv", 16), ("mbgmv", 6)):
        t_init = time.perf_counter()
        srv, uids = make_server(torch, cfg, kernel, params)
        params = srv.params
        reqs = make_requests(cfg, uids, n_req, SEED + len(out))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t_init
        be = srv.backend
        spans = {"prefill": [], "decode": []}
        decode_tokens = [0]

        def timed(fn, kind, count):
            def run(*a, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                res = fn(*a, **kw)
                end.record()
                spans[kind].append((start, end))
                decode_tokens[0] += count(*a)
                return res
            return run

        be.prefill_admitted = timed(be.prefill_admitted, "prefill",
                                    lambda states: 0)
        be.decode = timed(be.decode, "decode", lambda ready, *a: len(ready))
        be.megastep = timed(be.megastep, "decode",
                            lambda ready, nsteps, *a: sum(nsteps))
        counters = _counters()
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        srv.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in counters.items()}
        times = {k: [s.elapsed_time(e) for s, e in v]
                 for k, v in spans.items()}
        for st in srv.states:
            check(len(st.generated) == st.req.max_new_tokens,
                  f"{kernel}: request {st.req.rid} produced "
                  f"{len(st.generated)} of {st.req.max_new_tokens} tokens")
            check(all(0 <= t < cfg.vocab for t in st.generated),
                  f"{kernel}: request {st.req.rid} token out of range")
        check(len(srv.states) == n_req, f"{kernel}: lost requests")
        for n, c in launches.items():
            check(c > 0, f"{kernel}: kernel {n} never launched on the "
                  "main path")
        tokens = sum(len(st.generated) for st in srv.states)
        rec = {"kernel": kernel, "requests": n_req, "tokens": tokens,
               "wall_s": wall, "setup_s": init_s,
               "prefill_calls": len(times["prefill"]),
               "prefill_ms_median": float(np.median(times["prefill"])),
               "prefill_ms_max": float(np.max(times["prefill"])),
               "decode_calls": len(times["decode"]),
               "decode_tokens": decode_tokens[0],
               "decode_ms": float(sum(times["decode"])),
               "decode_tok_s": 1e3 * decode_tokens[0]
               / sum(times["decode"]),
               "decode_call_ms_median": float(np.median(times["decode"])),
               "tok_s_wall": tokens / wall,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "launches": launches,
               "transfer_stats": dict(be.transfer_stats)}
        print(f"  {kernel}: {n_req} requests, {tokens} tokens in "
              f"{wall:.2f} s wall ({rec['tok_s_wall']:.1f} tok/s); "
              "prefill median "
              f"{rec['prefill_ms_median']:.1f} ms over "
              f"{rec['prefill_calls']} calls; decode "
              f"{rec['decode_tok_s']:.1f} tok/s; launches {launches}",
              flush=True)
        out.append(rec)
        del srv, be
        torch.cuda.empty_cache()
    return out, params


# ------------------------------------------------------------ phase 4 ----

@contextlib.contextmanager
def plain_ops():
    """Route the model's kernel calls to the plain versions (on the card)
    for the comparison step."""
    from repro_torch.kernels import ops, ref
    saved = ops.paged_attention, ops.lora_delta

    def lora_plain(x, a, b, idx, ranks=None, mode="bgmv", rank_block=16,
                   live=None):
        if live is None:
            live = ops.lora_live(idx, ranks, mode, a.shape[-1], rank_block)
        y = ref.lora_shrink_ref(x, a, idx, live)
        return ref.lora_expand_ref(y.to(x.dtype), b, idx, live)

    ops.paged_attention, ops.lora_delta = ref.paged_attention_ref, \
        lora_plain
    try:
        yield
    finally:
        ops.paged_attention, ops.lora_delta = saved


@contextlib.contextmanager
def capture_first_calls(store):
    """Record the arguments of the first paged-attention and LoRA-delta
    call (layer 0) of a decode step, for phase 5's timing."""
    from repro_torch.kernels import ops
    saved = ops.paged_attention, ops.lora_delta

    def pa(*a):
        store.setdefault("paged_attention", a)
        return saved[0](*a)

    def ld(*a, **kw):
        store.setdefault("lora_delta", (a, kw))
        return saved[1](*a, **kw)

    ops.paged_attention, ops.lora_delta = pa, ld
    try:
        yield
    finally:
        ops.paged_attention, ops.lora_delta = saved


def logits_phase(torch, cfg, params):
    """Phase 4: admit 8 requests at once, serve them up to their first
    decode step, then run
    the next decode step twice on copies of the KV pool — through the
    kernels and through the plain versions — and compare the logits."""
    from repro_torch.models import model as model_lib
    print("phase 4: decode-step logits, kernels vs plain versions",
          flush=True)
    srv, uids = make_server(torch, cfg, "bgmv", params)
    for r in make_requests(cfg, uids, 8, SEED + 7, spacing_ms=0.0):
        srv.submit(r)
    be = srv.backend
    while be.transfer_stats["decode_steps"] == 0:
        srv.step()
    pipe = be.pipe
    act = pipe.active & (pipe.pos < pipe.target)
    check(bool(act.any()), "phase 4: no active decode row")
    lora = be._lora_arg()
    store = {}

    def step_logits():
        cache = {n: t.clone() for n, t in be.cache.items()}
        with torch.no_grad():
            logits, _ = model_lib.decode(
                cfg, be.params, cache, pipe.last_tok[:, None], pipe.pos,
                lora=lora, write_mask=act, block_table=pipe.block_table)
        return logits[:, -1].float(), cache

    with capture_first_calls(store):
        lk, cache_k = step_logits()
    with plain_ops():
        lp, _ = step_logits()
    torch.cuda.synchronize()
    err = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    check(bool(torch.isfinite(lk).all()), "phase 4: non-finite logits")
    check(err <= LOGIT_TOL * scale,
          f"phase 4: logits max abs err {err:.3e} > {LOGIT_TOL} * "
          f"{scale:.3e}")
    same = int((lk.argmax(-1) == lp.argmax(-1))[act].sum())
    print(f"  logits max abs err {err:.4e}, max |logit| {scale:.4e}, "
          f"relative {err / scale:.3e} (limit {LOGIT_TOL}); greedy tokens "
          f"agree on {same}/{int(act.sum())} active rows", flush=True)
    store["profile"] = profile_step(torch, step_logits)
    store["pool_ranks"] = be.pool.pool["ranks"]
    store["logits"] = {"max_abs_err": err, "max_abs_logit": scale,
                       "rel_err": err / scale, "rows": int(act.sum()),
                       "greedy_agree": same}
    store["keepalive"] = (srv, cache_k)
    return store


def profile_step(torch, step_fn, top=12):
    """Where one llama2-7b decode step's time goes: torch.profiler over a
    warm step, device time summed by kernel name, and the step's wall
    time, so the device's idle share shows."""
    from torch.profiler import ProfilerActivity, profile
    step_fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = []
    for ev in prof.key_averages():
        # device-side events only (kernels, memcpys): an operator's own
        # row repeats the time of the kernels it launched
        if "CUDA" not in str(ev.device_type) or "Buffer" in ev.key:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append({"name": ev.key[:80], "calls": ev.count,
                         "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    device_ms = sum(r["device_ms"] for r in rows)
    out = {"wall_ms": wall_ms, "device_ms": device_ms,
           "device_idle_share": (1.0 - device_ms / wall_ms)
           if device_ms else None, "top": rows[:top]}
    print(f"  one decode step, synchronized and profiled (a per-layer "
          f"diagnostic): {wall_ms:.1f} ms wall, {device_ms:.1f} ms of "
          "device kernels", flush=True)
    for r in rows[:top]:
        print(f"    {r['device_ms']:8.3f} ms {r['calls']:5d}x {r['name']}",
              flush=True)
    return out


# ------------------------------------------------------------ phase 5 ----

def time_ms(torch, fn, flush, n=100):
    """Mean device time of fn over n launches, each started with a cold
    L2 (flushed by an untimed write), after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(n):
        flush()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / n


def bound(nbytes, ops, dtype_name):
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = ops / PEAK_OPS_PER_S[dtype_name]
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def timing_phase(torch, step, errs, serving):
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.bgmv import lora_expand, lora_shrink
    from repro_torch.kernels.paged import paged_attention
    from repro_torch.models.layers import paged_kv_for_attn
    print("phase 5: kernel timing at the decode shapes of phase 4",
          flush=True)
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    launches = {r["kernel"]: r["launches"] for r in serving}
    rows = []

    # paged attention, layer 0 of the captured step
    q, k, v, pp, bt, pos = step["paged_attention"]
    B, H, hd = q.shape
    KV, ps = k.shape[1], k.shape[2]
    claimed = bt[bt >= 0].long()
    kpos = pp[claimed]                                   # (n_claimed, ps)
    row_of = (bt >= 0).nonzero()[:, 0]
    n_valid = int(((kpos >= 0) & (kpos <= pos[row_of][:, None])).sum())
    esz = q.element_size()
    nbytes = (2 * q.numel() * esz + 2 * claimed.numel() * KV * ps * hd * esz
              + claimed.numel() * ps * 4 + bt.numel() * 4 + pos.numel() * 4)
    ops_n = 4 * (H // KV) * KV * hd * n_valid
    b_ms, b_by = bound(nbytes, ops_n, "bfloat16")
    kd, vd, kp = paged_kv_for_attn({"k": k, "v": v, "pos": pp}, bt)
    mask = ((kp >= 0) & (kp <= pos[:, None]))[:, None, None, :]
    qs = q[:, :, None, :]
    rows.append({
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged.py:107",
        "path": "bgmv", "launches": launches["bgmv"]["paged_attention"],
        "max_abs_err": errs["paged_attention"],
        "ms": time_ms(torch, lambda: paged_attention(q, k, v, pp, bt, pos),
                      flush),
        "plain_ms": time_ms(torch, lambda: ref.paged_attention_ref(
            q, k, v, pp, bt, pos), flush, n=20),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, kd, vd, attn_mask=mask), flush),
        "bytes": nbytes, "shape": {"B": B, "H": H, "KV": KV, "hd": hd,
                                   "ps": ps, "W": bt.shape[1],
                                   "claimed_pages": int(claimed.numel()),
                                   "valid_slots": n_valid}})

    # LoRA shrink / expand, layer 0 target q of the captured step
    (x, a, b, idx, *_), _ = step["lora_delta"]
    ranks = step["pool_ranks"]
    r_max, d_in, d_out = a.shape[-1], a.shape[1], b.shape[-1]
    nrows = x.shape[0]
    safe = idx.clamp(min=0).long()
    a_g, b_g = a[safe], b[safe]
    for mode, live, src_line in (
            ("bgmv", ref.bgmv_live(idx, r_max),
             ("src/repro/kernels/bgmv.py:86", "src/repro/kernels/bgmv.py:136")),
            ("mbgmv", ref.mbgmv_live(idx, ranks, 16),
             ("src/repro/kernels/mbgmv.py:69",
              "src/repro/kernels/mbgmv.py:141"))):
        adapted = idx >= 0
        slot_live = {}
        for s, lv in zip(idx[adapted].tolist(), live[adapted].tolist()):
            slot_live[s] = lv
        live_cols = sum(slot_live.values())
        row_live = int(live.sum())
        y = lora_shrink(x, a, idx, live)
        yd = y.to(x.dtype)
        e = x.element_size()
        s_bytes = (x.numel() * e + live_cols * d_in * e + 8 * nrows
                   + y.numel() * 4)
        s_ms, s_by = bound(s_bytes, 2 * d_in * row_live, "bfloat16")
        e_bytes = (yd.numel() * e + live_cols * d_out * e + 8 * nrows
                   + nrows * d_out * e)
        e_ms, e_by = bound(e_bytes, 2 * d_out * row_live, "bfloat16")
        common = {"route": "cuda", "source": "src/repro_torch/csrc/lora.cu",
                  "path": mode,
                  "shape": {"rows": nrows, "d_in": d_in, "d_out": d_out,
                            "r_max": r_max, "live_columns": row_live}}
        rows.append({
            "name": f"lora_shrink[{mode}]", "replaces": src_line[0],
            "launches": launches[mode]["lora_shrink"],
            "max_abs_err": errs["lora_shrink"],
            "ms": time_ms(torch, lambda: lora_shrink(x, a, idx, live), flush),
            "plain_ms": time_ms(torch, lambda: ref.lora_shrink_ref(
                x, a, idx, live), flush, n=20),
            "bound_ms": s_ms, "bound_by": s_by,
            "library_ms": time_ms(torch, lambda: torch.bmm(
                x[:, None, :], a_g), flush),
            "bytes": s_bytes, **common})
        rows.append({
            "name": f"lora_expand[{mode}]", "replaces": src_line[1],
            "launches": launches[mode]["lora_expand"],
            "max_abs_err": errs["lora_expand"],
            "ms": time_ms(torch, lambda: lora_expand(yd, b, idx, live), flush),
            "plain_ms": time_ms(torch, lambda: ref.lora_expand_ref(
                yd, b, idx, live), flush, n=20),
            "bound_ms": e_ms, "bound_by": e_by,
            "library_ms": time_ms(torch, lambda: torch.bmm(
                yd[:, None, :], b_g), flush),
            "bytes": e_bytes, **common})
    step["rank_sweep"] = rank_sweep(torch, a, b, x, flush)
    for r in rows:
        print(f"  {r['name']}: {r['ms'] * 1e3:.1f} us (bound "
              f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}), plain "
              f"{r['plain_ms'] * 1e3:.1f} us, library "
              f"{r['library_ms'] * 1e3:.1f} us, {r['launches']} launches",
              flush=True)
    return rows


def rank_sweep(torch, a, b, x, flush):
    """Does the LoRA kernels' time follow the live rank columns (MBGMV's
    sum-rank law)? Shrink and expand on layer 0's q adapters, every row
    with the same live width, one adapter slot per row modulo the slots."""
    from repro_torch.kernels.bgmv import lora_expand, lora_shrink
    out = []
    slots = a.shape[0]
    for nrows in (8, 64):
        xr = x[torch.arange(nrows, device="cuda") % x.shape[0]].contiguous()
        idx = (torch.arange(nrows, device="cuda") % slots).to(torch.int32)
        for live_w in (16, 32, 64):
            live = torch.full((nrows,), live_w, dtype=torch.int32,
                              device="cuda")
            yd = lora_shrink(xr, a, idx, live).to(xr.dtype)
            out.append({
                "rows": nrows, "live": live_w,
                "shrink_ms": time_ms(torch, lambda: lora_shrink(
                    xr, a, idx, live), flush),
                "expand_ms": time_ms(torch, lambda: lora_expand(
                    yd, b, idx, live), flush)})
            print(f"  rank sweep rows {nrows} live {live_w}: shrink "
                  f"{out[-1]['shrink_ms'] * 1e3:.1f} us, expand "
                  f"{out[-1]['expand_ms'] * 1e3:.1f} us", flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
