#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. print the card's name and power limit (and the host's
     os.cpu_count()); build the CUDA kernels from
     src/repro_torch/csrc with nvcc (sm_90a) and print the build time and
     each kernel's registers, static shared memory and spills (ptxas);
  2. hold each kernel against its plain PyTorch version on the card:
     llama2-7b shapes in bf16 and smoke shapes in f32, with unclaimed
     pages, pos = 0 rows, a row with no claimed page, claimed-but-empty
     pages, GQA groups 1/4/8, paged attention in one block a row (llama2-
     7b's 8 x 32) and with each row's table split over blocks (a 3,000-
     token row beside short ones at yi-9b's 8 x 4, 2,400-2,500-token rows
     at groups 1, 6 and 8; mistral-large's group 12 at hd 128 in one split
     and in many, dbrx/grok's group 6), NaN in every page a row does not
     own (llama2-7b, yi-9b and mistral-large shapes), idx = -1
     rows and ranks 8/16/32/64 under BGMV and MBGMV, the shrink on both
     its paths (1 to 64 rows: the decode blocks by slot, with the expand
     of the f32 y rounded on load held bitwise to the expand of the cast
     y; prefill rows in runs of 1/17/
     32/64/4,096 per slot, a ragged last tile, whole tiles of idx -1 rows,
     and yi-9b's 32,768 rows: row tiles), the expand on both of its (1, 8
     and 64 rows: decode; 65 to 32,768 rows: row tiles), d_out 512 / 4,096
     and a ragged 136 (f32), r_max 48 and 24 on both paths of each,
     both at llama2-13b's d 5,120 and mistral-
     large's d 12,288 (d_out 12,288 and 1,024) and at mamba2's in_proj
     (768 -> 3,352) and out_proj (1,536 -> 768), decode and prefill rows,
     and at widths that are no multiple of 8 (d_in 4,100 -> d_out 1,000
     and 1,000 -> 4,100 on decode rows, 2,048 / 1,100 / 32,768 prefill
     rows; 131 -> 37 in f32), every kernel repeatable bitwise; paged
     attention at MQA groups (32 at hd 128, and 71 at hd 64 with long
     rows and splits, NaN in foreign pages at group 32: the group kernel
     in bf16, group tiles of the lane kernel in f32) and at hd 80, 100
     and 12 (bf16 and f32); flash attention at
     yi-9b's long prompt (bf16, B 2, H 32 over KV 4, hd 128, L 4096,
     causal), at llama2-7b's (H = KV = 32, L 256), llama2-13b's (H = KV =
     40), mistral-large's (96 over 8) and dbrx/grok's (48 over 8), all on
     (B, L, H, hd)
     views as the model passes them, in bf16 at hd 32/64/128 with Lq !=
     Lk, lengths no multiple of the 128-key tile, windows, causal=False
     and GQA groups 1/4/8, and at smoke shapes in f32 (non-causal,
     window, Lq != Lk, ragged L, GQA groups 1/2/8); at hd 96
     (phi-3-vision: H 32 MHA, L 576 + 256, and ragged) and hd 256
     (recurrentgemma: H 10 over 1, L 3,000 with window 2,048, and ragged)
     and whisper's cross-attention (hd 64, 64 queries over 1,500 keys,
     non-causal), in bf16 and f32; and at head dims with no
     instantiation of their own (80, 72, 100, 160, 200: causal and
     windowed, Lq != Lk, views, bf16 and f32);
  3a. serve full-width llama2-7b (32 layers, d_model 4096, bf16, seeded
     random weights on the card) through `InferenceServer`: 16 requests
     with kernel="bgmv", then 6 with kernel="mbgmv"; every request must
     finish with its tokens and every kernel's launch count must move
     (flash attention: once per layer of every prefill call). Prints
     prefill and decode times taken with CUDA events around the backend's
     calls, with no synchronization added (the host runs ahead of the card
     as in service), and the run's wall time;
  4a. one llama2-7b decode step's logits through the kernels vs through
     the plain versions, on the card, and its profile;
  5a. per-kernel timing at the decode shapes of phase 4a (CUDA events, L2
     flushed between launches) beside its bound, the plain version and a
     PyTorch library call (paged attention is also timed at yi-9b's
     decode shape after phase 5b: layer 0 of the first decode step of
     phase 3b's monolithic arm, a row at pos >= 2,048); the decode LoRA
     kernels and their `torch.bmm` also as a graphed step launches them
     (`graph_ms`: launches replayed from one CUDA graph); flash attention
     at layer 0 of the largest prefill call phase 3a served (llama2-7b's
     largest bucket), with its launches a call;
  3d. on the same llama2-7b weights, a cluster (`core.cluster.Cluster`) of
     two servers sharing the weights, each with its own page and adapter
     pools, behind the router, 24 requests of 32-256 prompt tokens and 32
     new tokens, in four arms: (a) the rank-aware router (Algorithm 1)
     over kernel="bgmv", (b) over "mbgmv", (c) MOSTIDLE over "bgmv", (d)
     arm (a) with server 1 crashed mid-decode and restarted. Every request
     finishes, (a)-(c) use both servers, (d) recovers the crashed
     server's live requests on the survivor; prints routes, decode
     tokens/s over both servers, wall time, peak memory and the simulated
     SLO attainment, TTFT and TPT;
  3e. the performance model on the card (paper Fig 9): phase 4a's decode
     step, 32 timed steps per kernel law with 1-8 of the 8 rows carrying
     adapters of random ranks; alpha, beta and R^2 of Perf_BGMV = alpha
     |S| max r + beta and Perf_MBGMV = alpha sum r + beta, beside the
     analytic model on the H100's constants;
  3c. on the same llama2-7b weights, 12 requests of 32-480 prompt tokens
     and 64 new tokens (three wrap the 512-slot ring) in four arms: (iv)
     the paged plane, greedy (the yardstick); (i) memory="dense" with
     bf16 KV, bgmv, then mbgmv on 6 of the requests; (ii) the same with
     int8 KV; (iii) pipeline="perstep" on the bf16 dense plane, 6
     requests; then (iv) temperature 0.8 on the paged plane, 6 requests
     of 32 new tokens, twice with one seed and once with another. Every
     arm finishes its requests and launches the LoRA and flash kernels;
     paged attention launches in arm (iv) only; one seed repeats its
     streams and another differs;
  4c. one decode step's logits after one prefill of 8 rows of 32-480
     tokens, over the same row caches in a dense bf16 slab, an int8 slab
     and the paged pool: paged vs dense bf16 within 5e-2 and int8 vs bf16
     within 0.08 of max |logit|;
  D. the compiled decode step on the same llama2-7b weights (every
     served phase, 3a-3d, S5, F and G, runs decode and megastep[K=k] as
     CUDA graphs, `core.graphs`, and checks that some graph replayed and
     none was re-captured): D1 phase 3a's bgmv and mbgmv requests and
     phase 3c's dense bf16 and int8 arms served again with graphs=False,
     greedy tokens and launch counts equal to the graphed runs'; D2 phase
     3c's temperature-0.8 arm (seed 0) eagerly, whether its streams equal
     the graphed ones; D3 RetraceSan (sanitizers forced on): a steady
     replay of a served schedule is clean, a LoRA pool leaf rebound after
     steady state raises; D4 decode ms a call graphed vs eager, one
     profiled decode and megastep[K=8] call of each arm, the syncs of
     each call (none outside a capture), each graph's capture time and
     the graph pool's bytes;
  P. the compiled prefill and chunk steps (since PR 23 every served
     phase runs its prefill buckets of at most 4,096 tokens, and every
     chunk, as CUDA graphs too; larger buckets run eagerly, counted): P1
     on the llama2-7b weights, phase 3a's bgmv and mbgmv requests served
     three times on one server, graphed and with graphs=False: tokens
     and launch counts equal, every prefill key built once, every one
     called twice or more replayed, the median prefill ms of each arm
     over all calls and over the calls that replayed (each call is the
     same call in both arms: the schedule is simulated); P2 after phase
     5b on the yi-9b weights, phase 3b's chunk_budget=512 arm with
     graphs=False against 3b's graphed one (tokens, launches, median
     chunk ms), the monolithic arm's buckets past the cap counted as
     eager, and its requests served twice with the cap lifted (the graph
     pool's bytes without the cap); P3 in phase G, mamba2-130m and
     phi-3-vision served twice, graphed and with graphs=False (tokens,
     launches, median prefill ms); P4 one profiled graphed and eager
     call of a llama2-7b prefill (8 x 256), a yi-9b chunk (512 tokens)
     and a mamba2 prefill: device
     ms, wall ms, idle share, the syncs of every call (none outside a
     capture), each key's capture seconds and the pool's bytes;
  T. training on the same llama2-7b weights. T1: each kernel autograd
     Function's gradients against autograd through the plain versions on
     the card, per output row with phase 2's rule, a second backward
     bitwise equal: flash dq / dk / dv on (B, L, H, hd) views at llama2-
     7b's B 2 x L 512, yi-9b's 1 x 4,096 (32 heads over 4), a window of
     256, a ragged L 777 (bf16) and at smoke shapes in f32; the LoRA
     delta's dx / dA / dB at 4,096 rows x d 4,096, r_max 64 (bgmv and
     mbgmv live widths, idx -1 rows; bf16) and at r_max 48 (f32). T2:
     LoRA training of full-width llama2-7b (all 32 layers, bf16, rank 64
     on q/k/v, `packed_batches` at 8 x 512, seed 0) through the training
     launcher's `Trainer` and `run`: (a) one step's loss within 1e-2 and
     every adapter gradient, per layer and target, within 5e-2 of its
     max |plain|, kernels vs plain versions, at an adapter with a seeded
     nonzero B; (b) 3 steps on one fixed batch at the launcher's lr
     (1e-3): the loss must fall; (c) 10 steps on fresh batches: ms/step (CUDA events), tokens/s,
     peak memory and each kernel's launches (flash and the LoRA pair must
     launch, paged attention must not); (d) a checkpoint of the adapter
     and optimizer state loads back bitwise; one step profiled (device
     time, idle share, the flash forward, the flash backward's range, the
     LoRA kernels, the GEMMs); the flash forward and the LoRA pair timed
     at the step's shapes. T3: full fine-tuning of llama2-7b cut to 4 of
     32 layers at full width (1.07 B parameters), one step's loss and
     every parameter gradient held to the plain path as in T2(a), then 5
     steps with accum 2 at 8 x 512, losses finite. Every `Trainer`
     step runs as a CUDA graph (key `train`) since PR 23. T4: T2(c)'s ten
     steps and T3's five run again with graphs=False from the same init
     on the same batches: each step's loss within 1e-2, each trained
     leaf within 5e-2 of its max after the last step; the median ms a
     step of each arm from step 3 (the graphed arm's first two are its
     warm-up and capture), peak memory, the graph pool's bytes; then
     llama2-7b is freed;
  3b. serve full-width yi-9b (48 layers, 32 heads over 4 KV heads, bf16,
     seeded random weights): 8 requests, three of 2,049-4,000 prompt
     tokens and five of 32-256, 16 new tokens each, in two arms on the same
     requests: monolithic prefill (chunk_budget=0) and chunked prefill
     (chunk_budget=512); every request finishes in both arms;
  4b. yi-9b prefill logits (B 2, one 3,000-token prompt per row) through
     the flash kernel vs the plain attention, and a profile of one prefill
     call at the serving shape (8 rows x 4,096 tokens, LoRA on);
  5b. flash attention timed at the shape of layer 0 of the largest
     captured yi-9b prefill call, as the other kernels are, and the LoRA
     shrink and expand at layer 0 of phase 4b's prefill call (32,768
     rows); then yi-9b is freed;
  A. the bf16 yi-9b arms of phase 3b settled in float32: full-width yi-9b
     in f32 (seeded as in 3b), phase 3b's requests through the monolithic
     (f32 flash kernel) and chunk_budget=512 arms; their tokens must
     agree, or, where they part, the top-2 logit margin there must lie
     below the flash-vs-plain logit difference (a near-tie, printed);
  F. the rest of the decoder family at full width, one config at a time
     (seeded bf16 weights on the card, each freed before the next):
     llama2-13b whole (40 layers), llama2-70b (24 of 80 layers), qwen2-
     72b (22 of 80, q/k/v bias), command-r-35b (24 of 40), mistral-large-
     123b (15 of 88, GQA group 12), dbrx-132b (6 of 40, 16 experts top-4)
     and grok-1-314b (4 of 64, 8 experts top-2, GeGLU): 8 requests of
     32-256 prompt tokens and 16 new tokens each under kernel="bgmv"
     (also "mbgmv" on llama2-13b and dbrx-132b), every kernel launched
     (paged attention at groups 12 and 6 included, flash on every
     prefill), then one decode step's logits through the kernels vs the
     plain versions within 5e-2 of max |logit| on every row; on the MoE
     configs the plain pass replays the kernel pass's expert choices, so
     the drops are equal layer by layer (checked) and the rows whose
     plain router alone would have chosen otherwise (near-ties) are
     printed; the llama2-13b and dbrx decode steps are profiled; paged
     attention is timed at layer 0 of mistral-large's first decode step
     (phase 5a's row);
  G. the non-decoder families at full width and full depth, one at a
     time (seeded bf16 weights, each freed before the next): mamba2-130m
     (SSM) and recurrentgemma-2b (hybrid) served on the dense plane,
     phi-3-vision-4.2b (VLM, text-only requests) on the paged plane, 8
     requests of 32-256 prompt tokens and 16 new each under "bgmv"
     (mamba2 also "mbgmv"), every request finishing and every kernel of
     the path launching; then a 2-row prefill (recurrentgemma: 3,000
     tokens, past its window; phi-3-vision: after 576 seeded patch
     embeddings) and one decode step through the kernels vs the plain
     versions within 5e-2 of max |logit| on every row (recurrentgemma's
     step profiled); whisper-tiny through model.prefill / model.decode
     (4 rows, seeded frame embeddings (4, 1,500, 384), 16 greedy tokens,
     LoRA q/k/v) held to the same rule at every step; flash is timed at
     hd 96 and 256 at layer 0 of phi-3-vision's and recurrentgemma's
     largest served prefill (phase 5b's rows);
  K. shapes past the registered configs (`shapes_phase`): llama2-7b
     with n_kv_heads=1 (K1: MQA, group 32 at hd 128) and with head_dim=80
     (K2), whole, and with falcon-7b's 71 heads of 64 over one KV head on
     a d_model of 4,100 (K3, 4 layers); each served graphed and with
     graphs=False (8 requests of 32-256 prompt tokens, 32 new, bgmv, 8
     adapters of ranks 8-64): every request finishes, the paged, flash
     and LoRA kernels launch, graphed = eager tokens and launches; one
     decode step's logits and a 2-row prefill's and decode step's through
     the kernels vs the plain versions within 5e-2 of max |logit|; paged
     attention timed at K1's and K3's decode (the group kernel), flash at
     K2's
     largest prefill (hd 80, run at width 96), the LoRA shrink at K3's
     decode (d_in 4,100), each beside SDPA / torch.bmm;
  M. the multi-device plane, in a process of its own (`--phase-m`): M1
     an NCCL group of one rank (a FileStore in a temporary directory) and
     a 1 x 1 ("data", "model") DeviceMesh on the card; M2 `moe_apply_ep`
     against `moe_apply` for one full-width layer of dbrx-132b (16
     experts top-4) and grok-1-314b (8 top-2, GeGLU) in f32, 4,096
     tokens, no expert over its capacity (checked): each output row
     within 1e-5 x max(1, its max |plain|), each weight gradient within
     1e-4 of its leaf's max; M3 dbrx-132b at full width, 6 of 40 layers,
     `moe_ep` under the mesh against the same weights without it: an
     8 x 512 packed prefill (mbgmv pool) and one decode step, logits
     within 5e-2 of max |logit|, a 2 x 512 LoRA loss within 1e-2 and
     its cross-entropy's adapter gradients within 5e-2 of their max, no
     drop, flash and the LoRA kernels launched under the mesh; M4 the
     port's dry run (`launch/dryrun.py`) of whisper-tiny decode_32k and
     dbrx / grok `moe_ep` decode_32k on pod16x16 in a subprocess within
     300 s (their train_4k, 55-85 s of host work each, is left to
     tests/test_torch_dryrun.py and the CLI), every record ok, its peak bytes a chip,
     fits_80g and dominant roofline term printed;
  then one {"kernels": [...]} line (the six TPU kernels' rows, the
  prefill shrink and expand rows, the yi-9b and mistral-large paged
  rows, the hd 96 / hd 256 flash rows, the llama2-7b serving-prefill
  flash row, phase T's rows at the training
  step's shapes and phase K's MQA, G 71, hd 80 and LoRA-tail rows) and
  the last line
  {"ok": true, "device": {...}}.

Tolerances (kernel vs plain version on the same inputs), per output row b
(per query row (b, h, i) for attention): bf16 max|kernel[b] - plain[b]|
<= 1e-2 * max|plain[b]|; f32 <= 1e-5 * max(1, max|plain[b]|).
Decode-step and prefill logits: max|kernels - plain| <= 5e-2 * max|plain|.
Training (phase T): the loss within 1e-2 * |plain|, each gradient leaf
within 5e-2 * max|plain| of that leaf.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
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


def smi_reading():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


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
    smi = smi_reading()
    # the card host's cores: the timeline model's cpu_cores
    # (repro_torch.core.timing.CARD_HOST_CORES)
    print(f"{smi}; host os.cpu_count() = {os.cpu_count()}", flush=True)

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    built = "found" if build.build_seconds is None \
        else f"nvcc {build.build_seconds:.1f} s"
    print(f"kernels ready in {time.perf_counter() - t0:.1f} s ({built}) -> "
          f"{build.library_path().name}", flush=True)
    print_build_info(build.build_log)

    errs = kernel_checks(torch)
    tooling = kernel_tooling_phase(torch)
    from repro_torch.configs.base import get_config
    llama = get_config("llama2-7b")
    llama_capture = {}
    with capture_largest_attention(llama_capture):
        serving, params = serve_phase(torch, llama, LLAMA_RUNS, "3a")
    tooling.update(sanitized_serving_phase(torch, llama, params))
    step = logits_phase(torch, llama, params)
    kernels = timing_phase(torch, step, errs, serving)
    kernels.append(flash_timing(
        torch, llama_capture.pop("args"), errs["flash_attention"], serving,
        name="flash_attention[llama2-7b serving prefill]",
        path="llama2-7b serving prefill"))
    report = {"serving": serving, "decode_logits": step["logits"],
              "decode_profile": step["profile"],
              "lora_rank_sweep": step["rank_sweep"], "tooling": tooling}
    report["cluster"] = cluster_phase(torch, llama, params)
    report["perf_model_fit"] = perf_model_phase(torch, llama, step)
    report["dense_serving"] = dense_phase(torch, llama, params)
    report["dense_logits"] = dense_logits_phase(torch, llama, params)
    report["graphs"] = graphs_phase(torch, llama, params, serving,
                                    report["dense_serving"])
    report["prefill_graphs"] = prefill_graphs_phase(torch, llama, params)
    report["training"], train_kernel_rows = training_phase(torch, llama,
                                                           params)
    kernels.extend(train_kernel_rows)
    del step, params
    gc.collect()
    torch.cuda.empty_cache()

    yi = get_config("yi-9b")
    capture = {}
    with capture_largest_attention(capture), capture_first_decode(capture):
        yi_serving, yi_params = serve_phase(torch, yi, YI_RUNS, "3b")
    report["yi_serving"] = yi_serving
    report["yi_arms_agree"] = arms_agree(yi_serving)
    prefill = prefill_phase(torch, yi, yi_params)
    lora_args = prefill.pop("prefill_lora")
    report.update(prefill)
    kernels.append(flash_timing(torch, capture["args"],
                                errs["flash_attention"], yi_serving))
    kernels.append(shrink_prefill_timing(torch, lora_args, yi_serving))
    kernels.append(chunk_shrink_timing(torch, lora_args, yi_serving))
    kernels.extend(chunk_expand_timing(torch, lora_args, yi_serving))
    kernels.append(expand_prefill_timing(torch, lora_args, yi_serving))
    kernels.append(paged_capture_timing(
        torch, capture["decode"], yi_serving, "paged_attention[yi-9b]",
        "yi-9b decode", min_pos=YI_LONG_POS))
    report["chunk_graphs"] = chunk_graphs_phase(torch, yi, yi_params,
                                                yi_serving)
    chunk_launches(kernels, report["chunk_graphs"]["p4"])
    del yi_params, capture, lora_args
    gc.collect()
    torch.cuda.empty_cache()
    report["yi_f32_arms"] = f32_arms_phase(torch, yi)
    report["families"], mistral_row = family_phase(torch)
    kernels.append(mistral_row)
    report["other_families"], g_rows = other_families_phase(torch, errs)
    kernels.extend(g_rows)
    report["shapes"], k_rows = shapes_phase(torch, errs)
    kernels.extend(k_rows)
    report["multi_device"] = multi_device_phase(torch)
    print(json.dumps(report), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


KERNEL_NAMES = ("flash_bf16", "flash_f32", "lora_shrink_tile",
                "lora_shrink_wgmma", "lora_shrink_decode", "lora_expand_tile",
                "lora_expand_wgmma", "lora_expand_decode",
                "paged_attention", "paged_combine", "paged_group",
                "paged_group_combine")


def print_build_info(log):
    """Registers, static shared memory and spills of each kernel, from
    nvcc's `-Xptxas -v` report of the library's build."""
    import re
    if not log:
        print("  (no ptxas report)", flush=True)
        return
    name, spill = None, "spills ?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(" + "|".join(KERNEL_NAMES) + r")_kernelI(\w*?)EE",
                          m.group(1))
            args = "" if k is None else k.group(2).replace(
                "13__nv_bfloat16", "bf16,").replace("Li", "")
            args = re.sub(r"^f", "f32,", args).replace("E", ",").strip(",")
            name = f"{k.group(1)}<{args}>" if k else m.group(1)[:60]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"spills {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers.*?(?:, (\d+) bytes smem)?$",
                      line)
        if m and name:
            print(f"  ptxas {name}: {m.group(1)} registers, static smem "
                  f"{m.group(2) or 0} B, {spill}", flush=True)
            name, spill = None, "spills ?"


# ------------------------------------------------------------ phase 2 ----

def check_close(name, got, want, dtype, share=False):
    """Each row b (leading axis) is held to its own scale: max|got[b] -
    want[b]| <= tol * max|want[b]| in bf16, <= tol * max(1, max|want[b]|)
    in f32. A row whose plain output is all zero must come out exactly
    zero. Returns the largest absolute error over all rows (with `share`,
    also the largest share of a row's limit)."""
    import torch
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
    if not g.numel():
        return (0.0, 0.0) if share else 0.0
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
    return (float(err.max()), float(ratio.max())) if share \
        else float(err.max())


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
    from repro_torch.kernels.bgmv import lora_expand, lora_shrink, padded_rank
    from repro_torch.kernels.ops import lora_live
    from repro_torch.kernels.paged import paged_attention
    print("phase 2: kernels vs plain versions on the card", flush=True)
    rng = np.random.default_rng(SEED)
    worst = {"paged_attention": 0.0, "lora_shrink": 0.0,
             "lora_expand": 0.0, "flash_attention": 0.0,
             "flash_attention[hd 96]": 0.0, "flash_attention[hd 256]": 0.0,
             "flash_attention[hd 80]": 0.0}

    def note(name, err, full):
        if full:
            worst[name] = max(worst[name], err)

    # paged attention: (label, B, H, KV, hd, ps, W, P, dtype, full-width,
    # context lengths or None for random ones). B x KV < the SM count
    # splits each row's table over blocks (kernels/paged.py: split_plan):
    # llama2-7b's 8 x 32 takes one split, the others several
    bf, f32 = torch.bfloat16, torch.float32
    yi_ctx = [0, 1, 3000, 2100, 40, 100, 200, 37]
    cases = [("llama2-7b bf16", 8, 32, 32, 128, 32, 16, 176, bf, True, None),
             ("GQA 4 bf16", 8, 32, 8, 128, 32, 16, 176, bf, True, None),
             ("yi-9b long rows GQA 8 bf16", 8, 32, 4, 128, 32, 128, 200, bf,
              True, yi_ctx),
             ("mistral-large GQA 12 one split bf16", 8, 96, 8, 128, 32, 4,
              40, bf, True, None),
             ("mistral-large GQA 12 long rows bf16", 8, 96, 8, 128, 32, 128,
              200, bf, True, yi_ctx),
             ("dbrx/grok GQA 6 bf16", 8, 48, 8, 128, 32, 16, 176, bf, True,
              None),
             ("GQA 6 long row splits f32", 3, 12, 2, 128, 32, 96, 100, f32,
              False, [0, 2500, 9]),
             ("MHA long row splits bf16", 3, 4, 4, 128, 32, 96, 100, bf,
              False, [0, 2500, 9]),
             ("smoke f32", 4, 4, 4, 32, 32, 2, 10, f32, False, None),
             ("GQA 2 ps 8 f32", 4, 4, 2, 32, 8, 5, 24, f32, False, None),
             ("GQA 4 hd 16 f32", 4, 8, 2, 16, 8, 5, 24, f32, False, None),
             ("GQA 8 long row splits f32", 3, 8, 1, 64, 16, 160, 170, f32,
              False, [0, 2400, 30]),
             # MQA at group 32 (hd 128) and 71 (hd 64, falcon-7b's) with
             # long rows and splits: the group kernel in bf16, group tiles
             # of the lane kernel in f32 (2 at group 32); head dims that
             # are no multiple of 8 (element copies into padded ring rows)
             # and hd 80
             ("MQA G 32 hd 128 bf16", 8, 32, 1, 128, 32, 16, 176, bf,
              True, None),
             ("MQA G 71 hd 64 long rows bf16", 8, 71, 1, 64, 32, 128, 200,
              bf, True, yi_ctx),
             ("MQA G 32 hd 128 long rows f32", 3, 32, 1, 128, 32, 96, 100,
              f32, False, [0, 2500, 9]),
             ("hd 80 GQA 4 bf16", 8, 32, 8, 80, 32, 16, 176, bf, False,
              None),
             ("hd 100 GQA 2 bf16", 8, 4, 2, 100, 32, 16, 176, bf, False,
              None),
             ("hd 100 GQA 2 long rows f32", 3, 4, 2, 100, 32, 96, 100, f32,
              False, [0, 2500, 9]),
             ("hd 12 GQA 4 f32", 4, 8, 2, 12, 8, 5, 24, f32, False, None),
             ("hd 12 GQA 4 long rows bf16", 3, 8, 2, 12, 16, 160, 170, bf,
              False, [0, 2400, 30])]
    for label, B, H, KV, hd, ps, W, P, dt, full, ctx in cases:
        cap = W * ps
        if ctx is None:
            ctx = [0, 1] + [int(rng.integers(2, cap + 1))
                            for _ in range(B - 2)]
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
        check(torch.equal(got, paged_attention(*args)),
              f"paged_attention {label}: two runs differ")
        if full and label.startswith(("llama2-7b", "yi-9b",
                                      "mistral-large", "MQA")):
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
    # dtype, full-width, seg). seg 0: slots drawn at random per row; seg T:
    # prefill's layout, runs of T rows per slot cycling through -1 and
    # every slot, so run boundaries fall inside row tiles, whole tiles
    # hold only idx -1 rows (T >= 64) and the last tile is ragged. Up to
    # 64 rows both kernels take their decode path (blocks by slot; the
    # shrink's d slices a cluster), above it row tiles (of 128 rows at
    # 32,768 rows: yi-9b's 8 x 4,096 prefill; the bf16 expand at d_out a
    # multiple of 8 on the persistent wgmma kernel). On every path the
    # expand of the shrink's f32 y (rounded as it is loaded, or cast by the
    # wrapper for the mma.sync row tiles) must equal the expand of y cast to
    # the pool's dtype bitwise.
    y8 = [8, 16, 32, 64] * 2
    lcases = [("decode 1 row bf16", 1, 4096, 4096, 64, y8, 16, bf, True, 0),
              ("decode bf16", 8, 4096, 4096, 64, y8, 16, bf, True, 0),
              ("65 rows runs of 1 d_out 512 bf16", 65, 4096, 512, 64, y8, 16,
               bf, True, 1),
              ("prefill 4133 rows runs of 4096 bf16", 4096 + 37, 4096, 4096,
               64, y8, 16, bf, True, 4096),
              ("64 rows bf16", 64, 4096, 4096, 64, y8, 16, bf, True, 0),
              ("32 rows runs of 5 bf16", 32, 4096, 4096, 64, y8, 16, bf,
               True, 5),
              ("64 rows runs of 17 bf16", 64, 4096, 4096, 64, y8, 16, bf,
               True, 17),
              ("prefill 1024 rows bf16", 1024, 4096, 4096, 64, y8, 16, bf,
               True, 0),
              *[(f"prefill runs of {T} bf16", 5 * max(T, 64) + 77, 4096,
                 4096, 64, y8, 16, bf, True, T) for T in (1, 17, 32, 64)],
              ("prefill runs of 4096 bf16", 2 * 4096 + 77, 4096, 4096, 64,
               y8, 16, bf, True, 4096),
              ("yi-9b prefill 32768 rows bf16", 32768, 4096, 512, 64, y8,
               16, bf, True, 4096),
              ("llama2-13b decode d 5120 bf16", 8, 5120, 5120, 64, y8, 16,
               bf, True, 0),
              ("llama2-13b prefill 2048 rows d 5120 bf16", 2048, 5120, 5120,
               64, y8, 16, bf, True, 256),
              ("mistral-large decode d 12288 bf16", 8, 12288, 12288, 64, y8,
               16, bf, True, 0),
              ("mistral-large decode d_in 12288 d_out 1024 bf16", 8, 12288,
               1024, 64, y8, 16, bf, True, 0),
              ("mistral-large prefill 2048 rows d 12288 bf16", 2048, 12288,
               12288, 64, y8, 16, bf, True, 256),
              ("mistral-large prefill 2048 rows d_out 1024 bf16", 2048,
               12288, 1024, 64, y8, 16, bf, True, 256),
              # mamba2's in_proj (d 768 -> 3,352: a ragged last column
              # block) and out_proj (1,536 -> 768), decode and prefill
              ("mamba2 in_proj decode bf16", 8, 768, 3352, 64, y8, 16, bf,
               True, 0),
              ("mamba2 out_proj decode bf16", 8, 1536, 768, 64, y8, 16, bf,
               True, 0),
              ("mamba2 in_proj prefill 2048 rows bf16", 2048, 768, 3352, 64,
               y8, 16, bf, True, 256),
              ("mamba2 out_proj prefill 2048 rows bf16", 2048, 1536, 768,
               64, y8, 16, bf, True, 256),
              # r_max a multiple of 8 that is no power-of-two multiple
              # of it (the decode shrink's last column group: 16 or 24)
              ("r_max 48 decode bf16", 8, 4096, 4096, 48,
               [48, 16, 33, 8] * 2, 16, bf, False, 0),
              ("r_max 48 prefill runs of 512 bf16", 2048 + 37, 4096, 4096,
               48, [48, 16, 33, 8] * 2, 16, bf, False, 512),
              ("r_max 24 decode bf16", 8, 4096, 1024, 24, [24, 8, 17, 5] * 2,
               8, bf, False, 0),
              ("r_max 24 prefill runs of 17 bf16", 1100, 4096, 1024, 24,
               [24, 8, 17, 5] * 2, 8, bf, False, 17),
              ("r_max 24 decode f32", 8, 128, 136, 24, [24, 3, 9, 1], 8, f32,
               False, 0),
              # MBGMV rank blocks of 4: live widths that end inside an
              # 8-column group (the wgmma expand zeroes B's group past
              # them in shared memory and masks y past each row's width)
              ("rank blocks of 4 prefill runs of 17 bf16", 1100, 4096, 1024,
               24, [24, 4, 20, 12] * 2, 4, bf, False, 17),
              # max_rank 12 and 20, no multiple of 8: the pool pads them
              # to 16 and 24 columns (bgmv.padded_rank), zero past each
              # rank; MBGMV's live width is clamped to the pool (20 at
              # rank_block 16 -> 32 -> 24), as `ops.lora_live` does
              *[(f"max_rank {m} {kind} bf16", rows, 4096, 4096,
                 padded_rank(m), [m, 5, m - 3, 8] * 2, 16, bf, False, seg)
                for m in (12, 20)
                for kind, rows, seg in (("decode", 8, 0),
                                        ("prefill runs of 17", 1100, 17))],
              ("smoke f32", 8, 128, 128, 8, [8, 3, 5, 1], 4, f32, False, 0),
              ("smoke prefill f32", 96, 128, 128, 8, [8, 3, 5, 1], 4, f32,
               False, 0),
              ("smoke prefill runs of 17 f32", 300, 128, 128, 8,
               [8, 3, 5, 1], 4, f32, False, 17),
              ("smoke decode d_out 136 f32", 8, 128, 136, 8, [8, 3, 5, 1],
               4, f32, False, 0),
              ("smoke prefill runs of 17 d_out 136 f32", 300, 128, 136, 8,
               [8, 3, 5, 1], 4, f32, False, 17),
              # tails: d_in (shrink) or d_out (expand) no multiple of 8, the
              # element-copy instantiations, on every launch path
              ("tail decode d_in 4100 d_out 1000 bf16", 8, 4100, 1000, 64,
               y8, 16, bf, True, 0),
              ("tail prefill 2048 rows d_in 4100 d_out 1000 bf16", 2048,
               4100, 1000, 64, y8, 16, bf, True, 256),
              ("tail decode d_in 1000 d_out 4100 bf16", 8, 1000, 4100, 64,
               y8, 16, bf, True, 0),
              ("tail prefill runs of 17 d_in 1000 d_out 4100 bf16", 1100,
               1000, 4100, 64, y8, 16, bf, True, 17),
              ("tail yi-9b prefill 32768 rows d_in 4100 bf16", 32768, 4100,
               1000, 64, y8, 16, bf, True, 4096),
              ("tail decode d_in 131 d_out 37 f32", 8, 131, 37, 24,
               [24, 3, 9, 1], 8, f32, False, 0),
              ("tail prefill runs of 17 d_in 131 d_out 37 f32", 300, 131, 37,
               24, [24, 3, 9, 1], 8, f32, False, 17)]
    for label, rows, d_in, d_out, r_max, ranks, rb, dt, full, seg in lcases:
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
        if seg:
            idx = torch.as_tensor(np.arange(rows) // seg % (slots + 1) - 1,
                                  dtype=torch.int32, device="cuda")
        else:
            idx = torch.as_tensor(rng.integers(-1, slots, rows),
                                  dtype=torch.int32, device="cuda")
            idx[0] = -1
        ranks_t = torch.as_tensor(ranks, dtype=torch.int32, device="cuda")
        for mode, live in (("bgmv", lora_live(idx, None, "bgmv", r_max)),
                           ("mbgmv", lora_live(idx, ranks_t, "mbgmv", r_max,
                                               rb))):
            y = lora_shrink(x, a, idx, live)
            note("lora_shrink", check_close(
                f"lora_shrink {mode} {label}", y,
                ref.lora_shrink_ref(x, a, idx, live), f32), full)
            dead = torch.arange(r_max, device="cuda")[None] >= live[:, None]
            check(bool((y[dead] == 0).all()), "shrink: dead columns != 0")
            check(torch.equal(y, lora_shrink(x, a, idx, live)),
                  "shrink: two runs differ (sums must repeat bitwise)")
            yd = y.to(dt)
            out = lora_expand(yd, b, idx, live)
            note("lora_expand", check_close(
                f"lora_expand {mode} {label}", out,
                ref.lora_expand_ref(yd, b, idx, live), dt), full)
            check(bool((out[idx < 0] == 0).all()), "expand: idx -1 row != 0")
            check(torch.equal(out, lora_expand(yd, b, idx, live)),
                  "expand: two runs differ (sums must repeat bitwise)")
            check(torch.equal(out, lora_expand(y, b, idx, live)),
                  f"expand {mode} {label}: f32 y rounded on load != "
                  "the expand of the cast y")

    # flash attention: (label, B, H, KV, Lq, Lk, hd, causal, window, dtype,
    # full-width); full-width and "view" cases are (B, L, H, hd) tensors
    # passed as their (B, H, L, hd) views, as the model passes them. The
    # bf16 kernel's K/V tiles are 128 keys: "ragged" lengths are no
    # multiple of that
    from repro_torch.kernels.flash import flash_attention
    fcases = [("yi-9b L 4096 bf16", 2, 32, 4, 4096, 4096, 128, True, None,
               bf, True),
              ("llama2-7b L 256 bf16", 8, 32, 32, 256, 256, 128, True, None,
               bf, True),
              ("llama2-13b H 40 MHA L 256 bf16", 8, 40, 40, 256, 256, 128,
               True, None, bf, True),
              ("mistral-large GQA 12 L 256 bf16", 8, 96, 8, 256, 256, 128,
               True, None, bf, True),
              ("dbrx/grok GQA 6 L 256 bf16", 8, 48, 8, 256, 256, 128, True,
               None, bf, True),
              ("GQA 8 window 128 ragged bf16", 2, 16, 2, 1000, 1000, 64,
               True, 128, bf, False),
              ("hd 32 GQA 1 Lq < Lk ragged view bf16", 2, 8, 8, 200, 333, 32,
               True, None, bf, False),
              ("hd 64 GQA 4 Lq > Lk non-causal view bf16", 2, 16, 4, 300,
               190, 64, False, None, bf, False),
              ("hd 128 GQA 8 window 100 non-causal ragged view bf16", 1, 16,
               2, 777, 777, 128, False, 100, bf, False),
              ("hd 32 GQA 4 window 64 ragged bf16", 2, 8, 2, 515, 515, 32,
               True, 64, bf, False),
              ("hd 128 GQA 1 Lq < Lk window 200 ragged view bf16", 1, 4, 4,
               129, 1100, 128, True, 200, bf, False),
              # the persistent walk with one work tile and a few: a single
              # query row, a window across two query tiles at MQA
              ("hd 128 one query B 1 L 1 view bf16", 1, 8, 8, 1, 1, 128,
               True, None, bf, False),
              ("hd 64 MQA 3 L 129 window 100 view bf16", 1, 3, 1, 129, 129,
               64, True, 100, bf, False),
              ("smoke non-causal f32", 2, 4, 4, 130, 130, 32, False, None,
               f32, False),
              ("smoke window 48 GQA 2 ragged f32", 2, 4, 2, 257, 257, 32,
               True, 48, f32, False),
              ("smoke Lq < Lk GQA 8 f32", 1, 8, 1, 96, 160, 64, True, None,
               f32, False),
              ("smoke Lq > Lk non-causal window GQA 2 f32", 1, 4, 2, 160, 96,
               16, False, 48, f32, False),
              # phi-3-vision (hd 96, MHA at H 32: 576 patches + 256
              # tokens), recurrentgemma (hd 256, H 10 over 1 KV head,
              # window 2,048 cutting a 3,000-token prompt), whisper's
              # cross-attention (hd 64, 64 queries over 1,500 frames)
              ("phi-3-vision hd 96 MHA L 832 bf16", 2, 32, 32, 832, 832, 96,
               True, None, bf, True),
              ("hd 96 MHA ragged view bf16", 2, 32, 32, 333, 333, 96, True,
               None, bf, False),
              ("recurrentgemma hd 256 MQA 10 L 3000 window 2048 bf16", 2,
               10, 1, 3000, 3000, 256, True, 2048, bf, True),
              ("hd 256 MQA 10 ragged view bf16", 2, 10, 1, 301, 301, 256,
               True, 2048, bf, False),
              ("hd 256 GQA 5 Lq < Lk window 100 non-causal view bf16", 1, 10,
               2, 129, 400, 256, False, 100, bf, False),
              ("whisper cross hd 64 Lq 64 Lk 1500 non-causal bf16", 4, 6, 6,
               64, 1500, 64, False, None, bf, True),
              ("hd 96 MHA ragged f32", 2, 32, 32, 200, 200, 96, True, None,
               f32, False),
              ("hd 256 MQA 10 window 100 ragged f32", 1, 10, 1, 300, 300,
               256, True, 100, f32, False),
              ("whisper cross hd 64 Lq 64 Lk 1500 non-causal f32", 2, 6, 6,
               64, 1500, 64, False, None, f32, False),
              # head dims with no instantiation of their own, run at the
              # next width (80, 72 -> 96; 100 -> 128 from a padded copy;
              # 160, 200 -> 256): phase K2's llama2-7b at hd 80 (32 x 80),
              # causal and windowed, Lq != Lk, views, bf16 and f32
              ("hd 80 MHA L 256 bf16", 8, 32, 32, 256, 256, 80, True, None,
               bf, True),
              ("hd 80 GQA 4 window 100 Lq < Lk ragged view bf16", 2, 16, 4,
               200, 333, 80, True, 100, bf, False),
              ("hd 72 GQA 2 Lq > Lk non-causal view bf16", 2, 8, 4, 300, 190,
               72, False, None, bf, False),
              ("hd 100 GQA 2 window 64 ragged view bf16", 2, 8, 4, 333, 333,
               100, True, 64, bf, False),
              ("hd 160 MQA 8 Lq < Lk view bf16", 1, 8, 1, 129, 400, 160, True,
               None, bf, False),
              ("hd 200 GQA 4 window 128 ragged view bf16", 1, 8, 2, 515, 515,
               200, True, 128, bf, False),
              ("hd 80 GQA 2 window 48 ragged f32", 2, 4, 2, 257, 257, 80,
               True, 48, f32, False),
              ("hd 72 Lq > Lk non-causal f32", 1, 4, 4, 160, 96, 72, False,
               None, f32, False),
              ("hd 100 Lq < Lk view f32", 1, 4, 4, 96, 160, 100, True, None,
               f32, False),
              ("hd 160 window 64 f32", 1, 4, 2, 200, 200, 160, True, 64, f32,
               False),
              ("hd 200 MQA 4 f32", 1, 4, 1, 130, 130, 200, True, None, f32,
               False)]
    for label, B, H, KV, Lq, Lk, hd, causal, window, dt, full in fcases:
        g = torch.Generator(device="cuda").manual_seed(Lq + H)
        q = torch.randn(B, Lq, H, hd, generator=g, device="cuda").to(dt)
        k = torch.randn(B, Lk, KV, hd, generator=g, device="cuda").to(dt)
        v = torch.randn(B, Lk, KV, hd, generator=g, device="cuda").to(dt)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        if not (full or "view" in label):
            q, k, v = (t.contiguous() for t in (q, k, v))
        got = flash_attention(q, k, v, causal=causal, window=window)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        # each query row (b, h, i) to its own limit: the first queries
        # attend a few keys (outputs ~3), late ones thousands (~0.05)
        note(f"flash_attention[hd {hd}]" if hd in (80, 96, 256)
             else "flash_attention", check_close(
                 f"flash_attention {label}", got.reshape(-1, hd),
                 want.reshape(-1, hd), dt), full)
        check(torch.equal(got, flash_attention(q, k, v, causal=causal,
                                               window=window)),
              f"flash_attention {label}: two runs differ")
        del q, k, v, got, want
    torch.cuda.synchronize()
    return worst


# ------------------------------------------------------------ phase 3 ----

ADAPTER_RANKS = (8, 16, 32, 64)
# (label, kernel, server kwargs, request kwargs)
LLAMA_RUNS = [("bgmv", "bgmv", {}, {"n": 16, "seed": SEED}),
              ("mbgmv", "mbgmv", {}, {"n": 6, "seed": SEED + 1})]
YI_LONG, YI_SHORT = (2049, 4001), (32, 257)
YI_REQUESTS = {"n": 8, "seed": SEED + 2, "lengths": "yi", "max_new": 16}
YI_SERVER = {"cache_slots": 4096}
YI_RUNS = [("chunk_budget=0", "bgmv", dict(YI_SERVER, chunk_budget=0),
            YI_REQUESTS),
           ("chunk_budget=512", "bgmv", dict(YI_SERVER, chunk_budget=512),
            YI_REQUESTS)]
# phase 3c: 12 requests of 32-480 prompt tokens and 64 new ones each
# (three pass the 512-slot ring), cache_slots 512 (make_server's default)
DENSE_LONG, DENSE_ANY = (449, 481), (32, 481)
DENSE_REQUESTS = {"n": 12, "seed": SEED + 3, "lengths": "dense",
                  "max_new": 64}
DENSE_HALF = dict(DENSE_REQUESTS, n=6)            # the first 6 of them
DENSE_TEMP = dict(DENSE_REQUESTS, n=6, max_new=32)
TEMPERATURE = 0.8
INT8_LOGIT_TOL = 0.08       # the reference's own int8 bound


def make_server(torch, cfg, kernel, params, cache_slots=512, seed=SEED,
                **kw):
    from repro_torch.core.engine import InferenceServer
    from repro_torch.core.lora import AdapterSpec
    srv = InferenceServer(cfg, mode="caraserve", kernel=kernel, max_batch=8,
                          cache_slots=cache_slots, page_size=32,
                          params=params, seed=seed, device="cuda", **kw)
    uids = []
    for r in ADAPTER_RANKS:
        for i in range(2):
            spec = AdapterSpec(f"lora-r{r}-{i}", r, cfg.name)
            srv.register_adapter(spec)
            uids.append(spec.uid)
    return srv, uids


def make_requests(cfg, uids, n, seed, spacing_ms=2.0, lengths=None,
                  max_new=32, slo_ms=None):
    """n requests over the adapters. Prompt lengths: 32-256 tokens, or,
    with lengths="yi", three long prompts of 2,049-4,000 tokens (requests
    0, 3 and 6, so the prefill bucket reaches 4,096) among short ones, or,
    with lengths="dense", 32-480 tokens with every fourth request (0, 4,
    8) at 449-480, so its positions pass 512 within 64 new tokens.
    `slo_ms` is each request's time-per-token SLO."""
    import numpy as np
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        lo, hi = YI_LONG if lengths == "yi" and i % 3 == 0 else YI_SHORT
        if lengths == "dense":
            lo, hi = DENSE_LONG if i % 4 == 0 else DENSE_ANY
        prompt = rng.integers(0, cfg.vocab, int(rng.integers(lo, hi)))
        out.append(Request(rid=i, adapter_uid=uids[i % len(uids)],
                           prompt=prompt.astype(np.int32),
                           max_new_tokens=max_new,
                           arrival_ms=spacing_ms * i, slo_tpt_ms=slo_ms))
    return out


def _counters():
    from repro_torch.kernels import bgmv, flash, paged
    return {"paged_attention": paged.paged_attention,
            "lora_shrink": bgmv.lora_shrink,
            "lora_expand": bgmv.lora_expand,
            "flash_attention": flash.flash_attention}


def time_backend_calls(torch, be, spans, decode_tokens):
    """Wrap a server's backend calls so each records a CUDA event on the
    stream at its start and its end into `spans` (by kind: prefill, chunk,
    decode), with no host synchronization added, tagged with what the
    call's step graph did (`capture`: captured and replayed once,
    `replay`, `capped`: eager by the prefill cap, `eager`: a key's warm-up
    or graphs off), and counts the decode tokens each decode or megastep
    call produces into decode_tokens[0]. Several servers may share one
    `spans`."""
    def counts():
        es = be.graphs.entries.values()
        return tuple(sum(getattr(e, n) for e in es)
                     for n in ("captures", "replays", "eager"))

    def timed(fn, kind, count):
        def run(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            before = counts()
            start.record()
            res = fn(*a, **kw)
            end.record()
            after = counts()
            tag = "capture" if after[0] > before[0] else \
                "replay" if after[1] > before[1] else \
                "capped" if after[2] > before[2] else "eager"
            spans[kind].append((start, end, tag))
            decode_tokens[0] += count(*a)
            return res
        return run

    be.prefill_admitted = timed(be.prefill_admitted, "prefill",
                                lambda states: 0)
    be.prefill_chunk = timed(be.prefill_chunk, "chunk", lambda *a: 0)
    be.decode = timed(be.decode, "decode", lambda ready, *a: len(ready))
    be.megastep = timed(be.megastep, "decode",
                        lambda ready, nsteps, *a: sum(nsteps))


def graph_check(be, label):
    """The backend's step graphs after a run (`core.graphs`): on the fused
    pipeline with graphs on, some key must have replayed and none may
    have been built twice (a buffer rebound); a key that built nothing
    ran eagerly by the prefill cap (counted); with graphs off (or the
    per-step pipeline), nothing may have been captured. Returns
    `StepGraphs.stats()`."""
    stats = be.graphs.stats()
    replays = sum(g["replays"] for g in stats.values())
    if be.graphs.capture and be.pipeline == "fused":
        check(replays > 0, f"{label}: the decode step never replayed a "
              "CUDA graph")
        check(all(g["builds"] == 1 or (g["builds"] == 0 and g["eager"])
                  for g in stats.values()),
              f"{label}: a step graph was re-captured: {stats}")
    else:
        check(replays == 0 and not any(g["captures"]
                                       for g in stats.values()),
              f"{label}: graphs off, yet captured: {stats}")
    return stats


def graph_summary(stats):
    if not any(g["captures"] for g in stats.values()):
        return "eager (no graph)"
    return "graphs " + ", ".join(
        f"{k} {g['replays']} replays"
        + (f" ({g['eager']} calls eager by the cap)" if g["eager"] else "")
        for k, g in stats.items())


def again(srv, reqs, rep):
    """`reqs` once more on `srv`: rids offset by 1,000 a repetition,
    arrivals shifted past the server's clock, so the schedule (and every
    prefill bucket and chunk width) repeats."""
    return [dataclasses.replace(r, rid=1000 * rep + r.rid,
                                arrival_ms=srv.clock + r.arrival_ms)
            for r in reqs]


def serve_phase(torch, cfg, runs, phase, params=None, repeat=1,
                graph_tokens=None):
    """Phase 3a/3b/3c: drive a path through InferenceServer, once per run,
    with every launch count zeroed just before and read just after: each
    kernel must have launched, except paged attention on the dense plane,
    which must not (dense decode attention is plain PyTorch by design).
    Prefill, prefill-chunk and decode times are the card's: a CUDA event
    is recorded on the stream at the start and end of each backend call,
    with no host synchronization added, so the host queues step N+1 while
    the card runs step N as it does in service; the spans are read after
    the run's one synchronize. A call's span runs from when the card
    reaches its first work (or the host records the start, if the card is
    idle) to when its last work ends, so host gaps inside a call count and
    gaps between calls do not; `wall_s` covers the whole run. Runs with
    the same request kwargs serve the same requests. `repeat`: serve them
    that many times on one server (`again`), so that every prefill bucket
    and chunk width is called again; `graph_tokens`: the backend's cap on
    the prefill buckets it graphs, where not the default."""
    import numpy as np
    print(f"phase {phase}: serving full-width {cfg.name} on the card",
          flush=True)
    out = []
    for label, kernel, server_kw, req_kw in runs:
        t_init = time.perf_counter()
        srv, uids = make_server(torch, cfg, kernel, params, **server_kw)
        params = srv.params
        reqs = make_requests(cfg, uids, **req_kw)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t_init
        be = srv.backend
        if graph_tokens is not None:
            be.graph_tokens = graph_tokens
        spans = {"prefill": [], "chunk": [], "decode": []}
        decode_tokens = [0]
        time_backend_calls(torch, be, spans, decode_tokens)
        counters = _counters()
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        srv.run(reqs)
        for rep in range(1, repeat):
            srv.run(again(srv, reqs, rep))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in counters.items()}
        times = {k: [s.elapsed_time(e) for s, e, _ in v]
                 for k, v in spans.items()}
        tags = {k: [t for *_, t in v] for k, v in spans.items()}
        for st in srv.states:
            check(len(st.generated) == st.req.max_new_tokens,
                  f"{label}: request {st.req.rid} produced "
                  f"{len(st.generated)} of {st.req.max_new_tokens} tokens")
            check(all(0 <= t < cfg.vocab for t in st.generated),
                  f"{label}: request {st.req.rid} token out of range")
        check(len(srv.states) == repeat * len(reqs),
              f"{label}: lost requests")
        n_attn = attention_layers(cfg)
        for n, c in launches.items():
            if n == "paged_attention" and srv.memory == "dense":
                check(c == 0, f"{label}: paged attention launched {c} "
                      "times on the dense plane")
            elif n != "flash_attention" or n_attn:
                check(c > 0, f"{label}: kernel {n} never launched on the "
                      "path")
        check(launches["flash_attention"] == n_attn * len(times["prefill"]),
              f"{label}: {launches['flash_attention']} flash launches for "
              f"{len(times['prefill'])} prefill calls of {n_attn} "
              "attention layers")
        stats = dict(be.transfer_stats)
        if server_kw.get("chunk_budget"):
            check(stats["prefill_chunks"] > 0, f"{label}: no prefill chunk")
        graphs = graph_check(be, label)
        tokens = sum(len(st.generated) for st in srv.states)
        rec = {"model": cfg.name, "run": label, "kernel": kernel,
               "memory": srv.memory, "pipeline": be.pipeline,
               "kv_cache_dtype": cfg.kv_cache_dtype or str(cfg.torch_dtype),
               "temperature": be.temperature,
               "requests": repeat * len(reqs), "tokens": tokens,
               "prompt_tokens": [int(st.req.prompt_len) for st in srv.states],
               "wall_s": wall, "setup_s": init_s,
               "prefill_calls": len(times["prefill"]),
               "prefill_ms": times["prefill"],
               "prefill_tags": tags["prefill"],
               "chunk_ms": times["chunk"], "chunk_tags": tags["chunk"],
               "prefill_ms_median": float(np.median(times["prefill"])),
               "prefill_ms_max": float(np.max(times["prefill"])),
               "chunk_calls": len(times["chunk"]),
               "chunk_ms_median": float(np.median(times["chunk"]))
               if times["chunk"] else None,
               "chunk_ms_total": float(sum(times["chunk"])),
               "decode_calls": len(times["decode"]),
               "decode_tokens": decode_tokens[0],
               "decode_ms": float(sum(times["decode"])),
               "decode_tok_s": 1e3 * decode_tokens[0]
               / sum(times["decode"]),
               "decode_call_ms_median": float(np.median(times["decode"])),
               "tok_s_wall": tokens / wall,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "launches": launches,
               "transfer_stats": stats, "graphs": graphs,
               "generated": {st.req.rid: list(map(int, st.generated))
                             for st in srv.states}}
        chunks = (f"; {rec['chunk_calls']} chunks, median "
                  f"{rec['chunk_ms_median']:.1f} ms"
                  if rec["chunk_calls"] else "")
        print(f"  {cfg.name} {label}: {rec['requests']} requests, {tokens} "
              f"tokens "
              f"in {wall:.2f} s wall ({rec['tok_s_wall']:.1f} tok/s); "
              f"prefill median {rec['prefill_ms_median']:.1f} ms over "
              f"{rec['prefill_calls']} calls{chunks}; decode "
              f"{rec['decode_tok_s']:.1f} tok/s, median "
              f"{rec['decode_call_ms_median']:.2f} ms a call; peak "
              f"{rec['peak_mem_gib']:.1f} GiB; launches {launches}; "
              f"{graph_summary(graphs)}", flush=True)
        out.append(rec)
        del srv, be
        gc.collect()
        torch.cuda.empty_cache()
    return out, params


def attention_layers(cfg):
    """Layers that run prefill attention: none in the SSM, the local-
    attention layers of the hybrid, every layer elsewhere."""
    if cfg.family == "ssm":
        return 0
    if cfg.hybrid:
        from repro_torch.models.transformer import hybrid_layer_kinds
        return hybrid_layer_kinds(cfg).count("attn")
    return cfg.n_layers


def arms_agree(records):
    """How many requests' tokens agree between the first two runs. Not
    required to be all: bf16 near-ties between the two numerics paths
    (flash vs plain chunk attention) can flip a greedy token (phase 4a)."""
    a, b = records[0]["generated"], records[1]["generated"]
    same = sum(a[r] == b[r] for r in a)
    print(f"  {records[0]['run']} vs {records[1]['run']}: tokens agree on "
          f"{same}/{len(a)} requests", flush=True)
    return {"requests": len(a), "agree": same}


def dense_phase(torch, cfg, params):
    """Phase 3c: full-width llama2-7b (the phase-3a weights) on the dense
    plane and the per-step pipeline, beside the paged plane, on the same
    requests (DENSE_REQUESTS). Arms: (iv) the paged plane, greedy on all
    12 requests: the yardstick; (i) memory="dense" with bf16 KV, bgmv on
    all 12, then mbgmv on the first 6; (ii) the same with int8 KV, which
    memory="auto" puts on the dense plane; (iii) pipeline="perstep" on the
    bf16 dense plane, 6 requests; (iv) temperature 0.8 on the paged plane,
    6 requests of 32 new tokens, twice with one seed and once with
    another. Each arm must finish every request and launch the LoRA and
    flash kernels; paged attention launches in arm (iv) only
    (`serve_phase`). The same-seed temperature runs must repeat and the
    other seed must differ. How many requests agree with the yardstick is
    reported, not required: bf16 near-ties can flip a greedy token."""
    temp = {"temperature": TEMPERATURE}
    bf16, _ = serve_phase(torch, cfg, [
        ("(iv) paged bgmv", "bgmv", {"memory": "paged"}, DENSE_REQUESTS),
        ("(i) dense bgmv", "bgmv", {"memory": "dense"}, DENSE_REQUESTS),
        ("(i) dense mbgmv", "mbgmv", {"memory": "dense"}, DENSE_HALF),
        ("(iii) perstep bgmv", "bgmv", {"pipeline": "perstep"}, DENSE_HALF),
        (f"(iv) paged T={TEMPERATURE} seed {SEED}", "bgmv", temp,
         DENSE_TEMP),
        (f"(iv) paged T={TEMPERATURE} seed {SEED} again", "bgmv", temp,
         DENSE_TEMP),
        (f"(iv) paged T={TEMPERATURE} seed {SEED + 1}", "bgmv",
         dict(temp, seed=SEED + 1), DENSE_TEMP)], "3c", params=params)
    int8, _ = serve_phase(
        torch, dataclasses.replace(cfg, kv_cache_dtype="int8"), [
            ("(ii) dense int8 bgmv", "bgmv", {}, DENSE_REQUESTS),
            ("(ii) dense int8 mbgmv", "mbgmv", {}, DENSE_HALF)], "3c",
        params=params)
    recs = bf16[:3] + int8 + bf16[3:]
    check(all(r["memory"] == "dense" for r in recs[1:6])
          and recs[3]["kv_cache_dtype"] == "int8"
          and recs[5]["pipeline"] == "perstep"
          and recs[0]["memory"] == recs[6]["memory"] == "paged",
          "phase 3c: an arm ran on the wrong plane")
    temp = [r["generated"] for r in recs[6:]]
    check(temp[0] == temp[1], "phase 3c: one seed gave two temperature "
          "streams")
    check(temp[0] != temp[2], "phase 3c: two seeds gave one temperature "
          "stream")
    yard = recs[0]["generated"]
    for r in recs[1:6]:
        # leading tokens each request shares with the yardstick: a bf16
        # near-tie flips one token and the streams part from there
        prefix = []
        for rid, toks in r["generated"].items():
            n = 0
            while n < len(toks) and toks[n] == yard[rid][n]:
                n += 1
            prefix.append(n)
        r["prefix_with_paged_greedy"] = prefix
        r["agree_with_paged_greedy"] = sum(
            n == len(yard[rid]) for rid, n in zip(r["generated"], prefix))
        print(f"  {r['run']}: decode {r['decode_tok_s']:.1f} tok/s, whole "
              f"run {r['tok_s_wall']:.1f} tok/s, peak "
              f"{r['peak_mem_gib']:.2f} GiB; tokens agree with the paged "
              f"greedy run on {r['agree_with_paged_greedy']}/"
              f"{r['requests']} requests (leading tokens shared: "
              f"{prefix})", flush=True)
    print(f"  temperature {TEMPERATURE}: seed {SEED} repeats, seed "
          f"{SEED + 1} differs", flush=True)
    return recs


def dense_logits_phase(torch, cfg, params):
    """Phase 4c: one decode step's logits over the same row caches on
    three planes. Prefill 8 rows of 32-480 tokens once (LoRA on, 8 stacked
    adapters), write the row caches into a dense bf16 slab, an int8 slab
    (quantized from the same caches) and the paged pool (16 pages a row,
    at random ids), then decode each row's greedy next token once on each.
    The paged step (the paged kernel) must agree with the dense bf16 step
    (plain attention) within LOGIT_TOL of max |logit|, and the int8 step
    with the bf16 step within INT8_LOGIT_TOL. Then a profile of the dense
    bf16 and int8 steps."""
    import numpy as np
    from repro_torch.models import layers, model as model_lib
    from repro_torch.serving import cache as cache_lib
    print("phase 4c: one decode step on the dense bf16, dense int8 and "
          "paged planes", flush=True)
    S, ps, B = 512, 32, 8
    rng = np.random.default_rng(SEED + 13)
    lens = rng.integers(*DENSE_ANY, B)
    toks = np.zeros((B, S), np.int64)
    for b, n in enumerate(lens):
        toks[b, :n] = rng.integers(0, cfg.vocab, n)
    srv, uids = make_server(torch, cfg, "bgmv", params)
    lora = srv.backend._lora_arg_stacked(uids)
    lora["mode"] = "bgmv"
    lens_d = torch.as_tensor(lens, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        logits, dense = model_lib.prefill(
            cfg, params, {"tokens": torch.as_tensor(toks, device="cuda")},
            lora=lora, cache_slots=S, last_pos=lens_d - 1)
        live = torch.arange(S, device="cuda")[None, None] \
            < lens_d[None, :, None]
        dense["pos"] = torch.where(live, dense["pos"], -1)
        quant = {"pos": dense["pos"].clone()}
        quant["k"], quant["k_scale"] = layers._quantize(dense["k"])
        quant["v"], quant["v_scale"] = layers._quantize(dense["v"])
        page_ids = rng.permutation(B * S // ps).reshape(B, S // ps)
        pool = cache_lib.zeros_paged(model_lib.cache_abstract(cfg, 1, S),
                                     B * S // ps, ps, "cuda")
        cache_lib.scatter_pages(pool, dense, page_ids)
        bt = torch.as_tensor(page_ids, dtype=torch.int32, device="cuda")
        tok = logits[:, 0].argmax(-1).to(torch.int32)[:, None]

        def step(c, cache, **kw):
            out, _ = model_lib.decode(c, params, cache, tok, lens_d,
                                      lora=lora, **kw)
            return out[:, -1].float()

        counters = _counters()
        n0 = counters["paged_attention"].launches
        lp = step(cfg, pool, block_table=bt)
        check(counters["paged_attention"].launches - n0 == cfg.n_layers,
              "phase 4c: the paged step did not run the paged kernel")
        ld = step(cfg, dense)
        c8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
        lq = step(c8, quant)
        # where a dense step's time goes; a repeated step rewrites the
        # same token into the same slot
        prof = {"dense_bf16": profile_step(
                    torch, lambda: step(cfg, dense),
                    "one llama2-7b decode step on the dense bf16 slab"),
                "dense_int8": profile_step(
                    torch, lambda: step(c8, quant),
                    "one llama2-7b decode step on the dense int8 slab")}
    torch.cuda.synchronize()
    scale = float(ld.abs().max())
    out = {"rows": B, "prompt_tokens": [int(n) for n in lens],
           "max_abs_logit": scale, "profiles": prof}
    for name, got, tol in (("paged_vs_dense_bf16", lp, LOGIT_TOL),
                           ("int8_vs_bf16_dense", lq, INT8_LOGIT_TOL)):
        check(bool(torch.isfinite(got).all()), f"phase 4c: {name}: "
              "non-finite logits")
        err = float((got - ld).abs().max())
        same = int((got.argmax(-1) == ld.argmax(-1)).sum())
        check(err <= tol * scale, f"phase 4c: {name}: max abs err "
              f"{err:.3e} > {tol} * {scale:.3e}")
        out[name] = {"max_abs_err": err, "rel_err": err / scale,
                     "limit": tol, "greedy_agree": same}
        print(f"  {name}: max abs err {err:.4e}, max |logit| {scale:.4e}, "
              f"relative {err / scale:.3e} (limit {tol}); greedy tokens "
              f"agree on {same}/{B} rows", flush=True)
    del srv, dense, quant, pool
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phase D ----

D_WATCH = {"n": 8, "seed": SEED + 8, "max_new": 32}
D_PROFILE = {"n": 8, "seed": SEED + 9, "max_new": 64}
D_PROFILE_K = 8                # the megastep[K] profiled in phase D4


def graphs_phase(torch, cfg, params, serving, dense):
    """Phase D on the phase-3a llama2-7b weights, at full width: the
    compiled decode step (`core.graphs`: CUDA graphs of decode and
    megastep[K=k], replayed over step state written in place) against the
    same servers with graphs=False, in this one process (the adapters are
    the same). D1: phase 3a's 16 (bgmv) and 6 (mbgmv) requests and phase
    3c's 12 on the dense plane in bf16 and int8 served eagerly: every
    request's greedy tokens and every kernel's launch count must equal
    the graphed run's. D2: phase 3c's temperature-0.8 requests (seed
    SEED) eagerly: whether the streams equal the graphed ones. D3: under
    the sanitizers, 8 requests, `mark_steady`, the same schedule again:
    RetraceSan must stay clean; then a LoRA pool leaf rebound and the
    schedule once more: `assert_clean` must raise. D4: decode ms a call
    (phase 3a's CUDA-event spans) graphed vs eager; one profiled decode
    call and megastep[K=8] call of each arm (device ms, wall ms, idle
    share); the syncs PyTorch reports in each call; each graph's capture
    time and the graph pool's bytes."""
    from repro_torch.analysis import sanitizers
    from repro_torch.analysis.retrace import RetraceError
    t0 = time.perf_counter()
    smi = smi_reading()
    switch = debug_switch_lines(torch)
    temp_label = f"(iv) paged T={TEMPERATURE} seed {SEED}"
    print("phase D1: the graphed runs of phases 3a / 3c served again with "
          "graphs=False", flush=True)
    eager, _ = serve_phase(torch, cfg, [
        (f"{label} eager", kernel, dict(kw, graphs=False), req)
        for label, kernel, kw, req in LLAMA_RUNS] + [
        ("(i) dense bgmv eager", "bgmv",
         {"memory": "dense", "graphs": False}, DENSE_REQUESTS),
        (temp_label + " eager", "bgmv",
         {"temperature": TEMPERATURE, "graphs": False}, DENSE_TEMP)],
        "D1", params=params)
    int8, _ = serve_phase(
        torch, dataclasses.replace(cfg, kv_cache_dtype="int8"),
        [("(ii) dense int8 bgmv eager", "bgmv", {"graphs": False},
          DENSE_REQUESTS)], "D1", params=params)
    graphed = {r["run"]: r for r in serving + dense}
    out = {"d1": []}
    for g, e in [(graphed["bgmv"], eager[0]), (graphed["mbgmv"], eager[1]),
                 (graphed["(i) dense bgmv"], eager[2]),
                 (graphed["(ii) dense int8 bgmv"], int8[0])]:
        n = len(g["generated"])
        same = sum(g["generated"][r] == e["generated"][r]
                   for r in g["generated"])
        rec = {"run": g["run"], "requests": n, "tokens_equal": same,
               "launches_graphed": g["launches"],
               "launches_eager": e["launches"],
               "decode_call_ms_median_graphed": g["decode_call_ms_median"],
               "decode_call_ms_median_eager": e["decode_call_ms_median"],
               "decode_tok_s_graphed": g["decode_tok_s"],
               "decode_tok_s_eager": e["decode_tok_s"],
               "wall_s_graphed": g["wall_s"], "wall_s_eager": e["wall_s"]}
        out["d1"].append(rec)
        print(f"  D1 {g['run']}: tokens equal on {same}/{n} requests; "
              f"launches graphed {g['launches']} / eager {e['launches']}; "
              f"decode median {g['decode_call_ms_median']:.2f} / "
              f"{e['decode_call_ms_median']:.2f} ms a call, "
              f"{g['decode_tok_s']:.1f} / {e['decode_tok_s']:.1f} tok/s "
              f"(graphed / eager; {smi})", flush=True)
        check(same == n, f"D1 {g['run']}: graphed tokens differ from the "
              f"eager ones on {n - same} of {n} requests")
        check(g["launches"] == e["launches"], f"D1 {g['run']}: launches "
              f"graphed {g['launches']} != eager {e['launches']}")

    g, e = graphed[temp_label], eager[3]
    parts = {r: next((i for i, (a, b) in enumerate(zip(g["generated"][r],
                                                         e["generated"][r]))
                      if a != b), None) for r in g["generated"]}
    equal = all(p is None for p in parts.values())
    out["d2"] = {"streams_equal": equal, "first_difference": parts}
    print(f"  D2 temperature {TEMPERATURE}, seed {SEED}: graphed and eager "
          f"streams {'equal' if equal else 'differ'} (first differing "
          f"token by request: {parts})", flush=True)
    check(all(p != 0 for p in parts.values()), "D2: a first token (sampled "
          "eagerly at prefill in both arms) differs")

    print("phase D3: RetraceSan over the graphed step", flush=True)
    with sanitizers.force(True):
        srv, uids = make_server(torch, cfg, "bgmv", params)
        be = srv.backend
        san = be.retrace_san
        check(san is not None, "D3: no RetraceSan under the sanitizers")
        reqs = make_requests(cfg, uids, **D_WATCH)
        srv.run(reqs)
        warm = dict(san._sizes)
        san.mark_steady()
        srv.run(again(srv, reqs, 1))
        san.assert_clean()
        steady = graph_check(be, "D3 steady")
        q = be.pool.pool["q"]
        q["a"] = q["a"].clone()          # rebound: not written in place
        srv.run(again(srv, reqs, 2))
        caught = None
        try:
            san.assert_clean()
        except RetraceError as err:
            caught = str(err)
        check(caught is not None, "D3: a LoRA pool leaf rebound after "
              "steady state went unseen")
        check(all(len(st.generated) == st.req.max_new_tokens
                  for st in srv.states), "D3: unfinished requests")
    out["d3"] = {"warm_sizes": warm, "steady_graphs": steady,
                 "rebound_raised": caught}
    print(f"  D3: warm-up builds {warm}; the same schedule after "
          f"mark_steady: clean ({graph_summary(steady)}); a pool leaf "
          f"rebound: raised ({caught})", flush=True)
    del srv, be, san, q
    gc.collect()

    print(f"phase D4: what a decode step costs, graphed and eager ({smi})",
          flush=True)
    out["d4"] = {}
    for graphs in (True, False):
        arm = "graphed" if graphs else "eager"
        srv, uids = make_server(torch, cfg, "bgmv", params, graphs=graphs)
        be, adm = srv.backend, srv.admission
        be.graphs.keep_graphs = graphs     # read the graphs' edges below
        records = []
        _sync_sites(torch, be, records)
        for r in make_requests(cfg, uids, spacing_ms=0.0, **D_PROFILE):
            srv.submit(r)
        while be.transfer_stats["decode_steps"] < 2 * D_PROFILE_K:
            srv.step()
        ready = [r for r in adm.rows if r is not None and not r.done]
        check(len(ready) == D_PROFILE["n"], f"D4: {len(ready)} rows ready")

        def dec():
            be.decode(ready, adm.row_slot, adm.row_pos, adm.row_pages)

        def mega():
            be.megastep(ready, [D_PROFILE_K] * len(ready), D_PROFILE_K,
                        adm.row_slot, adm.row_pages)

        for fn in (dec, mega):
            fn()
            fn()          # a key's first call runs eagerly, its second
        p_dec = profile_step(torch, dec, f"one {arm} llama2-7b decode call")
        p_mega = profile_step(torch, mega, f"one {arm} llama2-7b "
                              f"megastep[K={D_PROFILE_K}] call")
        be.flush_readback()
        stats = graph_check(be, f"D4 {arm}")
        plain = [(k, st, [x for x in sites if x not in switch], cap)
                 for k, st, sites, cap in records if not cap]
        rec = {"decode_call": p_dec, "megastep_call": p_mega,
               "calls": len(records), "calls_outside_a_capture": len(plain),
               "calls_that_uploaded": sum(not r[1] for r in records),
               "sync_sites_outside_a_capture": sorted(
                   {f"{os.path.relpath(p_, ROOT)}:{n_}"
                    for r in plain for p_, n_ in r[2]}),
               "graphs": stats}
        if graphs:
            rec["pool_bytes"] = be.graphs.pool_bytes()
            rec["step_graph_edges"] = step_graph_edges(be, stats)
        out["d4"][arm] = rec
        print(f"  D4 {arm}: decode call {p_dec['wall_ms']:.2f} ms wall, "
              f"{p_dec['device_ms']:.2f} ms device, idle "
              f"{share(p_dec)}; megastep[K={D_PROFILE_K}] "
              f"{p_mega['wall_ms']:.2f} ms wall, {p_mega['device_ms']:.2f} "
              f"ms device, idle {share(p_mega)}; "
              f"{len(records)} calls ({rec['calls_that_uploaded']} "
              f"uploaded), syncs outside a capture at "
              f"{rec['sync_sites_outside_a_capture']}", flush=True)
        if graphs:
            print("  D4 capture s by key: " + ", ".join(
                f"{k} {[round(x, 3) for x in v['capture_s']]}"
                for k, v in stats.items())
                + f"; graph pool {rec['pool_bytes']} B", flush=True)
            check(not rec["sync_sites_outside_a_capture"],
                  "D4: a graphed decode / megastep call synced")
        del srv, be, adm, ready
        gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase D took {out['seconds']:.1f} s", flush=True)
    return out


def step_graph_edges(be, stats):
    """Nodes, edges and programmatic edges of the decode and megastep
    graphs (kept by `StepGraphs.keep_graphs`): the decode LoRA kernels are
    launched with programmatic dependent launch and each expand follows
    its shrink, so every captured step holds at least as many
    programmatic edges as it launches expands."""
    import ctypes
    from repro_torch.kernels import build
    lib = build.library()
    out = {}
    for key, e in be.graphs.entries.items():
        if e.graph is None or not key.startswith(("decode", "megastep")):
            continue
        info = (ctypes.c_longlong * 3)()
        rc = lib.rt_graph_edges(ctypes.c_void_p(e.graph.raw_cuda_graph()),
                                info)
        check(rc == 0, f"D4 {key}: rt_graph_edges returned {rc}")
        nodes, edges, prog = (int(v) for v in info)
        expands = stats[key]["launches_a_replay"]["lora_expand"]
        out[key] = {"nodes": nodes, "edges": edges,
                    "programmatic_edges": prog, "lora_expand_launches":
                    expands}
        print(f"  D4 {key} graph: {nodes} nodes, {edges} edges, {prog} "
              f"programmatic, {expands} lora_expand launches", flush=True)
        check(prog >= expands > 0, f"D4 {key}: {prog} programmatic edges "
              f"for {expands} lora_expand launches")
    return out


# ------------------------------------------------------------ phase P ----

P1_PASSES = 3                         # P1 serves 3a's requests 3 times
P_PROFILE = {"n": 8, "len": 256}      # P4's profiled prefill: 8 x 256
P_CHUNK = 512                         # P4's profiled yi-9b chunk


def p_compare(phase, graphed, eager, smi, kind="prefill"):
    """Graphed and eager records of one run (`serve_phase`): every
    request's tokens and every kernel's launch count must be equal; prints
    the median `kind` (prefill / chunk) ms of each arm. Returns the
    summary."""
    import numpy as np
    n = len(graphed["generated"])
    same = sum(graphed["generated"][r] == eager["generated"][r]
               for r in graphed["generated"])
    key = f"{kind}_ms_median"
    ms_g, ms_e = graphed[f"{kind}_ms"], eager[f"{kind}_ms"]
    tags = graphed[f"{kind}_tags"]
    # both arms serve one schedule (the timeline is simulated), so call i
    # is the same call in each: the medians over the calls that replayed
    paired = [i for i, t in enumerate(tags) if t == "replay"] \
        if len(ms_g) == len(ms_e) else []
    rec = {"run": graphed["run"], "requests": n, "tokens_equal": same,
           "launches_graphed": graphed["launches"],
           "launches_eager": eager["launches"],
           f"{kind}_calls": graphed[f"{kind}_calls"],
           f"{kind}_tags": {t: tags.count(t) for t in set(tags)},
           f"{key}_graphed": graphed[key], f"{key}_eager": eager[key],
           "replayed_calls": len(paired),
           f"{key}_replayed": float(np.median([ms_g[i] for i in paired]))
           if paired else None,
           f"{key}_replayed_eager": float(np.median([ms_e[i]
                                                     for i in paired]))
           if paired else None,
           "wall_s_graphed": graphed["wall_s"],
           "wall_s_eager": eager["wall_s"],
           "graphs": graphed["graphs"]}
    over = (f"; over the {len(paired)} calls that replayed "
            f"{rec[key + '_replayed']:.2f} / "
            f"{rec[key + '_replayed_eager']:.2f} ms") if paired else \
        "; no call replayed"
    print(f"  {phase} {graphed['model']} {graphed['run']}: tokens equal on "
          f"{same}/{n} requests; launches graphed {graphed['launches']} / "
          f"eager {eager['launches']}; median {kind} "
          f"{graphed[key]:.2f} / {eager[key]:.2f} ms over "
          f"{graphed[f'{kind}_calls']} calls ({rec[f'{kind}_tags']}){over} "
          f"(graphed / eager; {smi})", flush=True)
    check(same == n, f"{phase} {graphed['run']}: graphed tokens differ from "
          f"the eager ones on {n - same} of {n} requests")
    check(graphed["launches"] == eager["launches"], f"{phase} "
          f"{graphed['run']}: launches graphed {graphed['launches']} != "
          f"eager {eager['launches']}")
    return rec


def p_keys_replayed(phase, stats, prefix):
    """The graphed keys named `prefix...`: each built once; each captured
    one (called twice or more) replayed; some replayed. A key called once
    ran its warm-up only: the served passes' schedules differ where the
    first pass's cold starts change which requests share a bucket.
    Returns (replayed keys, keys called once)."""
    keys = {k: g for k, g in stats.items()
            if k.startswith(prefix) and not g["eager"]}
    bad = {k: (g["builds"], g["captures"], g["replays"])
           for k, g in keys.items() if g["builds"] != 1
           or g["replays"] < g["captures"]}
    check(not bad, f"{phase}: keys not built once and replayed: {bad}")
    replayed = sorted(k for k, g in keys.items() if g["replays"])
    check(replayed, f"{phase}: no {prefix}...] key replayed: {keys}")
    return replayed, sorted(k for k, g in keys.items() if not g["replays"])


def pool_summary(stats):
    """The graph pool's bytes after the last capture, and each key's
    capture seconds."""
    after = [b for g in stats.values() for b in g["pool_bytes"]
             if b is not None]
    return {"pool_bytes": max(after) if after else None,
            "capture_s": {k: g["capture_s"] for k, g in stats.items()
                          if g["capture_s"]}}


def prefill_graphs_phase(torch, cfg, params):
    """Phase P1 on the phase-3a llama2-7b weights, at full width: phase
    3a's 16 (bgmv) and 6 (mbgmv) requests served P1_PASSES times on one
    server (so that prefill buckets come again), graphed and with
    graphs=False, in this one process (the adapters are the same): every
    request's greedy tokens and every kernel's launch count equal, every
    graphed prefill key built once, every one called twice or more
    replayed; the median prefill ms of each arm, over all calls and over
    the calls that replayed. P4: one profiled graphed and eager prefill
    call (`profile_prefill`)."""
    smi = smi_reading()
    t0 = time.perf_counter()
    print(f"phase P1: phase 3a's requests served {P1_PASSES} times, "
          "graphed and eager", flush=True)
    arms = {}
    for graphs in (True, False):
        arm = "graphed" if graphs else "eager"
        arms[arm], _ = serve_phase(torch, cfg, [
            (f"{label} x{P1_PASSES} {arm}", kernel, dict(kw, graphs=graphs),
             req) for label, kernel, kw, req in LLAMA_RUNS], "P1",
            params=params, repeat=P1_PASSES)
    out = {"p1": []}
    for g, e in zip(arms["graphed"], arms["eager"]):
        rec = p_compare("P1", g, e, smi)
        rec["keys"], rec["keys_called_once"] = p_keys_replayed(
            f"P1 {g['run']}", g["graphs"], "prefill[")
        rec.update(pool_summary(g["graphs"]))
        out["p1"].append(rec)
        print(f"  P1 {g['run']}: prefill keys built once and replayed "
              f"{rec['keys']}, called once {rec['keys_called_once']}; "
              f"graph pool {rec['pool_bytes']} B", flush=True)
    out["p4"] = {arm: profile_prefill(torch, cfg, params, graphs=arm ==
                                      "graphed", smi=smi)
                 for arm in ("graphed", "eager")}
    out["seconds"] = time.perf_counter() - t0
    print(f"  phases P1 / P4 (llama2-7b) took {out['seconds']:.1f} s",
          flush=True)
    return out


def profile_prefill(torch, cfg, params, graphs, smi, **server_kw):
    """Phase P4: one packed prefill call of P_PROFILE's rows, profiled
    (device ms, wall ms, idle share) after the key's warm-up and capture,
    the syncs of every prefill call (none outside a capture), each key's
    capture seconds and the graph pool's bytes."""
    import numpy as np
    from repro_torch.serving.request import Request
    arm = "graphed" if graphs else "eager"
    srv, uids = make_server(torch, cfg, "bgmv", params, graphs=graphs,
                            **server_kw)
    be = srv.backend
    records = []
    _sync_sites(torch, be, records, kinds=("prefill_admitted",))
    rng = np.random.default_rng(SEED + 12)
    for i in range(P_PROFILE["n"]):
        srv.submit(Request(rid=i, adapter_uid=uids[i % len(uids)],
                           prompt=rng.integers(0, cfg.vocab, P_PROFILE["len"]
                                               ).astype(np.int32),
                           max_new_tokens=4, arrival_ms=0.0))
    while be.transfer_stats["prefills"] == 0:
        srv.step()
    states = [st for st in srv.states if st.row is not None]
    check(len(states) == P_PROFILE["n"], f"P4: {len(states)} rows admitted")

    def call():
        be.prefill_admitted(states)

    call()                   # a key's second call is its capture
    prof = profile_step(torch, call, f"one {arm} {cfg.name} prefill call "
                        f"({P_PROFILE['n']} x {P_PROFILE['len']})")
    be.flush_readback()
    return p4_record(torch, be, prof, records, arm, f"{cfg.name} prefill",
                     smi)


def p4_record(torch, be, prof, records, arm, what, smi):
    """P4's record of one profiled arm; checks that no call synced outside
    a capture."""
    switch = debug_switch_lines(torch)
    plain = [(k, st, [x for x in sites if x not in switch], cap)
             for k, st, sites, cap in records if not cap]
    stats = be.graphs.stats()
    rec = {"call": prof, "calls": len(records),
           "sync_sites_outside_a_capture": sorted(
               {f"{os.path.relpath(p_, ROOT)}:{n_}"
                for r in plain for p_, n_ in r[2]}),
           **pool_summary(stats)}
    print(f"  P4 {what} {arm}: {prof['wall_ms']:.2f} ms wall, "
          f"{prof['device_ms']:.2f} ms device, idle {share(prof)}; "
          f"{len(records)} calls, syncs outside a capture at "
          f"{rec['sync_sites_outside_a_capture']}; capture s "
          f"{rec['capture_s']}; graph pool {rec['pool_bytes']} B ({smi})",
          flush=True)
    check(not rec["sync_sites_outside_a_capture"],
          f"P4 {what} {arm}: a call synced")
    return rec


def chunk_graphs_phase(torch, cfg, params, serving):
    """Phase P2 on the phase-3b yi-9b weights (bf16, full width): phase
    3b's 8 requests with chunk_budget=512 served with graphs=False, their
    tokens and launch counts equal to 3b's graphed arm's, each arm's
    median chunk ms; the monolithic arm's buckets past the cap counted as
    eager; the monolithic requests served twice with the cap lifted
    (every bucket graphed) for the graph pool's bytes without the cap;
    P4: one profiled graphed and eager chunk (`profile_chunk`)."""
    from repro_torch.core.backend import PREFILL_GRAPH_TOKENS
    smi = smi_reading()
    t0 = time.perf_counter()
    graphed = {r["run"]: r for r in serving}
    print("phase P2: yi-9b chunked prefill graphed and eager", flush=True)
    (mono_label, kernel, mono_kw, req), (label, _, chunk_kw, _) = YI_RUNS
    eager, _ = serve_phase(torch, cfg, [
        (f"{label} eager", kernel, dict(chunk_kw, graphs=False), req)],
        "P2", params=params)
    g = graphed[label]
    out = {"p2": p_compare("P2", g, eager[0], smi, kind="chunk")}
    for kind in ("prefill_chunk[", "prefill_chunk_final["):
        keys = [k for k, v in g["graphs"].items()
                if k.startswith(kind) and v["replays"]]
        check(keys, f"P2: no {kind}...] key replayed: {g['graphs']}")
    mono = graphed[mono_label]["graphs"]
    capped = {k: v["eager"] for k, v in mono.items() if v["eager"]}
    past = {k for k in mono if k.startswith("prefill[") and
            bucket_tokens(k) > PREFILL_GRAPH_TOKENS}
    check(past and set(capped) == past, f"P2: the monolithic arm's "
          f"buckets past the cap {sorted(past)} vs those run eagerly "
          f"{capped}")
    out["capped_buckets"] = capped
    out["pool_capped"] = pool_summary(mono)
    lifted, _ = serve_phase(torch, cfg, [
        (f"{mono_label} x2, no cap", kernel, mono_kw, req)], "P2",
        params=params, repeat=2, graph_tokens=float("inf"))
    out["pool_uncapped"] = pool_summary(lifted[0]["graphs"])
    out["uncapped_prefill_ms_median"] = lifted[0]["prefill_ms_median"]
    print(f"  P2 monolithic arm: buckets eager by the cap (calls) {capped}; "
          f"graph pool {out['pool_capped']['pool_bytes']} B with the cap "
          f"of {PREFILL_GRAPH_TOKENS} tokens, "
          f"{out['pool_uncapped']['pool_bytes']} B without it (keys "
          f"captured: {sorted(out['pool_uncapped']['capture_s'])}; {smi})",
          flush=True)
    out["p4"] = {arm: profile_chunk(torch, cfg, params, arm == "graphed",
                                    smi) for arm in ("graphed", "eager")}
    out["seconds"] = time.perf_counter() - t0
    print(f"  phases P2 / P4 (yi-9b) took {out['seconds']:.1f} s",
          flush=True)
    return out


def chunk_launches(kernels, p4):
    """The yi-9b chunk rows' launches a chunk (`lora_shrink[yi-9b chunk]`,
    `lora_expand[yi-9b chunk, ...]`): the counts of P4's graphed chunk,
    equal to its eager chunk's."""
    for kernel in ("lora_shrink", "lora_expand"):
        n = {arm: r[f"{kernel}_launches_a_chunk"] for arm, r in p4.items()}
        check(n["graphed"] == n["eager"] > 0,
              f"P4: {kernel} launches a chunk differ or are 0: {n}")
        for row in kernels:
            if row["name"].startswith(f"{kernel}[yi-9b chunk"):
                row["launches_a_chunk"] = n["graphed"]


def bucket_tokens(key):
    """Nb x Lp of a `prefill[Nb=n,Lp=l]` key."""
    nb, lp = (int(x.split("=")[1]) for x in key[8:-1].split(","))
    return nb * lp


def profile_chunk(torch, cfg, params, graphs, smi):
    """Phase P4: one yi-9b chunk of P_CHUNK tokens (the first chunk of a
    long prompt, run again over its own pages), profiled after the key's
    warm-up and capture, with P4's sync check."""
    import numpy as np
    from repro_torch.serving.request import Request
    arm = "graphed" if graphs else "eager"
    srv, uids = make_server(torch, cfg, "bgmv", params, graphs=graphs,
                            **dict(YI_SERVER, chunk_budget=P_CHUNK))
    be, adm = srv.backend, srv.admission
    records = []
    _sync_sites(torch, be, records, kinds=("prefill_chunk",))
    rng = np.random.default_rng(SEED + 14)
    srv.submit(Request(rid=0, adapter_uid=uids[0],
                       prompt=rng.integers(0, cfg.vocab, YI_LONG[1] - 1
                                           ).astype(np.int32),
                       max_new_tokens=4, arrival_ms=0.0))
    while be.transfer_stats["prefill_chunks"] == 0:
        srv.step()
    st = srv.states[0]

    def call():
        be.prefill_chunk(st, adm.row_pages[st.row], 0, P_CHUNK, False)

    call()
    call()                   # the key's capture (the first was its warm-up)
    from repro_torch.kernels.bgmv import lora_expand, lora_shrink
    before = (lora_shrink.launches, lora_expand.launches)
    lora_shrink.launches = lora_expand.launches = 0
    call()                   # one chunk's LoRA launches (a replay adds
    shrinks = lora_shrink.launches        # what its capture launched)
    expands = lora_expand.launches
    lora_shrink.launches += before[0]
    lora_expand.launches += before[1]
    prof = profile_step(torch, call, f"one {arm} {cfg.name} chunk of "
                        f"{P_CHUNK} tokens")
    rec = p4_record(torch, be, prof, records, arm, f"{cfg.name} chunk",
                    smi)
    rec["lora_shrink_launches_a_chunk"] = shrinks
    rec["lora_expand_launches_a_chunk"] = expands
    print(f"  P4 {cfg.name} chunk {arm}: {shrinks} lora_shrink and "
          f"{expands} lora_expand launches in one chunk", flush=True)
    return rec


def debug_switch_lines(torch):
    """The lines of torch.cuda.set_sync_debug_mode: the instrumentation's
    own switch can report itself; it is no line of the port."""
    import inspect
    fn = torch.cuda.set_sync_debug_mode
    src, first = inspect.getsourcelines(fn)
    return {(os.path.realpath(inspect.getsourcefile(fn)), first + i)
            for i in range(len(src))}


def share(profile):
    x = profile["device_idle_share"]
    return "not measured (no device time)" if x is None else f"{x:.3f}"


# ------------------------------------------------------------ phase T ----

T_BATCH, T_SEQ, T_RANK, T_STEPS = 8, 512, 64, 10
T3_LAYERS, T3_ACCUM = 4, 2       # T3: full fine-tuning, depth cut
T3_STEPS = 5                     # T3's steps (T4: the last 3 replay)
GRAD_TOL = 5e-2                  # a model gradient leaf vs the plain path
# T1 flash cases: (label, B, H, KV, L, hd, window, dtype, full-width)
T1_FLASH = [("llama2-7b B 2 L 512", 2, 32, 32, 512, 128, None, "bf16", True),
            ("yi-9b B 1 L 4096 GQA 8", 1, 32, 4, 4096, 128, None, "bf16",
             True),
            ("window 256 GQA 4 L 1024", 2, 16, 4, 1024, 128, 256, "bf16",
             False),
            ("ragged L 777 GQA 2", 2, 8, 4, 777, 128, None, "bf16", False),
            ("smoke window 48 GQA 2 ragged f32", 2, 4, 2, 130, 32, 48, "f32",
             False)]


def grad_checks(torch):
    """Phase T1: each kernel Function's gradients (flash: dq, dk, dv; the
    LoRA delta's shrink and expand: dx, dA, dB) against autograd through
    the plain versions on the card, per output row with phase 2's rule,
    and a second backward bitwise equal. Flash takes (B, L, H, hd) leaves
    passed as (B, H, L, hd) views, as the model passes them. Returns the
    worst error per gradient at full-width shapes."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash import flash_attention
    print("phase T1: gradients through the kernels' autograd Functions vs "
          "autograd through the plain versions", flush=True)
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    worst = {}

    def note(name, err, full):
        if full:
            worst[name] = max(worst.get(name, 0.0), err)

    for label, B, H, KV, L, hd, window, dt, full in T1_FLASH:
        dt = dts[dt]
        g = torch.Generator(device="cuda").manual_seed(L + H)
        leaves = [torch.randn(B, L, n, hd, generator=g, device="cuda")
                  .to(dt).requires_grad_() for n in (H, KV, KV)]
        views = [t.transpose(1, 2) for t in leaves]
        dout = torch.randn(B, L, H, hd, generator=g, device="cuda").to(dt)
        dout = dout.transpose(1, 2)            # non-contiguous, as served
        out = flash_attention(*views, window=window)
        check(out.grad_fn is not None, "flash: no grad_fn")
        got = torch.autograd.grad(out, leaves, dout, retain_graph=True)
        again = torch.autograd.grad(out, leaves, dout)
        plain = ref.flash_attention_ref(*views, window=window)
        want = torch.autograd.grad(plain, leaves, dout)
        for n, a, b, w in zip(("dq", "dk", "dv"), got, again, want):
            check(a.dtype == dt and a.shape == w.shape,
                  f"flash {label}: {n} dtype / shape")
            note(f"flash_attention {n}", check_close(
                f"flash_attention {n} {label}", a.reshape(-1, hd),
                w.reshape(-1, hd), dt), full)
            check(torch.equal(a, b), f"flash {label}: {n}: two backward "
                  "runs differ")
        del leaves, views, dout, out, got, again, plain, want
        torch.cuda.empty_cache()

    # LoRA: 4,096 rows (8 x 512 tokens) x d 4,096, r_max 64, four slots
    # of ranks 64/16/32/8 in runs of 512 rows (prefill's layout) cycling
    # through -1, bf16; and r_max 48 in f32 at smoke widths
    for label, rows, d, r_max, ranks, rb, dt, full in (
            ("llama2-7b 4096 rows d 4096", 4096, 4096, 64, [64, 16, 32, 8],
             16, torch.bfloat16, True),
            ("r_max 48 f32", 300, 128, 48, [48, 5, 16], 16, torch.float32,
             False)):
        g = torch.Generator(device="cuda").manual_seed(rows + r_max)
        a = torch.zeros(len(ranks), d, r_max, device="cuda")
        b = torch.zeros(len(ranks), r_max, d, device="cuda")
        for s, r in enumerate(ranks):
            a[s, :, :r] = torch.randn(d, r, generator=g, device="cuda") \
                * d ** -0.5
            b[s, :r] = torch.randn(r, d, generator=g, device="cuda") \
                * r ** -0.5
        x = torch.randn(rows, d, generator=g, device="cuda").to(dt)
        a, b = a.to(dt), b.to(dt)
        seg = 512 if rows >= 512 else 17
        idx = (torch.arange(rows, device="cuda") // seg % (len(ranks) + 1)
               - 1).to(torch.int32)
        dout = torch.randn(rows, d, generator=g, device="cuda").to(dt)
        ranks_t = torch.tensor(ranks, dtype=torch.int32, device="cuda")
        for mode in ("bgmv", "mbgmv"):
            live = ops.lora_live(idx, ranks_t, mode, r_max, rb)
            xs, as_, bs = (t.detach().requires_grad_() for t in (x, a, b))
            out = ops.lora_delta(xs, as_, bs, idx, live=live)
            got = torch.autograd.grad(out, (xs, as_, bs), dout,
                                      retain_graph=True)
            again = torch.autograd.grad(out, (xs, as_, bs), dout)
            y = ref.lora_shrink_ref(xs, as_, idx, live)
            want = torch.autograd.grad(ref.lora_expand_ref(
                y.to(dt), bs, idx, live), (xs, as_, bs), dout)
            for n, gg, g2, w, width in zip(("dx", "dA", "dB"), got, again,
                                           want, (d, r_max, d)):
                note(f"lora {n}", check_close(
                    f"lora {n} {mode} {label}", gg.reshape(-1, width),
                    w.reshape(-1, width), dt), full)
                check(torch.equal(gg, g2), f"lora {label}: {n}: two "
                      "backward runs differ")
            check(bool((got[0][idx < 0] == 0).all()),
                  "lora: an idx -1 row has a nonzero dx")
    torch.cuda.synchronize()
    return worst


def train_rows(torch, cfg, launches, errs):
    """Kernels-line rows at the LoRA training step's shapes (full-width
    llama2-7b, 8 x 512 tokens, one slot of rank 64): flash forward at B 8,
    H 32, L 512, hd 128, and the shrink and expand at 4,096 rows x d
    4,096, r_max 64, where the backward's launches on B^T and A^T take
    the same shapes. Each held per row to its plain version and timed
    beside its bound, the plain version and a library call (SDPA; one
    torch.matmul), which the port never calls; the LoRA pair and its
    matmul also in a CUDA graph (`graph_ms`), as T4's graphed step
    launches them. Launches: phase T2(c)'s ten steps (forward, the remat
    recompute and the backward)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.bgmv import lora_expand, lora_shrink
    from repro_torch.kernels.flash import flash_attention
    print("phase T: kernel timing at the LoRA training step's shapes",
          flush=True)
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    g = torch.Generator(device="cuda").manual_seed(SEED + 21)
    B, H, L, hd = T_BATCH, cfg.n_heads, T_SEQ, cfg.hd
    q, k, v = (torch.randn(B, L, H, hd, generator=g, device="cuda")
               .bfloat16().transpose(1, 2) for _ in range(3))
    err = check_close("flash_attention train shape", flash_attention(
        q, k, v).reshape(-1, hd), ref.flash_attention_ref(q, k, v).reshape(
        -1, hd), torch.bfloat16)
    pairs = B * H * L * (L + 1) // 2
    nbytes = 4 * q.numel() * 2
    b_ms, b_by = bound(nbytes, 4 * hd * pairs, "bfloat16")
    rows = [{
        "name": "flash_attention[llama2-7b train]", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash.py:110",
        "path": "llama2-7b LoRA training (forward and remat recompute)",
        "launches": launches["flash_attention"], "max_abs_err": err,
        "ms": time_ms(torch, lambda: flash_attention(q, k, v), flush, n=50),
        "plain_ms": time_ms(torch, lambda: ref.flash_attention_ref(q, k, v),
                            flush, n=10),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), flush, n=50),
        "bytes": nbytes, "ops": 4 * hd * pairs,
        "shape": {"B": B, "H": H, "KV": H, "L": L, "hd": hd}}]
    # LoRA at layer 0 of target q: x the normed activations' shape
    rows_n, d, r = B * L, cfg.d_model, cfg.lora.max_rank
    x = torch.randn(rows_n, d, generator=g, device="cuda").bfloat16()
    a = (torch.randn(1, d, r, generator=g, device="cuda") * d ** -0.5
         ).bfloat16()
    bw = (torch.randn(1, r, d, generator=g, device="cuda") * r ** -0.5
          ).bfloat16()
    idx = torch.zeros(rows_n, dtype=torch.int32, device="cuda")
    live = ref.bgmv_live(idx, r)
    y = lora_shrink(x, a, idx, live)
    yd = y.bfloat16()
    s_err = check_close("lora_shrink train shape", y,
                        ref.lora_shrink_ref(x, a, idx, live), torch.float32)
    check(torch.equal(y, lora_shrink(x, a, idx, live)),
          "shrink train shape: two runs differ")
    e_err = check_close("lora_expand train shape", lora_expand(
        yd, bw, idx, live), ref.lora_expand_ref(yd, bw, idx, live),
        torch.bfloat16)
    s_bytes = x.numel() * 2 + a.numel() * 2 + 8 * rows_n + y.numel() * 4
    e_bytes = yd.numel() * 2 + bw.numel() * 2 + 8 * rows_n + rows_n * d * 2
    ops_n = 2 * d * r * rows_n
    for name, fn, plain, lib, nb, e, src in (
            ("lora_shrink", lambda: lora_shrink(x, a, idx, live),
             lambda: ref.lora_shrink_ref(x, a, idx, live),
             lambda: torch.matmul(x, a[0]), s_bytes, s_err,
             "src/repro/kernels/bgmv.py:86"),
            ("lora_expand", lambda: lora_expand(yd, bw, idx, live),
             lambda: ref.lora_expand_ref(yd, bw, idx, live),
             lambda: torch.matmul(yd, bw[0]), e_bytes, e_err,
             "src/repro/kernels/bgmv.py:136")):
        b_ms, b_by = bound(nb, ops_n, "bfloat16")
        rows.append({
            "name": f"{name}[llama2-7b train]", "route": "cuda",
            "source": "src/repro_torch/csrc/lora.cu", "replaces": src,
            "path": "llama2-7b LoRA training (forward, recompute and the "
                    "backward's launches on the transposed weights)",
            "launches": launches[name], "max_abs_err": e,
            "ms": time_ms(torch, fn, flush),
            "graph_ms": graph_ms(torch, fn, flush),
            "host_ms": host_ms(torch, fn),
            "plain_ms": time_ms(torch, plain, flush, n=20),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(torch, lib, flush),
            "library_graph_ms": graph_ms(torch, lib, flush),
            "library_call": "torch.matmul with the one slot's weight",
            "bytes": nb, "shape": {"rows": rows_n, "d": d, "r_max": r,
                                   "slots": 1}})
    # the flash backward (plain PyTorch, blockwise) beside autograd through
    # the plain version, at the same shape
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    dout = torch.randn(B, H, L, hd, generator=g, device="cuda").bfloat16()
    o_k = flash_attention(*leaves)
    o_p = ref.flash_attention_ref(*leaves)
    bwd = {"flash_backward_ms": time_ms(
        torch, lambda: torch.autograd.grad(o_k, leaves, dout,
                                           retain_graph=True), flush, n=10),
        "plain_autograd_backward_ms": time_ms(
            torch, lambda: torch.autograd.grad(o_p, leaves, dout,
                                               retain_graph=True), flush,
            n=10),
        "grad_errors_full_width": errs}
    for r_ in rows:
        graphed = "" if "graph_ms" not in r_ else (
            f"; in a CUDA graph {r_['graph_ms'] * 1e3:.1f} us, library "
            f"{r_['library_graph_ms'] * 1e3:.1f} us; host "
            f"{r_['host_ms'] * 1e3:.1f} us a call")
        print(f"  {r_['name']}: {r_['ms'] * 1e3:.1f} us (bound "
              f"{r_['bound_ms'] * 1e3:.1f} us by {r_['bound_by']}), plain "
              f"{r_['plain_ms'] * 1e3:.1f} us, library "
              f"{r_['library_ms'] * 1e3:.1f} us, {r_['launches']} launches"
              f"{graphed}", flush=True)
    print(f"  flash backward (plain PyTorch, blockwise) "
          f"{bwd['flash_backward_ms']:.3f} ms, autograd through the plain "
          f"version {bwd['plain_autograd_backward_ms']:.3f} ms", flush=True)
    return rows, bwd


def profile_train_step(torch, step_fn, what):
    """One warm training step under torch.profiler: wall time, device
    time (the kernels' sum), the idle share, and device time by kind: the
    flash forward kernel, the LoRA kernels, the GEMMs (cuBLAS, the flash
    backward's f32 products among them), the rest; and, apart, the flash
    backward's named range (its GEMMs and element-wise kernels)."""
    from torch.profiler import ProfilerActivity, profile
    step_fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kinds = {"flash_forward": 0.0, "lora_kernels": 0.0, "gemm": 0.0,
             "other": 0.0}
    bwd_ms, top = 0.0, []
    for ev in prof.key_averages():
        ms = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0)) / 1e3
        if ev.key == "flash_attention_backward":
            # the named range (a CPU row and a device row): its kernels
            # are counted below by kind, so it is read, not added
            bwd_ms = max(bwd_ms, ms, getattr(
                ev, "device_time_total", 0.0) / 1e3)
            continue
        if "CUDA" not in str(ev.device_type) or "Buffer" in ev.key:
            continue
        if ms <= 0:
            continue
        name = ev.key.lower()
        kind = ("flash_forward" if "flash_bf16" in name or "flash_f32" in name
                else "lora_kernels" if "lora_" in name else "gemm" if any(
                    s in name for s in ("gemm", "xmma", "cutlass", "nvjet",
                                        "sm90_", "sm80_")) else "other")
        kinds[kind] += ms
        top.append({"name": ev.key[:80], "calls": ev.count, "device_ms": ms})
    device_ms = sum(kinds.values())
    top.sort(key=lambda r: -r["device_ms"])
    out = {"wall_ms": wall_ms, "device_ms": device_ms,
           "device_idle_share": 1.0 - device_ms / wall_ms if device_ms
           else None, "flash_backward_range_ms": bwd_ms,
           "by_kind_ms": kinds, "top": top[:16]}
    print(f"  {what}, profiled: {wall_ms:.1f} ms wall, {device_ms:.1f} ms "
          f"of device kernels (idle share {out['device_idle_share']}); "
          f"flash forward {kinds['flash_forward']:.1f} ms, LoRA kernels "
          f"{kinds['lora_kernels']:.1f} ms, GEMMs {kinds['gemm']:.1f} ms, "
          f"other {kinds['other']:.1f} ms; of all these, the flash backward "
          f"(plain PyTorch range) {bwd_ms:.1f} ms", flush=True)
    for r in top[:16]:
        print(f"    {r['device_ms']:8.3f} ms {r['calls']:5d}x {r['name']}",
              flush=True)
    return out


def grads_close(what, got, want, names, tol=GRAD_TOL):
    """Each gradient leaf within tol x its max |plain|; returns the worst
    ratio."""
    worst, at = 0.0, None
    for n, g, w in zip(names, got, want):
        check(bool(g.isfinite().all()), f"{what}: {n}: non-finite gradient")
        scale = float(w.float().abs().max())
        err = float((g.float() - w.float()).abs().max())
        check(err <= tol * scale, f"{what}: {n}: max abs err {err:.3e} > "
              f"{tol} x {scale:.3e}")
        if scale and err / scale > worst:
            worst, at = err / scale, n
    print(f"  {what}: {len(names)} gradient leaves, worst error "
          f"{worst:.3e} of the leaf's max |plain| at {at} (limit {tol})",
          flush=True)
    return worst


def training_phase(torch, cfg, params):
    """Phase T: LoRA training of full-width llama2-7b on the phase-3a
    weights, through the training launcher's `Trainer` and `run`, then
    full fine-tuning at a depth cut. See the module docstring."""
    import tempfile
    from repro_torch.launch import train as train_launch
    from repro_torch.models import model as model_lib
    from repro_torch.models.weights import init_params
    from repro_torch.training import checkpoint, train as train_lib
    from repro_torch.training import tree as tree_lib
    errs = grad_checks(torch)
    counters = _counters()
    print(f"phase T2: LoRA training, full-width {cfg.name} ({cfg.n_layers} "
          f"layers, bf16), rank {T_RANK} on {list(cfg.lora.targets)}, "
          f"batch {T_BATCH} x {T_SEQ}", flush=True)
    trainer = train_launch.Trainer(cfg, lora_rank=T_RANK, steps=T_STEPS,
                                   seed=SEED, device="cuda", params=params)
    data = trainer.batches(T_BATCH, T_SEQ, SEED)
    batch = next(data)
    out = {"grad_checks": errs}

    # (a) one step's loss and adapter gradients at a nonzero B: kernels vs
    # plain versions
    g = torch.Generator(device="cuda").manual_seed(SEED + 22)
    adapter = {t: {"a": ab["a"], "b": (torch.randn(
        ab["b"].shape, generator=g, device="cuda") * T_RANK ** -0.5 * 0.1
        ).to(ab["b"].dtype)} for t, ab in trainer.adapter.items()}
    for fn in counters.values():
        fn.launches = 0
    lk, gk = train_lib.lora_loss_and_grads(cfg, params, adapter, batch,
                                           T_RANK)
    launches_a = {n: fn.launches for n, fn in counters.items()}
    for n in ("flash_attention", "lora_shrink", "lora_expand"):
        check(launches_a[n] > 0, f"phase T2(a): {n} never launched")
    with plain_ops(), plain_attention():
        lp, gp = train_lib.lora_loss_and_grads(cfg, params, adapter, batch,
                                               T_RANK)
    lk, lp = float(lk), float(lp)
    check(abs(lk - lp) <= 1e-2 * abs(lp), f"phase T2(a): loss {lk} vs "
          f"plain {lp}")
    names, got, want = [], [], []
    for t in gk:
        for ab in ("a", "b"):
            for layer in range(cfg.n_layers):
                names.append(f"{t}.{ab}[{layer}]")
                got.append(gk[t][ab][layer])
                want.append(gp[t][ab][layer])
    out["T2a"] = {"loss": lk, "plain_loss": lp, "launches": launches_a,
                  "worst_grad_ratio": grads_close(
                      "phase T2(a) adapter gradients, kernels vs plain",
                      got, want, names)}
    print(f"  loss {lk:.5f} through the kernels, {lp:.5f} plain; "
          f"launches {launches_a}", flush=True)
    del gk, gp, got, want

    # (b) three steps on one fixed batch: the loss falls
    fixed = train_launch.Trainer(cfg, lora_rank=T_RANK, steps=3, seed=SEED,
                                 device="cuda", params=params)
    losses = [float(fixed.step(batch)["loss"]) for _ in range(3)]
    check(all(map(lambda v: v == v and abs(v) < 1e9, losses)),
          f"phase T2(b): non-finite loss {losses}")
    check(losses[-1] < losses[0], f"phase T2(b): the loss did not fall on "
          f"a fixed batch: {losses}")
    out["T2b_fixed_batch_losses"] = losses
    print(f"  3 steps on one fixed batch (lr {fixed.opt_cfg.lr}): losses "
          f"{losses}", flush=True)
    del fixed

    # (c) ten steps on fresh batches, through the launcher's run()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    recs = train_launch.run(trainer, data, T_STEPS, log_every=1)
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for n in ("flash_attention", "lora_shrink", "lora_expand"):
        check(launches[n] > 0, f"phase T2(c): {n} never launched")
    check(launches["paged_attention"] == 0,
          "phase T2(c): paged attention launched in training")
    check(all(r["loss"] == r["loss"] for r in recs),
          "phase T2(c): non-finite loss")
    steady = recs[1:]
    ms = sum(r["ms"] for r in steady) / len(steady)
    out["T2c"] = {"steps": recs, "ms_per_step_after_first": ms,
                  "tok_s_after_first": 1e3 * T_BATCH * T_SEQ / ms,
                  "peak_mem_gib": peak, "launches": launches}
    print(f"  {T_STEPS} steps: {ms:.1f} ms/step after the first "
          f"({out['T2c']['tok_s_after_first']:.0f} tok/s), peak "
          f"{peak:.2f} GiB; launches {launches}", flush=True)

    # (d) a checkpoint of {"model": adapter, "opt": state} loads back
    # bitwise
    with tempfile.TemporaryDirectory() as d:
        path = checkpoint.step_path(d, T_STEPS)
        tree = {"model": trainer.adapter, "opt": trainer.state}
        checkpoint.save(path, tree, step=T_STEPS)
        back, man = checkpoint.load(path, tree)
        same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(
            tree_lib.leaves(tree), tree_lib.leaves(back)))
        check(same and man["step"] == T_STEPS,
              "phase T2(d): the checkpoint did not load back bitwise")
        out["T2d_checkpoint_leaves"] = len(tree_lib.leaves(tree))
    print(f"  checkpoint of {out['T2d_checkpoint_leaves']} leaves loads "
          "back bitwise", flush=True)
    out["T4"] = t4_arms(torch, cfg, params, trainer, recs, peak,
                        lora_rank=T_RANK, steps=T_STEPS, data_seed=SEED)
    prof = profile_train_step(
        torch, lambda: trainer.step(batch),
        f"one {cfg.name} LoRA training step ({T_BATCH} x {T_SEQ})")
    # the profiler slows the host: the idle share against (c)'s step time
    prof["idle_share_vs_step"] = 1.0 - prof["device_ms"] / ms
    print(f"  device kernels {prof['device_ms']:.1f} ms of the "
          f"{ms:.1f} ms unprofiled step: idle share "
          f"{prof['idle_share_vs_step']:.3f}", flush=True)
    out["T2_profile"] = prof
    rows, out["train_kernel_timing"] = train_rows(torch, cfg, launches,
                                                  errs)
    del trainer, data
    gc.collect()
    torch.cuda.empty_cache()

    # T3: full fine-tuning, cut to T3_LAYERS layers at full width
    cut = dataclasses.replace(cfg, n_layers=T3_LAYERS)
    print(f"phase T3: full fine-tuning of {cfg.name} cut to {T3_LAYERS} of "
          f"{cfg.n_layers} layers (d {cut.d_model}, bf16), accum "
          f"{T3_ACCUM}, batch {T_BATCH} x {T_SEQ}", flush=True)
    p3 = init_params(cut, SEED + 23, "cuda")
    n_params = sum(p.numel() for p in p3.parameters())
    full = train_launch.Trainer(cut, steps=T3_STEPS, seed=SEED,
                                device="cuda", params=p3, accum=T3_ACCUM)
    data3 = full.batches(T_BATCH, T_SEQ, SEED + 1)
    b3 = next(data3)
    tree = tree_lib.param_tree(p3)
    leaves, names = tree_lib.leaves(tree), tree_lib.paths(tree)

    def full_grads():
        with train_lib.trainable(leaves):
            loss, _ = model_lib.loss(cut, p3, b3)
            return float(loss.detach()), train_lib.grads(loss, leaves,
                                                         names)

    for fn in counters.values():
        fn.launches = 0
    lk, gk = full_grads()
    check(counters["flash_attention"].launches > 0,
          "phase T3: flash never launched")
    with plain_ops(), plain_attention():
        lp, gp = full_grads()
    check(abs(lk - lp) <= 1e-2 * abs(lp), f"phase T3: loss {lk} vs plain "
          f"{lp}")
    worst3 = grads_close("phase T3 parameter gradients, kernels vs plain",
                         gk, gp, names)
    del gk, gp
    torch.cuda.reset_peak_memory_stats()
    recs3 = train_launch.run(full, data3, T3_STEPS, log_every=1)
    check(all(r["loss"] == r["loss"] and abs(r["loss"]) < 1e9
              for r in recs3), "phase T3: non-finite loss")
    out["T3"] = {"layers": T3_LAYERS, "params": n_params, "loss": lk,
                 "plain_loss": lp, "worst_grad_ratio": worst3,
                 "steps": recs3,
                 "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"  {n_params / 1e9:.3f} B parameters; {T3_STEPS} steps with "
          f"accum {T3_ACCUM}: losses {[r['loss'] for r in recs3]}, peak "
          f"{out['T3']['peak_mem_gib']:.2f} GiB", flush=True)
    out["T4_full"] = t4_arms(torch, cut, None, full, recs3,
                             out["T3"]["peak_mem_gib"], lora_rank=0,
                             steps=T3_STEPS, data_seed=SEED + 1,
                             init_seed=SEED + 23)
    del full, p3, tree, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return out, rows


def t4_arms(torch, cfg, params, graphed, graphed_recs, graphed_peak, *,
            lora_rank, steps, data_seed, init_seed=None):
    """Phase T4: the graphed trainer's `steps` steps (T2(c), or T3's) run
    again with graphs=False from the same init (the adapter's seeded
    draw; a full fine-tune's parameters from `init_seed`) on the same
    batches (the stream's first batch skipped, as phase T2(a) / T3 took
    it): each step's loss within 1e-2 of the eager one's and, after the
    last step, each trained leaf within 5e-2 of its max |eager|; the
    median ms a step of each arm, peak memory, the graph pool's bytes."""
    import numpy as np
    from repro_torch.launch import train as train_launch
    from repro_torch.models.weights import init_params
    from repro_torch.training import tree as tree_lib
    smi = smi_reading()
    what = f"LoRA rank {lora_rank}" if lora_rank else \
        f"full fine-tuning ({cfg.n_layers} layers, accum {T3_ACCUM})"
    print(f"phase T4: {cfg.name} {what}, graphed vs eager, {steps} steps "
          f"of {T_BATCH} x {T_SEQ}", flush=True)
    if params is None:
        params = init_params(cfg, init_seed, "cuda")
    eager = train_launch.Trainer(
        cfg, lora_rank=lora_rank, steps=graphed.opt_cfg.total_steps,
        seed=SEED, device="cuda", params=params, graphs=False,
        accum=T3_ACCUM if not lora_rank else 1)
    data = eager.batches(T_BATCH, T_SEQ, data_seed)
    next(data)
    torch.cuda.reset_peak_memory_stats()
    recs = train_launch.run(eager, data, steps, log_every=1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for g, e in zip(graphed_recs, recs):
        check(abs(g["loss"] - e["loss"]) <= 1e-2 * abs(e["loss"]),
              f"phase T4 {what}: step {e['step']} loss graphed "
              f"{g['loss']} vs eager {e['loss']}")
    tg, te = graphed.trained(), eager.trained()
    worst = grads_close(f"phase T4 {what}: trained leaves after step "
                        f"{steps}, graphed vs eager", tree_lib.leaves(tg),
                        tree_lib.leaves(te), tree_lib.paths(te))
    # the graphed arm's first step is its warm-up, its second its capture:
    # both arms' medians over the steps after them
    ms = {"graphed": float(np.median([r["ms"] for r in graphed_recs[2:]])),
          "eager": float(np.median([r["ms"] for r in recs[2:]]))}
    stats = graphed.graphs.stats().get("train", {})
    rec = {"losses_graphed": [r["loss"] for r in graphed_recs],
           "losses_eager": [r["loss"] for r in recs],
           "worst_leaf_ratio": worst, "ms_per_step_median": ms,
           "peak_mem_gib": {"graphed": graphed_peak, "eager": peak},
           "pool_bytes": graphed.graphs.pool_bytes(),
           "capture_s": stats.get("capture_s"),
           "replays": stats.get("replays")}
    check(graphed.graphs.capture and rec["replays"],
          f"phase T4 {what}: the graphed trainer never replayed")
    print(f"  T4 {what}: losses graphed {rec['losses_graphed']} / eager "
          f"{rec['losses_eager']}; median {ms['graphed']:.1f} / "
          f"{ms['eager']:.1f} ms a step from step 3 (graphed / eager); peak "
          f"{graphed_peak:.2f} / {peak:.2f} GiB; graph pool "
          f"{rec['pool_bytes']} B; capture {rec['capture_s']} s; {smi}",
          flush=True)
    del eager, data
    gc.collect()
    torch.cuda.empty_cache()
    return rec


# ----------------------------------------------------------- phase 3d ----

# 24 requests of 32-256 prompt tokens and 32 new ones each, 2 ms apart:
# every output stays inside the 512-slot ring, where a crash failover's
# replay is exact
CLUSTER_REQUESTS = {"n": 24, "seed": SEED + 4}
# (label, router, kernel, crash server 1 and restart it)
CLUSTER_ARMS = [("(a) rank_aware bgmv", "rank_aware", "bgmv", False),
                ("(b) rank_aware mbgmv", "rank_aware", "mbgmv", False),
                ("(c) most_idle bgmv", "most_idle", "bgmv", False),
                ("(d) rank_aware bgmv, crash", "rank_aware", "bgmv", True)]
SUMMARY_KEYS = ("n", "shed", "recovered", "failovers", "slo_attainment",
                "ttft_mean", "ttft_p99", "tpt_mean", "tpt_p99",
                "latency_mean", "cold_starts")


def cluster_phase(torch, cfg, params):
    """Phase 3d: two full-width llama2-7b servers over one copy of the
    weights (`params`; each server has its own page pool and adapter pool)
    behind the router, as a user runs `core.cluster.Cluster`. Arms on the
    same 24 requests: (a) Algorithm 1 over kernel="bgmv", (b) over "mbgmv"
    (the sum-rank law), (c) MOSTIDLE over "bgmv", (d) arm (a) with server 1
    crashed while its first request decodes and restarted later (times on
    the simulated timeline, read from arm (a)'s, which arm (d) repeats up
    to the crash). The SLO is the reference CLI's: 1.5 x DecPerf of a full
    batch at rank 64. Each arm must finish every request with its tokens,
    shed none, launch the flash, paged, shrink and expand kernels, and stay
    below the card's memory; (a)-(c) must route to both servers; (d) must
    crash, restart and recover a live request, and peak at most one KV
    pool above (a). Decode tokens/s come from CUDA-event spans around both
    servers' backend calls (`time_backend_calls`), summed."""
    import numpy as np
    from repro_torch.core.cluster import Cluster
    from repro_torch.core.faults import FaultEvent, FaultPlane
    from repro_torch.core.perf_model import ServerPerfModel
    from repro_torch.core.scheduler import make_scheduler
    print("phase 3d: a cluster of two full-width llama2-7b servers on the "
          "card behind the router", flush=True)
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    out, crash = [], None
    for label, policy, kernel, faulted in CLUSTER_ARMS:
        t_init = time.perf_counter()
        servers, uids = [], None
        for _ in range(2):
            srv, uids = make_server(torch, cfg, kernel, params)
            servers.append(srv)
        check(all(s.params is params for s in servers),
              f"{label}: the servers do not share the weights")
        perf = ServerPerfModel(cfg, kernel=kernel)
        slo = 1.5 * perf.dec_perf([64] * 8)
        reqs = make_requests(cfg, uids, slo_ms=slo, **CLUSTER_REQUESTS)
        sched = make_scheduler(policy, perf, slo_ms=slo) \
            if policy == "rank_aware" else make_scheduler(policy)
        plane = None
        if faulted:
            plane = FaultPlane([FaultEvent(crash[0], "crash", 1),
                                FaultEvent(crash[1], "restart", 1)])
        cl = Cluster(servers, sched, faults=plane)
        routes, route = [], cl._route

        def rec(req, now_ms=None, allow_shed=True):
            idx = route(req, now_ms=now_ms, allow_shed=allow_shed)
            routes.append((req.rid, idx, allow_shed))
            return idx

        cl._route = rec
        spans = {"prefill": [], "chunk": [], "decode": []}
        decode_tokens = [0]
        for srv in servers:
            time_backend_calls(torch, srv.backend, spans, decode_tokens)
        pool_bytes = sum(t.numel() * t.element_size()
                         for t in servers[0].backend.cache.values())
        counters = _counters()
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t_init
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        summary, states = cl.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {n: fn.launches for n, fn in counters.items()}
        decode_ms = float(sum(s.elapsed_time(e)
                              for s, e, _ in spans["decode"]))
        arrivals = [sum(1 for _, i, fresh in routes if fresh and i == k)
                    for k in range(2)]
        check(summary["n"] == len(reqs) and summary["shed"] == 0,
              f"{label}: {summary['n']} of {len(reqs)} requests finished, "
              f"{summary['shed']} shed")
        for st in states:
            check(len(st.generated) == st.req.max_new_tokens
                  and all(0 <= t < cfg.vocab for t in st.generated),
                  f"{label}: request {st.req.rid} produced "
                  f"{len(st.generated)} of {st.req.max_new_tokens} tokens")
        for n, c in launches.items():
            check(c > 0, f"{label}: kernel {n} never launched on the path")
        check(peak < card_bytes, f"{label}: peak {peak} B >= the card's "
              f"{card_bytes} B")
        if faulted:
            fs = cl.fault_stats
            check(fs["crashes"] == 1 and fs["restarts"] == 1
                  and summary["recovered"] > 0,
                  f"{label}: crashes {fs['crashes']}, restarts "
                  f"{fs['restarts']}, recovered {summary['recovered']}")
            check(peak <= out[0]["peak_mem_bytes"] + pool_bytes,
                  f"{label}: peak {peak} B grew by more than a KV pool "
                  f"({pool_bytes} B) over arm (a)'s")
        else:
            check(min(arrivals) > 0, f"{label}: routes {arrivals}: a "
                  "server took no request")
        graphs = [graph_check(x.backend, f"{label} server {i}")
                  for i, x in enumerate(servers)]
        rec_ = {"run": label, "policy": policy, "kernel": kernel,
                "requests": len(reqs), "slo_ms_simulated": slo,
                "routes_per_server": arrivals,
                "failover_routes": [i for _, i, fresh in routes
                                    if not fresh],
                "wall_s": wall, "setup_s": init_s,
                "prefill_calls": len(spans["prefill"]),
                "decode_calls": len(spans["decode"]),
                "decode_tokens": decode_tokens[0], "decode_ms": decode_ms,
                "decode_tok_s": 1e3 * decode_tokens[0] / decode_ms,
                "tok_s_wall": sum(len(st.generated) for st in states) / wall,
                "peak_mem_bytes": peak, "peak_mem_gib": peak / 2 ** 30,
                "kv_pool_bytes": pool_bytes, "launches": launches,
                "graphs": graphs, "fault_stats": dict(cl.fault_stats),
                "simulated_h100_timeline": {k: summary[k]
                                            for k in SUMMARY_KEYS},
                "generated": {st.req.rid: list(map(int, st.generated))
                              for st in states}}
        if faulted:
            a = out[0]["generated"]
            rec_["agree_with_a"] = sum(rec_["generated"][r] == a[r]
                                       for r in a)
            rec_["crash_restart_ms_simulated"] = list(crash)
        elif crash is None:
            # where arm (d) crashes server 1: midway through the decode of
            # the first request it serves in arm (a), on the simulated
            # timeline (which arm (d) repeats up to the crash), and where
            # it restarts: as long again after that
            first = min(servers[1].states, key=lambda st: st.first_token_ms)
            mid = 0.5 * (first.first_token_ms + first.finish_ms)
            crash = (mid, mid + (first.finish_ms - first.first_token_ms))
        sim = rec_["simulated_h100_timeline"]
        print(f"  {label}: routes per server {arrivals}, "
              f"{len(rec_['failover_routes'])} failovers; decode "
              f"{rec_['decode_tok_s']:.1f} tok/s over both servers; "
              f"{wall:.2f} s wall; peak {rec_['peak_mem_gib']:.2f} GiB; "
              f"launches {launches}; "
              + "; ".join(f"server {i} {graph_summary(g)}"
                          for i, g in enumerate(graphs)), flush=True)
        print(f"    simulated on the H100 timeline (not measured): SLO "
              f"{slo:.2f} ms/token, attainment {sim['slo_attainment']:.3f}, "
              f"TTFT mean {sim['ttft_mean']:.1f} ms, TPT mean "
              f"{sim['tpt_mean']:.2f} ms, recovered {sim['recovered']}"
              + (f"; tokens agree with (a) on {rec_['agree_with_a']}/"
                 f"{len(reqs)} requests" if faulted else ""), flush=True)
        out.append(rec_)
        # the wrapped router holds the cluster: drop every reference, so
        # the next arm's peak holds only its own two servers' pools
        del cl, servers, srv, states, sched, rec, route, routes
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------- phase 3e ----

FIT_STEPS, FIT_WARM = 32, 3


def perf_model_phase(torch, cfg, step):
    """Phase 3e: the paper's Fig 9 on the card. Phase 4a's decode step (8
    rows after one prefill) is run FIT_STEPS times per kernel law after
    FIT_WARM warm-ups; in each step |S| of the 8 rows (1-8) carry adapters
    of random ranks from {8, 16, 32, 64} and the rest idx -1. Each step is
    timed with CUDA events on the stream, no synchronization added, as in
    serving. Perf_BGMV = alpha |S| max r + beta and Perf_MBGMV = alpha sum r
    + beta are fitted with the port's `fit_linear`, beside the analytic
    `profile_and_fit` on the H100's data-sheet constants. No gate on R^2."""
    import numpy as np
    from repro_torch.core.perf_model import (batch_feature, fit_linear,
                                             profile_and_fit)
    from repro_torch.models import model as model_lib
    print("phase 3e: the rank-aware performance model on the card (Fig 9)",
          flush=True)
    srv = step["keepalive"][0]
    be = srv.backend
    pipe = be.pipe
    act = pipe.active & (pipe.pos < pipe.target)
    uids = sorted(srv.store.specs, key=lambda u: (srv.store.specs[u].rank,
                                                  u))
    stacked = be._lora_arg_stacked(uids)
    ranks_of = [srv.store.specs[u].rank for u in uids]
    rng = np.random.default_rng(SEED + 21)
    out = {}
    for kernel in ("bgmv", "mbgmv"):
        feats, rank_sets, evs = [], [], []
        for i in range(FIT_WARM + FIT_STEPS):
            n_s = int(rng.integers(1, 9))
            rows = rng.choice(8, n_s, replace=False)
            slots = rng.choice(len(uids), n_s)
            idx = np.full(8, -1, np.int32)
            idx[rows] = slots
            lora = {"pool": stacked["pool"], "mode": kernel,
                    "idx": torch.as_tensor(idx, device="cuda")}
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            with torch.no_grad():
                logits, _ = model_lib.decode(
                    cfg, be.params, be.cache, pipe.last_tok[:, None],
                    pipe.pos, lora=lora, write_mask=act,
                    block_table=pipe.block_table)
                logits[:, -1].argmax(-1)
            e.record()
            if i >= FIT_WARM:
                ranks = [ranks_of[j] for j in slots]
                rank_sets.append(ranks)
                feats.append(batch_feature(ranks, kernel))
                evs.append((s, e))
        torch.cuda.synchronize()
        ms = [s.elapsed_time(e) for s, e in evs]
        fit = fit_linear(feats, ms, kernel)
        model, _ = profile_and_fit(cfg, kernel)
        ratio = [model.predict(r) / m for r, m in zip(rank_sets, ms)]
        out[kernel] = {
            "steps": FIT_STEPS, "feature": feats, "step_ms": ms,
            "card_fit": {"alpha": fit.alpha, "beta": fit.beta, "r2": fit.r2},
            "analytic_h100": {"alpha": model.alpha, "beta": model.beta,
                              "r2": model.r2},
            "predicted_over_measured_mean": float(np.mean(ratio)),
            "step_ms_median": float(np.median(ms))}
        print(f"  {kernel}: card fit alpha {fit.alpha:.4e} ms, beta "
              f"{fit.beta:.3f} ms, R^2 {fit.r2:.3f} over {FIT_STEPS} steps "
              f"(median {np.median(ms):.2f} ms); analytic H100 model alpha "
              f"{model.alpha:.4e} ms, beta {model.beta:.3f} ms, R^2 "
              f"{model.r2:.3f}; predicted / measured step time "
              f"{np.mean(ratio):.3f}", flush=True)
    return out


# ------------------------------------------------------------ phase A ----

def f32_arms_phase(torch, cfg):
    """Phase A: are the yi-9b arms' bf16 differences (phase 3b) near-ties
    or a fault? Full-width yi-9b in float32 (seeded as in phase 3b), phase
    3b's requests, monolithic (the f32 flash kernel) and chunk_budget=512
    (plain chunk attention) arms; every request's tokens must agree. Where
    a request's tokens part, its common prefix (prompt + the tokens both
    arms emitted) is prefilled once through the flash kernel and once
    through the plain attention, and at the last position each side's
    top-2 logit margin is set beside the two sides' logit difference: a
    margin below the difference is a near-tie (recorded, not a failure),
    a margin above it a fault (the phase raises)."""
    from repro_torch.models import model as model_lib
    f32 = dataclasses.replace(cfg, dtype="float32")
    recs, params = serve_phase(torch, f32, [
        (f"f32 {label}", kernel, kw, req)
        for label, kernel, kw, req in YI_RUNS], "A")
    a, b = recs[0]["generated"], recs[1]["generated"]
    out = {"runs": [{k: r[k] for k in ("run", "requests", "tokens",
                                       "wall_s", "decode_tok_s",
                                       "peak_mem_gib", "launches")}
                    for r in recs],
           "requests": len(a), "agree": sum(a[r] == b[r] for r in a),
           "diverged": []}
    reqs = {r.rid: r for r in make_requests(cfg, [""] * 8, **YI_REQUESTS)}
    for rid in a:
        if a[rid] == b[rid]:
            continue
        k = next(i for i, (x, y) in enumerate(zip(a[rid], b[rid]))
                 if x != y)
        prefix = list(map(int, reqs[rid].prompt)) + a[rid][:k]
        toks = torch.as_tensor([prefix], dtype=torch.int32, device="cuda")

        def logits():
            with torch.no_grad():
                lg, _ = model_lib.prefill(f32, params, {"tokens": toks},
                                          last_only=True)
            return lg[0, -1].float()

        lk = logits()
        with plain_attention():
            lp = logits()
        margins = [float(t[0] - t[1]) for t in
                   (lk.topk(2).values, lp.topk(2).values)]
        diff = float((lk - lp).abs().max())
        tie = min(margins) < diff
        out["diverged"].append({
            "rid": rid, "prompt_tokens": reqs[rid].prompt_len,
            "first_differing_token": k, "top2_margin_flash": margins[0],
            "top2_margin_plain": margins[1], "logit_diff": diff,
            "max_abs_logit": float(lp.abs().max()), "near_tie": tie})
        print(f"  request {rid}: tokens part at {k}; top-2 margin flash "
              f"{margins[0]:.3e}, plain {margins[1]:.3e}; logit difference "
              f"{diff:.3e}; max |logit| {float(lp.abs().max()):.3e}: "
              f"{'near-tie' if tie else 'FAULT'}", flush=True)
        check(tie, f"phase A: request {rid} parts at token {k} with a "
              f"top-2 margin {min(margins):.3e} above the logit difference "
              f"{diff:.3e}: a fault, not a near-tie")
    print(f"  f32 yi-9b: monolithic and chunked arms agree on "
          f"{out['agree']}/{out['requests']} requests", flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phase F ----

# (config, layers kept on the card or None for all, an extra "mbgmv"
# run): each cut keeps the bf16 weights near 40 GiB (PERF.md section 4)
FAMILY = [("llama2-13b", None, True), ("llama2-70b", 24, False),
          ("qwen2-72b", 22, False), ("command-r-35b", 24, False),
          ("mistral-large-123b", 15, False), ("dbrx-132b", 6, True),
          ("grok-1-314b", 4, False)]
FAMILY_REQUESTS = {"n": 8, "seed": SEED + 5, "max_new": 16}
# whose decode step is profiled: the paper's second model, and a MoE
FAMILY_PROFILED = ("llama2-13b", "dbrx-132b")
SUMMARY_RUN_KEYS = ("run", "kernel", "requests", "tokens", "wall_s",
                    "setup_s", "prefill_calls", "prefill_ms_median",
                    "prefill_ms_max", "decode_calls", "decode_tokens",
                    "decode_ms", "decode_tok_s", "peak_mem_gib", "launches",
                    "transfer_stats")


def family_phase(torch):
    """Phase F: the rest of the decoder family at full width, one config at
    a time, each freed before the next: seeded bf16 weights on the card,
    depth cut as FAMILY says, served as phase 3a serves llama2-7b (8
    requests of 32-256 prompt tokens, 16 new tokens, bgmv; mbgmv too on
    llama2-13b and dbrx-132b) with every kernel's launches checked, then
    one decode step's logits through the kernels against the plain
    versions (on the MoE configs with the kernel pass's routing replayed
    and compared layer by layer: `moe_agreement`), profiled on
    FAMILY_PROFILED. Returns the
    per-config summaries and phase 5a's paged-attention row at
    mistral-large's first decode step (GQA group 12)."""
    from repro_torch.configs.base import get_config
    print(f"phase F: the rest of the decoder family at full width on "
          f"{smi_reading()}", flush=True)
    out, row = [], None
    for name, layers, mbgmv in FAMILY:
        full = get_config(name)
        cfg = dataclasses.replace(full, n_layers=layers or full.n_layers)
        runs = [("bgmv", "bgmv", {}, FAMILY_REQUESTS)]
        if mbgmv:
            runs.append(("mbgmv", "mbgmv", {}, FAMILY_REQUESTS))
        capture = {}
        with capture_first_decode(capture):
            recs, params = serve_phase(torch, cfg, runs, "F")
        weights = sum(t.numel() * t.element_size()
                      for t in params.parameters()) / 2 ** 30
        step = logits_phase(torch, cfg, params, phase="F",
                            profile=name in FAMILY_PROFILED)
        if name == "mistral-large-123b":
            row = paged_capture_timing(
                torch, capture["decode"], recs, "paged_attention"
                "[mistral-large]", "mistral-large decode")
        out.append({
            "model": name, "layers": cfg.n_layers,
            "published_layers": full.n_layers,
            "gqa_group": cfg.n_heads // cfg.n_kv_heads,
            "weights_gib": weights,
            "runs": [{k: r[k] for k in SUMMARY_RUN_KEYS} for r in recs],
            "decode_logits": step["logits"],
            "decode_profile": step.get("profile")})
        print(f"  {name}: {cfg.n_layers}/{full.n_layers} layers, "
              f"{weights:.2f} GiB of weights, peak "
              f"{max(r['peak_mem_gib'] for r in recs):.2f} GiB", flush=True)
        del step, params, capture, recs
        gc.collect()
        torch.cuda.empty_cache()
    return out, row


# ------------------------------------------------------------ phase G ----

# (config, kernels of its serving runs, dtype of its logits check): every
# config whole, at its published widths; whisper-tiny goes through the
# model API only. mamba2's logits are held in float32: in bf16 a rounding-
# level change of the plain path alone moves its logits by up to half of
# max |logit| (the control of `g_logits_bf16_diagnostic`; PERF.md, PR 18)
FAMILY_G = [("mamba2-130m", ("bgmv", "mbgmv"), "float32"),
            ("recurrentgemma-2b", ("bgmv",), "bfloat16"),
            ("phi-3-vision-4.2b", ("bgmv",), "bfloat16")]
G_REQUESTS = {"n": 8, "seed": SEED + 6, "max_new": 16}
G_LONG = 3000                  # recurrentgemma's logits prompt: > window
WHISPER_PROMPT, WHISPER_NEW, WHISPER_ROWS = 64, 16, 4


def other_families_phase(torch, errs):
    """Phase G: the non-decoder families at full width and full depth, one
    config at a time, each freed before the next: seeded bf16 weights on
    the card; mamba2-130m and recurrentgemma-2b served on the dense plane,
    phi-3-vision-4.2b on the paged plane (8 requests of 32-256 prompt
    tokens, 16 new, bgmv; mamba2 also mbgmv), every request finishing and
    every kernel of the path launching; then one 2-row prefill and one
    decode step's logits through the kernels against the plain versions
    (`g_logits`), and whisper-tiny through the model API (`whisper_g`).
    Returns the per-config summaries and phase 5b's flash rows at hd 96
    and 256 (layer 0 of the largest captured serving prefill)."""
    from repro_torch.configs.base import get_config
    print(f"phase G: mamba2, recurrentgemma, phi-3-vision and whisper at "
          f"full width on {smi_reading()}", flush=True)
    from repro_torch.models.weights import init_params
    out, rows = [], []
    for name, kernels, logits_dtype in FAMILY_G:
        cfg = get_config(name)
        runs = [(k, k, {}, G_REQUESTS) for k in kernels]
        capture = {}
        with capture_largest_attention(capture):
            recs, params = serve_phase(torch, cfg, runs, "G")
        weights = sum(t.numel() * t.element_size()
                      for t in params.parameters()) / 2 ** 30
        graphs = None
        if name in P3_MODELS:
            graphs = p3_arms(torch, cfg, params, kernels[0])
        if logits_dtype == cfg.dtype:
            logits = g_logits(torch, cfg, params,
                              profile=name == "recurrentgemma-2b")
        else:
            logits = {"bf16_diagnostic": g_logits_bf16_diagnostic(
                torch, cfg, params)}
            cfg_s = dataclasses.replace(cfg, dtype=logits_dtype)
            params_s = init_params(cfg_s, SEED, "cuda")
            logits.update(g_logits(torch, cfg_s, params_s))
            del params_s
        if cfg.hd in (96, 256) and "args" in capture:
            rows.append(flash_timing(
                torch, capture["args"], errs[f"flash_attention[hd {cfg.hd}]"],
                recs,
                name=f"flash_attention[hd {cfg.hd}]",
                path=f"{name} prefill", window=(cfg.hybrid.window
                                                if cfg.hybrid else None)))
        out.append({
            "model": name, "layers": cfg.n_layers, "weights_gib": weights,
            "memory": recs[0]["memory"],
            "runs": [{k: r[k] for k in SUMMARY_RUN_KEYS} for r in recs],
            "logits": logits, "graphed_vs_eager": graphs})
        print(f"  {name}: {cfg.n_layers} layers (whole), {weights:.2f} GiB "
              f"of weights, peak "
              f"{max(r['peak_mem_gib'] for r in recs):.2f} GiB", flush=True)
        del params, capture, recs
        gc.collect()
        torch.cuda.empty_cache()
    out.append(whisper_g(torch))
    gc.collect()
    torch.cuda.empty_cache()
    return out, rows


# phase P3: the phase-G configs served again with graphs=False; P4
# profiles mamba2's prefill
P3_MODELS = ("mamba2-130m", "phi-3-vision-4.2b")


def p3_arms(torch, cfg, params, kernel):
    """Phase P3: phase G's requests of `cfg` served twice on one server
    (so that prefill buckets come again), graphed and with graphs=False,
    on the same weights: tokens and launch counts equal, the median
    prefill ms of each arm over all calls and over the calls that
    replayed; on mamba2 also P4's profiled prefill of each arm."""
    smi = smi_reading()
    arms = [serve_phase(torch, cfg, [
        (f"{kernel} x2 {arm}", kernel, {"graphs": arm == "graphed"},
         G_REQUESTS)], "P3", params=params, repeat=2)[0][0]
        for arm in ("graphed", "eager")]
    out = {"p3": p_compare("P3", *arms, smi)}
    if cfg.family == "ssm":
        out["p4"] = {arm: profile_prefill(torch, cfg, params,
                                          graphs=arm == "graphed", smi=smi)
                     for arm in ("graphed", "eager")}
    return out


def g_pool(torch, cfg, ranks=(16, 64)):
    """A LoRA slot pool on the card holding one adapter a rank, drawn from
    a seeded generator at `make_adapter_weights`' scales (the hash-seeded
    adapters differ from process to process), so the check sees the same
    adapters in every run and in either dtype."""
    from repro_torch.core import lora as lora_lib
    pool = lora_lib.pool_init(cfg, len(ranks), "cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 16)
    L, r_max = cfg.n_layers + cfg.n_enc_layers, cfg.lora.max_rank
    for s, r in enumerate(ranks):
        w, r = {}, min(r, r_max)
        for tgt in cfg.lora.targets:
            d_in, d_out = lora_lib.lora_target_dims(cfg, tgt)
            a = torch.zeros(L, d_in, r_max, device="cuda")
            b = torch.zeros(L, r_max, d_out, device="cuda")
            a[:, :, :r] = torch.randn(L, d_in, r, generator=g,
                                      device="cuda") * d_in ** -0.5
            b[:, :r] = torch.randn(L, r, d_out, generator=g,
                                   device="cuda") * r ** -0.5
            w[tgt] = {"a": a.to(cfg.torch_dtype), "b": b.to(cfg.torch_dtype)}
        lora_lib.pool_insert(pool, cfg, w, s, r)
    return pool


def logits_close(torch, what, lk, lp, verbose=True, strict=True):
    """Every row of `lk` within LOGIT_TOL x max |lp| of `lp` (with
    `strict` False: measured and printed, not held)."""
    check(bool(torch.isfinite(lk).all()), f"{what}: non-finite logits")
    scale = float(lp.abs().max())
    err = (lk - lp).abs().flatten(1).amax(1)
    bad = (err > LOGIT_TOL * scale).nonzero()
    check(not (strict and bad.numel()),
          f"{what}: row {int(bad[0]) if bad.numel() else 0}"
          f" max abs err {float(err.max()):.3e} > {LOGIT_TOL} * "
          f"{scale:.3e}")
    same = int((lk.argmax(-1) == lp.argmax(-1)).sum())
    if verbose:
        print(f"  {what}: logits max abs err {float(err.max()):.4e}, max "
              f"|logit| {scale:.4e}, relative {float(err.max()) / scale:.3e}"
              f" (limit {LOGIT_TOL}); greedy agree {same}/{lk.shape[0]}",
              flush=True)
    return {"max_abs_err": float(err.max()), "max_abs_logit": scale,
            "rel_err": float(err.max()) / scale, "rows": lk.shape[0],
            "greedy_agree": same}


def g_logits(torch, cfg, params, profile=False, strict=True, label="",
             kernels=True, phase="G"):
    """One prefill of 2 rows (LoRA slots of rank 16 and 64) and one decode
    step from its caches, through the kernels and through the plain
    versions (the decode step's input token is the kernel pass's in both):
    the prefill's last-position logits and the step's logits of every row
    within LOGIT_TOL x max |logit|. recurrentgemma's prompt has G_LONG
    tokens, past its 2,048-token window, so the window cuts inside the
    flash kernel and the local-attention ring wraps; phi-3-vision's rows
    start with its 576 patch embeddings (seeded) and decode on the paged
    pool (the paged kernel). Kernel launches are counted over the kernel
    pass. With `profile`, one decode step is profiled; with `strict`
    False the logits are measured, not held (a diagnostic); `kernels`
    False: the first pass is routed elsewhere by the caller, and its
    launches are not checked."""
    import numpy as np
    from repro_torch.models import model as model_lib
    from repro_torch.serving import cache as cache_lib
    rng = np.random.default_rng(SEED + 12)
    B = 2
    L = G_LONG if cfg.hybrid else 256
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (B, L)),
                           dtype=torch.int32, device="cuda")
    batch = {"tokens": toks}
    P0 = cfg.n_prefix_tokens if cfg.family == "vlm" else 0
    if P0:
        g = torch.Generator(device="cuda").manual_seed(SEED + 13)
        batch["prefix_embeds"] = torch.randn(
            B, P0, cfg.d_model, generator=g, device="cuda").to(
            cfg.torch_dtype)
    lora = {"pool": g_pool(torch, cfg),
            "idx": torch.arange(B, dtype=torch.int32, device="cuda"),
            "mode": "bgmv"}
    paged = model_lib.supports_paged(cfg)
    ps = 32
    S = -(-(P0 + L + 16) // ps) * ps
    pos = torch.full((B,), P0 + L, dtype=torch.int32, device="cuda")
    state = {}

    def prefill():
        with torch.no_grad():
            lg, cache = model_lib.prefill(cfg, params, batch, lora=lora,
                                          cache_slots=S, last_only=True)
        bt = None
        if paged:
            W = S // ps
            bt = torch.arange(B * W, dtype=torch.int32,
                              device="cuda").reshape(B, W)
            pool = cache_lib.zeros_paged(model_lib.cache_abstract(cfg, 1, S),
                                         B * W, ps, "cuda")
            cache = cache_lib.scatter_pages(pool, cache, bt.cpu().numpy())
        return lg[:, -1].float(), cache, bt

    def decode(cache, bt, tok):
        with torch.no_grad():
            lg, _ = model_lib.decode(cfg, params, cache, tok[:, None], pos,
                                     lora=lora, block_table=bt)
        return lg[:, -1].float()

    def clone(cache):
        if isinstance(cache, list):
            return [{n: t.clone() for n, t in c.items()} for c in cache]
        return {n: t.clone() for n, t in cache.items()}

    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    pk, cache_k, bt = prefill()
    tok = pk.argmax(-1).to(torch.int32)
    dk = decode(clone(cache_k), bt, tok)
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in counters.items()}
    with plain_ops(), plain_attention():
        pp, cache_p, bt_p = prefill()
        dp = decode(cache_p, bt_p, tok)
    torch.cuda.synchronize()
    n_attn = attention_layers(cfg)
    check(launches["flash_attention"] == n_attn,
          f"phase {phase} {cfg.name}: {launches['flash_attention']} flash "
          f"launches for {n_attn} attention layers")
    check(not kernels or (launches["lora_shrink"] > 0
                          and launches["lora_expand"] > 0),
          f"phase {phase} {cfg.name}: the LoRA kernels did not launch")
    check((launches["paged_attention"] > 0) == paged,
          f"phase {phase} {cfg.name}: paged attention launched "
          f"{launches['paged_attention']} times (paged plane: {paged})")
    print(f"phase {phase}: {cfg.name} logits{label} ({cfg.dtype}), prefill "
          f"of {B}"
          f" x {P0 + L} tokens and one decode step, kernels vs plain "
          f"versions; launches {launches}", flush=True)
    state["prefill"] = logits_close(torch, f"{cfg.name} prefill", pk, pp,
                                    strict=strict)
    state["decode"] = logits_close(torch, f"{cfg.name} decode step", dk, dp,
                                   strict=strict)
    state["launches"] = launches
    state["prompt_tokens"] = P0 + L
    if profile:
        state["profile"] = profile_step(
            torch, lambda: decode(clone(cache_k), bt, tok),
            f"one {cfg.name} decode step ({B} rows, pos {P0 + L})")
    return state


@contextlib.contextmanager
def lora_without_cast():
    """Route the model's LoRA delta to the plain version with the f32
    shrink fed to the expand uncast (the reference's `lora_delta_ref`
    rounding; the kernels and `plain_ops` cast it to x's dtype first): the
    same function, rounded elsewhere."""
    from repro_torch.kernels import ops, ref
    saved = ops.lora_delta

    def nocast(x, a, b, idx, ranks=None, mode="bgmv", rank_block=16,
               live=None):
        if live is None:
            live = ops.lora_live(idx, ranks, mode, a.shape[-1], rank_block)
        return ref.lora_expand_ref(ref.lora_shrink_ref(x, a, idx, live), b,
                                   idx, live)

    ops.lora_delta = nocast
    try:
        yield
    finally:
        ops.lora_delta = saved


def g_logits_bf16_diagnostic(torch, cfg, params):
    """mamba2 in bf16: the kernels-vs-plain logit gap of `g_logits`,
    measured, beside a control that changes only the plain path's
    rounding (`lora_without_cast` vs `plain_ops`): where the control moves
    the logits as much as the kernels do, the bf16 comparison cannot tell
    a kernel fault from the model's sensitivity to rounding, and the
    check is held in float32 instead (FAMILY_G)."""
    out = {"kernels_vs_plain": g_logits(torch, cfg, params, strict=False)}
    with lora_without_cast():
        ctl = g_logits(torch, cfg, params, strict=False, kernels=False,
                       label=" control: plain without the LoRA cast")
    out["control"] = {k: ctl[k] for k in ("prefill", "decode")}
    return out


def whisper_g(torch):
    """whisper-tiny through the model API, as its callers drive it (the
    serving engine has no encoder input to pass): WHISPER_ROWS rows of
    seeded frame embeddings (enc_seq 1,500 x d 384) and WHISPER_PROMPT
    prompt tokens, LoRA q/k/v on (ranks 16 and 64, and a row without),
    then WHISPER_NEW greedy tokens. The kernel pass's tokens are fed to a
    plain pass too; the prefill's and every step's logits within
    LOGIT_TOL x max |logit|. Prefill and decode are timed with CUDA
    events."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.models.weights import init_params
    cfg = get_config("whisper-tiny")
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, SEED, "cuda")
    weights = sum(t.numel() * t.element_size()
                  for t in params.parameters()) / 2 ** 30
    B = WHISPER_ROWS
    rng = np.random.default_rng(SEED + 14)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (B, WHISPER_PROMPT)),
                           dtype=torch.int32, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 15)
    enc = torch.randn(B, cfg.enc_seq, cfg.d_model, generator=g,
                      device="cuda").to(cfg.torch_dtype)
    lora = {"pool": g_pool(torch, cfg),
            "idx": torch.tensor([0, 1, -1, 1][:B], dtype=torch.int32,
                                device="cuda"), "mode": "bgmv"}
    slots = WHISPER_PROMPT + WHISPER_NEW

    def run(feed=None):
        """Greedy generation (or, given `feed`, those tokens as inputs);
        returns (stacked logits, tokens, prefill ms, decode ms)."""
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        with torch.no_grad():
            ev[0].record()
            lg, cache = model_lib.prefill(
                cfg, params, {"tokens": toks, "enc_embeds": enc}, lora=lora,
                cache_slots=slots, last_only=True)
            ev[1].record()
            out, new = [lg[:, -1].float()], []
            for t in range(WHISPER_NEW):
                tok = out[-1].argmax(-1).to(torch.int32) if feed is None \
                    else feed[t]
                new.append(tok)
                pos = torch.full((B,), WHISPER_PROMPT + t,
                                 dtype=torch.int32, device="cuda")
                lg, cache = model_lib.decode(cfg, params, cache,
                                             tok[:, None], pos, lora=lora)
                out.append(lg[:, -1].float())
            ev[2].record()
        torch.cuda.synchronize()
        return (torch.stack(out), new, ev[0].elapsed_time(ev[1]),
                ev[1].elapsed_time(ev[2]))

    print("phase G: whisper-tiny through model.prefill / model.decode "
          f"({B} rows x {WHISPER_PROMPT} tokens over {cfg.enc_seq} frames, "
          f"{WHISPER_NEW} greedy tokens)", flush=True)
    run()                                  # warm-up (first calls)
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    lk, new, pre_ms, dec_ms = run()
    launches = {n: fn.launches for n, fn in counters.items()}
    with plain_ops(), plain_attention():
        lp, _, _, _ = run(feed=new)
    # the encoder's layers, the decoder's self- and cross-attention
    want = cfg.n_enc_layers + 2 * cfg.n_layers
    check(launches["flash_attention"] == want,
          f"phase G whisper: {launches['flash_attention']} flash launches, "
          f"{want} expected")
    check(launches["lora_shrink"] > 0 and launches["lora_expand"] > 0,
          "phase G whisper: the LoRA kernels did not launch")
    check(launches["paged_attention"] == 0,
          "phase G whisper: paged attention launched")
    errs = [logits_close(torch, f"whisper-tiny step {t}", lk[t], lp[t],
                         verbose=False) for t in range(lk.shape[0])]
    worst = max(errs, key=lambda e: e["rel_err"])
    rec = {"model": cfg.name, "layers": cfg.n_layers,
           "enc_layers": cfg.n_enc_layers, "weights_gib": weights,
           "rows": B, "prompt_tokens": WHISPER_PROMPT,
           "new_tokens": WHISPER_NEW, "prefill_ms": pre_ms,
           "decode_ms": dec_ms,
           "decode_tok_s": 1e3 * B * WHISPER_NEW / dec_ms,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": launches, "logits_worst": worst,
           "generated": [[int(t[b]) for t in new] for b in range(B)]}
    print(f"  whisper-tiny: prefill {pre_ms:.1f} ms, decode "
          f"{rec['decode_tok_s']:.1f} tok/s ({dec_ms:.1f} ms for "
          f"{WHISPER_NEW} steps), peak {rec['peak_mem_gib']:.2f} GiB, "
          f"{weights:.3f} GiB of weights; launches {launches}; worst step "
          f"relative err {worst['rel_err']:.3e}", flush=True)
    del params
    return rec


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


def eager_call(what, key, store):
    """A hook that records a Python call must see an eager one: a CUDA
    graph's replay runs no Python, and a capture executes nothing, so a
    record made under a capture would hold no values. Raise if `store`
    still lacks `key` under a capture."""
    import torch
    if key not in store:
        check(not torch.cuda.is_current_stream_capturing(),
              f"{what}: the first call is under a CUDA-graph capture")
        return True
    return False


@contextlib.contextmanager
def capture_first_calls(store):
    """Record the arguments of the first paged-attention and LoRA-delta
    call (layer 0) of a decode step, for phase 5a's timing."""
    from repro_torch.kernels import ops
    saved = ops.paged_attention, ops.lora_delta

    def pa(*a):
        if eager_call("capture_first_calls", "paged_attention", store):
            store["paged_attention"] = a
        return saved[0](*a)

    def ld(*a, **kw):
        if eager_call("capture_first_calls", "lora_delta", store):
            store["lora_delta"] = (a, kw)
        return saved[1](*a, **kw)

    ops.paged_attention, ops.lora_delta = pa, ld
    try:
        yield
    finally:
        ops.paged_attention, ops.lora_delta = saved


@contextlib.contextmanager
def capture_largest_attention(store):
    """Record the arguments of the largest prefill-attention call (its
    first layer) while serving, for phase 5b's timing."""
    import torch
    from repro_torch.kernels import ops
    saved = ops.attention

    def attn(q, k, v, **kw):
        # a graphed prefill key's eager first call was seen already; its
        # capture records no values
        if not (q.is_cuda and torch.cuda.is_current_stream_capturing()) \
                and ("args" not in store
                     or q.numel() > store["args"][0].numel()):
            store["args"] = (q, k, v)
        return saved(q, k, v, **kw)

    ops.attention = attn
    try:
        yield
    finally:
        ops.attention = saved


YI_LONG_POS = 2048            # phase 5a's yi-9b decode call holds a row here


@contextlib.contextmanager
def capture_first_decode(store):
    """Clone the arguments of the first paged-attention call while serving
    (layer 0 of the first decode step of the first run: the yi-9b
    monolithic arm; a key's first call runs eagerly, so a graphed server's
    first decode is seen), for phase 5a's yi-9b row; the pool and tables
    change in place afterwards."""
    from repro_torch.kernels import ops
    saved = ops.paged_attention

    def pa(*a):
        if eager_call("capture_first_decode", "decode", store):
            store["decode"] = tuple(t.clone() for t in a)
        return saved(*a)

    ops.paged_attention = pa
    try:
        yield
    finally:
        ops.paged_attention = saved


@contextlib.contextmanager
def plain_attention():
    """Route the model's prefill attention to the plain version (on the
    card)."""
    from repro_torch.kernels import ops, ref
    saved = ops.attention
    ops.attention = ref.flash_attention_ref
    try:
        yield
    finally:
        ops.attention = saved


def logits_phase(torch, cfg, params, phase="4a", profile=True):
    """Phase 4a: admit 8 requests at once, serve them up to their first
    decode step, then run
    the next decode step twice on copies of the KV pool — through the
    kernels and through the plain versions — and compare the logits of
    every row. On a MoE config the plain pass replays the kernel pass's
    expert choices (`replay_routing`), so that both fill each expert's
    capacity alike and the routing is compared layer by layer
    (`moe_agreement`)."""
    from repro_torch.models import model as model_lib
    from repro_torch.models.moe import record_routing
    print(f"phase {phase}: {cfg.name} decode-step logits, kernels vs plain "
          "versions", flush=True)
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

    with capture_first_calls(store), record_routing() as routes_k:
        lk, cache_k = step_logits()
    with plain_ops(), replay_routing(routes_k), \
            record_routing() as routes_p:
        lp, _ = step_logits()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(lk).all()), f"phase {phase}: non-finite "
          "logits")
    moe = moe_agreement(torch, cfg, routes_k, routes_p, phase) \
        if cfg.moe else {}
    scale = float(lp.abs().max())
    err = float((lk - lp).abs().max())
    check(err <= LOGIT_TOL * scale,
          f"phase {phase}: logits max abs err {err:.3e} > {LOGIT_TOL} * "
          f"{scale:.3e}")
    same = int((lk.argmax(-1) == lp.argmax(-1))[act].sum())
    note = ""
    if cfg.moe:
        note = (f"; expert drops per layer {moe['drops_kernels']} / "
                f"{moe['drops_plain']} (kernels / plain, routing replayed), "
                f"router probabilities within {moe['max_prob_delta']:.2e}, "
                f"near-ties the replay took {moe['near_ties']}")
    print(f"  logits max abs err {err:.4e}, max |logit| {scale:.4e}, "
          f"relative {err / scale:.3e} (limit {LOGIT_TOL}); greedy tokens "
          f"agree on {same}/{int(act.sum())} active rows{note}", flush=True)
    if profile:
        store["profile"] = profile_step(torch, step_logits,
                                        f"one {cfg.name} decode step")
    store["pool_ranks"] = be.pool.pool["ranks"]
    store["logits"] = {"max_abs_err": err, "max_abs_logit": scale,
                       "rel_err": err / scale, "rows": int(act.sum()),
                       "greedy_agree": same, **moe}
    store["keepalive"] = (srv, cache_k)
    return store


@contextlib.contextmanager
def replay_routing(routes):
    """Make each MoE layer choose the experts that the matching call in
    `routes` (the kernel pass's, in call order) chose, with gates from its
    own router probabilities. A bf16 move of ~3e-3 in a router
    probability can flip a near-tied expert and change that row by O(1);
    replayed, both passes fill each expert's capacity alike, so their
    drops are equal and every row's logits are comparable."""
    from repro_torch.models import moe
    saved, calls = moe.top_k, iter(routes)

    def replayed(probs, k):
        idx = next(calls)["idx"]
        check(idx.shape == probs.shape[:-1] + (k,), "replay_routing: the "
              "plain pass routed other shapes than the kernel pass")
        return probs.gather(-1, idx), idx

    moe.top_k = replayed
    try:
        yield
    finally:
        moe.top_k = saved


def moe_agreement(torch, cfg, routes_k, routes_p, phase):
    """Compare one decode step's routing through the kernels (routes_k)
    and through the plain versions replaying it (routes_p), layer by
    layer (one group: every row of the step). Checked: each layer's
    chosen experts, kept assignments and drop count are equal. Reported:
    the largest router-probability move between the passes, and the rows
    whose plain probabilities alone would have chosen other experts (the
    near-ties the replay took), each with the plain margin between its
    k-th and (k+1)-th expert and its probability move."""
    from repro_torch.models.moe import top_k
    k = cfg.moe.top_k
    check(len(routes_k) == len(routes_p) == cfg.n_layers,
          f"phase {phase}: {len(routes_k)} / {len(routes_p)} MoE calls "
          f"for {cfg.n_layers} layers")
    ties, max_delta = [], 0.0
    for layer, (a, b) in enumerate(zip(routes_k, routes_p)):
        check(torch.equal(a["idx"], b["idx"])
              and torch.equal(a["keep"], b["keep"]),
              f"phase {phase}: layer {layer}: the replayed routing differs")
        pa, pb = a["probs"][0], b["probs"][0]                  # (rows, E)
        delta = (pa - pb).abs().amax(-1)                       # (rows,)
        max_delta = max(max_delta, float(delta.max()))
        own = top_k(pb, k)[1].sort(-1).values
        chosen = a["idx"][0].sort(-1).values
        for r in (own != chosen).any(-1).nonzero()[:, 0].tolist():
            top = pb[r].sort(descending=True).values
            ties.append({"layer": layer, "row": r,
                         "margin": float(top[k - 1] - top[k]),
                         "prob_move": float(delta[r])})
    drops = [[int(r["dropped"]) for r in rs] for rs in (routes_k, routes_p)]
    check(drops[0] == drops[1], f"phase {phase}: expert drops per layer "
          f"{drops[0]} through the kernels, {drops[1]} through the plain "
          "versions")
    return {"near_ties": ties, "max_prob_delta": max_delta,
            "drops_kernels": drops[0], "drops_plain": drops[1]}


def prefill_phase(torch, cfg, params):
    """Phase 4b: yi-9b prefill logits at one long prompt per row (B 2,
    3,000 tokens: no multiple of the kernel's 64-row tiles) through the
    flash kernel and through the plain attention, every other op the
    same; then a profile of one prefill call at the serving shape (8 rows
    x 4,096 tokens, LoRA on through 8 stacked adapters, row caches
    written), as `prefill_admitted` makes it."""
    import numpy as np
    from repro_torch.models import model as model_lib
    print("phase 4b: yi-9b prefill logits, flash kernel vs plain attention",
          flush=True)
    rng = np.random.default_rng(SEED + 11)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 3000)),
                           dtype=torch.int32, device="cuda")

    def logits():
        with torch.no_grad():
            out, _ = model_lib.prefill(cfg, params, {"tokens": toks},
                                       last_only=True)
        return out[:, -1].float()

    lk = logits()
    with plain_attention():
        lp = logits()
    torch.cuda.synchronize()
    err = float((lk - lp).abs().max())
    scale = float(lp.abs().max())
    check(bool(torch.isfinite(lk).all()), "phase 4b: non-finite logits")
    check(err <= LOGIT_TOL * scale,
          f"phase 4b: logits max abs err {err:.3e} > {LOGIT_TOL} * "
          f"{scale:.3e}")
    same = int((lk.argmax(-1) == lp.argmax(-1)).sum())
    print(f"  prefill logits max abs err {err:.4e}, max |logit| "
          f"{scale:.4e}, relative {err / scale:.3e} (limit {LOGIT_TOL}); "
          f"greedy tokens agree on {same}/2 rows", flush=True)
    out = {"prefill_logits": {"max_abs_err": err, "max_abs_logit": scale,
                              "rel_err": err / scale, "rows": 2,
                              "prompt_tokens": 3000, "greedy_agree": same}}

    srv, uids = make_server(torch, cfg, "bgmv", params, **YI_SERVER)
    lora = srv.backend._lora_arg_stacked(uids)
    lora["mode"] = "bgmv"
    big = torch.as_tensor(rng.integers(0, cfg.vocab, (8, 4096)),
                          dtype=torch.int32, device="cuda")
    last = torch.full((8,), 4095, dtype=torch.int32, device="cuda")

    def prefill_call():
        with torch.no_grad():
            model_lib.prefill(cfg, params, {"tokens": big}, lora=lora,
                              cache_slots=4096, last_pos=last)

    store = {}
    with capture_first_calls(store):
        prefill_call()                   # layer 0's LoRA shrink, captured
    out["prefill_lora"] = store["lora_delta"]
    out["prefill_profile"] = profile_step(
        torch, prefill_call, "one yi-9b prefill call (8 x 4096 tokens)")
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    return out


def profile_step(torch, step_fn, what, top=16):
    """Where one call's time goes: torch.profiler over a warm call, device
    time summed by kernel name, and the call's wall time, so the device's
    idle share shows."""
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
    print(f"  {what}, synchronized and profiled (a per-layer "
          f"diagnostic): {wall_ms:.1f} ms wall, {device_ms:.1f} ms of "
          "device kernels", flush=True)
    for r in rows[:top]:
        print(f"    {r['device_ms']:8.3f} ms {r['calls']:5d}x {r['name']}",
              flush=True)
    return out


# ------------------------------------------------------------ phase 5 ----

def time_ms(torch, fn, flush, n=100, warm=3):
    """Mean device time of fn over n launches, each started with a cold
    L2 (flushed by an untimed write), after `warm` warm-up launches."""
    for _ in range(warm):
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


def host_ms(torch, fn, n=20):
    """Mean host time of one call of fn (a wrapper's checks, plan, tensor
    maps and launch), n calls queued with no sync between them. Where it
    outlasts the L2 flush that time_ms queues before each launch, the
    device idles inside time_ms's events."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    return 1e3 * t


def graph_ms(torch, fn, flush, n=20, reps=5):
    """Mean device time of fn as a graphed step launches it: n launches,
    each after an L2 flush, captured in one CUDA graph and replayed
    `reps` times (CUDA events), less the same graph of flushes alone. No
    wrapper host work lies between the launches, as in a replay."""
    stream = torch.cuda.Stream()
    per = []
    for body in (lambda: (flush(), fn()), flush):
        body()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        gc.collect()
        gc.disable()          # a graph destroyed mid-capture voids it
        try:
            with torch.cuda.graph(g, stream=stream):
                for _ in range(n):
                    body()
        finally:
            gc.enable()
        g.replay()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            g.replay()
        e.record()
        e.synchronize()
        per.append(s.elapsed_time(e) / (reps * n))
        del g
    return per[0] - per[1]


def bound(nbytes, ops, dtype_name):
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = ops / PEAK_OPS_PER_S[dtype_name]
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def paged_row(torch, args, flush, **meta):
    """A kernels-line row for one paged-attention call: its time beside
    its bound (each claimed page of K and V read once, q read and out
    written once; 4 flops a valid slot and head dim per query head), the
    plain version and SDPA over the gathered pages with K/V repeated
    across each GQA group (timed only, never called by the port); also
    both as a graphed step launches them (`graph_ms`). `shape.route` names
    the kernel (kernels/paged.py: ROUTES)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.bgmv import sm_count
    from repro_torch.kernels.paged import (ROUTES, launch_tiles,
                                           paged_attention, route,
                                           split_plan)
    from repro_torch.models.layers import paged_kv_for_attn
    q, k, v, pp, bt, pos = args
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
    kd = kd.repeat_interleave(H // KV, dim=1)
    vd = vd.repeat_interleave(H // KV, dim=1)
    mask = ((kp >= 0) & (kp <= pos[:, None]))[:, None, None, :]
    qs = q[:, :, None, :]
    tiles = launch_tiles(H // KV, hd, q.dtype)
    return {
        "name": meta["name"], "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged.py:107",
        "path": meta["path"], "launches": meta["launches"],
        "max_abs_err": meta["max_abs_err"],
        "ms": time_ms(torch, lambda: paged_attention(q, k, v, pp, bt, pos),
                      flush),
        "graph_ms": graph_ms(torch, lambda: paged_attention(
            q, k, v, pp, bt, pos), flush),
        "plain_ms": time_ms(torch, lambda: ref.paged_attention_ref(
            q, k, v, pp, bt, pos), flush, n=20),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, kd, vd, attn_mask=mask), flush),
        "library_graph_ms": graph_ms(
            torch, lambda: F.scaled_dot_product_attention(
                qs, kd, vd, attn_mask=mask), flush),
        "bytes": nbytes, "shape": {
            "B": B, "H": H, "KV": KV, "hd": hd, "ps": ps, "W": bt.shape[1],
            "claimed_pages": int(claimed.numel()), "valid_slots": n_valid,
            "max_pos": int(pos.max()),
            "route": ROUTES[route(H // KV, hd, q.dtype)],
            "group_tiles": tiles,
            "splits": split_plan(B, KV, bt.shape[1], sm_count(q.device),
                                 tiles)}}


def timing_phase(torch, step, errs, serving):
    from repro_torch.kernels import ref
    from repro_torch.kernels.bgmv import lora_expand, lora_shrink
    print("phase 5a: kernel timing at the decode shapes of phase 4a",
          flush=True)
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    launches = {r["kernel"]: r["launches"] for r in serving}
    rows = []

    # paged attention, layer 0 of the captured step
    rows.append(paged_row(torch, step["paged_attention"], flush,
                          name="paged_attention", path="bgmv",
                          launches=launches["bgmv"]["paged_attention"],
                          max_abs_err=errs["paged_attention"]))

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
        # the main path's expand reads the shrink's f32 y (ops.lora_delta)
        e_bytes = (y.numel() * 4 + live_cols * d_out * e + 8 * nrows
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
            "graph_ms": graph_ms(torch, lambda: lora_shrink(x, a, idx, live),
                                 flush),
            "library_graph_ms": graph_ms(torch, lambda: torch.bmm(
                x[:, None, :], a_g), flush),
            "bytes": s_bytes, **common})
        rows.append({
            "name": f"lora_expand[{mode}]", "replaces": src_line[1],
            "launches": launches[mode]["lora_expand"],
            "max_abs_err": errs["lora_expand"],
            "y": "the shrink's f32 y, rounded as it is loaded",
            "ms": time_ms(torch, lambda: lora_expand(y, b, idx, live), flush),
            "plain_ms": time_ms(torch, lambda: ref.lora_expand_ref(
                yd, b, idx, live), flush, n=20),
            "bound_ms": e_ms, "bound_by": e_by,
            "library_ms": time_ms(torch, lambda: torch.bmm(
                yd[:, None, :], b_g), flush),
            "graph_ms": graph_ms(torch, lambda: lora_expand(y, b, idx, live),
                                 flush),
            "library_graph_ms": graph_ms(torch, lambda: torch.bmm(
                yd[:, None, :], b_g), flush),
            "bytes": e_bytes, **common})
    step["rank_sweep"] = rank_sweep(torch, a, b, x, flush)
    for r in rows:
        graphed = (f"; in a CUDA graph {r['graph_ms'] * 1e3:.1f} us"
                   if "graph_ms" in r else "")
        if "library_graph_ms" in r:
            graphed += f", library {r['library_graph_ms'] * 1e3:.1f} us"
        print(f"  {r['name']}: {r['ms'] * 1e3:.1f} us (bound "
              f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}), plain "
              f"{r['plain_ms'] * 1e3:.1f} us, library "
              f"{r['library_ms'] * 1e3:.1f} us, {r['launches']} "
              f"launches{graphed}", flush=True)
    return rows


def flash_timing(torch, args, err, serving, name="flash_attention",
                 path="yi-9b prefill", window=None):
    """Phase 5b: the flash kernel at layer 0 of the largest captured
    (causal) prefill call of a path (yi-9b; phase G's phi-3-vision at hd 96
    and recurrentgemma at hd 256, `window` its local window), beside its
    bound, the plain version and SDPA over K/V repeated across each GQA
    group, with the window as a mask (timed only, never called by the
    port). Launch counts are the first run's; the other runs' are listed
    beside them. Each timing runs for about a second or a few launches,
    whichever is more. `err`: the kernel's worst phase-2 error at
    full-width shapes of this head dim."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash import flash_attention
    print(f"phase 5b: flash attention timing at the captured {path} shape",
          flush=True)
    q, k, v = args
    B, H, Lq, hd = q.shape
    KV, Lk = k.shape[1], k.shape[2]
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    # causal (query, key) pairs the kernel is given, inside the window,
    # pad positions of the packed batch included (the kernel cannot tell
    # them apart)
    pairs = sum(min(i + 1, Lk, window or Lk) for i in range(Lq))
    esz = q.element_size()
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * esz
    b_ms, b_by = bound(nbytes, 4 * B * H * hd * pairs, "bfloat16")

    def auto_n(fn, budget_ms=1000.0, n_max=50):
        fn()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        return max(3, min(n_max, int(budget_ms / max(s.elapsed_time(e),
                                                      1e-3))))

    def kern():
        return flash_attention(q, k, v, window=window)

    def plain():
        return ref.flash_attention_ref(q, k, v, window=window)

    kr = k.repeat_interleave(H // KV, dim=1)
    vr = v.repeat_interleave(H // KV, dim=1)
    mask = None
    if window is not None and window < Lq:
        d = torch.arange(Lq, device="cuda")[:, None] \
            - torch.arange(Lk, device="cuda")[None]
        mask = (d >= 0) & (d < window)

    def library():
        if mask is None:
            return F.scaled_dot_product_attention(q, kr, vr, is_causal=True)
        return F.scaled_dot_product_attention(q, kr, vr, attn_mask=mask)

    by_run = {f"{r['model']} {r['run']}": r["launches"]["flash_attention"]
              for r in serving}
    row = {"name": name, "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash.py:110",
           "path": path,
           "launches": serving[0]["launches"]["flash_attention"],
           "launches_a_call": serving[0]["launches"]["flash_attention"]
           / max(1, serving[0]["prefill_calls"]),
           "max_abs_err": err,
           "ms": time_ms(torch, kern, flush, n=auto_n(kern), warm=1),
           "plain_ms": time_ms(torch, plain, flush, n=auto_n(plain), warm=0),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": time_ms(torch, library, flush, n=auto_n(library),
                                 warm=1),
           "bytes": nbytes, "ops": 4 * B * H * hd * pairs,
           "launches_by_run": by_run,
           "shape": {"B": B, "H": H, "KV": KV, "Lq": Lq, "Lk": Lk, "hd": hd,
                     "window": window, "causal_pairs": pairs,
                     "dtype": str(q.dtype)}}
    # as a graphed prefill launches them: no wrapper host work between
    # launches (graph_ms)
    row["graph_ms"] = graph_ms(torch, kern, flush)
    row["library_graph_ms"] = graph_ms(torch, library, flush)
    row["tflop_s"] = row["ops"] / row["ms"] / 1e9
    print(f"  {name}: {row['ms']:.3f} ms, in a CUDA graph "
          f"{row['graph_ms']:.3f} ms (bound {b_ms:.3f} ms by "
          f"{b_by}, {row['tflop_s']:.1f} TFLOP/s), plain "
          f"{row['plain_ms']:.1f} ms, library (SDPA) "
          f"{row['library_ms']:.3f} ms, in a graph "
          f"{row['library_graph_ms']:.3f} ms, launches {by_run} "
          f"({row['launches_a_call']:g} a prefill call)", flush=True)
    return row


def shrink_prefill_timing(torch, captured, serving):
    """Phase 5b: the LoRA shrink at layer 0 (target q) of the yi-9b prefill
    call of phase 4b: 32,768 rows (8 x 4,096 tokens, each row's slot
    repeated over its 4,096 tokens), d_in 4,096, r_max 64, 8 adapters; the
    row-tile path. Held per row against the plain version, timed beside
    its bound (phase 5a's formula), the plain version and one
    torch.matmul(x, A_cat) over all slots' A side by side (d_in x 8 r_max):
    every slot's columns for every row, a superset of the function, timed
    only and never called by the port. Launches: the yi-9b monolithic
    arm's."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.bgmv import cluster_room, lora_shrink, \
        shrink_plan, sm_count
    print("phase 5b: LoRA shrink at the yi-9b prefill shape", flush=True)
    (x, a, b, idx), kw = captured
    live = kw.get("live")
    if live is None:
        live = ops.lora_live(idx, kw.get("ranks"), kw.get("mode", "bgmv"),
                             a.shape[-1], kw.get("rank_block", 16))
    rows, d_in = x.shape
    slots, _, r_max = a.shape
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    y = lora_shrink(x, a, idx, live)
    err = check_close("lora_shrink prefill (yi-9b layer 0 q)", y,
                      ref.lora_shrink_ref(x, a, idx, live), torch.float32)
    adapted = idx >= 0
    slot_live = dict(zip(idx[adapted].tolist(), live[adapted].tolist()))
    live_cols = sum(slot_live.values())
    row_live = int(live.sum())
    e = x.element_size()
    nbytes = (x.numel() * e + live_cols * d_in * e + 8 * rows
              + y.numel() * 4)
    b_ms, b_by = bound(nbytes, 2 * d_in * row_live, "bfloat16")
    a_cat = a.permute(1, 0, 2).reshape(d_in, slots * r_max).contiguous()
    plan = shrink_plan(rows, d_in, slots, sm_count(x.device), a.shape[-1],
                       x.dtype, cluster_room(x.device))
    row = {"name": "lora_shrink[bgmv, prefill]", "route": "cuda",
           "source": "src/repro_torch/csrc/lora.cu",
           "replaces": "src/repro/kernels/bgmv.py:86",
           "path": "yi-9b prefill",
           "launches": serving[0]["launches"]["lora_shrink"],
           "max_abs_err": err,
           "ms": time_ms(torch, lambda: lora_shrink(x, a, idx, live), flush),
           "graph_ms": graph_ms(torch, lambda: lora_shrink(x, a, idx, live),
                                flush),
           "host_ms": host_ms(torch, lambda: lora_shrink(x, a, idx, live)),
           "plain_ms": time_ms(torch, lambda: ref.lora_shrink_ref(
               x, a, idx, live), flush, n=10),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": time_ms(torch, lambda: torch.matmul(x, a_cat),
                                 flush),
           "library_call": f"torch.matmul(x, A_cat {tuple(a_cat.shape)}): "
                           "all slots' columns for every row (a superset)",
           "bytes": nbytes,
           "shape": {"rows": rows, "d_in": d_in, "r_max": r_max,
                     "slots": slots, "adapters": len(slot_live),
                     "live_columns": row_live, "tile_rows": plan.tile,
                     "split": plan.split, "grid": plan.grid}}
    print(f"  {row['name']}: {row['ms'] * 1e3:.1f} us (bound "
          f"{b_ms * 1e3:.1f} us by {b_by}, {row['ms'] / b_ms:.2f}x), plain "
          f"{row['plain_ms'] * 1e3:.1f} us, library (matmul over A_cat) "
          f"{row['library_ms'] * 1e3:.1f} us, {row['launches']} launches; "
          f"in a CUDA graph {row['graph_ms'] * 1e3:.1f} us, host "
          f"{row['host_ms'] * 1e3:.1f} us a call", flush=True)
    return row


P_CHUNK_ROWS = 512                    # the yi-9b chunk's rows (chunk_budget)


def chunk_shrink_timing(torch, captured, serving):
    """Phase 5b: the LoRA shrink at the yi-9b chunk's shape: 512 rows (one
    chunk of one long prompt, so one slot of the pool's 8), d_in 4,096,
    r_max 64, the first 512 rows of phase 4b's layer-0 q input and its
    pool; the row-tile path (64-row tiles split over clusters of 8). Held
    per row against the plain version and timed beside its bound (phase
    5a's formula), the plain version and one torch.matmul(x, A[s]) with
    the one slot's weight, timed only and never called by the port.
    Launches: every shrink launch of the yi-9b chunked arm; its launches
    a chunk are counted in P4 (`chunk_launches`)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bgmv import cluster_room, lora_shrink, \
        shrink_plan, sm_count
    print("phase 5b: LoRA shrink at the yi-9b chunk's shape", flush=True)
    (x, a, _, idx), _ = captured
    x = x[:P_CHUNK_ROWS].contiguous()
    slots, d_in, r_max = a.shape
    s = int(idx[idx >= 0][0])
    idx = torch.full((P_CHUNK_ROWS,), s, dtype=torch.int32, device="cuda")
    live = ref.bgmv_live(idx, r_max)
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    y = lora_shrink(x, a, idx, live)
    err = check_close("lora_shrink yi-9b chunk (layer 0 q)", y,
                      ref.lora_shrink_ref(x, a, idx, live), torch.float32)
    check(torch.equal(y, lora_shrink(x, a, idx, live)),
          "shrink chunk: two runs differ")
    e = x.element_size()
    nbytes = x.numel() * e + r_max * d_in * e + 8 * P_CHUNK_ROWS \
        + y.numel() * 4
    ops_n = 2 * d_in * int(live.sum())
    b_ms, b_by = bound(nbytes, ops_n, "bfloat16")
    plan = shrink_plan(P_CHUNK_ROWS, d_in, slots, sm_count(x.device),
                       a.shape[-1], x.dtype, cluster_room(x.device))
    row = {"name": "lora_shrink[yi-9b chunk]", "route": "cuda",
           "source": "src/repro_torch/csrc/lora.cu",
           "replaces": "src/repro/kernels/bgmv.py:86",
           "path": "yi-9b chunked prefill (chunk_budget 512)",
           "launches": serving[1]["launches"]["lora_shrink"],
           "launches_of": "every lora_shrink launch of the chunked arm: "
                          "its chunks, short prefills and decode steps",
           "max_abs_err": err,
           "ms": time_ms(torch, lambda: lora_shrink(x, a, idx, live), flush),
           "graph_ms": graph_ms(torch, lambda: lora_shrink(x, a, idx, live),
                                flush),
           "host_ms": host_ms(torch, lambda: lora_shrink(x, a, idx, live)),
           "plain_ms": time_ms(torch, lambda: ref.lora_shrink_ref(
               x, a, idx, live), flush, n=20),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": time_ms(torch, lambda: torch.matmul(x, a[s]),
                                 flush),
           "library_graph_ms": graph_ms(torch, lambda: torch.matmul(
               x, a[s]), flush),
           "library_call": "torch.matmul(x, A[s]) with the one slot's "
                           "weight",
           "bytes": nbytes,
           "shape": {"rows": P_CHUNK_ROWS, "d_in": d_in, "r_max": r_max,
                     "slots": slots, "adapters": 1,
                     "tile_rows": plan.tile, "split": plan.split,
                     "grid": plan.grid}}
    print(f"  {row['name']}: {row['ms'] * 1e3:.1f} us, in a CUDA graph "
          f"{row['graph_ms'] * 1e3:.1f} us (bound {b_ms * 1e3:.2f} us by "
          f"{b_by}), plain {row['plain_ms'] * 1e3:.1f} us, library "
          f"(matmul) {row['library_ms'] * 1e3:.1f} us, in a CUDA graph "
          f"{row['library_graph_ms'] * 1e3:.1f} us, host "
          f"{row['host_ms'] * 1e3:.1f} us a call, {row['launches']} "
          "launches in the chunked arm", flush=True)
    return row


P_CHUNK_KV_COLS = 512                 # yi-9b's k / v: 4 KV heads x 128


def chunk_expand_timing(torch, captured, serving):
    """Phase 5b: the LoRA expand at the yi-9b chunk's shapes: 512 rows of
    one slot of the pool's 8, r_max 64, y from the shrink of the first 512
    rows of phase 4b's layer-0 q input (f32, as `ops.lora_delta` passes
    it: the expand rounds it on load), at d_out 4,096 (q, the captured
    pool's B) and 512 (k / v: a seeded B of that width); the persistent
    wgmma kernel. Each held per row against the plain version on the cast
    y, timed beside its bound (y, the slot's B and out moved once), the
    plain version and one torch.matmul(y, B[s]) (timed only, never called
    by the port), each also in a CUDA graph. Launches: every expand launch
    of the yi-9b chunked arm; its launches a chunk are counted in P4
    (`chunk_launches`)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.bgmv import (expand_plan, lora_expand,
                                          lora_shrink, sm_count)
    print("phase 5b: LoRA expand at the yi-9b chunk's shapes", flush=True)
    (x, a, b, idx), _ = captured
    x = x[:P_CHUNK_ROWS].contiguous()
    slots, r_max, d_q = b.shape
    s = int(idx[idx >= 0][0])
    idx = torch.full((P_CHUNK_ROWS,), s, dtype=torch.int32, device="cuda")
    live = ref.bgmv_live(idx, r_max)
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    y = lora_shrink(x, a, idx, live)
    yd = y.to(b.dtype)
    g = torch.Generator(device="cuda").manual_seed(SEED + 29)
    b_kv = (torch.randn(slots, r_max, P_CHUNK_KV_COLS, generator=g,
                        device="cuda") * r_max ** -0.5).to(b.dtype)
    rows = []
    for label, bw in (("q", b), ("k / v", b_kv)):
        d_out = bw.shape[-1]
        out = lora_expand(y, bw, idx, live)
        err = check_close(f"lora_expand yi-9b chunk {label} (d_out {d_out})",
                          out, ref.lora_expand_ref(yd, bw, idx, live),
                          b.dtype)
        check(torch.equal(out, lora_expand(y, bw, idx, live)),
              f"expand chunk {label}: two runs differ")
        check(torch.equal(out, lora_expand(yd, bw, idx, live)),
              f"expand chunk {label}: f32 y rounded on load != the cast y")
        e = bw.element_size()
        nbytes = y.numel() * 4 + r_max * d_out * e + 8 * P_CHUNK_ROWS \
            + P_CHUNK_ROWS * d_out * e
        b_ms, b_by = bound(nbytes, 2 * d_out * int(live.sum()), "bfloat16")
        row = {"name": f"lora_expand[yi-9b chunk, d_out {d_out}]",
               "route": "cuda", "source": "src/repro_torch/csrc/lora.cu",
               "replaces": "src/repro/kernels/bgmv.py:136",
               "path": "yi-9b chunked prefill (chunk_budget 512), target "
                       + label,
               "launches": serving[1]["launches"]["lora_expand"],
               "launches_of": "every lora_expand launch of the chunked "
                              "arm: its chunks, short prefills and decode "
                              "steps",
               "max_abs_err": err,
               "ms": time_ms(torch, lambda: lora_expand(y, bw, idx, live),
                             flush),
               "graph_ms": graph_ms(torch, lambda: lora_expand(
                   y, bw, idx, live), flush),
               "plain_ms": time_ms(torch, lambda: ref.lora_expand_ref(
                   yd, bw, idx, live), flush, n=20),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": time_ms(torch, lambda: torch.matmul(
                   yd, bw[s]), flush),
               "library_graph_ms": graph_ms(torch, lambda: torch.matmul(
                   yd, bw[s]), flush),
               "library_call": "torch.matmul(y, B[s]) with the one slot's "
                               "weight",
               "bytes": nbytes,
               "shape": {"rows": P_CHUNK_ROWS, "r_max": r_max,
                         "d_out": d_out, "slots": slots, "adapters": 1,
                         "y": "f32, rounded on load",
                         "plan": expand_plan(P_CHUNK_ROWS, d_out,
                                             sm_count(x.device),
                                             bw.dtype)._asdict()}}
        print(f"  {row['name']}: {row['ms'] * 1e3:.1f} us, in a CUDA graph "
              f"{row['graph_ms'] * 1e3:.1f} us (bound {b_ms * 1e3:.2f} us "
              f"by {b_by}), plain {row['plain_ms'] * 1e3:.1f} us, library "
              f"(matmul) in a CUDA graph "
              f"{row['library_graph_ms'] * 1e3:.1f} us, "
              f"{row['launches']} launches in the chunked arm", flush=True)
        rows.append(row)
    return rows


def expand_prefill_timing(torch, captured, serving):
    """Phase 5b: the LoRA expand at layer 0 (target q) of the yi-9b
    prefill call of phase 4b: 32,768 rows (each row's slot repeated over
    its 4,096 tokens), r_max 64, d_out 4,096, 8 adapters, y from the
    shrink cast to bf16 (and, `f32_y_graph_ms`, the shrink's f32 y, as
    the model passes it: rounded on load); the row-tile path (the
    persistent wgmma kernel). Held per row against the plain version,
    timed beside its bound (phase 5a's formula), the plain version and one
    torch.matmul(Y_bd, B_cat), also in a CUDA graph: Y_bd (rows, 8 r_max)
    holds each row's y in its slot's r_max columns and zeros elsewhere,
    B_cat (8 r_max, d_out) stacks the slots' B — the same function at 8x
    the flops, timed only and never called by the port. Launches: the
    yi-9b monolithic arm's."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.bgmv import (expand_plan, lora_expand,
                                          lora_shrink, sm_count)
    print("phase 5b: LoRA expand at the yi-9b prefill shape", flush=True)
    (x, a, b, idx), kw = captured
    live = kw.get("live")
    if live is None:
        live = ops.lora_live(idx, kw.get("ranks"), kw.get("mode", "bgmv"),
                             a.shape[-1], kw.get("rank_block", 16))
    rows = x.shape[0]
    slots, r_max, d_out = b.shape
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    y32 = lora_shrink(x, a, idx, live)
    yd = y32.to(x.dtype)
    out = lora_expand(yd, b, idx, live)
    err = check_close("lora_expand prefill (yi-9b layer 0 q)", out,
                      ref.lora_expand_ref(yd, b, idx, live), x.dtype)
    check(torch.equal(out, lora_expand(yd, b, idx, live)),
          "expand prefill: two runs differ")
    check(torch.equal(out, lora_expand(y32, b, idx, live)),
          "expand prefill: f32 y rounded on load != the cast y")
    del out
    adapted = idx >= 0
    slot_live = dict(zip(idx[adapted].tolist(), live[adapted].tolist()))
    live_cols = sum(slot_live.values())
    row_live = int(live.sum())
    e = yd.element_size()
    nbytes = (yd.numel() * e + live_cols * d_out * e + 8 * rows
              + rows * d_out * e)
    b_ms, b_by = bound(nbytes, 2 * d_out * row_live, "bfloat16")
    y_bd = torch.zeros(rows, slots, r_max, dtype=yd.dtype, device="cuda")
    keep = torch.arange(r_max, device="cuda")[None] < live[:, None]
    y_bd[adapted, idx[adapted].long()] = torch.where(keep, yd, 0)[adapted]
    y_bd = y_bd.reshape(rows, slots * r_max)
    b_cat = b.reshape(slots * r_max, d_out)
    row = {"name": "lora_expand[bgmv, prefill]", "route": "cuda",
           "source": "src/repro_torch/csrc/lora.cu",
           "replaces": "src/repro/kernels/bgmv.py:136",
           "path": "yi-9b prefill",
           "launches": serving[0]["launches"]["lora_expand"],
           "max_abs_err": err,
           "ms": time_ms(torch, lambda: lora_expand(yd, b, idx, live), flush),
           "graph_ms": graph_ms(torch, lambda: lora_expand(yd, b, idx, live),
                                flush),
           "host_ms": host_ms(torch, lambda: lora_expand(yd, b, idx, live)),
           "plain_ms": time_ms(torch, lambda: ref.lora_expand_ref(
               yd, b, idx, live), flush, n=10),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": time_ms(torch, lambda: torch.matmul(y_bd, b_cat),
                                 flush),
           "library_graph_ms": graph_ms(torch, lambda: torch.matmul(
               y_bd, b_cat), flush),
           "f32_y_graph_ms": graph_ms(torch, lambda: lora_expand(
               y32, b, idx, live), flush),
           "library_call": f"torch.matmul(Y_bd {tuple(y_bd.shape)}, B_cat "
                           f"{tuple(b_cat.shape)}): the same function at "
                           f"{slots}x the flops",
           "bytes": nbytes,
           "shape": {"rows": rows, "r_max": r_max, "d_out": d_out,
                     "slots": slots, "adapters": len(slot_live),
                     "live_columns": row_live,
                     "plan": expand_plan(rows, d_out, sm_count(x.device),
                                         b.dtype)._asdict()}}
    print(f"  {row['name']}: {row['ms'] * 1e3:.1f} us (bound "
          f"{b_ms * 1e3:.1f} us by {b_by}, {row['ms'] / b_ms:.2f}x), plain "
          f"{row['plain_ms'] * 1e3:.1f} us, library (matmul Y_bd x B_cat) "
          f"{row['library_ms'] * 1e3:.1f} us, {row['launches']} launches; "
          f"in a CUDA graph {row['graph_ms'] * 1e3:.1f} us (on the "
          f"shrink's f32 y {row['f32_y_graph_ms'] * 1e3:.1f} us), library "
          f"{row['library_graph_ms'] * 1e3:.1f} us, host "
          f"{row['host_ms'] * 1e3:.1f} us a call", flush=True)
    return row


def paged_capture_timing(torch, args, serving, name, path, min_pos=0):
    """A phase-5a paged-attention row at a served decode shape: layer 0 of
    the first decode step of the first run (`capture_first_decode`; yi-9b:
    8 rows, 32 query heads over 4 KV heads, one row at pos >= YI_LONG_POS;
    mistral-large: 96 over 8, GQA group 12), held per row against the
    plain version and timed as the llama2-7b row is. Launches: that run's."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged import paged_attention
    print(f"phase 5a: paged attention at the {path} shape", flush=True)
    q, k, v, pp, bt, pos = args
    check(int(pos.max()) >= min_pos,
          f"{path} capture: no row at pos >= {min_pos}")
    err, share = check_close(f"paged_attention {path} (layer 0)",
                             paged_attention(*args),
                             ref.paged_attention_ref(*args), q.dtype,
                             share=True)
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    row = paged_row(torch, args, flush_buf.zero_, name=name, path=path,
                    launches=serving[0]["launches"]["paged_attention"],
                    max_abs_err=err)
    row["limit_share"] = share
    print(f"  {row['name']} ({row['shape']['route']} kernel): "
          f"{row['ms'] * 1e3:.1f} us (bound "
          f"{row['bound_ms'] * 1e3:.2f} us by {row['bound_by']}), in a CUDA "
          f"graph {row['graph_ms'] * 1e3:.1f} us, plain "
          f"{row['plain_ms'] * 1e3:.1f} us, library (SDPA) "
          f"{row['library_ms'] * 1e3:.1f} us, in a CUDA graph "
          f"{row['library_graph_ms'] * 1e3:.1f} us, {row['launches']} "
          f"launches, worst {share:.3f} of a row's limit, shape "
          f"{row['shape']}", flush=True)
    return row


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


# ------------------------------------------------------------ phase K ----

# llama2-7b changed to shapes the reference's kernels take and no
# registered config reaches: (tag, label, ModelConfig changes). K1 MQA
# (group 32 at hd 128: paged attention on the group kernel), K2 hd 80 (32
# heads of 80: flash at width 96), K3 falcon-7b's attention (71 query
# heads of 64 over one KV head, one block a KV head) over a d_model of 4,100
# (no multiple of 8: the LoRA shrink's tail on q, k and v), its depth cut
# to K3_LAYERS; K1 and K2 whole.
K3_LAYERS = 4
K_CONFIGS = [("K1", "n_kv_heads=1", {"n_kv_heads": 1}),
             ("K2", "head_dim=80", {"head_dim": 80}),
             ("K3", f"71 heads of 64 over 1, d_model 4100, {K3_LAYERS} "
              "layers", {"n_heads": 71, "n_kv_heads": 1, "head_dim": 64,
                         "d_model": 4100, "n_layers": K3_LAYERS})]
K_REQUESTS = {"n": 8, "seed": SEED + 10, "max_new": 32}


def tail_shrink_row(torch, step, serving, flush):
    """A kernels-line row for the LoRA shrink at a width that is no
    multiple of 8: layer 0's first LoRA call (target q) of phase K3's
    decode step, 8 rows of d_in 4,100 (the 4-byte-copy instantiation of
    the decode path), held per row against the plain version and
    timed as phase 5a's shrink is (events, in a graph, `torch.bmm`)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.bgmv import lora_shrink
    (x, a, b, idx, *_), kw = step["lora_delta"]
    live = kw.get("live")
    if live is None:
        live = ops.lora_live(idx, kw.get("ranks"), kw.get("mode", "bgmv"),
                             a.shape[-1], kw.get("rank_block", 16))
    rows, d_in = x.shape
    check(d_in % 8 != 0, f"phase K3: the captured shrink's d_in {d_in} is "
          "a multiple of 8")
    y = lora_shrink(x, a, idx, live)
    err = check_close(f"lora_shrink tail (K3 layer 0, d_in {d_in})", y,
                      ref.lora_shrink_ref(x, a, idx, live), torch.float32)
    adapted = idx >= 0
    slot_live = dict(zip(idx[adapted].tolist(), live[adapted].tolist()))
    e = x.element_size()
    nbytes = (x.numel() * e + sum(slot_live.values()) * d_in * e + 8 * rows
              + y.numel() * 4)
    b_ms, b_by = bound(nbytes, 2 * d_in * int(live.sum()), "bfloat16")
    a_g = a[idx.clamp(min=0).long()]
    row = {"name": f"lora_shrink[tail, d_in {d_in}]", "route": "cuda",
           "source": "src/repro_torch/csrc/lora.cu",
           "replaces": "src/repro/kernels/bgmv.py:86",
           "path": "phase K3 decode",
           "launches": serving[0]["launches"]["lora_shrink"],
           "max_abs_err": err,
           "ms": time_ms(torch, lambda: lora_shrink(x, a, idx, live), flush),
           "plain_ms": time_ms(torch, lambda: ref.lora_shrink_ref(
               x, a, idx, live), flush, n=20),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": time_ms(torch, lambda: torch.bmm(
               x[:, None, :], a_g), flush),
           "graph_ms": graph_ms(torch, lambda: lora_shrink(x, a, idx, live),
                                flush),
           "library_graph_ms": graph_ms(torch, lambda: torch.bmm(
               x[:, None, :], a_g), flush),
           "bytes": nbytes,
           "shape": {"rows": rows, "d_in": d_in, "r_max": a.shape[-1],
                     "live_columns": int(live.sum())}}
    print(f"  {row['name']}: {row['ms'] * 1e3:.1f} us (bound "
          f"{b_ms * 1e3:.2f} us by {b_by}), plain "
          f"{row['plain_ms'] * 1e3:.1f} us, library (bmm) "
          f"{row['library_ms'] * 1e3:.1f} us, in a CUDA graph "
          f"{row['graph_ms'] * 1e3:.1f} us (bmm "
          f"{row['library_graph_ms'] * 1e3:.1f}), {row['launches']} "
          "launches", flush=True)
    return row


def shapes_phase(torch, errs):
    """Phase K: each of K_CONFIGS served on the card through
    `InferenceServer` (seeded bf16 weights, mode "caraserve", bgmv, the 8
    adapters of ranks 8-64, 8 requests of 32-256 prompt tokens and 32 new
    tokens), graphed and with graphs=False: every request finishes, the
    paged, flash and LoRA kernels launch, tokens and launch counts equal
    in both arms; then one decode step's logits (8 rows) and a 2-row
    prefill's and its decode step's (`g_logits`) through the kernels vs
    the plain versions within LOGIT_TOL x max |logit|; then the new
    shapes timed as phase 5a / 5b time theirs: paged attention at K1's
    and K3's decode (the group kernel), flash at K2's largest prefill (hd 80
    at width 96), the LoRA shrink at K3's decode (d_in 4,100). Returns
    (report, kernels-line rows)."""
    from repro_torch.configs.base import get_config
    base = get_config("llama2-7b")
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    report, rows = {}, []
    for tag, label, kw in K_CONFIGS:
        cfg = dataclasses.replace(base, **kw)
        print(f"phase {tag}: llama2-7b with {label} (H {cfg.n_heads} over "
              f"KV {cfg.n_kv_heads}, hd {cfg.hd}, d_model {cfg.d_model}, "
              f"{cfg.n_layers} layers)", flush=True)
        capture = {}
        runs = [(f"{tag} graphed", "bgmv", {}, K_REQUESTS),
                (f"{tag} eager", "bgmv", {"graphs": False}, K_REQUESTS)]
        with capture_largest_attention(capture):
            serving, params = serve_phase(torch, cfg, runs, tag)
        graphed, eager = serving
        check(graphed["generated"] == eager["generated"],
              f"phase {tag}: graphed and eager tokens differ")
        check(graphed["launches"] == eager["launches"],
              f"phase {tag}: launches differ graphed / eager: "
              f"{graphed['launches']} / {eager['launches']}")
        print(f"  {tag}: graphed = eager tokens over {graphed['requests']} "
              f"requests; launches {graphed['launches']}", flush=True)
        step = logits_phase(torch, cfg, params, phase=tag, profile=False)
        both = g_logits(torch, cfg, params, label=f" ({label})", phase=tag)
        report[tag] = {"label": label, "serving": serving,
                       "decode_logits": step["logits"],
                       "g_logits": {k: both[k] for k in
                                    ("prefill", "decode", "launches")}}
        if tag == "K1":
            rows.append(paged_capture_timing(
                torch, step["paged_attention"], serving,
                "paged_attention[MQA G 32, hd 128]", "K1 decode"))
        elif tag == "K2":
            rows.append(flash_timing(
                torch, capture["args"], errs["flash_attention[hd 80]"],
                serving, name="flash_attention[hd 80]",
                path="K2 largest prefill"))
        else:
            rows.append(paged_capture_timing(
                torch, step["paged_attention"], serving,
                "paged_attention[G 71, hd 64]", "K3 decode"))
            rows.append(tail_shrink_row(torch, step, serving, flush))
        del step, both, capture, params, serving
        gc.collect()
        torch.cuda.empty_cache()
    return report, rows


# ------------------------------------------------------------ phase S ----

def kernel_tooling_phase(torch):
    """Phase S1-S3 (repro_torch.analysis.kernel_verify): the footprint of
    every launch at every registered config against the card's limits,
    the paged shape rule's Python copy against the library's, the
    canaries on every launch path of the six kernels, and the mutants,
    each of which the checks must catch. Any finding fails the run."""
    from repro_torch.analysis import kernel_verify
    from repro_torch.kernels import build
    lib = build.library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t0 = time.perf_counter()
    print("phase S1: launch footprints at every registered config and "
          "phase K's shapes", flush=True)
    rows, lim, found = kernel_verify.footprint(lib, build.build_log, sms)
    print(f"  card limits: {lim}", flush=True)
    groups = {}
    for fp in rows:
        key = (fp.launch.kernel, fp.part, fp.launch.path,
               str(fp.launch.dtype).replace("torch.", ""), fp.threads,
               fp.dyn_smem, fp.registers, fp.static_smem, fp.local_bytes,
               fp.blocks_per_sm, fp.cluster, fp.max_clusters)
        groups.setdefault(key, []).append(fp.launch.case)
    table = []
    for key, cases in sorted(groups.items()):
        kernel, part, path, dt, thr, dyn, regs, st, loc, blk, cl, mcl = key
        occ = blk * thr / lim["threads_sm"]
        table.append({"kernel": kernel, "part": part, "path": path,
                      "dtype": dt, "threads": thr, "dyn_smem": dyn,
                      "registers": regs, "static_smem": st,
                      "local_bytes": loc, "blocks_per_sm": blk,
                      "cluster": cl, "max_clusters": mcl,
                      "occupancy": occ, "configs": sorted(set(cases))})
        clusters = f", clusters of {cl} ({mcl} at once)" if cl > 1 else ""
        print(f"  {kernel}[{path}]{'' if part == kernel else ' ' + part} "
              f"{dt}: {thr} threads, dyn smem {dyn} B, {regs} registers, "
              f"static smem {st} B, local {loc} B, {blk} blocks/SM "
              f"(occupancy {occ:.2f}){clusters} — {len(set(cases))} "
              "configs", flush=True)
    found += kernel_verify.paged_rule_findings(lib)
    found += kernel_verify.flash_order_findings(lib)
    check(not found, "phase S1 findings:\n  " + "\n  ".join(found))
    print(f"  {len(rows)} launches of {len(groups)} distinct footprints "
          "within the limits (bf16 flash on its persistent grid); "
          "paged.fits, paged.group_tiles and paged.route equal "
          "rt_paged_attention_fits, rt_paged_attention_tiles and "
          "rt_paged_attention_route; flash.tile_order equals "
          f"rt_flash_attention_order at "
          f"{len(kernel_verify.FLASH_ORDER_CASES)} shapes", flush=True)
    print("phase S2: canaries (fills, guard bands, poisoned inputs, a "
          "concurrent stream)", flush=True)
    paths, found = kernel_verify.canaries(lib, sms)
    check(not found, "phase S2 findings:\n  " + "\n  ".join(found))
    print(f"  {len(paths)} launch paths clean: {paths}", flush=True)
    print("phase S3: mutants at the ctypes boundary", flush=True)
    caught = []
    for name, f in kernel_verify.mutants(lib, sms):
        check(bool(f), f"phase S3: mutant '{name}' was not caught")
        print(f"  caught {name}: {f[0]}", flush=True)
        caught.append(name)
    secs = time.perf_counter() - t0
    print(f"  phase S1-S3 took {secs:.1f} s", flush=True)
    return {"footprints": table, "limits": lim, "canary_paths": paths,
            "mutants_caught": caught, "seconds": secs}


S_RANKS = (8, 16)              # phase S's adapters: 1 page each
S_REQUESTS = {"n": 6, "seed": SEED + 7, "max_new": 48}
# 4 rows of 40-72 prompt tokens (2-3 pages) fill 14 pages with the two
# adapters' 2; growing past 96 tokens preempts
S_SERVER = {"max_batch": 4, "cache_slots": 512, "total_pages": 14,
            "chunk_budget": 0}
S_LENGTHS = (40, 73)
# phase S6: (max_rank, the adapters' ranks). The pools pad to 16 and 24
# columns; MBGMV's live widths are 16 / 16 and 24 (32 clamped) / 16, so at
# 20 it reads fewer columns than BGMV
S_MAX_RANKS = ((12, (12, 5)), (20, (20, 5)))
S_LOGIT_PROMPT = 40            # phase S6: tokens a row of the logit check


def s_requests(cfg, uids, n, seed, max_new):
    """n requests over the adapters, prompts of S_LENGTHS tokens, one
    every 4 ms; the second adapter's first request arrives after the
    first has decoded (its upload runs mid-run)."""
    import numpy as np
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=i, adapter_uid=uids[0 if i < 2 else i % len(uids)],
                    prompt=rng.integers(0, cfg.vocab, int(rng.integers(
                        *S_LENGTHS))).astype(np.int32),
                    max_new_tokens=max_new, arrival_ms=4.0 * i)
            for i in range(n)]


def s_server(torch, cfg, params, kernel, preempt, ranks=S_RANKS):
    from repro_torch.core.engine import InferenceServer
    from repro_torch.core.lora import AdapterSpec
    srv = InferenceServer(cfg, mode="caraserve", kernel=kernel,
                          page_size=32, params=params, seed=SEED,
                          device="cuda", preempt=preempt, **S_SERVER)
    uids = []
    for i, r in enumerate(ranks):
        spec = AdapterSpec(f"s-r{r}-{i}", r, cfg.name)
        srv.register_adapter(spec)
        uids.append(spec.uid)
    return srv, uids


def _sync_sites(torch, be, records, kinds=("decode", "megastep")):
    """Wrap the backend's calls `kinds` (`be.decode` / `be.megastep`, or
    `prefill_admitted` / `prefill_chunk`) so that each call runs under
    torch.cuda.set_sync_debug_mode("warn") and appends (kind, steady,
    [(file, line), ...], captured) to `records`: steady when the call
    uploaded nothing (the batch did not change), captured when it captured
    a CUDA graph (a key's second call)."""
    import warnings

    def wrap(fn, kind):
        def run(*a, **kw):
            h2d = be.transfer_stats["h2d"]
            caps = sum(e.captures for e in be.graphs.entries.values())
            with warnings.catch_warnings(record=True) as ws:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    res = fn(*a, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            sites = [(os.path.realpath(w.filename), w.lineno) for w in ws
                     if "synchroniz" in str(w.message)]
            records.append((kind, be.transfer_stats["h2d"] == h2d, sites,
                            sum(e.captures for e in be.graphs.entries.values())
                            > caps))
            return res
        return run

    for kind in kinds:
        setattr(be, kind, wrap(getattr(be, kind), kind))


def sanitized_serving_phase(torch, cfg, params):
    """Phase S4-S6 on the phase-3a weights: the port's lint clean (strict
    waivers); full-width serving under a page pool small enough to preempt
    (swap, then recompute) with an adapter upload mid-run, once as
    served and once with the sanitizers forced on (PageSan, LinkSan):
    tokens equal, sanitizers clean and live, wall times side by side;
    every device->host sync PyTorch reports in the decode steps and
    megasteps on a line the lint waives; servers of max_rank 12 and 20
    (pools padded to 16 and 24 columns) under bgmv and mbgmv, each one's
    prefill and decode logits held against the plain LoRA path on its own
    pool (`s6_logits`)."""
    import dataclasses
    import inspect
    import linecache
    from repro_torch.analysis import lint, sanitizers
    from repro_torch.kernels import bgmv
    t0 = time.perf_counter()
    print("phase S4: lint of src/repro_torch (--strict-waivers)", flush=True)
    report = lint.run_lint_report()
    check(not report.findings and not report.unused_waivers,
          "phase S4: lint findings: " + "; ".join(
              f.render() for f in report.findings + report.unused_waivers))
    waived = {(os.path.realpath(f.path), f.line): f for f in report.waived}
    for f in report.waived:
        print(f"  waived {os.path.relpath(f.path, ROOT)}:{f.line} "
              f"[{f.rule}]", flush=True)
    out = {"lint_waived": [f"{os.path.relpath(f.path, ROOT)}:{f.line}"
                           for f in report.waived], "arms": []}
    print(f"phase S5: {cfg.name} serving under a {S_SERVER['total_pages']}"
          "-page pool, as served and with the sanitizers forced on",
          flush=True)
    sync_records = []
    for preempt in ("swap", "recompute"):
        toks = {}
        # the arm that runs first pays the warm-up: alternate the order
        for sanitize in ((False, True) if preempt == "swap"
                         else (True, False)):
            with sanitizers.force(sanitize):
                srv, uids = s_server(torch, cfg, params, "bgmv", preempt)
                if not sanitize and preempt == "swap":
                    _sync_sites(torch, srv.backend, sync_records)
                reqs = s_requests(cfg, uids, **S_REQUESTS)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                srv.run(reqs)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t1
            san_p, san_l = srv.allocator.san, srv.cold.tracker.san
            check((san_p is not None) == sanitize
                  and (san_l is not None) == sanitize,
                  f"S5 {preempt}: sanitizers live = {sanitize} expected")
            ps = dict(srv.preempt_stats)
            check(ps[f"{preempt}_preemptions"] > 0,
                  f"S5 {preempt}: no {preempt} preemption ({ps})")
            demand = srv.cold.tracker.stats["demand"]
            check(demand >= len(S_RANKS), f"S5 {preempt}: {demand} uploads")
            for st in srv.states:
                check(len(st.generated) == st.req.max_new_tokens,
                      f"S5 {preempt}: request {st.req.rid} unfinished")
            toks[sanitize] = {st.req.rid: list(map(int, st.generated))
                              for st in srv.states}
            rec = {"preempt": preempt, "sanitized": sanitize, "wall_s": wall,
                   "preempt_stats": ps, "uploads": demand,
                   "free_pages_after": srv.allocator.free_pages}
            if sanitize:
                rec.update(pagesan_claims=san_p.claims,
                           pagesan_frees=san_p.frees,
                           pagesan_access_checks=san_p.access_checks,
                           linksan_checks=san_l.checks)
                check(san_p.access_checks > 0 and san_l.checks > 0,
                      f"S5 {preempt}: a sanitizer checked nothing")
            out["arms"].append(rec)
            print(f"  {preempt} {'sanitized' if sanitize else 'as served'}"
                  f": {wall:.2f} s wall, {ps[f'{preempt}_preemptions']} "
                  f"{preempt} preemptions, {demand} uploads"
                  + (f", PageSan {san_p.access_checks} access checks / "
                     f"{san_p.claims} claims, LinkSan {san_l.checks} checks"
                     if sanitize else ""), flush=True)
            rec["graphs"] = graph_check(srv.backend, f"S5 {preempt}")
            del srv
            gc.collect()
        check(toks[True] == toks[False],
              f"S5 {preempt}: sanitized tokens differ from the served ones")
    walls = {(r["preempt"], r["sanitized"]): r["wall_s"] for r in out["arms"]}
    print(f"  {smi_reading()}: wall s as served / sanitized: swap "
          f"{walls[('swap', False)]:.2f} / {walls[('swap', True)]:.2f}, "
          f"recompute {walls[('recompute', False)]:.2f} / "
          f"{walls[('recompute', True)]:.2f}", flush=True)
    # the instrumentation's own switch (torch.cuda.set_sync_debug_mode)
    # can report itself; it is no line of the port
    switch = debug_switch_lines(torch)
    steady = {k: next((s for kind, st, s, cap in sync_records
                       if kind == k and st and not cap), None)
              for k in ("decode", "megastep")}
    for kind, sites in steady.items():
        check(sites is not None, f"S5: no steady-state {kind} call")
        print(f"  steady-state {kind}: syncs PyTorch reports at "
              f"{[f'{os.path.relpath(p, ROOT)}:{n}' for p, n in sites]}",
              flush=True)
    # the graphed step: no call that replays (or runs its warm-up) may
    # sync, uploads included (they go through pinned staging)
    uploading = [r for r in sync_records if not r[1]]
    blocked = [r for r in uploading if set(r[2]) - switch]
    synced = [r for r in sync_records if set(r[2]) - switch and not r[3]]
    out["upload_calls"] = len(uploading)
    out["upload_calls_that_synced"] = len(blocked)
    out["calls_that_synced_outside_a_capture"] = len(synced)
    print(f"  {len(blocked)} of {len(uploading)} decode / megastep calls "
          f"that uploaded reported a sync (run 59, before pinned staging: "
          f"57 of 65); {len(synced)} of "
          f"{sum(not r[3] for r in sync_records)} calls outside a capture "
          "synced", flush=True)
    check(not synced, "S5: a decode / megastep call outside a capture "
          f"synced: {[sorted(set(r[2]) - switch) for r in synced][:4]}")
    every, bad = {}, set()
    for kind, st, sites, _ in sync_records:
        for site in sites:
            p_, n = site
            key = (f"{os.path.relpath(p_, ROOT)}:{n} "
                   f"`{linecache.getline(p_, n).strip()}`")
            every[key] = every.get(key, 0) + 1
            if site not in waived and site not in switch:
                bad.add(key)
    print(f"  syncs over all {len(sync_records)} decode / megastep calls "
          f"(by line, calls): {every}", flush=True)
    check(not bad, f"S5: syncs at lines the lint does not waive: "
          f"{sorted(bad)}")
    print("  every one on a waived line (or the debug mode's own switch)",
          flush=True)
    out["syncs_all_calls"] = every
    out["syncs_steady"] = {k: [f"{os.path.relpath(p_, ROOT)}:{n}"
                               for p_, n in v] for k, v in steady.items()}

    counters = _counters()
    out["max_rank"] = []
    for max_rank, ranks in S_MAX_RANKS:
        r_pad = bgmv.padded_rank(max_rank)
        print(f"phase S6: max_rank {max_rank} (pool {r_pad} columns), "
              f"adapters of ranks {ranks}, bgmv and mbgmv", flush=True)
        c_r = dataclasses.replace(cfg, lora=dataclasses.replace(
            cfg.lora, max_rank=max_rank))
        for kernel in ("bgmv", "mbgmv"):
            srv, uids = s_server(torch, c_r, params, kernel, "recompute",
                                 ranks=ranks)
            check(srv.backend.pool.pool["q"]["a"].shape[-1] == r_pad,
                  f"S6 {max_rank} {kernel}: pool not padded to {r_pad}")
            for fn in counters.values():
                fn.launches = 0
            srv.run(s_requests(c_r, uids, **S_REQUESTS))
            torch.cuda.synchronize()
            for n in ("lora_shrink", "lora_expand"):
                check(counters[n].launches > 0,
                      f"S6 {max_rank} {kernel}: {n} not launched")
            check(all(len(st.generated) == S_REQUESTS["max_new"]
                      for st in srv.states),
                  f"S6 {max_rank} {kernel}: unfinished")
            rec = {"max_rank": max_rank, "kernel": kernel,
                   **s6_logits(torch, c_r, params, srv.backend, uids,
                               kernel)}
            out["max_rank"].append(rec)
            print(f"  {kernel}: {len(srv.states)} requests served; live "
                  f"widths {rec['live']}; logits vs the plain LoRA path: "
                  f"prefill rel err {rec['prefill_rel_err']:.3e}, decode "
                  f"{rec['decode_rel_err']:.3e} (limit {LOGIT_TOL}; the "
                  f"LoRA itself moves them {rec['lora_moves']:.3e}), "
                  f"greedy agree {rec['greedy_agree']}", flush=True)
            del srv
            gc.collect()
    out["seconds"] = time.perf_counter() - t0
    print(f"  phase S4-S6 took {out['seconds']:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return out


def s6_logits(torch, cfg, params, be, uids, kernel):
    """Prefill and decode logits on the served pool `be.pool` (two rows an
    adapter, S_LOGIT_PROMPT tokens, one decode step on each pass's own
    cache with the kernel pass's greedy token), through the LoRA kernels
    and through the plain LoRA path (`plain_ops`); each within LOGIT_TOL
    of max |logit|. The prefill without LoRA must move further than that,
    or the comparison could not see the LoRA path."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.models import model as model_lib
    slots = [be.pool.lookup(u) for u in uids]
    check(None not in slots, f"S6 {kernel}: an adapter left the pool")
    pool, dev = be.pool.pool, be.device
    idx = torch.as_tensor(slots * 2, dtype=torch.int32, device=dev)
    lora = {"pool": pool, "idx": idx, "mode": kernel}
    rng = np.random.default_rng(SEED + 17)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (len(idx),
                                                       S_LOGIT_PROMPT)),
                           dtype=torch.int32, device=dev)
    pos = torch.full((len(idx),), S_LOGIT_PROMPT, dtype=torch.int32,
                     device=dev)

    def prefill(with_lora=True):
        with torch.no_grad():
            lg, cache = model_lib.prefill(cfg, params, {"tokens": toks},
                                          lora=lora if with_lora else None,
                                          cache_slots=2 * S_LOGIT_PROMPT)
        return lg[:, -1].float(), cache

    def decode(cache, tok):
        with torch.no_grad():
            lg, _ = model_lib.decode(cfg, params, cache, tok, pos, lora=lora)
        return lg[:, -1].float()

    pk, ck = prefill()
    with plain_ops():
        pp, cp = prefill()
    tok = pk.argmax(-1).to(torch.int32)[:, None]
    dk = decode(ck, tok)
    with plain_ops():
        dp = decode(cp, tok)
    rec = {"live": ops.lora_live(idx, pool["ranks"], kernel,
                                 pool["q"]["a"].shape[-1],
                                 cfg.lora.rank_block).tolist()}
    for name, k, p_ in (("prefill", pk, pp), ("decode", dk, dp)):
        check(bool(torch.isfinite(k).all()),
              f"S6 {kernel}: non-finite {name} logits")
        err, scale = float((k - p_).abs().max()), float(p_.abs().max())
        check(err <= LOGIT_TOL * scale,
              f"S6 {kernel}: {name} logits max abs err {err:.3e} > "
              f"{LOGIT_TOL} * {scale:.3e}")
        rec[f"{name}_rel_err"] = err / scale
    rec["greedy_agree"] = int((dk.argmax(-1) == dp.argmax(-1)).sum())
    rec["lora_moves"] = float((pk - prefill(False)[0]).abs().max()) / float(
        pp.abs().max())
    check(rec["lora_moves"] > LOGIT_TOL,
          f"S6 {kernel}: the LoRA moves the prefill logits by "
          f"{rec['lora_moves']:.3e} of max |logit|, within the limit")
    return rec


# ------------------------------------------------------------ phase M ----

M_TOKENS = 4096                # phase M2: tokens through one MoE layer
M2_CONFIGS = ("dbrx-132b", "grok-1-314b")
M2_CAPACITY = 2.0              # twice an expert's mean load (no drop: checked)
M2_GRAD_TOL = 1e-4             # a weight gradient vs moe_apply's, of its max
M3_LAYERS = 6                  # dbrx-132b's depth cut, as in phase F
M3_ROWS, M3_LEN = 8, 512       # the packed prefill
M3_TRAIN = (2, 512)            # the LoRA loss + backward
M3_RANK = 16
M4_COMBOS = [("whisper-tiny", "decode_32k", ()),
             ("dbrx-132b", "decode_32k", ("moe_ep",)),
             ("grok-1-314b", "decode_32k", ("moe_ep",))]
M4_TIMEOUT = 300
M_TIMEOUT = 500
M_DEVICE, M_BACKEND = "cuda", "nccl"


def multi_device_phase(torch):
    """Phase M in a process of its own (`--phase-m`), so its process group
    starts and ends there: M1 an NCCL group of one rank on cuda:0 and a
    1 x 1 ("data", "model") DeviceMesh; M2 `moe_apply_ep` against
    `moe_apply` for one full-width layer of dbrx-132b and grok-1-314b in
    f32; M3 dbrx-132b at full width cut to 6 layers, `moe_ep` under the
    mesh against the same weights without it (prefill, decode, a LoRA
    loss and its adapter gradients), flash and the LoRA kernels launched;
    M4 the port's dry run of three combos in a process of its own. Its
    failure fails the run. Returns its report."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = run_group([sys.executable, str(Path(__file__).resolve()),
                     "--phase-m"], M_TIMEOUT)
    sys.stdout.write(out.stdout)
    check(out.returncode == 0, "phase M failed (exit "
          f"{out.returncode}): {out.stderr[-4000:]}")
    line = [x for x in out.stdout.splitlines() if x.startswith("PHASE_M=")]
    check(len(line) == 1, "phase M printed no report")
    report = json.loads(line[0][len("PHASE_M="):])
    report["seconds"] = time.perf_counter() - t0
    print(f"phase M: {report['seconds']:.1f} s on {smi_reading()}",
          flush=True)
    return report


def run_group(cmd, timeout, env=None):
    """`cmd` in a process group of its own, its output captured; past
    `timeout` s the whole group is killed (what it started included) and
    the run fails."""
    import signal
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        check(False, f"{cmd[1:3]} did not end within {timeout} s")
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def phase_m_child() -> int:
    """The process of phase M (see `multi_device_phase`)."""
    import tempfile
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch.mesh import make_debug_mesh
    print(f"phase M on {smi_reading()}", flush=True)
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        # M1: one rank; its group over a FileStore, no port
        if M_DEVICE == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(
            M_BACKEND, store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = make_debug_mesh(1, 1, device_type=M_DEVICE)
            print(f"  M1: {M_BACKEND} group of {dist.get_world_size()} "
                  f"rank, mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
                  f" on {M_DEVICE}", flush=True)
            report["M2"] = [m2_moe_layer(torch, name, mesh)
                            for name in M2_CONFIGS]
            report["M3"] = m3_dbrx(torch, mesh)
        finally:
            dist.destroy_process_group()
    report["M4"] = m4_dryrun()
    print("PHASE_M=" + json.dumps(report), flush=True)
    return 0


def _m_config(name, **kw):
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(name), moe_ep=True,
                               moe_ep_shards=1, **kw)


def m2_moe_layer(torch, name, mesh):
    """M2: one MoE layer at full width in f32, M_TOKENS seeded tokens,
    through `moe_apply_ep` on the mesh and through `moe_apply`: every
    output row within F32_TOL x max(1, max |plain row|), every weight
    gradient (of a seeded cotangent) within M2_GRAD_TOL x its leaf's
    max."""
    from repro_torch.models import moe, moe_ep
    from repro_torch.models.param import Dense
    full = _m_config(name, dtype="float32")
    cfg = dataclasses.replace(full, moe=dataclasses.replace(
        full.moe, capacity_factor=M2_CAPACITY))
    E, k, d, f = cfg.moe.n_experts, cfg.moe.top_k, cfg.d_model, cfg.d_ff
    g = torch.Generator(device=M_DEVICE).manual_seed(SEED + 21)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=M_DEVICE) * scale

    w = {"router": randn(d, E, scale=d ** -0.5),
         "w1": randn(E, d, f, scale=d ** -0.5),
         "w2": randn(E, f, d, scale=f ** -0.5),
         "w3": randn(E, d, f, scale=d ** -0.5)}
    x, cot = randn(1, M_TOKENS, d), randn(1, M_TOKENS, d)
    # no assignment drops: every expert's load within both capacities
    with torch.no_grad():
        idx = moe.top_k(torch.softmax(x[0] @ w["router"], -1), k)[1]
        load = int(torch.bincount(idx.flatten(), minlength=E).max())
    cap = moe.capacity(cfg, M_TOKENS)
    check(load <= cap, f"M2 {name}: an expert takes {load} > {cap} slots")

    def run(ep):
        p = moe.MoE(*(Dense(w[n]) for n in ("router", "w1", "w2", "w3")))
        leaves = [getattr(p, n).w.requires_grad_(True)
                  for n in ("router", "w1", "w2", "w3")]
        if ep:
            y, _ = moe_ep.moe_apply_ep(cfg, p, x, mesh)
        else:
            with moe.record_routing() as routes:
                y, _ = moe.moe_apply(cfg, p, x)
            check(int(routes[0]["dropped"]) == 0, f"M2 {name}: drops")
        gs = torch.autograd.grad((y * cot).sum(), leaves)
        return y.detach(), gs

    y_ep, g_ep = run(True)
    g_ep = [t.cpu() for t in g_ep]          # room for the second pass
    y_ref, g_ref = run(False)
    err = check_close(f"M2 {name} moe_apply_ep", y_ep[0], y_ref[0],
                      torch.float32)
    worst = max(grads_close(f"M2 {name} {n} gradient", [a.to(b.device)],
                            [b], [n], tol=M2_GRAD_TOL)
                for n, a, b in zip(("router", "w1", "w2", "w3"), g_ep,
                                   g_ref))
    print(f"  M2 {name}: E {E} top-{k} d {d} f {f}, {M_TOKENS} tokens, "
          f"max load {load} of capacity {cap}; output err {err:.3e}",
          flush=True)
    return {"model": name, "max_abs_err": err, "grad_worst": worst,
            "max_load": load, "capacity": cap}


def m3_dbrx(torch, mesh):
    """M3: dbrx-132b at full width, M3_LAYERS layers, moe_ep over the
    mesh against the same weights without a mesh: a packed prefill
    (M3_ROWS x M3_LEN, mbgmv pool) and one decode step, logits within
    LOGIT_TOL of max |logit|; a LoRA loss (M3_TRAIN) within 1e-2, and
    each adapter gradient of its cross-entropy within GRAD_TOL of its
    max.
    The capacity factor E / top-k never drops (an expert takes at most
    every token of a group once); flash and the LoRA kernels must launch
    under the mesh."""
    from repro_torch import sharding as shd
    from repro_torch.models import model, moe
    from repro_torch.models.weights import init_params
    from repro_torch.training import train as train_lib
    full = _m_config("dbrx-132b", n_layers=M3_LAYERS)
    cfg = dataclasses.replace(full, moe=dataclasses.replace(
        full.moe, capacity_factor=full.moe.n_experts / full.moe.top_k))
    params = init_params(cfg, SEED, M_DEVICE)
    pool = g_pool(torch, cfg)
    g = torch.Generator(device=M_DEVICE).manual_seed(SEED + 22)
    toks = torch.randint(0, cfg.vocab, (M3_ROWS, M3_LEN), generator=g,
                         device=M_DEVICE, dtype=torch.int32)
    idx = torch.arange(M3_ROWS, device=M_DEVICE, dtype=torch.int32) % 2
    lora = {"pool": pool, "idx": idx, "mode": "mbgmv"}
    nxt = torch.randint(0, cfg.vocab, (M3_ROWS, 1), generator=g,
                        device=M_DEVICE, dtype=torch.int32)
    pos = torch.full((M3_ROWS,), M3_LEN, device=M_DEVICE, dtype=torch.int32)

    def serve():
        with torch.no_grad():
            lp, cache = model.prefill(cfg, params, {"tokens": toks},
                                      lora=lora, cache_slots=M3_LEN + 1,
                                      last_only=True)
            ld, _ = model.decode(cfg, params, cache, nxt, pos, lora=lora)
        return lp[:, 0].float(), ld[:, 0].float()

    adapter = train_lib.init_lora_adapter(cfg, M3_RANK, g)
    for t in adapter.values():
        t["b"].copy_(torch.randn(t["b"].shape, generator=g,
                                 device=M_DEVICE) * 0.02)
    B, L = M3_TRAIN
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, L), generator=g,
                                     device=M_DEVICE, dtype=torch.int32)}

    def train():
        """(the loss, the cross-entropy's adapter gradients). The MoE aux
        term is an estimator of its own on each path, in both packages
        (one group of a data shard's tokens under moe_ep, one group a
        sequence without), so the gradients are held on the
        cross-entropy (aux_weight 0) and the loss with its aux."""
        flat = [t.detach().requires_grad_()
                for t in train_lib.tree_lib.leaves(adapter)]
        lora = {"pool": train_lib.lora_pool(
            train_lib.tree_lib.unflatten(adapter, flat), M3_RANK),
            "idx": torch.zeros(B, dtype=torch.int32, device=M_DEVICE),
            "mode": "bgmv"}
        with torch.no_grad():
            loss, _ = model.loss(cfg, params, batch, lora=lora)
        ce, _ = model.loss(cfg, params, batch, lora=lora, aux_weight=0.0)
        return float(loss), torch.autograd.grad(ce, flat)

    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    with shd.use_mesh(mesh):
        lp_m, ld_m = serve()
        loss_m, g_m = train()
    launches = {n: fn.launches for n, fn in counters.items()}
    for n in ("flash_attention", "lora_shrink", "lora_expand"):
        check(M_DEVICE != "cuda" or launches[n] > 0,
              f"M3: {n} did not launch under the mesh")
    with moe.record_routing() as routes:
        lp, ld = serve()
    check(all(int(r["dropped"]) == 0 for r in routes), "M3: drops")
    loss, g_p = train()
    out = {"prefill": logits_close(torch, "M3 prefill (mesh vs none)",
                                   lp_m, lp),
           "decode": logits_close(torch, "M3 decode (mesh vs none)",
                                  ld_m, ld)}
    check(abs(loss_m - loss) <= 1e-2 * abs(loss),
          f"M3: LoRA loss {loss_m} under the mesh, {loss} without")
    names = train_lib.tree_lib.paths(adapter)
    out["grad_worst"] = grads_close(
        "M3 adapter gradients of the cross-entropy (mesh vs none)", g_m,
        g_p, names)
    print(f"  M3 dbrx-132b: {cfg.n_layers}/{full.n_layers} layers, moe_ep "
          f"over a 1 x 1 mesh; loss {loss_m:.6f} vs {loss:.6f}; launches "
          f"under the mesh {launches}", flush=True)
    out.update(loss_mesh=loss_m, loss=loss, launches=launches,
               layers=cfg.n_layers)
    return out


M4_SCRIPT = r"""
import json, sys, time
from repro_torch.launch.dryrun import run_combo
for arch, shape, opts in json.loads(sys.argv[1]):
    t0 = time.time()
    r = run_combo(arch, shape, opts=tuple(opts))
    r["wall_s"] = time.time() - t0
    print("M4=" + json.dumps(r, default=str), flush=True)
"""


def m4_dryrun():
    """M4: the port's dry run of M4_COMBOS on pod16x16 in a process of its
    own, within M4_TIMEOUT: every record ok; its peak bytes a chip, fits
    and dominant roofline term printed."""
    t0 = time.perf_counter()
    out = run_group([sys.executable, "-c", M4_SCRIPT, json.dumps(M4_COMBOS)],
                    M4_TIMEOUT, env=dict(os.environ, PYTHONPATH=str(SRC)))
    check(out.returncode == 0, f"M4: the dry run failed: "
          f"{out.stderr[-3000:]}")
    recs = [json.loads(x[3:]) for x in out.stdout.splitlines()
            if x.startswith("M4=")]
    check(len(recs) == len(M4_COMBOS), "M4: records missing")
    rows = []
    for r in recs:
        check(r["status"] == "ok", f"M4: {r['arch']} {r['shape']} "
              f"{r['status']}")
        t = r["roofline"]
        print(f"  M4 {r['arch']} {r['shape']} {r['mesh']}: bytes_per_chip "
              f"{r['bytes_per_chip'] / 2 ** 30:.3f} GiB (inputs "
              f"{r['analytic_input_bytes_per_chip'] / 2 ** 30:.3f} GiB), "
              f"fits_80g {r['fits_80g']}, dominant {t['dominant']} "
              f"(compute {t['compute_s']:.4g} s, memory {t['memory_s']:.4g}"
              f" s, collective {t['collective_s']:.4g} s), "
              f"{r['wall_s']:.1f} s", flush=True)
        rows.append({k: r[k] for k in (
            "arch", "shape", "mesh", "bytes_per_chip", "fits_80g",
            "analytic_input_bytes_per_chip", "hlo_flops_per_dev",
            "collective_bytes", "roofline", "model_flops",
            "useful_flops_ratio", "wall_s")})
    print(f"  M4: {len(rows)} records in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return rows


if __name__ == "__main__":
    sys.exit(phase_m_child() if sys.argv[1:] == ["--phase-m"] else main())
