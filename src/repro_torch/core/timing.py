"""Analytic timing model — the system's "profiler" on a CPU-only container.

A copy of the reference's timing module: the serving timeline stays this
analytic simulator (TPU v5e / A10 datasheet constants). Every TTFT or
tokens/s the engine derives from it is *simulated*, never a measurement
of the card; the card's own numbers are wall-clock times taken by
chip_smoke.py.

The paper profiles an A10 GPU to obtain prefill/decode latencies and feeds
them to both the serving engine's continuous-batching timeline and the
scheduler's performance models (sec 5, sec 7.5 "we obtain the prefill and
decoding latency of the simulator by profiling"). We reproduce that
methodology with a first-principles roofline cost model of the TPU v5e
target: iteration latency = max(compute term, HBM term) + fixed overheads,
and LoRA kernel cost follows the BGMV max-rank / MBGMV sum-rank laws by
construction of the kernels in repro.kernels.

Every constant is either a v5e datasheet number or calibrated to the paper's
figures (adapter upload ~tens of ms for rank 64, Fig 3; <1 ms invocation via
shared memory, Fig 17; single-CPU token ceiling, Fig 18).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str = "tpu-v5e"
    peak_flops: float = 197e12        # bf16 FLOP/s per chip
    hbm_bw: float = 819e9             # B/s per chip
    ici_bw: float = 50e9              # B/s per link
    hbm_bytes: float = 16 * 2 ** 30
    chips: int = 1                    # chips per serving instance (TP group)
    # host <-> device adapter upload (effective, pageable host memory);
    # calibrated so a rank-64 q/k/v adapter of a 7B model (~100 MiB) costs
    # ~25 ms, matching paper Fig 3-Right.
    load_bw: float = 4e9
    load_base_ms: float = 1.0
    # parallel upload lanes on the host link; 1 = a single PCIe/DMA stream,
    # so concurrent cold starts serialize on the link (LoadTracker)
    load_concurrency: int = 1
    # host-assist constants; core GEMM rate calibrated to paper Fig 18
    # (128-token rank-64 q/k/v prefill of a 7B model on 8 cores ~ 13 ms)
    cpu_core_flops: float = 120e9     # sustained AVX-512 GEMM FLOP/s per core
    cpu_cores: int = 112              # TPU VM host cores (DESIGN.md sec 6)
    cpu_max_tokens_per_core: int = 16 # profiling-guided parallelization knob
    invoke_overhead_ms: float = 0.8   # shared-memory IPC per prefill (Fig 17)
    sync_per_layer_ms: float = 0.02   # async memcpy+signal operator (Fig 8)
    step_overhead_ms: float = 1.5     # scheduling/launch overhead per iter


V5E = Hardware()
# The paper's testbed GPU, for apples-to-apples reproduction of its figures.
A10 = Hardware(name="a10", peak_flops=125e12, hbm_bw=600e9,
               hbm_bytes=24 * 2 ** 30, load_bw=4e9)


def model_bytes(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    return cfg.param_count() * dtype_bytes


def active_bytes(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    return cfg.active_param_count() * dtype_bytes


def kv_bytes_per_token(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    if cfg.family == "ssm":
        return 0
    n_blocks = cfg.n_layers + cfg.n_enc_layers
    return 2 * cfg.n_kv_heads * cfg.hd * n_blocks * dtype_bytes


class TimingModel:
    """Latency oracle for one serving instance of `cfg` on `hw`."""

    def __init__(self, cfg: ModelConfig, hw: Hardware = V5E):
        self.cfg = cfg
        self.hw = hw
        # config-derived constants, hoisted out of the per-iteration path
        # (the engine calls these oracles once per simulated iteration)
        self._active_params = cfg.active_param_count()
        self._active_bytes = active_bytes(cfg)
        self._kv_bpt = kv_bytes_per_token(cfg)
        self._lora_unit: Optional[float] = None

    # ----------------------------------------------------- base model ----
    def _attn_flops(self, new_tokens: int, ctx_start: int = 0) -> float:
        """FLOPs of causal attention for `new_tokens` query positions whose
        context already holds `ctx_start` cached keys: query i attends to
        ctx_start + i + 1 keys, and each (query, key) pair costs
        4 * n_heads * hd flops per block (QK^T + PV)."""
        if new_tokens <= 0 or self._kv_bpt == 0:
            return 0.0
        n_blocks = self.cfg.n_layers + self.cfg.n_enc_layers
        keys = new_tokens * ctx_start + new_tokens * (new_tokens + 1) / 2.0
        return 4.0 * n_blocks * self.cfg.n_heads * self.cfg.hd * keys

    def base_prefill_ms(self, total_tokens: int) -> float:
        """Monolithic prefill of `total_tokens` prompt tokens.

        Compute term = linear GEMM flops plus the quadratic causal-attention
        term (without it the model under-bills 2k+ token prompts); short
        prompts stay HBM-bound, so their cost is bitwise unchanged by the
        attention term.
        """
        flops = 2 * self._active_params * total_tokens \
            + self._attn_flops(total_tokens)
        t_c = flops / (self.hw.peak_flops * self.hw.chips)
        t_m = self._active_bytes / (self.hw.hbm_bw * self.hw.chips)
        return max(t_c, t_m) * 1e3 + self.hw.step_overhead_ms

    def chunk_prefill_ms(self, chunk_tokens: int, ctx_start: int = 0) -> float:
        """One prefill chunk of `chunk_tokens` on top of `ctx_start` cached
        tokens, run as its own iteration (no decode rows riding along)."""
        return self.mixed_step_ms(0, 0, chunk_tokens, ctx_start)

    def mixed_step_ms(self, batch: int, avg_ctx: int,
                      chunk_tokens: int, chunk_ctx: int = 0) -> float:
        """One iteration serving `batch` decode rows plus a piggybacked
        prefill chunk of `chunk_tokens` (context depth `chunk_ctx`).

        The chunk shares the iteration's weight pass and fixed step
        overhead with the decode batch — that sharing is the piggyback
        win — but pays its own GEMM/attention flops and re-reads the
        chunk row's prefix KV from HBM.
        """
        if chunk_tokens <= 0:
            return self.base_decode_ms(batch, avg_ctx)
        flops = 2 * self._active_params * (batch + chunk_tokens) \
            + self._attn_flops(chunk_tokens, chunk_ctx)
        par_b = self._active_bytes
        kv_b = self._kv_bpt * (avg_ctx * batch + chunk_ctx + chunk_tokens)
        t_c = flops / (self.hw.peak_flops * self.hw.chips)
        t_m = (par_b + kv_b) / (self.hw.hbm_bw * self.hw.chips)
        return max(t_c, t_m) * 1e3 + self.hw.step_overhead_ms

    def base_decode_ms(self, batch: int, avg_ctx: int = 512) -> float:
        """One decode iteration for `batch` sequences (HBM-bound)."""
        par_b = self._active_bytes
        kv_b = self._kv_bpt * avg_ctx * batch
        t_m = (par_b + kv_b) / (self.hw.hbm_bw * self.hw.chips)
        flops = 2 * self._active_params * batch
        t_c = flops / (self.hw.peak_flops * self.hw.chips)
        return max(t_c, t_m) * 1e3 + self.hw.step_overhead_ms

    # ------------------------------------------------------ LoRA kernels ----
    def _lora_bytes_per_token_rank(self) -> float:
        if self._lora_unit is not None:
            return self._lora_unit
        total = 0
        from repro_torch.core.lora import lora_target_dims
        for tgt in self.cfg.lora.targets:
            d_in, d_out = lora_target_dims(self.cfg, tgt)
            total += (d_in + d_out)
        n_blocks = self.cfg.n_layers + self.cfg.n_enc_layers
        self._lora_unit = total * n_blocks * 2  # bytes per unit rank (bf16)
        return self._lora_unit

    def lora_decode_ms(self, ranks: Sequence[int], kernel: str = "bgmv",
                       rank_block: int = 16) -> float:
        """Per-iteration LoRA kernel cost (HBM-bound, paper sec 5: >70% of
        memory bandwidth). BGMV: |S|*max(rank); MBGMV: sum(ceil(rank/RB)*RB)."""
        if not ranks:
            return 0.0
        unit = self._lora_bytes_per_token_rank()
        if kernel == "bgmv":
            work = len(ranks) * max(ranks)
        else:
            work = sum((r + rank_block - 1) // rank_block * rank_block
                       for r in ranks)
        return work * unit / (self.hw.hbm_bw * self.hw.chips) * 1e3

    def lora_prefill_gpu_ms(self, tokens: int, rank: int) -> float:
        unit = self._lora_bytes_per_token_rank()
        flops = tokens * rank * unit  # 2 flops per 2 bytes -> ~1:1
        return max(flops / (self.hw.peak_flops * self.hw.chips),
                   rank * unit / (self.hw.hbm_bw * self.hw.chips)) * 1e3

    # ------------------------------------------------------- cold start ----
    def load_ms(self, adapter_bytes: int) -> float:
        """Host->device adapter upload (the paper's cold-start, Fig 3)."""
        return self.hw.load_base_ms + adapter_bytes / self.hw.load_bw * 1e3

    def cpu_cores_for(self, tokens: int) -> int:
        """Profiling-guided parallelization (paper sec 4.2, Fig 18)."""
        want = -(-tokens // self.hw.cpu_max_tokens_per_core)
        return max(1, min(want, self.hw.cpu_cores))

    def cpu_lora_prefill_ms(self, tokens: int, rank: int) -> float:
        """Host CPUs computing x·A·B for the prefill (paper sec 4.1)."""
        unit = self._lora_bytes_per_token_rank()   # = flops per token-rank
        flops = tokens * rank * unit
        cores = self.cpu_cores_for(tokens)
        t = flops / (cores * self.hw.cpu_core_flops) * 1e3
        n_blocks = self.cfg.n_layers + self.cfg.n_enc_layers
        return t + self.hw.invoke_overhead_ms \
            + n_blocks * self.hw.sync_per_layer_ms

    def cpu_lora_decode_ms(self, ranks: Sequence[int]) -> float:
        """Host CPUs computing the per-token x·A·B for decode rows riding
        the CPU-assist path as a *fault shield* — their adapter upload is
        mid-retry (core/faults.py), so the LoRA delta comes from the host
        copy instead of stalling the row. One token per row per iteration:
        a single token cannot be split across cores
        (cpu_max_tokens_per_core >= 1), rows run on distinct cores in
        parallel — the iteration is bounded by the largest rank — and pays
        the shared-memory invocation plus per-layer sync overheads once
        (paper Figs 8, 17). The host work overlaps the device pass; the
        engine charges max(device_ms, cpu_lora_decode_ms)."""
        if not ranks:
            return 0.0
        unit = self._lora_bytes_per_token_rank()
        t = max(ranks) * unit / self.hw.cpu_core_flops * 1e3
        n_blocks = self.cfg.n_layers + self.cfg.n_enc_layers
        return t + self.hw.invoke_overhead_ms \
            + n_blocks * self.hw.sync_per_layer_ms
