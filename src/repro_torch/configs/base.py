"""Config system: ModelConfig dataclass, input-shape specs, registry.

A copy of the reference's config module whose dtype property yields a
torch dtype (`torch_dtype`). The port registers every config of the
reference: the decoder-only dense and MoE family (llama2-7b/13b/70b,
yi-9b, qwen2-72b, command-r-35b, mistral-large-123b, dbrx-132b,
grok-1-314b), phi-3-vision-4.2b (vlm), recurrentgemma-2b (hybrid),
mamba2-130m (ssm) and whisper-tiny (encoder-decoder); `smoke()` is
unchanged, so the reduced variant has the reference's exact shapes.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128       # N
    head_dim: int = 64         # P
    n_groups: int = 1          # G (B/C groups)
    conv_width: int = 4
    expand: int = 2            # d_inner = expand * d_model
    chunk: int = 256           # SSD chunk length


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma-style pattern: `pattern` repeats over layers."""
    pattern: Tuple[str, ...] = ("rglru", "rglru", "attn")  # 1:2 attn:rec
    window: int = 2048          # local attention window
    lru_width: Optional[int] = None  # defaults to d_model


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    """Paper setting: adapters on W_q, W_k, W_v (sec 7.1). For attention-free
    blocks (SSM) the adapter attaches to in_proj/out_proj instead."""
    max_rank: int = 64          # pool padding rank (BGMV pads to this)
    n_slots: int = 8            # device-resident adapter slots per server
    rank_block: int = 16        # MBGMV rank-block granularity (TPU lanes)
    targets: Tuple[str, ...] = ("q", "k", "v")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qkv_bias: bool = False
    mlp_act: str = "silu"       # silu (SwiGLU) | gelu (plain 2-mat MLP)
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    rope_theta: float = 10000.0
    pos: str = "rope"           # rope | learned (whisper)
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    lora: LoRAConfig = dataclasses.field(default_factory=LoRAConfig)
    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 1500         # stubbed conv-frontend output frames
    max_ctx: int = 32768        # learned-position table size (whisper real:448;
                                # sized up so prefill_32k/decode_32k lower)
    # VLM prefix stub
    n_prefix_tokens: int = 0    # patch embeddings prepended (phi-3-vision)
    # long-context handling
    sliding_window: Optional[int] = None  # if set, window attention available
    # distribution
    fsdp_weights: bool = False  # 2D (data x model) weight sharding for big models
    remat: bool = True
    accum_steps: int = 1        # grad-accum microbatches in train_step
    dtype: str = "bfloat16"
    opt_moments_dtype: str = "float32"  # bf16 on the biggest archs (memory)
    unroll_layers: bool = False # python-loop layers (dry-run cost probes)
    moe_2d_ff: bool = False     # expert d_ff over (data x model) [REFUTED:
                                # reshards activations, see sec Perf]
    moe_gather_weights: bool = False  # constrain expert-einsum outputs to
                                # batch sharding -> per-layer weight
                                # all-gather instead of activation reshard
    moe_ep: bool = False        # expert parallelism via shard_map all-to-all
                                # (models/moe_ep.py, sec Perf B)
    moe_ep_shards: int = 16     # expert-parallel width (= data-axis size of
                                # the production mesh); weights stored in EP
                                # layout so no per-layer resharding
    seq_parallel: bool = False  # shard residual-stream L over model in train
    kv_cache_dtype: str = ""    # "int8" -> quantized KV cache (serving)
    serve_tp: bool = False      # serving: TP-only weights (no FSDP gathers)
    citation: str = ""

    def probe(self, k: int) -> "ModelConfig":
        """k-layer unrolled variant for scan-corrected cost extrapolation
        (launch/dryrun.py): XLA cost analysis counts while bodies once, so
        totals are derived from probe(1)/probe(2) lowers."""
        n = 3 * k if self.hybrid else k
        return dataclasses.replace(
            self, n_layers=n,
            n_enc_layers=(k if self.n_enc_layers else 0),
            accum_steps=1, unroll_layers=True)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            s = self.ssm
            d_in = s.expand * d
            per = d * (2 * d_in + 2 * s.n_groups * s.state_dim) + d_in * d
            return emb + self.n_layers * per
        attn = d * self.hd * self.n_heads + 2 * d * self.hd * self.n_kv_heads \
            + self.hd * self.n_heads * d
        n_mats = 2 if self.mlp_act == "gelu" else 3   # silu/geglu are gated
        mlp = n_mats * d * f
        if self.moe:
            mlp = self.moe.n_experts * mlp + d * self.moe.n_experts
        per = attn + mlp
        n_blocks = self.n_layers + self.n_enc_layers
        return emb + n_blocks * per

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k experts only)."""
        if not self.moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        n_mats = 2 if self.mlp_act == "gelu" else 3
        dense_total = self.param_count() - self.n_layers * (
            self.moe.n_experts * n_mats * d * f + d * self.moe.n_experts)
        return dense_total + self.n_layers * self.moe.top_k * n_mats * d * f

    def smoke(self) -> "ModelConfig":
        """Reduced variant of the same family for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=2 if not self.hybrid else 3,
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            n_enc_layers=2 if self.n_enc_layers else 0,
            enc_seq=16,
            n_prefix_tokens=4 if self.n_prefix_tokens else 0,
            fsdp_weights=False,
            accum_steps=1,
            dtype="float32",
        )
        if self.moe:
            kw["moe"] = MoEConfig(n_experts=4, top_k=min(self.moe.top_k, 2))
        if self.ssm:
            kw["ssm"] = SSMConfig(state_dim=16, head_dim=16, conv_width=4,
                                  expand=2, chunk=8)
        if self.hybrid:
            kw["hybrid"] = HybridConfig(window=8)
        if self.sliding_window:
            kw["sliding_window"] = 16
        kw["lora"] = LoRAConfig(max_rank=8, n_slots=4, rank_block=4,
                                targets=self.lora.targets)
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}

ARCH_IDS = [
    "whisper-tiny", "recurrentgemma-2b", "dbrx-132b", "mistral-large-123b",
    "phi-3-vision-4.2b", "command-r-35b", "yi-9b", "grok-1-314b",
    "mamba2-130m", "qwen2-72b",
]

_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        mod = name.replace("-", "_").replace(".", "_")
        importlib.import_module(f"repro_torch.configs.{mod}")
    return _REGISTRY[name]


def all_arch_ids():
    return list(ARCH_IDS)


def combo_is_supported(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """The one documented skip: whisper long_500k (DESIGN.md sec 4)."""
    if shape.name == "long_500k":
        if cfg.family in ("encdec", "audio"):
            return False, ("encoder-decoder over 30s audio has no 500k-token "
                           "decode semantics (decoder ctx 448); skipped per "
                           "DESIGN.md sec 4")
        if cfg.family in ("dense", "moe", "vlm") and not cfg.sliding_window:
            return False, "full-attention arch without sliding-window variant"
    return True, ""
