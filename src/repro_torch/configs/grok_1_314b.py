"""grok-1-314b [moe] — 8 experts top-2. hf:xai-org/grok-1."""
from repro_torch.configs.base import (LoRAConfig, ModelConfig, MoEConfig,
                                      register)

CONFIG = register(ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    mlp_act="geglu",
    moe=MoEConfig(n_experts=8, top_k=2),
    sliding_window=4096,
    fsdp_weights=True,
    opt_moments_dtype="bfloat16",
    accum_steps=16,
    lora=LoRAConfig(max_rank=64, n_slots=8, targets=("q", "k", "v")),
    citation="hf:xai-org/grok-1",
))
