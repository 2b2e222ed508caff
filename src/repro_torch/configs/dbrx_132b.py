"""dbrx-132b [moe] — 16 experts top-4, fine-grained. hf:databricks/dbrx-base."""
from repro_torch.configs.base import (LoRAConfig, ModelConfig, MoEConfig,
                                      register)

CONFIG = register(ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    mlp_act="silu",
    moe=MoEConfig(n_experts=16, top_k=4),
    sliding_window=4096,   # windowed variant for long_500k (DESIGN.md sec 4)
    fsdp_weights=True,
    opt_moments_dtype="bfloat16",
    accum_steps=16,
    lora=LoRAConfig(max_rank=64, n_slots=8, targets=("q", "k", "v")),
    citation="hf:databricks/dbrx-base",
))
