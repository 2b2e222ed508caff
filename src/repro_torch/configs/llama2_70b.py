"""llama2-70b — paper Table 2 multi-GPU row (4x A100 -> TP=4)."""
from repro_torch.configs.base import LoRAConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama2-70b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=32000,
    mlp_act="silu",
    sliding_window=4096,
    fsdp_weights=True,
    accum_steps=16,
    opt_moments_dtype="bfloat16",
    lora=LoRAConfig(max_rank=64, n_slots=8, targets=("q", "k", "v")),
    citation="arXiv:2307.09288 (paper Table 2)",
))
