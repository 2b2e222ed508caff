"""llama2-13b — paper Table 2 multi-GPU row (2x A10 -> TP=2)."""
from repro_torch.configs.base import LoRAConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama2-13b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=13824,
    vocab=32000,
    mlp_act="silu",
    sliding_window=4096,
    accum_steps=4,
    lora=LoRAConfig(max_rank=64, n_slots=8, targets=("q", "k", "v")),
    citation="arXiv:2307.09288 (paper Table 2)",
))
