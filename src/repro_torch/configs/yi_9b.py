"""yi-9b [dense] — llama-arch GQA. arXiv:2403.04652."""
from repro_torch.configs.base import LoRAConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    mlp_act="silu",
    sliding_window=4096,
    accum_steps=4,
    lora=LoRAConfig(max_rank=64, n_slots=8, targets=("q", "k", "v")),
    citation="arXiv:2403.04652",
))
