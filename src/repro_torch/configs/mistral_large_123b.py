"""mistral-large-123b [dense] — hf:mistralai/Mistral-Large-Instruct-2407."""
from repro_torch.configs.base import LoRAConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    vocab=32768,
    mlp_act="silu",
    sliding_window=4096,
    fsdp_weights=True,
    opt_moments_dtype="bfloat16",
    accum_steps=16,
    lora=LoRAConfig(max_rank=64, n_slots=8, targets=("q", "k", "v")),
    citation="hf:mistralai/Mistral-Large-Instruct-2407",
))
