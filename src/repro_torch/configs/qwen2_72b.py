"""qwen2-72b [dense] — GQA, QKV bias. arXiv:2407.10671."""
from repro_torch.configs.base import LoRAConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    mlp_act="silu",
    qkv_bias=True,
    sliding_window=4096,
    fsdp_weights=True,
    opt_moments_dtype="bfloat16",
    accum_steps=16,
    lora=LoRAConfig(max_rank=64, n_slots=8, targets=("q", "k", "v")),
    citation="arXiv:2407.10671",
))
