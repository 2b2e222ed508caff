"""command-r-35b [dense] — GQA, no-bias. hf:CohereForAI/c4ai-command-r-v01."""
from repro_torch.configs.base import LoRAConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256000,
    mlp_act="silu",
    qkv_bias=False,
    sliding_window=4096,
    accum_steps=8,
    lora=LoRAConfig(max_rank=64, n_slots=8, targets=("q", "k", "v")),
    citation="hf:CohereForAI/c4ai-command-r-v01",
))
