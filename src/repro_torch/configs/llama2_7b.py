"""llama2-7b — the paper's own evaluation model (Table 2). arXiv:2307.09288."""
from repro_torch.configs.base import LoRAConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama2-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab=32000,
    mlp_act="silu",
    sliding_window=4096,
    accum_steps=4,
    lora=LoRAConfig(max_rank=64, n_slots=8, targets=("q", "k", "v")),
    citation="arXiv:2307.09288 (paper Table 2)",
))
