"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2. arXiv:2402.19427."""
from repro_torch.configs.base import HybridConfig, LoRAConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,           # pattern (rglru, rglru, attn) repeating
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,          # MQA on the local-attention layers
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    mlp_act="gelu",        # gated gelu in the paper; plain-gelu GLU here
    accum_steps=2,
    hybrid=HybridConfig(pattern=("rglru", "rglru", "attn"), window=2048),
    lora=LoRAConfig(max_rank=64, n_slots=8, targets=("q", "k", "v")),
    citation="arXiv:2402.19427",
))
