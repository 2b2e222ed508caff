"""mamba2-130m [ssm] — SSD (state-space duality). arXiv:2405.21060.

Attention-free: LoRA attaches to in_proj/out_proj (DESIGN.md
sec Arch-applicability) — the paper's q/k/v targets do not exist here.
"""
from repro_torch.configs.base import LoRAConfig, ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,             # attention-free
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=128, head_dim=64, n_groups=1, conv_width=4,
                  expand=2, chunk=256),
    lora=LoRAConfig(max_rank=64, n_slots=8, targets=("in_proj", "out_proj")),
    citation="arXiv:2405.21060",
))
