"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend (stubbed).
hf:microsoft/Phi-3-vision-128k-instruct.

The ViT/SigLIP encoder + projector is a stub per the carve-out: input_specs()
provides (B, 576, 3072) patch embeddings prepended to the token sequence.
"""
from repro_torch.configs.base import LoRAConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,         # MHA
    d_ff=8192,
    vocab=32064,
    mlp_act="silu",
    n_prefix_tokens=576,   # 24x24 CLIP patches
    sliding_window=4096,
    accum_steps=4,
    lora=LoRAConfig(max_rank=64, n_slots=8, targets=("q", "k", "v")),
    citation="hf:microsoft/Phi-3-vision-128k-instruct",
))
