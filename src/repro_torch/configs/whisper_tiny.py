"""whisper-tiny [audio/enc-dec] — arXiv:2212.04356.

Transformer backbone only; the mel-spectrogram + conv feature extractor is a
stub per the carve-out: input_specs() provides (B, 1500, 384) frame embeddings.
"""
from repro_torch.configs.base import LoRAConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,            # decoder layers
    n_enc_layers=4,        # encoder layers
    enc_seq=1500,          # 30 s of audio -> 1500 frames after conv frontend
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    mlp_act="gelu",
    norm="layernorm",
    pos="learned",
    qkv_bias=True,         # whisper uses biases on q/v (we apply to qkv)
    lora=LoRAConfig(max_rank=64, n_slots=8, targets=("q", "k", "v")),
    citation="arXiv:2212.04356",
))
