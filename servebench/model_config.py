"""A configuration file (`servebench/configs/<name>.json`, Hugging Face
key names) read into the sizes the harness and the reference use, and
into the port's `ModelConfig` for the system under test."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Tuple

import torch

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    d_model: int
    d_ff: int
    n_heads: int
    n_kv_heads: int
    hd: int
    n_layers: int
    vocab: int
    qkv_bias: bool
    eps: float
    rope_theta: float
    dtype: str
    lora_targets: Tuple[str, ...]
    max_rank: int
    rank_block: int
    n_slots: int
    sliding_window: int
    reference: str

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def r_pad(self) -> int:
        """The pool's rank axis: max_rank rounded up to a multiple of 8."""
        return -(-self.max_rank // 8) * 8

    def lora_dims(self, target: str) -> Tuple[int, int]:
        if target == "q":
            return self.d_model, self.n_heads * self.hd
        if target in ("k", "v"):
            return self.d_model, self.n_kv_heads * self.hd
        raise ValueError(f"no LoRA target {target!r} in a dense model")

    def matmul_params_a_layer(self) -> int:
        d, hd = self.d_model, self.hd
        return d * (self.n_heads + 2 * self.n_kv_heads) * hd \
            + self.n_heads * hd * d + 3 * d * self.d_ff

    def port_config(self):
        """The port's ModelConfig for these sizes."""
        from repro_torch.configs.base import LoRAConfig, ModelConfig
        return ModelConfig(
            name=self.name, family="dense", n_layers=self.n_layers,
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, d_ff=self.d_ff, vocab=self.vocab,
            head_dim=self.hd, qkv_bias=self.qkv_bias, mlp_act="silu",
            norm="rmsnorm", rope_theta=self.rope_theta,
            sliding_window=self.sliding_window, dtype=self.dtype,
            lora=LoRAConfig(max_rank=self.max_rank, n_slots=self.n_slots,
                            rank_block=self.rank_block,
                            targets=self.lora_targets))


def spec_from_dict(c: dict) -> ModelSpec:
    if c.get("hidden_act", "silu") != "silu" or c.get("tie_word_embeddings"):
        raise ValueError(f"{c['name']}: only untied SwiGLU models are read")
    lora = c["lora"]
    return ModelSpec(
        name=c["name"], d_model=c["hidden_size"],
        d_ff=c["intermediate_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"],
        hd=c.get("head_dim") or c["hidden_size"] // c["num_attention_heads"],
        n_layers=c["num_hidden_layers"], vocab=c["vocab_size"],
        qkv_bias=bool(c.get("attention_bias", False)),
        eps=float(c["rms_norm_eps"]), rope_theta=float(c["rope_theta"]),
        dtype=c["torch_dtype"], lora_targets=tuple(lora["targets"]),
        max_rank=lora["max_rank"], rank_block=lora["rank_block"],
        n_slots=lora["n_slots"], sliding_window=c.get("sliding_window"),
        reference=c["reference"])


def load_spec(name: str, root: Path = HERE) -> ModelSpec:
    path = root / "configs" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no configuration {name!r} at {path}")
    return spec_from_dict(json.loads(path.read_text()))
