"""Family dispatch, dense family only: mirrors `repro.models.model`.

  prefill(cfg, params, batch, ...) -> (logits, row caches)
  decode(cfg, params, cache, ...)  -> (logits, cache)
  cache_abstract(cfg, batch, ...)  -> meta-device stand-ins of the cache

Other families raise NotImplementedError (ROADMAP.md queue 1).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def supports_last_pos(cfg: ModelConfig) -> bool:
    """True when prefill() accepts `last_pos` (per-row pre-unembed
    gather)."""
    return cfg.family not in ("audio", "encdec")


def supports_write_mask(cfg: ModelConfig) -> bool:
    """True when decode() accepts `write_mask` (per-row cache-write
    drop)."""
    return cfg.family not in ("audio", "encdec")


def supports_paged(cfg: ModelConfig) -> bool:
    """True when decode() accepts the paged (block-table) cache layout: the
    uniform layered GQA KV cache without int8 quantization."""
    return (cfg.family not in ("audio", "encdec", "ssm")
            and not cfg.hybrid and cfg.kv_cache_dtype != "int8")


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """The model's capability, as in the reference; the port's serving
    backend does not run chunked prefill yet (ROADMAP.md queue 1)."""
    return supports_paged(cfg) and not cfg.moe


def prefill(cfg, params, batch, *, lora=None, cache_slots=None,
            last_only=False, last_pos=None):
    """batch: {tokens}. -> (logits, row caches). Full causal attention:
    the sliding-window variant is not ported yet (ROADMAP.md queue 1)."""
    return transformer.prefill(
        cfg, params, batch["tokens"], lora=lora, cache_slots=cache_slots,
        last_only=last_only, last_pos=last_pos)


def decode(cfg, params, cache, tokens_t, pos, *, lora=None,
           write_mask=None, block_table=None):
    """block_table (B, W): the cache is the paged page-pool layout;
    write_mask (B,) bool: rows with False skip the cache write."""
    return transformer.decode_step(cfg, params, cache, tokens_t, pos,
                                   lora=lora, write_mask=write_mask,
                                   block_table=block_table)


def decode_cache_slots(cfg: ModelConfig, seq_len: int) -> Optional[int]:
    """Cache depth for a decode shape: full-depth unless the sliding-window
    variant is in force (long contexts on windowed archs)."""
    if cfg.sliding_window and seq_len > 65536:
        return cfg.sliding_window
    return seq_len


def cache_abstract(cfg: ModelConfig, batch: int, seq_len: int):
    """Meta-device tensors matching the dense decode cache layout:
    k/v (L, batch, KV, slots, hd), pos (L, batch, slots) int32."""
    transformer._check_family(cfg)
    slots = decode_cache_slots(cfg, seq_len)
    L, kvh, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    meta = dict(device="meta")
    return {"k": torch.empty(L, batch, kvh, slots, hd,
                             dtype=cfg.torch_dtype, **meta),
            "v": torch.empty(L, batch, kvh, slots, hd,
                             dtype=cfg.torch_dtype, **meta),
            "pos": torch.empty(L, batch, slots, dtype=torch.int32, **meta)}
