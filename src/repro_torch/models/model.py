"""Family dispatch, decoder-only dense and MoE family: mirrors
`repro.models.model`.

  prefill(cfg, params, batch, ...) -> (logits, row caches)
  prefill_chunk(cfg, params, ...)  -> logits of the final chunk, or None
  decode(cfg, params, cache, ...)  -> (logits, cache)
  cache_abstract(cfg, batch, ...)  -> meta-device stand-ins of the cache

The family decodes over the dense per-row cache (bf16/f32 or int8 KV)
or the paged pool, with full or sliding-window attention. Other families
raise NotImplementedError (ROADMAP.md queue 1).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers, transformer


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
    """True when the serving backend may split this model's prefill into
    fixed-token chunks (backend.prefill_chunk): the paged layered GQA cache
    plus per-position-independent blocks (MoE capacity routing depends on
    how many tokens share the batch)."""
    return supports_paged(cfg) and not cfg.moe


def prefill_chunk(cfg, params, tokens_c, start, clen, cache, page_ids, *,
                  lora=None, last=False, window=None):
    """One chunk of an incremental prefill, written into the row's pages of
    the paged pool in place; see transformer.prefill_chunk."""
    if not supports_chunked_prefill(cfg):
        raise ValueError(f"chunked prefill unsupported for {cfg.name}")
    return transformer.prefill_chunk(cfg, params, tokens_c, start, clen,
                                     cache, page_ids, lora=lora, last=last,
                                     window=window)


def prefill(cfg, params, batch, *, lora=None, cache_slots=None, window=None,
            last_only=False, last_pos=None):
    """batch: {tokens}. -> (logits, row caches). `window`: sliding-window
    causal attention (the flash kernel on the card), else full causal."""
    return transformer.prefill(
        cfg, params, batch["tokens"], lora=lora, cache_slots=cache_slots,
        window=window, last_only=last_only, last_pos=last_pos)


def decode(cfg, params, cache, tokens_t, pos, *, lora=None, window=None,
           write_mask=None, block_table=None):
    """block_table (B, W): the cache is the paged page-pool layout;
    write_mask (B,) bool: rows with False skip the cache write; `window`:
    sliding-window attention, plain PyTorch on both planes (the paged
    kernel is full-attention only, as the reference's)."""
    return transformer.decode_step(cfg, params, cache, tokens_t, pos,
                                   lora=lora, window=window,
                                   write_mask=write_mask,
                                   block_table=block_table)


def decode_cache_slots(cfg: ModelConfig, seq_len: int) -> Optional[int]:
    """Cache depth for a decode shape: full-depth unless the sliding-window
    variant is in force (long contexts on windowed archs)."""
    if cfg.sliding_window and seq_len > 65536:
        return cfg.sliding_window
    return seq_len


def decode_window(cfg: ModelConfig, seq_len: int) -> Optional[int]:
    """The decode window that goes with `decode_cache_slots`."""
    return cfg.sliding_window if (cfg.sliding_window and seq_len > 65536) \
        else None


def cache_abstract(cfg: ModelConfig, batch: int, seq_len: int):
    """Meta-device tensors matching the dense decode cache layout:
    k/v (L, batch, KV, slots, hd), pos (L, batch, slots) int32; with
    int8 KV the k/v payload is int8 and k_scale/v_scale (L, batch, KV,
    slots) f32 ride beside it."""
    transformer._check_family(cfg)
    return layers.cache_init(batch, cfg.n_kv_heads,
                             decode_cache_slots(cfg, seq_len), cfg.hd,
                             cfg.torch_dtype,
                             quantized=cfg.kv_cache_dtype == "int8",
                             layers=cfg.n_layers, device="meta")
