"""Whisper-style encoder-decoder backbone (arXiv:2212.04356). Mirrors
`repro.models.encdec`.

The mel-spectrogram + conv frontend is a stub, as in the reference:
callers provide (B, enc_seq, d_model) frame embeddings. Learned
positions; pre-LN; the decoder has self-attention (causal, cached, LoRA
q/k/v) and cross-attention (encoder K/V computed once at prefill and
cached). The model API is the only entry point: the serving engine has no
encoder input to pass, in the reference as here.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.layers import (cache_init_like, cache_write_prefill,
                                       embed_lookup, mlp_apply)
from repro_torch.models.param import Dense, Norm, _param, norm_apply
from repro_torch.models.transformer import (MLP, Attention, _lora_live,
                                            _lora_slice, _proj, attn_apply)


class EncBlock(nn.Module):
    def __init__(self, norm1: Norm, attn: Attention, norm2: Norm, mlp: MLP):
        super().__init__()
        self.norm1, self.attn, self.norm2, self.mlp = norm1, attn, norm2, mlp


class DecBlock(nn.Module):
    def __init__(self, norm1: Norm, attn: Attention, norm_x: Norm,
                 xattn: Attention, norm2: Norm, mlp: MLP):
        super().__init__()
        self.norm1, self.attn, self.norm_x = norm1, attn, norm_x
        self.xattn, self.norm2, self.mlp = xattn, norm2, mlp


class EncDec(nn.Module):
    """enc_pos (enc_seq, d); enc_blocks; enc_norm; embed (vocab, d);
    dec_pos (max_ctx, d); dec_blocks; final_norm; lm_head.w (d, vocab)."""

    def __init__(self, enc_pos, enc_blocks, enc_norm: Norm, embed, dec_pos,
                 dec_blocks, final_norm: Norm, lm_head: Dense):
        super().__init__()
        self.enc_pos = _param(enc_pos)
        self.enc_blocks = nn.ModuleList(enc_blocks)
        self.enc_norm = enc_norm
        self.embed = _param(embed)
        self.dec_pos = _param(dec_pos)
        self.dec_blocks = nn.ModuleList(dec_blocks)
        self.final_norm, self.lm_head = final_norm, lm_head


def encode(cfg, params: EncDec, enc_embeds):
    """enc_embeds: (B, enc_seq, d) stubbed frontend output. Bidirectional
    attention over the frames (the flash kernel on the card)."""
    x = enc_embeds.to(cfg.torch_dtype) + params.enc_pos[None]
    B, L = x.shape[:2]
    pos = torch.arange(L, dtype=torch.int32, device=x.device).expand(B, L)
    for p_l in params.enc_blocks:
        xn = norm_apply(p_l.norm1, x, cfg.norm)
        a, _ = attn_apply(cfg, p_l.attn, xn, pos, rope_cs=None, causal=False)
        h = x + a
        x = h + mlp_apply(cfg, p_l.mlp, norm_apply(p_l.norm2, h, cfg.norm))
    return norm_apply(params.enc_norm, x, cfg.norm)


def _dec_block(cfg, p_l: DecBlock, x, positions, enc_out, *, lora_layer,
               lora_idx, lora_ranks, lora_mode, lora_live, cache, decode):
    """One decoder block. cache: {self: kv-cache, cross: {k, v, pos}} (in
    decode, written in place), or, in prefill, {self: an empty kv-cache}
    or None. Returns (x, {self, cross})."""
    xn = norm_apply(p_l.norm1, x, cfg.norm)
    self_cache = cache["self"] if cache else None
    a, (k, v) = attn_apply(
        cfg, p_l.attn, xn, positions, rope_cs=None, lora_layer=lora_layer,
        lora_idx=lora_idx, lora_ranks=lora_ranks, lora_mode=lora_mode,
        lora_live=lora_live, cache=self_cache if decode else None,
        decode=decode)
    if self_cache is not None and not decode:
        cache_write_prefill(self_cache, k, v, positions)
    x = x + a
    xn = norm_apply(p_l.norm_x, x, cfg.norm)
    if decode:
        a, _ = attn_apply(cfg, p_l.xattn, xn, positions, rope_cs=None,
                          cache=cache["cross"], decode=True,
                          kv_override=(None, None))
        cross_cache = cache["cross"]
    else:
        ck = _proj(p_l.xattn.wk, enc_out)
        cv = _proj(p_l.xattn.wv, enc_out)
        a, _ = attn_apply(cfg, p_l.xattn, xn, positions, rope_cs=None,
                          causal=False, kv_override=(ck, cv))
        B, S = enc_out.shape[:2]
        ep = torch.arange(S, dtype=torch.int32,
                          device=x.device).expand(B, S)
        cross_cache = {"k": ck.transpose(1, 2), "v": cv.transpose(1, 2),
                       "pos": ep}
    x = x + a
    x = x + mlp_apply(cfg, p_l.mlp, norm_apply(p_l.norm2, x, cfg.norm))
    return x, {"self": self_cache, "cross": cross_cache}


def prefill(cfg, params: EncDec, tokens, enc_embeds, *, lora=None,
            cache_slots=None, last_only=False):
    """Returns (logits, cache): one {self, cross} entry a decoder layer
    when `cache_slots` is given, self a kv-cache of cache_slots slots."""
    enc_out = encode(cfg, params, enc_embeds)
    B, L = tokens.shape
    x = embed_lookup(params.embed, tokens).to(cfg.torch_dtype)
    idxs = torch.clamp(torch.arange(L, device=x.device), max=cfg.max_ctx - 1)
    x = x + params.dec_pos[idxs][None]
    positions = torch.arange(L, dtype=torch.int32,
                             device=x.device).expand(B, L)
    live = _lora_live(cfg, lora)
    caches = []
    for i, p_l in enumerate(params.dec_blocks):
        ll, lora_idx, lora_ranks, lora_mode = _lora_slice(lora, i)
        c0 = {"self": cache_init_like(x, B, cfg.n_kv_heads, cache_slots,
                                      cfg.hd, cfg.torch_dtype),
              "cross": None} if cache_slots else None
        x, c = _dec_block(cfg, p_l, x, positions, enc_out, lora_layer=ll,
                          lora_idx=lora_idx, lora_ranks=lora_ranks,
                          lora_mode=lora_mode, lora_live=live, cache=c0,
                          decode=False)
        caches.append(c)
    if last_only:
        x = x[:, -1:]
    xn = norm_apply(params.final_norm, x, cfg.norm)
    return xn @ params.lm_head.w, (caches if cache_slots else None)


def decode_step(cfg, params: EncDec, cache, tokens_t, pos, *, lora=None):
    """tokens_t: (B, 1); pos: (B,). The self caches are written in place.
    Returns (logits, cache)."""
    x = embed_lookup(params.embed, tokens_t).to(cfg.torch_dtype)
    pidx = torch.clamp(pos.long(), max=cfg.max_ctx - 1)
    x = x + embed_lookup(params.dec_pos, pidx, ("seq", "embed"))[:, None]
    live = _lora_live(cfg, lora)
    for i, (p_l, c_l) in enumerate(zip(params.dec_blocks, cache)):
        ll, lora_idx, lora_ranks, lora_mode = _lora_slice(lora, i)
        x, _ = _dec_block(cfg, p_l, x, pos, None, lora_layer=ll,
                          lora_idx=lora_idx, lora_ranks=lora_ranks,
                          lora_mode=lora_mode, lora_live=live, cache=c_l,
                          decode=True)
    xn = norm_apply(params.final_norm, x, cfg.norm)
    return xn @ params.lm_head.w, cache
