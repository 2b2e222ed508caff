"""Decoder-only dense transformer with LoRA hooks on W_q/W_k/W_v (paper
sec 7.1): the modules, and the prefill / decode functions over them.
Mirrors the dense branch of `repro.models.transformer`.

QKV projections are stored 3-D — (d_model, heads, head_dim) — and the
output projection (heads, head_dim, d_model), the reference's layouts.
Layers are a ModuleList rather than one stacked tensor per leaf, so the
decode loop indexes a layer's weights without slicing copies.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.lora import lora_apply
from repro_torch.kernels.ops import lora_live
from repro_torch.models.layers import (apply_rope, attn_prefill,
                                       cache_write_token_paged, mlp_apply,
                                       paged_attn_decode, paged_write_index,
                                       rope_tables)
from repro_torch.models.param import Dense, Norm, norm_apply

ROADMAP_FAMILIES = ("model family or variant not ported to repro_torch yet "
                    "(ROADMAP.md queue 1, other model families)")


# --------------------------------------------------------------- modules ----

class Attention(nn.Module):
    def __init__(self, wq: Dense, wk: Dense, wv: Dense, wo: Dense):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo


class MLP(nn.Module):
    def __init__(self, w1: Dense, w2: Dense, w3: Dense):
        super().__init__()
        self.w1, self.w2, self.w3 = w1, w2, w3


class Block(nn.Module):
    def __init__(self, norm1: Norm, attn: Attention, norm2: Norm, mlp: MLP):
        super().__init__()
        self.norm1, self.attn, self.norm2, self.mlp = norm1, attn, norm2, mlp


class Transformer(nn.Module):
    """embed (vocab, d); blocks[i]; final_norm; lm_head.w (d, vocab)."""

    def __init__(self, embed: torch.Tensor, blocks, final_norm: Norm,
                 lm_head: Dense):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm
        self.lm_head = lm_head


# ------------------------------------------------------------ attention ----

def _proj(p: Dense, x):
    """x (B, L, d) @ w (d, n, h) -> (B, L, n, h), as one matmul."""
    d, n, h = p.w.shape
    return (x @ p.w.reshape(d, n * h)).reshape(*x.shape[:-1], n, h)


def _lora_heads(xn, lora_layer, tgt, idx, ranks, mode, rank_block, live,
                nh, hd):
    delta = lora_apply(xn, lora_layer, tgt, idx, ranks, mode, rank_block,
                       live)
    if delta is None:
        return None
    return delta.reshape(*delta.shape[:-1], nh, hd)


def _plus(y, delta):
    return y if delta is None else y + delta


def attn_apply(cfg, p: Attention, x, positions, *, rope_cs,
               lora_layer=None, lora_idx=None, lora_ranks=None,
               lora_mode="bgmv", lora_live=None, decode=False, cache=None, write_mask=None, block_table=None,
               write_index=None):
    """Returns (out, kv). positions: (B, L) prefill / (B,) decode.

    Decode writes the token's K/V into the paged cache `cache` (one layer's
    page pools, updated in place) through `block_table` and attends over
    the row's pages; `write_mask` (B,) bool drops the write of frozen rows.
    Prefill attends densely and returns the rotated (k, v) so the caller
    can build the row caches. `rope_cs`, `write_index` and `lora_live` are
    per-step values the caller computes once for all layers (`rope_cs`:
    `layers.rope_tables` at `positions`)."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    lora = (lora_idx, lora_ranks, lora_mode, cfg.lora.rank_block, lora_live)
    q = _plus(_proj(p.wq, x), _lora_heads(x, lora_layer, "q", *lora, H, hd))
    k = _plus(_proj(p.wk, x), _lora_heads(x, lora_layer, "k", *lora, KV, hd))
    v = _plus(_proj(p.wv, x), _lora_heads(x, lora_layer, "v", *lora, KV, hd))
    q = apply_rope(q, *rope_cs)
    k = apply_rope(k, *rope_cs)
    if decode:
        if block_table is None:
            raise NotImplementedError(
                "decode over the dense per-row cache is not ported to "
                "repro_torch yet (ROADMAP.md queue 1, memory='dense')")
        cache_write_token_paged(cache, k, v, positions, block_table,
                                write_mask=write_mask, index=write_index)
        out = paged_attn_decode(q, cache, block_table, positions)
    else:
        out = attn_prefill(q, k, v)
    B, L = out.shape[0], out.shape[1]
    y = out.reshape(B, L, H * hd) @ p.wo.w.reshape(H * hd, -1)
    return y, (k, v)


# ---------------------------------------------------------------- blocks ----

def block_apply(cfg, p: Block, x, positions, *, rope_cs, lora_layer,
                lora_idx, lora_ranks, lora_mode, decode,
                lora_live=None, cache=None, write_mask=None,
                block_table=None, write_index=None):
    """Returns (y, (k, v)) — the layer's rotated K/V for prefill."""
    xn = norm_apply(p.norm1, x)
    a, kv = attn_apply(
        cfg, p.attn, xn, positions, lora_layer=lora_layer,
        lora_idx=lora_idx, lora_ranks=lora_ranks, lora_mode=lora_mode,
        lora_live=lora_live, decode=decode, cache=cache,
        write_mask=write_mask, block_table=block_table, rope_cs=rope_cs,
        write_index=write_index)
    h = x + a
    hn = norm_apply(p.norm2, h)
    return h + mlp_apply(cfg, p.mlp, hn), kv


# ------------------------------------------------------------- top level ----

def embed_tokens(cfg, params: Transformer, tokens):
    return params.embed[tokens.long()].to(cfg.torch_dtype)


def unembed(cfg, params: Transformer, x):
    return norm_apply(params.final_norm, x) @ params.lm_head.w


def _lora_slice(lora, i):
    """Layer i's slice of the LoRA pool (views, no copies); None-safe."""
    if lora is None:
        return None, None, None, "none"
    pool, idx, mode = lora["pool"], lora["idx"], lora.get("mode", "bgmv")
    per_layer = {t: {"a": pool[t]["a"][i], "b": pool[t]["b"][i]}
                 for t in pool if t != "ranks"}
    return per_layer, idx, pool["ranks"], mode


def _lora_live(cfg, lora):
    """The step's live rank columns per row, shared by every layer."""
    if lora is None:
        return None
    return lora_live(lora["idx"], lora["pool"]["ranks"],
                     lora.get("mode", "bgmv"), cfg.lora.max_rank,
                     cfg.lora.rank_block)


def _check_family(cfg):
    """The port serves the llama-style dense family: RMSNorm, SwiGLU,
    RoPE, no biases, untied embeddings."""
    if (cfg.family != "dense" or cfg.moe or cfg.hybrid or cfg.qkv_bias
            or cfg.norm != "rmsnorm" or cfg.mlp_act != "silu"
            or cfg.pos != "rope" or cfg.tie_embeddings):
        raise NotImplementedError(f"{cfg.name}: {ROADMAP_FAMILIES}")


def prefill(cfg, params: Transformer, tokens, *, lora=None,
            cache_slots=None, positions=None, last_only=False,
            last_pos=None):
    """Returns (logits, cache). cache_slots=None -> no cache; else the row
    caches {"k"/"v": (L, B, KV, cache_slots, hd), "pos": (L, B,
    cache_slots)} with the prompt in slots [0, L) and pos -1 past it.
    last_pos: optional (B,) per-row positions — the residual stream is
    gathered there *before* the unembed, so the (B, L, vocab) logits are
    never materialized."""
    _check_family(cfg)
    x = embed_tokens(cfg, params, tokens)
    B, L = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(L, dtype=torch.int32,
                                 device=x.device).expand(B, L)
    cache = None
    if cache_slots is not None:
        if L > cache_slots:
            raise NotImplementedError(
                "a prefill longer than the cache (ring write) is not ported "
                "to repro_torch yet (ROADMAP.md queue 1, memory='dense')")
        nl, kvh, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
        dev, dt = x.device, cfg.torch_dtype
        cache = {"k": torch.zeros(nl, B, kvh, cache_slots, hd, dtype=dt,
                                  device=dev),
                 "v": torch.zeros(nl, B, kvh, cache_slots, hd, dtype=dt,
                                  device=dev),
                 "pos": torch.full((nl, B, cache_slots), -1,
                                   dtype=torch.int32, device=dev)}
        cache["pos"][:, :, :L] = positions.to(torch.int32)
    rope_cs = rope_tables(positions, cfg.hd, cfg.rope_theta)
    live = _lora_live(cfg, lora)
    for i, p_l in enumerate(params.blocks):
        ll, lora_idx, lora_ranks, lora_mode = _lora_slice(lora, i)
        x, (k, v) = block_apply(
            cfg, p_l, x, positions, lora_layer=ll, lora_idx=lora_idx,
            lora_ranks=lora_ranks, lora_mode=lora_mode, lora_live=live,
            decode=False, rope_cs=rope_cs)
        if cache is not None:
            cache["k"][i, :, :, :L] = k.transpose(1, 2)
            cache["v"][i, :, :, :L] = v.transpose(1, 2)
    if last_pos is not None:
        x = x[torch.arange(B, device=x.device), last_pos.long()][:, None]
    elif last_only:
        x = x[:, -1:]
    return unembed(cfg, params, x), cache


def decode_step(cfg, params: Transformer, cache, tokens_t, pos, *,
                lora=None, write_mask=None, block_table=None):
    """tokens_t: (B, 1); pos: (B,) current absolute position. cache is the
    paged pool {"k"/"v": (L, P + 1, KV, ps, hd), "pos": (L, P + 1, ps)},
    updated in place through `block_table` (B, W); write_mask (B,) bool
    drops frozen rows' writes. Returns (logits, cache)."""
    _check_family(cfg)
    x = embed_tokens(cfg, params, tokens_t)
    # per-step values every layer shares
    rope_cs = rope_tables(pos[:, None], cfg.hd, cfg.rope_theta)
    windex = paged_write_index(cache["k"], block_table, pos, write_mask) \
        if block_table is not None else None
    live = _lora_live(cfg, lora)
    for i, p_l in enumerate(params.blocks):
        ll, lora_idx, lora_ranks, lora_mode = _lora_slice(lora, i)
        cache_l = {name: t[i] for name, t in cache.items()}
        x, _ = block_apply(
            cfg, p_l, x, pos, lora_layer=ll, lora_idx=lora_idx,
            lora_ranks=lora_ranks, lora_mode=lora_mode, lora_live=live,
            decode=True, cache=cache_l,
            write_mask=write_mask, block_table=block_table,
            rope_cs=rope_cs, write_index=windex)
    return unembed(cfg, params, x), cache
