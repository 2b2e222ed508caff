"""Decoder-only transformer (dense, MoE or VLM feed-forward stack, or the
RecurrentGemma hybrid of RG-LRU and local-attention layers) with LoRA
hooks on W_q/W_k/W_v (paper sec 7.1): the modules, and the prefill /
chunked-prefill / decode functions over them, full or sliding-window,
against the dense per-row KV cache (bf16/f32 or int8) or the paged pool.
Mirrors `repro.models.transformer`.

QKV projections are stored 3-D — (d_model, heads, head_dim) — and the
output projection (heads, head_dim, d_model), the reference's layouts.
Layers are a ModuleList rather than one stacked tensor per leaf, so the
decode loop indexes a layer's weights without slicing copies.
"""
from __future__ import annotations

import contextlib
from types import SimpleNamespace

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding as shd
from repro_torch.core.lora import lora_apply
from repro_torch.kernels.bgmv import padded_rank
from repro_torch.kernels.ops import lora_live
from repro_torch.models import rglru
from repro_torch.models.layers import (apply_rope, attn_decode,
                                       attn_prefill, cache_init_like,
                                       cache_kv_for_attn,
                                       cache_write_prefill,
                                       cache_write_token,
                                       cache_write_token_paged,
                                       embed_lookup, mlp_apply,
                                       paged_attn_chunk, paged_attn_decode,
                                       paged_write_index, rope_tables)
from repro_torch.models.moe import MoE, moe_apply
from repro_torch.models.moe_ep import moe_apply_ep
from repro_torch.models.param import Dense, Norm, norm_apply

FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "audio", "encdec")


# --------------------------------------------------------------- modules ----

class Attention(nn.Module):
    def __init__(self, wq: Dense, wk: Dense, wv: Dense, wo: Dense):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo


class MLP(nn.Module):
    """w1, w2, and w3 for a gated MLP (`cfg.mlp_act` silu / geglu)."""

    def __init__(self, w1: Dense, w2: Dense, w3: Dense = None):
        super().__init__()
        self.w1, self.w2, self.w3 = w1, w2, w3


class Block(nn.Module):
    """The feed-forward is `mlp` (an MLP) or `moe` (a MoE), the
    reference's leaf name."""

    def __init__(self, norm1: Norm, attn: Attention, norm2: Norm, ffn):
        super().__init__()
        self.norm1, self.attn, self.norm2 = norm1, attn, norm2
        if isinstance(ffn, MoE):
            self.moe = ffn
        else:
            self.mlp = ffn


class Transformer(nn.Module):
    """embed (vocab, d); blocks[i]; final_norm; lm_head.w (d, vocab), or
    None with tied embeddings (the unembed is embed^T). Also the container
    of the SSM stack (`models/ssm.py` blocks) and, with blocks of both
    kinds, of the hybrid."""

    def __init__(self, embed: torch.Tensor, blocks, final_norm: Norm,
                 lm_head: Dense = None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm
        self.lm_head = lm_head


# ------------------------------------------------------------ attention ----

def _proj(p: Dense, x):
    """x (B, L, d) @ w (d, n, h) [+ b (n, h)] -> (B, L, n, h), as one
    matmul."""
    if shd.is_dtensor(x):
        return _proj_dist(p, x)
    d, n, h = p.w.shape
    y = (x @ p.w.reshape(d, n * h)).reshape(*x.shape[:-1], n, h)
    return y if p.b is None else y + p.b


def _proj_dist(p: Dense, x):
    """`_proj` on each rank's rows and heads (heads over "model" where
    their count divides it, never a head cut), the weight's d_model whole:
    the reference's column-parallel projection, its FSDP gather
    included."""
    mesh = shd.current_mesh()

    def local(placed, x, w, b=None):
        if placed.get("heads"):       # x's gradient: a sum over the heads'
            x = shd.enter_sliced(x, shd.group_of(mesh, placed["heads"]))
        return _proj(SimpleNamespace(w=w, b=b), x)

    rows = ("batch",) + (None,) * (x.dim() - 1)
    w = (p.w,) if p.b is None else (p.w, p.b)
    return shd.local_call(
        local, (x, *w),
        (rows, (None, "heads", None), ("heads", None))[:len(w) + 1],
        rows[:-1] + ("heads", None))


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
               lora_mode="bgmv", lora_live=None, window=None, decode=False,
               cache=None, write_mask=None, block_table=None,
               write_index=None, causal=True, kv_override=None):
    """Returns (out, kv). positions: (B, L) prefill / (B,) decode.
    `window`: keys at or more than `window` positions behind the query
    are masked (sliding-window attention). `rope_cs` None: no RoPE
    (learned positions). `kv_override`: precomputed (k, v) (whisper's
    cross-attention), or (None, None) in decode, where the cross cache is
    attended at an unbounded position and nothing is written; `causal`
    False: bidirectional prefill (whisper's encoder and cross-attention).

    Decode writes the token's K/V into one layer's cache, in place, and
    attends over it; `write_mask` (B,) bool drops the write of frozen
    rows. With a `block_table` the cache is the paged pool and attention
    reads the row's pages (the paged kernel on the card); without one it
    is the dense per-row cache, dequantized if int8, and attention is the
    plain `attn_decode` on every device, as the reference computes it
    outside any Pallas kernel. Prefill attends densely and returns the
    rotated (k, v) so the caller can build the row caches; given a
    `cache`, it is one chunk of a row's prefill instead (B = 1): the
    chunk's K/V land in the row's pages at `write_index` and the chunk
    attends over those pages. `rope_cs`, `write_index` (paged: a
    `paged_write_index`; dense: the ring slot pos % S) and `lora_live`
    are per-step values the caller computes once for all layers
    (`rope_cs`: `layers.rope_tables` at `positions`)."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    lora = (lora_idx, lora_ranks, lora_mode, cfg.lora.rank_block, lora_live)
    q = _plus(_proj(p.wq, x), _lora_heads(x, lora_layer, "q", *lora, H, hd))
    if kv_override is None:
        k = _plus(_proj(p.wk, x),
                  _lora_heads(x, lora_layer, "k", *lora, KV, hd))
        v = _plus(_proj(p.wv, x),
                  _lora_heads(x, lora_layer, "v", *lora, KV, hd))
        if rope_cs is not None:
            k = apply_rope(k, *rope_cs)
    else:
        k, v = kv_override
    if rope_cs is not None:
        q = apply_rope(q, *rope_cs)
    if decode and kv_override is not None:
        ck, cv = cache_kv_for_attn(cache, cfg.torch_dtype)
        out = attn_decode(q, ck, cv, cache["pos"],
                          torch.full_like(cache["pos"][:, 0], 2 ** 30))
    elif decode and block_table is None:
        cache_write_token(cache, k, v, positions, write_mask=write_mask,
                          slot=write_index)
        ck, cv = cache_kv_for_attn(cache, cfg.torch_dtype)
        out = attn_decode(q, ck, cv, cache["pos"], positions, window=window)
    elif decode:
        cache_write_token_paged(cache, k, v, positions, block_table,
                                write_mask=write_mask, index=write_index)
        out = paged_attn_decode(q, cache, block_table, positions,
                                window=window)
    elif cache is not None:
        # each of the chunk's tokens written as a one-token row of its own
        cache_write_token_paged(cache, k.transpose(0, 1), v.transpose(0, 1),
                                positions[0], block_table,
                                index=write_index)
        out = paged_attn_chunk(q, cache, block_table, positions,
                               window=window)
    else:
        out = attn_prefill(q, k, v, causal=causal, window=window)
    B, L = out.shape[0], out.shape[1]
    y = out.reshape(B, L, H * hd) @ p.wo.w.reshape(H * hd, -1)
    return y, (k, v)


# ---------------------------------------------------------------- blocks ----

def block_apply(cfg, p: Block, x, positions, *, rope_cs, lora_layer,
                lora_idx, lora_ranks, lora_mode, decode,
                lora_live=None, window=None, cache=None, write_mask=None,
                block_table=None, write_index=None, need_aux=False):
    """Returns (y, (k, v)) — the layer's rotated K/V for prefill — or,
    with `need_aux`, (y, (k, v), aux): a MoE layer's load-balance loss
    (None for an MLP layer). A MoE layer takes the MLP's place; serving
    computes no aux. With `cfg.moe_ep` and a current mesh
    (`sharding.use_mesh`) that has a "data" axis, the MoE is expert-
    parallel over the data axes (`moe_ep.moe_apply_ep`), as the
    reference's."""
    xn = norm_apply(p.norm1, x, cfg.norm)
    a, kv = attn_apply(
        cfg, p.attn, xn, positions, lora_layer=lora_layer,
        lora_idx=lora_idx, lora_ranks=lora_ranks, lora_mode=lora_mode,
        lora_live=lora_live, window=window, decode=decode, cache=cache,
        write_mask=write_mask, block_table=block_table, rope_cs=rope_cs,
        write_index=write_index)
    h = x + a
    hn = norm_apply(p.norm2, h, cfg.norm)
    aux = None
    if cfg.moe:
        mesh = shd.current_mesh()
        if cfg.moe_ep and mesh is not None and \
                "data" in shd.axis_names(mesh):
            m, aux = moe_apply_ep(cfg, p.moe, hn, mesh,
                                  data_axes=shd.batch_axes(mesh),
                                  need_aux=need_aux)
        else:
            m, aux = moe_apply(cfg, p.moe, hn, need_aux=need_aux)
        y = h + m
    else:
        y = h + mlp_apply(cfg, p.mlp, hn)
    return (y, kv, aux) if need_aux else (y, kv)


# ------------------------------------------------------------- top level ----

def embed_tokens(cfg, params: Transformer, tokens, prefix_embeds=None):
    """Token embeddings, after `prefix_embeds` (B, P, d) when given (the
    VLM's stubbed patch embeddings)."""
    x = embed_lookup(params.embed, tokens).to(cfg.torch_dtype)
    if prefix_embeds is None:
        return x
    if shd.is_dtensor(x):        # each rank joins its rows (DTensor's cat
        rows = ("batch", None, None)    # gathers them)
        return shd.local_call(lambda placed, p, x: torch.cat([p, x], dim=1),
                              (prefix_embeds.to(x.dtype), x), (rows, rows),
                              rows)
    return torch.cat([prefix_embeds.to(x.dtype), x], dim=1)


def unembed(cfg, params: Transformer, x):
    xn = norm_apply(params.final_norm, x, cfg.norm)
    if params.lm_head is None:               # tied embeddings
        return xn @ params.embed.t()
    return xn @ params.lm_head.w


def hybrid_layer_kinds(cfg):
    pat = cfg.hybrid.pattern
    return [pat[i % len(pat)] for i in range(cfg.n_layers)]


def _rope(cfg, positions):
    """RoPE tables at `positions`, or None for learned positions."""
    return rope_tables(positions, cfg.hd, cfg.rope_theta) \
        if cfg.pos == "rope" else None


def _lora_slice(lora, i):
    """Layer i's slice of the LoRA pool (views, no copies); None-safe."""
    if lora is None:
        return None, None, None, "none"
    pool, idx, mode = lora["pool"], lora["idx"], lora.get("mode", "bgmv")
    per_layer = {t: {"a": shd.take_layer(pool[t]["a"], i),
                     "b": shd.take_layer(pool[t]["b"], i)}
                 for t in pool if t != "ranks"}
    return per_layer, idx, pool["ranks"], mode


def _lora_live(cfg, lora):
    """The step's live rank columns per row, shared by every layer."""
    if lora is None:
        return None
    return lora_live(lora["idx"], lora["pool"]["ranks"],
                     lora.get("mode", "bgmv"), padded_rank(cfg.lora.max_rank),
                     cfg.lora.rank_block)


def remat_layer(cfg, fn, *args):
    """One layer, `fn(*args)`: under activation checkpointing when
    `cfg.remat` and grad mode is on (the reference's `jax.checkpoint` of
    its layer body), so the backward recomputes the layer from its input
    instead of keeping its activations. Under `torch.no_grad()` (serving)
    it is a plain call. The recompute runs under the forward's current
    mesh (the backward may run on another thread, which sees none). The
    layers draw no random numbers, so the RNG state is not saved and
    restored around the recompute (reading a CUDA generator's state is
    refused under a CUDA graph capture of the training step)."""
    if cfg.remat and torch.is_grad_enabled():
        mesh = shd.current_mesh()
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              shd.use_mesh(mesh)))
    return fn(*args)


def _check_family(cfg):
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown model family {cfg.family!r}")


def prefill(cfg, params: Transformer, tokens, *, prefix_embeds=None,
            lora=None, cache_slots=None, window=None, positions=None,
            last_only=False, last_pos=None, return_aux=False):
    """Returns (logits, cache). cache_slots=None -> no cache; else the row
    caches {"k"/"v": (L, B, KV, cache_slots, hd), "pos": (L, B,
    cache_slots)[, "k_scale"/"v_scale": (L, B, KV, cache_slots) f32]}
    (int8 payload and scales when cfg.kv_cache_dtype == "int8"): the
    prompt in slots [0, L) and pos -1 past it, or, for a prompt longer
    than the cache, its last cache_slots tokens in ring order
    (`layers.cache_write_prefill`). The hybrid's cache is a list, one
    entry a layer: {"h", "conv"} for an RG-LRU layer, and for a local-
    attention layer {"k"/"v": (B, KV, S, hd), "pos": (B, S)} with S =
    min(cache_slots, window) (its attention is windowed at
    `cfg.hybrid.window`). `prefix_embeds` (B, P, d): the VLM's patch
    embeddings, placed before the tokens. last_pos: optional (B,) per-row
    positions — the residual stream is gathered there *before* the
    unembed, so the (B, L, vocab) logits are never materialized.
    `window`: sliding-window attention (flash on the card).
    `return_aux`: return (logits, cache, aux), aux the sum over layers of
    the MoE load-balance loss (f32, 0 without MoE), as the reference's
    layer scan carries it. With `cfg.remat` and grad mode on, each layer
    of the uniform stack runs under activation checkpointing
    (`remat_layer`)."""
    _check_family(cfg)
    x = embed_tokens(cfg, params, tokens, prefix_embeds)
    B, L = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(L, dtype=torch.int32,
                                 device=x.device).expand(B, L)
    rope_cs = _rope(cfg, positions)
    live = _lora_live(cfg, lora)
    aux = torch.zeros((), dtype=torch.float32, device=x.device) \
        if return_aux else None
    if cfg.hybrid:
        x, cache = _hybrid_prefill(cfg, params, x, positions, rope_cs, lora,
                                   live, cache_slots)
    else:
        cache = None
        if cache_slots is not None:
            cache = cache_init_like(x, B, cfg.n_kv_heads, cache_slots,
                                    cfg.hd, cfg.torch_dtype,
                                    quantized=cfg.kv_cache_dtype == "int8",
                                    layers=cfg.n_layers)

        def layer(x, i, p_l):
            ll, lora_idx, lora_ranks, lora_mode = _lora_slice(lora, i)
            return block_apply(
                cfg, p_l, x, positions, lora_layer=ll, lora_idx=lora_idx,
                lora_ranks=lora_ranks, lora_mode=lora_mode, lora_live=live,
                window=window, decode=False, rope_cs=rope_cs,
                need_aux=return_aux)

        for i, p_l in enumerate(params.blocks):
            x, (k, v), *a = remat_layer(cfg, layer, x, i, p_l)
            if a and a[0] is not None:
                aux = aux + a[0]
            if cache is not None:
                cache_write_prefill(
                    {n: shd.take_layer(t, i) for n, t in cache.items()}, k, v,
                    positions)
    if last_pos is not None:
        x = x[torch.arange(B, device=x.device), last_pos.long()][:, None]
    elif last_only:
        x = x[:, -1:]
    if return_aux:
        return unembed(cfg, params, x), cache, aux
    return unembed(cfg, params, x), cache


def _hybrid_prefill(cfg, params, x, positions, rope_cs, lora, live,
                    cache_slots):
    """The hybrid stack's prefill: returns (x, per-layer caches or None).
    An attention layer's cache holds min(cache_slots, window) slots, as
    the reference's (its `or window` when cache_slots is 0 included)."""
    B, win = x.shape[0], cfg.hybrid.window
    caches = []
    for i, (kind, p_l) in enumerate(zip(hybrid_layer_kinds(cfg),
                                        params.blocks)):
        if kind == "rglru":
            x, c = rglru.rglru_block_apply(cfg, p_l, x)
        else:
            ll, lora_idx, lora_ranks, lora_mode = _lora_slice(lora, i)
            x, (k, v) = block_apply(
                cfg, p_l, x, positions, lora_layer=ll, lora_idx=lora_idx,
                lora_ranks=lora_ranks, lora_mode=lora_mode, lora_live=live,
                window=win, decode=False, rope_cs=rope_cs)
            c = None
            if cache_slots is not None:
                c = cache_init_like(x, B, cfg.n_kv_heads,
                                    min(cache_slots, win) or win, cfg.hd,
                                    cfg.torch_dtype)
                cache_write_prefill(c, k, v, positions)
        caches.append(c)
    return x, (caches if cache_slots is not None else None)


def prefill_chunk(cfg, params: Transformer, tokens_c, start, clen, cache,
                  page_ids, *, lora=None, last=False, window=None):
    """One chunk of an incremental prefill, written into the row's pages
    in place (the reference gathers the row into a dense view and returns
    a new one).

    tokens_c: (1, C) token slice padded to C; `start`: absolute position
    of the chunk's first token; `clen`: real tokens in the chunk; each an
    int or a 0-d int32 tensor on the device (a captured chunk step reads
    them from its static inputs, so one graph serves every start and
    length). cache is the paged pool {"k"/"v": (L, P + 1, KV, ps, hd),
    "pos": (L, P + 1, ps)}; page_ids (W,) int32 the row's claimed pages in
    logical order, covering slots [0, start + clen), -1 past them (the
    server pads them to the block table's width). Token j of the chunk
    lands in slot start + j; pad tokens (j >= clen) write into the sink
    page, so the row's pad slots keep pos -1, as the reference's dropped
    scatter does. Every per-position op (projection + LoRA, RoPE, norms,
    MLP, residuals) is the sequence of `attn_apply` / `block_apply`;
    attention masks by the cached absolute positions
    (`layers.paged_attn_chunk`, plain PyTorch on every device, as the
    reference computes it outside Pallas; it reads all W pages). Returns
    the (1, 1, vocab) logits of the chunk's last real token (gathered at
    a device index) when `last`, else None. `window` masks keys `window`
    or more positions behind each query."""
    _check_family(cfg)
    x = embed_tokens(cfg, params, tokens_c)
    C = x.shape[1]
    offs = torch.arange(C, dtype=torch.int32, device=x.device)
    positions = (offs + start)[None]
    bt = page_ids.to(torch.int32).reshape(1, -1)
    windex = paged_write_index(cache["k"], bt.expand(C, -1), positions[0],
                               write_mask=offs < clen)
    rope_cs = _rope(cfg, positions)
    live = _lora_live(cfg, lora)
    for i, p_l in enumerate(params.blocks):
        ll, lora_idx, lora_ranks, lora_mode = _lora_slice(lora, i)
        cache_l = {name: shd.take_layer(t, i) for name, t in cache.items()}
        x, _ = block_apply(
            cfg, p_l, x, positions, lora_layer=ll, lora_idx=lora_idx,
            lora_ranks=lora_ranks, lora_mode=lora_mode, lora_live=live,
            window=window, decode=False, cache=cache_l, block_table=bt,
            rope_cs=rope_cs, write_index=windex)
    if not last:
        return None
    # the last real token: offs == max(clen - 1, 0), as a device index
    at = torch.clamp(offs.new_zeros(()) + clen - 1, min=0).reshape(1)
    return unembed(cfg, params, x.index_select(1, at.long()))


def decode_step(cfg, params: Transformer, cache, tokens_t, pos, *,
                lora=None, window=None, write_mask=None, block_table=None):
    """tokens_t: (B, 1); pos: (B,) current absolute position. With a
    `block_table` (B, W) the cache is the paged pool {"k"/"v": (L, P + 1,
    KV, ps, hd), "pos": (L, P + 1, ps)}; without one it is the dense
    per-row cache of `prefill` (k/v (L, B, KV, S, hd), pos (L, B, S), and
    the scales when int8; the hybrid's per-layer list), the token written
    at ring slot pos % S. Either is updated in place; write_mask (B,) bool
    drops frozen rows' writes (an RG-LRU layer's state keeps its old
    rows). `window`: sliding-window attention, plain PyTorch on both
    planes (the paged kernel has no window mask, as the reference's has
    none); the hybrid's attention layers always use `cfg.hybrid.window`.
    Returns (logits, cache)."""
    _check_family(cfg)
    x = embed_tokens(cfg, params, tokens_t)
    # per-step values every layer shares
    rope_cs = _rope(cfg, pos[:, None])
    live = _lora_live(cfg, lora)
    if cfg.hybrid:
        if block_table is not None:
            raise ValueError("paged cache unsupported for hybrid")
        for i, (kind, p_l, c_l) in enumerate(
                zip(hybrid_layer_kinds(cfg), params.blocks, cache)):
            if kind == "rglru":
                x, c = rglru.rglru_block_step(cfg, p_l, x, c_l)
                write_state(c_l, c, write_mask)
                continue
            ll, lora_idx, lora_ranks, lora_mode = _lora_slice(lora, i)
            x, _ = block_apply(
                cfg, p_l, x, pos, lora_layer=ll, lora_idx=lora_idx,
                lora_ranks=lora_ranks, lora_mode=lora_mode, lora_live=live,
                window=cfg.hybrid.window, decode=True, cache=c_l,
                write_mask=write_mask, rope_cs=rope_cs,
                write_index=pos.long() % c_l["k"].shape[2])
        return unembed(cfg, params, x), cache
    if block_table is not None:
        windex = paged_write_index(cache["k"], block_table, pos, write_mask)
    else:
        windex = pos.long() % cache["k"].shape[3]
    for i, p_l in enumerate(params.blocks):
        ll, lora_idx, lora_ranks, lora_mode = _lora_slice(lora, i)
        cache_l = {name: shd.take_layer(t, i) for name, t in cache.items()}
        x, _ = block_apply(
            cfg, p_l, x, pos, lora_layer=ll, lora_idx=lora_idx,
            lora_ranks=lora_ranks, lora_mode=lora_mode, lora_live=live,
            window=window, decode=True, cache=cache_l,
            write_mask=write_mask, block_table=block_table,
            rope_cs=rope_cs, write_index=windex)
    return unembed(cfg, params, x), cache


def write_state(old, new, write_mask=None, batch_axis=0):
    """Copy a recurrent layer's new state leaves into `old` in place; rows
    whose write_mask is False keep their old values (recurrent state has
    no slot to drop a write into: the reference selects per row)."""
    for name, t in new.items():
        if write_mask is not None:
            shape = [1] * t.dim()
            shape[batch_axis] = -1
            t = torch.where(write_mask.reshape(shape), t, old[name])
        old[name].copy_(t)
