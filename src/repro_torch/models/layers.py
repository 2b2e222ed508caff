"""Shared neural building blocks of the dense family: RoPE, GQA attention
(direct / chunked online-softmax / decode over a cache), the paged KV
cache, and the MLP. Mirrors `repro.models.layers` (dense and paged
subset).

Conventions:
  activations x: (B, L, D)
  q: (B, L, H, hd); k/v: (B, L, KV, hd)
  paged KV cache, one layer: k/v (P + 1, KV, page_size, hd) and pos
  (P + 1, page_size) absolute positions (-1 = empty). Page P is a write
  sink that no block table names: a write the reference drops by indexing
  out of bounds lands there instead, so no row's pages are touched and no
  host sync is needed to filter the rows.
  RoPE is applied at write time, so cached k never needs re-rotation.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.param import dense_apply

NEG_INF = -1e30


# ---------------------------------------------------------------- RoPE ----

def rope_tables(positions, hd, theta=10000.0):
    """cos/sin of RoPE at `positions` (B, L): each (B, L, 1, hd/2), f32.
    The model computes them once per forward and shares them across
    layers (the reference recomputes them inside each layer's jit)."""
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=positions.device) / half)
    ang = positions[..., None].float() * freq                 # (B, L, half)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_rope(x, cos, sin):
    """x: (B, L, H, hd) rotated by tables from `rope_tables`."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x, positions, theta=10000.0):
    """x: (B, L, H, hd), positions: (B, L) int."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


# ----------------------------------------------------------- attention ----

def _gqa_scores(q, k):
    """q: (B,Lq,H,hd), k: (B,Lk,KV,hd) -> (B,KV,G,Lq,Lk) with G=H//KV."""
    b, lq, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, lq, kv, h // kv, hd)
    return torch.einsum("bqkgh,bskh->bkgqs", qg, k) / (hd ** 0.5)


def _gqa_out(probs, v):
    """probs: (B,KV,G,Lq,Lk), v: (B,Lk,KV,hd) -> (B,Lq,H,hd)."""
    b, kv, g, lq, _ = probs.shape
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(b, lq, kv * g, v.shape[-1])


def attn_direct(q, k, v, mask):
    """Materialized-logits attention. mask: broadcastable to
    (B,KV,G,Lq,Lk)."""
    s = _gqa_scores(q, k).float()
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _gqa_out(p.to(v.dtype), v)


def causal_mask(lq, lk, q_offset=0, window=None, device=None):
    """(1,1,1,Lq,Lk) bool mask; query i attends key j iff j <= i+q_offset
    and (window is None or i+q_offset - j < window)."""
    qpos = torch.arange(lq, device=device)[:, None] + q_offset
    kpos = torch.arange(lk, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m &= (qpos - kpos) < window
    return m[None, None, None]


def attn_chunked(q, k, v, *, causal=True, window=None, block=512):
    """Online-softmax attention over KV blocks: never materializes the
    (Lq, Lk) logits."""
    b, lq, h, hd = q.shape
    lk, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, lq, kv, g, hd)
    qpos = torch.arange(lq, device=q.device)
    m = torch.full((b, kv, g, lq), NEG_INF, device=q.device)
    l = torch.zeros((b, kv, g, lq), device=q.device)
    acc = torch.zeros((b, kv, g, lq, hd), device=q.device)
    for start in range(0, lk, block):
        kblk, vblk = k[:, start:start + block], v[:, start:start + block]
        s = (torch.einsum("bqkgh,bskh->bkgqs", qg, kblk)
             / (hd ** 0.5)).float()
        kpos = start + torch.arange(kblk.shape[1], device=q.device)
        valid = torch.ones(lq, kblk.shape[1], dtype=torch.bool,
                           device=q.device)
        if causal:
            valid &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            valid &= (qpos[:, None] - kpos[None, :]) < window
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskh->bkgqh", p.to(vblk.dtype), vblk).float()
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, lq, h, hd)
    return out.to(q.dtype)


def attn_prefill(q, k, v, *, causal=True, window=None, block=512,
                 direct_threshold=2048):
    """Direct attention up to `direct_threshold` keys, chunked beyond."""
    if k.shape[1] <= direct_threshold:
        if causal:
            mask = causal_mask(q.shape[1], k.shape[1], window=window,
                               device=q.device)
        else:
            mask = torch.ones((1, 1, 1, q.shape[1], k.shape[1]),
                              dtype=torch.bool, device=q.device)
        return attn_direct(q, k, v, mask)
    return attn_chunked(q, k, v, causal=causal, window=window, block=block)


def attn_decode(q, cache_k, cache_v, cache_pos, pos, window=None):
    """One-token attention over a dense cache. q: (B,1,H,hd); cache_k/v:
    (B,KV,S,hd); cache_pos: (B,S) abs positions (-1 empty); pos: (B,)."""
    b, _, h, hd = q.shape
    kv = cache_k.shape[1]
    qg = q.reshape(b, kv, h // kv, hd)
    s = (torch.einsum("bkgh,bksh->bkgs", qg, cache_k) / (hd ** 0.5)).float()
    valid = (cache_pos >= 0) & (cache_pos <= pos[:, None])           # (B,S)
    if window is not None:
        valid &= (pos[:, None] - cache_pos) < window
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(cache_v.dtype)
    out = torch.einsum("bkgs,bksh->bkgh", p, cache_v)
    return out.reshape(b, 1, h, hd)


# ------------------------------------------------------- paged KV cache ----

def paged_write_index(k_pool, block_table, pos, write_mask=None):
    """Where each row's token lands: (physical page, offset) of ring slot
    pos % (W * page_size) through the block table. Rows masked out by
    `write_mask`, and rows whose logical page is unclaimed, get the sink
    page. `k_pool` is one layer's or the stacked k pool (page axis -4).
    The decode step computes this once and shares it across layers."""
    sink, ps = k_pool.shape[-4] - 1, k_pool.shape[-2]
    w = block_table.shape[1]
    slot = pos.long() % (w * ps)
    page, off = slot // ps, slot % ps
    phys = block_table.gather(1, page[:, None])[:, 0].long()
    ok = phys >= 0
    if write_mask is not None:
        ok = ok & write_mask
    return torch.where(ok, phys, sink), off


def cache_write_token_paged(cache, k_t, v_t, pos, block_table,
                            write_mask=None, index=None):
    """Write one token at ring slot pos % (W * page_size) through the block
    table, in place (the pool is the largest tensor the server holds; the
    reference returns a new pool). k_t/v_t: (B, 1, KV, hd); pos: (B,).
    Rows masked out by `write_mask`, and rows whose logical page is
    unclaimed, write into the sink page instead: every real page stays
    bitwise untouched for them. `index`: a precomputed
    `paged_write_index`. Returns `cache`."""
    phys, off = index if index is not None else paged_write_index(
        cache["k"], block_table, pos, write_mask)
    cache["k"][phys, :, off] = k_t[:, 0]
    cache["v"][phys, :, off] = v_t[:, 0]
    cache["pos"][phys, off] = pos.to(cache["pos"].dtype)
    return cache


def paged_kv_for_attn(cache, block_table):
    """Gather a layer's paged cache into dense (B, KV, S, hd) k/v views and
    their (B, S) positions, S = W * page_size in block-table order. Slots
    behind unclaimed logical pages get pos -1, so attention masks them."""
    bt = block_table.long()
    safe = bt.clamp(min=0)
    k = cache["k"][safe]                         # (B, W, KV, ps, hd)
    v = cache["v"][safe]
    b, w, kvh, ps, hd = k.shape
    k = k.transpose(1, 2).reshape(b, kvh, w * ps, hd)
    v = v.transpose(1, 2).reshape(b, kvh, w * ps, hd)
    kpos = torch.where(bt[:, :, None] >= 0, cache["pos"][safe], -1)
    return k, v, kpos.reshape(b, w * ps)


def paged_attn_decode(q, cache, block_table, pos):
    """One-token decode attention straight off the paged cache. q:
    (B, 1, H, hd); block_table (B, W); pos (B,). The device decides: on
    CUDA the paged-attention kernel runs (it reads only the row's claimed
    pages); on the CPU the pages are gathered and attended densely."""
    if q.is_cuda:
        out = ops.paged_attention(q[:, 0], cache["k"], cache["v"],
                                  cache["pos"], block_table, pos)
        return out[:, None]
    ck, cv, cpos = paged_kv_for_attn(cache, block_table)
    return attn_decode(q, ck, cv, cpos, pos)


# ------------------------------------------------------------------ MLP ----

def mlp_apply(cfg, p, x):
    """SwiGLU (`mlp_act="silu"`, the family's checked activation)."""
    h = F.silu(dense_apply(p.w1, x)) * dense_apply(p.w3, x)
    return dense_apply(p.w2, h)
