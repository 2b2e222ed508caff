"""Shared neural building blocks: RoPE, GQA attention (direct / chunked
online-softmax / decode over a cache, full or sliding-window), the dense
and paged KV caches, and the MLPs (gated, or the plain 2-matrix gelu
MLP). Mirrors `repro.models.layers` (dense, int8-quantized and paged
caches; the recurrent blocks are in `ssm.py` and `rglru.py`).

Conventions:
  activations x: (B, L, D)
  q: (B, L, H, hd); k/v: (B, L, KV, hd)
  dense KV cache, one layer: k/v (B, KV, S, hd) and pos (B, S), a ring
  (slot of position p: p % S); int8 adds k_scale/v_scale (B, KV, S).
  paged KV cache, one layer: k/v (P + 1, KV, page_size, hd) and pos
  (P + 1, page_size) absolute positions (-1 = empty). Page P is a write
  sink that no block table names: a write the reference drops by indexing
  out of bounds lands there instead, so no row's pages are touched and no
  host sync is needed to filter the rows.
  RoPE is applied at write time, so cached k never needs re-rotation.

Given DTensors (the dry run), attention and the cache writes run as
regions on each rank's shards (`sharding.local_call`): the batch over the
data axes; query and key heads over "model" when both counts divide it,
else the cache's slots, with the softmax combined across those ranks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import sharding as shd
from repro_torch.kernels import ops
from repro_torch.models.param import dense_apply

NEG_INF = -1e30


# ----------------------------------------------------------- embedding ----

def embed_lookup(table, ids, table_axes=("vocab", "embed")):
    """table[ids]: the rows of an embedding table. Given DTensors, each
    rank looks its rows up in its slice of a table cut over its first dim
    (`table_axes`) and the slices' rows are summed across the cut."""
    if not shd.is_dtensor(table):
        return table[ids.long()]
    mesh = shd.current_mesh()

    def local(placed, table, ids):
        cut = placed.get(table_axes[0])
        if not cut:
            return table[ids.long()]
        n = table.shape[0]
        rel = ids.long() - n * shd.coordinate(mesh, cut)
        hit = (rel >= 0) & (rel < n)
        rows = table[rel.clamp(0, n - 1)] * hit[..., None].to(table.dtype)
        return shd.sum_over(rows, shd.group_of(mesh, cut))

    ids_axes = ("batch",) + (None,) * (ids.dim() - 1)
    return shd.local_call(local, (table, ids), (table_axes, ids_axes),
                          ids_axes + (table_axes[1],))


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
    """Prefill attention; q (B, L, H, hd), k/v (B, L, KV, hd). The device
    decides: on CUDA the flash kernel runs, reading the (B, H, L, hd)
    transposes of q/k/v through their strides (no copy) and writing an
    output whose transpose is contiguous (B, L, H, hd); on the CPU, direct
    attention up to `direct_threshold` keys and chunked beyond, as in the
    reference's `attn_prefill`."""
    if shd.is_dtensor(q):
        return _attn_prefill_dist(q, k, v, causal, window)
    if q.is_cuda:
        out = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window)
        return out.transpose(1, 2)
    if k.shape[1] <= direct_threshold:
        if causal:
            mask = causal_mask(q.shape[1], k.shape[1], window=window,
                               device=q.device)
        else:
            mask = torch.ones((1, 1, 1, q.shape[1], k.shape[1]),
                              dtype=torch.bool, device=q.device)
        return attn_direct(q, k, v, mask)
    return attn_chunked(q, k, v, causal=causal, window=window, block=block)


def _attn_prefill_dist(q, k, v, causal, window):
    """The flash kernel's custom op on each rank's batch rows and heads."""
    def local(placed, q, k, v):
        return ops.attention_op(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal,
                                window).transpose(1, 2)

    ax = ("batch", None, "kv_heads", None)
    return shd.local_call(local, (q, k, v), (ax, ax, ax), ax)


def attn_decode(q, cache_k, cache_v, cache_pos, pos, window=None):
    """One-token attention over a dense cache. q: (B,1,H,hd); cache_k/v:
    (B,KV,S,hd); cache_pos: (B,S) abs positions (-1 empty); pos: (B,)."""
    if shd.is_dtensor(q):
        return _attn_decode_dist(q, cache_k, cache_v, cache_pos, pos, window)
    return _attn_decode(q, cache_k, cache_v, cache_pos, pos, window)


# the logical axes of one layer's dense KV cache (`model.cache_logical_axes`
# puts a stack's "layers" axis before them)
CACHE_AXES = {"k": ("batch", "kv_heads", "cache_seq", None),
              "v": ("batch", "kv_heads", "cache_seq", None),
              "pos": ("batch", "cache_seq"),
              "k_scale": ("batch", "kv_heads", "cache_seq"),
              "v_scale": ("batch", "kv_heads", "cache_seq")}
TOKEN_KV = ("batch", None, "kv_heads", None)


def _attn_decode_dist(q, ck, cv, cpos, pos, window):
    """`attn_decode` on each rank's rows: over its heads, or, when the
    cache's slots are cut over some mesh axes, over its slots, the softmax
    combined across them (its max, its sum and the weighted values)."""
    mesh = shd.current_mesh()

    def local(placed, q, ck, cv, cpos, pos):
        seq = placed.get("cache_seq")
        if not seq:
            return _attn_decode(q, ck, cv, cpos, pos, window)
        group = shd.group_of(mesh, seq)
        s, valid = _decode_scores(q, ck, cpos, pos, window)
        m = shd.max_over(s.amax(-1, keepdim=True), group)
        p = torch.where(valid[:, None, None], torch.exp(s - m), 0.0)
        den = shd.sum_over(p.sum(-1, keepdim=True), group)
        out = shd.sum_over(torch.einsum("bkgs,bksh->bkgh",
                                        p.to(cv.dtype), cv).float(), group)
        b, _, h, hd = q.shape
        return (out / den.clamp(min=1e-30)).to(cv.dtype).reshape(b, 1, h,
                                                                  hd)

    return shd.local_call(local, (q, ck, cv, cpos, pos),
                          (TOKEN_KV, CACHE_AXES["k"], CACHE_AXES["v"],
                           CACHE_AXES["pos"], ("batch",)), TOKEN_KV)


def _decode_scores(q, cache_k, cache_pos, pos, window):
    """(B, KV, G, S) f32 scores and the (B, S) valid slots."""
    b, _, h, hd = q.shape
    kv = cache_k.shape[1]
    qg = q.reshape(b, kv, h // kv, hd)
    s = (torch.einsum("bkgh,bksh->bkgs", qg, cache_k) / (hd ** 0.5)).float()
    valid = (cache_pos >= 0) & (cache_pos <= pos[:, None])           # (B,S)
    if window is not None:
        valid &= (pos[:, None] - cache_pos) < window
    return s, valid


def _attn_decode(q, cache_k, cache_v, cache_pos, pos, window=None):
    b, _, h, hd = q.shape
    s, valid = _decode_scores(q, cache_k, cache_pos, pos, window)
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(cache_v.dtype)
    out = torch.einsum("bkgs,bksh->bkgh", p, cache_v)
    return out.reshape(b, 1, h, hd)


# ------------------------------------------------------- dense KV cache ----
#
# int8 quantization is symmetric, one f32 scale per (head, position).
# Writes go in place; the reference returns new arrays.

def cache_init(batch, kv_heads, slots, hd, dtype, quantized=False, *,
               layers=None, device=None):
    """An empty cache (k/v zeros, pos -1); `layers` adds a leading layer
    axis, the layout the model's decode takes."""
    lead = () if layers is None else (layers,)
    kv = lead + (batch, kv_heads, slots, hd)
    pay = torch.int8 if quantized else dtype
    c = {"k": torch.zeros(kv, dtype=pay, device=device),
         "v": torch.zeros(kv, dtype=pay, device=device),
         "pos": torch.full(lead + (batch, slots), -1, dtype=torch.int32,
                           device=device)}
    if quantized:
        c["k_scale"] = torch.zeros(kv[:-1], dtype=torch.float32,
                                   device=device)
        c["v_scale"] = torch.zeros(kv[:-1], dtype=torch.float32,
                                   device=device)
    return c


def _quantize(x):
    """x: (..., hd) -> (int8, scale (...,) f32); rounds half to even, as
    jnp.round does."""
    xf = x.float()
    scale = xf.abs().amax(-1) / 127.0
    q = torch.round(xf / scale.clamp(min=1e-9)[..., None]).to(torch.int8)
    return q, scale


def _dequantize(q, scale, dtype):
    return (q.float() * scale[..., None]).to(dtype)


def cache_write_prefill(cache, k, v, positions):
    """Write a prefill's k/v (B, L, KV, hd) and positions (B, L) into one
    layer's cache, in place. L <= S: slots [0, L), the rest untouched.
    L > S: the last S tokens, rolled by L % S so that slot(p) = p % S and
    later decode writes evict the oldest token."""
    if shd.is_dtensor(k):
        return _cache_write_prefill_dist(cache, k, v, positions)
    slots = cache["k"].shape[2]
    L = k.shape[1]
    kT, vT = k.transpose(1, 2), v.transpose(1, 2)          # (B, KV, L, hd)
    leaves = {"k": kT, "v": vT, "pos": positions.to(torch.int32)}
    if cache["k"].dtype == torch.int8:
        leaves["k"], leaves["k_scale"] = _quantize(kT)
        leaves["v"], leaves["v_scale"] = _quantize(vT)
    for name, x in leaves.items():
        ax = 1 if name == "pos" else 2                     # the slot axis
        if L <= slots:
            cache[name].narrow(ax, 0, L).copy_(x)
        else:
            x = x.narrow(ax, L - slots, slots)
            cache[name].copy_(torch.roll(x, L % slots, dims=ax))
    return cache


def _cache_axes(cache):
    return {n: CACHE_AXES[n] for n in cache}


def _cache_write_prefill_dist(cache, k, v, positions):
    """Each rank writes its rows and heads; a prompt as long as the cache
    also its slots when they are cut, any other prompt its rows with their
    slots whole. A leaf cut otherwise than the region cuts it (`pos` has
    no heads to cut, so its slots may be) takes the written values back
    (`sharding.write_back`)."""
    def local(placed, cache, k, v, positions):
        return cache_write_prefill(cache, k, v, positions)

    axes = _cache_axes(cache)
    if k.shape[1] == cache["k"].shape[2]:
        kv = ("batch", "cache_seq", "kv_heads", None)
        in_axes = (axes, kv, kv, ("batch", "cache_seq"))
    else:
        axes = {n: tuple(None if a == "cache_seq" else a for a in ax)
                for n, ax in axes.items()}
        in_axes = (axes, TOKEN_KV, TOKEN_KV, ("batch", None))
    shd.write_back(cache, shd.local_call(local, (cache, k, v, positions),
                                         in_axes, axes))
    return cache


def cache_init_like(x, batch, kv_heads, slots, hd, dtype, quantized=False,
                    *, layers=None):
    """`cache_init` on x's device; for a DTensor x, laid out by the cache's
    logical axes on its mesh (each rank allocating its shard)."""
    if not shd.is_dtensor(x):
        return cache_init(batch, kv_heads, slots, hd, dtype, quantized,
                          layers=layers, device=x.device)
    meta = cache_init(batch, kv_heads, slots, hd, dtype, quantized,
                      layers=layers, device="meta")
    lead = () if layers is None else ("layers",)
    c = shd.distribute_empty(meta, {n: lead + CACHE_AXES[n] for n in meta},
                             x.device_mesh)
    for n, t in c.items():
        t.fill_(-1 if n == "pos" else 0)
    return c


def _cache_write_token_dist(cache, k_t, v_t, pos, write_mask, slot):
    """Each rank writes its rows and heads; when the cache's slots are
    cut, only the rank holding a row's slot writes it."""
    mesh = shd.current_mesh()
    slot = pos.long() % cache["k"].shape[2] if slot is None else slot
    mask = torch.ones_like(pos, dtype=torch.bool) if write_mask is None \
        else write_mask

    def local(placed, cache, k_t, v_t, pos, mask, slot):
        seq = placed.get("cache_seq")
        if seq:
            n = cache["k"].shape[2]
            mask = mask & (slot // n == shd.coordinate(mesh, seq))
            slot = slot % n
        return cache_write_token(cache, k_t, v_t, pos, write_mask=mask,
                                 slot=slot)

    b, axes = ("batch",), _cache_axes(cache)
    shd.write_back(cache, shd.local_call(
        local, (cache, k_t, v_t, pos, mask, slot),
        (axes, TOKEN_KV, TOKEN_KV, b, b, b), axes))
    return cache


def cache_write_token(cache, k_t, v_t, pos, write_mask=None, slot=None):
    """Write one token at ring slot pos % S, in place. k_t/v_t:
    (B, 1, KV, hd); pos: (B,). Rows with write_mask False get their slot's
    old contents written back, so every leaf stays bitwise untouched for
    them (the reference drops their write by indexing out of bounds).
    `slot`: a precomputed pos % S, shared by the step's layers."""
    if shd.is_dtensor(k_t):
        return _cache_write_token_dist(cache, k_t, v_t, pos, write_mask,
                                       slot)
    if slot is None:
        slot = pos.long() % cache["k"].shape[2]
    rows = torch.arange(k_t.shape[0], device=k_t.device)
    leaves = {"k": k_t[:, 0], "v": v_t[:, 0], "pos": pos}
    if cache["k"].dtype == torch.int8:
        leaves["k"], leaves["k_scale"] = _quantize(k_t[:, 0])
        leaves["v"], leaves["v_scale"] = _quantize(v_t[:, 0])
    for name, new in leaves.items():
        dst = cache[name]
        idx = (rows, slot) if name == "pos" else (rows, slice(None), slot)
        new = new.to(dst.dtype)
        if write_mask is not None:
            keep = write_mask.reshape((-1,) + (1,) * (new.dim() - 1))
            new = torch.where(keep, new, dst[idx])
        dst[idx] = new
    return cache


def cache_kv_for_attn(cache, dtype):
    """k/v for attention: the int8 payload dequantized to `dtype`."""
    if cache["k"].dtype == torch.int8:
        return (_dequantize(cache["k"], cache["k_scale"], dtype),
                _dequantize(cache["v"], cache["v_scale"], dtype))
    return cache["k"], cache["v"]


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


def paged_attn_decode(q, cache, block_table, pos, window=None):
    """One-token decode attention straight off the paged cache. q:
    (B, 1, H, hd); block_table (B, W); pos (B,). The device decides: on
    CUDA the paged-attention kernel runs (it reads only the row's claimed
    pages); on the CPU the pages are gathered and attended densely.
    Windowed attention takes the gather path on every device, as in the
    reference (its kernel has no sliding-window mask)."""
    if q.is_cuda and window is None:
        out = ops.paged_attention(q[:, 0], cache["k"], cache["v"],
                                  cache["pos"], block_table, pos)
        return out[:, None]
    ck, cv, cpos = paged_kv_for_attn(cache, block_table)
    return attn_decode(q, ck, cv, cpos, pos, window=window)


def paged_attn_chunk(q, cache, block_table, positions, window=None):
    """A prefill chunk's attention over its row's pages, the chunk's own K/V
    already written. q (1, C, H, hd); block_table (1, W) the row's pages;
    positions (1, C) absolute. Each query attends the cached slots whose
    position is >= 0 and <= its own (and, with a `window`, less than
    `window` behind it), as the reference's `prefill_chunk` does with
    `attn_direct`. Plain PyTorch on every device: the reference computes
    this outside any Pallas kernel."""
    ck, cv, cpos = paged_kv_for_attn(cache, block_table)
    kp = cpos[:, None, :]
    qp = positions[..., None]
    valid = (kp >= 0) & (kp <= qp)
    if window is not None:
        valid &= (qp - kp) < window
    return attn_direct(q, ck.transpose(1, 2), cv.transpose(1, 2),
                       valid[:, None, None])


# ------------------------------------------------------------------ MLP ----

def gelu(x):
    """The tanh approximation: `jax.nn.gelu`'s default, not torch's."""
    return F.gelu(x, approximate="tanh")


def gate_act(cfg, a, b3):
    """The gated MLP's activation: SwiGLU (`mlp_act="silu"`) or GeGLU
    (`"geglu"`, grok's experts)."""
    if cfg.mlp_act == "silu":
        return F.silu(a) * b3
    if cfg.mlp_act == "geglu":
        return gelu(a) * b3
    raise ValueError(f"mlp_act {cfg.mlp_act!r} is not gated")


def mlp_apply(cfg, p, x):
    """Gated (silu / geglu: w1, w3, w2) or, for any other `mlp_act`, the
    plain 2-matrix gelu MLP (w1, w2), as the reference's `mlp_apply`."""
    if cfg.mlp_act in ("silu", "geglu"):
        h = gate_act(cfg, dense_apply(p.w1, x), dense_apply(p.w3, x))
    else:
        h = gelu(dense_apply(p.w1, x))
    return dense_apply(p.w2, h)
