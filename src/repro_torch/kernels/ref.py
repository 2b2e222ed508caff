"""Plain PyTorch versions of every kernel in this package.

They are what a CPU tensor runs, and what the CUDA kernels are held
against on the card (chip_smoke.py). Each computes the kernel's function
— f32 accumulation, one cast at the end — in the most direct way, and is
itself held against the reference's `repro.kernels.ref` and Pallas
kernels by tests/test_torch_kernels.py.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def accum_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulation type: float32, or float64 for float64 inputs (the
    gradient checks)."""
    return torch.promote_types(dtype, torch.float32)


# --------------------------------------------------------------- LoRA ----

def bgmv_live(idx: torch.Tensor, r_max: int) -> torch.Tensor:
    """Live rank columns per row under BGMV: pad-to-max, all r_max columns
    of every adapted row (the max-rank cost law)."""
    return torch.where(idx >= 0, r_max, 0).to(torch.int32)


def mbgmv_live(idx: torch.Tensor, ranks: torch.Tensor,
               rank_block: int) -> torch.Tensor:
    """Live rank columns per row under MBGMV: the adapter's rank rounded up
    to whole rank blocks (the sum-rank cost law)."""
    safe = idx.clamp(min=0).long()
    nblk = (ranks[safe] + rank_block - 1) // rank_block * rank_block
    return torch.where(idx >= 0, nblk, 0).to(torch.int32)


def live_mask(live: torch.Tensor, r: int) -> torch.Tensor:
    return torch.arange(r, device=live.device)[None] < live[:, None]


def lora_shrink_ref(x, a, idx, live):
    """y[b, :live[b]] = x[b] @ A[idx[b]][:, :live[b]], f32 (f64 for f64
    inputs); other columns and rows with idx < 0 are zero. x (rows, d_in);
    a (S, d_in, r)."""
    rows, r = x.shape[0], a.shape[-1]
    acc = accum_dtype(x.dtype)
    y = torch.zeros(rows, r, dtype=acc, device=x.device)
    for s in range(a.shape[0]):
        m = idx == s
        if bool(m.any()):
            y[m] = x[m].to(acc) @ a[s].to(acc)
    return torch.where(live_mask(live, r), y, 0.0)


def lora_expand_ref(y, b, idx, live):
    """out[b] = y[b, :live[b]] @ B[idx[b]][:live[b]], f32 accumulation, one
    cast to B's dtype; rows with idx < 0 are zero. y (rows, r);
    b (S, r, d_out)."""
    rows, r = y.shape
    acc = accum_dtype(b.dtype)
    yk = torch.where(live_mask(live, r), y.to(acc), 0.0)
    out = torch.zeros(rows, b.shape[-1], dtype=acc, device=y.device)
    for s in range(b.shape[0]):
        m = idx == s
        if bool(m.any()):
            out[m] = yk[m] @ b[s].to(acc)
    return out.to(b.dtype)


def bgmv_shrink_ref(x, a_pool, idx):
    return lora_shrink_ref(x, a_pool, idx, bgmv_live(idx, a_pool.shape[-1]))


def bgmv_expand_ref(y, b_pool, idx):
    return lora_expand_ref(y.to(b_pool.dtype), b_pool, idx,
                           bgmv_live(idx, b_pool.shape[1]))


def bgmv_ref(x, a_pool, b_pool, idx):
    """Full BGMV delta: the f32 shrink is cast to x's dtype before the
    expand, as the reference's `bgmv` does."""
    return bgmv_expand_ref(bgmv_shrink_ref(x, a_pool, idx).to(x.dtype),
                           b_pool, idx)


def mbgmv_shrink_ref(x, a_pool, idx, ranks, rank_block=16):
    return lora_shrink_ref(x, a_pool, idx,
                           mbgmv_live(idx, ranks, rank_block))


def mbgmv_expand_ref(y, b_pool, idx, ranks, rank_block=16):
    return lora_expand_ref(y.to(b_pool.dtype), b_pool, idx,
                           mbgmv_live(idx, ranks, rank_block))


def mbgmv_ref(x, a_pool, b_pool, idx, ranks, rank_block=16):
    y = mbgmv_shrink_ref(x, a_pool, idx, ranks, rank_block).to(x.dtype)
    return mbgmv_expand_ref(y, b_pool, idx, ranks, rank_block)


# ----------------------------------------------------- paged attention ----

def paged_attention_ref(q, k_pages, v_pages, pos_pages, block_table, pos):
    """One-token decode attention over each row's block table.

    q (B, H, hd); k/v_pages (P, KV, ps, hd); pos_pages (P, ps) absolute
    positions (-1 empty); block_table (B, W) int32, -1 unclaimed; pos (B,).
    A slot counts iff its page is claimed and 0 <= kpos <= pos[b]. Scores,
    softmax and the weighted sum run in f32 with the mask applied to p; a
    row with no valid slot returns zeros. Returns (B, H, hd) in q's dtype."""
    b, h, hd = q.shape
    kv = k_pages.shape[1]
    bt = block_table.long()
    safe = bt.clamp(min=0)
    k = k_pages[safe].transpose(1, 2).reshape(b, kv, -1, hd).float()
    v = v_pages[safe].transpose(1, 2).reshape(b, kv, -1, hd).float()
    kpos = torch.where(bt[:, :, None] >= 0, pos_pages[safe],
                       -1).reshape(b, -1)
    valid = (kpos >= 0) & (kpos <= pos[:, None])                 # (B, S)
    # what sits behind a masked slot (another row's page, NaN) is never
    # part of the result, as the kernel never reads it
    k = torch.where(valid[:, None, :, None], k, 0.0)
    v = torch.where(valid[:, None, :, None], v, 0.0)
    qg = q.reshape(b, kv, h // kv, hd).float()
    s = torch.einsum("bkgh,bksh->bkgs", qg, k) * hd ** -0.5
    s = torch.where(valid[:, None, None], s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid[:, None, None], torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bkgs,bksh->bkgh", p, v) / l
    return out.reshape(b, h, hd).to(q.dtype)


# ------------------------------------------------------ flash attention ----

def flash_attention_ref(q, k, v, *, causal=True, window=None, block=512):
    """Prefill attention, the function of the flash kernel.

    q (B, H, Lq, hd); k/v (B, KV, Lk, hd) -> (B, H, Lq, hd) in q's dtype.
    Query i sits at position i, as key i (the TPU kernel's alignment,
    repro/kernels/flash.py, not its JAX oracle's decode-style
    qpos = i + Lk - Lq). A key counts iff kpos <= qpos when causal and
    qpos - kpos < window when a window is given; GQA maps head h to KV head
    h // (H / KV). Scores, softmax and PV run in f32 (f64 for f64 inputs)
    with the mask applied to p, so a query with no valid key returns
    zeros. Queries are taken `block` at a time, which bounds the f32 score
    tensor and changes nothing else."""
    b, h, lq, hd = q.shape
    kv, lk = k.shape[1], k.shape[2]
    acc = accum_dtype(q.dtype)
    kt = k.to(acc).transpose(-1, -2)[:, :, None]        # (B, KV, 1, hd, Lk)
    vf = v.to(acc)[:, :, None]                          # (B, KV, 1, Lk, hd)
    kpos = torch.arange(lk, device=q.device)[None]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for s0 in range(0, lq, block):
        qg = q[:, :, s0:s0 + block].to(acc)
        n = qg.shape[2]
        s = (qg.reshape(b, kv, h // kv, n, hd) @ kt) * hd ** -0.5
        qpos = torch.arange(s0, s0 + n, device=q.device)[:, None]
        valid = torch.ones(n, lk, dtype=torch.bool, device=q.device)
        if causal:
            valid &= kpos <= qpos
        if window is not None:
            valid &= qpos - kpos < window
        s = torch.where(valid, s, NEG_INF)
        p = torch.where(valid, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
        o = (p @ vf) / p.sum(-1, keepdim=True).clamp(min=1e-30)
        out[:, :, s0:s0 + n] = o.reshape(b, h, n, hd).to(q.dtype)
    return out
