"""The plain reference of a dense decoder with LoRA on W_q, W_k and W_v:
plain PyTorch, float32 throughout (TF32 off), no kernel, no cache, no
batching. It imports nothing of the program: it reads the weights and
adapters that the benchmark made, and the tokens that the program served,
and recomputes every position's logits from the tokens alone.

The model, as published for Llama-family and Qwen2 models:
  x = embed[tokens]
  per layer: xn = rmsnorm(x) * norm1
             q = xn Wq (+ bq) + (xn A_q[:, :r]) B_q[:r], k and v alike
             q, k rotated (RoPE, the two halves of a head: x1, x2 ->
             x1 cos - x2 sin, x2 cos + x1 sin; frequency theta^(-i/half))
             causal attention; query head h reads KV head h // (H / KV)
             x = x + attn Wo
             hn = rmsnorm(x) * norm2
             x = x + (silu(hn W1) * (hn W3)) W2
  logits = (rmsnorm(x) * final_norm) W_head
LoRA has no scaling factor (the adapters' scales are in A and B).

`quant="fp8"` is the control: every matrix product (the projections, the
LoRA factors, the head) takes its operands rounded to float8 e4m3, the
weight with a scale a column and the activation with a scale a row, the
W8A8 arithmetic that a lower-precision serving path would use.

Work is done layer by layer over all the sequences, so that a layer's
weights are turned into float32 once, and attention in blocks of
queries, so that it fits beside the weights on the card.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

F8_MAX = 448.0          # largest finite float8 e4m3fn


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale a slice along `dim`."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / F8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _mm(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]):
    if quant == "fp8":
        return _fp8(x, -1) @ _fp8(w, 0)
    if quant is not None:
        raise ValueError(f"unknown control precision {quant!r}")
    return x @ w


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, heads, hd) at positions 0..T-1."""
    T, _, hd = x.shape
    half = hd // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] \
        * freq
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, q_block: int) -> torch.Tensor:
    """Causal attention, q (T, H, hd), k / v (T, KV, hd) -> (T, H * hd)."""
    T, H, hd = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1).transpose(0, 1)    # (H, T, hd)
    v = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = torch.empty(T, H, hd, dtype=torch.float32, device=q.device)
    keys = torch.arange(T, device=q.device)
    for s in range(0, T, q_block):
        e = min(T, s + q_block)
        qs = q[s:e].transpose(0, 1)                      # (H, n, hd)
        sc = qs @ k[:, :e].transpose(1, 2) / hd ** 0.5   # (H, n, e)
        mask = keys[None, :e] <= torch.arange(s, e, device=q.device)[:, None]
        sc = sc.masked_fill(~mask, float("-inf"))
        out[s:e] = (torch.softmax(sc, dim=-1) @ v[:, :e]).transpose(0, 1)
    return out.reshape(T, H * hd)


def forward(sizes: Dict, weights, adapters: Sequence[Dict],
            ranks: Sequence[int], tokens: Sequence[torch.Tensor],
            starts: Sequence[int], quant: Optional[str] = None,
            q_block: int = 512, head_block: int = 256) -> List[torch.Tensor]:
    """Logits (float32) of each sequence at positions starts[i] .. T_i - 1.

    sizes: d_model, n_heads, n_kv_heads, hd, eps, rope_theta
    weights: .embed, .layers[i].{norm1, wq, wk, wv, wo, bq, bk, bv, norm2,
             w1, w3, w2}, .final_norm, .lm_head (the benchmark's tensors)
    adapters[i]: {target: {a: (L, d_in, r_pad), b: (L, r_pad, d_out)}}
    ranks[i]: the adapter's rank; tokens[i]: (T_i,) int64 on the device"""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _forward(sizes, weights, adapters, ranks, tokens, starts,
                        quant, q_block, head_block)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev


@torch.no_grad()
def _forward(sizes, weights, adapters, ranks, tokens, starts, quant,
             q_block, head_block):
    d, H, KV, hd = (sizes[k] for k in ("d_model", "n_heads", "n_kv_heads",
                                       "hd"))
    eps, theta = sizes["eps"], sizes["rope_theta"]
    dev = weights.embed.device
    f32 = torch.float32
    xs = [weights.embed[t].to(f32) for t in tokens]
    for li, lw in enumerate(weights.layers):
        W = {n: getattr(lw, n).to(f32) for n in
             ("norm1", "wq", "wk", "wv", "wo", "norm2", "w1", "w3", "w2")}
        B = {n: (getattr(lw, n).to(f32) if getattr(lw, n) is not None
                 else None) for n in ("bq", "bk", "bv")}
        for i, x in enumerate(xs):
            T = x.shape[0]
            xn = _rms(x, W["norm1"], eps)
            heads = {"q": H, "k": KV, "v": KV}
            proj = {}
            for tgt, wname, bname in (("q", "wq", "bq"), ("k", "wk", "bk"),
                                      ("v", "wv", "bv")):
                y = _mm(xn, W[wname].reshape(d, -1), quant)
                if B[bname] is not None:
                    y = y + B[bname].reshape(-1)
                ad = adapters[i].get(tgt)
                if ad is not None and ranks[i] > 0:
                    r = ranks[i]
                    a = ad["a"][li, :, :r].to(dev, f32)
                    b = ad["b"][li, :r, :].to(dev, f32)
                    y = y + _mm(_mm(xn, a, quant), b, quant)
                proj[tgt] = y.reshape(T, heads[tgt], hd)
            q = _rope(proj["q"], theta)
            k = _rope(proj["k"], theta)
            att = _attention(q, k, proj["v"], q_block)
            x = x + _mm(att, W["wo"].reshape(H * hd, d), quant)
            hn = _rms(x, W["norm2"], eps)
            g = _mm(hn, W["w1"], quant)
            u = _mm(hn, W["w3"], quant)
            x = x + _mm(torch.nn.functional.silu(g) * u, W["w2"], quant)
            xs[i] = x
        del W, B
    fn = weights.final_norm.to(f32)
    out = []
    for x, s in zip(xs, starts):
        xn = _rms(x[s:], fn, eps)
        cols = []
        for c in range(0, weights.lm_head.shape[1], head_block * 128):
            cols.append(_mm(xn, weights.lm_head[:, c:c + head_block * 128]
                            .to(f32), quant))
        out.append(torch.cat(cols, dim=1))
    return out
