"""RecurrentGemma / Griffin recurrent block: conv1d + RG-LRU with a GeLU
gate branch (arXiv:2402.19427). Mirrors `repro.models.rglru`. The block
carries no LoRA: adapters attach to q/k/v of the hybrid's local-attention
layers.

The reference's prefill runs the recurrence h_t = a_t h_{t-1} + b_t with
`jax.lax.associative_scan`; the port runs the same linear recurrence as a
doubling (Hillis-Steele) scan: log2(L) steps of element-wise work, in
f32 as the reference's gates are, so the sums group differently and
agree to rounding.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import gelu
from repro_torch.models.param import Dense, Norm, _param, dense_apply, \
    norm_apply

_C = 8.0  # RG-LRU decay sharpness constant (Griffin paper)


class RGLRUBlock(nn.Module):
    """norm; w_x, w_gate (d, w); conv_w (4, w), conv_b (w,); w_a, w_i
    (w, w) with biases; lam (w,) f32; w_out (w, d)."""

    def __init__(self, norm: Norm, w_x: Dense, w_gate: Dense,
                 conv_w: torch.Tensor, conv_b: torch.Tensor, w_a: Dense,
                 w_i: Dense, lam: torch.Tensor, w_out: Dense):
        super().__init__()
        self.norm, self.w_x, self.w_gate = norm, w_x, w_gate
        self.conv_w, self.conv_b = _param(conv_w), _param(conv_b)
        self.w_a, self.w_i, self.lam, self.w_out = w_a, w_i, _param(lam), \
            w_out


def _gates(p: RGLRUBlock, u):
    """u: (..., w) conv output -> (a, b) of h_t = a*h_{t-1} + b, f32."""
    r = torch.sigmoid(dense_apply(p.w_a, u).float())
    i = torch.sigmoid(dense_apply(p.w_i, u).float())
    log_a = -_C * F.softplus(p.lam) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) \
        * i * u.float()
    return a, b


def causal_conv(x, w, b):
    """Depthwise causal conv. x: (B, L, C), w: (W, C), b: (C,)."""
    W, L = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    return sum(xp[:, i:i + L] * w[i] for i in range(W)) + b


def conv_tail(x_pre, W):
    """The last W - 1 pre-conv inputs (B, W - 1, C), zeros before the
    sequence start: the decode conv state."""
    L = x_pre.shape[1]
    if L >= W - 1:
        return x_pre[:, L - (W - 1):L]
    return F.pad(x_pre, (0, 0, W - 1 - L, 0))


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along axis 1 with h_{-1} = 0, for every t:
    after the step of offset d each (a, b) covers the 2d positions ending
    at t."""
    L, d = a.shape[1], 1
    while d < L:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_block_apply(cfg, p: RGLRUBlock, x):
    """Full sequence. x: (B, L, d). Returns (y, cache={h, conv})."""
    xn = norm_apply(p.norm, x, cfg.norm)
    gate = gelu(dense_apply(p.w_gate, xn))
    ux_pre = dense_apply(p.w_x, xn)
    u = F.silu(causal_conv(ux_pre, p.conv_w, p.conv_b))
    a, b = _gates(p, u)
    h = linear_scan(a, b)
    y = dense_apply(p.w_out, (gate.float() * h).to(x.dtype))
    cache = {"h": h[:, -1].to(cfg.torch_dtype),
             "conv": conv_tail(ux_pre, p.conv_w.shape[0])}
    return x + y, cache


def rglru_block_step(cfg, p: RGLRUBlock, x_t, cache):
    """Decode step. x_t: (B, 1, d); cache: {h: (B, w), conv: (B, W-1, w)}.
    Returns (y, new cache) with new tensors (the caller writes them)."""
    xn = norm_apply(p.norm, x_t, cfg.norm)
    gate = gelu(dense_apply(p.w_gate, xn))               # (B, 1, w)
    ux_pre = dense_apply(p.w_x, xn)                      # (B, 1, w)
    conv_in = torch.cat([cache["conv"], ux_pre], dim=1)
    W = p.conv_w.shape[0]
    u = F.silu(sum(conv_in[:, i] * p.conv_w[i] for i in range(W))
               + p.conv_b)                               # (B, w)
    a, b = _gates(p, u[:, None])                         # (B, 1, w) f32
    h = a[:, 0] * cache["h"].float() + b[:, 0]
    y = dense_apply(p.w_out, (gate[:, 0].float() * h).to(x_t.dtype))
    return x_t + y[:, None], {"h": h.to(cfg.torch_dtype),
                              "conv": conv_in[:, 1:]}


def rglru_cache_init(cfg, batch, device=None):
    w = cfg.hybrid.lru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=cfg.torch_dtype,
                             device=device),
            "conv": torch.zeros((batch, 3, w), dtype=cfg.torch_dtype,
                                device=device)}
