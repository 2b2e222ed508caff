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

from repro_torch import sharding as shd
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


def _gates(u, w_a, b_a, w_i, b_i, lam, own=slice(None)):
    """u: (..., w) conv output -> (a, b) of h_t = a*h_{t-1} + b, f32, for
    the channels `own` (w_a / w_i's columns, b_a, b_i and lam are given
    for those)."""
    r = torch.sigmoid((u @ w_a + b_a).float())
    i = torch.sigmoid((u @ w_i + b_i).float())
    log_a = -_C * F.softplus(lam) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) \
        * i * u[..., own].float()
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
    gh, h_last, tail = _region(_recur, cfg, p, (gate, ux_pre),
                               (CUT3, ROWS3), (CUT3, CUT2, ROWS3))
    return x + dense_apply(p.w_out, gh), {"h": h_last, "conv": tail}


CUT3, CUT2, ROWS3 = ("batch", None, "mlp"), ("batch", "mlp"), \
    ("batch", None, None)


def _weights(p: RGLRUBlock):
    return (p.conv_w, p.conv_b, p.w_a.w, p.w_a.b, p.w_i.w, p.w_i.b, p.lam)


W_AXES = ((None, None), (None,), (None, "mlp"), ("mlp",), (None, "mlp"),
          ("mlp",), ("mlp",))


def _region(fn, cfg, p: RGLRUBlock, acts, act_axes, out_axes):
    """fn(cfg, *acts, *weights, own) -> (gate * h, h, conv state). Given
    DTensors, each rank runs it on its rows and its slice of the
    recurrence's channels (over "model" where w divides), the conv's
    input whole: the gates' products need every channel of u
    (`sharding.local_call`)."""
    w = _weights(p)
    if not shd.is_dtensor(acts[0]):
        return fn(cfg, *acts, *w)
    mesh = shd.current_mesh()

    def local(placed, *a):
        cut = placed.get("mlp")
        if not cut:
            return fn(cfg, *a)
        n, c = a[-1].shape[0], shd.coordinate(mesh, cut)   # lam's channels
        group = shd.group_of(mesh, cut)
        return fn(cfg, *a, own=slice(c * n, (c + 1) * n),
                  enter=lambda u: shd.enter_sliced(u, group))

    return shd.local_call(local, (*acts, *w), act_axes + W_AXES, out_axes)


def _recur(cfg, gate, ux_pre, conv_w, conv_b, w_a, b_a, w_i, b_i, lam,
           own=slice(None), enter=None):
    """The conv, gates and scan of a full sequence, for the channels
    `own` of the gates and the state (the conv over all). `enter`: u as
    it enters the channel-cut part (its gradient summed over the cut)."""
    u = F.silu(causal_conv(ux_pre, conv_w, conv_b))
    u = u if enter is None else enter(u)
    h = linear_scan(*_gates(u, w_a, b_a, w_i, b_i, lam, own))
    return ((gate.float() * h).to(gate.dtype), h[:, -1].to(cfg.torch_dtype),
            conv_tail(ux_pre, conv_w.shape[0]))


def rglru_block_step(cfg, p: RGLRUBlock, x_t, cache):
    """Decode step. x_t: (B, 1, d); cache: {h: (B, w), conv: (B, W-1, w)}.
    Returns (y, new cache) with new tensors (the caller writes them)."""
    xn = norm_apply(p.norm, x_t, cfg.norm)
    gate = gelu(dense_apply(p.w_gate, xn))               # (B, 1, w)
    ux_pre = dense_apply(p.w_x, xn)                      # (B, 1, w)
    gh, h, conv = _region(_recur_step, cfg, p,
                          (gate, ux_pre, cache["h"], cache["conv"]),
                          (CUT3, ROWS3, CUT2, ROWS3), (CUT2, CUT2, ROWS3))
    return x_t + dense_apply(p.w_out, gh)[:, None], {"h": h, "conv": conv}


def _recur_step(cfg, gate, ux_pre, h, conv, conv_w, conv_b, w_a, b_a, w_i,
                b_i, lam, own=slice(None), enter=None):
    """One token of the conv, gates and recurrence (the channels `own` of
    the gates and the state, the conv over all; `enter` as `_recur`)."""
    conv_in = torch.cat([conv, ux_pre], dim=1)
    W = conv_w.shape[0]
    u = F.silu(sum(conv_in[:, i] * conv_w[i] for i in range(W))
               + conv_b)                                 # (B, w)
    u = u if enter is None else enter(u)
    a, b = _gates(u[:, None], w_a, b_a, w_i, b_i, lam, own)  # (B, 1, w) f32
    h = a[:, 0] * h.float() + b[:, 0]
    return ((gate[:, 0].float() * h).to(gate.dtype), h.to(cfg.torch_dtype),
            conv_in[:, 1:])


def rglru_cache_init(cfg, batch, device=None):
    w = cfg.hybrid.lru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=cfg.torch_dtype,
                             device=device),
            "conv": torch.zeros((batch, 3, w), dtype=cfg.torch_dtype,
                                device=device)}
