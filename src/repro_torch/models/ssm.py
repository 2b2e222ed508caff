"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060). Mirrors
`repro.models.ssm`: prefill runs the chunked SSD algorithm (intra-chunk
quadratic form, inter-chunk state recurrence: a Python loop over chunks
where the reference scans), decode the O(1) state update. LoRA targets
in_proj / out_proj (the paper's q/k/v do not exist here).
"""
from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import sharding as shd
from repro_torch.core.lora import lora_apply
from repro_torch.models.param import Dense, Norm, _param, dense_apply, \
    norm_apply
from repro_torch.models.rglru import causal_conv, conv_tail
from repro_torch.models.transformer import _plus


class SSMBlock(nn.Module):
    """norm; in_proj (d, in_total); conv_w (W, conv_dim), conv_b;
    a_log, dt_bias, d_skip (H,) f32; gate_norm (d_in,); out_proj
    (d_in, d)."""

    def __init__(self, norm: Norm, in_proj: Dense, conv_w: torch.Tensor,
                 conv_b: torch.Tensor, a_log: torch.Tensor,
                 dt_bias: torch.Tensor, d_skip: torch.Tensor,
                 gate_norm: Norm, out_proj: Dense):
        super().__init__()
        self.norm, self.in_proj = norm, in_proj
        self.conv_w, self.conv_b = _param(conv_w), _param(conv_b)
        self.a_log, self.dt_bias = _param(a_log), _param(dt_bias)
        self.d_skip = _param(d_skip)
        self.gate_norm, self.out_proj = gate_norm, out_proj


def ssm_dims(cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.state_dim
    in_total = 2 * d_in + 2 * s.n_groups * s.state_dim + H
    return d_in, H, conv_dim, in_total


def _segsum(a):
    """a: (..., Q) log-decays -> (..., Q, Q): out[i, j] = sum_{j<t<=i} a_t
    for i >= j, -inf otherwise."""
    Q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    idx = torch.arange(Q, device=a.device)
    return torch.where(idx[:, None] >= idx[None, :], diff, -torch.inf)


def ssd_chunked(x, dt, A, B, C, D, chunk):
    """SSD scan. x: (b, l, h, p); dt: (b, l, h) (post-softplus); A: (h,)
    negative; B, C: (b, l, g, n); D: (h,). Returns y: (b, l, h, p) and the
    final state (b, h, p, n). Types follow the reference's: decays in
    f32, products in x's dtype."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    Q = min(chunk, l)
    pad = (-l) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    nc = x.shape[1] // Q
    xc = x.reshape(b, nc, Q, h, p)
    dtc = dt.reshape(b, nc, Q, h)
    Bc = B.reshape(b, nc, Q, g, n)
    Cc = C.reshape(b, nc, Q, g, n)
    a = (dtc * A).float()                                 # (b,nc,Q,h)
    a_h = a.permute(0, 1, 3, 2)                           # (b,nc,h,Q)
    cum = torch.cumsum(a_h, dim=-1)

    # intra-chunk (quadratic, "attention-like")
    Lmat = torch.exp(_segsum(a_h))                        # (b,nc,h,Q,Q)
    Bh = Bc.repeat_interleave(rep, dim=3)                 # (b,nc,Q,h,n)
    Ch = Cc.repeat_interleave(rep, dim=3)
    scores = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh).float()
    xdt = xc * dtc[..., None]
    y_intra = torch.einsum("bchqk,bckhp->bcqhp",
                           (scores * Lmat).to(x.dtype), xdt)

    # per-chunk final states
    decay_to_end = torch.exp(cum[..., -1:] - cum)         # (b,nc,h,Q)
    states = torch.einsum("bchq,bcqhn,bcqhp->bchpn",
                          decay_to_end.to(x.dtype), Bh, xdt)

    # inter-chunk recurrence over chunk states
    chunk_decay = torch.exp(cum[..., -1])                 # (b,nc,h)
    S = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(S)
        S = S * chunk_decay[:, c, :, None, None].to(S.dtype) + states[:, c]
    S_prev = torch.stack(prev, dim=1)                     # (b,nc,h,p,n)

    y_inter = torch.einsum("bcqhn,bchpn,bchq->bcqhp", Ch, S_prev,
                           torch.exp(cum).to(x.dtype))
    y = (y_intra + y_inter).reshape(b, -1, h, p)[:, :l]
    y = y + x[:, :l] * D[None, None, :, None].to(x.dtype)
    return y, S


def ssd_step(x_t, dt_t, A, B_t, C_t, D, state):
    """Decode step. x_t: (b, h, p); dt_t: (b, h); B_t, C_t: (b, g, n);
    state: (b, h, p, n) -> (y_t, new_state)."""
    rep = x_t.shape[1] // B_t.shape[1]
    Bh = B_t.repeat_interleave(rep, dim=1)                # (b,h,n)
    Ch = C_t.repeat_interleave(rep, dim=1)
    decay = torch.exp((dt_t * A).float()).to(state.dtype)
    upd = torch.einsum("bhp,bhn->bhpn", x_t * dt_t[..., None], Bh)
    state = state * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", state, Ch) \
        + x_t * D[None, :, None].to(x_t.dtype)
    return y, state


def _split_in_proj(cfg, zxbcdt):
    d_in, _, conv_dim, _ = ssm_dims(cfg)
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:d_in + conv_dim],
            zxbcdt[..., d_in + conv_dim:])


def ssm_block_apply(cfg, p: SSMBlock, x, *, lora_layer=None, lora_idx=None,
                    lora_ranks=None, lora_mode="bgmv", lora_live=None):
    """Full-sequence (prefill) pass. x: (B, L, d). Returns (y, cache
    {state (B, H, P, N), conv (B, W - 1, conv_dim)})."""
    lora = (lora_idx, lora_ranks, lora_mode, cfg.lora.rank_block, lora_live)
    xn = norm_apply(p.norm, x, cfg.norm)
    zxbcdt = _plus(dense_apply(p.in_proj, xn),
                   lora_apply(xn, lora_layer, "in_proj", *lora))
    y, S_final, tail = _mixer(cfg, p, zxbcdt)
    out = _plus(dense_apply(p.out_proj, y),
                lora_apply(y, lora_layer, "out_proj", *lora))
    return x + out, {"state": S_final, "conv": tail}


def _mixer_weights(p: SSMBlock):
    return (p.conv_w, p.conv_b, p.a_log, p.dt_bias, p.d_skip,
            p.gate_norm.scale)


def _mixer(cfg, p: SSMBlock, zxbcdt):
    """The SSD mixer between the projections: (y (B, L, d_in), final state,
    conv tail). Given DTensors, each rank mixes its rows with the block's
    weights whole (`sharding.local_call`)."""
    if not shd.is_dtensor(zxbcdt):
        return _mix(cfg, zxbcdt, *_mixer_weights(p))
    w = _mixer_weights(p)
    return shd.local_call(
        lambda placed, z, *w: _mix(cfg, z, *w), (zxbcdt, *w),
        (ROWS3,) + tuple((None,) * t.dim() for t in w),
        (ROWS3, ("batch", None, None, None), ROWS3))


ROWS3 = ("batch", None, None)


def _mix(cfg, zxbcdt, conv_w, conv_b, a_log, dt_bias, d_skip, gn_scale):
    s = cfg.ssm
    B_, L, _ = zxbcdt.shape
    d_in, H, _, _ = ssm_dims(cfg)
    gn = s.n_groups * s.state_dim
    z, xbc_pre, dt = _split_in_proj(cfg, zxbcdt)
    xbc = F.silu(causal_conv(xbc_pre, conv_w, conv_b))
    xs = xbc[..., :d_in].reshape(B_, L, H, s.head_dim)
    Bm = xbc[..., d_in:d_in + gn].reshape(B_, L, s.n_groups, s.state_dim)
    Cm = xbc[..., d_in + gn:].reshape(B_, L, s.n_groups, s.state_dim)
    dt_f = F.softplus(dt.float() + dt_bias)
    A = -torch.exp(a_log)
    y, S_final = ssd_chunked(xs, dt_f.to(zxbcdt.dtype), A, Bm, Cm, d_skip,
                             s.chunk)
    y = y.reshape(B_, L, d_in)
    y = norm_apply(SimpleNamespace(scale=gn_scale, bias=None),
                   y * F.silu(z), "rmsnorm")
    return y, S_final, conv_tail(xbc_pre, s.conv_width)


def ssm_block_step(cfg, p: SSMBlock, x_t, cache, *, lora_layer=None,
                   lora_idx=None, lora_ranks=None, lora_mode="bgmv",
                   lora_live=None):
    """Decode step. x_t: (B, 1, d); cache: {state (B, H, P, N), conv
    (B, W - 1, conv_dim)}. Returns (y, new cache) with new tensors (the
    caller writes them)."""
    lora = (lora_idx, lora_ranks, lora_mode, cfg.lora.rank_block, lora_live)
    xn = norm_apply(p.norm, x_t, cfg.norm)
    zxbcdt = _plus(dense_apply(p.in_proj, xn),
                   lora_apply(xn, lora_layer, "in_proj", *lora))
    args = (zxbcdt, cache["conv"], cache["state"], *_mixer_weights(p))
    if shd.is_dtensor(zxbcdt):
        y, state, conv = shd.local_call(
            lambda placed, *a: _mix_step(cfg, *a), args,
            (ROWS3, ROWS3, ("batch", None, None, None))
            + tuple((None,) * t.dim() for t in args[3:]),
            (ROWS3, ("batch", None, None, None), ROWS3))
    else:
        y, state, conv = _mix_step(cfg, *args)
    out = _plus(dense_apply(p.out_proj, y),
                lora_apply(y, lora_layer, "out_proj", *lora))
    return x_t + out, {"state": state, "conv": conv}


def _mix_step(cfg, zxbcdt, conv_state, state, conv_w, conv_b, a_log,
              dt_bias, d_skip, gn_scale):
    """One token of the mixer: (y (B, 1, d_in), new state, new conv
    state)."""
    s = cfg.ssm
    B_ = zxbcdt.shape[0]
    d_in, H, _, _ = ssm_dims(cfg)
    gn = s.n_groups * s.state_dim
    z, xbc_pre, dt = _split_in_proj(cfg, zxbcdt)
    conv_in = torch.cat([conv_state, xbc_pre], dim=1)     # (B, W, conv)
    xbc = sum(conv_in[:, i] * conv_w[i] for i in range(s.conv_width))
    xbc = F.silu(xbc + conv_b)                            # (B, conv_dim)
    xs = xbc[..., :d_in].reshape(B_, H, s.head_dim)
    Bm = xbc[..., d_in:d_in + gn].reshape(B_, s.n_groups, s.state_dim)
    Cm = xbc[..., d_in + gn:].reshape(B_, s.n_groups, s.state_dim)
    dt_f = F.softplus(dt[:, 0].float() + dt_bias)
    A = -torch.exp(a_log)
    y_t, state = ssd_step(xs, dt_f.to(zxbcdt.dtype), A, Bm, Cm, d_skip,
                          state)
    y = y_t.reshape(B_, 1, d_in)
    y = norm_apply(SimpleNamespace(scale=gn_scale, bias=None),
                   y * F.silu(z), "rmsnorm")
    return y, state, conv_in[:, 1:]


def ssm_cache_init(cfg, batch, device=None):
    s = cfg.ssm
    _, H, conv_dim, _ = ssm_dims(cfg)
    return {"state": torch.zeros((batch, H, s.head_dim, s.state_dim),
                                 dtype=cfg.torch_dtype, device=device),
            "conv": torch.zeros((batch, s.conv_width - 1, conv_dim),
                                dtype=cfg.torch_dtype, device=device)}
