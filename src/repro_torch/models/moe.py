"""Mixture-of-Experts layer (DBRX 16 experts top-4, Grok-1 8 experts
top-2): the default path of `repro.models.moe`, plain PyTorch on every
device (the reference computes it in plain `jnp`, outside any Pallas
kernel).

Tokens are scattered into per-expert capacity buffers, the experts run as
batched products over (E, G x C, d), and the results are gathered back
with their gates. Groups: a prefill (T > 1) groups by sequence, a decode
step is one global group of all B rows, so every row routed (frozen or
empty ones too) takes capacity, as in the reference. An assignment's
slot in its expert is the count of earlier (token, k) assignments to that
expert; those at or past the capacity are dropped.

`moe_2d_ff` and `moe_gather_weights` only change the reference's sharding
or layout, so they compute this same function; `moe_ep` is multi-device
expert parallelism, not ported.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import gate_act
from repro_torch.models.param import Dense

_routes = None          # a list while `record_routing` is active


class MoE(nn.Module):
    """router.w (d, E); w1.w / w3.w (E, d, f); w2.w (E, f, d)."""

    def __init__(self, router: Dense, w1: Dense, w2: Dense, w3: Dense):
        super().__init__()
        self.router, self.w1, self.w2, self.w3 = router, w1, w2, w3


@contextlib.contextmanager
def record_routing():
    """Collect each `moe_apply` call's routing into the yielded list, as
    device tensors (no host sync): {"probs": (G, S, E) f32, "idx": (G, S,
    k) experts chosen, "keep": (G, S, k) bool, False where dropped,
    "dropped": 0-d count of dropped assignments}."""
    global _routes
    saved, _routes = _routes, []
    try:
        yield _routes
    finally:
        _routes = saved


def top_k(probs, k):
    """Top-k along the last axis, ties to the lower index (as
    `jax.lax.top_k`): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg, S: int) -> int:
    """Slots an expert has in a group of S tokens, a multiple of 4."""
    k, E = cfg.moe.top_k, cfg.moe.n_experts
    c = max(int(S * k * cfg.moe.capacity_factor / E + 0.999), k)
    return -(-c // 4) * 4


def moe_apply(cfg, p: MoE, x, need_aux=True):
    """x (B, T, d) -> (y (B, T, d), aux): aux is the Switch-style
    load-balance loss of the training loss, or None without `need_aux`
    (serving computes none). The router's product runs in x's dtype, its
    softmax and gates in f32."""
    if cfg.moe_ep:
        raise NotImplementedError(
            f"{cfg.name}: moe_ep (expert parallelism over devices) is not "
            "ported to repro_torch yet (ROADMAP.md queue 1, multi-device)")
    B, T, d = x.shape
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    G, S = (B, T) if T > 1 else (1, B * T)
    xg = x.reshape(G, S, d)
    probs = torch.softmax((xg @ p.router.w.to(x.dtype)).float(), dim=-1)
    gate_vals, gate_idx = top_k(probs, k)                     # (G, S, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    C = capacity(cfg, S)

    onehot = F.one_hot(gate_idx, E)                           # (G, S, k, E)
    oh = onehot.reshape(G, S * k, E)
    pos = ((oh.cumsum(1) - oh) * oh).sum(-1)                  # (G, S*k)
    keep = pos < C
    if _routes is not None:
        _routes.append({"probs": probs, "idx": gate_idx,
                        "keep": keep.reshape(G, S, k),
                        "dropped": (~keep).sum()})

    # dispatch into (E, G, C + 1, d): slot C takes the dropped writes and
    # is never read back
    e_flat = gate_idx.reshape(G, S * k)
    p_flat = torch.where(keep, pos, C)
    g_flat = torch.arange(G, device=x.device)[:, None].expand(G, S * k)
    buf = x.new_zeros(E, G, C + 1, d)
    buf[e_flat, g_flat, p_flat] = xg.repeat_interleave(k, dim=1)
    h = buf.reshape(E, G * (C + 1), d)
    h = gate_act(cfg, torch.bmm(h, p.w1.w), torch.bmm(h, p.w3.w))
    out = torch.bmm(h, p.w2.w).reshape(E, G, C + 1, d)
    g = out[e_flat, g_flat, p_flat.clamp(max=C - 1)].reshape(G, S, k, d)
    w = (keep.reshape(G, S, k) * gate_vals).to(g.dtype)
    y = (g * w[..., None]).sum(2).reshape(B, T, d)
    if not need_aux:
        return y, None

    frac = onehot.sum((1, 2)).float() / (S * k)               # (G, E)
    aux = E * (frac * probs.mean(1)).sum(-1).mean()
    return y, aux
