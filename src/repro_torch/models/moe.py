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
or layout, so they compute this same function; `moe_ep` under a mesh with
a data axis is `models.moe_ep.moe_apply_ep` (`transformer.block_apply`
chooses), and without one this function over the EP-native weights,
which are this layout when each expert is one f-slice.
"""
from __future__ import annotations

import contextlib
from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import sharding as shd
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
    "dropped": 0-d count of dropped assignments}. A call under a CUDA-graph
    capture raises: a replay runs no Python and would record nothing."""
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
    softmax and gates in f32. Given DTensors, see `_moe_apply_dist`."""
    if shd.is_dtensor(x):
        return _moe_apply_dist(cfg, p, x, need_aux)
    return _moe_apply(cfg, p, x, need_aux)


def _moe_apply_dist(cfg, p: MoE, x, need_aux):
    """Each rank routes its rows with every expert whole: a prefill's
    groups (its sequences) are the rank's own; a decode step's one group
    of all rows is formed on every rank. The aux loss is averaged over
    the data axes. (Expert parallelism is `moe_ep`.)"""
    mesh = shd.current_mesh()
    x_axes = ("batch", None, None) if x.shape[1] > 1 else (None, None, None)
    w = [p.router.w, p.w1.w, p.w2.w, p.w3.w]

    def local(placed, x, *w):
        r, w1, w2, w3 = (SimpleNamespace(w=t) for t in w)
        y, aux = _moe_apply(cfg, SimpleNamespace(router=r, w1=w1, w2=w2,
                                                 w3=w3), x, need_aux)
        rows = placed.get("batch")
        if aux is not None and rows:
            aux = shd.sum_over(aux, shd.group_of(mesh, rows),
                               1.0 / shd.shard_count((rows,), mesh))
        return y, aux

    return shd.local_call(local, (x, *w),
                          (x_axes, *((None,) * t.dim() for t in w)),
                          (x_axes, () if need_aux else None))


def _moe_apply(cfg, p: MoE, x, need_aux=True):
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
        if x.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "record_routing under a CUDA-graph capture: the graph's "
                "replays would append nothing (record an eager call)")
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
