"""Parameter containers and the two leaf layers (dense, norm).

The port's model is a tree of `nn.Module`s whose attribute names and
tensor layouts are the reference's parameter tree (`blocks[i].attn.wq.w`
is `(d, H, hd)`), so `models.weights.params_from_jax` maps one onto the
other leaf for leaf. Parameters never require grad: the port serves.
"""
from __future__ import annotations

import torch
from torch import nn


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Dense(nn.Module):
    """A weight `w` of any layout and an optional bias `b` (q/k/v with
    `cfg.qkv_bias`, the RG-LRU gates)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor = None):
        super().__init__()
        self.w = _param(w)
        self.b = None if b is None else _param(b)


class Norm(nn.Module):
    """`scale`, and `bias` for a layernorm (`cfg.norm`)."""

    def __init__(self, scale: torch.Tensor, bias: torch.Tensor = None):
        super().__init__()
        self.scale = _param(scale)
        self.bias = None if bias is None else _param(bias)


def dense_apply(p: Dense, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w
    return y if p.b is None else y + p.b


def norm_apply(p: Norm, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm or LayerNorm (`kind`) computed in float32, cast back to x's
    dtype."""
    xf = x.float()
    if kind == "layernorm":
        xf = xf - xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p.scale.float()
    if kind == "layernorm" and p.bias is not None:
        y = y + p.bias.float()
    return y.to(x.dtype)
