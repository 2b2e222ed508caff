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
    """A weight `w` of any layout (the dense family the port serves has no
    biases)."""

    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.w = _param(w)


class Norm(nn.Module):
    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = _param(scale)


def dense_apply(p: Dense, x: torch.Tensor) -> torch.Tensor:
    return x @ p.w


def norm_apply(p: Norm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in float32, cast back to x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p.scale.float()
    return y.to(x.dtype)
