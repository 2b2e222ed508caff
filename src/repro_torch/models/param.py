"""Parameter containers and the two leaf layers (dense, norm).

The port's model is a tree of `nn.Module`s whose attribute names and
tensor layouts are the reference's parameter tree (`blocks[i].attn.wq.w`
is `(d, H, hd)`), so `models.weights.params_from_jax` maps one onto the
other leaf for leaf. Parameters never require grad: the port serves.

`models.weights.init_tree` makes each leaf a `Box` of its value and its
logical axes, as the reference's init does; `split` parts the two, so the
sharding plane (`repro_torch.sharding`) derives placements from the same
tree the weights come from.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.sharding import constrain


class Box(NamedTuple):
    """A leaf of an init tree: its value and its logical axes (one name,
    or None, a dim; `sharding.RULES` maps the names to mesh axes)."""
    value: torch.Tensor
    axes: Tuple[Optional[str], ...]


def split(tree):
    """A tree with `Box` leaves (dicts and lists) -> (value tree, axes
    tree) of the same structure."""
    if isinstance(tree, Box):
        return tree.value, tuple(tree.axes)
    if isinstance(tree, dict):
        pairs = {k: split(v) for k, v in tree.items()}
        return ({k: v for k, (v, _) in pairs.items()},
                {k: a for k, (_, a) in pairs.items()})
    pairs = [split(v) for v in tree]
    return [v for v, _ in pairs], [a for _, a in pairs]


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
    dtype. A DTensor x is first laid out with its rows over the data axes
    and its features whole (`sharding.constrain`): the residual stream's
    sums over "model" are taken here, where the reference's GSPMD takes
    them."""
    x = constrain(x, "batch", *(None,) * (x.dim() - 1))
    xf = x.float()
    if kind == "layernorm":
        xf = xf - xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p.scale.float()
    if kind == "layernorm" and p.bias is not None:
        y = y + p.bias.float()
    return y.to(x.dtype)
