"""AdamW with decoupled weight decay, global-norm clipping and a
linear-warmup cosine schedule, on trees of tensors (`training.tree`).
Mirrors `repro.training.optim` and computes its function: moments in
`moments_dtype` whatever the parameters' dtype, the update in float32,
cast back to each leaf's dtype. (`torch.optim.AdamW` differs in its decay
and bias-correction arithmetic.)"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.training import tree as tree_lib


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moments_dtype: str = "float32"   # bf16 halves optimizer memory (>=70B)


class AdamWState(NamedTuple):
    step: Any          # 0-d int32 tensor
    mu: Any
    nu: Any


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at `step` (a tensor), in float32."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init(params, moments_dtype="float32") -> AdamWState:
    """Zero moments shaped and laid out like `params` (a DTensor
    parameter's moments are DTensors of its placements), on the device of
    its first leaf."""
    dt = getattr(torch, moments_dtype)
    dev = tree_lib.leaves(params)[0].device
    z = lambda p: torch.zeros_like(p, dtype=dt, device=dev)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_lib.map_(z, params),
                      nu=tree_lib.map_(z, params))


def clone(state: AdamWState) -> AdamWState:
    """A copy of `state`, leaf for leaf."""
    return AdamWState(state.step.clone(), tree_lib.map_(torch.clone, state.mu),
                      tree_lib.map_(torch.clone, state.nu))


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.float())) for x in tree_lib.leaves(tree)]
    return torch.sqrt(sum(sq))


def _updates(cfg: AdamWConfig, params, grads, state: AdamWState,
             decay=None):
    """The step's shared terms and, leaf by leaf, (param, its new value,
    mu, new mu, nu, new nu): the one arithmetic of `apply` and `apply_`.
    Returns (step + 1, stats, generator of those tuples)."""
    gnorm = global_norm(grads)
    flat_g = [g.float() for g in tree_lib.leaves(grads)]
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        flat_g = [g * scale for g in flat_g]
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.float())
    b2c = 1 - torch.pow(cfg.b2, step.float())
    mdt = getattr(torch, cfg.moments_dtype)
    flat_p = tree_lib.leaves(params)
    flat_d = [p.dim() >= 2 for p in flat_p] if decay is None \
        else tree_lib.leaves(decay)

    def leaf(p, g32, mu, nu, dec):
        mu_n = cfg.b1 * mu.float() + (1 - cfg.b1) * g32
        nu_n = cfg.b2 * nu.float() + (1 - cfg.b2) * g32 * g32
        delta = (mu_n / b1c) / (torch.sqrt(nu_n / b2c) + cfg.eps)
        p32 = p.float()
        if dec:
            delta = delta + cfg.weight_decay * p32
        return (p, (p32 - lr * delta).to(p.dtype), mu, mu_n.to(mdt), nu,
                nu_n.to(mdt))

    gen = (leaf(p, g, m, n, d) for p, g, m, n, d in zip(
        flat_p, flat_g, tree_lib.leaves(state.mu),
        tree_lib.leaves(state.nu), flat_d))
    return step, {"grad_norm": gnorm, "lr": lr}, gen


def apply(cfg: AdamWConfig, params, grads, state: AdamWState, decay=None):
    """Returns (new_params, new_state, stats); `params` and `state` are
    left as they are. Weight decay applies to the leaves with ndim >= 2,
    or, given `decay` (a tree of bools like `params`), to the leaves it
    marks: the port keeps a uniform stack's layers as a list where the
    reference stacks them, so a layer's leaf has one dimension fewer than
    the reference's (`train.decay_mask`). Clipped gradients are float32,
    as the reference's bf16 gradient times its f32 scale promotes to
    float32."""
    step, stats, gen = _updates(cfg, params, grads, state, decay)
    out = list(gen)
    new_p = tree_lib.unflatten(params, [o[1] for o in out])
    new_mu = tree_lib.unflatten(params, [o[3] for o in out])
    new_nu = tree_lib.unflatten(params, [o[5] for o in out])
    return new_p, AdamWState(step, new_mu, new_nu), stats


def apply_(cfg: AdamWConfig, params, grads, state: AdamWState, decay=None):
    """`apply` written in place: each parameter, moment and the step
    counter keep their storage (a captured training step reads them by
    address), one leaf at a time, so no second copy of the trees exists.
    The arithmetic is `apply`'s. Returns the stats."""
    step, stats, gen = _updates(cfg, params, grads, state, decay)
    for p, p_n, mu, mu_n, nu, nu_n in gen:
        p.copy_(p_n)
        mu.copy_(mu_n)
        nu.copy_(nu_n)
    state.step.copy_(step)
    return stats
