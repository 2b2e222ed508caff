"""Training step builders: full fine-tuning and LoRA-adapter training (the
substrate that produces the adapters CaraServe serves). Mirrors
`repro.training.train`.

On the card the forward pass runs the hand-written flash and LoRA
kernels, and their gradients go through the kernels' autograd Functions
(`kernels/flash.py`, `kernels/bgmv.py`); each layer is recomputed in the
backward when `cfg.remat` (`transformer.remat_layer`). A parameter or
adapter leaf that autograd cannot reach from the loss is an error, never
a zero gradient.

The parameters of the port's model are `nn.Parameter`s that do not
require grad (the port serves). Full fine-tuning switches them on for
its step only. The steps (`make_train_step_`, `make_lora_train_step_`)
write the optimizer's update into the trained leaves and the optimizer
state in place (`optim.apply_`), so that they can run as a CUDA graph
(`launch.train.Trainer`); `make_train_step` and `make_lora_train_step`
give the reference's functional signatures over the same arithmetic.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch import sharding as shd
from repro_torch.configs.base import ModelConfig
from repro_torch.core.lora import lora_target_dims
from repro_torch.kernels.bgmv import padded_rank
from repro_torch.models import model as model_lib
from repro_torch.training import optim
from repro_torch.training import tree as tree_lib


def _microbatches(batch, accum: int):
    """(B, ...) -> accum batches of B / accum rows, in order. A DTensor
    batch is gathered whole, and each microbatch's rows laid out over the
    data axes again."""
    for x in batch.values():
        if x.shape[0] % accum:
            raise ValueError(
                f"batch ({x.shape[0]}) must be a multiple of accum ({accum})")
    whole = {k: shd.constrain(v, *(None,) * v.dim())
             for k, v in batch.items()}
    return [{k: shd.constrain(v.reshape(accum, -1, *v.shape[1:])[i],
                              "batch", *(None,) * (v.dim() - 1))
             for k, v in whole.items()} for i in range(accum)]


def grads(loss: torch.Tensor, leaves, names):
    """d loss / d leaf for each leaf, laid out as the leaf (a DTensor
    leaf's gradient is reduce-scattered to its layout); raises, naming the
    leaves, if the graph does not reach some of them (a kernel without a
    gradient would cut it)."""
    if not loss.requires_grad:
        raise RuntimeError("training: the loss has no gradient at all (no "
                           "leaf is reachable from it)")
    out = torch.autograd.grad(loss, leaves, allow_unused=True)
    missing = [n for n, g in zip(names, out) if g is None]
    if missing:
        raise RuntimeError(f"training: no gradient reaches {len(missing)} "
                           f"leaves requiring one, e.g. {missing[:4]}")
    return [shd.like(g, p) for g, p in zip(out, leaves)]


@contextlib.contextmanager
def trainable(leaves):
    for p in leaves:
        p.requires_grad_(True)
    try:
        yield
    finally:
        for p in leaves:
            p.requires_grad_(False)


def decay_mask(cfg: ModelConfig, tree):
    """Which leaves of the port's parameter tree AdamW decays: those whose
    leaf in the reference's tree has ndim >= 2. The reference stacks the
    layers of a uniform stack (`blocks`, not the hybrid's) on a leading
    axis, so a layer's leaf counts one dimension more there (its norm
    scales are decayed)."""
    stacked = not cfg.hybrid and cfg.family not in ("audio", "encdec")
    out = {k: tree_lib.map_(lambda p: p.dim() >= 2, v)
           for k, v in tree.items()}
    if stacked and "blocks" in tree:
        out["blocks"] = tree_lib.map_(lambda p: p.dim() >= 1, tree["blocks"])
    return out


def make_train_step_(cfg: ModelConfig, opt_cfg: optim.AdamWConfig,
                     accum: Optional[int] = None):
    """Returns train_step_(params, opt_state, batch) -> metrics: full
    fine-tuning of every parameter of the model `params`, with the
    gradients of `accum` microbatches summed in `cfg.opt_moments_dtype`
    and divided by `accum`; the parameters and `opt_state` (over
    `tree.param_tree(params)`) are updated in place (`optim.apply_`), so
    the step can run as a CUDA graph."""
    accum = accum or cfg.accum_steps
    acc_dtype = getattr(torch, cfg.opt_moments_dtype)

    def train_step_(params, opt_state, batch):
        tree = tree_lib.param_tree(params)
        leaves, names = tree_lib.leaves(tree), tree_lib.paths(tree)
        with trainable(leaves):
            if accum > 1:
                g_acc = [torch.zeros_like(p, dtype=acc_dtype)
                         for p in leaves]
                loss = 0.0
                for mb in _microbatches(batch, accum):
                    l, _ = model_lib.loss(cfg, params, mb)
                    for a, g in zip(g_acc, grads(l, leaves, names)):
                        a += g.to(a.dtype)
                    loss = loss + l.detach()
                gs = [g.div_(accum) for g in g_acc]
                loss = loss / accum
            else:
                loss, _ = model_lib.loss(cfg, params, batch)
                gs = grads(loss, leaves, names)
                loss = loss.detach()
        with torch.no_grad():
            stats = optim.apply_(opt_cfg, tree, tree_lib.unflatten(tree, gs),
                                 opt_state, decay=decay_mask(cfg, tree))
        return {"loss": loss, **stats}

    return train_step_


def make_train_step(cfg: ModelConfig, opt_cfg: optim.AdamWConfig,
                    accum: Optional[int] = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): `make_train_step_`'s step with the parameters updated in
    place and a new optimizer state (`opt_state` is left as it is)."""
    step_ = make_train_step_(cfg, opt_cfg, accum)

    def train_step(params, opt_state, batch):
        opt_state = optim.clone(opt_state)
        return params, opt_state, step_(params, opt_state, batch)

    return train_step


def lora_pool(adapter, rank: int):
    """The adapter as a single-slot pool, the structure the engine
    serves: {target: {a: (L, 1, d_in, r_max), b: (L, 1, r_max, d_out)},
    ranks: (1,)} (views, no copies)."""
    pool = {t: {"a": adapter[t]["a"][:, None], "b": adapter[t]["b"][:, None]}
            for t in adapter}
    dev = tree_lib.leaves(adapter)[0].device
    pool["ranks"] = torch.full((1,), rank, dtype=torch.int32, device=dev)
    return pool


def lora_loss_and_grads(cfg: ModelConfig, params, adapter, batch,
                        rank: int):
    """The loss of the frozen model `params` with `adapter` on every row
    (slot 0, mode "bgmv", as the reference builds it) and its gradient in
    each adapter leaf. Returns (loss, grads like `adapter`)."""
    flat = [t.detach().requires_grad_() for t in tree_lib.leaves(adapter)]
    live = tree_lib.unflatten(adapter, flat)
    B = batch["tokens"].shape[0]
    lora = {"pool": lora_pool(live, rank),
            "idx": torch.zeros(B, dtype=torch.int32, device=flat[0].device),
            "mode": "bgmv"}
    loss, _ = model_lib.loss(cfg, params, batch, lora=lora)
    gs = grads(loss, flat, tree_lib.paths(adapter))
    return loss.detach(), tree_lib.unflatten(adapter, gs)


def make_lora_train_step_(cfg: ModelConfig, opt_cfg: optim.AdamWConfig,
                          rank: int):
    """LoRA fine-tuning in place: base params frozen; gradients flow only
    to the adapter, which `optim.apply_` updates in place with the
    optimizer state, so the step can run as a CUDA graph. Returns
    train_step_(adapter, opt_state, params, batch) -> metrics."""

    def train_step_(adapter, opt_state, params, batch):
        loss, g = lora_loss_and_grads(cfg, params, adapter, batch, rank)
        with torch.no_grad():
            stats = optim.apply_(opt_cfg, adapter, g, opt_state)
        return {"loss": loss, **stats}

    return train_step_


def make_lora_train_step(cfg: ModelConfig, opt_cfg: optim.AdamWConfig,
                         rank: int):
    """`make_lora_train_step_`'s step, functional as the reference's:
    train_step(adapter, opt_state, params, batch) -> (adapter, opt_state,
    metrics), new trees, the arguments left as they are."""
    step_ = make_lora_train_step_(cfg, opt_cfg, rank)

    def train_step(adapter, opt_state, params, batch):
        adapter = tree_lib.map_(torch.clone, adapter)
        opt_state = optim.clone(opt_state)
        return adapter, opt_state, step_(adapter, opt_state, params, batch)

    return train_step


def init_lora_adapter(cfg: ModelConfig, rank: int,
                      generator: torch.Generator):
    """Trainable adapter {target: {a: (L, d_in, r_pad), b: (L, r_pad,
    d_out)}} (r_pad = `padded_rank(max_rank)`, as the serving pool) in the
    config's dtype, on the generator's device: A ~ N(0, d_in^-1/2) with
    the columns past `rank` zeroed, B zero (standard LoRA: training starts
    at the base model). The columns past `rank` get zero gradients and stay
    zero. The draws differ from `jax.random`'s; parity tests carry the
    reference's adapter across (`models.weights.adapter_from_jax`)."""
    L = cfg.n_layers + cfg.n_enc_layers
    r_max = padded_rank(cfg.lora.max_rank)
    rank = min(rank, cfg.lora.max_rank)
    dev = generator.device
    out = {}
    for tgt in cfg.lora.targets:
        d_in, d_out = lora_target_dims(cfg, tgt)
        a = torch.randn((L, d_in, r_max), generator=generator, device=dev)
        a = a * d_in ** -0.5 * (torch.arange(r_max, device=dev) < rank)
        out[tgt] = {"a": a.to(cfg.torch_dtype),
                    "b": torch.zeros(L, r_max, d_out, dtype=cfg.torch_dtype,
                                     device=dev)}
    return out
