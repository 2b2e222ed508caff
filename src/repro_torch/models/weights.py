"""The port's model state: seeded random init on the device, and the
bridge from the reference's parameter tree.

`init_params` draws every weight from one seeded `torch.Generator` on the
target device (the full-width model is built on the card, where no JAX
exists). The draws differ from `jax.random`'s, so parity tests go through
`params_from_jax`, which takes the reference's value tree
(`repro.models.param.split(init_params(...))[0]`, every leaf turned into
numpy by the caller) and copies it leaf for leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.param import Dense, Norm
from repro_torch.models.transformer import (MLP, Attention, Block,
                                            Transformer, _check_family)


def _build(cfg, embed, final_scale, lm_head_w, layer):
    """layer(i) -> dict of the i-th layer's tensors under the reference's
    leaf names."""
    blocks = []
    for i in range(cfg.n_layers):
        t = layer(i)
        mlp = MLP(Dense(t["w1"]), Dense(t["w2"]), Dense(t["w3"]))
        blocks.append(Block(
            Norm(t["norm1"]),
            Attention(Dense(t["wq"]), Dense(t["wk"]), Dense(t["wv"]),
                      Dense(t["wo"])),
            Norm(t["norm2"]), mlp))
    return Transformer(embed, blocks, Norm(final_scale), Dense(lm_head_w))


def init_params(cfg, seed: int = 0, device=None) -> Transformer:
    """Random weights at the reference's scales, drawn on `device`
    (None: the card)."""
    _check_family(cfg)
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.torch_dtype
    d, H, KV, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, \
        cfg.d_ff

    def normal(shape, scale):
        return torch.randn(shape, generator=g, device=dev, dtype=dt) * scale

    def ones(n):
        return torch.ones(n, device=dev, dtype=dt)

    def layer(_):
        t = {"norm1": ones(d), "norm2": ones(d),
             "wq": normal((d, H, hd), d ** -0.5),
             "wk": normal((d, KV, hd), d ** -0.5),
             "wv": normal((d, KV, hd), d ** -0.5),
             "wo": normal((H, hd, d), (H * hd) ** -0.5),
             "w1": normal((d, f), d ** -0.5),
             "w2": normal((f, d), f ** -0.5),
             "w3": normal((d, f), d ** -0.5)}
        return t

    embed = normal((cfg.vocab, d), 0.02)
    return _build(cfg, embed, ones(d), normal((d, cfg.vocab), d ** -0.5),
                  layer)


def params_from_jax(cfg, tree, device=None) -> Transformer:
    """The reference's parameter value tree (numpy leaves, blocks stacked
    on a leading layer axis) -> the port's Transformer on `device`
    (None: the card)."""
    _check_family(cfg)
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(
            dev, cfg.torch_dtype)

    blk = tree["blocks"]
    att, mlp = blk["attn"], blk["mlp"]

    def layer(i):
        out = {"norm1": t(blk["norm1"]["scale"][i]),
               "norm2": t(blk["norm2"]["scale"][i]),
               **{n: t(att[n]["w"][i]) for n in ("wq", "wk", "wv", "wo")},
               **{n: t(mlp[n]["w"][i]) for n in ("w1", "w2", "w3")}}
        return out

    return _build(cfg, t(tree["embed"]), t(tree["final_norm"]["scale"]),
                  t(tree["lm_head"]["w"]), layer)
