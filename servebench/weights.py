"""The inputs a run makes from `--seed`: the base model's weights on the
device, in the port's parameter layout, and the adapters, made on the
device and copied to host memory.

Both are drawn from one `torch.Generator` on the device in a few large
calls: every weight of the model is one slice of one flat buffer filled
by `torch.randn`, then scaled in place a leaf at a time (the scales are
the port's own init scales: embedding 0.02, a projection d_in^-0.5). The
norms' scales and the q/k/v biases are drawn too, so that the reference
is held to them. Adapters of one rank are drawn together, a target at a
time: A (L, d_in, r) ~ N(0, 1/d_in), B (L, r, d_out) ~ N(0, 1/r), the
scales of the port's `make_adapter_weights`, then padded with zeros to
the pool's rank (`core/lora.make_adapter_weights` documents the layout).

The returned `Weights` is what both sides get: the port builds its
modules over these very tensors (no copy), and the reference reads them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from servebench.model_config import ModelSpec


@dataclasses.dataclass
class Layer:
    norm1: torch.Tensor          # (d,)
    wq: torch.Tensor             # (d, H, hd)
    wk: torch.Tensor             # (d, KV, hd)
    wv: torch.Tensor             # (d, KV, hd)
    wo: torch.Tensor             # (H, hd, d)
    bq: object                   # (H, hd) or None
    bk: object
    bv: object
    norm2: torch.Tensor          # (d,)
    w1: torch.Tensor             # (d, f)  gate
    w3: torch.Tensor             # (d, f)  up
    w2: torch.Tensor             # (f, d)  down


@dataclasses.dataclass
class Weights:
    embed: torch.Tensor          # (vocab, d)
    layers: List[Layer]
    final_norm: torch.Tensor     # (d,)
    lm_head: torch.Tensor        # (d, vocab)


def _leaf_shapes(m: ModelSpec):
    d, H, KV, hd, f = m.d_model, m.n_heads, m.n_kv_heads, m.hd, m.d_ff
    layer = [("norm1", (d,)), ("wq", (d, H, hd)), ("wk", (d, KV, hd)),
             ("wv", (d, KV, hd)), ("wo", (H, hd, d))]
    if m.qkv_bias:
        layer += [("bq", (H, hd)), ("bk", (KV, hd)), ("bv", (KV, hd))]
    layer += [("norm2", (d,)), ("w1", (d, f)), ("w3", (d, f)),
              ("w2", (f, d))]
    return layer


def _scale(m: ModelSpec, name: str):
    """(multiplier, offset) that turn a N(0, 1) draw into the leaf."""
    d = m.d_model
    if name in ("norm1", "norm2", "final_norm"):
        return 0.1, 1.0                   # scales around 1
    if name in ("bq", "bk", "bv"):
        return 0.5, 0.0
    if name == "embed":
        return 0.02, 0.0
    if name == "wo":
        return (m.n_heads * m.hd) ** -0.5, 0.0
    if name == "w2":
        return m.d_ff ** -0.5, 0.0
    return d ** -0.5, 0.0                 # wq wk wv w1 w3 lm_head


def make_weights(m: ModelSpec, gen: torch.Generator,
                 device: torch.device) -> Weights:
    dt = m.torch_dtype
    shapes = [("embed", (m.vocab, m.d_model))]
    for i in range(m.n_layers):
        shapes += [((i, n), s) for n, s in _leaf_shapes(m)]
    shapes += [("final_norm", (m.d_model,)),
               ("lm_head", (m.d_model, m.vocab))]
    sizes = [int(torch.Size(s).numel()) for _, s in shapes]
    flat = torch.empty(sum(sizes), dtype=dt, device=device)
    # one randn a chunk of at most 2**30 elements (a few large calls)
    chunk = 1 << 30
    for off in range(0, flat.numel(), chunk):
        flat[off:off + chunk].normal_(generator=gen)
    views: Dict[object, torch.Tensor] = {}
    off = 0
    for (key, shape), n in zip(shapes, sizes):
        v = flat[off:off + n].view(shape)
        mul, add = _scale(m, key[1] if isinstance(key, tuple) else key)
        v.mul_(mul)
        if add:
            v.add_(add)
        views[key] = v
        off += n
    layers = []
    for i in range(m.n_layers):
        g = {n: views[(i, n)] for n, _ in _leaf_shapes(m)}
        layers.append(Layer(g["norm1"], g["wq"], g["wk"], g["wv"], g["wo"],
                            g.get("bq"), g.get("bk"), g.get("bv"),
                            g["norm2"], g["w1"], g["w3"], g["w2"]))
    return Weights(views["embed"], layers, views["final_norm"],
                   views["lm_head"])


def port_params(w: Weights):
    """The port's `Transformer` over the same tensors (its layout:
    `models/weights.py`); nothing is copied."""
    from repro_torch.models.param import Dense, Norm
    from repro_torch.models.transformer import (MLP, Attention, Block,
                                                Transformer)
    blocks = [Block(Norm(l.norm1),
                    Attention(Dense(l.wq, l.bq), Dense(l.wk, l.bk),
                              Dense(l.wv, l.bv), Dense(l.wo)),
                    Norm(l.norm2),
                    MLP(Dense(l.w1), Dense(l.w2), Dense(l.w3)))
              for l in w.layers]
    return Transformer(w.embed, blocks, Norm(w.final_norm), Dense(w.lm_head))


def make_adapters(m: ModelSpec, plans, gen: torch.Generator,
                  device: torch.device) -> Dict[str, dict]:
    """{uid: {target: {a: (L, d_in, r_pad), b: (L, r_pad, d_out)}}} in
    host memory, zero past each adapter's rank. Drawn on the device a
    (rank, target) at a time, for every adapter of that rank at once."""
    dt, L, r_pad = m.torch_dtype, m.n_layers, m.r_pad
    by_rank: Dict[int, list] = {}
    for p in plans:
        by_rank.setdefault(p.rank, []).append(p.uid)
    out: Dict[str, dict] = {u: {} for p in plans for u in [p.uid]}
    for r in sorted(by_rank):
        uids = by_rank[r]
        n = len(uids)
        for tgt in m.lora_targets:
            d_in, d_out = m.lora_dims(tgt)
            a = torch.zeros((n, L, d_in, r_pad), dtype=dt, device=device)
            b = torch.zeros((n, L, r_pad, d_out), dtype=dt, device=device)
            a[..., :r] = torch.randn((n, L, d_in, r), generator=gen,
                                     dtype=torch.float32, device=device
                                     ).mul_(d_in ** -0.5).to(dt)
            b[:, :, :r] = torch.randn((n, L, r, d_out), generator=gen,
                                      dtype=torch.float32, device=device
                                      ).mul_(r ** -0.5).to(dt)
            a, b = a.cpu(), b.cpu()
            for j, u in enumerate(uids):
                out[u][tgt] = {"a": a[j], "b": b[j]}
    return out
