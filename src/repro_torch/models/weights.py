"""The port's model state: seeded random init on the device, and the
bridge from the reference's parameter tree.

Both paths first make the reference's value tree with torch tensors as
leaves, one entry a layer (the reference stacks the layers of its
uniform stacks on a leading axis), and `_build` turns that tree into the
family's modules. `init_params` draws every weight from one seeded
`torch.Generator` on the target device (the full-width model is built on
the card, where no JAX exists), at the reference's scales. The draws
differ from `jax.random`'s, so parity tests go through `params_from_jax`,
which takes the reference's value tree
(`repro.models.param.split(init_params(...))[0]`, every leaf turned into
numpy by the caller) and copies it leaf for leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.lora import is_adapter_tree, pad_adapter
from repro_torch.device import resolve_device
from repro_torch.models import encdec, rglru, ssm
from repro_torch.models.moe import MoE
from repro_torch.models.moe_ep import ep_factors
from repro_torch.models.param import Box, Dense, Norm, split
from repro_torch.models.transformer import (MLP, Attention, Block,
                                            Transformer, _check_family,
                                            hybrid_layer_kinds)
from repro_torch.training.optim import AdamWState

# leaves the reference keeps in float32 whatever the model's dtype
F32_LEAVES = ("a_log", "dt_bias", "d_skip", "lam")


# -------------------------------------------------------------- modules ----

def _dense(t):
    return Dense(t["w"], t.get("b"))


def _norm(t):
    return Norm(t["scale"], t.get("bias"))


def _attn(t):
    return Attention(*(_dense(t[n]) for n in ("wq", "wk", "wv", "wo")))


def _mlp(t):
    return MLP(_dense(t["w1"]), _dense(t["w2"]),
               _dense(t["w3"]) if "w3" in t else None)


def _block(t):
    ffn = MoE(_dense(t["moe"]["router"]),
              *(_dense(t["moe"][n]) for n in ("w1", "w2", "w3"))) \
        if "moe" in t else _mlp(t["mlp"])
    return Block(_norm(t["norm1"]), _attn(t["attn"]), _norm(t["norm2"]),
                 ffn)


def _rglru_block(t):
    return rglru.RGLRUBlock(_norm(t["norm"]), _dense(t["w_x"]),
                            _dense(t["w_gate"]), t["conv_w"], t["conv_b"],
                            _dense(t["w_a"]), _dense(t["w_i"]), t["lam"],
                            _dense(t["w_out"]))


def _ssm_block(t):
    return ssm.SSMBlock(_norm(t["norm"]), _dense(t["in_proj"]), t["conv_w"],
                        t["conv_b"], t["a_log"], t["dt_bias"], t["d_skip"],
                        _norm(t["gate_norm"]), _dense(t["out_proj"]))


def _build(cfg, tree):
    """The reference's value tree (torch leaves, one dict a layer) -> the
    family's modules."""
    if cfg.family in ("audio", "encdec"):
        return encdec.EncDec(
            tree["enc_pos"],
            [encdec.EncBlock(_norm(b["norm1"]), _attn(b["attn"]),
                             _norm(b["norm2"]), _mlp(b["mlp"]))
             for b in tree["enc_blocks"]],
            _norm(tree["enc_norm"]), tree["embed"], tree["dec_pos"],
            [encdec.DecBlock(_norm(b["norm1"]), _attn(b["attn"]),
                             _norm(b["norm_x"]), _attn(b["xattn"]),
                             _norm(b["norm2"]), _mlp(b["mlp"]))
             for b in tree["dec_blocks"]],
            _norm(tree["final_norm"]), _dense(tree["lm_head"]))
    if cfg.family == "ssm":
        blocks = [_ssm_block(b) for b in tree["blocks"]]
    elif cfg.hybrid:
        blocks = [_rglru_block(b) if kind == "rglru" else _block(b)
                  for kind, b in zip(hybrid_layer_kinds(cfg),
                                     tree["blocks"])]
    else:
        blocks = [_block(b) for b in tree["blocks"]]
    head = _dense(tree["lm_head"]) if "lm_head" in tree else None
    return Transformer(tree["embed"], blocks, _norm(tree["final_norm"]),
                       head)


# ---------------------------------------------------------- random init ----

def init_params(cfg, seed: int = 0, device=None):
    """Random weights at the reference's scales, drawn on `device`
    (None: the card)."""
    _check_family(cfg)
    dev = resolve_device(device)
    return _build(cfg, split(init_tree(cfg, seed, dev))[0])


def init_tree(cfg, seed: int, dev: torch.device):
    """The reference's init tree in the port's layout: every leaf a
    `Box` of its value and its logical axes (the reference's, with the
    leading "layers" axis of a uniform stack dropped, since the port lists
    the layers). On the "meta" device the values are shapes only."""
    meta = dev.type == "meta"
    g = None if meta else torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.torch_dtype
    d = cfg.d_model
    ew = "embed_fsdp" if cfg.fsdp_weights else "embed"

    def normal(shape, scale, axes, dtype=dt):
        return Box(torch.randn(shape, generator=g, device=dev,
                               dtype=dtype).mul_(scale), axes)

    def full(shape, value, axes, dtype=dt):
        return Box(torch.full(shape, value, device=dev, dtype=dtype), axes)

    def dense(d_in, d_out, axes, bias=False):
        p = {"w": normal((d_in, d_out), d_in ** -0.5, axes)}
        if bias:
            p["b"] = full((d_out,), 0.0, axes[-1:])
        return p

    def norm(n, kind=cfg.norm):
        p = {"scale": full((n,), 1.0, ("embed",))}
        if kind == "layernorm":
            p["bias"] = full((n,), 0.0, ("embed",))
        return p

    def attn():
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        t = {n: {"w": normal((d, nh, hd), d ** -0.5, (
            ew, "kv_heads" if nh == KV and nh != H else "heads", None))}
            for n, nh in (("wq", H), ("wk", KV), ("wv", KV))}
        t["wo"] = {"w": normal((H, hd, d), (H * hd) ** -0.5,
                               ("heads", None, ew))}
        if cfg.qkv_bias:
            for n, nh in (("wq", H), ("wk", KV), ("wv", KV)):
                t[n]["b"] = full((nh, hd), 0.0, ("heads", None))
        return t

    def ffn():
        f = cfg.d_ff
        gated = cfg.mlp_act in ("silu", "geglu")
        if not cfg.moe:
            t = {"w1": dense(d, f, (ew, "mlp")), "w2": dense(f, d, ("mlp", ew))}
            if gated:
                t["w3"] = dense(d, f, (ew, "mlp"))
            return t
        E = cfg.moe.n_experts
        if cfg.moe_ep:
            # the EP-native layout, (E*s, d, f/s): s f-slices an expert
            # over the expert-parallel width (`moe_ep.ep_factors`)
            s, _ = ep_factors(E, cfg.moe_ep_shards)
            E, f_in, f_out = E * s, f // s, f
            ax1, ax2 = ("experts_ep", None, "mlp"), ("experts_ep", "mlp", None)
        else:
            f_in = f_out = f
            ax1, ax2 = (("experts", None, "mlp_fsdp"),
                        ("experts", "mlp_fsdp", None)) if cfg.moe_2d_ff \
                else (("experts", ew, "mlp"), ("experts", "mlp", ew))
        return {"router": dense(d, cfg.moe.n_experts, ("embed", None)),
                "w1": {"w": normal((E, d, f_in), d ** -0.5, ax1)},
                "w2": {"w": normal((E, f_in, d), f_out ** -0.5, ax2)},
                "w3": {"w": normal((E, d, f_in), d ** -0.5, ax1)}}

    def block():
        t = {"norm1": norm(d), "norm2": norm(d), "attn": attn()}
        t["moe" if cfg.moe else "mlp"] = ffn()
        return t

    def rglru_block():
        w = cfg.hybrid.lru_width or d
        return {"norm": norm(d), "w_x": dense(d, w, ("embed", "mlp")),
                "w_gate": dense(d, w, ("embed", "mlp")),
                "conv_w": normal((4, w), 0.3, (None, "mlp")),
                "conv_b": full((w,), 0.0, ("mlp",)),
                "w_a": dense(w, w, ("mlp", None), bias=True),
                "w_i": dense(w, w, ("mlp", None), bias=True),
                "lam": Box(torch.linspace(0.5, 4.0, w, device=dev), (None,)),
                "w_out": dense(w, d, ("mlp", "embed"))}

    def ssm_block():
        s = cfg.ssm
        d_in, H, conv_dim, in_total = ssm.ssm_dims(cfg)
        f32 = torch.float32
        return {"norm": norm(d), "in_proj": dense(d, in_total, ("embed", "mlp")),
                "conv_w": normal((s.conv_width, conv_dim), 0.3, (None, "mlp")),
                "conv_b": full((conv_dim,), 0.0, ("mlp",)),
                "a_log": Box(torch.log(torch.linspace(1.0, 16.0, H,
                                                      device=dev)), (None,)),
                "dt_bias": full((H,), 0.0, (None,), f32),
                "d_skip": full((H,), 1.0, (None,), f32),
                "gate_norm": norm(d_in, "rmsnorm"),
                "out_proj": dense(d_in, d, ("mlp", "embed"))}

    if cfg.family in ("audio", "encdec"):
        return {
            "enc_pos": normal((cfg.enc_seq, d), 0.02, ("seq", "embed")),
            "enc_blocks": [{"norm1": norm(d), "attn": attn(),
                            "norm2": norm(d), "mlp": ffn()}
                           for _ in range(cfg.n_enc_layers)],
            "enc_norm": norm(d),
            "embed": normal((cfg.vocab, d), 0.02, ("vocab", "embed")),
            "dec_pos": normal((cfg.max_ctx, d), 0.02, ("seq", "embed")),
            "dec_blocks": [{"norm1": norm(d), "attn": attn(),
                            "norm_x": norm(d), "xattn": attn(),
                            "norm2": norm(d), "mlp": ffn()}
                           for _ in range(cfg.n_layers)],
            "final_norm": norm(d), "lm_head": dense(d, cfg.vocab, (ew, "vocab"))}
    tree = {"embed": normal((cfg.vocab, d), 0.02, ("vocab", "embed"))}
    if not cfg.tie_embeddings and cfg.family != "ssm":
        tree["lm_head"] = dense(d, cfg.vocab, (ew, "vocab"))
    if cfg.family == "ssm":
        tree["blocks"] = [ssm_block() for _ in range(cfg.n_layers)]
    elif cfg.hybrid:
        tree["blocks"] = [rglru_block() if kind == "rglru" else block()
                          for kind in hybrid_layer_kinds(cfg)]
    else:
        tree["blocks"] = [block() for _ in range(cfg.n_layers)]
    tree["final_norm"] = norm(d)
    return tree


# ------------------------------------------------------ from the reference ----

def params_from_jax(cfg, tree, device=None):
    """The reference's parameter value tree (numpy leaves; the blocks of a
    uniform stack on a leading layer axis, a hybrid's or enc-dec's as a
    list) -> the port's modules on `device` (None: the card)."""
    _check_family(cfg)
    dev = resolve_device(device)

    def conv(x, name=""):
        if isinstance(x, dict):
            return {k: conv(v, k) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v, name) for v in x]
        dtype = torch.float32 if name in F32_LEAVES else cfg.torch_dtype
        return torch.from_numpy(np.array(x, np.float32)).to(dev, dtype)

    return _build(cfg, conv(unstack_layers(cfg, tree)))


def adapter_from_jax(cfg, tree, device=None):
    """The reference's trainable adapter ({target: {a: (L, d_in, r_max),
    b: (L, r_max, d_out)}}, numpy leaves) -> the port's, in the config's
    dtype on `device` (None: the card), its rank axis padded to
    `padded_rank(max_rank)` with zeros (`core.lora.pad_adapter`)."""
    dev = resolve_device(device)
    return pad_adapter(cfg, {t: {n: torch.from_numpy(
        np.array(x, np.float32)).to(dev, cfg.torch_dtype)
        for n, x in ab.items()} for t, ab in tree.items()})


def opt_state_from_jax(cfg, state, device=None):
    """The reference's `AdamWState` (step, mu, nu; numpy leaves) -> the
    port's `training.optim.AdamWState`, the moments in their own dtype
    (float32, or bfloat16 with `moments_dtype="bfloat16"`) on `device`
    (None: the card). Moments of an adapter keep its tree; moments of the
    model's parameters take the port's layout, a uniform stack's layers
    as a list (`params_from_jax`), so they line up with
    `training.tree.param_tree`; moments of an adapter are padded as the
    adapter (`adapter_from_jax`)."""
    dev = resolve_device(device)
    step, mu, nu = state

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        dt = torch.bfloat16 if str(np.asarray(x).dtype) == "bfloat16" \
            else torch.float32
        return torch.from_numpy(np.array(x, np.float32)).to(dev, dt)

    def layout(tree):
        if is_adapter_tree(cfg, tree):
            return pad_adapter(cfg, conv(tree))
        return conv(unstack_layers(cfg, tree))

    return AdamWState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=dev),
        mu=layout(mu), nu=layout(nu))


def unstack_layers(cfg, tree):
    """A params-shaped tree in the reference's layout (a uniform stack's
    layers on a leading axis of each leaf) -> the port's (a list of
    layers, each leaf indexed, no copies). A hybrid's or enc-dec's layers
    are a list in both, and pass as they are."""
    if not isinstance(tree.get("blocks"), dict):
        return tree
    return dict(tree, blocks=[_index(tree["blocks"], i)
                              for i in range(cfg.n_layers)])


def stack_layers(cfg, tree):
    """The inverse of `unstack_layers`: a uniform stack's list of layers
    stacked leaf by leaf on a leading axis (a copy), as the reference
    holds it."""
    blocks = tree.get("blocks")
    if cfg.hybrid or not isinstance(blocks, list):
        return tree
    return dict(tree, blocks=_stack(blocks))


def _stack(layers):
    if isinstance(layers[0], dict):
        return {k: _stack([t[k] for t in layers]) for k in layers[0]}
    return torch.stack(layers)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]
