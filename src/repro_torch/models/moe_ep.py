"""Expert-parallel MoE: tokens travel to the ranks that own their experts
and back with two all-to-alls over the mesh's data axes. Mirrors
`repro.models.moe_ep`; plain PyTorch and NCCL (gloo on the CPU) on every
device, as the reference is plain `jnp` and XLA collectives.

Shard layout over n_data = the product of the data axes' sizes (built by
`shard_expert_weights`):
  * n_data >= E (production: grok's 8 experts on 16, dbrx's 16 on 16):
    each expert's d_ff is cut into s = n_data / E slices; shard j owns
    slice j % s of expert j // s. Tokens go to all s slices of their
    expert and the partial outputs (w2 contracts over the f-slice) sum on
    the way back.
  * n_data < E: each shard owns E / n_data whole experts.
Within a shard the f-slice is further cut over the `model` axis; the
partial outputs are summed over it.

`moe_apply_ep` runs the per-rank body under `local_map` (the counterpart
of `shard_map`) on DTensors, or on plain tensors that every rank holds
whole (taken as replicated). It is differentiable: the all-to-alls are
`all_to_all_single_autograd`, and the model-axis sum is a Function whose
backward passes the (replicated) gradient through, beside an identity
whose backward sums the gradient of the tokens entering the f-sliced
experts over the model axis, so every gradient comes out with its input's
layout (the router's summed over the data axes).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import gate_act
from repro_torch.sharding import (as_dtensor, enter_sliced, group_of,
                                  is_dtensor, mesh_axis_sizes, sum_over)


def ep_factors(E: int, n_data: int):
    """(s_factor, e_per_shard): f-slices per expert, experts per shard."""
    if n_data >= E:
        if n_data % E:
            raise ValueError(f"n_data ({n_data}) not a multiple of E ({E})")
        return n_data // E, 1
    if E % n_data:
        raise ValueError(f"E ({E}) not a multiple of n_data ({n_data})")
    return 1, E // n_data


def shard_expert_weights(cfg, p, n_data: int) -> dict:
    """A MoE layer's weights (`models.moe.MoE`, the global layout (E, d,
    f) / (E, f, d) or the EP-native one) -> {"router", "w1", "w2", "w3"}
    tensors in the EP layout: (E*s, d, f/s) / (E*s, f/s, d). Views of the
    weights when they are EP-native already."""
    E = cfg.moe.n_experts
    s, _ = ep_factors(E, n_data)
    fs = cfg.d_ff // s
    w1, w2, w3 = p.w1.w, p.w2.w, p.w3.w
    out = {"router": p.router.w, "w1": w1, "w2": w2, "w3": w3}
    if w1.shape[0] == E * s and w1.shape[2] == fs:
        return out                              # already EP-native

    def win(w):                                 # (E, d, f) -> (E*s, d, f/s)
        E_, d_, _ = w.shape
        return w.reshape(E_, d_, s, fs).transpose(1, 2).reshape(E_ * s, d_,
                                                                fs)

    out.update(w1=win(w1), w3=win(w3),
               w2=w2.reshape(E * s, fs, w2.shape[-1]))
    return out


def moe_apply_ep(cfg, p, x, mesh, *, data_axes=("data",), need_aux=True):
    """x (B, T, d) -> (y (B, T, d), aux or None without `need_aux`), the
    reference's `moe_apply_ep` on a `DeviceMesh` named ("pod",) "data"
    (, "model"). Each data shard routes its B*T / n_data tokens with its
    own capacity; with a capacity at which nothing drops this is
    `moe.moe_apply`. x and the weights are DTensors on `mesh`, or plain
    tensors every rank holds whole (y then comes back whole too)."""
    import torch.distributed._functional_collectives as fc
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    B, T, d = x.shape
    E, top_k = cfg.moe.n_experts, cfg.moe.top_k
    cf = cfg.moe.capacity_factor
    sizes = mesh_axis_sizes(mesh)
    n_data = 1
    for a in data_axes:
        n_data *= sizes.get(a, 1)
    s_factor, e_per = ep_factors(E, n_data)
    n_shards = n_data
    tokens = B * T
    if tokens % n_data:
        raise ValueError(f"B*T ({tokens}) must divide over the data axis "
                         f"({n_data} shards)")
    t_loc = tokens // n_data
    cap = max(-(-t_loc * top_k * int(cf * 4) // (4 * E)), top_k)
    cap = -(-cap // 4) * 4
    pe = shard_expert_weights(cfg, p, n_data)
    dgroup = group_of(mesh, data_axes)
    mgroup = mesh.get_group("model") if "model" in sizes else None

    def local(x_loc, wr, w1, w2, w3):
        # x_loc (t_loc, d); w1/w3 (e_per, d, f_loc); w2 (e_per, f_loc, d)
        probs = torch.softmax((x_loc @ wr.to(x_loc.dtype)).float(), -1)
        gate_vals, gate_idx = moe_mod.top_k(probs, top_k)      # (t, k)
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(
            min=1e-9)
        onehot = F.one_hot(gate_idx, E)                          # (t, k, E)
        oh = onehot.reshape(t_loc * top_k, E)
        pos = ((oh.cumsum(0) - oh) * oh).sum(-1).reshape(t_loc, top_k)
        keep = pos < cap

        # scatter into (n_shards * e_per * cap + 1, d): the last row is the
        # sink of dropped assignments, never sent. Under s_factor > 1 an
        # assignment goes to each of its expert's s f-slices.
        e_flat, p_flat = gate_idx.reshape(-1), pos.reshape(-1)
        kept = keep.reshape(-1)
        sink = n_shards * e_per * cap
        x_rep = x_loc.repeat_interleave(top_k, dim=0)
        slots = []
        for r in range(s_factor):
            shard = e_flat * s_factor + r if e_per == 1 else e_flat // e_per
            ew = 0 if e_per == 1 else e_flat % e_per
            slots.append((shard, ew))
            idx = torch.where(kept, (shard * e_per + ew) * cap + p_flat,
                              sink)
            buf = x_loc.new_zeros(sink + 1, d).index_add(0, idx, x_rep) \
                if r == 0 else buf.index_add(0, idx, x_rep)
        buf = buf[:sink]

        recv = fc.all_to_all_single_autograd(buf, None, None, dgroup)
        recv = fc.wait_tensor(recv)
        # recv row block j: the tokens source shard j sent to this shard
        xin = recv.reshape(n_shards, e_per, cap, d).transpose(0, 1) \
            .reshape(e_per, n_shards * cap, d)
        if mgroup is not None:
            xin = enter_sliced(xin, mgroup)
        h = gate_act(cfg, torch.bmm(xin, w1), torch.bmm(xin, w3))
        out = torch.bmm(h, w2)                                   # f-partial
        if mgroup is not None:
            out = sum_over(out, mgroup)
        out = out.reshape(e_per, n_shards, cap, d).transpose(0, 1) \
            .reshape(n_shards * e_per * cap, d)
        back = fc.wait_tensor(
            fc.all_to_all_single_autograd(out, None, None, dgroup))
        back = back.reshape(n_shards, e_per, cap, d)

        # combine: sum the s_factor f-slice partials, weighted by the gates
        safe_p = p_flat.clamp(max=cap - 1)
        contrib = sum(back[shard, ew, safe_p] for shard, ew in slots)
        w = (keep * gate_vals).to(contrib.dtype)
        y = (contrib.reshape(t_loc, top_k, d) * w[..., None]).sum(1)
        if not need_aux:
            return y
        # load-balance aux: the local estimate, averaged over the data
        # shards (equal on every model rank already)
        frac = onehot.sum((0, 1)).float() / (t_loc * top_k)
        aux = E * (frac * probs.mean(0)).sum()
        return y, sum_over(aux, dgroup, 1.0 / n_data)

    names = mesh.mesh_dim_names
    rep = [Replicate()] * mesh.ndim

    def pl(data_dim=None, model_dim=None, data=None):
        out = list(rep)
        for i, n in enumerate(names):
            if n in data_axes and (data_dim is not None or data is not None):
                out[i] = data if data is not None else Shard(data_dim)
            elif n == "model" and model_dim is not None:
                out[i] = Shard(model_dim)
        return out

    fn = local_map(
        local,
        out_placements=(pl(0), rep) if need_aux else pl(0),
        in_placements=(pl(0), rep, pl(0, 2), pl(0, 1), pl(0, 2)),
        in_grad_placements=(pl(0), pl(data=Partial()), pl(0, 2), pl(0, 1),
                            pl(0, 2)),
        device_mesh=mesh, redistribute_inputs=True)
    args = [as_dtensor(t, mesh) for t in
            (x.reshape(tokens, d), pe["router"], pe["w1"], pe["w2"],
             pe["w3"])]
    y, aux = fn(*args) if need_aux else (fn(*args), None)
    if is_dtensor(x):
        return y.reshape(B, T, d), aux
    return y.full_tensor().reshape(B, T, d), \
        None if aux is None else aux.full_tensor()
