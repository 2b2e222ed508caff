"""Public entry points of the kernels. The tensor's device decides the
path: a CPU tensor runs the plain PyTorch version, a CUDA tensor the
hand-written CUDA kernel (or the call raises — there is no fallback).

`attention_op`, `lora_shrink_op` and `lora_expand_op` are the kernels'
entry points as torch custom ops (`torch.ops.repro_torch.*`) with fake
implementations and FLOP formulas, so a trace without a device (the dry
run's `FakeTensorMode`) gets their shapes and counts their work as the
kernels do it; the model calls them only inside its distributed regions
(`sharding.local_call`).
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import ref
from repro_torch.kernels.bgmv import lora_expand, lora_shrink
from repro_torch.kernels.flash import flash_attention, \
    flash_attention_backward
from repro_torch.kernels.paged import paged_attention

__all__ = ["attention", "lora_delta", "lora_live", "paged_attention"]


def attention(q, k, v, causal=True, window=None):
    """Prefill attention. q (B, H, Lq, hd); k/v (B, KV, Lk, hd) ->
    (B, H, Lq, hd); query i sits at position i, as key i."""
    return flash_attention(q, k, v, causal=causal, window=window)


def lora_live(idx, ranks=None, mode="bgmv", r_max=None, rank_block=16):
    """Live rank columns per row: all r_max under "bgmv" (max-rank law),
    each adapter's rank rounded up to whole rank blocks, at most r_max,
    under "mbgmv" (sum-rank law; a pool padded to a multiple of 8 need not
    hold whole rank blocks, as the reference's masked delta does not). A
    model step computes this once for all its layers."""
    if mode == "bgmv":
        return ref.bgmv_live(idx, r_max)
    if mode == "mbgmv":
        if ranks is None:
            raise ValueError("mode='mbgmv' needs per-slot ranks")
        return ref.mbgmv_live(idx, ranks, rank_block).clamp(max=r_max)
    raise ValueError(f"unknown LoRA kernel mode {mode!r}")


def lora_delta(x, a, b, idx, ranks=None, mode="bgmv", rank_block=16,
               live=None):
    """Batched heterogeneous-rank LoRA delta. x (rows, d_in);
    a (slots, d_in, r_max); b (slots, r_max, d_out); idx (rows,) int32 slot
    per row (-1 = no adapter -> zero row). mode "bgmv" computes all r_max
    columns (max-rank law), "mbgmv" only each adapter's live rank blocks
    (sum-rank law); the pool is zero-padded past each rank, so both give
    the same numbers. `live`: a precomputed `lora_live`. The f32 shrink is
    rounded to x's (the pool's) dtype before the expand, as the
    reference's kernels do: the expand takes it in f32 and rounds it (the
    decode and wgmma kernels as they load it, with no launch between the
    two).
    Returns (rows, d_out) in x's dtype."""
    if live is None:
        live = lora_live(idx, ranks, mode, a.shape[-1], rank_block)
    y = lora_shrink(x, a, idx, live)
    return lora_expand(y if b.dtype == x.dtype else y.to(x.dtype), b, idx,
                       live)


# ----------------------------------------------- custom ops, for tracing ----

@torch.library.custom_op(
    "repro_torch::attention", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, bool causal, SymInt? window)"
           " -> Tensor")
def attention_op(q, k, v, causal, window):
    """`attention` as a custom op, differentiable (its backward is
    `attention_bwd_op`)."""
    return flash_attention(q, k, v, causal=causal, window=window)


@torch.library.custom_op(
    "repro_torch::attention_bwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor dout, bool causal, "
           "SymInt? window) -> (Tensor, Tensor, Tensor)")
def attention_bwd_op(q, k, v, dout, causal, window):
    return flash_attention_backward(q, k, v, dout, causal=causal,
                                    window=window)


@attention_op.register_fake
def _(q, k, v, causal, window):
    return torch.empty_like(q)


@attention_bwd_op.register_fake
def _(q, k, v, dout, causal, window):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _attention_setup(ctx, inputs, output):
    q, k, v, causal, window = inputs
    ctx.save_for_backward(q, k, v)
    ctx.causal, ctx.window = causal, window


def _attention_backward(ctx, dout):
    q, k, v = ctx.saved_tensors
    return (*attention_bwd_op(q, k, v, dout, ctx.causal, ctx.window), None,
            None)


attention_op.register_autograd(_attention_backward,
                               setup_context=_attention_setup)


def _keys_per_query(lq, lk, causal, window):
    """Mean keys a query attends: all, about half under a causal mask,
    at most `window`."""
    n = (lk + 1) / 2 if causal and lq == lk else lk
    return min(n, window) if window else n


@register_flop_formula(torch.ops.repro_torch.attention)
def _(q_shape, k_shape, v_shape, causal, window, out_shape=None, **kw):
    B, H, Lq, hd = q_shape
    return int(4 * B * H * Lq * hd * _keys_per_query(Lq, k_shape[2], causal,
                                                      window))


@register_flop_formula(torch.ops.repro_torch.attention_bwd)
def _(q_shape, k_shape, v_shape, dout_shape, causal, window, out_shape=None,
      **kw):
    B, H, Lq, hd = q_shape          # recomputed scores, dV, dP, dQ, dK
    return int(10 * B * H * Lq * hd * _keys_per_query(
        Lq, k_shape[2], causal, window))


@torch.library.custom_op(
    "repro_torch::lora_shrink", mutates_args=(),
    schema="(Tensor x, Tensor a, Tensor idx, Tensor live) -> Tensor")
def lora_shrink_op(x, a, idx, live):
    """The LoRA shrink (`bgmv.lora_shrink`) as a custom op."""
    return lora_shrink(x, a, idx, live)


@torch.library.custom_op(
    "repro_torch::lora_expand", mutates_args=(),
    schema="(Tensor y, Tensor b, Tensor idx, Tensor live) -> Tensor")
def lora_expand_op(y, b, idx, live):
    """The LoRA expand (`bgmv.lora_expand`) as a custom op."""
    return lora_expand(y, b, idx, live)


@lora_shrink_op.register_fake
def _(x, a, idx, live):
    return x.new_empty(x.shape[0], a.shape[-1], dtype=torch.float32)


@lora_expand_op.register_fake
def _(y, b, idx, live):
    return y.new_empty(y.shape[0], b.shape[-1], dtype=b.dtype)


# every row adapted at the pool's full rank: the max-rank law's work
@register_flop_formula(torch.ops.repro_torch.lora_shrink)
def _(x_shape, a_shape, idx_shape, live_shape, out_shape=None, **kw):
    return 2 * x_shape[0] * x_shape[1] * a_shape[-1]


@register_flop_formula(torch.ops.repro_torch.lora_expand)
def _(y_shape, b_shape, idx_shape, live_shape, out_shape=None, **kw):
    return 2 * y_shape[0] * y_shape[1] * b_shape[-1]
