"""Public entry points of the kernels. The tensor's device decides the
path: a CPU tensor runs the plain PyTorch version, a CUDA tensor the
hand-written CUDA kernel (or the call raises — there is no fallback)."""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.bgmv import lora_expand, lora_shrink
from repro_torch.kernels.paged import paged_attention

__all__ = ["lora_delta", "lora_live", "paged_attention"]


def lora_live(idx, ranks=None, mode="bgmv", r_max=None, rank_block=16):
    """Live rank columns per row: all r_max under "bgmv" (max-rank law),
    each adapter's rank rounded up to whole rank blocks under "mbgmv"
    (sum-rank law). A model step computes this once for all its layers."""
    if mode == "bgmv":
        return ref.bgmv_live(idx, r_max)
    if mode == "mbgmv":
        if ranks is None:
            raise ValueError("mode='mbgmv' needs per-slot ranks")
        if r_max % rank_block:
            raise ValueError(f"r_max ({r_max}) must be a multiple of "
                             f"rank_block ({rank_block})")
        return ref.mbgmv_live(idx, ranks, rank_block)
    raise ValueError(f"unknown LoRA kernel mode {mode!r}")


def lora_delta(x, a, b, idx, ranks=None, mode="bgmv", rank_block=16,
               live=None):
    """Batched heterogeneous-rank LoRA delta. x (rows, d_in);
    a (slots, d_in, r_max); b (slots, r_max, d_out); idx (rows,) int32 slot
    per row (-1 = no adapter -> zero row). mode "bgmv" computes all r_max
    columns (max-rank law), "mbgmv" only each adapter's live rank blocks
    (sum-rank law); the pool is zero-padded past each rank, so both give
    the same numbers. `live`: a precomputed `lora_live`. The f32 shrink is
    cast to x's dtype before the expand, as the reference's kernels do.
    Returns (rows, d_out) in x's dtype."""
    if live is None:
        live = lora_live(idx, ranks, mode, a.shape[-1], rank_block)
    y = lora_shrink(x, a, idx, live)
    return lora_expand(y.to(x.dtype), b, idx, live)
