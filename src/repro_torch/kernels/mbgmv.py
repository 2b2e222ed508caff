"""MBGMV — rank-block-skip LoRA delta (S-LoRA's sum-rank law).

Runs the same two CUDA kernels as BGMV (kernels/bgmv.py) with
`live[b] = ceil(rank[idx[b]] / rank_block) * rank_block`, so only the live
rank blocks are read and computed and dead blocks are exactly zero — the
function of the Pallas TPU kernels `repro/kernels/mbgmv.py::mbgmv_shrink`
/ `::mbgmv_expand`.
"""
from __future__ import annotations

from repro_torch.kernels.bgmv import lora_expand, lora_shrink
from repro_torch.kernels.ops import lora_live

RANK_BLOCK = 16


def mbgmv_shrink(x, a_pool, idx, ranks, *, rank_block=RANK_BLOCK):
    if tuple(ranks.shape) != (a_pool.shape[0],):
        raise ValueError(f"mbgmv_shrink: ranks {tuple(ranks.shape)} must be "
                         f"({a_pool.shape[0]},) to match a_pool")
    return lora_shrink(x, a_pool, idx, lora_live(
        idx, ranks, "mbgmv", a_pool.shape[-1], rank_block))


def mbgmv_expand(y, b_pool, idx, ranks, *, rank_block=RANK_BLOCK):
    if tuple(ranks.shape) != (b_pool.shape[0],):
        raise ValueError(f"mbgmv_expand: ranks {tuple(ranks.shape)} must be "
                         f"({b_pool.shape[0]},) to match b_pool")
    return lora_expand(y, b_pool, idx, lora_live(
        idx, ranks, "mbgmv", b_pool.shape[1], rank_block))

