"""Paged decode attention: wrapper of the CUDA kernel in
csrc/paged_attention.cu, which replaces the Pallas TPU kernel
`repro/kernels/paged.py::paged_attention`.

A CPU tensor runs the plain version (`ref.paged_attention_ref`); a CUDA
tensor launches the kernel or raises. `paged_attention.launches` counts
kernel launches (one a call; with more than one split the call also
launches the kernel's combine pass).

Two kernels, chosen by `route` from shapes alone: the group kernel (bf16
at GQA groups 2 to GROUP_MAX_G: one block holds a KV head's whole group
as the M rows of tensor-core products) and the lane kernel (MHA, f32,
larger groups: lanes of 8 columns a head, a group too large for one
block cut into `group_tiles` tiles). Both split each row's block table
over `split_plan` blocks, chosen here from shapes alone (no device sync).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.bgmv import sm_count

_FLOATS = (torch.float32, torch.bfloat16)
SPLIT_PAGES = 4                # block-table columns a split at least
MAX_SPLIT_BLOCKS_PER_SM = 8    # blocks of all splits, an SM at most
MAX_THREADS = 256              # csrc/paged_attention.cu: kMaxThreads
MAX_HEAD_DIM = 256             # csrc/paged_attention.cu: kMaxHeadDim
GROUP_MAX_G = 128              # csrc/paged_attention.cu: kGroupMaxG
ROUTES = ("lanes", "group")    # rt_paged_attention_route's codes


def fits(G: int, hd: int) -> bool:
    """The kernel's shape rule, `rt_paged_attention_fits` of
    csrc/paged_attention.cu, for the CPU (the wrapper asks the library; the
    card checks hold the two equal over a grid of G and hd): any GQA group
    (cut into `group_tiles` tiles) and any hd up to MAX_HEAD_DIM, where a
    head's lanes of 8 columns still fit one warp."""
    return G >= 1 and 1 <= hd <= MAX_HEAD_DIM


def shape_refusal(G: int, hd: int) -> Optional[str]:
    """Why the kernel refuses GQA group G at head dim hd, or None."""
    if fits(G, hd):
        return None
    return (f"the kernel takes GQA group >= 1 and hd 1 to {MAX_HEAD_DIM} "
            f"(a head's score is summed over pow2(hd / 8) lanes of one "
            f"32-lane warp), got group {G}, hd {hd}")


def route(G: int, hd: int, dtype: torch.dtype) -> int:
    """The kernel the wrapper launches, `rt_paged_attention_route` of
    csrc/paged_attention.cu for the CPU (the card checks hold the two
    equal over a grid of G, hd and dtype): 1 (ROUTES: "group") for bf16 at
    GQA groups 2 to GROUP_MAX_G, 0 ("lanes") for MHA, f32 and larger
    groups; -1 where the kernels refuse."""
    if not fits(G, hd) or dtype not in _FLOATS:
        return -1
    return int(dtype == torch.bfloat16 and 2 <= G <= GROUP_MAX_G)


def launch_tiles(G: int, hd: int, dtype: torch.dtype) -> int:
    """Blocks a KV head takes along the group: the lane kernel's
    `group_tiles`, one on the group route."""
    return 1 if route(G, hd, dtype) == 1 else group_tiles(G, hd)


def group_tiles(G: int, hd: int) -> int:
    """Tiles a KV head's G query heads are cut into, as
    `rt_paged_attention_tiles` of csrc/paged_attention.cu cuts them: a
    block holds MAX_THREADS threads, one per (head, 8 columns of hd
    rounded up to a power of two), so one tile (one block a KV head)
    where G x pow2(ceil(hd / 8)) <= MAX_THREADS, else as few as hold the
    group. Each tile reads its KV head's pages again."""
    lanes = 1
    while lanes < -(-hd // 8):
        lanes *= 2
    return -(-G // (MAX_THREADS // lanes))


def split_plan(B: int, KV: int, W: int, sms: int, tiles: int) -> int:
    """Runs of block-table columns a row is split into: one when the
    B x KV x `tiles` blocks (group tiles a KV head) fill every SM (`sms`)
    already; else runs of SPLIT_PAGES columns, so that a long row spreads
    over many SMs whichever rows are long (blocks whose run holds no
    claimed page exit at once), capped at MAX_SPLIT_BLOCKS_PER_SM blocks
    an SM, and no split left empty (the kernel gives split k the columns
    [k * ceil(W / n), (k + 1) * ceil(W / n)))."""
    blocks = B * KV * tiles
    if blocks >= sms or W < 2 * SPLIT_PAGES:
        return 1
    n = min(MAX_SPLIT_BLOCKS_PER_SM * sms // max(1, blocks),
            W // SPLIT_PAGES)
    per = -(-W // n)
    return -(-W // per)


def paged_attention(q, k_pages, v_pages, pos_pages, block_table, pos):
    """q (B, H, hd); k/v_pages (P, KV, ps, hd); pos_pages (P, ps) int32;
    block_table (B, W) int32, -1 = unclaimed; pos (B,) int32 -> (B, H, hd)
    in q's dtype."""
    B, H, hd = q.shape
    P, KV, ps = k_pages.shape[0], k_pages.shape[1], k_pages.shape[2]
    W = block_table.shape[1]
    if H % KV:
        raise ValueError(f"paged_attention: H ({H}) not divisible by KV "
                         f"({KV}) — q {tuple(q.shape)} vs k_pages "
                         f"{tuple(k_pages.shape)}")
    if k_pages.shape != v_pages.shape or k_pages.shape[3] != hd:
        raise ValueError(f"paged_attention: k_pages {tuple(k_pages.shape)}, "
                         f"v_pages {tuple(v_pages.shape)} and q "
                         f"{tuple(q.shape)} disagree")
    if tuple(pos_pages.shape) != (P, ps):
        raise ValueError(f"paged_attention: pos_pages "
                         f"{tuple(pos_pages.shape)} must be ({P}, {ps}) to "
                         f"match k_pages {tuple(k_pages.shape)}")
    if block_table.shape[0] != B or tuple(pos.shape) != (B,):
        raise ValueError(f"paged_attention: block_table "
                         f"{tuple(block_table.shape)} / pos "
                         f"{tuple(pos.shape)} must lead with batch {B}")
    if not q.is_cuda:
        return ref.paged_attention_ref(q, k_pages, v_pages, pos_pages,
                                       block_table, pos)
    lib = build.library()
    if not lib.rt_paged_attention_fits(H // KV, hd):
        raise ValueError(
            f"paged_attention: {shape_refusal(H // KV, hd) or 'refused'}")
    G = H // KV
    build.require(q, "q", dtypes=_FLOATS, ndim=3)
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        build.require(t, name, dtypes=(q.dtype,), ndim=4, device=q.device)
    for name, t in (("pos_pages", pos_pages), ("block_table", block_table),
                    ("pos", pos)):
        build.require(t, name, dtypes=(torch.int32,), device=q.device)
    if hd % 8 == 0:           # 16-byte copies; other widths copy elements
        for name, t in (("q", q), ("k_pages", k_pages),
                        ("v_pages", v_pages)):
            build.require_aligned(t, name)
    out = torch.empty_like(q)
    nsplit = split_plan(B, KV, W, sm_count(q.device),
                        launch_tiles(G, hd, q.dtype))
    # per split: (m, l, acc) of each query head, combined by the kernel
    ws = torch.empty(B * H * nsplit * (hd + 2) if nsplit > 1 else 0,
                     dtype=torch.float32, device=q.device)
    rc = lib.rt_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        pos_pages.data_ptr(), block_table.data_ptr(), pos.data_ptr(),
        out.data_ptr(), ws.data_ptr() if nsplit > 1 else None, B, H, KV, P,
        ps, hd, W, nsplit, build.DTYPE_CODE[q.dtype],
        build.stream_handle(q.device))
    build.check_launch(rc, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
