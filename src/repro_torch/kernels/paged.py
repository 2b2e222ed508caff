"""Paged decode attention: wrapper of the CUDA kernel in
csrc/paged_attention.cu, which replaces the Pallas TPU kernel
`repro/kernels/paged.py::paged_attention`.

A CPU tensor runs the plain version (`ref.paged_attention_ref`); a CUDA
tensor launches the kernel or raises. `paged_attention.launches` counts
kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

_FLOATS = (torch.float32, torch.bfloat16)


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
    if (H // KV) * hd > 1024 or hd % 8:
        raise ValueError(f"paged_attention: the kernel takes GQA group x hd "
                         f"<= 1024 and hd % 8 == 0, got group {H // KV}, "
                         f"hd {hd}")
    build.require(q, "q", dtypes=_FLOATS, ndim=3)
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        build.require(t, name, dtypes=(q.dtype,), ndim=4, device=q.device)
    for name, t in (("pos_pages", pos_pages), ("block_table", block_table),
                    ("pos", pos)):
        build.require(t, name, dtypes=(torch.int32,), device=q.device)
    build.require_aligned(k_pages, "k_pages")
    build.require_aligned(v_pages, "v_pages")
    lib = build.library()
    out = torch.empty_like(q)
    rc = lib.rt_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        pos_pages.data_ptr(), block_table.data_ptr(), pos.data_ptr(),
        out.data_ptr(), B, H, KV, P, ps, hd, W, build.DTYPE_CODE[q.dtype],
        build.stream_handle(q.device))
    build.check_launch(rc, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
