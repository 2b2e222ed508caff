"""BGMV — batched gathered LoRA matvecs (Punica), pad-to-max rank.

`lora_shrink` / `lora_expand` wrap the two CUDA kernels of csrc/lora.cu,
which replace the Pallas TPU kernels `repro/kernels/bgmv.py::bgmv_shrink`
/ `::bgmv_expand` and, through `live`, their MBGMV counterparts
(kernels/mbgmv.py). A CPU tensor runs the plain version in `ref`; a CUDA
tensor launches the kernel or raises. `lora_shrink.launches` and
`lora_expand.launches` count kernel launches.

    shrink:  y[b]   = x[b] @ A[idx[b]][:, :live[b]]    (rows, d_in) -> f32
    expand:  out[b] = y[b, :live[b]] @ B[idx[b]][:live[b]]
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

_FLOATS = (torch.float32, torch.bfloat16)
SHRINK_THREADS = 1024          # csrc/lora.cu: kShrinkThreads


def _check_rows(name, idx, live, rows):
    if tuple(idx.shape) != (rows,) or tuple(live.shape) != (rows,):
        raise ValueError(f"{name}: idx {tuple(idx.shape)} and live "
                         f"{tuple(live.shape)} must be ({rows},)")


def lora_shrink(x, a, idx, live):
    """x (rows, d_in); a (slots, d_in, r_max); idx, live (rows,) int32 ->
    (rows, r_max) float32."""
    rows, d_in = x.shape
    slots, a_d_in, r_max = a.shape
    if a_d_in != d_in:
        raise ValueError(f"lora_shrink: x {tuple(x.shape)} and a "
                         f"{tuple(a.shape)} disagree on d_in")
    _check_rows("lora_shrink", idx, live, rows)
    if not x.is_cuda:
        return ref.lora_shrink_ref(x, a, idx, live)
    lanes = r_max // 8
    if r_max % 8 or lanes & (lanes - 1) or lanes > SHRINK_THREADS:
        raise ValueError(f"lora_shrink: the kernel takes r_max = 8 x a power "
                         f"of two <= {8 * SHRINK_THREADS}, got {r_max}")
    build.require(x, "x", dtypes=_FLOATS, ndim=2)
    build.require(a, "a", dtypes=(x.dtype,), ndim=3, device=x.device)
    build.require_aligned(a, "a")
    for name, t in (("idx", idx), ("live", live)):
        build.require(t, name, dtypes=(torch.int32,), device=x.device)
    lib = build.library()
    y = torch.empty(rows, r_max, dtype=torch.float32, device=x.device)
    rc = lib.rt_lora_shrink(x.data_ptr(), a.data_ptr(), idx.data_ptr(),
                            live.data_ptr(), y.data_ptr(), rows, d_in, r_max,
                            slots, build.DTYPE_CODE[x.dtype],
                            build.stream_handle(x.device))
    build.check_launch(rc, "lora_shrink")
    lora_shrink.launches += 1
    return y


def lora_expand(y, b, idx, live):
    """y (rows, r_max) in B's dtype; b (slots, r_max, d_out); idx, live
    (rows,) int32 -> (rows, d_out) in B's dtype."""
    rows, r_max = y.shape
    slots, b_r, d_out = b.shape
    if b_r != r_max:
        raise ValueError(f"lora_expand: y {tuple(y.shape)} and b "
                         f"{tuple(b.shape)} disagree on rank")
    if y.dtype != b.dtype:
        raise ValueError(f"lora_expand: y ({y.dtype}) must have b's dtype "
                         f"({b.dtype})")
    _check_rows("lora_expand", idx, live, rows)
    if not y.is_cuda:
        return ref.lora_expand_ref(y, b, idx, live)
    build.require(y, "y", dtypes=_FLOATS, ndim=2)
    build.require(b, "b", dtypes=(y.dtype,), ndim=3, device=y.device)
    for name, t in (("idx", idx), ("live", live)):
        build.require(t, name, dtypes=(torch.int32,), device=y.device)
    lib = build.library()
    out = torch.empty(rows, d_out, dtype=b.dtype, device=y.device)
    rc = lib.rt_lora_expand(y.data_ptr(), b.data_ptr(), idx.data_ptr(),
                            live.data_ptr(), out.data_ptr(), rows, r_max,
                            d_out, slots, build.DTYPE_CODE[y.dtype],
                            build.stream_handle(y.device))
    build.check_launch(rc, "lora_expand")
    lora_expand.launches += 1
    return out


lora_shrink.launches = 0
lora_expand.launches = 0


def bgmv_shrink(x, a_pool, idx):
    return lora_shrink(x, a_pool, idx, ref.bgmv_live(idx, a_pool.shape[-1]))


def bgmv_expand(y, b_pool, idx):
    return lora_expand(y, b_pool, idx, ref.bgmv_live(idx, b_pool.shape[1]))

