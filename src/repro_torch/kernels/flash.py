"""Flash attention (prefill): wrapper of the CUDA kernel in
csrc/flash_attention.cu, which replaces the Pallas TPU kernel
`repro/kernels/flash.py::flash_attention`.

A CPU tensor runs the plain version (`ref.flash_attention_ref`); a CUDA
tensor launches the kernel or raises. `flash_attention.launches` counts
kernel launches. The kernel reads q/k/v through their strides (last dim
contiguous), so a (B, L, H, hd) tensor can be passed as its (B, H, L, hd)
transpose without a copy; the output has q's strides.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

# head dims the kernel is instantiated for (csrc/flash_attention.cu): 96 is
# phi-3-vision's, 256 recurrentgemma's
HEAD_DIMS = {torch.bfloat16: (32, 64, 96, 128, 256),
             torch.float32: (16, 32, 64, 96, 128, 256)}
NOT_SUPPORTED = 801            # cudaErrorNotSupported: no TMA encoder


def _require_strided(t, name, dtype, device):
    """The kernels read rows of hd contiguous elements by TMA (bf16) or in
    16-byte vectors (f32): a 16-byte-aligned base and strides that are
    multiples of 8 elements."""
    build.require(t, name, dtypes=(dtype,), ndim=4, device=device,
                  contiguous=False)
    if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]):
        raise ValueError(f"{name} must have a contiguous last dim and "
                         f"strides that are multiples of 8, got "
                         f"{t.stride()}")
    build.require_aligned(t, name)


def flash_attention(q, k, v, *, causal=True, window=None):
    """q (B, H, Lq, hd); k/v (B, KV, Lk, hd) -> (B, H, Lq, hd) in q's dtype.
    Query i sits at position i, as key i; GQA maps head h to KV head
    h // (H / KV); `window`: keys with qpos - kpos >= window are masked."""
    B, H, Lq, hd = q.shape
    KV, Lk = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(f"flash_attention: H ({H}) not divisible by KV "
                         f"({KV}) — q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)}")
    if k.shape != v.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} != v "
                         f"{tuple(v.shape)}")
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree on batch or head dim")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got "
                         f"{window}")
    if not q.is_cuda:
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if hd not in HEAD_DIMS.get(q.dtype, ()):
        raise ValueError(f"flash_attention: the kernel takes hd in "
                         f"{HEAD_DIMS.get(q.dtype, ())} for {q.dtype}, got "
                         f"{hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require_strided(t, name, q.dtype, q.device)
    lib = build.library()
    out = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    rc = lib.rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        B, H, KV, Lq, Lk, hd, int(causal), 0 if window is None else window,
        build.DTYPE_CODE[q.dtype], build.stream_handle(q.device))
    if rc == NOT_SUPPORTED:
        raise RuntimeError("flash_attention: the CUDA driver does not "
                           "provide cuTensorMapEncodeTiled (TMA), which the "
                           "bf16 kernel needs")
    build.check_launch(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
