"""Flash attention (prefill): wrapper of the CUDA kernel in
csrc/flash_attention.cu, which replaces the Pallas TPU kernel
`repro/kernels/flash.py::flash_attention`.

A CPU tensor runs the plain version (`ref.flash_attention_ref`); a CUDA
tensor launches the kernel or raises. `flash_attention.launches` counts
kernel launches. The kernel reads q/k/v through their strides (last dim
contiguous), so a (B, L, H, hd) tensor can be passed as its (B, H, L, hd)
transpose without a copy; the output has q's strides. A head dim that is
no multiple of 8 is passed as zero-padded copies (TMA's rows need 16-byte
strides) and its output is a view of the first hd columns.

Gradients: when q, k or v requires grad (and grad mode is on), the call
goes through `FlashAttention`, a `torch.autograd.Function` whose forward
is the same launch (or plain version) and whose backward is
`flash_attention_backward`, plain PyTorch over blocks of queries. The
reference has no backward kernel either: its training path
differentiates plain attention with XLA (`attn_chunked` under
`jax.checkpoint`), outside any Pallas kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, ref

# head dims the kernel is instantiated for (csrc/flash_attention.cu): 96 is
# phi-3-vision's, 256 recurrentgemma's. Any other hd up to MAX_HEAD_DIM runs
# at the next of these (`padded_width`), its missing columns zero.
HEAD_DIMS = {torch.bfloat16: (32, 64, 96, 128, 256),
             torch.float32: (16, 32, 64, 96, 128, 256)}
MAX_HEAD_DIM = 256             # O: 64 x hd f32 a warpgroup in registers
NOT_SUPPORTED = 801            # cudaErrorNotSupported: no TMA encoder
BQ = 128                       # query rows a bf16 work tile (csrc: kBQ)
MAX_QUERY_TILES = 8192         # of a (head, row) (csrc: kMaxQTiles)


def shape_refusal(hd: int, dtype: torch.dtype) -> Optional[str]:
    """Why the kernel refuses this head dim and dtype, or None."""
    if dtype in HEAD_DIMS and 1 <= hd <= MAX_HEAD_DIM:
        return None
    return (f"the kernel takes hd 1 to {MAX_HEAD_DIM} (its O accumulator, "
            f"64 x hd f32 a warpgroup, must fit in registers) in "
            f"{sorted(map(str, HEAD_DIMS))}, got hd {hd} in {dtype}")


def length_refusal(Lq: int, dtype: torch.dtype) -> Optional[str]:
    """Why the kernel refuses this query length, or None: the bf16 walk's
    order table holds MAX_QUERY_TILES query tiles a (head, row)."""
    if dtype == torch.bfloat16 and Lq > MAX_QUERY_TILES * BQ:
        return (f"the bf16 kernel takes Lq up to {MAX_QUERY_TILES * BQ} "
                f"({MAX_QUERY_TILES} query tiles of {BQ}), got {Lq}")
    return None


def padded_width(hd: int, dtype: torch.dtype) -> int:
    """The instantiated width the kernel runs head dim `hd` at (the
    narrowest of HEAD_DIMS[dtype] >= hd; csrc/flash_attention.cu:
    for_head_dim)."""
    return min(w for w in HEAD_DIMS[dtype] if w >= hd)


def key_tile(hd: int) -> int:
    """Keys a K/V tile of the bf16 kernel at head dim `hd` (csrc: Tile::kBK):
    128 up to width 128, 64 at width 256."""
    return 64 if padded_width(hd, torch.bfloat16) > 128 else 128


def tile_weights(Lq: int, Lk: int, causal: bool, window: Optional[int],
                 bk: int) -> list:
    """The KV tiles each query tile of BQ rows sees (csrc: kv_tiles): keys
    past its last query are causally masked, keys at or before its first
    query less the window are outside every row's window."""
    out = []
    for m in range(-(-Lq // BQ)):
        q0 = m * BQ
        k_hi = min(Lk, q0 + BQ) if causal else Lk
        k_lo = max(0, q0 - window + 1) if window else 0
        out.append(max(0, -(-k_hi // bk) - k_lo // bk))
    return out


def tile_order(Lq: int, Lk: int, causal: bool, window: Optional[int],
               bk: int) -> list:
    """The order of one (head, row)'s query tiles in the bf16 kernel's
    walk, heaviest first (csrc: TileOrder; the card holds this copy equal
    to `rt_flash_attention_order`). The weights first rise (a causal mask)
    and then fall (a window), so two cursors start where the fall begins
    and walk outwards, each step taking the heavier side, the later tile
    on a tie."""
    w = tile_weights(Lq, Lk, causal, window, bk)
    s = len(w) - 1
    while s > 0 and w[s - 1] >= w[s]:
        s -= 1
    lo, hi, out = s - 1, s, []
    for _ in w:
        if lo < 0 or (hi < len(w) and w[hi] >= w[lo]):
            out.append(hi)
            hi += 1
        else:
            out.append(lo)
            lo -= 1
    return out


def persistent_grid(B: int, H: int, Lq: int, sms: int) -> int:
    """Blocks of a bf16 launch (csrc: bf16_launch): one an SM, at most one
    a work tile (query tile, head, row)."""
    return min(-(-Lq // BQ) * H * B, sms)


def work_walks(B: int, H: int, Lq: int, Lk: int, hd: int, causal: bool,
               window: Optional[int], sms: int) -> list:
    """The work tiles (query tile, head, row) each block of a bf16 launch
    takes, in order (csrc: the producer's walk). Position w = (b H + h) nq
    + rank lists each (head, row)'s query tiles in `tile_order`, the
    heads of a row in turn, so the tiles that run at once share a KV
    head's keys in L2. Round k deals positions k G .. k G + G - 1 to the
    G blocks, reversed in odd rounds (a snake), so each block pairs heavy
    ranks with light ones."""
    order = tile_order(Lq, Lk, causal, window, key_tile(hd))
    nq, grid = len(order), persistent_grid(B, H, Lq, sms)
    walks = [[] for _ in range(grid)]
    for w in range(nq * H * B):
        k, i = divmod(w, grid)
        hb = w // nq
        walks[grid - 1 - i if k % 2 else i].append(
            (order[w % nq], hb % H, hb // H))
    return walks


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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal=causal, window=window)


def _forward(q, k, v, *, causal, window):
    """The kernel's launch on a CUDA tensor, the plain version on a CPU
    one."""
    B, H, Lq, hd = q.shape
    KV, Lk = k.shape[1], k.shape[2]
    if not q.is_cuda:
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    why = shape_refusal(hd, q.dtype) or length_refusal(Lq, q.dtype)
    if why:
        raise ValueError(f"flash_attention: {why}")
    cols = -(-hd // 8) * 8
    if cols != hd:
        # TMA's rows need 16-byte strides: one zero-padded copy of each
        # operand (zero columns change no score), the output sliced back
        q, k, v = (torch.nn.functional.pad(t, (0, cols - hd))
                   for t in (q, k, v))
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
    return out if cols == hd else out[..., :hd]


flash_attention.launches = 0


class FlashAttention(torch.autograd.Function):
    """`flash_attention` with gradients in q, k and v. Saves q, k and v
    (the views the caller passed: no copy); the backward recomputes each
    block's scores."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _forward(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        # a named range, so a profile can sum the backward's device time
        with torch.profiler.record_function("flash_attention_backward"):
            dq, dk, dv = flash_attention_backward(
                q, k, v, dout, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention_backward(q, k, v, dout, *, causal=True, window=None,
                             block=512):
    """dq, dk, dv of `flash_attention` for the output gradient `dout`
    (B, H, Lq, hd), in plain PyTorch, accumulating in f32 (f64 for f64
    inputs). Queries are taken `block` at a time, each against the keys
    its causal mask and window can reach: the block's scores are
    recomputed from q and k, its rows' log-sum-exp taken over the valid
    keys, and P, dP = dO V^T and dS = P (dP - rowsum(P dP)) formed, so no
    (B, H, Lq, Lk) tensor exists. rowsum(P dP) is computed from this P
    rather than from the (bf16) output, so the gradient carries no rounding
    of the forward. dk and dv sum over each GQA group's heads. Returns
    gradients in the inputs' dtypes and strides (dense views of the
    (B, L, H, hd) tensors the model passes stay so)."""
    B, H, Lq, hd = q.shape
    KV, Lk = k.shape[1], k.shape[2]
    G = H // KV
    acc = ref.accum_dtype(q.dtype)
    dense = torch.contiguous_format
    scale = hd ** -0.5
    kf = k.to(acc, memory_format=dense)
    vf = v.to(acc, memory_format=dense)
    dq = torch.empty_like(q)
    dk = torch.zeros(B, KV, Lk, hd, dtype=acc, device=q.device)
    dv = torch.zeros_like(dk)
    for s0 in range(0, Lq, block):
        n = min(block, Lq - s0)
        # keys any query of the block may see: kpos > qpos - window, and
        # kpos <= qpos when causal
        lo = 0 if window is None else min(max(0, s0 - window + 1), Lk)
        hi = min(Lk, s0 + n) if causal else Lk
        if hi <= lo:
            dq[:, :, s0:s0 + n] = 0
            continue
        qb = q[:, :, s0:s0 + n].to(acc, memory_format=dense)
        qb = qb.reshape(B, KV, G * n, hd)
        dob = dout[:, :, s0:s0 + n].to(acc, memory_format=dense)
        dob = dob.reshape(B, KV, G * n, hd)
        kb, vb = kf[:, :, lo:hi], vf[:, :, lo:hi]
        qpos = torch.arange(s0, s0 + n, device=q.device)[:, None]
        kpos = torch.arange(lo, hi, device=q.device)[None]
        valid = torch.ones(n, hi - lo, dtype=torch.bool, device=q.device)
        if causal:
            valid &= kpos <= qpos
        if window is not None:
            valid &= qpos - kpos < window
        s = (qb @ kb.transpose(-1, -2)).view(B, KV, G, n, hi - lo) * scale
        s = torch.where(valid, s, ref.NEG_INF)
        m = s.amax(-1, keepdim=True)
        lse = m + torch.log(torch.where(valid, torch.exp(s - m), 0.0)
                            .sum(-1, keepdim=True).clamp(min=1e-30))
        p = torch.where(valid, torch.exp(s - lse), 0.0)
        p = p.view(B, KV, G * n, hi - lo)
        dv[:, :, lo:hi] += p.transpose(-1, -2) @ dob
        dp = dob @ vb.transpose(-1, -2)
        ds = p * (dp - (p * dp).sum(-1, keepdim=True))
        dq[:, :, s0:s0 + n] = ((ds @ kb) * scale).view(
            B, KV, G, n, hd).reshape(B, H, n, hd)
        dk[:, :, lo:hi] += (ds.transpose(-1, -2) @ qb) * scale
    return dq, torch.empty_like(k).copy_(dk), torch.empty_like(v).copy_(dv)
