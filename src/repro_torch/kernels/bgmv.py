"""BGMV — batched gathered LoRA matvecs (Punica), pad-to-max rank.

`lora_shrink` / `lora_expand` wrap the two CUDA kernels of csrc/lora.cu,
which replace the Pallas TPU kernels `repro/kernels/bgmv.py::bgmv_shrink`
/ `::bgmv_expand` and, through `live`, their MBGMV counterparts
(kernels/mbgmv.py). A CPU tensor runs the plain version in `ref`; a CUDA
tensor launches the kernel or raises. `lora_shrink.launches` and
`lora_expand.launches` count kernel launches.

    shrink:  y[b]   = x[b] @ A[idx[b]][:, :live[b]]    (rows, d_in) -> f32
    expand:  out[b] = y[b, :live[b]] @ B[idx[b]][:live[b]]

The shrink kernel has three launch shapes, chosen here from the row
count, d_in, the dtype and the SM count (`shrink_plan`, no device sync,
so a CUDA graph can capture it): up to DECODE_MAX_ROWS rows (decode) one
block per (distinct slot, DECODE_SHRINK_COLS rank columns, d slice), the
d slices of a (slot, columns) one cluster that adds its partial sums in
rank order; more rows (prefill, chunks, training) in bf16 at a d_in that
is a multiple of 8 go to a persistent kernel (TMA + wgmma), one block an
SM, in clusters of `split` d slices that each walk a contiguous run of
SHRINK_ROWS-row tiles (`shrink_walk`): a producer warp keeps x's boxes
in flight, each with its slot's box of A beside it, and takes a tile's
distinct slots two to a pass (x read once for both); the cluster adds
its blocks' partial sums in rank order (no atomics) while the next tile
loads; f32 and other widths go to the cp.async tiles of 64 or 128 rows, one block per (tile, distinct slot of the tile), `split`
blocks of one cluster sharing a tile where the tiles cannot fill the
card. The expand has three launch
shapes (`expand_plan`): up to DECODE_MAX_ROWS rows one block per (row,
DECODE_EXPAND_COLS output columns); more rows in bf16 at a d_out that is
a multiple of 8 go to a persistent kernel (TMA + wgmma) whose blocks walk
contiguous runs of EXPAND_ROWS x 64- or 128-column tiles (`expand_walk`),
one pass a distinct slot of a tile, and store each tile by TMA while the
next one is computed: its output is most of its bytes, and the stores
that drain under the work keep the stream going; f32 and other widths go
to the mma.sync tiles of EXPAND_ROWS rows x EXPAND_COLS columns, each block
walking every n-th tile of its columns. The decode shrink groups the
rows by slot, so a slot's A is read once for all its rows. Both decode
kernels are launched with programmatic dependent launch: each may start
while the kernel before it finishes (the shrink lets the expand start
once its loads are done, and the expand prefetches B into L2 before it
waits for y). The decode and wgmma expands also take the shrink's f32 y
and round each value to B's dtype as they load it, which `y.to(b.dtype)`
would give, so the pair runs without a cast between its launches (the
mma.sync tiles take y in B's dtype: the wrapper casts for them).

Gradients: when an operand requires grad (and grad mode is on), each
wrapper goes through its `torch.autograd.Function` (`LoRAShrink`,
`LoRAExpand`), whose forward is the same launch. The backward of a
gathered matvec is a gathered matvec, so the data gradients run the
port's own kernels on transposed, contiguous operands: the shrink's dx is
the expand of dy over A^T (slots, r_max, d_in), the expand's dy the
shrink of dout over B^T (slots, d_out, r_max). The weight gradients
dA[s] = sum over the rows of slot s of x^T dy, and dB[s] likewise, are
f32 matmuls, one a slot, as XLA computes them outside any Pallas kernel
in the reference; only each row's live columns count, and idx -1 rows
add nothing.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional

import torch

from repro_torch.kernels import build, ref

_FLOATS = (torch.float32, torch.bfloat16)
RANK_ALIGN = 8                 # r_max: a multiple of this (16-byte rows)
MAX_R = 8 * 1024               # ... up to this
DECODE_MAX_ROWS = 64           # csrc/lora.cu: kDecRows, decode path
DECODE_SHRINK_COLS = 16        # csrc/lora.cu: kDCols, rank columns a block
DECODE_SLICE_D = 128           # a decode shrink block's d slice: >= this
DECODE_EXPAND_COLS = 256       # csrc/lora.cu: kDecCols, columns a block
RANK_SPLIT = 8                 # csrc/lora.cu: kRankSplit, warps a block
TILE_ROWS = (64, 128)          # csrc/lora.cu: the cp.async tile kernel's rows
SHRINK_ROWS = 64               # csrc/lora.cu: kSM, the wgmma shrink's rows
SHRINK_EXCHANGE = 6            # a cluster's reduction, in a block's stages
MAX_TILE_SPLIT = 8             # csrc/lora.cu: kMaxTileSplit (a cluster)
TILE_D = 64                    # csrc/lora.cu: kWD, d a TMA box
MIN_SLICE_D = 256              # a row-tile block's d slice: >= 4 boxes
# {split: clusters of `split` blocks of the persistent wgmma shrink one
# H100 80GB HBM3 holds at once}, as `cluster_room` reads it there: what
# the CPU's models of a launch plan with
H100_CLUSTER_ROOM = {1: 132, 2: 66, 4: 30, 8: 15}
EXPAND_ROWS = 64               # csrc/lora.cu: kEM / kXM, rows a tile
EXPAND_COLS = 256              # csrc/lora.cu: kEN, an mma.sync block's
EXPAND_TILE_COLS = (64, 128)   # csrc/lora.cu: the wgmma kernel's BN
EXPAND_BLOCKS_PER_SM = 2       # row-tile blocks an SM holds (both kernels)


class ShrinkPlan(NamedTuple):
    """The shrink kernel's launch, `grid` blocks in all. Row-tile path in
    bf16 at a d_in that is a multiple of 8 (`per_tile` 0): the persistent
    wgmma kernel, in clusters of `split` (block `part` of a cluster
    reducing d in [part * d_chunk, (part + 1) * d_chunk)), each cluster
    walking a run of tiles of `tile` rows (`shrink_walk`) and, within a
    tile, a pass per two distinct slots. Other row tiles (f32, other
    widths): the cp.async tile kernel, tiles of `tile` rows, `per_tile` blocks a
    tile's slots (block k takes the tile's k-th distinct slot) times
    `split` blocks (one cluster) over d_chunk-wide slices of d_in. Decode
    path (tile 0): `per_tile` blocks for the rows' distinct slots (block k
    takes the k-th) times `split` blocks (one cluster, block p reducing d
    in [p * d_chunk, (p + 1) * d_chunk)) for each of the col_groups(r_max)
    groups of DECODE_SHRINK_COLS rank columns."""
    tile: int
    per_tile: int
    grid: int
    d_chunk: int
    split: int


def col_groups(r_max: int) -> int:
    """The decode shrink's groups of DECODE_SHRINK_COLS rank columns."""
    return -(-r_max // DECODE_SHRINK_COLS)


def shrink_plan(rows: int, d_in: int, slots: int, sms: int, r_max: int,
                dtype: torch.dtype, room: Mapping[int, int]) -> ShrinkPlan:
    """Up to DECODE_MAX_ROWS rows, the decode path: a row tile holding
    many slots would stream each slot's A through one SM, and the earlier
    decode kernel's cluster a row read each slot's A once a row. The
    decode blocks cover the card from (slot, column group, d slice): the
    most of 1, 2, 4 or 8 d slices (a portable cluster) that give each at
    least DECODE_SLICE_D of d (one bf16 stage), each d_chunk a whole
    number of 16-wide k-steps; one block a distinct slot the rows can hold
    (min(slots, rows): the slots in use are not known without a device
    sync; blocks past them return at once). The block's threads are fixed
    (128, kDThr): the earlier kernel took 512 threads at 16 rows or fewer
    and 256 above, more loads in flight for a handful of rows; a decode
    block keeps its whole slice of A in flight from its shared-memory ring
    instead (four stages of 128 d: all 512 of d_in 4,096 at split 8).

    Above it in bf16 at a d_in that is a multiple of 8 (TMA's 16-byte
    strides), the persistent wgmma kernel: SHRINK_ROWS-row tiles, one
    block an SM, clusters of `split` d slices (1, 2, 4 or 8, each at least
    MIN_SLICE_D wide past 1), as many clusters as the card holds at once
    (`room[split]`: `cluster_room` on the card, H100_CLUSTER_ROOM in the
    CPU's models) and no more than the tiles. A
    block's time is its tiles (ceil(tiles / clusters)) times its stages
    (d_chunk / TILE_D) and its tile's reduction: SHRINK_EXCHANGE stages
    where a cluster adds its blocks' partial sums over distributed shared
    memory, one where the block holds the whole of d. The plan takes the
    split of the least, the smaller on a tie. On the H100 (`kernel_ab.py
    --sweep`) a stage took ~0.35 us a block and a cluster's reduction
    ~2 us, so the training step's 4,096 rows of one slot run as 64
    clusters of 2, the yi-9b chunk's 512 rows as 8 clusters of 8 and the
    32,768-row prefill as 132 blocks of the whole of d, 4 tiles each. The
    slots a tile holds are not known without a device sync, so the plan
    counts one pass a tile.

    Otherwise (f32, other widths) the cp.async tile kernel: tiles of 128
    rows where they alone fill every SM (`sms`), else of 64; then the most
    of 1, 2, 4 or 8 blocks a tile (a cluster, each over a d slice of whole
    TILE_D boxes of at least MIN_SLICE_D) that give no SM a second block,
    counting one working slot a tile: at two blocks an SM the H100 holds
    only 30 clusters of 8 at once. Launches of more tiles than half the
    SMs keep one block a tile."""
    if rows <= DECODE_MAX_ROWS:
        split = 1
        while (split < MAX_TILE_SPLIT
               and 2 * split * DECODE_SLICE_D <= d_in):
            split *= 2
        d_chunk = -(-(-(-d_in // split)) // 16) * 16
        per = max(1, min(slots, rows))
        return ShrinkPlan(0, per, per * split * col_groups(r_max), d_chunk,
                          split)
    if dtype == torch.bfloat16 and d_in % 8 == 0:
        tiles = -(-rows // SHRINK_ROWS)
        best = None
        split = 1
        while split <= MAX_TILE_SPLIT and (
                split == 1 or d_in >= 2 * split * MIN_SLICE_D):
            d_chunk = -(-(-(-d_in // split)) // TILE_D) * TILE_D
            nk = d_chunk // TILE_D
            clusters = max(1, min(room[split], tiles))
            cost = -(-tiles // clusters) * (
                nk + (SHRINK_EXCHANGE if split > 1 else 1))
            if best is None or cost < best[0]:
                best = (cost, ShrinkPlan(SHRINK_ROWS, 0, clusters * split,
                                         d_chunk, split))
            split *= 2
        return best[1]
    big = TILE_ROWS[1]
    tile = big if -(-rows // big) >= sms else TILE_ROWS[0]
    tiles = -(-rows // tile)
    split = 1
    while (split < MAX_TILE_SPLIT and 2 * tiles * split <= sms
           and d_in >= 2 * split * MIN_SLICE_D):
        split *= 2
    d_chunk = -(-(-(-d_in // split)) // TILE_D) * TILE_D
    per_tile = max(1, min(slots, tile))
    return ShrinkPlan(tile, per_tile, tiles * per_tile * split, d_chunk,
                      split)


def shrink_walk(rows: int, plan: ShrinkPlan):
    """The persistent shrink's tiles, cluster by cluster, as their first
    rows in the order each cluster takes them (csrc/lora.cu:
    lora_shrink_wgmma_kernel): cluster c of G = grid / split takes the T
    tiles [T c // G, T (c + 1) // G)."""
    tiles = -(-rows // plan.tile)
    g = plan.grid // plan.split
    return [[t * plan.tile for t in range(tiles * c // g,
                                          tiles * (c + 1) // g)]
            for c in range(g)]


class ExpandPlan(NamedTuple):
    """The expand kernel's launch. `cols` 0 and `grid` 0: the decode
    path; `cols` 0 and `grid` > 0: the mma.sync row tiles, `grid` blocks a
    column tile of EXPAND_COLS; `cols` 64 or 128: the persistent wgmma
    kernel, `grid` blocks in all walking tiles of EXPAND_ROWS rows x
    `cols` columns (`expand_walk`)."""
    grid: int
    cols: int


def expand_plan(rows: int, d_out: int, sms: int,
                dtype: torch.dtype) -> ExpandPlan:
    """The expand kernel's launch for B of `dtype`. Up to DECODE_MAX_ROWS
    rows the decode path, one block per (row, DECODE_EXPAND_COLS output
    columns), live rank row r taken by warp r % RANK_SPLIT: a row tile
    would visit each row's slot in turn on one block; a block per
    (columns, distinct slot) read each slot's B once but measured slower
    at 32 and 64 rows on the H100 (its grouping and y's load after it
    cost two more round trips than re-reading B from L2). Up to 16 rows
    (csrc/lora.cu: kDecEarlyRows) the block issues its first 8 rank rows
    of B before it loads y; past it y is loaded first and B a rank row a
    loop step at 32 registers, eight blocks an SM (one wave of 1,024
    blocks at 64 rows).
    More rows in bf16 at a d_out that is a multiple of 8 (TMA's 16-byte
    strides): the persistent wgmma kernel, EXPAND_BLOCKS_PER_SM blocks an
    SM, tiles of EXPAND_ROWS rows x 128 columns where they give every
    block one, else x 64 (the yi-9b chunk's 512 rows: 512 tiles of 64
    columns at d_out 4,096, 64 at its k / v's 512), min(tiles,
    EXPAND_BLOCKS_PER_SM x `sms`) blocks, each a contiguous run of the
    tiles (`expand_walk`). Its output
    is most of its bytes and leaves by TMA stores that drain under the
    next tiles' work: the H100 takes such a stream at 2.5-2.8 TB/s
    (PERF.md, `kernel_ab.py --expand-probe`), where the mma.sync blocks, which
    stored a tile before computing the next, reached 1.5.
    Otherwise (f32, other widths) the mma.sync row tiles of EXPAND_ROWS rows x
    EXPAND_COLS columns, block k of a column tile taking the tiles k, k +
    blocks, ...: as many blocks as fill every SM (`sms`)
    EXPAND_BLOCKS_PER_SM times in one round (at least one, at most one a
    tile)."""
    if rows <= DECODE_MAX_ROWS:
        return ExpandPlan(0, 0)
    tiles = -(-rows // EXPAND_ROWS)
    if dtype == torch.bfloat16 and d_out % 8 == 0:
        wide = EXPAND_TILE_COLS[1]
        cols = wide if tiles * -(-d_out // wide) >= \
            EXPAND_BLOCKS_PER_SM * sms else EXPAND_TILE_COLS[0]
        return ExpandPlan(min(tiles * -(-d_out // cols),
                              EXPAND_BLOCKS_PER_SM * sms), cols)
    col_blocks = -(-d_out // EXPAND_COLS)
    return ExpandPlan(max(1, min(tiles, EXPAND_BLOCKS_PER_SM * sms
                                 // col_blocks)), 0)


def expand_walk(rows: int, d_out: int, plan: ExpandPlan):
    """The wgmma expand's tiles, block by block, as (first row, first
    column) in the order each block takes them (csrc/lora.cu:
    lora_expand_wgmma_kernel): the T tiles numbered column tile by column
    tile, block b taking [T b // grid, T (b + 1) // grid)."""
    row_tiles = -(-rows // EXPAND_ROWS)
    total = row_tiles * -(-d_out // plan.cols)
    return [[(w % row_tiles * EXPAND_ROWS, w // row_tiles * plan.cols)
             for w in range(total * b // plan.grid,
                            total * (b + 1) // plan.grid)]
            for b in range(plan.grid)]


def padded_rank(max_rank: int) -> int:
    """The rank columns of a pool that holds adapters of up to `max_rank`:
    the next multiple of RANK_ALIGN, so any max_rank runs on the kernels.
    The columns past an adapter's rank are zero, which changes no delta."""
    return -(-max_rank // RANK_ALIGN) * RANK_ALIGN


def _rank_refusal(r_max: int) -> Optional[str]:
    if r_max % RANK_ALIGN or not 0 < r_max <= MAX_R:
        return (f"the kernel takes r_max a multiple of {RANK_ALIGN} up to "
                f"{MAX_R} (16-byte rows of A, y and B; the pool pads it), "
                f"got {r_max}")
    return None


def shrink_refusal(d_in: int, r_max: int) -> Optional[str]:
    """Why the shrink kernel refuses these widths, or None: any d_in (a
    width no multiple of 8 takes element copies of x), r_max as
    `padded_rank` makes it."""
    return _rank_refusal(r_max)


def expand_refusal(r_max: int, d_out: int) -> Optional[str]:
    """Why the expand kernel refuses these widths, or None: any d_out (a
    width no multiple of 8 takes element copies of B and stores of out),
    r_max as `padded_rank` makes it."""
    return _rank_refusal(r_max)


_SMS: dict = {}
_ROOM: dict = {}


def sm_count(device: torch.device) -> int:
    """The card's SM count (cached: the plan is computed per call)."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def cluster_room(device: torch.device) -> Dict[int, int]:
    """{split: clusters of `split` blocks of the persistent wgmma shrink
    the card holds at once} (cudaOccupancyMaxActiveClusters, through
    rt_lora_shrink_info; at split 1 its blocks an SM times the SMs),
    cached: a launch of more clusters would run in two waves."""
    if device not in _ROOM:
        import ctypes
        lib = build.library()
        out = (ctypes.c_longlong * len(build.INFO_FIELDS))()
        room = {}
        for split in (1, 2, 4, 8):
            d_in = 2 * split * MIN_SLICE_D
            with torch.cuda.device(device):
                build.check_launch(lib.rt_lora_shrink_info(
                    DECODE_MAX_ROWS + 1, d_in, RANK_ALIGN, 1, SHRINK_ROWS,
                    d_in // split, split, split,
                    build.DTYPE_CODE[torch.bfloat16], out),
                    "lora_shrink: cluster_room")
            info = dict(zip(build.INFO_FIELDS, out))
            room[split] = (info["blocks_per_sm"] * sm_count(device)
                           if split == 1 else info["max_clusters"])
            if room[split] <= 0:
                raise RuntimeError(f"lora_shrink: the card holds no "
                                   f"cluster of {split} ({room[split]})")
        _ROOM[device] = room
    return _ROOM[device]


def _check_rows(name, idx, live, rows):
    if tuple(idx.shape) != (rows,) or tuple(live.shape) != (rows,):
        raise ValueError(f"{name}: idx {tuple(idx.shape)} and live "
                         f"{tuple(live.shape)} must be ({rows},)")


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def lora_shrink(x, a, idx, live):
    """x (rows, d_in); a (slots, d_in, r_max); idx, live (rows,) int32 ->
    (rows, r_max) float32."""
    rows, d_in = x.shape
    if a.shape[1] != d_in:
        raise ValueError(f"lora_shrink: x {tuple(x.shape)} and a "
                         f"{tuple(a.shape)} disagree on d_in")
    _check_rows("lora_shrink", idx, live, rows)
    if _needs_grad(x, a):
        return LoRAShrink.apply(x, a, idx, live)
    return _shrink(x, a, idx, live)


def _shrink(x, a, idx, live):
    """The shrink kernel's launch on a CUDA tensor, the plain version on a
    CPU one."""
    rows, d_in = x.shape
    slots, _, r_max = a.shape
    if not x.is_cuda:
        return ref.lora_shrink_ref(x, a, idx, live)
    why = shrink_refusal(d_in, r_max)
    if why:
        raise ValueError(f"lora_shrink: {why}")
    build.require(x, "x", dtypes=_FLOATS, ndim=2)
    build.require(a, "a", dtypes=(x.dtype,), ndim=3, device=x.device)
    if d_in % 8 == 0:         # 16-byte copies; other widths copy elements
        build.require_aligned(x, "x")
    build.require_aligned(a, "a")
    for name, t in (("idx", idx), ("live", live)):
        build.require(t, name, dtypes=(torch.int32,), device=x.device)
    lib = build.library()
    plan = shrink_plan(rows, d_in, slots, sm_count(x.device), r_max,
                       x.dtype, cluster_room(x.device))
    y = torch.empty(rows, r_max, dtype=torch.float32, device=x.device)
    rc = lib.rt_lora_shrink(x.data_ptr(), a.data_ptr(), idx.data_ptr(),
                            live.data_ptr(), y.data_ptr(), rows, d_in, r_max,
                            slots, plan.tile, plan.d_chunk, plan.split,
                            plan.grid, build.DTYPE_CODE[x.dtype],
                            build.stream_handle(x.device))
    build.check_launch(rc, "lora_shrink")
    lora_shrink.launches += 1
    return y


def lora_expand(y, b, idx, live):
    """y (rows, r_max) in B's dtype, or float32 (each value then rounded to
    B's dtype first, as `y.to(b.dtype)` rounds it: the decode and wgmma
    kernels round as they load); b (slots, r_max, d_out); idx, live
    (rows,) int32 -> (rows, d_out) in B's dtype."""
    rows, r_max = y.shape
    slots, b_r, d_out = b.shape
    if b_r != r_max:
        raise ValueError(f"lora_expand: y {tuple(y.shape)} and b "
                         f"{tuple(b.shape)} disagree on rank")
    if y.dtype not in (b.dtype, torch.float32):
        raise ValueError(f"lora_expand: y ({y.dtype}) must have b's dtype "
                         f"({b.dtype}) or float32")
    _check_rows("lora_expand", idx, live, rows)
    if _needs_grad(y, b):
        return LoRAExpand.apply(y.to(b.dtype), b, idx, live)
    return _expand(y, b, idx, live)


def _expand(y, b, idx, live):
    """The expand kernel's launch on a CUDA tensor, the plain version on a
    CPU one."""
    rows, r_max = y.shape
    slots, _, d_out = b.shape
    if not y.is_cuda:
        return ref.lora_expand_ref(y.to(b.dtype), b, idx, live)
    why = expand_refusal(r_max, d_out)
    if why:
        raise ValueError(f"lora_expand: {why}")
    plan = expand_plan(rows, d_out, sm_count(y.device), b.dtype)
    if plan.grid and not plan.cols and y.dtype != b.dtype:
        y = y.to(b.dtype)         # the mma.sync tiles take y in B's dtype
    build.require(b, "b", dtypes=_FLOATS, ndim=3, device=y.device)
    build.require(y, "y", dtypes=(b.dtype, torch.float32), ndim=2)
    build.require_aligned(y, "y")
    if d_out % 8 == 0:        # 16-byte copies; other widths copy elements
        build.require_aligned(b, "b")
    for name, t in (("idx", idx), ("live", live)):
        build.require(t, name, dtypes=(torch.int32,), device=y.device)
    lib = build.library()
    out = torch.empty(rows, d_out, dtype=b.dtype, device=y.device)
    rc = lib.rt_lora_expand(y.data_ptr(), b.data_ptr(), idx.data_ptr(),
                            live.data_ptr(), out.data_ptr(), rows, r_max,
                            d_out, slots, plan.grid, plan.cols,
                            build.DTYPE_CODE[b.dtype],
                            build.DTYPE_CODE[y.dtype],
                            build.stream_handle(y.device))
    build.check_launch(rc, "lora_expand")
    lora_expand.launches += 1
    return out


lora_shrink.launches = 0
lora_expand.launches = 0


def _slot_masks(idx, slots):
    """(slots, rows, 1) bool: row b belongs to slot s (idx -1: to none)."""
    return (idx[None] == torch.arange(slots, device=idx.device)[:, None]
            )[..., None]


class LoRAShrink(torch.autograd.Function):
    """`lora_shrink` with gradients in x and A."""

    @staticmethod
    def forward(ctx, x, a, idx, live):
        ctx.save_for_backward(x, a, idx, live)
        return _shrink(x, a, idx, live)

    @staticmethod
    def backward(ctx, dy):
        x, a, idx, live = ctx.saved_tensors
        dx = da = None
        if ctx.needs_input_grad[0]:
            # dx[b] = dy[b, :live] A[idx[b]][:, :live]^T: the expand over A^T
            dx = lora_expand(dy.to(x.dtype), a.transpose(1, 2).contiguous(),
                             idx, live)
        if ctx.needs_input_grad[1]:
            acc = ref.accum_dtype(x.dtype)
            g = torch.where(ref.live_mask(live, a.shape[-1]), dy.to(acc),
                            0.0)
            xt = x.to(acc).t()
            da = torch.stack([xt @ torch.where(m, g, 0.0) for m in
                              _slot_masks(idx, a.shape[0])]).to(a.dtype)
        return dx, da, None, None


class LoRAExpand(torch.autograd.Function):
    """`lora_expand` with gradients in y and B."""

    @staticmethod
    def forward(ctx, y, b, idx, live):
        ctx.save_for_backward(y, b, idx, live)
        return _expand(y, b, idx, live)

    @staticmethod
    def backward(ctx, dout):
        y, b, idx, live = ctx.saved_tensors
        dout = dout.contiguous()
        dy = db = None
        if ctx.needs_input_grad[0]:
            # dy[b, :live] = dout[b] B[idx[b]][:live]^T: the shrink over B^T
            dy = lora_shrink(dout, b.transpose(1, 2).contiguous(), idx,
                             live).to(y.dtype)
        if ctx.needs_input_grad[1]:
            acc = ref.accum_dtype(b.dtype)
            yk = torch.where(ref.live_mask(live, b.shape[1]), y.to(acc),
                             0.0)
            g = dout.to(acc)
            db = torch.stack([torch.where(m, yk, 0.0).t() @ g for m in
                              _slot_masks(idx, b.shape[0])]).to(b.dtype)
        return dy, db, None, None


def bgmv_shrink(x, a_pool, idx):
    return lora_shrink(x, a_pool, idx, ref.bgmv_live(idx, a_pool.shape[-1]))


def bgmv_expand(y, b_pool, idx):
    return lora_expand(y, b_pool, idx, ref.bgmv_live(idx, b_pool.shape[1]))

