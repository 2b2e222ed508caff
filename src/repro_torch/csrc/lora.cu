// Gathered LoRA shrink and expand (BGMV / MBGMV).
//
// Replace the Pallas TPU kernels src/repro/kernels/bgmv.py::bgmv_shrink,
// ::bgmv_expand (_shrink_kernel, _expand_kernel) and
// src/repro/kernels/mbgmv.py::mbgmv_shrink, ::mbgmv_expand. The four TPU
// kernels become one shrink and one expand that differ only in `live[b]`,
// the number of rank columns computed for row b:
//   BGMV  live[b] = r_max                                (max-rank law)
//   MBGMV live[b] = ceil(rank[idx[b]] / rank_block) * rank_block
//                                                        (sum-rank law)
// Columns at or past live[b] are exactly zero and their weights are never
// read (beyond the 8-column group live[b] ends in); a row with idx[b] < 0
// or >= slots (no adapter) is a zero row and reads nothing.
//
// Bound on the H100: bytes. The shrink does 2 * live flops per element of
// x against ~2 bytes, and each adapter's A (d_in x r_max) is shared by
// every row of that adapter: at yi-9b's prefill (32,768 rows, d_in 4096,
// r_max 64, 8 adapters) x is 268 MB, A 4 MB and y 8 MB, 84 us at
// 3.35 TB/s against 17 us of tensor-core work. Three launch shapes, chosen
// on the host from `rows`, d_in and the SM count (kernels/bgmv.py:
// shrink_plan):
//  - Row tiles (prefill, chunks, training). Tiles of 64 or 128 consecutive
//    rows, one block per (tile, distinct slot of the tile); prefill
//    repeats each row's slot T times, so most tiles hold one slot and
//    their other blocks exit at once. What bounds a launch is how many
//    blocks stream x at once: a block walks its d range one stage after
//    another, so a launch of few tiles (the yi-9b chunk: 8 tiles of one
//    slot; training: 64 tiles of one slot) left most SMs idle while a few
//    walked all of d_in (81-90 us on the H100 against 1.4-10.5 us of
//    bytes). So where the tiles cannot fill the card, `split` blocks of
//    one cluster (2, 4 or 8, as many as give no SM a second block) share
//    a tile, each over a slice of d_in of whole 64-wide stages; each
//    keeps its f32 partial sums in its shared memory, and the cluster
//    adds them in rank order through distributed shared memory (no
//    atomics), each block writing 1 / split of the tile's rows.
//    Launches whose tiles fill the card (the 32,768-row
//    prefill) keep one block a tile. In bf16 (d_in a multiple of 8) a
//    stage costs one thread a TMA copy of x's 64-d slab of the tile and
//    A[s][64 d, 64 columns] into a ring of 4-6 stages (an mbarrier each,
//    96 KiB: 2 blocks an SM) and each warpgroup (64 rows) one wgmma
//    m64n64k16 chain of 4 k-steps, bf16 in, f32 out, added into the f32
//    total on the CUDA cores. Each block of a tile of k slots reads the
//    whole slab, so such a tile reads x k times; runs of at least a
//    tile's rows (prompts of 64 tokens or more in 64-row tiles; on the
//    H100's 132 SMs 128-row tiles come only at 16,769 rows or more) keep
//    k at most 2. f32 and other widths take cp.async copies and mma.sync
//    (bf16) or the CUDA cores (f32). So x is read once and A once per
//    tile, not once per row.
//  - Split d_in (decode, up to 64 rows). A cluster of kSplit blocks per
//    row, each reducing a slice of d_in; rank 0 adds the blocks' partial
//    sums from their shared memory (distributed shared memory) in rank
//    order and writes y, so 8 rows fill 64 SMs instead of 8. A row
//    re-reads its adapter's A from L2, which a handful of rows affords.
//
// The expand is bound by bytes too, and by its output: at yi-9b's prefill
// (d_out 4096) out is 268 MB against 4 MB each of y and B. Two launch
// shapes, chosen on the host from `rows` (kernels/bgmv.py: expand_plan):
//  - Row tiles (prefill, chunks, training). A block owns 256 output
//    columns and walks every row_blocks-th tile of 64 consecutive rows,
//    with the next tile's y and slots loading (cp.async) while it works on
//    the current one. For each distinct slot of a tile (prefill repeats
//    each row's slot T times, so most tiles hold one) it multiplies the
//    tile's y by B[s][:live, 256 columns] on the tensor cores (mma.sync
//    m16n8k16, bf16 in, f32 accumulate; warp tiles of 32 x 64), 64 rank
//    rows a pass, each pass added on the CUDA cores, and casts once into a
//    staged output tile. The B tile stays in shared memory while the slot
//    does not change, so B is read about once per block instead of once
//    per row; every element of out is written by one block, its slot's
//    rows 16 bytes a thread from the staged tile. f32 takes the same tiles
//    on CUDA cores. The output's 32 KB a tile are most of the bytes, and
//    at one slot (training: 4,096 rows x d_out 4,096, 256 blocks over 132
//    SMs) what bounds a launch is that a block's stores of a tile do not
//    overlap its next tile's product: 22-23 us in a CUDA graph on the
//    H100 against 10.3 us of bytes. Writing whole one-slot tiles with TMA
//    bulk stores that drain under the next tile's work measured no faster
//    there, so the one store path stays.
//  - Decode (up to 64 rows). One block per (row, 256 columns): each lane
//    owns 8 columns, read from one rank row of B in a 16-byte load, and
//    the 8 warps split the live rank rows, their partials added in warp
//    order.
// Widths: any d_in and d_out, as the Pallas kernels' _fit_block takes them
// (src/repro/kernels/bgmv.py:40-47). Where d_in (shrink) or d_out (expand)
// is a multiple of 8, x, B and out move 16 bytes at a time; otherwise the
// row-tile and decode kernels are instantiated with element copies and
// stores (kVec false), zero past the width, so a partial k-step of 16 sums
// zeros. The split shrink reads x element by element on either; TMA
// needs 16-byte strides, so only such widths take the wgmma shrink. r_max
// stays a multiple of 8 (the pool pads it: kernels/bgmv.py padded_rank).
// Every sum runs in a fixed order (no atomics): results repeat bitwise.
#include <type_traits>

#include <cooperative_groups.h>

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

// ------------------------------------------------- shrink: split d_in ----

constexpr int kSplit = 8;                // blocks a row: a portable cluster

// y[row, r] for r < live[row]: block `part` of the row's cluster reduces
// d in [part * d_chunk, (part + 1) * d_chunk). Threads are r_max/8 rank
// lanes of 8 columns x (blockDim / lanes) d-groups, a power of two; a
// lane reads its 8 columns of one d row of A in a single 16-byte load, up
// to 8 loads a thread in flight. The d-groups are reduced through shared
// memory by a fixed tree, the blocks by rank 0.
template <typename T>
__global__ void __cluster_dims__(kSplit, 1, 1) lora_shrink_split_kernel(
    const T* __restrict__ x, const T* __restrict__ a,
    const int* __restrict__ idx, const int* __restrict__ live,
    float* __restrict__ y, int d_in, int r_max, int slots, int d_chunk) {
  extern __shared__ float red[];            // ngrp * r_max
  cg::cluster_group cluster = cg::this_cluster();
  const int row = blockIdx.x / kSplit;
  const int part = (int)cluster.block_rank();
  const int lanes = r_max / rt::kVec;
  const int lane = threadIdx.x % lanes, grp = threadIdx.x / lanes;
  const int ngrp = blockDim.x / lanes;      // a power of two
  const int c0 = lane * rt::kVec;
  const int s = idx[row];
  const int lv = (s >= 0 && s < slots) ? min(live[row], r_max) : 0;
  const int d_lo = part * d_chunk, d_hi = min(d_in, d_lo + d_chunk);
  float acc[rt::kVec];
#pragma unroll
  for (int j = 0; j < rt::kVec; ++j) acc[j] = 0.f;
  if (c0 < lv) {
    const T* xr = x + (size_t)row * d_in;
    const T* as = a + (size_t)s * d_in * r_max + c0;
#pragma unroll 8
    for (int d = d_lo + grp; d < d_hi; d += ngrp) {
      const float xv = rt::to_f32(xr[d]);
      float w[rt::kVec];
      rt::load8(as + (size_t)d * r_max, w);
#pragma unroll
      for (int j = 0; j < rt::kVec; ++j) acc[j] += xv * w[j];
    }
  }
  float* mine = red + grp * r_max + c0;
#pragma unroll
  for (int j = 0; j < rt::kVec; ++j) mine[j] = acc[j];
  __syncthreads();
  for (int st = ngrp / 2; st > 0; st >>= 1) {
    if (grp < st) {
      const float* other = red + (grp + st) * r_max + c0;
#pragma unroll
      for (int j = 0; j < rt::kVec; ++j) mine[j] += other[j];
    }
    __syncthreads();
  }
  cluster.sync();                           // every block's red[0:r_max]
  if (part == 0) {
    for (int c = threadIdx.x; c < r_max; c += blockDim.x) {
      float sum = 0.f;
      for (int k = 0; k < kSplit; ++k)
        sum += cluster.map_shared_rank(red, k)[c];
      y[(size_t)row * r_max + c] = c < lv ? sum : 0.f;
    }
  }
  cluster.sync();                           // rank 0 has read them all
}

// -------------------------------------------------- shrink: row tiles ----

constexpr int kCols = 64;                   // rank columns a pass
constexpr int kLdp = kCols + 4;             // a partial's row (f32)
constexpr int kMaxTileSplit = 8;            // blocks a cluster: portable

// The row-tile prologue, shared by both row-tile kernels: each row of the
// tile [row0, row0 + BM) gets its slot (-1: past `rows` or no adapter) in
// sidx and its live width in slive; `k`, the block's y, selects the tile's
// k-th distinct slot, returned in s (-1: the tile has fewer) with its
// rows' widest live width rounded up to 8 in ncol. With `zeros`, the rows
// without an adapter are written as zero rows (the first block of a tile).
// Every block of a cluster shares (tile, k), so they return together.
template <int BM, int kThr>
__device__ __forceinline__ void tile_slot(
    const int* __restrict__ idx, const int* __restrict__ live,
    float* __restrict__ y, int* sidx, int* slive, int* width, int rows,
    int r_max, int slots, int row0, int k, bool zeros, int& s, int& ncol) {
  const int tid = threadIdx.x;
  if (tid < BM) {
    const int r = row0 + tid;
    int sl = -1, lv = 0;
    if (r < rows) {
      sl = idx[r];
      if (sl < 0 || sl >= slots) sl = -1;
      else lv = max(0, min(live[r], r_max));
    }
    sidx[tid] = sl;
    slive[tid] = lv;
  }
  __syncthreads();
  // a slot's first row in the tile holds the widest live width of the
  // slot's rows; every other row -1
  if (tid < BM) {
    const int sl = sidx[tid];
    int w = -1;
    if (sl >= 0) {
      bool first = true;
      for (int u = tid - 1; u >= 0 && first; --u) first = sidx[u] != sl;
      if (first) {
        w = 0;
        for (int u = tid; u < BM; ++u)
          if (sidx[u] == sl) w = max(w, slive[u]);
      }
    }
    width[tid] = w;
  }
  if (zeros) {
    for (int i = tid; i < BM * r_max; i += kThr) {
      const int r = i / r_max;
      if (row0 + r < rows && sidx[r] < 0)
        y[(size_t)(row0 + r) * r_max + i % r_max] = 0.f;
    }
  }
  __syncthreads();
  s = -1;
  ncol = 0;
  for (int u = 0, n = 0; u < BM; ++u) {
    if (width[u] < 0 || n++ != k) continue;                 // uniform
    s = sidx[u];
    ncol = (width[u] + 7) / 8 * 8;
    break;
  }
}

// Barrier of the blocks that share a tile's partial sums: the cluster, or
// the block alone.
__device__ __forceinline__ void split_sync(int split) {
  if (split > 1) cg::this_cluster().sync();
  else __syncthreads();
}

// y[rows of slot s, c0 : c0 + kCols] from the blocks' partial sums of a
// pass (each block's BM x kCols f32 in its own shared memory, row stride
// kLdp, written before the call). Block `part` of the `split` blocks of
// the tile sums and writes rows [part * BM / split, ...) of every block's
// partials in rank order (distributed shared memory, no atomics: the sum
// repeats bitwise), 4 columns a thread; columns at or past the pass's nc
// or a row's live width are 0. nc <= 0: no partials, zeros. Returns once
// every block has read every partial.
template <int BM, int kThr>
__device__ __forceinline__ void store_pass(
    float* partial, float* __restrict__ y, const int* sidx, const int* slive,
    int s, int row0, int rows, int r_max, int c0, int nc, int split,
    int part) {
  const int ccount = min(kCols, r_max - c0);     // a multiple of 8
  const int per = BM / split;
  if (nc > 0) split_sync(split);                 // every partial written
  for (int i = threadIdx.x; i < per * (ccount / 4); i += kThr) {
    const int r = part * per + i / (ccount / 4), c = i % (ccount / 4) * 4;
    if (row0 + r >= rows || sidx[r] != s) continue;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < nc && c0 + c < slive[r]) {
#pragma unroll
      for (int k = 0; k < kMaxTileSplit; ++k) {
        if (k >= split) break;
        const float* src = split > 1
            ? cg::this_cluster().map_shared_rank(partial, k) : partial;
        const float4 p = *reinterpret_cast<const float4*>(src + r * kLdp + c);
        v.x += p.x;
        v.y += p.y;
        v.z += p.z;
        v.w += p.w;
      }
      const int lv = min(nc, slive[r] - c0);     // columns [c, lv) live
      if (c + 1 >= lv) v.y = 0.f;
      if (c + 2 >= lv) v.z = 0.f;
      if (c + 3 >= lv) v.w = 0.f;
    }
    *reinterpret_cast<float4*>(y + (size_t)(row0 + r) * r_max + c0 + c) = v;
  }
  if (nc > 0) split_sync(split);                 // every partial read
}

// -- bf16 row tiles through TMA and wgmma (d_in a multiple of 8) --

constexpr int kWD = 64;                     // d a TMA box: 128 bytes of bf16

// BM rows a tile in BM / 64 warpgroups (wgmma's 64 rows each); a stage is
// the tile's x[:, 64 d] (BM rows of 128 bytes) and A[s][64 d, 64 columns]
// (64 rows of 128 bytes), both 128-byte swizzled as TMA writes them.
template <int BM>
struct WTile {
  static constexpr int kThreads = 2 * BM;           // BM / 64 warpgroups
  static constexpr int kXBytes = BM * kWD * 2;
  static constexpr int kABytes = kWD * kCols * 2;
  static constexpr int kStageBytes = kXBytes + kABytes;
  static constexpr int kStages = BM == 64 ? 6 : 4;  // 96 KiB: 2 blocks an SM
  static constexpr int kRing = kStages * kStageBytes;
  static_assert(kRing >= BM * kLdp * 4, "the partials reuse the ring");
  static constexpr size_t kSmem = kRing + 1024;     // + a 1024-byte align
};

// Block (tile, k, part): the tile's k-th distinct slot s over d in
// [part * d_chunk, (part + 1) * d_chunk) (d_chunk a multiple of kWD),
// `split` blocks a tile in one cluster. Thread 0 keeps the ring full
// (one mbarrier a stage; TMA zero-fills past d_in and past `rows`);
// each warpgroup multiplies its 64 rows of every stage by the stage's A
// tile (wgmma m64n64k16, bf16 in, f32 out, 4 k-steps) and adds the sum
// into its f32 total on the CUDA cores: the tensor cores' f32 adds round
// toward zero, which over d_in 4096 drifts past the f32 limit. Rows of
// other slots are multiplied too and never stored; a warpgroup with no
// row of s only waits. After all stages the totals go to shared memory
// (over the ring) and store_pass sums the cluster's partials.
template <int BM>
__global__ void __launch_bounds__(WTile<BM>::kThreads)
    lora_shrink_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                             const __grid_constant__ CUtensorMap ta,
                             const int* __restrict__ idx,
                             const int* __restrict__ live,
                             float* __restrict__ y, int rows, int d_in,
                             int r_max, int slots, int d_chunk, int split) {
  using W = WTile<BM>;
  constexpr int S = W::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (rt::smem_u32(smem_raw) & 1023)) & 1023);
  __shared__ __align__(8) uint64_t full[S];
  __shared__ int sidx[BM], slive[BM], width[BM];
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid / 128, warp = (tid / 32) & 3;
  const int part = (int)blockIdx.x % split;
  const int row0 = (int)blockIdx.x / split * BM;
  int s, ncol;
  tile_slot<BM, W::kThreads>(idx, live, y, sidx, slive, width, rows, r_max,
                             slots, row0, blockIdx.y,
                             blockIdx.y == 0 && part == 0, s, ncol);
  if (s < 0) return;
  if (tid == 0) {
    for (int b = 0; b < S; ++b) rt::mbar_init(&full[b], 1);
    rt::fence_barrier_init();
  }
  bool mine = false;                        // a row of s in my 64 rows
  for (int r = 0; r < 64; ++r) mine |= sidx[wg * 64 + r] == s;
  __syncthreads();
  const int lo = part * d_chunk, hi = min(d_in, lo + d_chunk);
  const int nk = hi > lo ? (hi - lo + kWD - 1) / kWD : 0;
  float* partial = reinterpret_cast<float*>(ring);
  int g = 0;                                // stages issued before the pass
  for (int c0 = 0; c0 < r_max; c0 += kCols) {
    const int nc = min(kCols, ncol - c0);
    if (nc > 0) {
      const CUtensorMap* mx = &tx;
      const CUtensorMap* ma = &ta;
      auto issue = [&](int kt) {            // stage kt of this pass
        const int b = (g + kt) % S;
        unsigned char* st = ring + b * W::kStageBytes;
        rt::mbar_expect_tx(&full[b], W::kStageBytes);
        rt::tma_load_4d(st, mx, &full[b], lo + kt * kWD, row0, 0, 0);
        rt::tma_load_4d(st + W::kXBytes, ma, &full[b], c0, lo + kt * kWD, s,
                        0);
      };
      if (tid == 0)
        for (int kt = 0; kt < min(nk, S); ++kt) issue(kt);
      float acc[kCols / 2], part_d[kCols / 2];
#pragma unroll
      for (int i = 0; i < kCols / 2; ++i) acc[i] = part_d[i] = 0.f;
      for (int kt = 0; kt < nk; ++kt) {
        const int b = (g + kt) % S;
        rt::mbar_wait(&full[b], ((g + kt) / S) & 1);
        if (mine) {
          unsigned char* st = ring + b * W::kStageBytes;
          // x: K-major, SBO one 8-row atom, a k-step 32 bytes on; A:
          // MN-major (transpose bit), a k-step 16 rows of 128 bytes on
          const uint64_t da = rt::smem_desc(st + wg * 64 * 128, 16, 1024, 1);
          const uint64_t db = rt::smem_desc(st + W::kXBytes, kWD * 128, 1024,
                                            1);
          rt::fence_regs(part_d);
          rt::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kWD / 16; ++kk)
            rt::Wgmma<kCols>::template ss<0, 1>(part_d, da + 2 * kk,
                                                db + 128 * kk, kk > 0);
          rt::wgmma_commit();
          rt::wgmma_wait<0>();
          rt::fence_regs(part_d);
#pragma unroll
          for (int i = 0; i < kCols / 2; ++i) acc[i] += part_d[i];
        }
        __syncthreads();                    // stage b read by every warp
        if (tid == 0 && kt + S < nk) issue(kt + S);
      }
      g += nk;
      // d[4i + 2h + e]: row 16 warp + lane / 4 + 8h, column 8i + 2 (lane %
      // 4) + e of the warpgroup's 64 rows
      if (mine) {
#pragma unroll
        for (int i = 0; i < kCols / 8; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wg * 64 + warp * 16 + (lane >> 2) + 8 * h;
            *reinterpret_cast<float2*>(partial + r * kLdp + 8 * i +
                                       2 * (lane & 3)) =
                make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
          }
      }
      rt::fence_proxy_async();              // the ring is TMA's again next
    }
    store_pass<BM, W::kThreads>(partial, y, sidx, slive, s, row0, rows,
                                r_max, c0, nc, split, part);
  }
}

// -- row tiles through cp.async (f32 on CUDA cores; bf16 at other d_in) --

template <typename T> struct TileCfg;
template <> struct TileCfg<bf16> {
  static constexpr int kBD = 64, kStages = 4;     // d a stage
  static constexpr int kLdx = kBD + 8, kLda = kCols + 8;   // ldmatrix pad
};
template <> struct TileCfg<float> {
  static constexpr int kBD = 32, kStages = 3;
  static constexpr int kLdx = kBD + 4, kLda = kCols + 4;
};

template <typename T, int BM>
constexpr size_t tile_smem() {
  using C = TileCfg<T>;
  return sizeof(T) * C::kStages * ((size_t)BM * C::kLdx +
                                   (size_t)C::kBD * C::kLda);
}

// One pass: the partial sums of y[rows of slot s in the tile, c0 : c0 +
// kCols] over d in [lo, hi), with nc (a multiple of 8, >= 8) columns
// computed, into `partial` (BM x kLdp f32 over the ring; rows of other
// slots are not written). kVec: d_in a multiple of 8, x's rows copied in
// 16-byte cp.async (f32 only: bf16 at such widths takes the wgmma
// kernel); else element by element (a row then starts anywhere), zero past
// hi, so a partial mma k-step of 16 sums zeros.
template <typename T, int BM, bool kVec>
__device__ __forceinline__ void shrink_pass(
    const T* __restrict__ x, const T* __restrict__ as_g, float* partial,
    T* xs, T* as, const int* sidx, int s, int row0, int lo, int hi,
    int d_in, int r_max, int c0, int nc) {
  using C = TileCfg<T>;
  constexpr int kThr = 2 * BM;
  constexpr int VEC = 16 / sizeof(T);       // elements a 16-byte copy
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nk = hi > lo ? (hi - lo + C::kBD - 1) / C::kBD : 0;

  auto load = [&](int buf, int kt) {
    const int d0 = lo + kt * C::kBD;
    T* xb = xs + buf * BM * C::kLdx;
    if constexpr (kVec) {
      constexpr int XC = C::kBD / VEC;      // copies a row of x
      for (int i = tid; i < BM * XC; i += kThr) {
        const int r = i / XC, d = d0 + (i % XC) * VEC;
        const bool ok = sidx[r] == s && d < hi;  // other slots' rows: 0
        const T* src = ok ? x + (size_t)(row0 + r) * d_in + d : x;
        rt::cp_async16(xb + r * C::kLdx + (i % XC) * VEC, src, ok);
      }
    } else {
      // the buffer was consumed before the __syncthreads() that precedes
      // this copy, so plain stores may land in it at once
      for (int i = tid; i < BM * C::kBD; i += kThr) {
        const int r = i / C::kBD, d = d0 + i % C::kBD;
        xb[r * C::kLdx + i % C::kBD] =
            sidx[r] == s && d < hi ? x[(size_t)(row0 + r) * d_in + d]
                                   : rt::from_f32<T>(0.f);
      }
    }
    T* ab = as + buf * C::kBD * C::kLda;
    constexpr int AC = kCols / VEC;         // copies a d row of A
    for (int i = tid; i < C::kBD * AC; i += kThr) {
      const int r = i / AC, c = (i % AC) * VEC, d = d0 + r;
      const bool ok = d < hi && c < nc;     // dead columns are never read
      const T* src = ok ? as_g + (size_t)d * r_max + c0 + c : as_g;
      rt::cp_async16(ab + r * C::kLda + c, src, ok);
    }
  };

  if constexpr (std::is_same<T, bf16>::value) {
    // warp w: rows 16w .. 16w + 15, all nc columns; a warp with no row of
    // slot s only helps load
    const bool mine = __any_sync(0xffffffffu, sidx[warp * 16 + (lane & 15)]
                                                  == s);
    // each stage's products are summed by the tensor cores into `part`,
    // then added to `acc` on the CUDA cores (see the wgmma kernel)
    float acc[kCols / 8][4];
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int st = 0; st < C::kStages - 1; ++st) {
      if (st < nk) load(st, st);
      rt::cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      rt::cp_async_wait<C::kStages - 2>();
      __syncthreads();
      const int nxt = kt + C::kStages - 1;
      if (nxt < nk) load(nxt % C::kStages, nxt);
      rt::cp_async_commit();
      if (!mine) continue;
      const T* xb = xs + (kt % C::kStages) * BM * C::kLdx;
      const T* ab = as + (kt % C::kStages) * C::kBD * C::kLda;
      float part[kCols / 8][4];
#pragma unroll
      for (int n = 0; n < kCols / 8; ++n)
        part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < C::kBD / 16; ++ks) {
        unsigned af[4];
        rt::ldsm_x4(af, xb + (warp * 16 + (lane & 15)) * C::kLdx + ks * 16 +
                            (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < kCols / 16; ++np) {
          if (np * 16 < nc) {
            unsigned bv[4];
            rt::ldsm_x4_trans(bv, ab + (ks * 16 + (lane & 7) +
                                        ((lane >> 3) & 1) * 8) * C::kLda +
                                      np * 16 + (lane >> 4) * 8);
            rt::mma_bf16(part[2 * np], af, bv[0], bv[1]);
            if (np * 16 + 8 < nc) rt::mma_bf16(part[2 * np + 1], af, bv[2],
                                               bv[3]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < kCols / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
    }
    rt::cp_async_wait<0>();
    __syncthreads();                        // the ring is free: partials
    if (!mine) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + (lane >> 2) + 8 * h;
#pragma unroll
      for (int n = 0; n < kCols / 8; ++n)
        *reinterpret_cast<float2*>(partial + r * kLdp + n * 8 +
                                   (lane & 3) * 2) =
            make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
    }
  } else {
    // f32 on CUDA cores: thread = 4 rows x 8 columns
    const int rg = tid / 8, cgp = tid % 8;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int st = 0; st < C::kStages - 1; ++st) {
      if (st < nk) load(st, st);
      rt::cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      rt::cp_async_wait<C::kStages - 2>();
      __syncthreads();
      const int nxt = kt + C::kStages - 1;
      if (nxt < nk) load(nxt % C::kStages, nxt);
      rt::cp_async_commit();
      if (cgp * 8 >= nc) continue;
      const T* xb = xs + (kt % C::kStages) * BM * C::kLdx;
      const T* ab = as + (kt % C::kStages) * C::kBD * C::kLda;
#pragma unroll 4
      for (int d = 0; d < C::kBD; ++d) {
        float xv[4], av[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = xb[(rg * 4 + i) * C::kLdx + d];
#pragma unroll
        for (int j = 0; j < 8; ++j) av[j] = ab[d * C::kLda + cgp * 8 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += xv[i] * av[j];
      }
    }
    rt::cp_async_wait<0>();
    __syncthreads();                        // the ring is free: partials
    if (cgp * 8 >= nc) return;              // columns past nc: never read
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* pr = partial + (rg * 4 + i) * kLdp + cgp * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) pr[j] = acc[i][j];
    }
  }
}

// Block (tile, k, part) as the wgmma kernel's, through shrink_pass.
template <typename T, int BM, bool kVec>
__global__ void __launch_bounds__(2 * BM) lora_shrink_tile_kernel(
    const T* __restrict__ x, const T* __restrict__ a,
    const int* __restrict__ idx, const int* __restrict__ live,
    float* __restrict__ y, int rows, int d_in, int r_max, int slots,
    int d_chunk, int split) {
  using C = TileCfg<T>;
  constexpr int kThr = 2 * BM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  T* as = xs + C::kStages * BM * C::kLdx;
  float* partial = reinterpret_cast<float*>(smem_raw);
  __shared__ int sidx[BM], slive[BM], width[BM];
  const int part = (int)blockIdx.x % split;
  const int row0 = (int)blockIdx.x / split * BM;
  int s, ncol;
  tile_slot<BM, kThr>(idx, live, y, sidx, slive, width, rows, r_max, slots,
                      row0, blockIdx.y, blockIdx.y == 0 && part == 0, s,
                      ncol);
  if (s < 0) return;
  const int lo = part * d_chunk, hi = min(d_in, lo + d_chunk);
  const T* as_g = a + (size_t)s * d_in * r_max;
  for (int c0 = 0; c0 < r_max; c0 += kCols) {
    const int nc = min(kCols, ncol - c0);
    if (nc > 0)
      shrink_pass<T, BM, kVec>(x, as_g, partial, xs, as, sidx, s, row0, lo,
                               hi, d_in, r_max, c0, nc);
    store_pass<BM, kThr>(partial, y, sidx, slive, s, row0, rows, r_max, c0,
                         nc, split, part);
  }
}

// A tile holds at most min(slots, BM) distinct slots: one block each (y),
// `split` blocks a tile (x) in a cluster. bf16 at a d_in that is a
// multiple of 8 takes the wgmma kernel (its tensor maps made by the
// caller); f32 and other widths the cp.async kernel.
template <typename T, int BM>
rt::Launch tile_launch(int rows, int d_in, int slots, int split) {
  static_assert(tile_smem<T, BM>() >= BM * kLdp * sizeof(float),
                "the partials reuse the ring");
  const dim3 grid((rows + BM - 1) / BM * split, max(1, min(slots, BM)));
  const bool vec = d_in % rt::kVec == 0;
  if constexpr (std::is_same<T, bf16>::value) {
    if (vec)
      return {(const void*)lora_shrink_wgmma_kernel<BM>, grid,
              WTile<BM>::kThreads, WTile<BM>::kSmem, (unsigned)split};
    return {(const void*)lora_shrink_tile_kernel<bf16, BM, false>, grid,
            2 * BM, tile_smem<bf16, BM>(), (unsigned)split};
  } else {
    return {vec ? (const void*)lora_shrink_tile_kernel<T, BM, true>
                : (const void*)lora_shrink_tile_kernel<T, BM, false>,
            grid, 2 * BM, tile_smem<T, BM>(), (unsigned)split};
  }
}

// a handful of rows is bound by latency: 512 threads keep more loads in
// flight; from 17 rows on, rows x kSplit blocks fill the card at 256.
// The d-groups are the largest power of two that fits beside the lanes
// (the tree reduction halves them), so any r_max = 8 x lanes is taken
template <typename T>
rt::Launch split_launch(int rows, int r_max) {
  const int lanes = r_max / rt::kVec;
  const int target = rows <= 16 ? 512 : 256;
  int ngrp = 1;
  while (2 * ngrp * lanes <= target) ngrp *= 2;
  return {(const void*)lora_shrink_split_kernel<T>, dim3(rows * kSplit),
          ngrp * lanes, (size_t)ngrp * r_max * sizeof(float)};
}

// ------------------------------------------------ expand: row tiles ----

constexpr int kEM = 64;                     // rows a tile
constexpr int kER = 64;                     // rank rows a pass
constexpr int kEN = 256;                    // output columns a block
constexpr int kEThr = 256;                  // 8 warps: 2 x 4 tiles of 32 x 64

template <typename T> struct ExpCfg;
template <> struct ExpCfg<bf16> {
  static constexpr int kLdy = kER + 8, kLdb = kEN + 8;     // ldmatrix pad
};
template <> struct ExpCfg<float> {
  static constexpr int kLdy = kER + 4, kLdb = kEN + 4;
};

// two y tiles (the current and the next, in flight), a y tile for rank
// rows past kER, a B tile and the bf16 output tile
template <typename T>
constexpr size_t expand_tile_smem() {
  using C = ExpCfg<T>;
  return sizeof(T) * (3 * (size_t)kEM * C::kLdy + (size_t)kER * C::kLdb +
                      (std::is_same<T, bf16>::value ? (size_t)kEM * C::kLdb
                                                    : 0));
}

// out[:, n0 : n0 + kEN] for the row tiles t = blockIdx.y, blockIdx.y +
// gridDim.y, ... of kEM rows. While a block works on tile t, y of tile
// t + gridDim.y and its slots are already loading. For each distinct
// slot s of the tile (a pass), the block multiplies y's rows (rows of
// other slots give products that are never stored; columns at or past a
// row's live width are zeroed first) by B[s][:ncol, n0 : n0 + kEN], ncol
// = the slot's widest live width in the tile rounded up to 8, kept in
// shared memory across tiles while the slot and width stay the same, and
// writes the rows of s; rows with no adapter get zeros. Every element of
// out is written once, by one block. kMulti: r_max > kER, rank rows in
// several passes (the partial sums take another 64 registers: one block
// an SM then, as for f32, so that nothing spills). kVec: d_out a multiple
// of 8, B's rows copied and out's written 16 bytes at a time; else
// element by element (a row then starts anywhere), zero past d_out.
template <typename T, bool kMulti, bool kVec>
__global__ void __launch_bounds__(
    kEThr, (std::is_same<T, bf16>::value && !kMulti) ? 2 : 1)
    lora_expand_tile_kernel(
    const T* __restrict__ y, const T* __restrict__ b,
    const int* __restrict__ idx, const int* __restrict__ live,
    T* __restrict__ out, int rows, int r_max, int d_out, int slots) {
  using C = ExpCfg<T>;
  constexpr bool kBF = std::is_same<T, bf16>::value;
  constexpr int VEC = 16 / sizeof(T);       // elements a 16-byte copy
  constexpr int YC = kER / VEC, OC = kEN / VEC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ybuf = reinterpret_cast<T*>(smem_raw);              // 2 x kEM x kLdy
  T* yx = ybuf + 2 * kEM * C::kLdy;                      // kEM x kLdy
  T* bs = yx + kEM * C::kLdy;                            // kER x kLdb
  T* stage = bs + kER * C::kLdb;                         // kEM x kLdb
  // rows' slots and live widths, one buffer a tile parity: a thread may
  // write the next tile's while another still reads this tile's
  __shared__ int sidx[2 * kEM], slive[2 * kEM], wred[2][kEM / 32];
  __shared__ unsigned firstm[kEM / 32];
  int pb = 0;                               // this tile's buffer: 0 or kEM
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kEN;
  const int ncols = min(kEN, d_out - n0);   // a multiple of 8 with kVec
  const int ntiles = (rows + kEM - 1) / kEM;
  const T zero = rt::from_f32<T>(0.f);

  // y[rows of tile t, k0 : k0 + kER] (columns at or past r_max as 0)
  auto load_y = [&](T* dst, int t, int k0) {
    for (int i = tid; i < kEM * YC; i += kEThr) {
      const int r = i / YC, c = (i % YC) * VEC, row = t * kEM + r;
      const bool ok = row < rows && k0 + c < r_max;
      rt::cp_async16(dst + r * C::kLdy + c,
                     ok ? y + (size_t)row * r_max + k0 + c : y, ok);
    }
  };
  // B[s][k0 : k0 + kn, n0 : n0 + kEN]; other rank rows as 0 (never read)
  auto load_b = [&](int s, int k0, int kn) {
    const T* src = b + ((size_t)s * r_max + k0) * d_out + n0;
    if constexpr (kVec) {
      for (int i = tid; i < kER * OC; i += kEThr) {
        const int r = i / OC, c = (i % OC) * VEC;
        const bool ok = r < kn && c < ncols;
        rt::cp_async16(bs + r * C::kLdb + c,
                       ok ? src + (size_t)r * d_out + c : b, ok);
      }
    } else {
      // bs is free here (a __syncthreads() since its last read)
      for (int i = tid; i < kER * kEN; i += kEThr) {
        const int r = i / kEN, c = i % kEN;
        bs[r * C::kLdb + c] =
            r < kn && c < ncols ? src[(size_t)r * d_out + c] : zero;
      }
    }
  };
  // row `tid` of tile t: its slot (-1: no adapter or past `rows`), live
  auto row_info = [&](int t, int& s, int& lv) {
    const int row = t * kEM + tid;
    s = -1;
    lv = 0;
    if (tid < kEM && row < rows) {
      s = idx[row];
      if (s < 0 || s >= slots) s = -1;
      else lv = max(0, min(live[row], r_max));
    }
  };
  // y columns at or past each row of s's live width, in [k0, k0 + kER)
  auto mask_y = [&](T* dst, int s, int k0) {
    for (int i = tid; i < kEM * YC; i += kEThr) {
      const int r = i / YC, c = (i % YC) * VEC;
      if (sidx[pb + r] != s || k0 + c + VEC <= slive[pb + r]) continue;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        if (k0 + c + j >= slive[pb + r]) dst[r * C::kLdy + c + j] = zero;
    }
  };

  // bf16: warp tile of 32 rows x 64 columns; f32: thread 4 rows x 16
  // columns. Without kMulti each is computed in NH = 2 halves of NW
  // columns, so the accumulators take 32 registers and two blocks fit an
  // SM without spilling.
  constexpr int NH = kMulti ? 1 : 2;
  constexpr int NW = 64 / NH;               // a warp's columns a half
  constexpr int FW = 16 / NH;               // an f32 thread's columns a half
  const int wr = warp & 1, wc = warp >> 1;
  const int rg = tid / 16, cg = tid % 16;
  // bf16: d[m * NW / 8 + n] is the mma tile (rows 16 m, columns 8 n) of
  // the warp's half; f32: d[FW / 4 * i + j / 4][j % 4] is (row i, column j)
  float acc[NW / 4][4], part[kMulti ? NW / 4 : 1][4];
  // d = y tile x bs over rank rows [0, kn), kn <= kER, half h's columns
  auto product = [&](const T* ys, int kn, int h, float (&d)[NW / 4][4]) {
#pragma unroll
    for (int n = 0; n < NW / 4; ++n)
      d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0.f;
    if constexpr (kBF) {
#pragma unroll
      for (int ks = 0; ks < kER / 16; ++ks) {
        if (ks * 16 >= kn) break;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          unsigned af[4];
          rt::ldsm_x4(af, ys + (wr * 32 + m * 16 + (lane & 15)) * C::kLdy +
                              ks * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int np = 0; np < NW / 16; ++np) {
            unsigned bv[4];
            rt::ldsm_x4_trans(bv, bs + (ks * 16 + (lane & 7) +
                                        ((lane >> 3) & 1) * 8) * C::kLdb +
                                      wc * 64 + h * NW + np * 16 +
                                      (lane >> 4) * 8);
            rt::mma_bf16(d[m * NW / 8 + 2 * np], af, bv[0], bv[1]);
            rt::mma_bf16(d[m * NW / 8 + 2 * np + 1], af, bv[2], bv[3]);
          }
        }
      }
    } else {
      for (int k = 0; k < kn; ++k) {
        float yv[4], bv[FW];
#pragma unroll
        for (int i = 0; i < 4; ++i) yv[i] = ys[(rg * 4 + i) * C::kLdy + k];
#pragma unroll
        for (int j = 0; j < FW; ++j)
          bv[j] = bs[k * C::kLdb + cg * 16 + h * FW + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < FW; ++j)
            d[FW / 4 * i + j / 4][j % 4] += yv[i] * bv[j];
      }
    }
  };

  int t = blockIdx.y;
  int s_nxt, lv_nxt;
  row_info(t, s_nxt, lv_nxt);
  if (t < ntiles) load_y(ybuf, t, 0);
  rt::cp_async_commit();
  int res_s = -1, res_ncol = 0;             // the B chunk held in bs
  for (int it = 0; t < ntiles; ++it, t += gridDim.y) {
    T* yb = ybuf + (it & 1) * kEM * C::kLdy;
    pb = (it & 1) * kEM;
    if (tid < kEM) {
      sidx[pb + tid] = s_nxt;
      slive[pb + tid] = lv_nxt;
    }
    const int t_nxt = t + gridDim.y;
    if (t_nxt < ntiles) row_info(t_nxt, s_nxt, lv_nxt);
    rt::cp_async_wait<0>();
    __syncthreads();                        // tile t's y landed
    if (t_nxt < ntiles)
      load_y(ybuf + ((it + 1) & 1) * kEM * C::kLdy, t_nxt, 0);
    rt::cp_async_commit();
    const int row0 = t * kEM;
    // the first row of each distinct slot of the tile
    if (tid < kEM) {
      const int s = sidx[pb + tid];
      bool first = s >= 0;
      for (int u = tid - 1; u >= 0 && first; --u)
        first = sidx[pb + u] != s;
      const unsigned m = __ballot_sync(0xffffffffu, first);
      if (lane == 0) firstm[warp] = m;
    }
    const bool zeros = __syncthreads_or(tid < kEM && row0 + tid < rows &&
                                        sidx[pb + tid] < 0);
    // rows without an adapter: zeros, 16 bytes a store
    if (zeros && kVec) {
      for (int i = tid; i < kEM * OC; i += kEThr) {
        const int r = i / OC, c = (i % OC) * VEC;
        if (row0 + r < rows && sidx[pb + r] < 0 && c < ncols)
          *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * d_out + n0 +
                                    c) = make_uint4(0u, 0u, 0u, 0u);
      }
    } else if (zeros) {
      for (int i = tid; i < kEM * kEN; i += kEThr) {
        const int r = i / kEN, c = i % kEN;
        if (row0 + r < rows && sidx[pb + r] < 0 && c < ncols)
          out[(size_t)(row0 + r) * d_out + n0 + c] = zero;
      }
    }
    for (int q = 0; q < kEM / 32; ++q) {
      for (unsigned m = firstm[q]; m != 0u; m &= m - 1u) {
        const int s = sidx[pb + q * 32 + __ffs(m) - 1];
        // the widest and narrowest live width of the slot's rows
        if (tid < kEM) {
          const bool mine = sidx[pb + tid] == s;
          const int hi = __reduce_max_sync(0xffffffffu,
                                           mine ? slive[pb + tid] : 0);
          const int lo = __reduce_min_sync(0xffffffffu,
                                           mine ? slive[pb + tid] : r_max);
          if (lane == 0) {
            wred[0][warp] = hi;
            wred[1][warp] = lo;
          }
        }
        __syncthreads();
        int hi = 0, lo = r_max;
#pragma unroll
        for (int w = 0; w < kEM / 32; ++w) {
          hi = max(hi, wred[0][w]);
          lo = min(lo, wred[1][w]);
        }
        const int ncol = (hi + 7) / 8 * 8;
        const int kn0 = min(kER, ncol);
        if (lo < min(kER, r_max)) mask_y(yb, s, 0);
        if (ncol > 0 && (s != res_s || ncol != res_ncol)) {
          load_b(s, 0, kn0);
          rt::cp_async_commit();
          rt::cp_async_wait<0>();
          res_s = s;
          res_ncol = ncol;
        }
        __syncthreads();                    // yb masked, bs loaded
        const bool any = kBF ? __any_sync(0xffffffffu,
                                          sidx[pb + wr * 32 + lane] == s)
                             : true;
        for (int h = 0; h < NH; ++h) {
          if (any && ncol > 0) {
            product(yb, kn0, h, acc);
          } else {
#pragma unroll
            for (int n = 0; n < NW / 4; ++n)
              acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
          }
          // rank rows past kER: one pass a kER rows, each pass's sum
          // added on the CUDA cores
          if constexpr (kMulti) for (int k0 = kER; k0 < ncol; k0 += kER) {
            __syncthreads();                // bs and yx consumed
            load_y(yx, t, k0);
            load_b(s, k0, min(kER, ncol - k0));
            rt::cp_async_commit();
            rt::cp_async_wait<0>();
            __syncthreads();
            mask_y(yx, s, k0);
            __syncthreads();
            res_s = -1;
            if (any) {
              product(yx, min(kER, ncol - k0), h, part);
#pragma unroll
              for (int n = 0; n < NW / 4; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
            }
          }
          if constexpr (kBF) {
            // cast once into the staged tile
            if (any) {
#pragma unroll
              for (int mm = 0; mm < 2; ++mm)
#pragma unroll
                for (int hr = 0; hr < 2; ++hr) {
                  const int r = wr * 32 + mm * 16 + (lane >> 2) + 8 * hr;
#pragma unroll
                  for (int n = 0; n < NW / 8; ++n)
                    *reinterpret_cast<unsigned*>(
                        stage + r * C::kLdb + wc * 64 + h * NW + n * 8 +
                        (lane & 3) * 2) =
                        rt::pack_bf16(acc[mm * NW / 8 + n][2 * hr],
                                      acc[mm * NW / 8 + n][2 * hr + 1]);
                }
            }
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = rg * 4 + i;
              if (sidx[pb + r] != s) continue;
              float* o = out + (size_t)(row0 + r) * d_out + n0 + cg * 16 +
                         h * FW;
#pragma unroll
              for (int q4 = 0; q4 < FW / 4; ++q4) {
                const int col = cg * 16 + h * FW + q4 * 4;
                if (kVec && col < ncols) {
                  *reinterpret_cast<float4*>(o + q4 * 4) = make_float4(
                      acc[FW / 4 * i + q4][0], acc[FW / 4 * i + q4][1],
                      acc[FW / 4 * i + q4][2], acc[FW / 4 * i + q4][3]);
                } else if (!kVec) {
#pragma unroll
                  for (int e = 0; e < 4; ++e)
                    if (col + e < ncols) o[q4 * 4 + e] =
                        acc[FW / 4 * i + q4][e];
                }
              }
            }
          }
        }
        if constexpr (kBF) {
          // the slot's rows of the staged tile, 16 bytes a store
          __syncthreads();
          if constexpr (kVec) {
            for (int i = tid; i < kEM * OC; i += kEThr) {
              const int r = i / OC, c = (i % OC) * VEC;
              if (sidx[pb + r] == s && c < ncols)
                *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * d_out +
                                          n0 + c) =
                    *reinterpret_cast<const uint4*>(stage + r * C::kLdb + c);
            }
          } else {
            for (int i = tid; i < kEM * kEN; i += kEThr) {
              const int r = i / kEN, c = i % kEN;
              if (sidx[pb + r] == s && c < ncols)
                out[(size_t)(row0 + r) * d_out + n0 + c] =
                    stage[r * C::kLdb + c];
            }
          }
        }
        __syncthreads();                    // stage, bs, yx, wred free
      }
    }
  }
  rt::cp_async_wait<0>();
}

template <typename T>
rt::Launch expand_tile_launch(int r_max, int d_out, int row_blocks) {
  const bool multi = r_max > kER, vec = d_out % rt::kVec == 0;
  const void* fn =
      multi ? (vec ? (const void*)lora_expand_tile_kernel<T, true, true>
                   : (const void*)lora_expand_tile_kernel<T, true, false>)
            : (vec ? (const void*)lora_expand_tile_kernel<T, false, true>
                   : (const void*)lora_expand_tile_kernel<T, false, false>);
  return {fn, dim3((d_out + kEN - 1) / kEN, row_blocks), kEThr,
          expand_tile_smem<T>()};
}

// --------------------------------------------------- expand: decode ----

constexpr int kRankSplit = 8;               // warps a block: rank slices
constexpr int kDecCols = 8 * 32;            // columns a block: 8 a lane

// out[row, c0 : c0 + kDecCols]: lane l of every warp owns 8 columns and
// reads them from one rank row of B in a single 16-byte load; warp w sums
// rank rows w, w + kRankSplit, ... below live[row] (up to 8 loads a thread
// in flight), and the warps' partials are added in warp order. kVec: d_out
// a multiple of 8; else the 8 columns are read one by one (a rank row then
// starts anywhere), zero past d_out.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kRankSplit * 32) lora_expand_decode_kernel(
    const T* __restrict__ y, const T* __restrict__ b,
    const int* __restrict__ idx, const int* __restrict__ live,
    T* __restrict__ out, int r_max, int d_out, int slots) {
  extern __shared__ __align__(16) float esm[];
  float* part = esm;                        // kRankSplit x kDecCols
  float* ysm = esm + kRankSplit * kDecCols; // r_max
  const int row = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.y * kDecCols + lane * rt::kVec;
  const int s = idx[row];
  const int lv = (s >= 0 && s < slots) ? max(0, min(live[row], r_max)) : 0;
  for (int r = tid; r < lv; r += blockDim.x)
    ysm[r] = rt::to_f32(y[(size_t)row * r_max + r]);
  __syncthreads();
  float acc[rt::kVec];
#pragma unroll
  for (int j = 0; j < rt::kVec; ++j) acc[j] = 0.f;
  if (c < d_out) {
    const T* bs = b + (size_t)max(s, 0) * r_max * d_out + c;
#pragma unroll 8
    for (int r = warp; r < lv; r += kRankSplit) {
      float w[rt::kVec];
      if constexpr (kVec) {
        rt::load8(bs + (size_t)r * d_out, w);
      } else {
#pragma unroll
        for (int j = 0; j < rt::kVec; ++j)
          w[j] = c + j < d_out ? rt::to_f32(bs[(size_t)r * d_out + j]) : 0.f;
      }
      const float yv = ysm[r];
#pragma unroll
      for (int j = 0; j < rt::kVec; ++j) acc[j] += yv * w[j];
    }
  }
  float4* mine = reinterpret_cast<float4*>(part + warp * kDecCols +
                                           lane * rt::kVec);
  mine[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  mine[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  __syncthreads();
  const int col = blockIdx.y * kDecCols + tid;
  if (col < d_out) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kRankSplit; ++w) sum += part[w * kDecCols + tid];
    out[(size_t)row * d_out + col] = rt::from_f32<T>(sum);
  }
}

template <typename T>
rt::Launch expand_decode_launch(int rows, int r_max, int d_out) {
  return {d_out % rt::kVec == 0
              ? (const void*)lora_expand_decode_kernel<T, true>
              : (const void*)lora_expand_decode_kernel<T, false>,
          dim3(rows, (d_out + kDecCols - 1) / kDecCols), kRankSplit * 32,
          sizeof(float) * ((size_t)kRankSplit * kDecCols + r_max)};
}

// The shrink's launch for these arguments (see rt_lora_shrink), or the
// error the entry point returns.
cudaError_t shrink_launch(int rows, int d_in, int r_max, int slots, int tile,
                          int d_chunk, int split, int dtype, rt::Launch* l) {
  // r_max a multiple of 8 (one 8-column lane each, at most 1,024 lanes a
  // block); any d_in (16-byte copies of x where it is a multiple of 8)
  const int lanes = r_max / rt::kVec;
  if (rows <= 0 || r_max <= 0 || r_max % rt::kVec != 0 || lanes > 1024 ||
      d_in <= 0 || d_chunk <= 0)
    return cudaErrorInvalidValue;
  const bool bf = dtype == rt::kBF16;
  if (!bf && dtype != rt::kF32) return cudaErrorInvalidValue;
  if (tile == 0) {
    if (split != kSplit || d_chunk % rt::kVec != 0 ||
        (long long)d_chunk * kSplit < d_in)
      return cudaErrorInvalidValue;
    *l = bf ? split_launch<bf16>(rows, r_max)
            : split_launch<float>(rows, r_max);
    return cudaSuccess;
  }
  // row tiles: `split` (a power of two up to a portable cluster) slices of
  // d_chunk (whole TMA boxes) that cover d_in
  if (split < 1 || split > kMaxTileSplit || (split & (split - 1)) != 0 ||
      d_chunk % kWD != 0 || (long long)d_chunk * split < d_in)
    return cudaErrorInvalidValue;
  if (tile == 64) {
    *l = bf ? tile_launch<bf16, 64>(rows, d_in, slots, split)
            : tile_launch<float, 64>(rows, d_in, slots, split);
  } else if (tile == 128) {
    *l = bf ? tile_launch<bf16, 128>(rows, d_in, slots, split)
            : tile_launch<float, 128>(rows, d_in, slots, split);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// A 4-D bf16 tensor map (`dims` innermost first, each dense in the next)
// cut into boxes of 64 x `box_rows`, 128-byte swizzled, zero-filled
// outside the tensor.
bool bf16_map(CUtensorMap* map, const void* ptr, const cuuint64_t (&dims)[4],
              int box_rows) {
  const cuuint64_t strides[3] = {dims[0] * 2, dims[0] * dims[1] * 2,
                                 dims[0] * dims[1] * dims[2] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kWD, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return rt::encode_tiled()(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(ptr), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The expand's launch for these arguments (see rt_lora_expand).
cudaError_t expand_launch(int rows, int r_max, int d_out, int row_blocks,
                          int dtype, rt::Launch* l) {
  // 16-byte copies of y's rows; B's and out's 16 bytes at a time where
  // d_out is a multiple of 8, element by element otherwise
  if (rows <= 0 || r_max <= 0 || r_max % rt::kVec != 0 || d_out <= 0 ||
      row_blocks < 0)
    return cudaErrorInvalidValue;
  const bool bf = dtype == rt::kBF16;
  if (!bf && dtype != rt::kF32) return cudaErrorInvalidValue;
  if (row_blocks == 0)
    *l = bf ? expand_decode_launch<bf16>(rows, r_max, d_out)
            : expand_decode_launch<float>(rows, r_max, d_out);
  else
    *l = bf ? expand_tile_launch<bf16>(r_max, d_out, row_blocks)
            : expand_tile_launch<float>(r_max, d_out, row_blocks);
  return cudaSuccess;
}

}  // namespace

// tile = 64 or 128: the row-tile path with tiles of that many rows, split
// blocks a tile (1, 2, 4 or 8: a cluster) over d_chunk-wide slices of d_in
// (a multiple of 64 with split * d_chunk >= d_in); tile = 0: the split
// path, split = kSplit blocks a row over d_chunk-wide slices of d_in (a
// multiple of 8 with kSplit * d_chunk >= d_in).
extern "C" int rt_lora_shrink(const void* x, const void* a, const int* idx,
                              const int* live, float* y, int rows, int d_in,
                              int r_max, int slots, int tile, int d_chunk,
                              int split, int dtype, void* stream) {
  if (rows == 0) return 0;
  rt::Launch l;
  const cudaError_t e = shrink_launch(rows, d_in, r_max, slots, tile,
                                      d_chunk, split, dtype, &l);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile == 0) {
    void* args[] = {&x, &a, &idx, &live, &y, &d_in, &r_max, &slots,
                    &d_chunk};
    return (int)rt::launch(l, args, st);
  }
  if (dtype == rt::kBF16 && d_in % rt::kVec == 0) {
    // the wgmma kernel: x as (d_in, rows), A as (r_max, d_in, slots)
    if (rt::encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
    CUtensorMap tx, ta;
    const cuuint64_t xd[4] = {(cuuint64_t)d_in, (cuuint64_t)rows, 1, 1};
    const cuuint64_t ad[4] = {(cuuint64_t)r_max, (cuuint64_t)d_in,
                              (cuuint64_t)max(slots, 1), 1};
    if (!bf16_map(&tx, x, xd, tile) || !bf16_map(&ta, a, ad, kWD))
      return (int)cudaErrorInvalidValue;
    void* args[] = {&tx, &ta, &idx, &live, &y, &rows, &d_in, &r_max, &slots,
                    &d_chunk, &split};
    return (int)rt::launch(l, args, st);
  }
  void* args[] = {&x, &a, &idx, &live, &y, &rows, &d_in, &r_max, &slots,
                  &d_chunk, &split};
  return (int)rt::launch(l, args, st);
}

// rt_lora_shrink's launch, described (rt::describe) into
// out[0 : rt::kInfoFields]; no kernel runs.
extern "C" int rt_lora_shrink_info(int rows, int d_in, int r_max, int slots,
                                   int tile, int d_chunk, int split,
                                   int dtype, long long* out) {
  rt::Launch l;
  const cudaError_t e = shrink_launch(rows, d_in, r_max, slots, tile,
                                      d_chunk, split, dtype, &l);
  return (int)(e != cudaSuccess ? e : rt::describe(l, out));
}

// row_blocks = 0: the decode path, one block per (row, kDecCols columns);
// row_blocks > 0: row tiles of kEM rows x kEN columns, row_blocks blocks
// a column tile, block k taking the tiles k, k + row_blocks, ...
extern "C" int rt_lora_expand(const void* y, const void* b, const int* idx,
                              const int* live, void* out, int rows, int r_max,
                              int d_out, int slots, int row_blocks, int dtype,
                              void* stream) {
  if (rows == 0) return 0;
  rt::Launch l;
  const cudaError_t e = expand_launch(rows, r_max, d_out, row_blocks, dtype,
                                      &l);
  if (e != cudaSuccess) return (int)e;
  void* decode_args[] = {&y, &b, &idx, &live, &out, &r_max, &d_out, &slots};
  void* tile_args[] = {&y, &b, &idx, &live, &out, &rows, &r_max, &d_out,
                       &slots};
  return (int)rt::launch(l, row_blocks == 0 ? decode_args : tile_args,
                         static_cast<cudaStream_t>(stream));
}

// rt_lora_expand's launch, described into out[0 : rt::kInfoFields].
extern "C" int rt_lora_expand_info(int rows, int r_max, int d_out,
                                   int row_blocks, int dtype,
                                   long long* out) {
  rt::Launch l;
  const cudaError_t e = expand_launch(rows, r_max, d_out, row_blocks, dtype,
                                      &l);
  return (int)(e != cudaSuccess ? e : rt::describe(l, out));
}
