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
// read (beyond the 8-column group that the widest live width of the rows
// of b's slot, in its tile or batch, ends in); a row with idx[b] < 0
// or >= slots (no adapter) is a zero row and reads nothing.
//
// Bound on the H100: bytes. The shrink does 2 * live flops per element of
// x against ~2 bytes, and each adapter's A (d_in x r_max) is shared by
// every row of that adapter: at yi-9b's prefill (32,768 rows, d_in 4096,
// r_max 64, 8 adapters) x is 268 MB, A 4 MB and y 8 MB, 84 us at
// 3.35 TB/s against 17 us of tensor-core work. Three launch shapes, chosen
// on the host from `rows`, d_in and the SM count (kernels/bgmv.py:
// shrink_plan):
//  - Row tiles in bf16 at a d_in that is a multiple of 8 (prefill,
//    chunks, training): a persistent kernel (lora_shrink_wgmma_kernel),
//    one block an SM, in clusters of `split` blocks that each take a
//    slice of d_in; each cluster walks a contiguous run of 64-row tiles,
//    a pass a distinct slot of a tile (and 64 rank columns). A producer
//    warp copies idx and live a few tiles ahead, finds each tile's slots
//    and keeps TMA loads of x's 64 x 64 boxes in flight through a ring;
//    the block's slice of A[s] stays in shared memory while the slot's
//    tiles run on, so at one slot A is read once a cluster, not once a
//    tile. A consumer warpgroup multiplies each box on wgmma and adds it
//    into an f32 total; the cluster adds its blocks' totals in rank order
//    through distributed shared memory, a tile's reduction overlapping
//    the next tile's loads. What bounded the kernel before (one block a
//    (tile, slot, d slice), which reloaded its stage only after the whole
//    block had read it) was that chain, not A's bytes: with A's loads cut
//    it ran no faster (kernel_ab.py --shrink-probe); x's stream alone
//    takes ~16 us at 4,096 rows and ~100 at 32,768 on the H100.
//  - Row tiles otherwise (f32; bf16 at a d_in that is no multiple of 8,
//    which TMA's 16-byte strides refuse): tiles of 64 or 128 consecutive
//    rows, one block per (tile, distinct slot of the tile); where the
//    tiles cannot fill the card, `split` blocks of one cluster (2, 4 or
//    8) share a tile, each over a slice of d_in, keeping its f32 partial
//    sums in shared memory, and the cluster adds them in rank order
//    through distributed shared memory (no atomics), each block writing
//    1 / split of the tile's rows. cp.async copies and mma.sync (bf16) or
//    the CUDA cores (f32). x is read once a distinct slot of a tile and A
//    once a tile, not once a row.
//  - Decode (up to 64 rows). A decode batch's bytes are A's: at 8 rows
//    x is 64 KB against 3.6 MB of A for 7 slots, so the launch is laid
//    out over the slots' A and not over rows. One warp groups the rows by
//    slot (decode_group: warp match and ballots, no device sync); block
//    (d slice, 16 rank columns, k) reads the k-th distinct slot's slice
//    of A once for all of that slot's rows, 16 bytes a copy, the whole
//    slice in flight in a ring of 128-d stages, x's rows of the slot
//    beside it, both issued once the rows are grouped (x's rows are not
//    known before, so A issued earlier on a guess of the slot saved no
//    round trip: the H100 measured it slower). The slot's rows (padded
//    to 16) times A on the tensor cores (mma.sync), each warp a quarter
//    of a stage's d; the warps' partials added in warp order, then pushed through
//    distributed shared memory to the block of the cluster (the d slices,
//    up to 8) that writes the row, one cluster barrier, and added there
//    in rank order. Launched with programmatic dependent launch: it lets
//    the expand after it start at once. Every step of a launch is a
//    round trip that a decode batch's few bytes cannot hide (the H100
//    measured ~1 us for the grouping, ~2 us to A's first stage and ~2 us
//    for a reduction by two cluster barriers and remote loads, at 8
//    rows), so the design cuts round trips rather than bytes.
//
// The expand is bound by bytes too, and by its output: at yi-9b's prefill
// (d_out 4096) out is 268 MB against 4 MB each of y and B. Three launch
// shapes, chosen on the host from `rows`, B's dtype and d_out
// (kernels/bgmv.py: expand_plan):
//  - Row tiles in bf16 at a d_out that is a multiple of 8 (prefill,
//    chunks, training): a persistent kernel (lora_expand_wgmma_kernel),
//    two blocks an SM, each walking a contiguous run of 64-row x 64- or
//    128-column tiles, column tile by column tile, so B[s][:, columns]
//    stays loaded while the slot's rows run on. A producer warp copies
//    idx and live a few tiles ahead, finds each tile's slots (a warp vote
//    where one slot holds every row) and keeps TMA loads of y in flight
//    through a ring of 5-8 stages, one 128-byte box of y's columns a
//    stage (64 bf16, or 32 of the shrink's f32 y, rounded to bf16 as it
//    is read: no cast launch), and B in two buffers, loaded again only
//    when (slot, columns, rank chunk) changes; a consumer warpgroup runs
//    wgmma with y in registers (columns past each row's live width
//    zeroed), one pass a distinct slot of the tile, each keeping its
//    slot's rows; the tile is rounded once into one of two staged tiles
//    and leaves by TMA stores that drain under the next tile's work. Its
//    output is what bounds it: the H100 takes such a stream at ~2.6-2.9
//    TB/s (a store-only kernel, `kernel_ab.py --expand-probe`), where
//    the mma.sync blocks below, which stored a tile and then computed
//    the next, reached 1.5 at one slot. The ring is deep because y's
//    loads are slow under that stream: designs with a ring of y and B
//    together (3 stages) and with y loaded into registers a tile ahead
//    left the consumers waiting for y (the one-slot training shape 16-20
//    us in a graph against 15 now). Launched with programmatic dependent
//    launch: a block sets up while the kernel ahead finishes and reads
//    nothing before it has.
//  - Row tiles otherwise (f32; d_out no multiple of 8, which TMA's
//    16-byte strides refuse). A block owns 256 output
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
//    on CUDA cores.
//  - Decode (up to 64 rows). One block per (row, 256 columns): each lane
//    owns 8 columns, read from one rank row of B in a 16-byte load, the
//    8 warps split the live rank rows, their partials added in warp
//    order; up to 16 rows B's first rank rows are issued before y is
//    loaded, so a launch is one round trip for idx and live and one for B
//    and y (past 16 rows, 1,024 blocks at 64, y first). A block per (128
//    columns, distinct slot), which read B once for all the rows of a
//    slot, measured slower at 32 and 64 rows on the H100 (7.7-9.3 us in a
//    graph against 5.9-6.3: the rows' grouping and y's load after it are
//    two more round trips than B's bytes from L2 cost).
//    It takes the shrink's f32 y and rounds each value to B's dtype as it
//    loads it (what y.to(b.dtype) gives), so no cast launch stands
//    between the pair, and is launched with programmatic dependent
//    launch: it prefetches B into L2 while the shrink runs and waits for
//    y only then.
// Widths: any d_in and d_out, as the Pallas kernels' _fit_block takes them
// (src/repro/kernels/bgmv.py:40-47). Where d_in (shrink) or d_out (expand)
// is a multiple of 8, x, B and out move 16 bytes at a time; otherwise the
// row-tile and decode kernels are instantiated with element copies and
// stores (kVec false), zero past the width, so a partial k-step of 16 sums
// zeros. TMA needs 16-byte strides, so only such widths take the wgmma
// shrink and expand. r_max
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

// ------------------------------------------------ decode: rows by slot ----

constexpr int kDecRows = 64;                // rows the decode kernels take
constexpr int kDThr = 128;                  // threads a decode block: 4 warps

// A decode block's slot, as its prologue finds it.
struct DecSlot {
  int s;                      // the k-th distinct slot (-1: fewer slots)
  int m;                      // its rows
  int ncol;                   // their widest live width, rounded up to 8
  unsigned zero[2];           // the rows without an adapter, a bit a row
  int rlist[kDecRows];        // its rows, in row order
  int rlive[kDecRows];        // and their live widths
};

__device__ __forceinline__ bool dec_zero_row(const DecSlot& g, int r) {
  return (g.zero[r >> 5] >> (r & 31)) & 1u;
}

// The decode prologue, shared by both decode kernels, in one warp (lane l
// holds rows l and l + 32 of [0, rows)): each row's slot (-1: no adapter)
// and live width; the first row of each distinct slot, in row order,
// numbers the slots (warp match and ballots, no block barrier), and `k`
// (the block's y) picks one. Writes *out, read after a __syncthreads().
__device__ __forceinline__ void decode_group(
    const int* __restrict__ idx, const int* __restrict__ live, int rows,
    int r_max, int slots, int k, DecSlot* out) {
  const int lane = threadIdx.x & 31;
  int sl[2], lv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {             // both loads in flight at once
    const int r = lane + 32 * h;
    sl[h] = r < rows ? idx[r] : -1;
    lv[h] = r < rows ? live[r] : 0;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (sl[h] < 0 || sl[h] >= slots) sl[h] = -1;
    lv[h] = sl[h] < 0 ? 0 : max(0, min(lv[h], r_max));
  }
  bool first[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {             // every lane takes the match
    const unsigned peers = __match_any_sync(0xffffffffu, sl[h]);
    first[h] = sl[h] >= 0 && lane == __ffs(peers) - 1;
  }
#pragma unroll
  for (int j = 0; j < 32; ++j)              // and no row of the first half
    first[1] &= __shfl_sync(0xffffffffu, sl[0], j) != sl[1];
  const unsigned long long f =
      __ballot_sync(0xffffffffu, first[0]) |
      (unsigned long long)__ballot_sync(0xffffffffu, first[1]) << 32;
  const unsigned z0 = __ballot_sync(0xffffffffu, lane < rows && sl[0] < 0);
  const unsigned z1 =
      __ballot_sync(0xffffffffu, lane + 32 < rows && sl[1] < 0);
  int s = -1, m = 0, ncol = 0;
  if (k < __popcll(f)) {                    // uniform
    unsigned long long g = f;
    for (int i = 0; i < k; ++i) g &= g - 1;
    const int u = __ffsll((long long)g) - 1;
    s = __shfl_sync(0xffffffffu, u < 32 ? sl[0] : sl[1], u & 31);
    const bool in0 = sl[0] == s, in1 = sl[1] == s;
    const unsigned b0 = __ballot_sync(0xffffffffu, in0);
    const unsigned b1 = __ballot_sync(0xffffffffu, in1);
    m = __popc(b0) + __popc(b1);
    ncol = (__reduce_max_sync(0xffffffffu,
                              max(in0 ? lv[0] : 0, in1 ? lv[1] : 0)) + 7) /
           8 * 8;
    const unsigned below = (1u << lane) - 1u;
    if (in0) {
      out->rlist[__popc(b0 & below)] = lane;
      out->rlive[__popc(b0 & below)] = lv[0];
    }
    if (in1) {
      out->rlist[__popc(b0) + __popc(b1 & below)] = lane + 32;
      out->rlive[__popc(b0) + __popc(b1 & below)] = lv[1];
    }
  }
  if (lane == 0) {
    out->s = s;
    out->m = m;
    out->ncol = ncol;
    out->zero[0] = z0;
    out->zero[1] = z1;
  }
}

// The hardware cluster barrier in two halves: arrive, then wait (release
// and acquire; `relaxed` arrives without ordering memory).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ------------------------------------------------ shrink: decode ----

constexpr int kDCols = 16;                  // rank columns a block
constexpr int kMaxTileSplit = 8;            // blocks a cluster: portable

template <typename T> struct DecCfg;
template <> struct DecCfg<bf16> {
  static constexpr int kSD = 128;           // d a stage
  static constexpr int kLdx = kSD + 8, kLda = kDCols + 8;   // ldmatrix pad
};
template <> struct DecCfg<float> {
  static constexpr int kSD = 64;
  static constexpr int kLdx = kSD + 4, kLda = kDCols + 4;
};

// rows padded to whole 16-row mma tiles, at most kDecRows
__host__ __device__ constexpr int dec_rows_pad(int rows) {
  return rows >= kDecRows ? kDecRows : (rows + 15) / 16 * 16;
}

// the ring's stages: four, three where the rows (padded) pass 32, so that
// two blocks fit an SM at 64 rows (one a SM left a 64-row launch of 128
// blocks in clusters of 8 a second wave)
__host__ __device__ constexpr int dec_stages(int mp) {
  return mp <= 32 ? 4 : 3;
}

// the ring (x of mp rows, A; the bf16 partials over it after the loop),
// the f32 partials beside it (f32 adds into them stage by stage), and the
// inbox the cluster's blocks push their partial sums into: split x
// ceil(mp / split) rows of kDCols
template <typename T>
constexpr size_t dec_shrink_smem(int mp, int split) {
  using C = DecCfg<T>;
  constexpr bool kBF = std::is_same<T, bf16>::value;
  return sizeof(T) * dec_stages(mp) *
             ((size_t)mp * C::kLdx + (size_t)C::kSD * C::kLda) +
         sizeof(float) * ((kBF ? 0 : 4 * (size_t)mp * kDCols) +
                          (size_t)split * ((mp + split - 1) / split) *
                              kDCols);
}

// Block (part, g, k) of a launch of `split` blocks a cluster (x: g *
// split + part; y: k): y[rows of the k-th distinct slot s, c0 : c0 +
// kDCols] (c0 = g * kDCols), the cluster's part-th block reducing d in
// [part * d_chunk, (part + 1) * d_chunk). Each stage of kSD d brings
// A[s][kSD d, the block's columns below the slot's widest live width] and
// x[the slot's rows] (gathered, zero past d_chunk and in the padding rows)
// into a ring of S stages (cp.async, 16 bytes a copy; 4 bytes where d_in
// is no multiple of 8), so a block reads its slice of A once for every row
// of its slot, with its whole slice in flight at d_in 4,096 (split 8, four
// stages of 128), a commit group a stage. bf16: warp w takes k-steps w
// and w + 4 of a stage on the tensor cores (mma.sync m16n8k16, f32
// accumulate; a stage's sum added on the CUDA cores), the slot's rows in
// 16-row tiles; f32 on the CUDA cores, lane = column, warp = a quarter of
// the stage's d. The warps'
// partials are added in warp order; then each block pushes its partial of
// every row into the inbox of the block that writes that row (part p: a
// 1 / split share of the slot's rows; distributed shared memory), one
// cluster barrier, and each block adds its inbox in rank order: no
// atomics, the sums repeat bitwise. Launched with programmatic dependent
// launch: it lets the expand after it start at once and waits for x's
// writer only before its first read.
template <typename T, bool kVec, int S>
__global__ void __launch_bounds__(kDThr) lora_shrink_decode_kernel(
    const T* __restrict__ x, const T* __restrict__ a,
    const int* __restrict__ idx, const int* __restrict__ live,
    float* __restrict__ y, int rows, int d_in, int r_max, int slots,
    int d_chunk, int split) {
  using C = DecCfg<T>;
  constexpr int VEC = 16 / sizeof(T);       // elements a 16-byte copy
  constexpr bool kBF = std::is_same<T, bf16>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ DecSlot grp;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int part = (int)blockIdx.x % split;
  const int k = blockIdx.y, c0 = (int)blockIdx.x / split * kDCols;
  const int cw = min(kDCols, r_max - c0);   // the block's columns (8k)
  const int lo = part * d_chunk, hi = min(d_in, lo + d_chunk);
  const int nk = hi > lo ? (hi - lo + C::kSD - 1) / C::kSD : 0;
  const int mp = dec_rows_pad(rows);
  T* xs = reinterpret_cast<T*>(smem_raw);
  T* as = xs + S * mp * C::kLdx;
  float* beside = reinterpret_cast<float*>(as + S * C::kSD * C::kLda);
  float* partial = kBF ? reinterpret_cast<float*>(smem_raw) : beside;
  float* inbox = kBF ? beside : beside + 4 * mp * kDCols;
  const int per_max = (mp + split - 1) / split;
  // x's rows start 4-byte aligned: bf16 pairs can be copied 4 bytes a copy
  const bool pairs = d_in % 2 == 0 && (reinterpret_cast<size_t>(x) & 3) == 0;

  if (split > 1) cluster_arrive_relaxed();  // started: waited for below
  rt::grid_dep_wait();

  // A[sa][stage kt, columns [c0, c0 + na)] into ring buffer `buf`, by
  // threads [t0, t0 + nt)
  auto load_a = [&](int buf, int kt, int sa, int na, int t0, int nt) {
    const T* as_g = a + (size_t)sa * d_in * r_max + c0;
    const int d0 = lo + kt * C::kSD;
    T* ab = as + buf * C::kSD * C::kLda;
    constexpr int AC = kDCols / VEC;        // copies a d row of A
    for (int i = tid - t0; i < C::kSD * AC; i += nt) {
      const int r = i / AC, c = (i % AC) * VEC, d = d0 + r;
      const bool ok = d < hi && c < na;     // dead columns are never read
      const T* src = ok ? as_g + (size_t)d * r_max + c : as_g;
      rt::cp_async16(ab + r * C::kLda + c, src, ok);
    }
  };
  // x of stage kt into rows [r0, r1) of ring buffer `buf`: row r from x's
  // row src(r) (-1: zeros), zero past hi, by threads [t0, t0 + nt)
  auto load_x = [&](int buf, int kt, int r0, int r1, auto src, int t0,
                    int nt) {
    const int d0 = lo + kt * C::kSD;
    T* xb = xs + buf * mp * C::kLdx;
    if constexpr (kVec) {
      constexpr int XC = C::kSD / VEC;      // copies a row of x
      for (int i = tid - t0; i < (r1 - r0) * XC; i += nt) {
        const int r = r0 + i / XC, d = d0 + (i % XC) * VEC, u = src(r);
        const bool ok = u >= 0 && d < hi;
        rt::cp_async16(xb + r * C::kLdx + (i % XC) * VEC,
                       ok ? x + (size_t)u * d_in + d : x, ok);
      }
    } else if (sizeof(T) == 4 || pairs) {
      // 4-byte copies: an f32 element, or two bf16 at an even d_in (hi is
      // even then, so a pair that starts below hi ends below it)
      constexpr int E = 4 / sizeof(T);      // elements a copy
      for (int i = tid - t0; i < (r1 - r0) * C::kSD / E; i += nt) {
        const int r = r0 + i / (C::kSD / E), c = i % (C::kSD / E) * E;
        const int d = d0 + c, u = src(r);
        const bool ok = u >= 0 && d < hi;
        rt::cp_async4z(xb + r * C::kLdx + c,
                       ok ? x + (size_t)u * d_in + d : x, ok);
      }
    } else {
      // bf16 at an odd d_in: element by element (the buffer was read
      // before the __syncthreads() that precedes this copy, so plain stores
      // may land in it at once)
      for (int i = tid - t0; i < (r1 - r0) * C::kSD; i += nt) {
        const int r = r0 + i / C::kSD, d = d0 + i % C::kSD, u = src(r);
        xb[r * C::kLdx + i % C::kSD] = u >= 0 && d < hi
            ? x[(size_t)u * d_in + d] : rt::from_f32<T>(0.f);
      }
    }
  };

  if (warp == 0) decode_group(idx, live, rows, r_max, slots, k, &grp);
  __syncthreads();
  const int s = grp.s, m = grp.m;
  if (k == 0 && part == 0 && (grp.zero[0] | grp.zero[1]))
    for (int i = tid; i < rows * cw; i += kDThr)   // rows without an adapter
      if (dec_zero_row(grp, i / cw))
        y[(size_t)(i / cw) * r_max + c0 + i % cw] = 0.f;
  const int nc = s >= 0 ? min(cw, grp.ncol - c0) : 0;   // columns computed
  if (nc <= 0) {                            // no slot, or past every live
    if (s >= 0 && part == 0)                // width of its rows
      for (int i = tid; i < m * cw; i += kDThr)
        y[(size_t)grp.rlist[i / cw] * r_max + c0 + i % cw] = 0.f;
    return;                                 // (the whole cluster returns)
  }
  const int mr = (m + 15) / 16 * 16;        // x rows the tiles read
  auto rows_of_s = [&](int r) { return r < m ? grp.rlist[r] : -1; };
#pragma unroll
  for (int st = 0; st < S; ++st) {          // a commit group a stage
    if (st < nk) {
      load_a(st, st, s, nc, 0, kDThr);
      load_x(st, st, 0, mr, rows_of_s, 0, kDThr);
    }
    rt::cp_async_commit();
  }

  if constexpr (!kBF)
    for (int i = tid; i < 4 * mp * kDCols; i += kDThr)
      if (i / kDCols % mp < m) partial[i] = 0.f;
  const int mt_n = mr / 16;                 // 16-row tiles of the slot
  float acc[kBF ? 4 : 1][kDCols / 8][4];
#pragma unroll
  for (int mt = 0; mt < (kBF ? 4 : 1); ++mt)
#pragma unroll
    for (int n = 0; n < kDCols / 8; ++n)
      acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    rt::cp_async_wait<S - 1>();
    __syncthreads();                        // stage kt landed
    const T* xb = xs + (kt % S) * mp * C::kLdx;
    const T* ab = as + (kt % S) * C::kSD * C::kLda;
    if constexpr (kBF) {
      float pr[4][kDCols / 8][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int n = 0; n < kDCols / 8; ++n)
          pr[mt][n][0] = pr[mt][n][1] = pr[mt][n][2] = pr[mt][n][3] = 0.f;
#pragma unroll
      for (int j = 0; j < C::kSD / 64; ++j) {
        const int ks = warp + 4 * j;        // 16 d a k-step
        unsigned bv[kDCols / 16][4];
#pragma unroll
        for (int np = 0; np < kDCols / 16; ++np)
          if (np * 16 < nc)
            rt::ldsm_x4_trans(bv[np], ab + (ks * 16 + (lane & 7) +
                                            ((lane >> 3) & 1) * 8) * C::kLda +
                                          np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          if (mt >= mt_n) break;
          unsigned af[4];
          rt::ldsm_x4(af, xb + (mt * 16 + (lane & 15)) * C::kLdx + ks * 16 +
                              (lane >> 4) * 8);
#pragma unroll
          for (int np = 0; np < kDCols / 16; ++np) {
            if (np * 16 < nc)
              rt::mma_bf16(pr[mt][2 * np], af, bv[np][0], bv[np][1]);
            if (np * 16 + 8 < nc)
              rt::mma_bf16(pr[mt][2 * np + 1], af, bv[np][2], bv[np][3]);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int n = 0; n < kDCols / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][n][e] += pr[mt][n][e];
    } else {
      // lane = column, warp = d [warp * kSD / 4, ...) of the stage; the
      // stage's sum a row added into the warp's partial
      constexpr int QD = C::kSD / 4;
      if (lane < nc)
        for (int r = 0; r < m; ++r) {
          float v = 0.f;
#pragma unroll 8
          for (int dd = 0; dd < QD; ++dd)
            v += rt::to_f32(xb[r * C::kLdx + warp * QD + dd]) *
                 rt::to_f32(ab[(warp * QD + dd) * C::kLda + lane]);
          partial[(warp * mp + r) * kDCols + lane] += v;
        }
    }
    __syncthreads();                        // stage kt read by every warp
    if (kt + S < nk) {
      load_a(kt % S, kt + S, s, nc, 0, kDThr);
      load_x(kt % S, kt + S, 0, mr, rows_of_s, 0, kDThr);
    }
    rt::cp_async_commit();
  }
  rt::cp_async_wait<0>();
  // the expand after this launch may start now: it prefetches B while
  // this block reduces (earlier, its loads would compete with A's)
  rt::grid_dep_launch();
  if constexpr (kBF) {
    // d[n][2h + e]: row 16 mt + lane / 4 + 8h, column 8n + 2 (lane % 4) + e
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      if (mt >= mt_n) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + (lane >> 2) + 8 * h;
#pragma unroll
        for (int n = 0; n < kDCols / 8; ++n)
          *reinterpret_cast<float2*>(partial + (warp * mp + r) * kDCols +
                                     n * 8 + (lane & 3) * 2) =
              make_float2(acc[mt][n][2 * h], acc[mt][n][2 * h + 1]);
      }
    }
  }
  __syncthreads();
  // the warps' partials in warp order, pushed to the block that writes the
  // row: part q writes rows [q * per, (q + 1) * per), into its inbox at
  // [this block's rank][row - q * per]
  const int per = (m + split - 1) / split;
  if (split > 1) cluster_wait();            // every block has started
  for (int i = tid; i < m * kDCols; i += kDThr) {
    float v = partial[i];
#pragma unroll
    for (int w = 1; w < 4; ++w) v += partial[w * mp * kDCols + i];
    const int r = i / kDCols, q = r / per;
    float* dst = inbox + (part * per_max + r - q * per) * kDCols + i % kDCols;
    if (split > 1) dst = cg::this_cluster().map_shared_rank(dst, q);
    *dst = v;
  }
  if (split > 1) {                          // every push landed
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  for (int i = tid; i < per * cw; i += kDThr) {
    const int j = i / cw, r = part * per + j, c = i % cw;
    if (r >= m) break;
    float v = 0.f;
    if (c < nc && c0 + c < grp.rlive[r])
      for (int q = 0; q < split; ++q)       // rank order
        v += inbox[(q * per_max + j) * kDCols + c];
    y[(size_t)grp.rlist[r] * r_max + c0 + c] = v;
  }
}

// -------------------------------------------------- shrink: row tiles ----

constexpr int kCols = 64;                   // rank columns a pass
constexpr int kLdp = kCols + 4;             // a partial's row (f32)

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

// -- bf16 row tiles: persistent, TMA + wgmma (d_in a multiple of 8) --

constexpr int kWD = 64;                     // d a TMA box: 128 bytes of bf16
constexpr int kSM = 64;                     // rows a tile: wgmma's M
constexpr int kSThreads = 160;              // a consumer warpgroup + a warp
constexpr int kSStages = 7;                 // x boxes in flight a block
constexpr int kSABoxes = 16;                // A's ring of boxes: 128 KiB
constexpr int kSPre = 4;                    // tiles of idx / live in flight
constexpr int kSXBytes = kSM * 128;         // a stage: x[tile, 64 d]
constexpr int kSABytes = kWD * 128;         // A[s][64 d, 64 columns]
constexpr int kSPartBytes = kSM * kLdp * 4;   // a block's partial sums
constexpr size_t kSSmem = (size_t)kSABoxes * kSABytes +
                          (size_t)kSStages * kSXBytes + 2 * kSPartBytes + 1024;

// An item of the walk, as the producer warp hands it to the consumers: a
// stage (x's box kt of a pass's d slice, read with A's box `abox` and a
// pair's second slot's `abox2`), or,
// with no stage, a pass past the slot's live columns or a tile with no
// adapter (zeros only), or the walk's end.
enum {
  kSTileFirst = 1,   // the tile's first item: its rows without an adapter
  kSStage = 2,       // a stage of a pass (else: zeros only)
  kSPassFirst = 4,
  kSPassLast = 8,
  kSPair = 16,       // a pass of two slots over one x stage
  kSEnd = 32
};
struct SItem {
  int row0;          // the tile: rows [row0, row0 + kSM)
  int s, c0, nc;     // the pass: slot, first column, columns computed
  int s2, nc2;       // a pair's second slot and its columns
  int abox, abox2;   // A's boxes this stage reads (-1: no stage)
  int flags;
  int info[kSM];     // row r: (slot + 2) << 16 | live (slot -2: past rows)
};
__device__ __forceinline__ int sinfo_slot(int v) { return (v >> 16) - 2; }
__device__ __forceinline__ int sinfo_live(int v) { return v & 0xffff; }

// y[row0 + r, c0 : c0 + ccount) = 0 for the rows r of the block's share
// [r0, r0 + per) whose slot is `s` (-1: no adapter), by 128 threads (t:
// this thread's index among them).
__device__ __forceinline__ void zero_rows(float* __restrict__ y,
                                          const int* info, int s, int row0,
                                          int r0, int per, int r_max,
                                          int c0, int ccount, int t) {
  for (int i = t; i < per * (ccount / 4); i += 128) {
    const int r = r0 + i / (ccount / 4), c = i % (ccount / 4) * 4;
    if (sinfo_slot(info[r]) == s)
      *reinterpret_cast<float4*>(y + (size_t)(row0 + r) * r_max + c0 + c) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Built with -DLORA_SHRINK_STAMPS (kernel_ab.py --shrink-probe, for
// measurement only), thread 0 of each block's consumers splits its time
// into the phases below by clock64() and adds them, its block's %globaltimer
// span and its exchanges into g_shrink_stamps (rt_lora_shrink_stamps reads
// and clears it); built without, the stamps compile to nothing.
enum {
  kStOther,     // zeros, releases, bookkeeping
  kStFull,      // waits for a stage's loads (x and A)
  kStMma,       // the stage's products and their f32 sums
  kStWait,      // the cluster barrier before the last exchange's sums
  kStReduce,    // the sums over the cluster's partials and y's stores
  kStExtra,     // the extra barriers (a pair's buffers, the kernel's end)
  kStPut,       // the partials written and the cluster barrier's arrive
  kStCycles,    // every phase: the block's clock64() span
  kStNs,        // the block's %globaltimer span
  kStBlocks,
  kStExchanges,
  kStCount
};
#ifdef LORA_SHRINK_STAMPS
__device__ unsigned long long g_shrink_stamps[kStCount];
__device__ __forceinline__ unsigned long long shrink_globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
struct SStamps {
  unsigned long long t[kStCount];
  long long last, first;
  unsigned long long ns0;
  __device__ void start() {
    last = first = clock64();
    ns0 = shrink_globaltimer();
    for (int k = 0; k < kStCount; ++k) t[k] = 0;
  }
  __device__ void tick(int k) {
    const long long now = clock64();
    t[k] += now - last;
    last = now;
  }
  __device__ void flush(int exchanges) {
    tick(kStOther);
    t[kStCycles] = last - first;
    t[kStNs] = shrink_globaltimer() - ns0;
    t[kStBlocks] = 1;
    t[kStExchanges] = exchanges;
    for (int k = 0; k < kStCount; ++k) atomicAdd(&g_shrink_stamps[k], t[k]);
  }
};
#else
struct SStamps {
  __device__ void start() {}
  __device__ void tick(int) {}
  __device__ void flush(int) {}
};
#endif

// y = x @ A[idx] row by row over row tiles of kSM rows, persistent: the
// blocks of a cluster (`split`, block `part` over d in [part * d_chunk,
// +d_chunk), whole TMA boxes) walk the same contiguous run of tiles [T c /
// G, T (c + 1) / G) of the T tiles, cluster c of G. Warp 4 (the producer)
// copies each tile's idx and live kSPre tiles ahead (cp.async), finds the
// tile's distinct slots in row order (a warp vote where one slot holds
// every row) and the widest live width of each, rounded up to 8 (ncol),
// and hands out the walk through a ring of kSStages stages (an mbarrier
// full and empty each): a pass a (slot, 64 rank columns below ncol), a
// stage a 64-wide box of d of the tile's x, loaded by TMA (zero past
// `rows` and d_in), with A[s][the same 64 d, 64 columns] beside it
// through a ring of kSABoxes boxes. A tile's slots go two to a pass: each
// x box is multiplied by both slots' A boxes, so x is read once for the
// pair (runs of 32 rows a slot). A is read again for every tile: holding
// a block's slice of it across the tiles of one slot gave no gain on the
// H100 (a stage takes ~0.35 us a block either way, and the parent's
// kernel ran no faster with A's loads cut: kernel_ab.py --shrink-probe).
// Warpgroup 0 (the consumers) multiplies two stages of a pass, or a
// pair's two slots, at a time (wgmma m64n64k16, bf16 in, f32 out, 4
// k-steps a stage, one wait for both) and adds each stage's products
// into its slot's f32 total on the CUDA cores, in stage order: the tensor
// cores' f32 adds round toward zero, which over d_in 4096 drifts past the
// f32 limit. At a pass's end the totals go to partial buffers (two; a
// pair fills both) and the cluster adds them in rank order through
// distributed shared memory (no atomics: the sum repeats bitwise), block
// `part` its 1 / split of the tile's rows; the cluster barrier that
// guards a buffer is waited for only after the next pass is computed
// (the producer warp takes part in it, so it runs at most about a pass
// ahead), with one more barrier where a pair's two buffers and the last
// exchange's are more than two. Rows of other slots are multiplied too
// and never stored; columns past a row's live width and rows without an
// adapter are zeros. Launched with programmatic dependent launch: a block
// sets up while the kernel ahead finishes, and reads or writes nothing of
// the tensors before it has. What bounds it on the H100 (kernel_ab.py
// --shrink-probe, --sweep): x's stream from memory at the full card (a
// TMA stream of x alone takes ~16 us at 4,096 rows after an L2 flush and
// ~98 at 32,768), a block's stage pipeline (~0.35 us a stage, ~45 GB/s a
// block at most) where few blocks work, and ~3 us a cluster's exchange
// at split 2 and 8 (the stamps: its barrier ~0.2, the sums over DSMEM
// with y's stores ~1.5, the partials written ~0.6, the closing barrier
// ~0.7; loading all of a thread's partials before the first sum was
// slower).
__global__ void __launch_bounds__(kSThreads, 1)
    lora_shrink_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                             const __grid_constant__ CUtensorMap ta,
                             const int* __restrict__ idx,
                             const int* __restrict__ live,
                             float* __restrict__ y, int rows, int d_in,
                             int r_max, int slots, int d_chunk, int split) {
  constexpr int S = kSStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* abase =
      smem_raw + ((1024 - (rt::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* xring = abase + kSABoxes * kSABytes;
  float* pbuf = reinterpret_cast<float*>(xring + S * kSXBytes);
  __shared__ __align__(8) uint64_t full[S], empty[S];
  __shared__ SItem meta[S];
  __shared__ int pidx[kSPre][kSM], plive[kSPre][kSM];
  // a pass's rows, for its sums: written at its last stage, read after
  // the next pass (three, so a thread still summing exchange e - 1 never
  // sees e + 2's rows land)
  __shared__ int cinfo[3][kSM];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int part = (int)blockIdx.x % split;
  const int cl = (int)blockIdx.x / split, ncl = (int)gridDim.x / split;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      rt::mbar_init(&full[i], 1);
      rt::mbar_init(&empty[i], 128);        // every consumer thread
    }
    rt::fence_barrier_init();
  }
  __syncthreads();
  const int tiles = (rows + kSM - 1) / kSM;
  const int w0 = (int)((long long)tiles * cl / ncl);
  const int w1 = (int)((long long)tiles * (cl + 1) / ncl);
  const int lo = part * d_chunk, hi = min(d_in, lo + d_chunk);
  const int nk = hi > lo ? (hi - lo + kWD - 1) / kWD : 0;
  const int nst = max(nk, 1);               // a pass's stage items
  const int per = kSM / split;              // rows a block sums and writes
  // launched with programmatic dependent launch: nothing of idx, live, x,
  // A or y is touched before the kernel ahead has finished
  rt::grid_dep_wait();

  if (warp == 4) {
    // ------------------------------------------------------ producer ----
    if (lane == 0) {
      rt::prefetch_map(&tx);
      rt::prefetch_map(&ta);
    }
    int item = 0;                           // items handed out
    int psize = 0;                          // buffers of the last exchange
    int abump = 0;                          // A boxes loaded so far
    auto fetch_rows = [&](int w) {          // tile w's idx and live
      if (w < w1) {
        const int row0 = w * kSM, slot = (w - w0) % kSPre;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + lane + 32 * h;
          const bool in = r < rows;
          rt::cp_async4z(&pidx[slot][lane + 32 * h], in ? idx + r : idx, in);
          rt::cp_async4z(&plive[slot][lane + 32 * h], in ? live + r : live,
                         in);
        }
      }
      rt::cp_async_commit();
    };
    int info[2] = {0, 0};                   // this lane's rows' info
    // hand out one item: wait for its stage, write it (every lane: its
    // rows' info), and with a stage, load x's box kt and A's box kt of
    // (s, c0) into A's box `ab` (and of a pair's (s2, c0) into box `ab2`)
    auto emit = [&](int row0, int s, int c0, int nc, int kt, int ab,
                    int flags, int s2 = -1, int nc2 = 0, int ab2 = -1) {
      const int st = item % S;
      rt::mbar_wait(&empty[st], ((item / S) & 1) ^ 1);
      SItem& m = meta[st];
      m.info[lane] = info[0];
      m.info[lane + 32] = info[1];
      const bool load_x = (flags & kSStage) && kt < nk;
      const bool pair = flags & kSPair;
      __syncwarp();
      if (lane == 0) {
        m.row0 = row0;
        m.s = s;
        m.c0 = c0;
        m.nc = nc;
        m.s2 = s2;
        m.nc2 = nc2;
        m.abox = load_x ? ab : -1;
        m.abox2 = load_x && pair ? ab2 : -1;
        m.flags = flags;
        rt::mbar_expect_tx(&full[st],
                           load_x ? kSXBytes + (pair ? 2 : 1) * kSABytes
                                  : 0);
        if (load_x) {
          const int d0 = lo + kt * kWD;
          rt::tma_load_4d(xring + st * kSXBytes, &tx, &full[st], d0, row0,
                          0, 0);
          rt::tma_load_4d(abase + ab * kSABytes, &ta, &full[st], c0, d0, s,
                          0);
          if (pair)
            rt::tma_load_4d(abase + ab2 * kSABytes, &ta, &full[st], c0, d0,
                            s2, 0);
        }
      }
      __syncwarp();
      ++item;
    };
    // the cluster barriers of an exchange of `need` partial buffers, as
    // the consumers pass them (see there): the last exchange's, and one
    // more where its buffers and these are more than two
    auto exchange = [&](int need) {
      if (split > 1) {
        if (psize > 0) cluster_wait();
        if (psize + need > 2) {
          cluster_arrive();
          cluster_wait();
        }
        cluster_arrive();
      }
      psize = need;
    };
    // a pass over (s, c0): its stages, each with the next box of A's ring
    // (two at most an item, so a box is loaded again 8 items later, when
    // the consumers have read it: the ring of stages is 7)
    auto pass = [&](int row0, int s, int c0, int nc, int first) {
      for (int kt = 0; kt < nst; ++kt)
        emit(row0, s, c0, nc, kt, abump++ % kSABoxes,
             kSStage | (kt == 0 ? kSPassFirst | first : 0) |
                 (kt == nst - 1 ? kSPassLast : 0));
      exchange(1);
    };
    // a pass over two slots' (s, c0) and (s2, c0): each stage's x box read
    // once for both
    auto pair_pass = [&](int row0, int s, int nc, int s2, int nc2, int c0,
                         int first) {
      for (int kt = 0; kt < nst; ++kt) {
        const int ab = abump++ % kSABoxes, ab2 = abump++ % kSABoxes;
        emit(row0, s, c0, nc, kt, ab,
             kSStage | kSPair | (kt == 0 ? kSPassFirst | first : 0) |
                 (kt == nst - 1 ? kSPassLast : 0),
             s2, nc2, ab2);
      }
      exchange(2);
    };

    for (int w = w0; w < w0 + kSPre; ++w) fetch_rows(w);
    for (int w = w0; w < w1; ++w) {
      const int row0 = w * kSM;
      rt::cp_async_wait<kSPre - 1>();       // tile w's idx and live
      const int slot = (w - w0) % kSPre;
      int sl[2], lv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool in = row0 + lane + 32 * h < rows;
        sl[h] = in ? pidx[slot][lane + 32 * h] : -1;
        lv[h] = in ? plive[slot][lane + 32 * h] : 0;
        if (sl[h] < 0 || sl[h] >= slots) sl[h] = -1;
        lv[h] = sl[h] < 0 ? 0 : max(0, min(lv[h], r_max));
        info[h] = ((in ? sl[h] + 2 : 0) << 16) | lv[h];
      }
      __syncwarp();
      asm volatile("" ::: "memory");        // the slot is read before
      fetch_rows(w + kSPre);                // its next copy lands in it
      int first = kSTileFirst;
      // a pass a 64 columns of slot s, below its rows' widest live width
      // rounded up to 8 (ncol)
      auto passes = [&](int s, int ncol) {
        for (int c0 = 0; c0 < r_max; c0 += kCols) {
          const int nc = min(kCols, ncol - c0);
          if (nc > 0)
            pass(row0, s, c0, nc, first);
          else                              // past every live width: zeros
            emit(row0, s, c0, nc, 0, -1, first);
          first = 0;
        }
      };
      const int s0 = __shfl_sync(0xffffffffu, sl[0], 0);
      if (__all_sync(0xffffffffu, sl[0] == s0 && sl[1] == s0)) {
        // one slot, or none, on every row
        if (s0 < 0)
          emit(row0, -1, 0, 0, 0, -1, first);
        else
          passes(s0, (__reduce_max_sync(0xffffffffu, max(lv[0], lv[1])) +
                      7) / 8 * 8);
        continue;
      }
      // the first row of each distinct slot, in row order
      bool fst[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned peers = __match_any_sync(0xffffffffu, sl[h]);
        fst[h] = sl[h] >= 0 && lane == __ffs(peers) - 1;
      }
#pragma unroll
      for (int j = 0; j < 32; ++j)
        fst[1] &= __shfl_sync(0xffffffffu, sl[0], j) != sl[1];
      unsigned long long f =
          __ballot_sync(0xffffffffu, fst[0]) |
          (unsigned long long)__ballot_sync(0xffffffffu, fst[1]) << 32;
      auto next_slot = [&](int& s, int& ncol) {
        const int u = __ffsll((long long)f) - 1;
        f &= f - 1;
        s = __shfl_sync(0xffffffffu, u < 32 ? sl[0] : sl[1], u & 31);
        ncol = (__reduce_max_sync(0xffffffffu,
                                  max(sl[0] == s ? lv[0] : 0,
                                      sl[1] == s ? lv[1] : 0)) +
                7) / 8 * 8;
      };
      while (f != 0) {                      // uniform: a slot at a time
        int s, ncol;
        next_slot(s, ncol);
        if (f == 0) {                       // the last of an odd count
          passes(s, ncol);
          continue;
        }
        // two slots a pass, x's stages read once for both
        int s2, ncol2;
        next_slot(s2, ncol2);
        for (int c0 = 0; c0 < r_max; c0 += kCols) {
          const int nc = min(kCols, ncol - c0), nc2 = min(kCols, ncol2 - c0);
          if (nc > 0 && nc2 > 0) {
            pair_pass(row0, s, nc, s2, nc2, c0, first);
          } else {
            if (nc > 0) pass(row0, s, c0, nc, first);
            else emit(row0, s, c0, nc, 0, -1, first);
            if (nc2 > 0) pass(row0, s2, c0, nc2, 0);
            else emit(row0, s2, c0, nc2, 0, -1, 0);
          }
          first = 0;
        }
      }
    }
    rt::cp_async_wait<0>();
    // the kernel after this one may start setting up: every load is issued
    rt::grid_dep_launch();
    emit(0, -1, 0, 0, 0, -1, kSEnd);
    if (split > 1 && psize > 0) {           // the consumers' last barrier
      cluster_wait();
      cluster_arrive();
    }
    return;
  }

  // -------------------------------------------------------- consumers ----
  const int g = lane >> 2, q = lane & 3;
  float acc[kCols / 2], acc2[kCols / 2], pa[kCols / 2], pb[kCols / 2];
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) acc[i] = acc2[i] = 0.f;
  int ex = 0;                               // exchanges begun
  // the last exchange: the buffers it filled (0: none; a pair's two),
  // which other threads or blocks may still read, whether its sums are
  // still to take (split > 1: after the next pass), its first buffer,
  // its tile and passes
  int held = 0, p_b = 0, p_ex = 0, p_row0 = 0, p_c0 = 0;
  int p_s = 0, p_nc = 0, p_s2 = 0, p_nc2 = 0;
  bool pend = false;
  // every consumer thread arrives (one lane a warp behind a branch also
  // works; the stage's reads are all this thread's)
  auto release = [&](int st) { rt::mbar_arrive(&empty[st]); };
  SStamps stamps;
  if (tid == 0) stamps.start();
  // a phase of thread 0's time ends (LORA_SHRINK_STAMPS only)
  auto tick = [&](int k) {
    if (tid == 0) stamps.tick(k);
  };
  // the sums of buffer b (exchange e's rows) over the cluster's partials
  // in rank order, for this block's rows of slot s; columns at or past nc
  // or a row's live width are 0
  auto reduce = [&](int b, int e, int row0, int s, int c0, int nc) {
    const int ccount = min(kCols, r_max - c0);
    const float* mine = pbuf + b * (kSPartBytes / 4);
    const int* inf = cinfo[e % 3];
    for (int i = tid; i < per * (ccount / 4); i += 128) {
      const int r = part * per + i / (ccount / 4), c = i % (ccount / 4) * 4;
      if (sinfo_slot(inf[r]) != s) continue;
      const int lv = min(nc, sinfo_live(inf[r]) - c0);  // [c, lv) live
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < lv) {
#pragma unroll
        for (int k = 0; k < kMaxTileSplit; ++k) {
          if (k >= split) break;
          const float* src = split > 1
              ? cg::this_cluster().map_shared_rank(mine, k) : mine;
          const float4 p =
              *reinterpret_cast<const float4*>(src + r * kLdp + c);
          v.x += p.x;
          v.y += p.y;
          v.z += p.z;
          v.w += p.w;
        }
        if (c + 1 >= lv) v.y = 0.f;
        if (c + 2 >= lv) v.z = 0.f;
        if (c + 3 >= lv) v.w = 0.f;
      }
      *reinterpret_cast<float4*>(y + (size_t)(row0 + r) * r_max + c0 + c) =
          v;
    }
  };
  auto reduce_pending = [&]() {
    reduce(p_b, p_ex, p_row0, p_s, p_c0, p_nc);
    if (held == 2) reduce(p_b ^ 1, p_ex, p_row0, p_s2, p_c0, p_nc2);
  };
  // d[4i + 2h + e]: row 16 warp + lane / 4 + 8h, column 8i + 2 (lane % 4)
  // + e, into partial buffer b
  auto put = [&](const float (&a)[kCols / 2], int b) {
    float* out = pbuf + b * (kSPartBytes / 4);
#pragma unroll
    for (int i = 0; i < kCols / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(out + (warp * 16 + g + 8 * h) * kLdp +
                                   8 * i + 2 * q) =
            make_float2(a[4 * i + 2 * h], a[4 * i + 2 * h + 1]);
  };
  for (int item = 0;;) {
    const int st = item % S;
    tick(kStOther);
    rt::mbar_wait(&full[st], (item / S) & 1);
    tick(kStFull);
    const SItem& m = meta[st];
    const int flags = m.flags;
    if (flags & kSEnd) break;
    const int row0 = m.row0, s = m.s, c0 = m.c0, nc = m.nc;
    if (flags & kSTileFirst)                // rows without an adapter
      zero_rows(y, m.info, -1, row0, part * per, per, r_max, 0, r_max, tid);
    if (!(flags & kSStage)) {
      if (s >= 0)                           // a pass past every live width
        zero_rows(y, m.info, s, row0, part * per, per, r_max, c0,
                  min(kCols, r_max - c0), tid);
      release(st);
      ++item;
      continue;
    }
    const bool pair = flags & kSPair;
    if (flags & kSPassFirst) {
#pragma unroll
      for (int i = 0; i < kCols / 2; ++i) acc[i] = acc2[i] = 0.f;
    }
    // a single slot's pass takes two of its stages at a time where it goes
    // on past this one: both products in flight before one wait
    const bool two = !pair && !(flags & kSPassLast);
    const int st2 = (item + 1) % S;
    if (two) {
      tick(kStOther);
      rt::mbar_wait(&full[st2], ((item + 1) / S) & 1);
      tick(kStFull);
    }
    const int last = (two ? meta[st2].flags : flags) & kSPassLast;
    // x: K-major, SBO one 8-row atom, a k-step 32 bytes on; A: MN-major
    // (transpose bit), a k-step 16 rows of 128 bytes on
    const uint64_t da = rt::smem_desc(xring + st * kSXBytes, 16, 1024, 1);
    const uint64_t db =
        rt::smem_desc(abase + m.abox * kSABytes, kWD * 128, 1024, 1);
    if (m.abox >= 0 && (two || pair)) {
      // the second chain: the next stage's x and A, or this x and the
      // pair's second A
      const uint64_t da2 =
          two ? rt::smem_desc(xring + st2 * kSXBytes, 16, 1024, 1) : da;
      const uint64_t db2 = rt::smem_desc(
          abase + (two ? meta[st2].abox : m.abox2) * kSABytes, kWD * 128,
          1024, 1);
      rt::fence_regs(pa);
      rt::fence_regs(pb);
      rt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWD / 16; ++kk)
        rt::Wgmma<kCols>::template ss<0, 1>(pa, da + 2 * kk, db + 128 * kk,
                                            kk > 0);
#pragma unroll
      for (int kk = 0; kk < kWD / 16; ++kk)
        rt::Wgmma<kCols>::template ss<0, 1>(pb, da2 + 2 * kk,
                                            db2 + 128 * kk, kk > 0);
      rt::wgmma_commit();
      rt::wgmma_wait<0>();
      rt::fence_regs(pa);
      rt::fence_regs(pb);
#pragma unroll
      for (int i = 0; i < kCols / 2; ++i) acc[i] += pa[i];
      if (two) {
#pragma unroll
        for (int i = 0; i < kCols / 2; ++i) acc[i] += pb[i];
      } else {
#pragma unroll
        for (int i = 0; i < kCols / 2; ++i) acc2[i] += pb[i];
      }
    } else if (m.abox >= 0) {
      rt::fence_regs(pa);
      rt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWD / 16; ++kk)
        rt::Wgmma<kCols>::template ss<0, 1>(pa, da + 2 * kk, db + 128 * kk,
                                            kk > 0);
      rt::wgmma_commit();
      rt::wgmma_wait<0>();
      rt::fence_regs(pa);
#pragma unroll
      for (int i = 0; i < kCols / 2; ++i) acc[i] += pa[i];
    }
    tick(kStMma);
    const int s2 = m.s2, nc2 = m.nc2;
    if (last && tid < kSM) cinfo[ex % 3][tid] = m.info[tid];
    release(st);
    if (two) release(st2);
    item += two ? 2 : 1;
    if (!last) continue;
    // The pass's totals: exchange `ex` of one buffer (a pair: two). The
    // exchange before it is summed first (its cluster barrier waited for
    // only now, after this pass); where its buffers and these are more
    // than two, one more barrier lets every block finish reading them.
    const int need = pair ? 2 : 1;
    tick(kStOther);
    if (pend) {
      cluster_wait();                       // every partial of ex - 1
      tick(kStWait);
      reduce_pending();
      tick(kStReduce);
      pend = false;
    }
    const bool extra = held + need > 2;
    if (extra) {
      if (split > 1) {
        cluster_arrive();
        cluster_wait();
      } else {
        rt::named_sync(1, 128);
      }
      tick(kStExtra);
    }
    const int b = need == 2 || extra || held == 0 ? 0 : p_b ^ 1;
    put(acc, b);
    if (pair) put(acc2, b ^ 1);
    held = need;
    p_b = b;
    p_ex = ex;
    p_row0 = row0;
    p_c0 = c0;
    p_s = s;
    p_nc = nc;
    p_s2 = s2;
    p_nc2 = nc2;
    if (split > 1) {
      cluster_arrive();                     // partials of ex written
      tick(kStPut);
      pend = true;
    } else {
      rt::named_sync(1, 128);
      tick(kStPut);
      reduce_pending();
      tick(kStReduce);
    }
    ++ex;
  }
  if (pend) {
    tick(kStOther);
    cluster_wait();
    tick(kStWait);
    reduce_pending();
    tick(kStReduce);
    cluster_arrive();                       // every block's partials read
    cluster_wait();
    tick(kStExtra);
  }
  if (tid == 0) stamps.flush(ex);
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

// The cp.async tile kernel (f32, and bf16 at a d_in that is no multiple
// of 8): a tile holds at most min(slots, BM) distinct slots, one block
// each (y), `split` blocks a tile (x) in a cluster.
template <typename T, int BM>
rt::Launch tile_launch(int rows, int d_in, int slots, int split) {
  static_assert(tile_smem<T, BM>() >= BM * kLdp * sizeof(float),
                "the partials reuse the ring");
  const dim3 grid((rows + BM - 1) / BM * split, max(1, min(slots, BM)));
  const bool vec = d_in % rt::kVec == 0;
  if constexpr (std::is_same<T, bf16>::value) {
    return {(const void*)lora_shrink_tile_kernel<bf16, BM, false>, grid,
            2 * BM, tile_smem<bf16, BM>(), (unsigned)split};
  } else {
    return {vec ? (const void*)lora_shrink_tile_kernel<T, BM, true>
                : (const void*)lora_shrink_tile_kernel<T, BM, false>,
            grid, 2 * BM, tile_smem<T, BM>(), (unsigned)split};
  }
}

// x: split blocks (a cluster) a column group of kDCols, y: a block per
// distinct slot the rows can hold; each block's dynamic shared memory is
// sized for the launch's rows (padded to 16)
template <typename T>
rt::Launch dec_shrink_launch(int rows, int d_in, int r_max, int slots,
                             int split) {
  const int mp = dec_rows_pad(rows);
  const dim3 grid((r_max + kDCols - 1) / kDCols * split,
                  max(1, min(slots, rows)));
  const bool vec = d_in % rt::kVec == 0;
  const void* fn =
      dec_stages(mp) == 4
          ? (vec ? (const void*)lora_shrink_decode_kernel<T, true, 4>
                 : (const void*)lora_shrink_decode_kernel<T, false, 4>)
          : (vec ? (const void*)lora_shrink_decode_kernel<T, true, 3>
                 : (const void*)lora_shrink_decode_kernel<T, false, 3>);
  rt::Launch l{fn, grid, kDThr, dec_shrink_smem<T>(mp, split),
               (unsigned)split};
  l.pdl = true;
  return l;
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

// f32, and bf16 at a d_out that is no multiple of 8 (the wgmma kernel
// takes the others)
template <typename T>
rt::Launch expand_tile_launch(int r_max, int d_out, int row_blocks) {
  const bool multi = r_max > kER;
  const void* fn =
      multi ? (const void*)lora_expand_tile_kernel<T, true, false>
            : (const void*)lora_expand_tile_kernel<T, false, false>;
  if constexpr (std::is_same<T, float>::value)
    if (d_out % rt::kVec == 0)
      fn = multi ? (const void*)lora_expand_tile_kernel<T, true, true>
                 : (const void*)lora_expand_tile_kernel<T, false, true>;
  return {fn, dim3((d_out + kEN - 1) / kEN, row_blocks), kEThr,
          expand_tile_smem<T>()};
}

// ---------------------------- expand: persistent TMA + wgmma (bf16 B) ----

constexpr int kXM = 64;                     // rows a tile: wgmma's M
constexpr int kXThreads = 160;              // a consumer warpgroup + a warp
constexpr int kXBlocksPerSm = 2;
constexpr int kXPre = 4;                    // tiles of idx / live in flight
constexpr int kXMaxStages = 8;
// dynamic shared memory a block: an SM's 228 KB over its blocks, less
// the 1 KB the runtime keeps a block and the static part (8 KB at most)
constexpr int kXBudget = 233472 / kXBlocksPerSm - 9216;

// An item: one rank chunk (a 128-byte box of y's columns) of one slot's
// pass over one tile, as the producer warp hands it to the consumers.
enum { kXFirst = 1, kXLastChunk = 2, kXLastOfTile = 4, kXEnd = 8 };
struct XItem {
  int row0, n0;          // the tile: rows [row0, +kXM), columns [n0, +BN)
  int s;                 // the pass's slot (-1: a tile with no pass)
  int k0, ksteps;        // rank rows [k0, k0 + 16 ksteps) (0: none)
  int flags;
  int bbuf;              // the B buffer it reads
  int sl[kXM], lv[kXM];  // each row's slot (-1: a zero row), live width
};

// y of type TY (B's bf16, or the shrink's f32, rounded to bf16 as it is
// read), BN output columns a tile. A chunk is kK = one 128-byte box of
// y's columns (64 bf16, 32 f32): a ring stage holds y[tile rows, k0 : k0
// + kK]; two B buffers hold B[s][k0 : k0 + kK, n0 : n0 + BN] (boxes of
// 64 columns x 8 rank rows), all 128-byte swizzled as TMA writes them;
// two staged output tiles.
template <typename TY, int BN>
struct XCfg {
  static constexpr int kK = 128 / (int)sizeof(TY);
  static constexpr int kYBytes = kXM * 128;
  static constexpr int kBBytes = kK * BN * 2;
  static constexpr int kOutBytes = kXM * BN * 2;
  static constexpr int kFixed = 2 * kBBytes + 2 * kOutBytes + 1024;
  static constexpr int kFit = (kXBudget - kFixed) / kYBytes;
  static constexpr int kStages = kFit > kXMaxStages ? kXMaxStages : kFit;
  static_assert(kStages >= 4, "a ring of four stages at least");
  static constexpr size_t kSmem = (size_t)kStages * kYBytes + kFixed;
};

// A warp's A fragments of y for k-step kk of a stage (rows 16 warp + g
// and + 8, g = lane / 4, as wgmma's register A takes them: mma.sync
// m16n8k16's layout), rounded to bf16 (f32 y: what y.to(bf16) gives).
__device__ __forceinline__ void y_frags(const bf16*, const unsigned char* ys,
                                        int kk, int warp, int lane,
                                        uint32_t (&a)[4]) {
  const int row = warp * 16 + (lane & 15), chunk = 2 * kk + (lane >> 4);
  rt::ldsm_x4(a, ys + row * 128 + ((chunk ^ (row & 7)) << 4));
}
__device__ __forceinline__ void y_frags(const float*, const unsigned char* ys,
                                        int kk, int warp, int lane,
                                        uint32_t (&a)[4]) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {             // row + 8 (i & 1), col + 8 (i / 2)
    const int row = warp * 16 + g + 8 * (i & 1);
    const int chunk = 4 * kk + (q >> 1) + 2 * (i >> 1);
    const float2 v = *reinterpret_cast<const float2*>(
        ys + row * 128 + ((chunk ^ (row & 7)) << 4) + (q & 1) * 8);
    a[i] = rt::pack_bf16(v.x, v.y);
  }
}

// The two bf16 of a fragment register that are at or past a row's live
// width lv (columns c, c + 1) zeroed.
__device__ __forceinline__ unsigned live_mask(int c, int lv) {
  return (c < lv ? 0x0000ffffu : 0u) | (c + 1 < lv ? 0xffff0000u : 0u);
}

// out = y @ B[idx] row by row, persistent: block b walks the tiles [T b /
// G, T (b + 1) / G) of the T = row tiles x column tiles, numbered column
// tile by column tile, so a block's tiles share their columns and, where
// a slot's rows run on (prefill, training), their slot. Warp 4 (the
// producer) keeps each tile's idx and live copying kXPre tiles ahead
// (cp.async), finds the tile's distinct slots in row order (one slot: a
// warp vote; several: warp match and ballots) and the widest live width
// of each, rounded up to 8 (ncol), and hands out one item a (slot, rank
// chunk below ncol) through a ring of stages (an mbarrier full and empty
// each): y's chunk by TMA (zero past `rows` and r_max; a tile's first
// chunk as soon as its stage is free, before its slots are known). B's
// chunk stays in one of two buffers while items ask for it (slot,
// columns, rank chunk); another chunk goes into the buffer read least
// recently, once the consumers have released the last item that read
// it: B's rank rows below ncol in 8-row boxes, the 8-row group past an
// odd ncol / 8 zeroed in shared memory (B is never read past ncol).
// Warpgroup 0 (the consumers) reads y's fragments into registers,
// rounding f32 y to bf16 (what y.to(bf16) gives) and zeroing columns at
// or past each row's live width, and runs wgmma m64nBNk16 (register A, B
// from its buffer, f32 accumulate) over the chunk's k-steps; at a pass's
// last chunk each thread writes its rows of that pass's slot, rounded
// once to bf16, into the staged output tile (128-byte swizzled), so a
// tile of several slots is computed once a slot and stored once; rows
// without an adapter or past `rows` are zeros. The tile leaves by TMA
// stores (clipped at `rows` and d_out) from one of two stages; a stage is
// written again only once the store that read it has (two tiles back),
// so two stores drain under the next tile's work. Every element of out is
// written by one store; the sums run in a fixed order (no atomics), so
// results repeat bitwise.
template <typename TY, int BN>
__global__ void __launch_bounds__(kXThreads, kXBlocksPerSm)
    lora_expand_wgmma_kernel(const __grid_constant__ CUtensorMap ty,
                             const __grid_constant__ CUtensorMap tb,
                             const __grid_constant__ CUtensorMap tout,
                             const int* __restrict__ idx,
                             const int* __restrict__ live, int rows,
                             int r_max, int d_out, int slots) {
  using C = XCfg<TY, BN>;
  constexpr int S = C::kStages;
  constexpr int K = C::kK;                  // rank rows a chunk
  constexpr int NB = BN / 64;               // 64-column boxes a tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (rt::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* bbase = ring + S * C::kYBytes;
  unsigned char* outs = bbase + 2 * C::kBBytes;
  __shared__ __align__(8) uint64_t full[S], empty[S];
  __shared__ XItem meta[S];
  __shared__ int pidx[kXPre][kXM], plive[kXPre][kXM];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      rt::mbar_init(&full[i], 1);
      rt::mbar_init(&empty[i], 128);        // every consumer thread
    }
    rt::fence_barrier_init();
  }
  __syncthreads();
  const int row_tiles = (rows + kXM - 1) / kXM;
  const long long tiles =
      (long long)row_tiles * ((d_out + BN - 1) / BN);
  const int w0 = (int)(tiles * blockIdx.x / gridDim.x);
  const int w1 = (int)(tiles * (blockIdx.x + 1) / gridDim.x);

  if (warp == 4) {
    // ------------------------------------------------------ producer ----
    if (lane == 0) {
      rt::prefetch_map(&ty);
      rt::prefetch_map(&tb);
      rt::prefetch_map(&tout);
    }
    int item = 0;
    // tile w's idx and live into the copy ring (rows past `rows` read
    // nothing), one commit group a tile, none of it past the run
    auto fetch_rows = [&](int w) {
      if (w < w1) {
        const int row0 = w % row_tiles * kXM, slot = (w - w0) % kXPre;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + lane + 32 * h;
          const bool in = r < rows;
          rt::cp_async4z(&pidx[slot][lane + 32 * h], in ? idx + r : idx, in);
          rt::cp_async4z(&plive[slot][lane + 32 * h], in ? live + r : live,
                         in);
        }
      }
      rt::cp_async_commit();
    };
    // wait for stage item % S; with y0 (a tile's first item, whose chunk
    // is rank columns [0, K)), load the tile's y chunk into it at once,
    // before the tile's slots are known
    auto open_stage = [&](int row0, bool y0) {
      const int st = item % S;
      rt::mbar_wait(&empty[st], ((item / S) & 1) ^ 1);
      if (y0 && lane == 0) {
        rt::mbar_add_tx(&full[st], C::kYBytes);
        rt::tma_load_4d(ring + st * C::kYBytes, &ty, &full[st], 0, row0, 0,
                        0);
      }
    };
    // the B chunk each buffer holds (slot, n0, k0, rank rows), and the
    // last item that read it (-1: none)
    int4 key0 = make_int4(-1, -1, -1, -1), key1 = key0;
    int use0 = -1, use1 = -1;
    // write the item into the stage open_stage opened (every lane: its
    // rows) and, with ksteps > 0, load its y chunk (unless open_stage did)
    // and pick its B buffer, loading the chunk where neither holds it
    auto emit = [&](int row0, int n0, int s, int k0, int ncol, int flags,
                    const int (&sl)[2], const int (&lv)[2], bool y_done) {
      const int st = item % S;
      XItem& m = meta[st];
      const int nrows = max(0, min(K, ncol - k0));   // B's rank rows
      const int ksteps = (nrows + 15) / 16;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m.sl[lane + 32 * h] = sl[h];
        m.lv[lane + 32 * h] = lv[h];
      }
      const int nbox = min(NB, (d_out - n0 + 63) / 64);  // inside d_out
      const int4 key = make_int4(s, n0, k0, nrows);
      auto holds = [&](const int4& k) {
        return k.x == key.x && k.y == key.y && k.z == key.z && k.w == key.w;
      };
      int bb = 0;
      bool load_b = false;
      if (ksteps > 0) {
        bb = holds(key0) ? 0 : holds(key1) ? 1 : -1;
        if (bb < 0) {
          bb = use0 <= use1 ? 0 : 1;        // the one read least recently
          const int lu = bb ? use1 : use0;
          if (lu >= 0 && lu > item - S)     // its reader may still run
            rt::mbar_wait(&empty[lu % S], (lu / S) & 1);
          load_b = true;
          (bb ? key1 : key0) = key;
          if (nrows % 16 == 8) {            // the group past B's rows: 0
            unsigned char* bs = bbase + bb * C::kBBytes;
            for (int i = lane; i < nbox * 64; i += 32)
              reinterpret_cast<uint4*>(bs + (i >> 6) * K * 128 +
                                       (nrows / 8) * 1024)[i & 63] =
                  make_uint4(0u, 0u, 0u, 0u);
            rt::fence_proxy_async();        // before the consumers' wgmma
          }
        }
        (bb ? use1 : use0) = item;
      }
      const bool load_y = ksteps > 0 && !y_done;
      __syncwarp();
      if (lane == 0) {
        m.row0 = row0;
        m.n0 = n0;
        m.s = s;
        m.k0 = k0;
        m.ksteps = ksteps;
        m.flags = flags;
        m.bbuf = bb;
        rt::mbar_expect_tx(&full[st],       // the stage's one arrival
                           (load_y ? C::kYBytes : 0) +
                               (load_b ? nbox * (nrows / 8) * 1024 : 0));
        if (load_y)
          rt::tma_load_4d(ring + st * C::kYBytes, &ty, &full[st], k0, row0,
                          0, 0);
      }
      __syncwarp();                         // B's copies after the expect
      if (load_b) {
        const int groups = nrows / 8;
        unsigned char* bs = bbase + bb * C::kBBytes;
        for (int i = lane; i < nbox * groups; i += 32)
          rt::tma_load_4d(bs + (i / groups) * K * 128 + (i % groups) * 1024,
                          &tb, &full[st], n0 + 64 * (i / groups),
                          k0 + 8 * (i % groups), s, 0);
      }
      ++item;
    };
    // a pass over slot s of widest live width `widest`: an item a chunk
    auto pass = [&](int row0, int n0, int s, int widest, bool last_pass,
                    const int (&sl)[2], const int (&lv)[2], bool y_done) {
      const int ncol = (widest + 7) / 8 * 8;
      const int chunks = max(1, (ncol + K - 1) / K);
      for (int c = 0; c < chunks; ++c) {
        const bool last = c == chunks - 1 && last_pass;
        if (c > 0) open_stage(row0, false);
        emit(row0, n0, s, c * K, ncol,
             (c == 0 ? kXFirst : 0) | (c == chunks - 1 ? kXLastChunk : 0) |
                 (last ? kXLastOfTile : 0),
             sl, lv, y_done && c == 0);
      }
    };

    // launched with programmatic dependent launch: the block sets up
    // while the kernel ahead (the shrink) finishes, and reads nothing
    // before it has (any input may be that kernel's output)
    rt::grid_dep_wait();
    for (int w = w0; w < w0 + kXPre; ++w) fetch_rows(w);
    int sl[2] = {-1, -1}, lv[2] = {0, 0};
    for (int w = w0; w < w1; ++w) {
      const int row0 = w % row_tiles * kXM, n0 = w / row_tiles * BN;
      open_stage(row0, true);               // y while idx may still copy
      rt::cp_async_wait<kXPre - 1>();       // tile w's idx and live
      const int slot = (w - w0) % kXPre;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool in = row0 + lane + 32 * h < rows;
        sl[h] = in ? pidx[slot][lane + 32 * h] : -1;
        lv[h] = in ? plive[slot][lane + 32 * h] : 0;
        if (sl[h] < 0 || sl[h] >= slots) sl[h] = -1;
        lv[h] = sl[h] < 0 ? 0 : max(0, min(lv[h], r_max));
      }
      __syncwarp();
      asm volatile("" ::: "memory");        // the slot is read before
      fetch_rows(w + kXPre);                // its next copy lands in it
      const int s0 = __shfl_sync(0xffffffffu, sl[0], 0);
      if (__all_sync(0xffffffffu, sl[0] == s0 && sl[1] == s0)) {
        // one slot, or none, on every row: one pass
        if (s0 < 0)
          emit(row0, n0, -1, 0, 0, kXFirst | kXLastChunk | kXLastOfTile, sl,
               lv, true);
        else
          pass(row0, n0, s0, __reduce_max_sync(0xffffffffu,
                                               max(lv[0], lv[1])),
               true, sl, lv, true);
        continue;
      }
      // the first row of each distinct slot, in row order
      bool first[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned peers = __match_any_sync(0xffffffffu, sl[h]);
        first[h] = sl[h] >= 0 && lane == __ffs(peers) - 1;
      }
#pragma unroll
      for (int j = 0; j < 32; ++j)
        first[1] &= __shfl_sync(0xffffffffu, sl[0], j) != sl[1];
      unsigned long long f =
          __ballot_sync(0xffffffffu, first[0]) |
          (unsigned long long)__ballot_sync(0xffffffffu, first[1]) << 32;
      bool y_done = true;                   // the tile's first item's y
      while (f != 0) {                      // uniform: a pass a slot
        const int u = __ffsll((long long)f) - 1;
        f &= f - 1;
        const int s = __shfl_sync(0xffffffffu, u < 32 ? sl[0] : sl[1],
                                  u & 31);
        if (!y_done) open_stage(row0, false);
        pass(row0, n0, s,
             __reduce_max_sync(0xffffffffu, max(sl[0] == s ? lv[0] : 0,
                                                sl[1] == s ? lv[1] : 0)),
             f == 0, sl, lv, y_done);
        y_done = false;
      }
    }
    rt::cp_async_wait<0>();
    open_stage(0, false);
    emit(0, 0, -1, 0, 0, kXEnd, sl, lv, true);   // the end of the walk
    return;
  }

  // -------------------------------------------------------- consumers ----
  const int g = lane >> 2, q = lane & 3;
  const int r0 = warp * 16 + g, r1 = r0 + 8;  // this thread's rows
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int tile = 0;
  bool fresh = true;                        // the tile's stage not written
  for (int item = 0;; ++item) {
    const int st = item % S;
    rt::mbar_wait(&full[st], (item / S) & 1);
    const XItem& m = meta[st];
    const int flags = m.flags;
    if (flags & kXEnd) break;
    const int s = m.s, k0 = m.k0, ksteps = m.ksteps;
    const int row0 = m.row0, n0 = m.n0;
    const int sl0 = m.sl[r0], sl1 = m.sl[r1];
    const int lv0 = m.lv[r0], lv1 = m.lv[r1];
    if (ksteps > 0) {
      const unsigned char* ys = ring + st * C::kYBytes;
      uint32_t a[K / 16][4] = {};
#pragma unroll
      for (int kk = 0; kk < K / 16; ++kk) {
        if (kk >= ksteps) break;
        y_frags(static_cast<const TY*>(nullptr), ys, kk, warp, lane, a[kk]);
        const int c = k0 + 16 * kk + 2 * q;
        a[kk][0] &= live_mask(c, lv0);
        a[kk][1] &= live_mask(c, lv1);
        a[kk][2] &= live_mask(c + 8, lv0);
        a[kk][3] &= live_mask(c + 8, lv1);
      }
      // B: MN-major (the transpose bit), a 64-column box of K rank rows
      // to the next (LBO), 8 rank rows an atom (SBO), a k-step 16 rows on
      const uint64_t db =
          rt::smem_desc(bbase + m.bbuf * C::kBBytes, K * 128, 1024, 1);
#pragma unroll
      for (int kk = 0; kk < K / 16; ++kk) rt::fence_regs(a[kk]);
      rt::fence_regs(acc);
      rt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < K / 16; ++kk)
        if (kk < ksteps)
          rt::Wgmma<BN>::template rs<1>(acc, a[kk], db + 128 * kk,
                                        kk > 0 || !(flags & kXFirst));
      rt::wgmma_commit();
      rt::wgmma_wait<0>();
      rt::fence_regs(acc);
    } else if (flags & kXFirst) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    }
    rt::mbar_arrive(&empty[st]);            // the stage is read
    unsigned char* ost = outs + (tile & 1) * C::kOutBytes;
    // d[4i + 2h + e]: row r0 + 8h, column 8i + 2q + e; into the staged
    // tile's box i / 8, 16-byte chunk i % 8 of the row, swizzled (h a
    // constant: acc stays in registers)
    auto put = [&](auto hc, bool zero) {
      constexpr int h = decltype(hc)::value;
      const int r = h ? r1 : r0;
      unsigned char* rowp = ost + r * 128 + q * 4;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
        *reinterpret_cast<unsigned*>(rowp + (i >> 3) * kXM * 128 +
                                     (((i & 7) ^ (r & 7)) << 4)) =
            zero ? 0u : rt::pack_bf16(acc[4 * i + 2 * h],
                                      acc[4 * i + 2 * h + 1]);
    };
    const std::integral_constant<int, 0> top;
    const std::integral_constant<int, 1> bottom;
    // before the tile's first write into its stage: the store that read
    // the stage last (two tiles back) has read it; the tile before's
    // store may still run, so two stores drain under this tile's work
    if (fresh && (flags & (kXLastChunk | kXLastOfTile))) {
      if (tid == 0) rt::bulk_wait_read<1>();
      rt::named_sync(1, 128);
      fresh = false;
    }
    if (flags & kXLastChunk) {              // the pass's rows, rounded once
      if (s >= 0 && sl0 == s) put(top, false);
      if (s >= 0 && sl1 == s) put(bottom, false);
    }
    if (flags & kXLastOfTile) {
      if (sl0 < 0) put(top, true);
      if (sl1 < 0) put(bottom, true);
      rt::fence_proxy_async();              // the generic writes -> TMA
      rt::named_sync(2, 128);
      if (tid == 0) {
        if (tile == 0) rt::grid_dep_wait(); // out: the kernels ahead done
        for (int x = 0; x < NB; ++x)
          if (n0 + 64 * x < d_out)
            rt::tma_store_4d(&tout, ost + x * kXM * 128, n0 + 64 * x, row0,
                             0, 0);
        rt::bulk_commit();
      }
      ++tile;
      fresh = true;
    }
  }
  if (tid == 0) rt::bulk_wait<0>();         // smem must outlive the stores
}

// --------------------------------------------------- expand: decode ----

// 8 values as 16 bytes of bf16 (one uint4) or 32 of f32 (two), and back:
// exact for values of that type
__device__ __forceinline__ void pack8(const float (&v)[rt::kVec],
                                      uint4 (&w)[1]) {
  w[0] = make_uint4(rt::pack_bf16(v[0], v[1]), rt::pack_bf16(v[2], v[3]),
                    rt::pack_bf16(v[4], v[5]), rt::pack_bf16(v[6], v[7]));
}
__device__ __forceinline__ void pack8(const float (&v)[rt::kVec],
                                      uint4 (&w)[2]) {
  w[0] = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
  w[1] = make_uint4(__float_as_uint(v[4]), __float_as_uint(v[5]),
                    __float_as_uint(v[6]), __float_as_uint(v[7]));
}
__device__ __forceinline__ void unpack8(const uint4 (&w)[1],
                                        float (&v)[rt::kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w[0]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack8(const uint4 (&w)[2],
                                        float (&v)[rt::kVec]) {
  v[0] = __uint_as_float(w[0].x); v[1] = __uint_as_float(w[0].y);
  v[2] = __uint_as_float(w[0].z); v[3] = __uint_as_float(w[0].w);
  v[4] = __uint_as_float(w[1].x); v[5] = __uint_as_float(w[1].y);
  v[6] = __uint_as_float(w[1].z); v[7] = __uint_as_float(w[1].w);
}

constexpr int kRankSplit = 8;               // warps a block: rank slices
constexpr int kDecCols = 8 * 32;            // columns a block: 8 a lane

// out[row, n0 : n0 + kDecCols] (n0 = blockIdx.y * kDecCols) = y[row,
// :live] @ B[idx[row]][:live, n0 : ...]: lane l of every warp owns 8
// columns, read from one rank row of B in a single 16-byte load (element
// loads where d_out is no multiple of 8: 4-byte pairs at an even d_out,
// zero past d_out); warp w sums rank rows w, w + kRankSplit, ... below
// live[row] in order, and the warps' partials are added in warp order. y is TY: B's
// dtype, or f32 rounded to B's dtype as it is loaded (the value
// `y.to(b.dtype)` gives), so no cast launch stands between the shrink and
// this kernel. A decode batch's B is a few MB: each row's blocks read
// their slot's B, the rows of one slot from L2 after the first. The chain
// of round trips is what a launch costs here (the H100 measured ~1 us a
// step), so kEarly (up to kDecEarlyRows rows) issues B's first 8 rank
// rows a warp before y is loaded, both after one read of idx and live,
// and prefetches its B lines into L2 before it waits for y. Past
// kDecEarlyRows rows (1,024 blocks at 64) a launch keeps y first, then B
// a rank row a loop step at 32 registers a thread, eight blocks an SM:
// 64 rows' 1,024 blocks in one wave on 132 SMs (at 64 registers, four
// blocks an SM, they took two waves and ~1.5 us more on the H100;
// kernels/bgmv.py: expand_plan). The sums and their order are the same
// either way. Both
// are launched with programmatic dependent launch after the shrink, which
// lets them start early; each waits for y (and anything else an earlier
// kernel wrote) before reading it.
template <typename T, typename TY, bool kVec, bool kEarly>
__global__ void __launch_bounds__(
    kRankSplit * 32,
    kEarly ? ((kVec && sizeof(T) == 2) ? 3 : 1) : (kVec ? 8 : 1))
    lora_expand_decode_kernel(
    const TY* __restrict__ y, const T* __restrict__ b,
    const int* __restrict__ idx, const int* __restrict__ live,
    T* __restrict__ out, int rows, int r_max, int d_out, int slots) {
  extern __shared__ __align__(16) float esm[];
  float* part = esm;                        // kRankSplit x kDecCols
  float* ysm = esm + kRankSplit * kDecCols; // y's live values, rounded
  const int row = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.y * kDecCols, c = n0 + lane * rt::kVec;
  auto slot_of = [&](int& s, int& lv) {
    s = idx[row];
    lv = (s >= 0 && s < slots) ? max(0, min(live[row], r_max)) : 0;
  };
  int s, lv;
  if constexpr (kEarly) {
    slot_of(s, lv);                         // (may be stale: aims the
    // prefetch only) the block's B lines, by the first row of each slot
    // alone (rows of one slot would prefetch the same lines again)
    const int u0 = lane < rows ? idx[lane] : -1;
    const int u1 = lane + 32 < rows ? idx[lane + 32] : -1;
    const bool seen =
        __ballot_sync(0xffffffffu, lane < row && u0 == s) |
        __ballot_sync(0xffffffffu, lane + 32 < row && u1 == s);
    if (lv > 0 && !seen && lane < 4)
      for (int r = warp; r < lv; r += kRankSplit)
        rt::prefetch_l2(b + ((size_t)s * r_max + r) * d_out +
                        min(n0 + lane * 64, d_out - 1));
  }
  rt::grid_dep_wait();
  slot_of(s, lv);
  const T* bs = b + (size_t)max(s, 0) * r_max * d_out + c;
  float acc[rt::kVec];
#pragma unroll
  for (int j = 0; j < rt::kVec; ++j) acc[j] = 0.f;
  // B's rows start 4-byte aligned at an even d_out: bf16 pairs a load
  const bool pairs = d_out % 2 == 0 && (reinterpret_cast<size_t>(b) & 3) == 0;
  // a lane's 8 values of rank row r into w (16 bytes of bf16, 32 of f32,
  // kept as loaded until used: half the registers of 8 floats); zero past
  // d_out
  constexpr int WQ = sizeof(T) * rt::kVec / 16;
  auto load_row = [&](int r, uint4 (&w)[WQ]) {
#pragma unroll
    for (int q = 0; q < WQ; ++q) w[q] = make_uint4(0u, 0u, 0u, 0u);
    if (c >= d_out) return;
    const T* src = bs + (size_t)r * d_out;
    if constexpr (kVec) {
#pragma unroll
      for (int q = 0; q < WQ; ++q) w[q] = reinterpret_cast<const uint4*>(src)[q];
    } else if (sizeof(T) == 2 && pairs) {
      // c is even and so is d_out: a pair that starts below d_out ends
      // below it
      const unsigned* p2 = reinterpret_cast<const unsigned*>(src);
      w[0] = make_uint4(p2[0], c + 2 < d_out ? p2[1] : 0u,
                        c + 4 < d_out ? p2[2] : 0u,
                        c + 6 < d_out ? p2[3] : 0u);
    } else {
      float e[rt::kVec];
#pragma unroll
      for (int j = 0; j < rt::kVec; ++j)
        e[j] = c + j < d_out ? rt::to_f32(src[j]) : 0.f;
      pack8(e, w);
    }
  };
  auto fma_row = [&](int r, const uint4 (&w)[WQ]) {
    const float yv = ysm[r];
    float e[rt::kVec];
    unpack8(w, e);
#pragma unroll
    for (int j = 0; j < rt::kVec; ++j) acc[j] += yv * e[j];
  };
  auto load_y = [&] {
    for (int r = tid; r < lv; r += kRankSplit * 32)
      ysm[r] = rt::to_f32(rt::from_f32<T>(rt::to_f32(
          y[(size_t)row * r_max + r])));
  };
  if constexpr (kEarly) {
    // rank rows warp + kRankSplit * (r0 + i), i < 8, below lv
    constexpr int kChunk = 8;
    uint4 w[kChunk][WQ];
    auto load_chunk = [&](int r0) {
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const int r = warp + kRankSplit * (r0 + i);
        if (r < lv) load_row(r, w[i]);
      }
    };
    load_chunk(0);                          // in flight while y loads
    load_y();
    __syncthreads();
    for (int r0 = 0;;) {
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const int r = warp + kRankSplit * (r0 + i);
        if (r < lv) fma_row(r, w[i]);
      }
      r0 += kChunk;
      if (warp + kRankSplit * r0 >= lv) break;
      load_chunk(r0);
    }
  } else {
    // y first, then a rank row a loop step (8 steps unrolled)
    load_y();
    __syncthreads();
    if (c < d_out) {
#pragma unroll 8
      for (int r = warp; r < lv; r += kRankSplit) {
        uint4 w[WQ];
        load_row(r, w);
        fma_row(r, w);
      }
    }
  }
  float4* mine = reinterpret_cast<float4*>(part + warp * kDecCols +
                                           lane * rt::kVec);
  mine[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  mine[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  __syncthreads();
  const int col = n0 + tid;
  if (col < d_out) {
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < kRankSplit; ++q) sum += part[q * kDecCols + tid];
    out[(size_t)row * d_out + col] = rt::from_f32<T>(sum);
  }
}

// a block per (row, kDecCols columns); y in B's dtype or (y_f32) f32. Up
// to kDecEarlyRows rows B's first rank rows are issued before y (kEarly);
// more rows keep y first (kernels/bgmv.py: expand_plan)
constexpr int kDecEarlyRows = 16;

template <typename T, typename TY, bool kVec>
const void* dec_expand_fn(int rows) {
  return rows <= kDecEarlyRows
             ? (const void*)lora_expand_decode_kernel<T, TY, kVec, true>
             : (const void*)lora_expand_decode_kernel<T, TY, kVec, false>;
}

template <typename T>
rt::Launch dec_expand_launch(int rows, int r_max, int d_out, bool y_f32) {
  const bool vec = d_out % rt::kVec == 0;
  const void* fn;
  if (y_f32)
    fn = vec ? dec_expand_fn<T, float, true>(rows)
             : dec_expand_fn<T, float, false>(rows);
  else
    fn = vec ? dec_expand_fn<T, T, true>(rows)
             : dec_expand_fn<T, T, false>(rows);
  rt::Launch l{fn, dim3(rows, (d_out + kDecCols - 1) / kDecCols),
               kRankSplit * 32,
               sizeof(float) * ((size_t)kRankSplit * kDecCols + r_max)};
  l.pdl = true;
  return l;
}

// The shrink's launch for these arguments (see rt_lora_shrink), or the
// error the entry point returns.
cudaError_t shrink_launch(int rows, int d_in, int r_max, int slots, int tile,
                          int d_chunk, int split, int blocks, int dtype,
                          rt::Launch* l) {
  // r_max a multiple of 8 (16-byte rows of A), at most 8,192; any d_in
  // (16-byte copies of x where it is a multiple of 8)
  if (rows <= 0 || r_max <= 0 || r_max % rt::kVec != 0 || r_max > 8192 ||
      d_in <= 0 || d_chunk <= 0)
    return cudaErrorInvalidValue;
  const bool bf = dtype == rt::kBF16;
  if (!bf && dtype != rt::kF32) return cudaErrorInvalidValue;
  if (tile == 0) {
    // decode: up to kDecRows rows, `split` blocks (a cluster) over slices
    // of d_chunk (whole 16-wide k-steps) that cover d_in
    if (rows > kDecRows || split < 1 || split > kMaxTileSplit ||
        d_chunk % 16 != 0 || (long long)d_chunk * split < d_in)
      return cudaErrorInvalidValue;
    *l = bf ? dec_shrink_launch<bf16>(rows, d_in, r_max, slots, split)
            : dec_shrink_launch<float>(rows, d_in, r_max, slots, split);
    return cudaSuccess;
  }
  // row tiles: `split` (a power of two up to a portable cluster) slices of
  // d_chunk (whole TMA boxes) that cover d_in
  if (split < 1 || split > kMaxTileSplit || (split & (split - 1)) != 0 ||
      d_chunk % kWD != 0 || (long long)d_chunk * split < d_in)
    return cudaErrorInvalidValue;
  if (bf && d_in % rt::kVec == 0) {
    // the persistent wgmma kernel: tiles of kSM rows, `blocks` (whole
    // clusters of `split`) walking them
    if (tile != kSM || blocks < split || blocks % split != 0)
      return cudaErrorInvalidValue;
    *l = rt::Launch{(const void*)lora_shrink_wgmma_kernel, dim3(blocks),
                    kSThreads, kSSmem, (unsigned)split};
    l->pdl = true;
    return cudaSuccess;
  }
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

// A 4-D tensor map of bf16 or (f32) f32 elements (`dims` innermost first,
// each dense in the next) cut into boxes of 128 bytes x `box_rows`,
// 128-byte swizzled, zero-filled outside the tensor (a TMA store clips
// there).
bool tile_map(CUtensorMap* map, const void* ptr, const cuuint64_t (&dims)[4],
              int box_rows, bool f32 = false) {
  const cuuint64_t e = f32 ? 4 : 2;
  const cuuint64_t strides[3] = {dims[0] * e, dims[0] * dims[1] * e,
                                 dims[0] * dims[1] * dims[2] * e};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / e), (cuuint32_t)box_rows, 1,
                             1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return rt::encode_tiled()(
             map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             4, const_cast<void*>(ptr), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TY, int BN>
rt::Launch wgmma_expand_launch(int blocks) {
  rt::Launch l{(const void*)lora_expand_wgmma_kernel<TY, BN>, dim3(blocks),
               kXThreads, XCfg<TY, BN>::kSmem};
  l.pdl = true;
  return l;
}

// The expand's launch for these arguments (see rt_lora_expand).
cudaError_t expand_launch(int rows, int r_max, int d_out, int blocks,
                          int cols, int dtype, int y_dtype, rt::Launch* l) {
  // 16-byte copies of y's rows; B's and out's 16 bytes at a time where
  // d_out is a multiple of 8, element by element otherwise
  if (rows <= 0 || r_max <= 0 || r_max % rt::kVec != 0 || d_out <= 0 ||
      blocks < 0)
    return cudaErrorInvalidValue;
  const bool bf = dtype == rt::kBF16;
  if (!bf && dtype != rt::kF32) return cudaErrorInvalidValue;
  if (cols != 0) {
    // the persistent wgmma kernel: bf16 B and out, whose rows TMA moves
    // (16-byte strides: d_out a multiple of 8), y in bf16 or f32
    if (!bf || d_out % rt::kVec != 0 || blocks < 1 ||
        (y_dtype != rt::kBF16 && y_dtype != rt::kF32))
      return cudaErrorInvalidValue;
    const bool y32 = y_dtype == rt::kF32;
    if (cols == 64)
      *l = y32 ? wgmma_expand_launch<float, 64>(blocks)
               : wgmma_expand_launch<bf16, 64>(blocks);
    else if (cols == 128)
      *l = y32 ? wgmma_expand_launch<float, 128>(blocks)
               : wgmma_expand_launch<bf16, 128>(blocks);
    else
      return cudaErrorInvalidValue;
    return cudaSuccess;
  }
  const int row_blocks = blocks;
  // y in B's dtype; the decode kernel also takes f32 y (rounded on load);
  // bf16 row tiles at a d_out that is a multiple of 8 are the wgmma
  // kernel's
  if (y_dtype != dtype && (row_blocks != 0 || y_dtype != rt::kF32))
    return cudaErrorInvalidValue;
  if (row_blocks != 0 && bf && d_out % rt::kVec == 0)
    return cudaErrorInvalidValue;
  if (row_blocks == 0) {
    if (rows > kDecRows) return cudaErrorInvalidValue;
    const bool y32 = y_dtype == rt::kF32;
    *l = bf ? dec_expand_launch<bf16>(rows, r_max, d_out, y32)
            : dec_expand_launch<float>(rows, r_max, d_out, y32);
  } else {
    *l = bf ? expand_tile_launch<bf16>(r_max, d_out, row_blocks)
            : expand_tile_launch<float>(r_max, d_out, row_blocks);
  }
  return cudaSuccess;
}

}  // namespace

// tile = 64 or 128: the row-tile path, split blocks (1, 2, 4 or 8: a
// cluster) over d_chunk-wide slices of d_in (a multiple of 64 with split *
// d_chunk >= d_in): in bf16 at a d_in that is a multiple of 8 the
// persistent wgmma kernel (tile 64; `blocks` blocks, whole clusters,
// walking the tiles; launched with programmatic stream serialization),
// else the cp.async tile kernel with tiles of `tile` rows (blocks
// unused); tile = 0: the decode path (up to 64 rows), split blocks (1 to
// 8, a cluster) a column group over d_chunk-wide slices of d_in (a
// multiple of 16 with split * d_chunk >= d_in), launched with programmatic
// stream serialization.
extern "C" int rt_lora_shrink(const void* x, const void* a, const int* idx,
                              const int* live, float* y, int rows, int d_in,
                              int r_max, int slots, int tile, int d_chunk,
                              int split, int blocks, int dtype,
                              void* stream) {
  if (rows == 0) return 0;
  rt::Launch l;
  const cudaError_t e = shrink_launch(rows, d_in, r_max, slots, tile,
                                      d_chunk, split, blocks, dtype, &l);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile != 0 && dtype == rt::kBF16 && d_in % rt::kVec == 0) {
    // the wgmma kernel: x as (d_in, rows), A as (r_max, d_in, slots)
    if (rt::encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
    CUtensorMap tx, ta;
    const cuuint64_t xd[4] = {(cuuint64_t)d_in, (cuuint64_t)rows, 1, 1};
    const cuuint64_t ad[4] = {(cuuint64_t)r_max, (cuuint64_t)d_in,
                              (cuuint64_t)max(slots, 1), 1};
    if (!tile_map(&tx, x, xd, tile) || !tile_map(&ta, a, ad, kWD))
      return (int)cudaErrorInvalidValue;
    void* args[] = {&tx, &ta, &idx, &live, &y, &rows, &d_in, &r_max, &slots,
                    &d_chunk, &split};
    return (int)rt::launch(l, args, st);
  }
  void* args[] = {&x, &a, &idx, &live, &y, &rows, &d_in, &r_max, &slots,
                  &d_chunk, &split};
  return (int)rt::launch(l, args, st);
}

// out[0 : kStCount]: the persistent shrink's stamps summed over every
// block since the last call (kSt* above), then cleared; 1 where the
// library was built without LORA_SHRINK_STAMPS.
extern "C" int rt_lora_shrink_stamps(long long* out) {
#ifdef LORA_SHRINK_STAMPS
  unsigned long long h[kStCount];
  cudaError_t e = cudaMemcpyFromSymbol(h, g_shrink_stamps, sizeof(h));
  if (e != cudaSuccess) return (int)e;
  for (int k = 0; k < kStCount; ++k) out[k] = (long long)h[k];
  const unsigned long long zero[kStCount] = {};
  return (int)cudaMemcpyToSymbol(g_shrink_stamps, zero, sizeof(zero));
#else
  (void)out;
  return 1;
#endif
}

// rt_lora_shrink's launch, described (rt::describe) into
// out[0 : rt::kInfoFields]; no kernel runs.
extern "C" int rt_lora_shrink_info(int rows, int d_in, int r_max, int slots,
                                   int tile, int d_chunk, int split,
                                   int blocks, int dtype, long long* out) {
  rt::Launch l;
  const cudaError_t e = shrink_launch(rows, d_in, r_max, slots, tile,
                                      d_chunk, split, blocks, dtype, &l);
  return (int)(e != cudaSuccess ? e : rt::describe(l, out));
}

// cols = 64 or 128: the persistent wgmma kernel (bf16 B, d_out a
// multiple of 8), `blocks` blocks walking tiles of 64 rows x cols columns,
// y in bf16 or (y_dtype f32) f32, rounded to bf16 as it is read; cols = 0
// and blocks = 0: the decode path (up to 64 rows), a block per (row, 256
// output columns), launched with programmatic stream serialization, y in
// B's dtype or (y_dtype f32) f32, each value rounded to B's dtype as it is
// loaded; cols = 0 and blocks > 0: the mma.sync row tiles of kEM rows x kEN
// columns (f32, and widths that are no multiple of 8), `blocks` blocks a
// column tile, block k taking the tiles k, k + blocks, ..., y in B's
// dtype.
extern "C" int rt_lora_expand(const void* y, const void* b, const int* idx,
                              const int* live, void* out, int rows, int r_max,
                              int d_out, int slots, int blocks, int cols,
                              int dtype, int y_dtype, void* stream) {
  if (rows == 0) return 0;
  rt::Launch l;
  const cudaError_t e = expand_launch(rows, r_max, d_out, blocks, cols,
                                      dtype, y_dtype, &l);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cols != 0) {
    // y as (r_max, rows), B as (d_out, r_max, slots), out as (d_out, rows)
    if (rt::encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
    CUtensorMap ty, tb, tout;
    const cuuint64_t yd[4] = {(cuuint64_t)r_max, (cuuint64_t)rows, 1, 1};
    const cuuint64_t bd[4] = {(cuuint64_t)d_out, (cuuint64_t)r_max,
                              (cuuint64_t)max(slots, 1), 1};
    const cuuint64_t od[4] = {(cuuint64_t)d_out, (cuuint64_t)rows, 1, 1};
    if (!tile_map(&ty, y, yd, kXM, y_dtype == rt::kF32) ||
        !tile_map(&tb, b, bd, 8) || !tile_map(&tout, out, od, kXM))
      return (int)cudaErrorInvalidValue;
    void* args[] = {&ty, &tb, &tout, &idx, &live, &rows, &r_max, &d_out,
                    &slots};
    return (int)rt::launch(l, args, st);
  }
  void* args[] = {&y, &b, &idx, &live, &out, &rows, &r_max, &d_out, &slots};
  return (int)rt::launch(l, args, st);
}

// rt_lora_expand's launch, described into out[0 : rt::kInfoFields].
extern "C" int rt_lora_expand_info(int rows, int r_max, int d_out,
                                   int blocks, int cols, int dtype,
                                   int y_dtype, long long* out) {
  rt::Launch l;
  const cudaError_t e = expand_launch(rows, r_max, d_out, blocks, cols,
                                      dtype, y_dtype, &l);
  return (int)(e != cudaSuccess ? e : rt::describe(l, out));
}
