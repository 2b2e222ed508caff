// Prefill attention (flash attention) over dense per-row K/V.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash.py::flash_attention
// (_flash_kernel): the same function. Query i sits at position i, as key i.
// A key counts iff kpos < Lk, kpos <= qpos when causal, and qpos - kpos <
// window when a window is given. Online softmax in f32 (running max m, sum
// l, accumulator) with scale hd**-0.5; p is zeroed where masked and l is
// clamped at 1e-30, so a query with no valid key returns zeros. GQA maps
// query head h to KV head h / (H/KV). The output is in q's dtype.
//
// Bound on the H100. A causal prefill of L tokens does 4 * H * hd *
// L(L+1)/2 flops per row against (2H + 2KV) * L * hd bf16 values moved:
// ~900 flops per byte at L 4096 (H 32, KV 4, hd 128), three times the ~295
// flops/byte above which the bf16 tensor cores, not the memory, are the
// limit: one yi-9b layer at 8 x 4,096 is 1.1e12 flops, 1.1 ms at 989
// TFLOP/s. At 8 x 512 (H 32 = KV) it is ~110 flops a byte: the bytes bound
// it (40 us), and a launch is a few waves of short tiles, so the fixed
// cost of a tile (its first loads, its first Q K^T, its store) is what the
// design has to hide. Only wgmma reaches the tensor-core rate, so the bf16
// kernel is built around it.
//
// Design (bf16): a persistent kernel. min(work tiles, SMs) blocks, one an
// SM, walking the work tiles (128-row query tile, head, row) in one fixed
// order with no tile counter, so a graph replays the same walk and every
// output bit repeats. Work position w = (b H + h) nq + rank lists each
// (head, row)'s query tiles heaviest first (TileOrder: weight = the KV
// tiles the mask lets the tile see, kv_tiles), the heads of a row in
// turn, so the tiles that run at once are a few heads' whole prefixes and
// share their KV head's keys in L2 (a walk that took one query-tile rank
// of every head at a time re-read the keys from HBM: 15% slower at 8 x
// 512). Round k deals positions kG .. kG + G - 1 to the G blocks,
// reversed in odd rounds (a snake), so a block's tiles pair heavy ranks
// with light ones and no block carries more than one tile's weight above
// the mean. Three warpgroups:
//  - Producer (warpgroup 2, one thread, 24 registers): for each of its
//    tiles, TMA loads the first K tile, then Q into one of kQBufs Q
//    buffers (once the store of the tile that last used the buffer has
//    read it), then the remaining K/V tiles of 128 keys (hd 256: 64) into
//    a ring of kStages stages, guarded by full and empty mbarriers per K
//    and per V. The ring's stage and phase run on across tiles, so the
//    next tile's Q and first K/V stages load while the consumers finish
//    this one. Each tile's (query tile, head, row) goes to the consumers
//    in shared memory, published by its Q buffer's full barrier. The
//    loop covers only the KV tiles the causal / window mask lets the
//    query tile see; K/V rows at or past Lk come in as zeros (the map's L
//    extent is Lk). The maps are encoded on the host at each call from
//    the views' strides (4-D: hd, L, heads, batch), so the model's (B, L,
//    H, hd) tensors pass as (B, H, L, hd) views without a copy.
//  - Two consumers (warpgroups 0 and 1, 64 query rows each, 240
//    registers via setmaxnreg): S = Q K^T as wgmma m64n{kBK}k16 with Q
//    and K K-major in swizzled shared memory (128-byte swizzle; a 128-wide
//    head is two 64-column boxes, a 256-wide one four; hd 32 and 96 use
//    32-column boxes with the 64-byte swizzle); online softmax in
//    registers with exp2 (a quad of lanes shares a row; one FFMA and one
//    ex2.approx an element, the scale folded into the exponent); P is
//    rounded to bf16 in registers and is the register A operand of O += P
//    V, wgmma m64n{hd}k16 with V read MN-major through the descriptor's
//    transpose bit. Rounding P is the one place where the arithmetic
//    differs from the plain version. The element-wise mask runs only on
//    tiles the mask cuts.
//  - Overlap within a warpgroup (FlashAttention-3's): tile i's Q K^T and
//    tile i - 1's P V are issued back to back (V waited for between
//    them), and tile i's softmax runs while P V is on the tensor cores.
//    Between the warpgroups
//    (ping-pong): named barriers 1 and 2 pass the turn to issue, so one
//    warpgroup's softmax runs while the other's products hold the tensor
//    cores, instead of both exponentiating at once.
//  - Epilogue: O / l rounded to bf16 and written swizzled into the
//    warpgroup's 64 rows of its tile's Q buffer (its last Q K^T is done),
//    then TMA stores through a 4-D map of out whose L and column extents
//    clip rows at or past Lq and the zero columns of a padded width. The
//    buffer goes back to the producer once the store has read it
//    (cp.async.bulk.wait_group.read), checked after the next tile's first
//    Q K^T is issued; with one Q buffer (hd 256: 64 KiB; two do not fit
//    beside the ring) at once, before the next tile's Q can load.
//
// Design (f32, small shapes). Tiles of 32 x 32 on CUDA cores, one quad of
// lanes per query row, scores and P in f32, K/V through shared memory.
//
// Head dims. Each kernel is built for a few widths (bf16: 32, 64, 96, 128,
// 256; f32: 16 as well), as the Pallas kernel takes any hd
// (src/repro/kernels/flash.py:87-135 pads Lq and Lk, not hd). Any other hd
// up to 256 runs at the next wider width: the tensor map's column extent
// is the tensors' width, so TMA fills the columns past it with zeros (the
// f32 loads zero them), which leave every score unchanged and give output
// columns that the store clips (f32: does not store). The tensors' width
// is hd rounded up to 8, TMA's 16-byte strides: for another hd the wrapper
// passes zero-padded copies. Above 256 the O accumulator (64 x hd f32 a
// warpgroup) no longer fits beside S in setmaxnreg's 240 registers.
#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;            // f32 kernel: 4 warps
constexpr int kFB = 32;                  // f32 tiles (queries and keys)
constexpr float kLog2e = 1.4426950408889634f;

// A launch's shape and element strides (the bf16 launch encodes its TMA
// maps from them); the f32 kernel's arguments.
struct Problem {
  int H, KV, Lq, Lk, causal, window;     // window <= 0: none
  long long qb, qh, ql;                  // element strides of q
  long long kb, kh, kl;                  // k
  long long vb, vh, vl;                  // v
  long long ob, oh, ol;                  // out
  float scale;
  int cols;                              // columns of q/k/v/out (hd to 8)
};

// The bf16 kernel's scalar arguments (its tensors, and their strides,
// come as TMA maps).
struct Sched {
  int H, KV, Lq, Lk, causal, window;     // window <= 0: none
  int B;
  int nq;                                // query tiles a (head, row)
  int tiles;                             // work tiles: nq x H x B
  float sl2;                             // hd^-0.5 log2(e)
};

// KV tiles [j_lo, j_hi) a query tile of rows [q0, q0 + bq) can see: keys
// past the tile's last query are causally masked, keys at or before
// q0 - window are outside every row's window.
template <class P>
__host__ __device__ __forceinline__ void kv_tiles(const P& p, int q0, int bq,
                                                  int bk, int& j_lo,
                                                  int& j_hi) {
  int k_hi = p.Lk;
  if (p.causal && q0 + bq < k_hi) k_hi = q0 + bq;
  const int k_lo =
      p.window > 0 && q0 - p.window + 1 > 0 ? q0 - p.window + 1 : 0;
  j_lo = k_lo / bk;
  j_hi = (k_hi + bk - 1) / bk;
}

template <class P>
__device__ __forceinline__ bool key_ok(const P& p, int qpos, int kpos) {
  return kpos < p.Lk && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || qpos - kpos < p.window);
}

// The keys query qpos may see, [lo, lo + span): key_ok as one unsigned
// compare, (unsigned)(kpos - lo) < span.
template <class P>
__device__ __forceinline__ void key_range(const P& p, int qpos, int& lo,
                                          unsigned& span) {
  int hi = p.Lk;
  if (p.causal && qpos + 1 < hi) hi = qpos + 1;
  lo = p.window > 0 && qpos - p.window + 1 > 0 ? qpos - p.window + 1 : 0;
  span = hi > lo ? (unsigned)(hi - lo) : 0u;
}

// True when every (query, key) pair of the tile is valid, so the
// element-wise mask can be skipped.
template <class P>
__device__ __forceinline__ bool tile_full(const P& p, int q0, int bq, int k0,
                                          int bk) {
  return k0 + bk <= p.Lk && (!p.causal || k0 + bk - 1 <= q0) &&
         (p.window <= 0 || (q0 + bq - 1) - k0 < p.window);
}

// -------------------------------------------------------------- bf16 ----

constexpr int kBQ = 128;                 // query rows a work tile (2 x 64)
constexpr int kMaxStages = 3;            // K/V ring depth (Tile::kStages)
constexpr int kMaxQBufs = 2;             // Q buffers (Tile::kQBufs)
constexpr int kWG = 128;                 // threads a warpgroup
constexpr int kBf16Threads = 3 * kWG;    // consumers 0, 1; producer 2
constexpr int kConsumerRegs = 240, kProducerRegs = 24;
constexpr int kSmemLimit = 232448;       // shared memory a block may use
// query tiles a (head, row) the walk's order table holds: Lq up to
// 1,048,576 (kernels/flash.py: MAX_QUERY_TILES)
constexpr int kMaxQTiles = 8192;
constexpr int kOrderBytes = 2 * kMaxQTiles;
// named barriers (0 is __syncthreads): the turn to issue of warpgroup 0
// and 1 (both warpgroups, 256 threads), and each warpgroup's own (128)
constexpr int kTurnBar = 1, kEpilogueBar = 3;

__device__ __forceinline__ float ex2(float x) {   // 2^x, one MUFU op
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// KV tiles of kv_tiles that query tile m sees (0 if none).
template <int BK, class P>
__host__ __device__ __forceinline__ int tile_weight(const P& p, int m) {
  int j_lo, j_hi;
  kv_tiles(p, m * kBQ, kBQ, BK, j_lo, j_hi);
  return j_hi > j_lo ? j_hi - j_lo : 0;
}

// The query tiles of one (head, row), heaviest first. A tile's weight
// (tile_weight) is min(Lk tiles, the causal end) less the window's start:
// it rises with m under a causal mask, falls with m under a window, and
// so first rises and then falls. Two cursors start where the fall begins
// and walk outwards, each step taking the heavier side (the later tile
// on a tie): weights never increase along the walk. Its Python mirror is
// kernels/flash.py: tile_order.
template <int BK>
struct TileOrder {
  int lo, hi;                            // lo walks down, hi walks up
  template <class P>
  __host__ __device__ void init(const P& p) {
    int s = p.nq - 1;                    // the fall: [s, nq) never rises
    while (s > 0 && tile_weight<BK>(p, s - 1) >= tile_weight<BK>(p, s)) --s;
    lo = s - 1;
    hi = s;
  }
  template <class P>
  __host__ __device__ int next(const P& p) {
    if (lo < 0 || (hi < p.nq &&
                   tile_weight<BK>(p, hi) >= tile_weight<BK>(p, lo)))
      return hi++;
    return lo--;
  }
};

// One online-softmax step over a 64 x kBK score tile in registers (the
// wgmma accumulator layout): mask unless the tile is full (masked scores
// -inf), update the row max m (of raw scores) and sum l, and turn s into
// p = 2^(s sl2 - m sl2) in place, one FFMA and one ex2 an element (sl2 =
// hd^-0.5 log2 e; masked p exactly 0). corr rescales what was summed
// before. A row with no valid key yet keeps m = -inf, p = 0, l = 0. The
// mask is a select against each row's key range (key_range), so it
// compiles to compares and selects: a branch an element, which key_ok's
// short-circuit tests can turn into, made the kernel up to 1.3x slower.
template <int NS>
__device__ __forceinline__ void softmax_step(float (&s)[NS * 4],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2],
                                             const Sched& p, int qrow,
                                             int k0, bool full, int lane) {
  const float sl2 = p.sl2;
  if (!full) {
    int lo[2];
    unsigned span[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) key_range(p, qrow + 8 * r, lo[r], span[r]);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + n * 8 + (lane & 3) * 2 + (e & 1);
        const bool ok = (unsigned)(kpos - lo[e >> 1]) < span[e >> 1];
        s[4 * n + e] = ok ? s[4 * n + e] : -INFINITY;
      }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * n + e]);
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // mx[r] is the new max: -inf only if the row has seen no valid key
    base[r] = mx[r] == -INFINITY ? 0.f : mx[r] * sl2;
    corr[r] = ex2(m[r] * sl2 - base[r]);     // m = -inf: 0 (nothing yet)
    m[r] = mx[r];
    l[r] *= corr[r];
  }
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = ex2(fmaf(s[4 * n + e], sl2, -base[e >> 1]));
      s[4 * n + e] = pe;
      l[e >> 1] += pe;
    }
}

// P as the A fragments of P V, rounded to bf16: k-step t covers keys
// 16t..16t+15, the S column blocks 2t and 2t + 1.
template <int NS>
__device__ __forceinline__ void p_fragments(const float (&s)[NS * 4],
                                            uint32_t (&pf)[NS / 2][4]) {
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    pf[n >> 1][(n & 1) * 2] = rt::pack_bf16(s[4 * n], s[4 * n + 1]);
    pf[n >> 1][(n & 1) * 2 + 1] = rt::pack_bf16(s[4 * n + 2], s[4 * n + 3]);
  }
}

// Shared-memory layout of a (rows x HD) bf16 tile as TMA writes it with
// swizzle: HD / kBox column boxes, each `rows` rows of kSwz bytes. A head
// dim that is a multiple of 64 takes 64-column boxes (128-byte swizzle),
// hd 32 and 96 take 32-column ones (64-byte swizzle): 96 = 3 x 32. Every
// k-step of 16 columns then lies inside one box (koff). The K/V tile, the
// ring depth and the Q buffers follow the head dim: up to hd 128, tiles
// of 128 keys and two Q buffers beside a ring of 3 stages where it fits
// (hd <= 96) and 2 at hd 128 (2 x 32 + 2 x 2 x 32 = 192 KiB of the 227 KiB
// a block may use); hd 256 takes tiles of 64 keys in 2 stages and one Q
// buffer (64 + 2 x 2 x 32 = 192 KiB; a second would need 256), and S
// (kBK / 2 f32 a thread) beside O (128) and P (kBK / 4) stays within
// setmaxnreg's 240 registers.
template <int HD>
struct Tile {
  static_assert(HD % 32 == 0 && HD <= 256, "head dim: a multiple of 32");
  static constexpr int kBox = HD % 64 == 0 ? 64 : 32;   // columns a box
  static constexpr int kBoxes = HD / kBox;
  static_assert(kBoxes * kBox == HD && kBox % 16 == 0,
                "a k-step must not straddle two boxes");
  static constexpr int kSwz = kBox * 2;            // bytes a row: 64 or 128
  static constexpr int kAtom = 8 * kSwz;           // 8 rows: the SBO
  static constexpr unsigned kLayout = kSwz == 128 ? 1 : 2;
  static constexpr int kBK = HD > 128 ? 64 : 128;  // keys a K/V tile
  static constexpr int kQBytes = kBQ * HD * 2;
  static constexpr int kKVBytes = kBK * HD * 2;
  static constexpr int kQBufs = HD > 128 ? 1 : 2;
  static constexpr int kStages =
      kQBufs * kQBytes + 6 * kKVBytes + kOrderBytes + 2048 <= kSmemLimit
          ? 3 : 2;
  static_assert(kStages <= kMaxStages && kQBufs <= kMaxQBufs,
                "barrier arrays");
  // kQBufs Q buffers, then kStages K tiles, then kStages V tiles, then the
  // barriers and the walk's order table
  static constexpr int kSmem = kQBufs * kQBytes + 2 * kStages * kKVBytes;
};

struct Barriers {
  uint64_t q_full[kMaxQBufs], q_empty[kMaxQBufs];
  uint64_t k_full[kMaxStages], v_full[kMaxStages];
  uint64_t k_empty[kMaxStages], v_empty[kMaxStages];
  // the work tile each Q buffer holds: its query tile and b * H + h (-1:
  // the block's walk is over)
  int tile_m[kMaxQBufs], tile_hb[kMaxQBufs];
};

template <int HD>
constexpr size_t bf16_smem() {           // + 1024: aligning to an atom
  static_assert(Tile<HD>::kSmem + sizeof(Barriers) + kOrderBytes + 1024 <=
                    kSmemLimit,
                "shared memory a block may use");
  return Tile<HD>::kSmem + sizeof(Barriers) + kOrderBytes + 1024;
}

// Offset of k-step kk (16 columns of hd) in a swizzled tile of `rows`
// rows, in the 16-byte units of a descriptor's address: 32 bytes further
// into the box each step, the next box after kBox / 16 steps.
template <int HD>
__device__ __forceinline__ unsigned koff(int kk, int rows) {
  using T = Tile<HD>;
  return (((kk * 16) / T::kBox) * rows * (unsigned)T::kSwz +
          ((kk * 16) % T::kBox) * 2u) >> 4;
}

// S = Q K^T over stage st (Q and K K-major: transpose bits 0)
template <int HD>
__device__ __forceinline__ void issue_s(float (&s)[Tile<HD>::kBK / 2],
                                        uint64_t dq, uint64_t dk, int st) {
  using T = Tile<HD>;
  const unsigned kb = (st * T::kKVBytes) >> 4;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    rt::Wgmma<T::kBK>::template ss<0, 0>(s, dq + koff<HD>(kk, kBQ),
                                         dk + kb + koff<HD>(kk, T::kBK),
                                         kk > 0);
  rt::wgmma_commit();
}

// O += P V over stage st (V MN-major: transpose bit 1; a 16-key k-step
// is 16 rows further)
template <int HD>
__device__ __forceinline__ void issue_pv(
    float (&o)[HD / 2], const uint32_t (&pf)[Tile<HD>::kBK / 16][4],
    uint64_t dv, int st) {
  using T = Tile<HD>;
  const unsigned vb = (st * T::kKVBytes) >> 4;
#pragma unroll
  for (int tt = 0; tt < T::kBK / 16; ++tt)
    rt::Wgmma<HD>::template rs<1>(o, pf[tt],
                                  dv + vb + ((tt * 16 * T::kSwz) >> 4), 1);
  rt::wgmma_commit();
}

template <int NP>
__device__ __forceinline__ void fence_frags(uint32_t (&pf)[NP][4]) {
#pragma unroll
  for (int tt = 0; tt < NP; ++tt) rt::fence_regs(pf[tt]);
}

// O *= corr row-wise, then P -> bf16 A fragments
template <int HD>
__device__ __forceinline__ void rescale(
    float (&o)[HD / 2], const float (&corr)[2],
    const float (&s)[Tile<HD>::kBK / 2],
    uint32_t (&pf)[Tile<HD>::kBK / 16][4]) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    o[4 * n] *= corr[0];
    o[4 * n + 1] *= corr[0];
    o[4 * n + 2] *= corr[1];
    o[4 * n + 3] *= corr[1];
  }
  p_fragments<Tile<HD>::kBK / 8>(s, pf);
}

// The ping-pong: wait for this warpgroup's turn to issue wgmma, and pass
// the turn to the other warpgroup once issued.
__device__ __forceinline__ void take_turn(int wg) {
  rt::named_sync(kTurnBar + wg, 2 * kWG);
}
__device__ __forceinline__ void pass_turn(int wg) {
  rt::named_arrive(kTurnBar + 1 - wg, 2 * kWG);
}

// O / l of one warpgroup's 64 rows -> bf16, swizzled into its 64 rows of
// each column box at `box0` (the tile's Q buffer), as the out map's TMA
// store reads them: the 16-byte chunk c of row r sits at c ^ (r % 8)
// (128-byte swizzle) or c ^ (r / 2 % 4) (64-byte).
template <int HD>
__device__ __forceinline__ void stage_out(unsigned char* box0,
                                          const float (&o)[HD / 2],
                                          const float (&inv)[2], int warp,
                                          int lane) {
  using T = Tile<HD>;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + (lane >> 2) + 8 * r;
    const int swz = T::kSwz == 128 ? (row & 7) : ((row >> 1) & 3);
    unsigned char* rowp = box0 + row * T::kSwz + (lane & 3) * 4;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int x = n * 8 / T::kBox, c = n % (T::kBox / 8);
      *reinterpret_cast<unsigned*>(rowp + x * kBQ * T::kSwz +
                                   ((c ^ swz) << 4)) =
          rt::pack_bf16(o[4 * n + 2 * r] * inv[r],
                        o[4 * n + 2 * r + 1] * inv[r]);
    }
  }
}

// Hand Q buffer `pend` (-1: none) back to the producer once the store
// that thread 0 of the warpgroup issued from it has read it.
__device__ __forceinline__ void release_q(Barriers& bar, int& pend, int t) {
  if (pend >= 0 && t == 0) {
    rt::bulk_wait_read<0>();
    rt::mbar_arrive(&bar.q_empty[pend]);
  }
  __syncwarp();                          // warp-wide wgmma comes next
  pend = -1;
}

template <int HD>
__global__ void __launch_bounds__(kBf16Threads, 1) flash_bf16_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap to, const Sched p) {
  using T = Tile<HD>;
  constexpr int kBK = T::kBK, kStages = T::kStages, kQBufs = T::kQBufs;
  extern __shared__ unsigned char smem_raw[];
  // swizzle atoms must sit on 1024-byte boundaries
  unsigned char* base =
      smem_raw + ((1024 - (rt::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_s = base;                               // + qb * kQBytes
  unsigned char* k_s = q_s + kQBufs * T::kQBytes;          // + st * kKVBytes
  unsigned char* v_s = k_s + kStages * T::kKVBytes;
  Barriers& bar = *reinterpret_cast<Barriers*>(base + T::kSmem);
  uint16_t* order =                      // rank -> query tile (TileOrder)
      reinterpret_cast<uint16_t*>(base + T::kSmem + sizeof(Barriers));

  if (threadIdx.x == 0) {
    for (int i = 0; i < kQBufs; ++i) {
      rt::mbar_init(&bar.q_full[i], 1);
      rt::mbar_init(&bar.q_empty[i], 2);           // each warpgroup's store
    }
    for (int s = 0; s < kStages; ++s) {
      rt::mbar_init(&bar.k_full[s], 1);
      rt::mbar_init(&bar.v_full[s], 1);
      rt::mbar_init(&bar.k_empty[s], 2 * kWG);
      rt::mbar_init(&bar.v_empty[s], 2 * kWG);
    }
    rt::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWG;
  if (wg == 2) {
    // ------------------------------------------------ producer ----
    rt::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 2 * kWG) {
      {
        TileOrder<kBK> walk;
        walk.init(p);
        for (int r = 0; r < p.nq; ++r) order[r] = (uint16_t)walk.next(p);
      }
      // Work position w = hb * nq + rank: each (head, row)'s query tiles
      // heaviest first, the heads of a row in turn. Round k deals
      // positions kG .. kG + G - 1 to the G blocks, reversed in odd rounds
      // (a snake), so a block's tiles pair heavy ranks with light ones.
      const int G = gridDim.x, me = blockIdx.x;
      int kv = 0, qi = 0;
      for (int k = 0; k * G < p.tiles; ++k) {
        const int w = k * G + ((k & 1) ? G - 1 - me : me);
        if (w >= p.tiles) continue;
        const int hb = w / p.nq, m = order[w - hb * p.nq];
        const int h = hb % p.H, b = hb / p.H, kvh = h / (p.H / p.KV);
        int j_lo, j_hi;
        kv_tiles(p, m * kBQ, kBQ, kBK, j_lo, j_hi);
        // the first K tile, then Q (its buffer may still be held by the
        // store of the tile that used it before), then the rest; a tile
        // with no KV tile loads Q alone
        for (int j = j_lo; j < j_hi || j == j_lo; ++j) {
          const int st = kv % kStages;
          const unsigned par = ((kv / kStages) & 1) ^ 1;
          if (j < j_hi) {
            rt::mbar_wait(&bar.k_empty[st], par);
            rt::mbar_expect_tx(&bar.k_full[st], T::kKVBytes);
            for (int x = 0; x < T::kBoxes; ++x)
              rt::tma_load_4d(k_s + st * T::kKVBytes + x * kBK * T::kSwz,
                              &tk, &bar.k_full[st], x * T::kBox, j * kBK,
                              kvh, b);
          }
          if (j == j_lo) {
            const int qb = qi % kQBufs;
            rt::mbar_wait(&bar.q_empty[qb], ((qi / kQBufs) & 1) ^ 1);
            bar.tile_m[qb] = m;
            bar.tile_hb[qb] = hb;
            rt::mbar_expect_tx(&bar.q_full[qb], T::kQBytes);
            for (int x = 0; x < T::kBoxes; ++x)
              rt::tma_load_4d(q_s + qb * T::kQBytes + x * kBQ * T::kSwz, &tq,
                              &bar.q_full[qb], x * T::kBox, m * kBQ, h, b);
          }
          if (j < j_hi) {
            rt::mbar_wait(&bar.v_empty[st], par);
            rt::mbar_expect_tx(&bar.v_full[st], T::kKVBytes);
            for (int x = 0; x < T::kBoxes; ++x)
              rt::tma_load_4d(v_s + st * T::kKVBytes + x * kBK * T::kSwz,
                              &tv, &bar.v_full[st], x * T::kBox, j * kBK,
                              kvh, b);
            ++kv;
          }
        }
        ++qi;
      }
      // the end of the walk, in the next Q buffer's slot
      const int qb = qi % kQBufs;
      rt::mbar_wait(&bar.q_empty[qb], ((qi / kQBufs) & 1) ^ 1);
      bar.tile_hb[qb] = -1;
      rt::mbar_arrive(&bar.q_full[qb]);
    }
  } else {
    // ------------------------------------------------ consumers ----
    rt::setmaxnreg_inc<kConsumerRegs>();
    constexpr int NS = kBK / 8;          // 8-key column blocks of S
    constexpr int NP = kBK / 16;         // 16-key k-steps of P V
    const int t = threadIdx.x % kWG, warp = t / 32, lane = t % 32;

    // Q / K descriptors: K-major, swizzled, SBO = one 8-row atom (k-steps:
    // koff). V: MN-major (transposed), LBO = the next box of hd columns,
    // SBO = the next 8 keys.
    const uint64_t dq0 = rt::smem_desc(q_s + wg * 64 * T::kSwz, 16, T::kAtom,
                                       T::kLayout);
    const uint64_t dk = rt::smem_desc(k_s, 16, T::kAtom, T::kLayout);
    const uint64_t dv = rt::smem_desc(v_s, kBK * T::kSwz, T::kAtom,
                                      T::kLayout);
    float o[HD / 2], m[2], l[2], corr[2];
    float s[NS * 4];
    uint32_t pf[NP][4];

    // Q buffer whose store is in flight (-1: none): thread 0 of the
    // warpgroup issued it and hands the buffer back once it has been read
    int pend = -1;
    if (wg == 1) pass_turn(1);           // warpgroup 0 issues first
    int kv = 0;
    for (int qi = 0;; ++qi) {
      const int qb = qi % kQBufs;
      rt::mbar_wait(&bar.q_full[qb], (qi / kQBufs) & 1);
      const int hb = bar.tile_hb[qb];
      if (hb < 0) break;
      const int q0 = bar.tile_m[qb] * kBQ;
      const int h = hb % p.H, b = hb / p.H;
      const uint64_t dq = dq0 + ((qb * T::kQBytes) >> 4);
      int j_lo, j_hi;
      kv_tiles(p, q0, kBQ, kBK, j_lo, j_hi);
      // Tile i's softmax runs while tile i - 1's P V is on the tensor
      // cores: S_i and P_{i-1} V are issued together, S_i is waited for
      // first.
      const int q0w = q0 + wg * 64;      // this warpgroup's 64 rows
      const int qrow = q0w + warp * 16 + (lane >> 2);   // +8 for e >= 2
      const int ntiles = j_hi - j_lo;
#pragma unroll
      for (int n = 0; n < HD / 2; ++n) o[n] = 0.f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;
      if (ntiles > 0) {
        int st = kv % kStages;
        rt::mbar_wait(&bar.k_full[st], (kv / kStages) & 1);
        rt::fence_regs(s);
        rt::wgmma_fence();
        take_turn(wg);
        issue_s<HD>(s, dq, dk, st);
        pass_turn(wg);
        release_q(bar, pend, t);         // the last tile's store has run
        rt::wgmma_wait<0>();
        rt::fence_regs(s);
        rt::mbar_arrive(&bar.k_empty[st]);
        softmax_step<NS>(s, m, l, corr, p, qrow, j_lo * kBK,
                         tile_full(p, q0w, 64, j_lo * kBK, kBK), lane);
        rescale<HD>(o, corr, s, pf);
        for (int i = 1; i < ntiles; ++i) {
          const int c = kv + i;
          st = c % kStages;
          const int ps = (c - 1) % kStages;
          rt::mbar_wait(&bar.k_full[st], (c / kStages) & 1);
          rt::fence_regs(s);
          rt::fence_regs(o);
          fence_frags(pf);
          rt::wgmma_fence();
          take_turn(wg);
          issue_s<HD>(s, dq, dk, st);
          // V waited for after S is issued: S runs while V lands
          rt::mbar_wait(&bar.v_full[ps], ((c - 1) / kStages) & 1);
          issue_pv<HD>(o, pf, dv, ps);
          pass_turn(wg);
          rt::wgmma_wait<1>();           // S_i done; P_{i-1} V still runs
          rt::fence_regs(s);
          rt::mbar_arrive(&bar.k_empty[st]);
          const int k0 = (j_lo + i) * kBK;
          softmax_step<NS>(s, m, l, corr, p, qrow, k0,
                           tile_full(p, q0w, 64, k0, kBK), lane);
          rt::wgmma_wait<0>();
          rt::fence_regs(o);
          fence_frags(pf);               // P_{i-1} is read until here
          rt::mbar_arrive(&bar.v_empty[ps]);
          rescale<HD>(o, corr, s, pf);
        }
        const int c = kv + ntiles - 1, ps = c % kStages;
        rt::mbar_wait(&bar.v_full[ps], (c / kStages) & 1);
        rt::fence_regs(o);
        fence_frags(pf);
        rt::wgmma_fence();
        take_turn(wg);
        issue_pv<HD>(o, pf, dv, ps);
        pass_turn(wg);
        rt::wgmma_wait<0>();
        rt::fence_regs(o);
        rt::mbar_arrive(&bar.v_empty[ps]);
        kv += ntiles;
      }
      release_q(bar, pend, t);

      // the quad's partial sums -> the row's l; O / l into this
      // warpgroup's rows of the Q buffer (its Q K^T are done), then out
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv[r] = 1.f / fmaxf(l[r], 1e-30f);
      }
      unsigned char* box0 = q_s + qb * T::kQBytes + wg * 64 * T::kSwz;
      stage_out<HD>(box0, o, inv, warp, lane);
      rt::fence_proxy_async();           // the generic writes -> TMA
      rt::named_sync(kEpilogueBar + wg, kWG);
      if (t == 0) {
        for (int x = 0; x < T::kBoxes; ++x)
          rt::tma_store_4d(&to, box0 + x * kBQ * T::kSwz, x * T::kBox, q0w,
                           h, b);
        rt::bulk_commit();
      }
      __syncwarp();
      pend = qb;
      if (kQBufs == 1) release_q(bar, pend, t);   // the next Q waits
    }
    if (t == 0) rt::bulk_wait<0>();      // smem must outlive the stores
    __syncwarp();
    if (wg == 0) take_turn(0);           // warpgroup 1's last pass
  }
}

// --------------------------------------------------------------- f32 ----

// rows [row0, row0 + kFB) of a (rows, cols) f32 matrix into shared memory
// (row stride LDS, HD columns), rows at or past n_rows and columns at or
// past cols (a multiple of 8) zeroed; 16-byte loads
template <int HD, int LDS>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              long long ld, int row0,
                                              int n_rows, int cols, int tid) {
  constexpr int kChunks = HD / 4;
  for (int i = tid; i < kFB * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows && c * 4 < cols)
      x = *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * ld +
                                           c * 4);
    float* d = dst + r * LDS + c * 4;
    d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, Problem p) {
  constexpr int LDS = HD + 1;            // odd: rows in distinct banks
  constexpr int NA = HD / 4;             // output columns per thread
  constexpr int NC = kFB / 4;            // score columns per thread
  extern __shared__ __align__(16) float fsm[];
  float* q_s = fsm;
  float* k_s = q_s + kFB * LDS;
  float* v_s = k_s + kFB * LDS;
  float* p_s = v_s + kFB * LDS;          // kFB x (kFB + 1)

  const int tid = threadIdx.x, r = tid >> 2, c4 = tid & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFB;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const float* kb = k + b * p.kb + kvh * p.kh;
  const float* vb = v + b * p.vb + kvh * p.vh;
  load_rows_f32<HD, LDS>(q_s, q + b * p.qb + h * p.qh, p.ql, q0, p.Lq,
                         p.cols, tid);
  int j_lo, j_hi;
  kv_tiles(p, q0, kFB, kFB, j_lo, j_hi);

  const int qpos = q0 + r;
  float acc[NA];
#pragma unroll
  for (int a = 0; a < NA; ++a) acc[a] = 0.f;
  float m = rt::kNegInf, l = 0.f;
  for (int j = j_lo; j < j_hi; ++j) {
    const int k0 = j * kFB;
    __syncthreads();                     // last tile consumed
    load_rows_f32<HD, LDS>(k_s, kb, p.kl, k0, p.Lk, p.cols, tid);
    load_rows_f32<HD, LDS>(v_s, vb, p.vl, k0, p.Lk, p.cols, tid);
    __syncthreads();
    float s[NC];
    float mx = rt::kNegInf;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = c4 + 4 * i;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot += q_s[r * LDS + d] * k_s[c * LDS + d];
      s[i] = key_ok(p, qpos, k0 + c) ? dot * p.scale : rt::kNegInf;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const float pe = s[i] > rt::kNegInf ? expf(s[i] - m_new) : 0.f;
      p_s[r * (kFB + 1) + c4 + 4 * i] = pe;
      psum += pe;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();                        // the row's p is in p_s
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      const int d = c4 + 4 * a;
      float pv = 0.f;
#pragma unroll 8
      for (int c = 0; c < kFB; ++c)
        pv += p_s[r * (kFB + 1) + c] * v_s[c * LDS + d];
      acc[a] = acc[a] * corr + pv;
    }
  }
  if (qpos < p.Lq) {
    float* orow = out + b * p.ob + h * p.oh + (long long)qpos * p.ol;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int a = 0; a < NA; ++a)
      if (c4 + 4 * a < p.cols) orow[c4 + 4 * a] = acc[a] * inv;
  }
}

// ------------------------------------------------------------ launch ----

template <int HD>
rt::Launch f32_launch(int B, int H, int Lq) {
  return {(const void*)flash_f32_kernel<HD>,
          dim3((Lq + kFB - 1) / kFB, H, B), kThreads,
          sizeof(float) *
              ((size_t)3 * kFB * (HD + 1) + (size_t)kFB * (kFB + 1))};
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, Problem p, int B, cudaStream_t st) {
  void* args[] = {&q, &k, &v, &out, &p};
  return rt::launch(f32_launch<HD>(B, p.H, p.Lq), args, st);
}

// The 4-D map (cols, L, heads, batch) of a bf16 (B, heads, L, cols) view
// with element strides sb, sh, sl, boxes of (kBox, rows): a load fills
// zeros outside the tensor (a width below HD reads as HD columns, the
// rest zero), a store leaves what lies outside unwritten.
template <int HD>
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int heads, int L,
                int cols, long long sb, long long sh, long long sl,
                int rows) {
  using T = Tile<HD>;
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)max(L, 1),
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sl * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)T::kBox, (cuuint32_t)rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return rt::encode_tiled()(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(ptr), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             T::kSwz == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                            : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

Sched make_sched(const Problem& p, int B) {
  Sched s;
  s.H = p.H; s.KV = p.KV; s.Lq = p.Lq; s.Lk = p.Lk;
  s.causal = p.causal; s.window = p.window;
  s.B = B;
  s.nq = (p.Lq + kBQ - 1) / kBQ;
  s.tiles = s.nq * p.H * B;
  s.sl2 = p.scale * kLog2e;
  return s;
}

// The persistent grid: one block an SM, at most one a work tile.
template <int HD>
rt::Launch bf16_launch(int tiles, int sms) {
  return {(const void*)flash_bf16_kernel<HD>,
          dim3(tiles < sms ? tiles : sms), kBf16Threads, bf16_smem<HD>()};
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, Problem p, int B, cudaStream_t st) {
  if (rt::encode_tiled() == nullptr) return cudaErrorNotSupported;
  const int sms = rt::sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  CUtensorMap tq, tk, tv, to;
  constexpr int kBK = Tile<HD>::kBK;
  if (!tensor_map<HD>(&tq, q, B, p.H, p.Lq, p.cols, p.qb, p.qh, p.ql,
                      kBQ) ||
      !tensor_map<HD>(&tk, k, B, p.KV, p.Lk, p.cols, p.kb, p.kh, p.kl,
                      kBK) ||
      !tensor_map<HD>(&tv, v, B, p.KV, p.Lk, p.cols, p.vb, p.vh, p.vl,
                      kBK) ||
      !tensor_map<HD>(&to, out, B, p.H, p.Lq, p.cols, p.ob, p.oh, p.ol,
                      kBQ / 2))
    return cudaErrorInvalidValue;
  Sched s = make_sched(p, B);
  if (s.nq > kMaxQTiles) return cudaErrorInvalidValue;
  void* args[] = {&tq, &tk, &tv, &to, &s};
  return rt::launch(bf16_launch<HD>(s.tiles, sms), args, st);
}

constexpr int kMaxHeadDim = 256;         // O: 64 x hd f32 a warpgroup

// f.run<HD, bf16>() at the narrowest width HD >= hd each kernel is built
// for (hd 1 .. kMaxHeadDim), or cudaErrorInvalidValue: the one list of
// them, for launch and description. A head dim between two widths runs
// at the wider one, its missing columns zero (kernels/flash.py:
// HEAD_DIMS).
template <typename F>
cudaError_t for_head_dim(int hd, int dtype, const F& f) {
  if (hd < 1 || hd > kMaxHeadDim) return cudaErrorInvalidValue;
  if (dtype == rt::kBF16) {
    if (hd <= 32) return f.template run<32, true>();
    if (hd <= 64) return f.template run<64, true>();
    if (hd <= 96) return f.template run<96, true>();
    if (hd <= 128) return f.template run<128, true>();
    return f.template run<256, true>();
  } else if (dtype == rt::kF32) {
    if (hd <= 16) return f.template run<16, false>();
    if (hd <= 32) return f.template run<32, false>();
    if (hd <= 64) return f.template run<64, false>();
    if (hd <= 96) return f.template run<96, false>();
    if (hd <= 128) return f.template run<128, false>();
    return f.template run<256, false>();
  }
  return cudaErrorInvalidValue;
}

struct Launcher {
  const void *q, *k, *v;
  void* out;
  Problem p;
  int B;
  cudaStream_t st;
  template <int HD, bool kBF16>
  cudaError_t run() const {
    if constexpr (kBF16) return launch_bf16<HD>(q, k, v, out, p, B, st);
    else return launch_f32<HD>(q, k, v, out, p, B, st);
  }
};

struct Describer {
  int B, H, Lq;
  long long* out;
  template <int HD, bool kBF16>
  cudaError_t run() const {
    if constexpr (kBF16) {
      const int sms = rt::sm_count();
      if (sms <= 0) return cudaErrorInvalidDevice;
      return rt::describe(
          bf16_launch<HD>((Lq + kBQ - 1) / kBQ * H * B, sms), out);
    } else {
      return rt::describe(f32_launch<HD>(B, H, Lq), out);
    }
  }
};

// The bf16 kernel's query-tile order (TileOrder at the width's key tile).
struct Orderer {
  Sched s;
  int* out;
  template <int HD, bool kBF16>
  cudaError_t run() const {
    if constexpr (kBF16) {
      TileOrder<Tile<HD>::kBK> order;
      order.init(s);
      for (int i = 0; i < s.nq; ++i) out[i] = order.next(s);
      return cudaSuccess;
    } else {
      return cudaErrorInvalidValue;
    }
  }
};

}  // namespace

// strides: 12 element strides on the host, (batch, head, seq) of q, k, v
// and out in that order; the last dim of each is contiguous and holds
// hd rounded up to 8 columns (the wrapper pads other head dims with zero
// columns, which change no score; the scale is hd's).
extern "C" int rt_flash_attention(const void* q, const void* k,
                                  const void* v, void* out,
                                  const long long* strides, int B, int H,
                                  int KV, int Lq, int Lk, int hd, int causal,
                                  int window, int dtype, void* stream) {
  if (B == 0 || Lq == 0) return 0;
  if (KV <= 0 || H % KV != 0 || Lk < 0)
    return (int)cudaErrorInvalidValue;
  Problem p;
  p.H = H; p.KV = KV; p.Lq = Lq; p.Lk = Lk;
  p.causal = causal; p.window = window;
  p.cols = (hd + 7) / 8 * 8;
  p.qb = strides[0]; p.qh = strides[1]; p.ql = strides[2];
  p.kb = strides[3]; p.kh = strides[4]; p.kl = strides[5];
  p.vb = strides[6]; p.vh = strides[7]; p.vl = strides[8];
  p.ob = strides[9]; p.oh = strides[10]; p.ol = strides[11];
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  const Launcher run{q, k, v, out, p, B, static_cast<cudaStream_t>(stream)};
  return (int)for_head_dim(hd, dtype, run);
}

// rt_flash_attention's launch, described (rt::describe) into
// out[0 : rt::kInfoFields]; no kernel runs. The bf16 grid is min(work
// tiles, the device's SMs); Lk, causal and window set each tile's weight
// (the walk, rt_flash_attention_order), not the grid.
extern "C" int rt_flash_attention_info(int B, int H, int Lq, int Lk, int hd,
                                       int causal, int window, int dtype,
                                       long long* out) {
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk < 0 || causal < 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  const Describer d{B, H, Lq, out};
  return (int)for_head_dim(hd, dtype, d);
}

// The bf16 kernel's walk over the query tiles of one (head, row) at width
// hd: out[i] (i < ceil(Lq / 128)) is the query tile of rank i, heaviest
// first (TileOrder). The CPU's copy is kernels/flash.py: tile_order.
extern "C" int rt_flash_attention_order(int Lq, int Lk, int hd, int causal,
                                        int window, int* out) {
  if (Lq <= 0 || Lk < 0 || (Lq + kBQ - 1) / kBQ > kMaxQTiles)
    return (int)cudaErrorInvalidValue;
  Sched s = {};
  s.Lq = Lq; s.Lk = Lk; s.causal = causal; s.window = window;
  s.nq = (Lq + kBQ - 1) / kBQ;
  const Orderer o{s, out};
  return (int)for_head_dim(hd, rt::kBF16, o);
}
