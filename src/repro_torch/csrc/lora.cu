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
// 3.35 TB/s against 17 us of tensor-core work. Two launch shapes, chosen
// on the host from `rows` (kernels/bgmv.py: shrink_plan):
//  - Row tiles (prefill and chunks). Tiles of 64 or 128 consecutive rows,
//    one block per (tile, distinct slot of the tile); prefill repeats each
//    row's slot T times, so most tiles hold one slot and their other
//    blocks exit at once. A block streams d_in in 64-wide chunks of x
//    (its slot's rows only) and of
//    A[s][:, :live] through a 4-stage cp.async ring and multiplies on the
//    tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate; N <= 64 a
//    pass, so mma.sync's fragments cost no more than wgmma's here), each
//    warp 16 rows; each stage's sum is added into the f32 total on the
//    CUDA cores. So x is read once and A once per tile, not once per
//    row. f32 takes the same tiles on CUDA cores (no TF32).
//  - Split d_in (decode, up to 64 rows). A cluster of kSplit blocks per
//    row, each reducing a slice of d_in; rank 0 adds the blocks' partial
//    sums from their shared memory (distributed shared memory) in rank
//    order and writes y, so 8 rows fill 64 SMs instead of 8. A row
//    re-reads its adapter's A from L2, which a handful of rows affords.
// Every sum runs in a fixed order (no atomics): results repeat bitwise.
#include <type_traits>

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

// ------------------------------------------------- shrink: split d_in ----

constexpr int kSplit = 8;                // blocks a row: a portable cluster

// y[row, r] for r < live[row]: block `part` of the row's cluster reduces
// d in [part * d_chunk, (part + 1) * d_chunk). Threads are r_max/8 rank
// lanes of 8 columns x (blockDim / lanes) d-groups; a lane reads its 8
// columns of one d row of A in a single 16-byte load, up to 8 loads a
// thread in flight. The d-groups are reduced through shared memory by a
// fixed tree, the blocks by rank 0.
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

// One pass: y[rows of slot s in the tile, c0 : c0 + kCols] over all of
// d_in, with nc (a multiple of 8, >= 8) columns computed and the rest 0.
template <typename T, int BM>
__device__ __forceinline__ void shrink_pass(
    const T* __restrict__ x, const T* __restrict__ as_g, float* __restrict__ y,
    T* xs, T* as, const int* sidx, const int* slive, int s, int row0,
    int rows, int d_in, int r_max, int c0, int nc) {
  using C = TileCfg<T>;
  constexpr int kThr = 2 * BM;
  constexpr int VEC = 16 / sizeof(T);       // elements a 16-byte copy
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nk = (d_in + C::kBD - 1) / C::kBD;
  const int ccount = min(kCols, r_max - c0);

  auto load = [&](int buf, int kt) {
    const int d0 = kt * C::kBD;
    T* xb = xs + buf * BM * C::kLdx;
    constexpr int XC = C::kBD / VEC;        // copies a row of x
    for (int i = tid; i < BM * XC; i += kThr) {
      const int r = i / XC, d = d0 + (i % XC) * VEC;
      const bool ok = sidx[r] == s && d < d_in;    // other slots' rows: 0
      const T* src = ok ? x + (size_t)(row0 + r) * d_in + d : x;
      rt::cp_async16(xb + r * C::kLdx + (i % XC) * VEC, src, ok);
    }
    T* ab = as + buf * C::kBD * C::kLda;
    constexpr int AC = kCols / VEC;         // copies a d row of A
    for (int i = tid; i < C::kBD * AC; i += kThr) {
      const int r = i / AC, c = (i % AC) * VEC, d = d0 + r;
      const bool ok = d < d_in && c < nc;   // dead columns are never read
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
    // then added to `acc` on the CUDA cores: the tensor cores' f32 adds
    // round toward zero, which over d_in 4096 drifts past the f32 limit
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
    __syncthreads();                        // buffers free for the next pass
    if (!mine) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + (lane >> 2) + 8 * h;
      if (row0 + r >= rows || sidx[r] != s) continue;
      float* yr = y + (size_t)(row0 + r) * r_max + c0;
#pragma unroll
      for (int n = 0; n < kCols / 8; ++n) {
        const int c = n * 8 + (lane & 3) * 2;
        if (n * 8 < ccount) {
          float2 v;
          v.x = (c < nc && c0 + c < slive[r]) ? acc[n][2 * h] : 0.f;
          v.y = (c + 1 < nc && c0 + c + 1 < slive[r]) ? acc[n][2 * h + 1]
                                                      : 0.f;
          *reinterpret_cast<float2*>(yr + c) = v;
        }
      }
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
    __syncthreads();
    if (cgp * 8 >= ccount) return;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
      if (row0 + r >= rows || sidx[r] != s) continue;
      float* yr = y + (size_t)(row0 + r) * r_max + c0 + cgp * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = cgp * 8 + j;
        yr[j] = (c < nc && c0 + c < slive[r]) ? acc[i][j] : 0.f;
      }
    }
  }
}

template <typename T, int BM>
__global__ void __launch_bounds__(2 * BM) lora_shrink_tile_kernel(
    const T* __restrict__ x, const T* __restrict__ a,
    const int* __restrict__ idx, const int* __restrict__ live,
    float* __restrict__ y, int rows, int d_in, int r_max, int slots) {
  using C = TileCfg<T>;
  constexpr int kThr = 2 * BM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  T* as = xs + C::kStages * BM * C::kLdx;
  __shared__ int sidx[BM], slive[BM], width[BM];
  const int row0 = blockIdx.x * BM, tid = threadIdx.x;
  // each row's slot (-1: past `rows` or no adapter) and live width
  if (tid < BM) {
    const int r = row0 + tid;
    int s = -1, lv = 0;
    if (r < rows) {
      s = idx[r];
      if (s < 0 || s >= slots) s = -1;
      else lv = max(0, min(live[r], r_max));
    }
    sidx[tid] = s;
    slive[tid] = lv;
  }
  __syncthreads();
  // a slot's first row in the tile holds the widest live width of the
  // slot's rows; every other row -1
  if (tid < BM) {
    const int s = sidx[tid];
    int w = -1;
    if (s >= 0) {
      bool first = true;
      for (int u = tid - 1; u >= 0 && first; --u) first = sidx[u] != s;
      if (first) {
        w = 0;
        for (int u = tid; u < BM; ++u)
          if (sidx[u] == s) w = max(w, slive[u]);
      }
    }
    width[tid] = w;
  }
  // rows without an adapter: zero rows (written by the tile's first block)
  if (blockIdx.y == 0) {
    for (int i = tid; i < BM * r_max; i += kThr) {
      const int r = i / r_max;
      if (row0 + r < rows && sidx[r] < 0)
        y[(size_t)(row0 + r) * r_max + i % r_max] = 0.f;
    }
  }
  __syncthreads();
  // block y of the tile takes the tile's y-th distinct slot, if any
  for (int u = 0, k = 0; u < BM; ++u) {
    if (width[u] < 0 || k++ != (int)blockIdx.y) continue;   // uniform
    const int s = sidx[u];
    const int ncol = (width[u] + 7) / 8 * 8;      // computed columns
    const T* as_g = a + (size_t)s * d_in * r_max;
    for (int c0 = 0; c0 < r_max; c0 += kCols) {
      const int nc = min(kCols, ncol - c0);
      if (nc > 0) {
        shrink_pass<T, BM>(x, as_g, y, xs, as, sidx, slive, s, row0, rows,
                           d_in, r_max, c0, nc);
      } else {                              // columns past every live
        const int ccount = min(kCols, r_max - c0);
        for (int i = tid; i < BM * ccount; i += kThr) {
          const int r = i / ccount;
          if (row0 + r < rows && sidx[r] == s)
            y[(size_t)(row0 + r) * r_max + c0 + i % ccount] = 0.f;
        }
      }
    }
    break;
  }
}

template <typename T, int BM>
cudaError_t launch_tile(const void* x, const void* a, const int* idx,
                        const int* live, float* y, int rows, int d_in,
                        int r_max, int slots, cudaStream_t st) {
  auto kern = lora_shrink_tile_kernel<T, BM>;
  constexpr size_t smem = tile_smem<T, BM>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  // a tile holds at most min(slots, BM) distinct slots: one block each
  const dim3 grid((rows + BM - 1) / BM, max(1, min(slots, BM)));
  kern<<<grid, 2 * BM, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), idx, live, y, rows,
      d_in, r_max, slots);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_split(const void* x, const void* a, const int* idx,
                         const int* live, float* y, int rows, int d_in,
                         int r_max, int slots, int d_chunk, cudaStream_t st) {
  const int lanes = r_max / rt::kVec;
  // a handful of rows is bound by latency: 512 threads keep more loads in
  // flight; from 17 rows on, rows x kSplit blocks fill the card at 256
  const int threads = max(rows <= 16 ? 512 : 256, lanes);
  const size_t smem = (size_t)(threads / lanes) * r_max * sizeof(float);
  lora_shrink_split_kernel<T><<<rows * kSplit, threads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), idx, live, y, d_in,
      r_max, slots, d_chunk);
  return cudaGetLastError();
}

// ----------------------------------------------------------- expand ----

// out[row, o] = sum_{r < live[row]} y[row, r] * B[idx[row], r, o], f32
// accumulation, one cast. Grid (rows, ceil(d_out / blockDim)), one output
// column per thread: consecutive threads read consecutive columns of B.
template <typename T>
__global__ void lora_expand_kernel(const T* __restrict__ y,
                                   const T* __restrict__ b,
                                   const int* __restrict__ idx,
                                   const int* __restrict__ live,
                                   T* __restrict__ out, int r_max, int d_out,
                                   int slots) {
  extern __shared__ float ys[];
  const int row = blockIdx.x;
  const int o = blockIdx.y * blockDim.x + threadIdx.x;
  const int s = idx[row];
  const int lv = (s >= 0 && s < slots) ? min(live[row], r_max) : 0;
  for (int r = threadIdx.x; r < lv; r += blockDim.x)
    ys[r] = rt::to_f32(y[(size_t)row * r_max + r]);
  __syncthreads();
  if (o >= d_out) return;
  float acc = 0.f;
  if (lv > 0) {
    const T* bs = b + (size_t)s * r_max * d_out;
#pragma unroll 8
    for (int r = 0; r < lv; ++r)
      acc += ys[r] * rt::to_f32(bs[(size_t)r * d_out + o]);
  }
  out[(size_t)row * d_out + o] = rt::from_f32<T>(acc);
}

constexpr int kExpandThreads = 256;

}  // namespace

// tile = 64 or 128: the row-tile path with tiles of that many rows;
// tile = 0: the split path, kSplit blocks a row over d_chunk-wide slices
// of d_in (a multiple of 8 with kSplit * d_chunk >= d_in).
extern "C" int rt_lora_shrink(const void* x, const void* a, const int* idx,
                              const int* live, float* y, int rows, int d_in,
                              int r_max, int slots, int tile, int d_chunk,
                              int dtype, void* stream) {
  if (rows == 0) return 0;
  // r_max = 8 x a power of two, so the split path's d-groups tree-reduce
  // evenly; d_in a multiple of 8 for 16-byte copies of x
  const int lanes = r_max / rt::kVec;
  if (r_max <= 0 || r_max % rt::kVec != 0 || lanes > 1024 ||
      (lanes & (lanes - 1)) != 0 || d_in <= 0 || d_in % rt::kVec != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf = dtype == rt::kBF16;
  if (!bf && dtype != rt::kF32) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (tile == 0) {
    if (d_chunk <= 0 || d_chunk % rt::kVec != 0 ||
        (long long)d_chunk * kSplit < d_in)
      return (int)cudaErrorInvalidValue;
    e = bf ? launch_split<bf16>(x, a, idx, live, y, rows, d_in, r_max, slots,
                                d_chunk, st)
           : launch_split<float>(x, a, idx, live, y, rows, d_in, r_max,
                                 slots, d_chunk, st);
  } else if (tile == 64) {
    e = bf ? launch_tile<bf16, 64>(x, a, idx, live, y, rows, d_in, r_max,
                                   slots, st)
           : launch_tile<float, 64>(x, a, idx, live, y, rows, d_in, r_max,
                                    slots, st);
  } else if (tile == 128) {
    e = bf ? launch_tile<bf16, 128>(x, a, idx, live, y, rows, d_in, r_max,
                                    slots, st)
           : launch_tile<float, 128>(x, a, idx, live, y, rows, d_in, r_max,
                                     slots, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}

extern "C" int rt_lora_expand(const void* y, const void* b, const int* idx,
                              const int* live, void* out, int rows, int r_max,
                              int d_out, int slots, int dtype, void* stream) {
  if (rows == 0) return 0;
  if (r_max <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(rows, (d_out + kExpandThreads - 1) / kExpandThreads);
  const size_t smem = (size_t)r_max * sizeof(float);
  if (dtype == rt::kBF16)
    lora_expand_kernel<__nv_bfloat16><<<grid, kExpandThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(y),
        static_cast<const __nv_bfloat16*>(b), idx, live,
        static_cast<__nv_bfloat16*>(out), r_max, d_out, slots);
  else if (dtype == rt::kF32)
    lora_expand_kernel<float><<<grid, kExpandThreads, smem, st>>>(
        static_cast<const float*>(y), static_cast<const float*>(b), idx, live,
        static_cast<float*>(out), r_max, d_out, slots);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
