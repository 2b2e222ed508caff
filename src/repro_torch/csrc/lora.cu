// Gathered LoRA shrink and expand (BGMV / MBGMV).
//
// Replace the Pallas TPU kernels src/repro/kernels/bgmv.py::bgmv_shrink,
// ::bgmv_expand (_shrink_kernel, _expand_kernel) and
// src/repro/kernels/mbgmv.py::mbgmv_shrink, ::mbgmv_expand. The four TPU
// kernels become two CUDA kernels that differ only in `live[b]`, the
// number of rank columns computed for row b:
//   BGMV  live[b] = r_max                                (max-rank law)
//   MBGMV live[b] = ceil(rank[idx[b]] / rank_block) * rank_block
//                                                        (sum-rank law)
// Columns at or past live[b] are exactly zero and their weights are never
// read; a row with idx[b] < 0 (no adapter) is a zero row and reads nothing.
//
// Bound on the H100: bytes. Each row does 2 flops per adapter weight it
// reads; with a handful of adapters per batch that is ~1 flop per byte,
// so moving the live adapter columns is the whole cost. The kernels read
// only live columns, which is what makes MBGMV's cost follow the sum of
// ranks; a row re-reads its adapter from L2 when several rows share it
// (prefill flattens B*T rows with idx repeated — a segmented SGMV kernel
// that reads each adapter once per segment is later work).
#include "common.cuh"

namespace {

// y[row, r] = sum_d x[row, d] * A[idx[row], d, r] for r < live[row], f32.
// One block of kShrinkThreads per row; threads are r_max/8 rank lanes of
// 8 columns x (kShrinkThreads / lanes) d-groups. A lane reads its 8
// columns of one d row of A in a single 16-byte load, so a warp reads
// 4 consecutive d rows (512 contiguous bytes at r_max 64); the d loop is
// unrolled so several loads are in flight per thread, which a handful of
// rows needs to cover memory latency. The d-groups are reduced through
// shared memory by a fixed tree, so the result is deterministic.
template <typename T>
__global__ void __launch_bounds__(1024) lora_shrink_kernel(
    const T* __restrict__ x, const T* __restrict__ a,
    const int* __restrict__ idx, const int* __restrict__ live,
    float* __restrict__ y, int d_in, int r_max, int slots) {
  extern __shared__ float red[];            // ngrp * r_max
  const int row = blockIdx.x;
  const int lanes = r_max / rt::kVec;
  const int lane = threadIdx.x % lanes, grp = threadIdx.x / lanes;
  const int ngrp = blockDim.x / lanes;      // a power of two
  const int c0 = lane * rt::kVec;
  const int s = idx[row];
  const int lv = (s >= 0 && s < slots) ? min(live[row], r_max) : 0;
  float acc[rt::kVec];
#pragma unroll
  for (int j = 0; j < rt::kVec; ++j) acc[j] = 0.f;
  if (c0 < lv) {
    const T* xr = x + (size_t)row * d_in;
    const T* as = a + (size_t)s * d_in * r_max + c0;
#pragma unroll 4
    for (int d = grp; d < d_in; d += ngrp) {
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
  if (grp == 0) {
#pragma unroll
    for (int j = 0; j < rt::kVec; ++j)
      y[(size_t)row * r_max + c0 + j] = (c0 + j < lv) ? red[c0 + j] : 0.f;
  }
}

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

constexpr int kShrinkThreads = 1024;
constexpr int kExpandThreads = 256;

}  // namespace

extern "C" int rt_lora_shrink(const void* x, const void* a, const int* idx,
                              const int* live, float* y, int rows, int d_in,
                              int r_max, int slots, int dtype, void* stream) {
  if (rows == 0) return 0;
  // r_max = 8 x a power of two, so the d-groups tree-reduce evenly
  const int lanes = r_max / rt::kVec;
  if (r_max % rt::kVec != 0 || lanes > kShrinkThreads ||
      (lanes & (lanes - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)(kShrinkThreads / lanes) * r_max * sizeof(float);
  if (dtype == rt::kBF16)
    lora_shrink_kernel<__nv_bfloat16><<<rows, kShrinkThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(a), idx, live, y, d_in, r_max,
        slots);
  else if (dtype == rt::kF32)
    lora_shrink_kernel<float><<<rows, kShrinkThreads, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(a), idx,
        live, y, d_in, r_max, slots);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
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
