// Paged decode attention for one token per row.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged.py::paged_attention
// (_paged_kernel): same function — a slot counts iff its page is claimed
// (block_table >= 0) and 0 <= kpos <= pos[b]; online softmax in f32 with
// scale hd**-0.5; the mask is applied to p, so a row with no valid slot
// returns zeros; GQA maps query head h to KV head h / (H/KV).
//
// Bound on the H100: bytes. One decode token reads every claimed K/V page
// of its row once and does ~4 flops per byte read, far below the ~295
// flops/byte where bf16 tensor cores become the limit.
//
// Design: one block per (row, KV head) covers the G query heads of the
// group, so each K/V page tile is read from device memory once per group
// rather than once per query head (the TPU grid revisits per head). The
// TPU grid's sequential W dimension becomes a loop inside the block with
// the running max / sum / accumulator in registers (one thread per (g, d)
// output element), cast once at the end. A page whose block-table entry
// is < 0 is skipped before any read of it: the tenant-isolation rule the
// reference pairs with its clamp (paged.py:53 with :106). Page tiles are
// staged in shared memory as f32 with 16-byte loads, several in flight per
// thread; scores use one warp per (g, slot) with a shuffle reduction over
// hd. No cp.async/TMA pipelining of the next page yet.
#include "common.cuh"

namespace {

template <typename T>
__global__ void paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ pos_pages,
    const int* __restrict__ block_table, const int* __restrict__ pos,
    T* __restrict__ out, int H, int KV, int P, int ps, int hd, int W,
    float scale) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;          // G*hd rounded up to a warp
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const bool owner = tid < G * hd;          // owns output element (g, d)
  const int g = tid / hd, d = tid % hd;
  const int h0 = kvh * G;

  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                        // ps*hd
  float* v_s = k_s + ps * hd;               // ps*hd
  float* q_s = v_s + ps * hd;               // G*hd
  float* s_s = q_s + G * hd;                // G*ps
  int* kpos_s = reinterpret_cast<int*>(s_s + G * ps);   // ps

  // the G query heads of this group are contiguous in q (B, H, hd)
  const T* qb = q + ((size_t)b * H + h0) * hd;
  for (int i = tid; i < G * hd; i += nthreads) q_s[i] = rt::to_f32(qb[i]);
  const int pos_b = pos[b];

  float m = rt::kNegInf, l = 0.f, acc = 0.f;
  for (int j = 0; j < W; ++j) {
    const int page = block_table[(size_t)b * W + j];
    // uniform across the block: unclaimed pages are never read
    if (page < 0 || page >= P) continue;
    __syncthreads();                        // last page's tiles consumed
    const size_t base = ((size_t)page * KV + kvh) * ps * hd;
    const T* kb = k_pages + base;
    const T* vb = v_pages + base;
    const int nvec = ps * hd / rt::kVec;
#pragma unroll 4
    for (int i = tid; i < nvec; i += nthreads) {
      float kx[rt::kVec], vx[rt::kVec];
      rt::load8(kb + (size_t)i * rt::kVec, kx);
      rt::load8(vb + (size_t)i * rt::kVec, vx);
      float4* dk = reinterpret_cast<float4*>(k_s + i * rt::kVec);
      float4* dv = reinterpret_cast<float4*>(v_s + i * rt::kVec);
      dk[0] = make_float4(kx[0], kx[1], kx[2], kx[3]);
      dk[1] = make_float4(kx[4], kx[5], kx[6], kx[7]);
      dv[0] = make_float4(vx[0], vx[1], vx[2], vx[3]);
      dv[1] = make_float4(vx[4], vx[5], vx[6], vx[7]);
    }
    for (int i = tid; i < ps; i += nthreads)
      kpos_s[i] = pos_pages[(size_t)page * ps + i];
    __syncthreads();
    for (int i = warp; i < G * ps; i += nwarps) {
      const int gg = i / ps, t = i % ps;
      const int kp = kpos_s[t];
      const bool ok = kp >= 0 && kp <= pos_b;    // uniform in the warp
      float dot = 0.f;
      if (ok)
        for (int e = lane; e < hd; e += 32)
          dot += q_s[gg * hd + e] * k_s[t * hd + e];
      dot = rt::warp_sum(dot);
      if (lane == 0) s_s[i] = ok ? dot * scale : rt::kNegInf;
    }
    __syncthreads();
    if (owner) {
      const float* sg = s_s + g * ps;
      float pm = rt::kNegInf;
      for (int t = 0; t < ps; ++t) pm = fmaxf(pm, sg[t]);
      const float m_new = fmaxf(m, pm);
      const float corr = expf(m - m_new);
      float psum = 0.f, pv = 0.f;
#pragma unroll 8
      for (int t = 0; t < ps; ++t) {
        const int kp = kpos_s[t];
        if (kp >= 0 && kp <= pos_b) {       // masked slots add nothing
          const float p = expf(sg[t] - m_new);
          psum += p;
          pv += p * v_s[t * hd + d];
        }
      }
      l = l * corr + psum;
      acc = acc * corr + pv;
      m = m_new;
    }
  }
  if (owner)
    out[((size_t)b * H + h0) * hd + tid] =
        rt::from_f32<T>(acc / fmaxf(l, 1e-30f));
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* pos_pages, const int* block_table,
                   const int* pos, void* out, int B, int H, int KV, int P,
                   int ps, int hd, int W, cudaStream_t stream) {
  const int G = H / KV;
  const int threads = (G * hd + 31) / 32 * 32;
  const size_t smem =
      sizeof(float) * (2 * (size_t)ps * hd + (size_t)G * hd + (size_t)G * ps)
      + sizeof(int) * ps;
  auto kern = paged_attention_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(B, KV), threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos_pages, block_table, pos,
      static_cast<T*>(out), H, KV, P, ps, hd, W,
      static_cast<float>(1.0 / sqrt(static_cast<double>(hd))));
  return cudaGetLastError();
}

}  // namespace

extern "C" int rt_paged_attention(const void* q, const void* k_pages,
                                  const void* v_pages, const int* pos_pages,
                                  const int* block_table, const int* pos,
                                  void* out, int B, int H, int KV, int P,
                                  int ps, int hd, int W, int dtype,
                                  void* stream) {
  if (B == 0) return 0;
  if (KV <= 0 || H % KV != 0 || (H / KV) * hd > 1024 || hd % rt::kVec != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kBF16)
    return (int)launch<__nv_bfloat16>(q, k_pages, v_pages, pos_pages,
                                      block_table, pos, out, B, H, KV, P, ps,
                                      hd, W, st);
  if (dtype == rt::kF32)
    return (int)launch<float>(q, k_pages, v_pages, pos_pages, block_table,
                              pos, out, B, H, KV, P, ps, hd, W, st);
  return (int)cudaErrorInvalidValue;
}
