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
// Bound on the H100: operations. A causal prefill of L tokens does
// 4 * H * hd * L(L+1)/2 flops per row against (2H + 2KV) * L * hd bf16
// values moved: ~900 flops per byte at L 4096 (H 32, KV 4, hd 128), three
// times the ~295 flops/byte above which the bf16 tensor cores, not the
// memory, are the limit. At yi-9b's long-prompt prefill (8 rows x 4096
// tokens, H 32, hd 128) one layer is 1.1e12 flops: 1.1 ms at 989 TFLOP/s.
//
// Design (bf16). One block of 4 warps per (query tile of 64 rows, head,
// row), the heaviest causal tiles launched first. The TPU grid's
// sequential KV axis becomes a loop inside the block over KV tiles of 64
// keys that starts and ends where the causal / window mask allows, so a
// tile the mask excludes is never read. Q is staged in shared memory once
// and then held as mma fragments in registers; each K/V tile is loaded
// once for the whole query tile with 16-byte cp.async, zero-filled at and
// past Lk (ragged lengths need no padded copies), and double-buffered so
// the next tile's loads overlap this tile's math. QK^T and PV run on the
// tensor cores as mma.sync m16n8k16 (bf16 in, f32 accumulate). Each warp
// owns 16 query rows, so the softmax statistics stay in registers (a quad
// of lanes shares a row) and P goes from the score accumulators straight
// into PV's A fragments, rounded to bf16. The element-wise mask runs only
// on tiles the mask cuts. q/k/v/out are strided (last dim contiguous), so
// the model passes its (B, L, H, hd) tensors as (B, H, L, hd) views
// without a copy. No wgmma, TMA or warp specialisation yet.
//
// Design (f32, small shapes). The same tiling on CUDA cores: 32 x 32
// tiles, one quad of lanes per query row, scores and P in f32.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;            // 4 warps
constexpr int kBQ = 64, kBK = 64;        // bf16 tiles (16 query rows / warp)
constexpr int kFB = 32;                  // f32 tiles (queries and keys)
constexpr float kLog2e = 1.4426950408889634f;

struct Problem {
  int H, KV, Lq, Lk, causal, window;     // window <= 0: none
  long long qb, qh, ql;                  // element strides of q
  long long kb, kh, kl;                  // k
  long long vb, vh, vl;                  // v
  long long ob, oh, ol;                  // out
  float scale;
};

// KV tiles [j_lo, j_hi) a query tile starting at q0 can see: keys past the
// tile's last query are causally masked, keys at or before q0 - window are
// outside every row's window.
__device__ __forceinline__ void kv_tiles(const Problem& p, int q0, int bq,
                                         int bk, int& j_lo, int& j_hi) {
  int k_hi = p.Lk;
  if (p.causal) k_hi = min(k_hi, q0 + bq);
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  j_lo = k_lo / bk;
  j_hi = (k_hi + bk - 1) / bk;
}

__device__ __forceinline__ bool key_ok(const Problem& p, int qpos, int kpos) {
  return kpos < p.Lk && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || qpos - kpos < p.window);
}

// True when every (query, key) pair of the tile is valid, so the
// element-wise mask can be skipped.
__device__ __forceinline__ bool tile_full(const Problem& p, int q0, int bq,
                                          int k0, int bk) {
  return k0 + bk <= p.Lk && (!p.causal || k0 + bk - 1 <= q0) &&
         (p.window <= 0 || (q0 + bq - 1) - k0 < p.window);
}

// ------------------------------------------------------ PTX helpers ----

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared; `pred` false zero-fills the 16 bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16, `lo` in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// rows [row0, row0 + ROWS) of a (rows, HD) bf16 matrix with row stride
// `ld` into shared memory (row stride LDS), rows at or past n_rows zeroed
template <int ROWS, int HD, int LDS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long ld, int row0, int n_rows,
                                          int tid) {
  constexpr int kChunks = HD / 8;
#pragma unroll 4
  for (int i = tid; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = row0 + r < n_rows;
    const bf16* s = ok ? src + (long long)(row0 + r) * ld + c * 8 : src;
    cp_async16(dst + r * LDS + c * 8, s, ok);
  }
}

// -------------------------------------------------------------- bf16 ----

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, Problem p) {
  constexpr int LDS = HD + 8;            // padded: ldmatrix conflict-free
  constexpr int KS = HD / 16;            // k-steps of QK^T over hd
  constexpr int NO = HD / 8;             // 8-wide output column tiles
  constexpr int NS = kBK / 8;            // 8-key score tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kBQ * LDS;           // two buffers
  bf16* v_s = k_s + 2 * kBK * LDS;       // two buffers

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const bf16* qb = q + b * p.qb + h * p.qh;
  const bf16* kb = k + b * p.kb + kvh * p.kh;
  const bf16* vb = v + b * p.vb + kvh * p.vh;
  int j_lo, j_hi;
  kv_tiles(p, q0, kBQ, kBK, j_lo, j_hi);

  load_rows<kBQ, HD, LDS>(q_s, qb, p.ql, q0, p.Lq, tid);
  cp_async_commit();
  if (j_lo < j_hi) {
    load_rows<kBK, HD, LDS>(k_s, kb, p.kl, j_lo * kBK, p.Lk, tid);
    load_rows<kBK, HD, LDS>(v_s, vb, p.vl, j_lo * kBK, p.Lk, tid);
  }
  cp_async_commit();
  cp_async_wait<1>();                    // Q has landed
  __syncthreads();

  unsigned qf[KS][4];                    // this warp's 16 rows of Q
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldsm_x4(qf[ks], q_s + (warp * 16 + (lane & 15)) * LDS + ks * 16 +
                        (lane >> 4) * 8);

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {rt::kNegInf, rt::kNegInf}, l[2] = {0.f, 0.f};
  const int qrow = q0 + warp * 16 + (lane >> 2);   // +8 for the second row
  const float sl2 = p.scale * kLog2e;              // exp(x) = exp2(x log2 e)

  for (int j = j_lo; j < j_hi; ++j) {
    const int buf = (j - j_lo) & 1;
    if (j + 1 < j_hi) {
      load_rows<kBK, HD, LDS>(k_s + (buf ^ 1) * kBK * LDS, kb, p.kl,
                              (j + 1) * kBK, p.Lk, tid);
      load_rows<kBK, HD, LDS>(v_s + (buf ^ 1) * kBK * LDS, vb, p.vl,
                              (j + 1) * kBK, p.Lk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();                  // tile j has landed
    __syncthreads();
    const bf16* kt = k_s + buf * kBK * LDS;
    const bf16* vt = v_s + buf * kBK * LDS;

    // S = Q K^T: score tile n holds keys 8n..8n+7
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        unsigned bk[4];
        ldsm_x4(bk, kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LDS +
                        ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[ks], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[ks], bk[2], bk[3]);
      }
    }

    // mask, running max, rescale
    const int k0 = j * kBK;
    const bool full = tile_full(p, q0, kBQ, k0, kBK);
    float mx[2] = {rt::kNegInf, rt::kNegInf};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl2;
        if (!full && !key_ok(p, qrow + (e >> 1) * 8,
                             k0 + n * 8 + (lane & 3) * 2 + (e & 1)))
          x = rt::kNegInf;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }

    // P (masked entries exactly 0) as the A fragments of PV: k-step t
    // covers keys 16t..16t+15, i.e. score tiles 2t and 2t + 1
    unsigned pf[NS / 2][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      float pe[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pe[e] = s[n][e] > rt::kNegInf ? exp2f(s[n][e] - m[e >> 1]) : 0.f;
      l[0] += pe[0] + pe[1];
      l[1] += pe[2] + pe[3];
      pf[n >> 1][(n & 1) * 2] = pack_bf16(pe[0], pe[1]);
      pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(pe[2], pe[3]);
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V
#pragma unroll
    for (int t = 0; t < NS / 2; ++t) {
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        unsigned bv[4];
        ldsm_x4_trans(bv, vt + (t * 16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                                   * LDS + dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pf[t], bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], pf[t], bv[2], bv[3]);
      }
    }
    __syncthreads();                     // buffer `buf` is refilled next
  }

  // the quad's partial sums -> the row's l; stage the tile in q_s (Q now
  // lives in registers; each warp rewrites only the rows it read) for
  // 16-byte stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  __syncwarp();
  const int srow = warp * 16 + (lane >> 2);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + (lane & 3) * 2;
    *reinterpret_cast<unsigned*>(q_s + srow * LDS + col) =
        pack_bf16(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<unsigned*>(q_s + (srow + 8) * LDS + col) =
        pack_bf16(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
  __syncthreads();
  bf16* ob = out + b * p.ob + h * p.oh;
  constexpr int kChunks = HD / 8;
  for (int i = tid; i < kBQ * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    if (q0 + r < p.Lq)
      *reinterpret_cast<uint4*>(ob + (long long)(q0 + r) * p.ol + c * 8) =
          *reinterpret_cast<const uint4*>(q_s + r * LDS + c * 8);
  }
}

// --------------------------------------------------------------- f32 ----

// rows [row0, row0 + kFB) of a (rows, HD) f32 matrix into shared memory
// (row stride LDS), rows at or past n_rows zeroed; 16-byte loads
template <int HD, int LDS>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              long long ld, int row0,
                                              int n_rows, int tid) {
  constexpr int kChunks = HD / 4;
  for (int i = tid; i < kFB * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows)
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
  load_rows_f32<HD, LDS>(q_s, q + b * p.qb + h * p.qh, p.ql, q0, p.Lq, tid);
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
    load_rows_f32<HD, LDS>(k_s, kb, p.kl, k0, p.Lk, tid);
    load_rows_f32<HD, LDS>(v_s, vb, p.vl, k0, p.Lk, tid);
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
    for (int a = 0; a < NA; ++a) orow[c4 + 4 * a] = acc[a] * inv;
  }
}

// ------------------------------------------------------------ launch ----

template <typename T, typename Kern>
cudaError_t launch(Kern kern, int tile, size_t smem, const void* q,
                   const void* k, const void* v, void* out, const Problem& p,
                   int B, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.Lq + tile - 1) / tile, p.H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, const Problem& p, int B, cudaStream_t st) {
  const size_t smem = sizeof(bf16) * (size_t)(kBQ + 4 * kBK) * (HD + 8);
  return launch<bf16>(flash_bf16_kernel<HD>, kBQ, smem, q, k, v, out, p, B,
                      st);
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, const Problem& p, int B, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * ((size_t)3 * kFB * (HD + 1) + (size_t)kFB * (kFB + 1));
  return launch<float>(flash_f32_kernel<HD>, kFB, smem, q, k, v, out, p, B,
                       st);
}

}  // namespace

// strides: 12 element strides on the host, (batch, head, seq) of q, k, v
// and out in that order; the last dim of each is contiguous.
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
  p.qb = strides[0]; p.qh = strides[1]; p.ql = strides[2];
  p.kb = strides[3]; p.kh = strides[4]; p.kl = strides[5];
  p.vb = strides[6]; p.vh = strides[7]; p.vl = strides[8];
  p.ob = strides[9]; p.oh = strides[10]; p.ol = strides[11];
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kBF16) {
    switch (hd) {
      case 32: return (int)launch_bf16<32>(q, k, v, out, p, B, st);
      case 64: return (int)launch_bf16<64>(q, k, v, out, p, B, st);
      case 128: return (int)launch_bf16<128>(q, k, v, out, p, B, st);
    }
  } else if (dtype == rt::kF32) {
    switch (hd) {
      case 16: return (int)launch_f32<16>(q, k, v, out, p, B, st);
      case 32: return (int)launch_f32<32>(q, k, v, out, p, B, st);
      case 64: return (int)launch_f32<64>(q, k, v, out, p, B, st);
      case 128: return (int)launch_f32<128>(q, k, v, out, p, B, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}
