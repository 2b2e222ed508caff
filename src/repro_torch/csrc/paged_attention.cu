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
// Design:
//  - Grid (row, KV head x group tile, split). A split takes a contiguous
//    run of the row's block-table columns, so a long row spreads over many
//    SMs even when rows x KV heads x tiles are few (yi-9b: 8 x 4). The
//    split count is chosen on the host from W, B x KV x tiles and the SM
//    count (kernels/paged.py: split_plan). With one split the block writes the output; with more,
//    each writes (m, l, acc) in f32 to a workspace and a second kernel
//    combines the splits in split order. A split with no valid slot gives
//    (m = -1e30, l = 0, acc = 0); a row with none anywhere gets zeros.
//  - A block covers a tile of Gb query heads of its KV head, so each page
//    is read once per tile. Gb is the whole group G where one block holds
//    it (G * L <= kMaxThreads, L below); a larger group (an MQA model's 32
//    or 71 heads) is cut into ntile = ceil(G * L / kMaxThreads) tiles of
//    Gb = ceil(G / ntile) heads, the grid's y axis being (KV head, tile).
//    The other tiles of a KV head read its pages again, mostly from L2.
//    A block first lists the claimed entries of its run (warp ballot, in
//    table order): an entry < 0 or >= P is skipped before any read of its
//    page, the tenant-isolation rule the reference pairs with its clamp
//    (paged.py:53 with :106). Pages then stream through a kStages-deep
//    ring of K, V and positions in the input dtype, one __syncthreads() a
//    page: 16-byte cp.async copies where hd is a multiple of 8 (kVec), else
//    element copies into rows padded to HDP = ceil(hd / 8) * 8 columns
//    whose pad is zero, so the score and P V code is the same for both.
//  - Thread (tg, g, c) keeps q[g, 8c : 8c + 8] and its 8 output columns in
//    registers. A score is the sum over the L = pow2(HDP / 8) lanes of a
//    head (xor shuffles), so every lane of the head holds it and no score
//    goes through shared memory. Slot groups tg = 0 .. TG-1 take the
//    slots t = tg (mod TG) of each page, TG = kMaxThreads / (Gb * L) slot
//    groups (G = 8: 2, G = 1: 16; G = 6 or 12, hd 128: 2 or 1), each with
//    its own running max / sum, merged at the end in tg order. Any G and
//    any hd up to 256 are taken (rt_paged_attention_fits): above 256 a
//    head's L would pass the 32 lanes of the warp its score is reduced
//    in. Sums run in a fixed order: results repeat bitwise.
#include "common.cuh"

namespace {

constexpr int kStages = 3;                  // page ring depth
constexpr int kList = 256;                  // block-table columns a window
constexpr int kGroup = 4;                   // slots a rescale
constexpr int kMaxThreads = 256;
constexpr int kMaxHeadDim = 32 * rt::kVec;  // L <= one warp's lanes

// The launch's head layout: L lanes a head (8 columns each, HDP = hd
// rounded up to 8), group tiles of Gb heads, ntile tiles a KV head.
struct Heads {
  int hdp, L, Gb, ntile;
};

__host__ __device__ inline Heads heads_of(int G, int hd) {
  Heads h;
  h.hdp = (hd + rt::kVec - 1) / rt::kVec * rt::kVec;
  h.L = 1;
  while (h.L < h.hdp / rt::kVec) h.L *= 2;
  const int cap = kMaxThreads / h.L;        // heads a block holds
  h.ntile = (G + cap - 1) / cap;
  h.Gb = (G + h.ntile - 1) / h.ntile;       // tiles as even as they come
  return h;
}

// kVec: hd a multiple of 8, pages copied in 16-byte cp.async; else element
// copies into HDP-column rows whose pad columns are zero.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kMaxThreads) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ pos_pages,
    const int* __restrict__ block_table, const int* __restrict__ pos,
    T* __restrict__ out, float* __restrict__ ws, int H, int KV, int P,
    int ps, int hd, int W, int nsplit, int L, int TG, int Gb, int ntile,
    float scale) {
  constexpr int VEC = 16 / sizeof(T);       // elements a 16-byte copy
  const int b = blockIdx.x, split = blockIdx.z;
  const int kvh = blockIdx.y / ntile, g0 = (blockIdx.y % ntile) * Gb;
  const int G = H / KV, h0 = kvh * G + g0;  // this tile's first head
  const int Gt = min(Gb, G - g0);           // heads of this tile
  const int hdp = kVec ? hd : (hd + rt::kVec - 1) / rt::kVec * rt::kVec;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int c = tid % L, g = (tid / L) % Gb, tg = tid / (L * Gb);
  const bool real = tid < L * Gb * TG;      // the rest pad the last warp
  const bool act = real && c < hdp / rt::kVec && g < Gt;
  const int gtile = ps * hd;                // elements of a page's K (or V)
  const int stile = ps * hdp;               // ... in a ring stage

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);              // kStages x (K, V)
  int* kpos_s = reinterpret_cast<int*>(ring + (size_t)kStages * 2 * stile);
  __shared__ int plist[kList];
  __shared__ int pcount;

  float qv[rt::kVec], acc[rt::kVec];
#pragma unroll
  for (int j = 0; j < rt::kVec; ++j) qv[j] = acc[j] = 0.f;
  const T* qh = q + ((size_t)b * H + h0 + g) * hd + c * rt::kVec;
  if (act) {
    if constexpr (kVec) {
      rt::load8(qh, qv);
    } else {
#pragma unroll
      for (int j = 0; j < rt::kVec; ++j)
        if (c * rt::kVec + j < hd) qv[j] = rt::to_f32(qh[j]);
    }
  }
  if constexpr (!kVec) {
    // the pad columns of every ring row: zero, never copied over
    const int pad = hdp - hd;
    for (int i = tid; i < kStages * 2 * ps * pad; i += nthr)
      ring[(size_t)(i / pad) * hdp + hd + i % pad] = rt::from_f32<T>(0.f);
  }
  const int pos_b = pos[b];
  float m = rt::kNegInf, l = 0.f;

  auto load = [&](int st, int page) {
    const size_t base = ((size_t)page * KV + kvh) * gtile;
    T* ks = ring + (size_t)st * 2 * stile;
    T* vs = ks + stile;
    if constexpr (kVec) {
      for (int i = tid; i < gtile / VEC; i += nthr) {
        rt::cp_async16(ks + i * VEC, k_pages + base + (size_t)i * VEC, true);
        rt::cp_async16(vs + i * VEC, v_pages + base + (size_t)i * VEC, true);
      }
    } else {
      // the stage was consumed before the __syncthreads() that precedes
      // this copy, so plain stores may land in it at once
      for (int i = tid; i < gtile; i += nthr) {
        const int si = (i / hd) * hdp + i % hd;
        ks[si] = k_pages[base + i];
        vs[si] = v_pages[base + i];
      }
    }
    for (int i = tid; i < ps; i += nthr)
      rt::cp_async4(kpos_s + st * ps + i, pos_pages + (size_t)page * ps + i);
  };

  const int per = (W + nsplit - 1) / nsplit;
  const int j_lo = split * per, j_hi = min(W, j_lo + per);
  for (int w0 = j_lo; w0 < j_hi; w0 += kList) {
    // the claimed entries of this window, in table order
    const int wn = min(kList, j_hi - w0);
    if (tid < 32) {
      int cnt = 0;
      for (int i0 = 0; i0 < wn; i0 += 32) {
        const int i = i0 + tid;
        const int page = i < wn ? block_table[(size_t)b * W + w0 + i] : -1;
        const bool ok = page >= 0 && page < P;
        const unsigned bal = __ballot_sync(0xffffffffu, ok);
        if (ok) plist[cnt + __popc(bal & ((1u << tid) - 1u))] = page;
        cnt += __popc(bal);
      }
      if (tid == 0) pcount = cnt;
    }
    __syncthreads();
    const int n = pcount;
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < n) load(st, plist[st]);
      rt::cp_async_commit();
    }
    for (int j = 0; j < n; ++j) {
      rt::cp_async_wait<kStages - 2>();
      __syncthreads();                      // page j landed; j - 1 consumed
      const int nxt = j + kStages - 1;
      if (nxt < n) load(nxt % kStages, plist[nxt]);
      rt::cp_async_commit();
      const T* ks = ring + (size_t)(j % kStages) * 2 * stile;
      const T* vs = ks + stile;
      const int* kp = kpos_s + (j % kStages) * ps;
      // this slot group's slots, kGroup at a time (trip count uniform
      // across the block, so every lane takes part in the shuffles)
      for (int t0 = 0; t0 < ps; t0 += kGroup * TG) {
        float s[kGroup];
        unsigned ok = 0u;
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const int t = t0 + u * TG + tg;
          float dot = 0.f;
          if (act && t < ps) {
            float kx[rt::kVec];
            rt::load8(ks + t * hdp + c * rt::kVec, kx);
#pragma unroll
            for (int e = 0; e < rt::kVec; ++e) dot += qv[e] * kx[e];
          }
          for (int off = L / 2; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          const bool valid = real && t < ps && kp[t] >= 0 && kp[t] <= pos_b;
          s[u] = valid ? dot * scale : rt::kNegInf;
          ok |= (unsigned)valid << u;
        }
        float pm = rt::kNegInf;
#pragma unroll
        for (int u = 0; u < kGroup; ++u) pm = fmaxf(pm, s[u]);
        const float m_new = fmaxf(m, pm);
        const float corr = expf(m - m_new);
        l *= corr;
#pragma unroll
        for (int e = 0; e < rt::kVec; ++e) acc[e] *= corr;
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          if (!((ok >> u) & 1u)) continue;  // masked slots add nothing
          const float p = expf(s[u] - m_new);
          l += p;
          if (act) {
            float vx[rt::kVec];
            rt::load8(vs + (t0 + u * TG + tg) * hdp + c * rt::kVec, vx);
#pragma unroll
            for (int e = 0; e < rt::kVec; ++e) acc[e] += p * vx[e];
          }
        }
        m = m_new;
      }
    }
    rt::cp_async_wait<0>();
    __syncthreads();                        // ring and list free
  }

  // merge the slot groups in tg order (shared memory reused)
  float* red = reinterpret_cast<float*>(smem_raw);       // nthr x 8
  float* ml = red + (size_t)nthr * rt::kVec;             // TG x Gb x (m, l)
  if (real) {
    float4* mine = reinterpret_cast<float4*>(red + (size_t)tid * rt::kVec);
    mine[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    mine[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    if (c == 0) {
      ml[(tg * Gb + g) * 2] = m;
      ml[(tg * Gb + g) * 2 + 1] = l;
    }
  }
  __syncthreads();
  if (!act || tg != 0) return;
  float M = rt::kNegInf;
  for (int t = 0; t < TG; ++t) M = fmaxf(M, ml[(t * Gb + g) * 2]);
  float lsum = 0.f, o[rt::kVec];
#pragma unroll
  for (int e = 0; e < rt::kVec; ++e) o[e] = 0.f;
  for (int t = 0; t < TG; ++t) {
    const float w = expf(ml[(t * Gb + g) * 2] - M);
    lsum += ml[(t * Gb + g) * 2 + 1] * w;
    const float* r = red + (size_t)((t * Gb + g) * L + c) * rt::kVec;
#pragma unroll
    for (int e = 0; e < rt::kVec; ++e) o[e] += r[e] * w;
  }
  // this lane's columns below hd (all 8 unless hd is no multiple of 8)
  const int ncol = kVec ? rt::kVec : min(rt::kVec, hd - c * rt::kVec);
  if (nsplit == 1) {
    T* ob = out + ((size_t)b * H + h0 + g) * hd + c * rt::kVec;
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
#pragma unroll
    for (int e = 0; e < rt::kVec; ++e)
      if (e < ncol) ob[e] = rt::from_f32<T>(o[e] * inv);
  } else {
    // workspace (B, KV, nsplit, G, hd + 2): acc, then m and l
    float* wp = ws + ((((size_t)b * KV + kvh) * nsplit + split) * G + g0 +
                      g) * (hd + 2);
#pragma unroll
    for (int e = 0; e < rt::kVec; ++e)
      if (e < ncol) wp[c * rt::kVec + e] = o[e];
    if (c == 0) {
      wp[hd] = M;
      wp[hd + 1] = lsum;
    }
  }
}

// out[b, kvh * G + g, d] from the splits' (m, l, acc), in split order.
template <typename T>
__global__ void paged_combine_kernel(const float* __restrict__ ws,
                                     T* __restrict__ out, int H, int KV,
                                     int hd, int nsplit) {
  const int b = blockIdx.x, kvh = blockIdx.y, G = H / KV;
  const size_t stride = (size_t)G * (hd + 2);           // one split
  const float* base = ws + ((size_t)b * KV + kvh) * nsplit * stride;
  for (int i = threadIdx.x; i < G * hd; i += blockDim.x) {
    const int g = i / hd, d = i % hd;
    const float* w0 = base + (size_t)g * (hd + 2);
    float M = rt::kNegInf;
    for (int k = 0; k < nsplit; ++k) M = fmaxf(M, w0[k * stride + hd]);
    float lsum = 0.f, o = 0.f;
    for (int k = 0; k < nsplit; ++k) {
      const float w = expf(w0[k * stride + hd] - M);
      lsum += w0[k * stride + hd + 1] * w;
      o += w0[k * stride + d] * w;
    }
    out[((size_t)b * H + kvh * G + g) * hd + d] =
        rt::from_f32<T>(o / fmaxf(lsum, 1e-30f));
  }
}

// The attention kernel's launch, and the combine's (used with nsplit > 1),
// with the attention kernel's head layout and slot groups (TG).
struct PagedPlan {
  rt::Launch attn, combine;
  Heads hs;
  int TG;
};

template <typename T>
PagedPlan paged_plan(int B, int H, int KV, int ps, int hd, int nsplit) {
  const int G = H / KV;
  PagedPlan p;
  p.hs = heads_of(G, hd);
  const int GL = p.hs.Gb * p.hs.L;
  p.TG = GL >= kMaxThreads ? 1 : kMaxThreads / GL;
  const int threads = (GL * p.TG + 31) / 32 * 32;
  const size_t ring = (size_t)kStages * (2 * (size_t)ps * p.hs.hdp *
                                             sizeof(T) +
                                         (size_t)ps * sizeof(int));
  const size_t merge = sizeof(float) * ((size_t)threads * rt::kVec +
                                        2 * (size_t)p.TG * p.hs.Gb);
  const bool vec = hd % rt::kVec == 0;
  p.attn = {vec ? (const void*)paged_attention_kernel<T, true>
                : (const void*)paged_attention_kernel<T, false>,
            dim3(B, KV * p.hs.ntile, nsplit), threads,
            ring > merge ? ring : merge};
  const int ct = G * hd < 1024 ? (G * hd + 31) / 32 * 32 : 1024;
  p.combine = {(const void*)paged_combine_kernel<T>, dim3(B, KV), ct, 0};
  return p;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* pos_pages, const int* block_table,
                   const int* pos, void* out, float* ws, int B, int H, int KV,
                   int P, int ps, int hd, int W, int nsplit,
                   cudaStream_t stream) {
  const PagedPlan pl = paged_plan<T>(B, H, KV, ps, hd, nsplit);
  int L = pl.hs.L, TG = pl.TG, Gb = pl.hs.Gb, ntile = pl.hs.ntile;
  float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  void* args[] = {&q, &k, &v, &pos_pages, &block_table, &pos, &out, &ws,
                  &H, &KV, &P, &ps, &hd, &W, &nsplit, &L, &TG, &Gb, &ntile,
                  &scale};
  const cudaError_t e = rt::launch(pl.attn, args, stream);
  if (e != cudaSuccess || nsplit == 1) return e;
  void* cargs[] = {&ws, &out, &H, &KV, &hd, &nsplit};
  return rt::launch(pl.combine, cargs, stream);
}

}  // namespace

// 1 when the kernel takes GQA group G at head dim hd: any group (tiles of
// at most kMaxThreads / L heads a block) and any hd up to kMaxHeadDim,
// where a head's L lanes still fit the warp its score is reduced in.
extern "C" int rt_paged_attention_fits(int G, int hd) {
  return G >= 1 && hd >= 1 && hd <= kMaxHeadDim ? 1 : 0;
}

// The group tiles a KV head's G query heads are cut into at head dim hd
// (the grid's y axis is KV heads x tiles), or 0 where the kernel refuses.
extern "C" int rt_paged_attention_tiles(int G, int hd) {
  return rt_paged_attention_fits(G, hd) ? heads_of(G, hd).ntile : 0;
}

namespace {

bool paged_args_ok(int B, int H, int KV, int ps, int hd, int W, int nsplit,
                   int dtype) {
  return B > 0 && KV > 0 && H % KV == 0 &&
         rt_paged_attention_fits(H / KV, hd) && ps > 0 && W >= 0 &&
         nsplit >= 1 && nsplit <= (W > 1 ? W : 1) &&
         (dtype == rt::kBF16 || dtype == rt::kF32);
}

}  // namespace

// nsplit >= 1 runs of block-table columns a row; ws: f32 workspace of
// B * KV * nsplit * (H / KV) * (hd + 2) floats, unused (may be null) when
// nsplit == 1.
extern "C" int rt_paged_attention(const void* q, const void* k_pages,
                                  const void* v_pages, const int* pos_pages,
                                  const int* block_table, const int* pos,
                                  void* out, float* ws, int B, int H, int KV,
                                  int P, int ps, int hd, int W, int nsplit,
                                  int dtype, void* stream) {
  if (B == 0) return 0;
  if (!paged_args_ok(B, H, KV, ps, hd, W, nsplit, dtype) ||
      (nsplit > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kBF16)
    return (int)launch<__nv_bfloat16>(q, k_pages, v_pages, pos_pages,
                                      block_table, pos, out, ws, B, H, KV, P,
                                      ps, hd, W, nsplit, st);
  if (dtype == rt::kF32)
    return (int)launch<float>(q, k_pages, v_pages, pos_pages, block_table,
                              pos, out, ws, B, H, KV, P, ps, hd, W, nsplit,
                              st);
  return (int)cudaErrorInvalidValue;
}

// rt_paged_attention's launches, described (rt::describe): the attention
// kernel into out[0 : rt::kInfoFields] and, with nsplit > 1, the combine
// into out[rt::kInfoFields : 2 * rt::kInfoFields]; no kernel runs.
extern "C" int rt_paged_attention_info(int B, int H, int KV, int ps, int hd,
                                       int W, int nsplit, int dtype,
                                       long long* out) {
  if (!paged_args_ok(B, H, KV, ps, hd, W, nsplit, dtype))
    return (int)cudaErrorInvalidValue;
  const PagedPlan pl =
      dtype == rt::kBF16
          ? paged_plan<__nv_bfloat16>(B, H, KV, ps, hd, nsplit)
          : paged_plan<float>(B, H, KV, ps, hd, nsplit);
  cudaError_t e = rt::describe(pl.attn, out);
  if (e == cudaSuccess && nsplit > 1)
    e = rt::describe(pl.combine, out + rt::kInfoFields);
  return (int)e;
}
