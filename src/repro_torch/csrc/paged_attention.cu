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
//
// The group route (bf16, GQA group 2 to kGroupMaxG: every GQA model the
// port serves, MQA included): paged_group_kernel. The kernel above holds
// one head in pow2(hd / 8) lanes, so a score costs a chain of shuffles
// and every lane of the head its own exp, a page is walked slot group by
// slot group, and a group past 256 threads reads each page once a tile.
// Here one block of a (split, KV head, row) holds the whole group: its
// ceil(G / 16) M tiles of 16 query heads (rows past G are zero and never
// stored) are the M axis of mma.sync.m16n8k16 products, so each page is
// read once for the group and a score costs no shuffle.
//  - Grid (split, KV head, row): the splits of a row are launched side
//    by side, so a long row's blocks start first.
//  - Warp (mt, kw) takes M tile mt and the 16-slot groups kw, kw + KW, ..
//    of every page: S = Q_mt K_slots^T (bf16 in, f32 accumulate: bf16
//    products are exact in f32, so S differs from the plain version only
//    in summation order), the online softmax on the accumulator fragments
//    (a row's max from one quad's two shuffles a slot group), then
//    O += P V_slots with P = P_hi + P_lo as two bf16 products, since the
//    reference keeps p in f32. A masked slot's score is replaced by the
//    reference's NEG_INF and its V fragment is zeroed in registers, so
//    whatever a masked slot holds (NaN included) adds nothing.
//  - Pages stream through a kGroupStages ring of cp.async copies (the
//    group's queries staged while the first pages are in flight), a
//    stage a page of up to kGroupChunk x 16 slots or that many slots of a
//    larger page, so shared memory does not grow with the page size (at
//    most ~199 KB: hd 256, 128 heads). K and V rows are HDS = HDP + 8
//    elements apart (HDP: hd rounded up to 16 x the instantiated k-steps,
//    pad columns zero), so ldmatrix reads them without bank conflicts;
//    the claimed entries are listed as above.
//  - The KW warps of an M tile merge their (m, l, O) in kw order through
//    shared memory. With one split the last writes the output; with more,
//    each split writes (acc, m, l) and paged_group_combine_kernel merges
//    the splits in split order, one warp a (row, head): its lanes read the
//    splits' (m, l) side by side and skip the splits with no valid slot.
#include "common.cuh"

#include <type_traits>

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

// ------------------------------------------------------- group route ----

constexpr int kGroupMaxG = 128;             // M tiles a block at most: 8
constexpr int kGroupStages = 4;             // its page ring: 3 in flight
constexpr int kGroupChunk = 2;              // 16-slot groups a ring stage
constexpr int kRouteLanes = 0, kRouteGroup = 1;

// The k-steps of 16 columns the group kernel is instantiated for; hd is
// rounded up to the next (pad columns zero).
__host__ __device__ inline int group_ksteps(int hd) {
  const int n = (hd + 15) / 16;
  return n <= 2 ? 2 : n <= 4 ? 4 : n <= 5 ? 5 : n <= 6 ? 6 : n <= 8 ? 8
       : n <= 12 ? 12 : 16;
}

// Warps a block at most: 16, or 8 where the O fragments of hd past 80
// (8 NK floats a thread) would leave too few of the 128 registers a
// thread of a 512-thread block has (NK 6 spilled there).
__host__ __device__ constexpr int group_max_warps(int NK) {
  return NK <= 5 ? 16 : 8;
}

// The group kernel's layout: MT M tiles, KS 16-slot groups a ring stage
// (a page, or a chunk of KS * 16 slots of a larger page, so the ring's
// shared memory does not grow with the page size), KW warps an M tile
// (each takes the slot groups kw, kw + KW, ...), HDS elements a
// shared-memory row.
struct GroupLayout {
  int NK, MT, KS, KW, HDS;
};

inline GroupLayout group_layout(int G, int ps, int hd) {
  GroupLayout g;
  g.NK = group_ksteps(hd);
  g.MT = (G + 15) / 16;
  g.KS = (ps + 15) / 16 < kGroupChunk ? (ps + 15) / 16 : kGroupChunk;
  const int room = group_max_warps(g.NK) / g.MT;
  g.KW = g.KS < room ? g.KS : (room > 1 ? room : 1);
  g.HDS = g.NK * 16 + 8;
  return g;
}

template <int NK>
__global__ void __launch_bounds__(32 * group_max_warps(NK))
    paged_group_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k_pages,
                       const __nv_bfloat16* __restrict__ v_pages,
                       const int* __restrict__ pos_pages,
                       const int* __restrict__ block_table,
                       const int* __restrict__ pos,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ ws, int H, int KV, int P, int ps,
                       int hd, int W, int nsplit, int KS, int KW,
                       float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int HDP = NK * 16, HDS = HDP + 8;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV, MT = (G + 15) / 16, RS = KS * 16;
  const int nch = (ps + RS - 1) / RS;       // ring stages a page
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / 32, lane = tid % 32;
  const int mt = warp / KW, kw = warp % KW;
  const int r0 = lane / 4, c2 = 2 * (lane % 4);   // fragment row / column
  const bool vec = hd % rt::kVec == 0;
  const int stage = 2 * RS * HDS;           // elements of a ring stage

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);            // MT*16 x HDS
  bf16* ring = qs + (size_t)MT * 16 * HDS;        // kGroupStages x (K, V)
  int* kpos_s = reinterpret_cast<int*>(ring + (size_t)kGroupStages * stage);
  __shared__ int plist[kList];
  __shared__ int pcount;

  const int pos_b = pos[b];
  float m[2] = {rt::kNegInf, rt::kNegInf}, l[2] = {0.f, 0.f};
  float o[2 * NK][4];
#pragma unroll
  for (int n = 0; n < 2 * NK; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  bool staged = false, any = false;

  // ring item j: chunk j % nch (slots c0 .. c0 + clen) of the j / nch-th
  // listed page
  auto load = [&](int st, int j) {
    const int page = plist[j / nch], c0 = (j % nch) * RS;
    const int clen = min(RS, ps - c0);
    const size_t base = (((size_t)page * KV + kvh) * ps + c0) * hd;
    const int n = clen * hd;                // elements of the chunk's K
    bf16* ks = ring + (size_t)st * stage;
    bf16* vs = ks + RS * HDS;
    if (vec) {
      const int per = hd / rt::kVec;
      for (int i = tid; i < n / rt::kVec; i += nthr) {
        const int si = (i / per) * HDS + (i % per) * rt::kVec;
        rt::cp_async16(ks + si, k_pages + base + (size_t)i * rt::kVec, true);
        rt::cp_async16(vs + si, v_pages + base + (size_t)i * rt::kVec, true);
      }
    } else {
      // the stage was consumed before the __syncthreads() that precedes
      // this copy, so plain stores may land in it at once
      for (int i = tid; i < n; i += nthr) {
        const int si = (i / hd) * HDS + i % hd;
        ks[si] = k_pages[base + i];
        vs[si] = v_pages[base + i];
      }
    }
    // a stage's rows past the chunk (past ps, or past a short last
    // chunk, which keep what an earlier chunk left) read as empty slots
    for (int i = tid; i < RS; i += nthr) {
      if (i < clen)
        rt::cp_async4(kpos_s + st * RS + i,
                      pos_pages + (size_t)page * ps + c0 + i);
      else
        kpos_s[st * RS + i] = -1;
    }
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
    const int n = pcount * nch;             // ring items of this window
#pragma unroll
    for (int st = 0; st < kGroupStages - 1; ++st) {
      if (st < n) load(st, st);
      rt::cp_async_commit();
    }
    if (n > 0 && !staged) {
      // once a block, while the first pages are in flight: the group's
      // queries in 8-column chunks (rows past G and columns past hd zero),
      // and zeros in the ring rows' columns hd .. HDP and in its rows past
      // ps (a page smaller than a stage), which no copy writes
      const bf16* qg = q + ((size_t)b * H + (size_t)kvh * G) * hd;
      for (int i = tid; i < MT * 16 * (HDP / 8); i += nthr) {
        const int g = i / (HDP / 8), d0 = (i % (HDP / 8)) * 8;
        uint4 chunk = make_uint4(0u, 0u, 0u, 0u);
        if (g < G && vec && d0 < hd) {
          chunk = *reinterpret_cast<const uint4*>(qg + (size_t)g * hd + d0);
        } else if (g < G) {
          unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (d0 + j < hd)
              w[j / 2] |= (unsigned)__bfloat16_as_ushort(
                              qg[(size_t)g * hd + d0 + j]) << (16 * (j % 2));
          chunk = make_uint4(w[0], w[1], w[2], w[3]);
        }
        *reinterpret_cast<uint4*>(qs + g * HDS + d0) = chunk;
      }
      const int padc = HDP - hd, padr = RS > ps ? RS - ps : 0;
      for (int i = tid; i < kGroupStages * 2 * RS * padc; i += nthr)
        ring[(i / padc) * HDS + hd + i % padc] = rt::from_f32<bf16>(0.f);
      for (int i = tid; i < kGroupStages * 2 * padr * HDP; i += nthr) {
        const int half = i / (padr * HDP), r = ps + (i / HDP) % padr;
        ring[((size_t)half * RS + r) * HDS + i % HDP] =
            rt::from_f32<bf16>(0.f);
      }
      staged = any = true;
    }
    for (int j = 0; j < n; ++j) {
      rt::cp_async_wait<kGroupStages - 2>();
      __syncthreads();                      // page j landed; j - 1 consumed
      const int nxt = j + kGroupStages - 1;
      if (nxt < n) load(nxt % kGroupStages, nxt);
      rt::cp_async_commit();
      const bf16* ks = ring + (size_t)(j % kGroupStages) * stage;
      const bf16* vs = ks + RS * HDS;
      const int* kp = kpos_s + (j % kGroupStages) * RS;
      for (int sg = kw; sg < KS; sg += KW) {
        // this thread's 4 slots: the fragment columns c2, c2 + 1 of the
        // group's two 8-slot halves
        bool ok[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = sg * 16 + (e >> 1) * 8 + c2 + (e & 1);
          ok[e] = kp[t] >= 0 && kp[t] <= pos_b;
        }
        float sc[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) sc[h][0] = sc[h][1] = sc[h][2] =
            sc[h][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          unsigned af[4], bk[4];
          rt::ldsm_x4(af, qs + (mt * 16 + (lane & 15)) * HDS + kk * 16 +
                              (lane >> 4) * 8);
          rt::ldsm_x4(bk, ks + (sg * 16 + (lane & 7) + (lane >> 4) * 8) *
                                   HDS + kk * 16 + ((lane >> 3) & 1) * 8);
          rt::mma_bf16(sc[0], af, bk[0], bk[1]);
          rt::mma_bf16(sc[1], af, bk[2], bk[3]);
        }
        // sc[h][e]: row r0 (e < 2) or r0 + 8, slot sg*16 + 8h + c2 + (e&1)
        float pm[2] = {rt::kNegInf, rt::kNegInf};
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool v = ok[2 * h + (e & 1)];
            sc[h][e] = v ? sc[h][e] * scale : rt::kNegInf;
            pm[e >> 1] = fmaxf(pm[e >> 1], sc[h][e]);
          }
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          pm[r] = fmaxf(pm[r], __shfl_xor_sync(0xffffffffu, pm[r], 1));
          pm[r] = fmaxf(pm[r], __shfl_xor_sync(0xffffffffu, pm[r], 2));
          const float m_new = fmaxf(m[r], pm[r]);
          corr[r] = expf(m[r] - m_new);
          m[r] = m_new;
          l[r] *= corr[r];
        }
        unsigned phi[4], plo[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // masked slots add nothing
            p[e] = ok[2 * h + (e & 1)] ? expf(sc[h][e] - m[e >> 1]) : 0.f;
            l[e >> 1] += p[e];
          }
          // A fragment of P (16 heads x 16 slots): a0/a1 the first 8
          // slots of rows r0 / r0 + 8, a2/a3 the second 8
          phi[2 * h] = rt::pack_bf16(p[0], p[1]);
          phi[2 * h + 1] = rt::pack_bf16(p[2], p[3]);
          const __nv_bfloat162 h01 =
              *reinterpret_cast<const __nv_bfloat162*>(&phi[2 * h]);
          const __nv_bfloat162 h23 =
              *reinterpret_cast<const __nv_bfloat162*>(&phi[2 * h + 1]);
          const float2 f01 = __bfloat1622float2(h01);
          const float2 f23 = __bfloat1622float2(h23);
          plo[2 * h] = rt::pack_bf16(p[0] - f01.x, p[1] - f01.y);
          plo[2 * h + 1] = rt::pack_bf16(p[2] - f23.x, p[3] - f23.y);
        }
        const unsigned a_hi[4] = {phi[0], phi[1], phi[2], phi[3]};
        const unsigned a_lo[4] = {plo[0], plo[1], plo[2], plo[3]};
        // V fragments of the masked slots zeroed: b0 holds slots c2, c2 + 1
        // of the first half, b1 of the second
        const unsigned mlo = (ok[0] ? 0xffffu : 0u) | (ok[1] ? 0xffff0000u : 0u);
        const unsigned mhi = (ok[2] ? 0xffffu : 0u) | (ok[3] ? 0xffff0000u : 0u);
#pragma unroll
        for (int n = 0; n < 2 * NK; ++n) {
          o[n][0] *= corr[0];
          o[n][1] *= corr[0];
          o[n][2] *= corr[1];
          o[n][3] *= corr[1];
        }
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          unsigned bv[4];
          rt::ldsm_x4_trans(bv, vs + (sg * 16 + (lane & 7) +
                                      ((lane >> 3) & 1) * 8) * HDS +
                                    kk * 16 + (lane >> 4) * 8);
          bv[0] &= mlo;
          bv[1] &= mhi;
          bv[2] &= mlo;
          bv[3] &= mhi;
          rt::mma_bf16(o[2 * kk], a_hi, bv[0], bv[1]);
          rt::mma_bf16(o[2 * kk + 1], a_hi, bv[2], bv[3]);
          rt::mma_bf16(o[2 * kk], a_lo, bv[0], bv[1]);
          rt::mma_bf16(o[2 * kk + 1], a_lo, bv[2], bv[3]);
        }
      }
    }
    rt::cp_async_wait<0>();
    __syncthreads();                        // ring and list free
  }

  float* wacc = ws;                                       // (B, H, nsplit, hd)
  float* wml = ws + (size_t)gridDim.z * H * nsplit * hd;  // (B, H, nsplit, 2)
  if (!any) {
    // no claimed page in this split: zeros, or acc 0 and (m, l) =
    // (NEG_INF, 0), which the combine weighs 0
    if (nsplit == 1) {
      for (int i = tid; i < G * hd; i += nthr)
        out[((size_t)b * H + (size_t)kvh * G) * hd + i] =
            rt::from_f32<bf16>(0.f);
    } else {
      const size_t h0 = (size_t)b * H + (size_t)kvh * G;
      for (int i = tid; i < G * hd; i += nthr)
        wacc[((h0 + i / hd) * nsplit + split) * hd + i % hd] = 0.f;
      for (int g = tid; g < G; g += nthr) {
        float* ml = wml + ((h0 + g) * nsplit + split) * 2;
        ml[0] = rt::kNegInf;
        ml[1] = 0.f;
      }
    }
    return;
  }

  // a row's l over its quad (fixed xor order)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // merge the KW warps of each M tile in kw order (shared memory reused)
  float* obuf = reinterpret_cast<float*>(smem_raw);       // MT*16 x HDP
  float* mbuf = obuf + (size_t)MT * 16 * HDP;             // warps x 16
  float* lbuf = mbuf + (size_t)(nthr / 32) * 16;          // warps x 16
  float L[2] = {l[0], l[1]};
  if (KW > 1) {
    if (lane % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mbuf[warp * 16 + r0 + 8 * r] = m[r];
        lbuf[warp * 16 + r0 + 8 * r] = l[r];
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float M = rt::kNegInf;
      for (int w = 0; w < KW; ++w)
        M = fmaxf(M, mbuf[(mt * KW + w) * 16 + r0 + 8 * r]);
      L[r] = 0.f;
      for (int w = 0; w < KW; ++w)
        L[r] += lbuf[(mt * KW + w) * 16 + r0 + 8 * r] *
                expf(mbuf[(mt * KW + w) * 16 + r0 + 8 * r] - M);
      const float f = expf(m[r] - M);
#pragma unroll
      for (int n = 0; n < 2 * NK; ++n) {
        o[n][2 * r] *= f;
        o[n][2 * r + 1] *= f;
      }
      m[r] = M;
    }
    for (int w = 0; w < KW - 1; ++w) {
      if (kw == w) {
#pragma unroll
        for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float* dst = obuf + (size_t)(mt * 16 + r0 + 8 * (e >> 1)) * HDP +
                         n * 8 + c2 + (e & 1);
            *dst = w == 0 ? o[n][e] : *dst + o[n][e];
          }
      }
      __syncthreads();
    }
    if (kw != KW - 1) return;
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[n][e] += obuf[(size_t)(mt * 16 + r0 + 8 * (e >> 1)) * HDP + n * 8 +
                        c2 + (e & 1)];
  }
  // rows r0 and r0 + 8 of M tile mt, columns n * 8 + c2 (+ 1) below hd
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int g = mt * 16 + r0 + 8 * r;
    if (g >= G) continue;
    const size_t h = (size_t)b * H + (size_t)kvh * G + g;
    if (nsplit == 1) {
      const float inv = 1.f / fmaxf(L[r], 1e-30f);
#pragma unroll
      for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = n * 8 + c2 + e;
          if (d < hd) out[h * hd + d] = rt::from_f32<bf16>(o[n][2 * r + e] * inv);
        }
    } else {
      float* acc = wacc + (h * nsplit + split) * hd;
#pragma unroll
      for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = n * 8 + c2 + e;
          if (d < hd) acc[d] = o[n][2 * r + e];
        }
      if (lane % 4 == 0) {
        wml[(h * nsplit + split) * 2] = m[r];
        wml[(h * nsplit + split) * 2 + 1] = L[r];
      }
    }
  }
}

// out[b, h, :] from the splits' (acc, m, l) of paged_group_kernel, one
// warp a (row, head): its lanes read the splits' (m, l) side by side, the
// max and l's sum reduce over the warp in a fixed xor order, and the
// splits' acc rows (each lane columns lane, lane + 32, ...) add in split
// order, kUnroll splits' loads in flight at once; a split with no valid
// slot (l = 0) weighs 0 and is not read.
template <typename T>
__global__ void __launch_bounds__(128) paged_group_combine_kernel(
    const float* __restrict__ ws, T* __restrict__ out, int BH, int hd,
    int nsplit) {
  constexpr int kCols = 256 / 32;           // columns a lane, hd <= 256
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.x * 4 + threadIdx.x / 32;
  if (bh >= BH) return;
  const float* acc = ws + (size_t)bh * nsplit * hd;
  const float* ml = ws + (size_t)BH * nsplit * hd + (size_t)bh * nsplit * 2;
  float M = rt::kNegInf;
  for (int k = lane; k < nsplit; k += 32) M = fmaxf(M, ml[2 * k]);
  for (int off = 16; off > 0; off >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  constexpr int kUnroll = 8;
  float lsum = 0.f, o[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) o[j] = 0.f;
  for (int k0 = 0; k0 < nsplit; k0 += 32) {
    const int k = k0 + lane;
    const float mk = k < nsplit ? ml[2 * k] : rt::kNegInf;
    const float lk = k < nsplit ? ml[2 * k + 1] : 0.f;
    const float w = lk > 0.f ? expf(mk - M) : 0.f;
    lsum += lk * w;
    const int nk = min(32, nsplit - k0);
    for (int i0 = 0; i0 < nk; i0 += kUnroll) {
      float wi[kUnroll], a[kUnroll][kCols];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        wi[u] = i0 + u < nk ? __shfl_sync(0xffffffffu, w, (i0 + u) & 31)
                            : 0.f;
      // warp-uniform predicates: a split of weight 0 is not read
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          a[u][j] = wi[u] != 0.f && lane + 32 * j < hd
                        ? acc[(size_t)(k0 + i0 + u) * hd + lane + 32 * j]
                        : 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < kCols; ++j) o[j] += wi[u] * a[u][j];
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
  const float inv = 1.f / fmaxf(lsum, 1e-30f);
#pragma unroll
  for (int j = 0; j < kCols; ++j)
    if (lane + 32 * j < hd)
      out[(size_t)bh * hd + lane + 32 * j] = rt::from_f32<T>(o[j] * inv);
}

// Which kernel takes (G, hd, dtype): the group kernel for bf16 at GQA
// groups 2 to kGroupMaxG, the lane kernel otherwise (MHA, f32, groups past
// kGroupMaxG). Shapes alone decide; kernels/paged.py: route is its copy.
__host__ __device__ inline int paged_route(int G, int hd, int dtype) {
  return dtype == rt::kBF16 && G >= 2 && G <= kGroupMaxG && hd >= 1 &&
                 hd <= kMaxHeadDim
             ? kRouteGroup
             : kRouteLanes;
}

const void* group_kernel(int NK) {
  switch (NK) {
    case 2: return (const void*)paged_group_kernel<2>;
    case 4: return (const void*)paged_group_kernel<4>;
    case 5: return (const void*)paged_group_kernel<5>;
    case 6: return (const void*)paged_group_kernel<6>;
    case 8: return (const void*)paged_group_kernel<8>;
    case 12: return (const void*)paged_group_kernel<12>;
    default: return (const void*)paged_group_kernel<16>;
  }
}

// The attention kernel's launch, and the combine's (used with nsplit > 1),
// with the lane kernel's head layout and slot groups (TG), or the group
// kernel's layout.
struct PagedPlan {
  rt::Launch attn, combine;
  int route;
  Heads hs;
  int TG;
  GroupLayout gl;
};

template <typename T>
PagedPlan paged_plan(int B, int H, int KV, int ps, int hd, int nsplit) {
  const int G = H / KV;
  PagedPlan p;
  p.route = paged_route(G, hd, std::is_same<T, float>::value ? rt::kF32
                                                             : rt::kBF16);
  if (p.route == kRouteGroup) {
    p.gl = group_layout(G, ps, hd);
    const GroupLayout& g = p.gl;
    const size_t rows = (size_t)g.MT * 16;
    const size_t ring = sizeof(T) * (rows * g.HDS + (size_t)kGroupStages * 2 *
                                                     g.KS * 16 * g.HDS) +
                        sizeof(int) * (size_t)kGroupStages * g.KS * 16;
    const int warps = g.MT * g.KW;
    const size_t merge = g.KW > 1 ? sizeof(float) * (rows * g.NK * 16 +
                                                     2 * (size_t)warps * 16)
                                  : 0;
    // splits fastest: a long row's blocks start in the first wave,
    // beside the short rows' (mostly empty) ones
    p.attn = {group_kernel(g.NK), dim3(nsplit, KV, B), 32 * warps,
              ring > merge ? ring : merge};
    p.combine = {(const void*)paged_group_combine_kernel<T>,
                 dim3((B * H + 3) / 4), 128, 0};
    return p;
  }
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
  float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  if (pl.route == kRouteGroup) {
    int KS = pl.gl.KS, KW = pl.gl.KW;
    void* args[] = {&q, &k, &v, &pos_pages, &block_table, &pos, &out, &ws,
                    &H, &KV, &P, &ps, &hd, &W, &nsplit, &KS, &KW, &scale};
    const cudaError_t e = rt::launch(pl.attn, args, stream);
    if (e != cudaSuccess || nsplit == 1) return e;
    int BH = B * H;
    void* cargs[] = {&ws, &out, &BH, &hd, &nsplit};
    return rt::launch(pl.combine, cargs, stream);
  }
  int L = pl.hs.L, TG = pl.TG, Gb = pl.hs.Gb, ntile = pl.hs.ntile;
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

// The group tiles the lane kernel cuts a KV head's G query heads into at
// head dim hd (its grid's y axis is KV heads x tiles), or 0 where the
// kernel refuses. The group route takes no tiles.
extern "C" int rt_paged_attention_tiles(int G, int hd) {
  return rt_paged_attention_fits(G, hd) ? heads_of(G, hd).ntile : 0;
}

// The kernel rt_paged_attention launches for GQA group G at head dim hd
// in dtype: 0 the lane kernel, 1 the group kernel; -1 where it refuses.
extern "C" int rt_paged_attention_route(int G, int hd, int dtype) {
  if (!rt_paged_attention_fits(G, hd) ||
      (dtype != rt::kBF16 && dtype != rt::kF32))
    return -1;
  return paged_route(G, hd, dtype);
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
// B * H * nsplit * (hd + 2) floats (each split's acc, m and l of each
// query head), unused (may be null) when nsplit == 1.
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
