// Shared helpers for the port's CUDA kernels (built for sm_90a by
// repro_torch/kernels/build.py into one shared library with a plain C
// interface, loaded with ctypes).
#pragma once

#include <cmath>
#include <mutex>
#include <unordered_map>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rt {

// dtype codes passed from Python (kernels/build.py: DTYPE_CODE)
enum { kF32 = 0, kBF16 = 1 };

constexpr float kNegInf = -1e30f;   // the reference's NEG_INF

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 8 consecutive elements -> f32, in one 16-byte load (bf16) or two (f32).
// The pointer must be 16-byte aligned (the wrappers check base pointers;
// offsets are multiples of 8 elements).
constexpr int kVec = 8;

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&out)[kVec]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&out)[kVec]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// ------------------------------------------------ PTX helpers (sm_80+) ----

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

// 4 bytes global -> shared (an int of a page's positions)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

// 4 bytes global -> shared, both 4-byte aligned; `pred` false zero-fills
__device__ __forceinline__ void cp_async4z(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0));
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

// Named barrier `id` (1-15; 0 is __syncthreads) over n threads, a
// multiple of 32: sync waits until n threads have arrived (itself
// included), arrive counts this thread and goes on.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Programmatic dependent launch (sm_90). A kernel launched with
// Launch.pdl may start while the kernel before it on the stream is still
// running; grid_dep_wait() returns once that kernel has finished and its
// writes are visible, so every read of what an earlier kernel may have
// written comes after it. grid_dep_launch() lets the next kernel, if it
// was launched with Launch.pdl, start before this one finishes. Both are
// no-ops in a kernel launched without the attribute.
__device__ __forceinline__ void grid_dep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Bring the L2 line that holds `p` into L2 (an ordinary load-unit
// instruction: a bulk prefetch a row goes through the SM's copy engine one
// at a time and cost ~10 ns each on the H100). L2 is the device's point of
// coherence, so a prefetch of data another kernel is still writing cannot
// make a later read stale.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p) : "memory");
}

// ------------------------------------------------------------ launches ----

// One kernel launch: the kernel, its grid, its block, its dynamic shared
// memory, where it is more than 1 the blocks of a cluster it is launched
// with (grid.x a multiple of it), and whether it is launched with
// programmatic stream serialization (`pdl`: see grid_dep_wait). Every
// entry point builds its launches with one function, which serves both the
// launch (`launch`) and its description (`describe`, for the rt_*_info
// entry points): the footprint checks read the launch that runs.
struct Launch {
  const void* fn;
  dim3 grid;
  int threads;
  size_t smem;
  unsigned cluster = 1;
  bool pdl = false;
};

// The kernel's static shared memory (cudaFuncGetAttributes), read once a
// kernel.
inline cudaError_t static_smem(const void* fn, size_t* bytes) {
  static std::mutex mu;
  static std::unordered_map<const void*, size_t> known;
  std::lock_guard<std::mutex> lock(mu);
  auto it = known.find(fn);
  if (it == known.end()) {
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, fn);
    if (e != cudaSuccess) return e;
    it = known.emplace(fn, a.sharedSizeBytes).first;
  }
  *bytes = it->second;
  return cudaSuccess;
}

// Raise the kernel's dynamic shared memory limit where the launch's
// dynamic memory and the kernel's static memory pass the default 48 KB.
inline cudaError_t prepare(const Launch& l) {
  size_t fixed = 0;
  const cudaError_t e = static_smem(l.fn, &fixed);
  if (e != cudaSuccess) return e;
  if (l.smem + fixed <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      l.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
}

// The launch's configuration for cudaLaunchKernelExC: a cluster of
// l.cluster blocks along x where it is more than 1, programmatic stream
// serialization with l.pdl; `attr` (two entries) must outlive its use.
inline cudaLaunchConfig_t cluster_config(const Launch& l,
                                         cudaLaunchAttribute* attr,
                                         cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = l.grid;
  cfg.blockDim = dim3(l.threads);
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = st;
  cfg.attrs = attr;
  if (l.cluster > 1) {
    attr[cfg.numAttrs].id = cudaLaunchAttributeClusterDimension;
    attr[cfg.numAttrs].val.clusterDim.x = l.cluster;
    attr[cfg.numAttrs].val.clusterDim.y = 1;
    attr[cfg.numAttrs].val.clusterDim.z = 1;
    ++cfg.numAttrs;
  }
  if (l.pdl) {
    attr[cfg.numAttrs].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[cfg.numAttrs].val.programmaticStreamSerializationAllowed = 1;
    ++cfg.numAttrs;
  }
  return cfg;
}

// `args`: a pointer to each of the kernel's arguments, in order.
inline cudaError_t launch(const Launch& l, void** args, cudaStream_t st) {
  cudaError_t e = prepare(l);
  if (e != cudaSuccess) return e;
  if (l.cluster > 1 || l.pdl) {
    cudaLaunchAttribute attr[2];
    const cudaLaunchConfig_t cfg = cluster_config(l, attr, st);
    e = cudaLaunchKernelExC(&cfg, l.fn, args);
  } else {
    e = cudaLaunchKernel(l.fn, l.grid, dim3(l.threads), args, l.smem, st);
  }
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

// The current device's SMs (cudaDevAttrMultiProcessorCount), read once a
// device; 0 where the query fails.
inline int sm_count() {
  static std::mutex mu;
  static std::unordered_map<int, int> known;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  std::lock_guard<std::mutex> lock(mu);
  auto it = known.find(dev);
  if (it == known.end()) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      return 0;
    it = known.emplace(dev, n).first;
  }
  return it->second;
}

constexpr int kInfoFields = 12;

// kInfoFields numbers of launch `l`: grid x, y, z, threads, dynamic shared
// memory, registers a thread, static shared memory, local memory a thread
// (bytes), the kernel's most threads a block, resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor; minus its error code
// where the query fails), the blocks of a cluster (the launch's, or the
// kernel's compiled __cluster_dims__; 1: none) and, for clusters of more
// than one block, the clusters the card holds at once
// (cudaOccupancyMaxActiveClusters; minus its error code where the query
// fails; 0 where no cluster fits), else 0.
inline cudaError_t describe(const Launch& l, long long* out) {
  cudaError_t e = prepare(l);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, l.fn);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  const cudaError_t oe = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, l.fn, l.threads, l.smem);
  cudaGetLastError();   // a failed query must not surface at a later launch
  const long long compiled = (long long)a.requiredClusterWidth *
                             a.requiredClusterHeight *
                             a.requiredClusterDepth;
  int clusters = 0;
  cudaError_t ce = cudaSuccess;
  if (l.cluster > 1 || compiled > 1) {
    Launch lc = l;
    lc.pdl = false;
    cudaLaunchAttribute attr[2];
    const cudaLaunchConfig_t cfg = cluster_config(lc, attr, nullptr);
    ce = cudaOccupancyMaxActiveClusters(&clusters, l.fn, &cfg);
    cudaGetLastError();
  }
  out[0] = l.grid.x;
  out[1] = l.grid.y;
  out[2] = l.grid.z;
  out[3] = l.threads;
  out[4] = (long long)l.smem;
  out[5] = a.numRegs;
  out[6] = (long long)a.sharedSizeBytes;
  out[7] = (long long)a.localSizeBytes;
  out[8] = a.maxThreadsPerBlock;
  out[9] = oe == cudaSuccess ? blocks : -(long long)oe;
  out[10] = l.cluster > 1 ? (long long)l.cluster
                          : (compiled > 1 ? compiled : 1);
  out[11] = ce == cudaSuccess ? clusters : -(long long)ce;
  return cudaSuccess;
}

}  // namespace rt
