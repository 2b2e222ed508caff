// The card's limits the kernels' launches are checked against
// (repro_torch/analysis/kernel_verify.py: the footprint check).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "tma.cuh"

// out[0 : 6]: shared memory a block may opt in to, shared memory an SM,
// registers an SM, registers a block, threads an SM, SMs.
extern "C" int rt_device_limits(int device, long long* out) {
  const cudaDeviceAttr attrs[6] = {
      cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrMaxRegistersPerMultiprocessor,
      cudaDevAttrMaxRegistersPerBlock,
      cudaDevAttrMaxThreadsPerMultiProcessor,
      cudaDevAttrMultiProcessorCount};
  for (int i = 0; i < 6; ++i) {
    int v = 0;
    const cudaError_t e = cudaDeviceGetAttribute(&v, attrs[i], device);
    if (e != cudaSuccess) return (int)e;
    out[i] = v;
  }
  return 0;
}

// ------------------------------------------------ measurement helpers ----
// Used by kernel_ab.py and chip_smoke.py, never by the model's path.

namespace {
// nothing, or (sync) two barriers of its cluster, as a cluster's
// reduction takes them
__global__ void empty_kernel(int sync) {
  if (sync) {
    cooperative_groups::this_cluster().sync();
    cooperative_groups::this_cluster().sync();
  }
}
}  // namespace

// One launch of an empty kernel of `blocks` blocks of 128 threads on
// `stream`, in clusters of `cluster` blocks (1: none; blocks a multiple of
// it) that pass two cluster barriers, with programmatic stream
// serialization where `pdl` is 1: the fixed cost of a launch in a
// harness, and a probe of whether a capture keeps the attribute.
extern "C" int rt_empty(int pdl, int blocks, int cluster, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(128);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = cluster;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = pdl ? attr : attr + 1;
  cfg.numAttrs = (pdl ? 1 : 0) + (cluster > 1 ? 1 : 0);
  int sync = cluster > 1;
  void* args[] = {&sync};
  const cudaError_t e =
      cudaLaunchKernelExC(&cfg, (const void*)empty_kernel, args);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

namespace {
constexpr int kProbeRows = 64, kProbeCols = 128;   // a tile: 16 KB of bf16
constexpr int kProbeBytes = kProbeRows * kProbeCols * 2;

// Writes every (64 x 128) tile of a (rows, cols) bf16 matrix from shared
// memory, each block a contiguous run of the tiles in column-block order
// (the walk of the persistent expand), through two staged tiles: by TMA
// bulk stores (kTma; a stage is written again once its store has read it)
// or by 16-byte st.global a thread. What a tile holds is the block's id.
template <bool kTma>
__global__ void __launch_bounds__(128) store_probe_kernel(
    const __grid_constant__ CUtensorMap map, __nv_bfloat16* out, int rows,
    int cols) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* st =
      smem_raw + ((1024 - (rt::smem_u32(smem_raw) & 1023)) & 1023);
  const int t = threadIdx.x;
  for (int i = t; i < 2 * kProbeBytes / 16; i += 128)
    reinterpret_cast<uint4*>(st)[i] = make_uint4(blockIdx.x, i, 0u, 0u);
  rt::fence_proxy_async();
  __syncthreads();
  const int rt_n = (rows + kProbeRows - 1) / kProbeRows;
  const long long tiles =
      (long long)rt_n * ((cols + kProbeCols - 1) / kProbeCols);
  const int w0 = (int)(tiles * blockIdx.x / gridDim.x);
  const int w1 = (int)(tiles * (blockIdx.x + 1) / gridDim.x);
  for (int w = w0; w < w1; ++w) {
    const int row0 = w % rt_n * kProbeRows, n0 = w / rt_n * kProbeCols;
    const unsigned char* src = st + (w & 1) * kProbeBytes;
    if constexpr (kTma) {
      if (t == 0) {
        rt::bulk_wait_read<1>();
        for (int x = 0; x < kProbeCols / 64; ++x)
          rt::tma_store_4d(&map, src + x * kProbeRows * 128, n0 + 64 * x,
                           row0, 0, 0);
        rt::bulk_commit();
      }
    } else {
      for (int i = t; i < kProbeBytes / 16; i += 128) {
        const int r = i / (kProbeCols / 8), c = i % (kProbeCols / 8) * 8;
        if (row0 + r < rows && n0 + c < cols)
          *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * cols + n0 +
                                    c) =
              reinterpret_cast<const uint4*>(src)[i];
      }
    }
  }
  if (kTma && t == 0) rt::bulk_wait<0>();
}
}  // namespace

// One launch of the store probe on `stream`: `blocks` blocks write the
// (rows, cols) bf16 matrix `out` (cols a multiple of 8, out 16-byte
// aligned) by TMA bulk stores (tma 1) or 16-byte st.global (tma 0): how
// fast the card takes a stream of writes from shared memory, as the
// expand's epilogue issues them.
extern "C" int rt_store_probe(void* out, int rows, int cols, int tma,
                              int blocks, void* stream) {
  if (rows <= 0 || cols <= 0 || cols % 8 != 0 || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map = {};
  if (tma) {
    if (rt::encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)rows, 1, 1};
    const cuuint64_t strides[3] = {dims[0] * 2, dims[0] * dims[1] * 2,
                                   dims[0] * dims[1] * 2};
    const cuuint32_t box[4] = {64, kProbeRows, 1, 1};
    const cuuint32_t estr[4] = {1, 1, 1, 1};
    if (rt::encode_tiled()(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, out,
                           dims, strides, box, estr,
                           CU_TENSOR_MAP_INTERLEAVE_NONE,
                           CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  const void* fn = tma ? (const void*)store_probe_kernel<true>
                       : (const void*)store_probe_kernel<false>;
  rt::Launch l{fn, dim3(blocks), 128, 2 * kProbeBytes + 1024};
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  void* args[] = {&map, &o, &rows, &cols};
  return (int)rt::launch(l, args, static_cast<cudaStream_t>(stream));
}

namespace {
constexpr int kLoadBox = 64 * 128;                 // 64 rows x 128 bytes
constexpr int kLoadMaxStages = 24;

// Reads every (64 x 64) box of a (rows, cols) bf16 matrix into shared
// memory by TMA and nothing else, each block a contiguous run of the boxes
// in row-tile order (a row tile's boxes along its columns, as a row-tile
// shrink block walks d), through a ring of `stages` boxes (an mbarrier
// each): one thread issues a box as soon as its stage's last box has
// landed, so `stages` boxes are in flight a block.
__global__ void __launch_bounds__(32) load_probe_kernel(
    const __grid_constant__ CUtensorMap map, int rows, int cols,
    int stages) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (rt::smem_u32(smem_raw) & 1023)) & 1023);
  __shared__ __align__(8) uint64_t full[kLoadMaxStages];
  if (threadIdx.x != 0) return;
  for (int i = 0; i < stages; ++i) rt::mbar_init(&full[i], 1);
  rt::fence_barrier_init();
  const int cb = (cols + 63) / 64;
  const long long boxes = (long long)((rows + 63) / 64) * cb;
  const int w0 = (int)(boxes * blockIdx.x / gridDim.x);
  const int w1 = (int)(boxes * (blockIdx.x + 1) / gridDim.x);
  for (int w = w0; w < w1; ++w) {
    const int i = w - w0, b = i % stages;
    if (i >= stages) rt::mbar_wait(&full[b], (i / stages - 1) & 1);
    rt::mbar_expect_tx(&full[b], kLoadBox);
    rt::tma_load_4d(ring + b * kLoadBox, &map, &full[b], w % cb * 64,
                    w / cb * 64, 0, 0);
  }
  for (int i = max(w0, w1 - stages) - w0; i < w1 - w0; ++i)
    rt::mbar_wait(&full[i % stages], (i / stages) & 1);
}
}  // namespace

// One launch of the load probe on `stream`: `blocks` blocks read the
// (rows, cols) bf16 matrix `x` (cols a multiple of 8, x 16-byte aligned)
// into shared memory by TMA, `stages` (1-24) boxes of 8 KB in flight a
// block: how fast the card feeds a stream of TMA loads, as the row-tile
// shrink issues them.
extern "C" int rt_load_probe(const void* x, int rows, int cols, int blocks,
                             int stages, void* stream) {
  if (rows <= 0 || cols <= 0 || cols % 8 != 0 || blocks <= 0 ||
      stages < 1 || stages > kLoadMaxStages)
    return (int)cudaErrorInvalidValue;
  if (rt::encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map = {};
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)rows, 1, 1};
  const cuuint64_t strides[3] = {dims[0] * 2, dims[0] * dims[1] * 2,
                                 dims[0] * dims[1] * 2};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  if (rt::encode_tiled()(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(x), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  rt::Launch l{(const void*)load_probe_kernel, dim3(blocks), 32,
               (size_t)stages * kLoadBox + 1024};
  void* args[] = {&map, &rows, &cols, &stages};
  return (int)rt::launch(l, args, static_cast<cudaStream_t>(stream));
}

// out[0 : 3]: the nodes of a CUDA graph (a cudaGraph_t, e.g. a captured
// torch.cuda.CUDAGraph(keep_graph=True)'s raw_cuda_graph()), its edges,
// and the edges among them that are programmatic (a kernel launched with
// programmatic stream serialization, captured as such). cudaErrorNot-
// Supported where the toolkit has no edge data (before CUDA 12.3).
extern "C" int rt_graph_edges(void* graph, long long* out) {
  const cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t nodes = 0;
  cudaError_t e = cudaGraphGetNodes(g, nullptr, &nodes);
  if (e != cudaSuccess) return (int)e;
#if CUDART_VERSION >= 12030
  size_t n = 0;
#if CUDART_VERSION >= 13000
  e = cudaGraphGetEdges(g, nullptr, nullptr, nullptr, &n);
#else
  e = cudaGraphGetEdges_v2(g, nullptr, nullptr, nullptr, &n);
#endif
  if (e != cudaSuccess) return (int)e;
  cudaGraphNode_t* from = new cudaGraphNode_t[n + 1];
  cudaGraphNode_t* to = new cudaGraphNode_t[n + 1];
  cudaGraphEdgeData* data = new cudaGraphEdgeData[n + 1];
#if CUDART_VERSION >= 13000
  e = cudaGraphGetEdges(g, from, to, data, &n);
#else
  e = cudaGraphGetEdges_v2(g, from, to, data, &n);
#endif
  long long prog = 0;
  for (size_t i = 0; e == cudaSuccess && i < n; ++i)
    prog += data[i].type == cudaGraphDependencyTypeProgrammatic;
  delete[] from;
  delete[] to;
  delete[] data;
  if (e != cudaSuccess) return (int)e;
  out[0] = (long long)nodes;
  out[1] = (long long)n;
  out[2] = prog;
  return 0;
#else
  return (int)cudaErrorNotSupported;
#endif
}
