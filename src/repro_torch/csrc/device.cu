// The card's limits the kernels' launches are checked against
// (repro_torch/analysis/kernel_verify.py: the footprint check).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

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
