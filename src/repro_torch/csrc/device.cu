// The card's limits the kernels' launches are checked against
// (repro_torch/analysis/kernel_verify.py: the footprint check).
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
