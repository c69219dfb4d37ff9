// The persistent grids of the probe kernels (probe_kloop.cu, split_assign.cu):
// the wrapper's plan gives an upper bound on the blocks (its work items, or
// its estimate of what fits on the SMs at once); this caps it at what the
// occupancy calculator says fits, so every block is resident and strides
// over the work. The kernels cover every work item for any count of blocks.
#pragma once

#include <cuda_runtime.h>

// Sets the kernel's dynamic shared memory limit and caps *blocks. Returns 0,
// or a CUDA error (cudaErrorInvalidConfiguration where no block fits).
template <class Kernel>
inline int hq_persistent_grid(Kernel kernel, int threads, int smem, int* blocks) {
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (*blocks > per_sm * sms) *blocks = per_sm * sms;
  return 0;
}
