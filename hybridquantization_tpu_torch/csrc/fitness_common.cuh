// What the B2 kernels share (fused_fitness.cu, band_fitness.cu): the
// half-sample mirror by index, the 4-byte cp.async they stage with, the
// fixed-order block sum of per-pixel Delta-E into a partial, and the
// double-precision reduce of a member's partials. Each including source
// gets its own copy (internal linkage).
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kReduceThreads = 256;

__device__ __forceinline__ int mirror(int i, int n) {
  return i < 0 ? -i - 1 : (i >= n ? 2 * n - i - 1 : i);
}

// mirror, then clamped: indices more than n beyond a border only feed
// outputs that are never summed
__device__ __forceinline__ int mirror_clamped(int i, int n) {
  return min(max(mirror(i, n), 0), n - 1);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Fixed-order block reduction of `v` into partials[index]: warp tree, then
// warp 0 over the warp sums.
__device__ __forceinline__ void block_sum(float v, float* warp_sums, float* out) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    float s = lane < n_warps ? warp_sums[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) *out = s;
  }
}

// One block per member: its n partials summed in double, in a fixed order,
// so that a fitness value is the same from run to run (no float atomics).
__global__ void __launch_bounds__(kReduceThreads)
reduce_kernel(const float* __restrict__ partials, int n, float* __restrict__ sums) {
  __shared__ double s[kReduceThreads];
  const float* src = partials + (size_t)blockIdx.x * n;
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kReduceThreads) acc += src[i];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) sums[blockIdx.x] = (float)s[0];
}

}  // namespace
