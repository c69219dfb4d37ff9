// B3: nearest-palette index of every pixel, for one palette.
//
// Replaces the TPU kernel hybridquantization_tpu/ops/pallas_assign.py
// (_assign_idx_kernel, :314-323; pallas_call in assign_idx, :420), which
// the exact Lloyd polish runs once per step. For every pixel i: the palette
// entry k maximising f_i . c_k - |c_k|^2 / 2 (= nearest in the feature
// space), first index on ties, a NaN score never winning, -1 where no
// score is a number. No counts and no colour gather: the polish sums the
// centroids itself.
//
// What bounds it on the H100: fp32 instruction rate, as for B1. The scan
// costs 3 FMAs, a compare and a select per (pixel, entry): 8.3 M x 256 at
// 4K/K256, against 16 bytes of traffic per pixel (12 in, 4 out). The design:
//  - a thread holds kPix pixels' features in registers, so each shared
//    float4 load of an entry feeds kPix scores; the kPix pixels of a thread
//    lie kThreads apart, so a warp's loads and stores stay contiguous;
//  - the palette is staged in shared memory as (c0, c1, c2, bias) float4
//    tiles of kTileK entries, read by every thread of a warp at the same
//    address (a broadcast), and looped over, so K has no ceiling (the TPU
//    kernel held a (K, block) score tile and needed a fallback above K~32k);
//  - the scan is a strict `>` from -inf in index order, which keeps
//    first-index ties exact and lets no NaN win.
// A tensor-core score tile is left for later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 2;       // pixels per thread
constexpr int kTileK = 1024;  // palette entries per shared tile (16 KB)

__global__ void __launch_bounds__(kThreads)
assign_idx_kernel(const float* __restrict__ feats, const float* __restrict__ pal,
                  int P, int K, int* __restrict__ idx_out) {
  __shared__ float4 tile[kTileK];

  const size_t base = (size_t)blockIdx.x * (kThreads * kPix) + threadIdx.x;
  float f0[kPix], f1[kPix], f2[kPix], best[kPix];
  int bi[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const size_t pix = base + (size_t)i * kThreads;
    const bool active = pix < (size_t)P;
    f0[i] = active ? feats[pix * 3 + 0] : 0.0f;
    f1[i] = active ? feats[pix * 3 + 1] : 0.0f;
    f2[i] = active ? feats[pix * 3 + 2] : 0.0f;
    best[i] = -INFINITY;
    bi[i] = -1;
  }

  for (int k0 = 0; k0 < K; k0 += kTileK) {
    const int n = min(kTileK, K - k0);
    __syncthreads();  // the previous tile is consumed
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float c0 = pal[(size_t)(k0 + j) * 3 + 0];
      const float c1 = pal[(size_t)(k0 + j) * 3 + 1];
      const float c2 = pal[(size_t)(k0 + j) * 3 + 2];
      tile[j] = make_float4(c0, c1, c2, -0.5f * (c0 * c0 + c1 * c1 + c2 * c2));
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float4 t = tile[j];
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        const float s = fmaf(f2[i], t.z, fmaf(f1[i], t.y, fmaf(f0[i], t.x, t.w)));
        if (s > best[i]) {
          best[i] = s;
          bi[i] = k0 + j;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const size_t pix = base + (size_t)i * kThreads;
    if (pix < (size_t)P) idx_out[pix] = bi[i];
  }
}

}  // namespace

// feats (P, 3) and pal (K, 3), f32 contiguous; idx_out (P,) int32.
// Returns cudaGetLastError() of the launch.
extern "C" int hq_assign_idx(const float* feats, const float* pal, int P, int K,
                             int* idx_out, void* stream) {
  if (P <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const size_t per_block = (size_t)kThreads * kPix;
  const unsigned blocks = (unsigned)(((size_t)P + per_block - 1) / per_block);
  assign_idx_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(feats, pal, P, K, idx_out);
  return (int)cudaGetLastError();
}
