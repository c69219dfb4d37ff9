// B2: fused S-CIELAB Delta-E sums for a population of quantized images.
//
// Replaces the TPU kernel hybridquantization_tpu/ops/fused_fitness.py
// (_fused_kernel, :296-450; pallas_call in fused_scielab_err_sums, :597).
// Per member: seven separable 1-D filters horizontally, seven vertically,
// with half-sample reflection at the true image borders
// (OptimizedConvolution.cl:21-27: offset -1 reads 0, offset n reads n-1),
// recombined o0 = y0 + y3 + y6, o1 = y1 + y4, o2 = y2 + y5 (SRC7 =
// 0,1,2,0,1,2,0), Opp -> XYZ -> LAB at the whitepoint, Delta-E against the
// target LAB image (target first), summed over the H x W pixels. The
// members of a bucket of images run in one launch: member m of the
// grid's z dimension reads its image's target m / pop.
//
// B2s, the TPU kernel's edges="slabs" variant (fused_fitness.py:325-337,
// :363-366, :578-584), serves a column shard of a wider image
// (parallel/fast.py): the horizontal pass takes the columns beyond the
// shard's two borders from two guards of taps / 2 columns, by index, with
// no concatenated copy of the shard (that copy would read and write q once
// more per evaluation); the shard that holds a true image border gets a
// locally mirrored guard there from its wrapper. Rows are whole on every
// shard, so the vertical pass mirrors at rows -1 and H as before. The
// TPU's 128-column slabs and R-folded band matrices are layout devices and
// are not ported.
//
// bf16 mode follows the TPU kernel's rounding points (its DEFAULT dots,
// fused_fitness.py:345-354, :398, :428): the opponent values and the
// horizontal taps are rounded to bf16 where the horizontal pass loads them,
// the f32 intermediate and the vertical taps where the vertical pass loads
// them; products of two bf16 values are exact in f32, so each tap is one
// exact product and one f32 add, as in the TPU's f32 accumulator. The
// recombination, LAB and Delta-E stay f32. Mirroring by index reads the
// same rounded samples as the TPU's R-folded edge matrices.
//
// What bounds it on the H100: memory traffic. The 7-channel intermediate of
// the horizontal pass is 7 x 4 B per pixel per member (929 MB at 4K/pop4),
// written once and read back once; each tap is one FMA. The design:
//  - hpass: one thread per output pixel computes all seven filters from the
//    three opponent channels (each source sample is loaded once per tap and
//    feeds two or three filters); taps sit in shared memory; the
//    neighbouring threads of a warp read neighbouring columns, so the tap
//    loop's loads coalesce and hit L1; a thread whose window lies inside
//    the row runs the tap loop without the per-tap mirror or guard test
//    (the same loads in the same order, so the same sums);
//  - vpass: one thread per output pixel walks the column of the scratch
//    (coalesced across the warp; the rows a block needs are shared with the
//    blocks above and below it through L2), then recombines, converts to LAB,
//    takes Delta-E, and reduces the block in a fixed order into one partial;
//  - reduce: one block per member sums its partials in double, in a fixed
//    order, so a fitness value is the same from run to run (no float atomics)
//    and the same whether its image ran alone or in a bucket.
// Keeping the intermediate in shared memory, and TMA/wgmma banded filters,
// are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "delta_e.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool kBf16>
__device__ __forceinline__ float load(const float* p) {
  return kBf16 ? bf16_round(*p) : *p;
}

__device__ __forceinline__ int mirror(int i, int n) {
  return i < 0 ? -i - 1 : (i >= n ? 2 * n - i - 1 : i);
}

// One tap of the seven horizontal filters: the three opponent samples at
// src, src + cs, src + 2 cs feed filters (0, 3, 6), (1, 4) and (2, 5).
template <bool kBf16>
__device__ __forceinline__ void tap7(float (&acc)[7], const float* sk, int taps, int t,
                                     const float* src, size_t cs) {
  const float v0 = load<kBf16>(src);
  const float v1 = load<kBf16>(src + cs);
  const float v2 = load<kBf16>(src + 2 * cs);
  acc[0] = fmaf(sk[0 * taps + t], v0, acc[0]);
  acc[1] = fmaf(sk[1 * taps + t], v1, acc[1]);
  acc[2] = fmaf(sk[2 * taps + t], v2, acc[2]);
  acc[3] = fmaf(sk[3 * taps + t], v0, acc[3]);
  acc[4] = fmaf(sk[4 * taps + t], v1, acc[4]);
  acc[5] = fmaf(sk[5 * taps + t], v2, acc[5]);
  acc[6] = fmaf(sk[6 * taps + t], v0, acc[6]);
}

// kSlabs (B2s, a column shard of a wider image): column x - half + t < 0
// reads column x - half + t + half of `left`, one at W or beyond column
// x - half + t - W of `right`, both (members, 3, H, half); no mirroring.
template <bool kBf16, bool kSlabs>
__global__ void __launch_bounds__(kThreads)
hpass_kernel(const float* __restrict__ q, const float* __restrict__ left,
             const float* __restrict__ right, const float* __restrict__ kh, int taps, int H,
             int W, float* __restrict__ t7) {
  extern __shared__ float sk[];  // 7 * taps
  for (int i = threadIdx.x; i < 7 * taps; i += blockDim.x) sk[i] = load<kBf16>(kh + i);
  __syncthreads();

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int p = blockIdx.z;
  if (x >= W) return;
  const int half = taps / 2;
  const size_t plane = (size_t)H * W;
  const float* row = q + (size_t)p * 3 * plane + (size_t)y * W;
  // the guards' rows of this member (used only with kSlabs)
  const size_t gplane = (size_t)H * half;
  const size_t goff = (size_t)p * 3 * gplane + (size_t)y * half;
  float acc[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (x >= half && x + half < W) {
    // the whole window lies inside the row: no mirror, no guard
    const float* src = row + (x - half);
    for (int t = 0; t < taps; ++t) {
      tap7<kBf16>(acc, sk, taps, t, src + t, plane);
    }
  } else {
    for (int t = 0; t < taps; ++t) {
      const int xi = x - half + t;
      if (kSlabs && xi < 0) {
        tap7<kBf16>(acc, sk, taps, t, left + goff + (xi + half), gplane);
      } else if (kSlabs && xi >= W) {
        tap7<kBf16>(acc, sk, taps, t, right + goff + (xi - W), gplane);
      } else {
        tap7<kBf16>(acc, sk, taps, t, row + (kSlabs ? xi : mirror(xi, W)), plane);
      }
    }
  }
  float* out = t7 + (size_t)p * 7 * plane + (size_t)y * W + x;
#pragma unroll
  for (int f = 0; f < 7; ++f) out[f * plane] = acc[f];
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
vpass_de_kernel(const float* __restrict__ t7, const float* __restrict__ target,
                const float* __restrict__ kv, int taps, int pop, int H, int W, float wp0,
                float wp1, float wp2, int kind, float* __restrict__ partials) {
  extern __shared__ float sk[];  // 7 * taps, then one float per warp
  float* warp_sums = sk + 7 * taps;
  // the target of this block's image, one division per block rather than
  // per thread
  __shared__ const float* image_target;
  if (threadIdx.x == 0) image_target = target + (size_t)(blockIdx.z / pop) * 3 * H * W;
  for (int i = threadIdx.x; i < 7 * taps; i += blockDim.x) sk[i] = load<kBf16>(kv + i);
  __syncthreads();

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int p = blockIdx.z;
  const size_t plane = (size_t)H * W;
  float de = 0.0f;
  if (x < W) {
    const int half = taps / 2;
    const float* col = t7 + (size_t)p * 7 * plane + x;
    float acc[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int t = 0; t < taps; ++t) {
      const float* r = col + (size_t)mirror(y - half + t, H) * W;
#pragma unroll
      for (int f = 0; f < 7; ++f) {
        acc[f] = fmaf(sk[f * taps + t], load<kBf16>(r + f * plane), acc[f]);
      }
    }
    const float o0 = (acc[0] + acc[3]) + acc[6];
    const float o1 = acc[1] + acc[4];
    const float o2 = acc[2] + acc[5];
    float L, a, b;
    hq::opp_to_lab(o0, o1, o2, wp0, wp1, wp2, L, a, b);
    const float* tgt = image_target + (size_t)y * W + x;
    de = hq::delta_e(kind, tgt[0], tgt[plane], tgt[2 * plane], L, a, b);
  }

  // fixed-order block reduction: warp tree, then warp 0 over the warp sums
  for (int off = 16; off > 0; off >>= 1) de += __shfl_down_sync(0xffffffffu, de, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = de;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    float s = lane < n_warps ? warp_sums[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) partials[((size_t)p * gridDim.y + y) * gridDim.x + blockIdx.x] = s;
  }
}

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

int blocks_x(int W) { return (W + kThreads - 1) / kThreads; }

}  // namespace

// Number of per-member partial sums hq_fused_err_sums writes.
extern "C" int hq_fused_num_partials(int H, int W) { return blocks_x(W) * H; }

// q (members, 3, H, W) opponent images, members = B * pop (image-major);
// left, right: null (mirror at both column borders), or the (members, 3, H,
// taps / 2) column guards of a shard (B2s: what lies left of column 0 and
// right of column W - 1); target (B, 3, H, W) LAB, one per image; kh, kv
// (7, taps) horizontal / vertical filter stacks; t7 (members, 7, H, W)
// scratch; partials (members, hq_fused_num_partials) scratch; sums (members,)
// output. All f32 contiguous. kind: 0 CIE76, 1 CIE94, 2 CIEDE2000; bf16:
// round the conv operands to bf16. Needs taps odd, taps / 2 < H, and
// without guards taps / 2 < W. Returns the first non-zero cudaGetLastError().
extern "C" int hq_fused_err_sums(const float* q, const float* left, const float* right,
                                 const float* target, const float* kh, const float* kv, int taps,
                                 int members, int pop, int H, int W, float wp0, float wp1,
                                 float wp2, int kind, int bf16, float* t7, float* partials,
                                 float* sums, void* stream) {
  const bool slabs = left != nullptr;
  if (members <= 0 || pop <= 0 || members % pop != 0 || H <= 0 || W <= 0 || taps <= 0 ||
      taps % 2 == 0 || taps / 2 >= H || (!slabs && taps / 2 >= W) || slabs != (right != nullptr) ||
      kind < 0 || kind > 2 || H > 65535 || members > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(blocks_x(W), H, members);
  const size_t tap_bytes = 7 * (size_t)taps * sizeof(float);
  const size_t vpass_bytes = tap_bytes + (kThreads / 32) * sizeof(float);
  if (slabs && bf16) {
    hpass_kernel<true, true><<<grid, kThreads, tap_bytes, s>>>(q, left, right, kh, taps, H, W, t7);
  } else if (slabs) {
    hpass_kernel<false, true><<<grid, kThreads, tap_bytes, s>>>(q, left, right, kh, taps, H, W, t7);
  } else if (bf16) {
    hpass_kernel<true, false><<<grid, kThreads, tap_bytes, s>>>(q, left, right, kh, taps, H, W, t7);
  } else {
    hpass_kernel<false, false><<<grid, kThreads, tap_bytes, s>>>(q, left, right, kh, taps, H, W, t7);
  }
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  if (bf16) {
    vpass_de_kernel<true><<<grid, kThreads, vpass_bytes, s>>>(t7, target, kv, taps, pop, H, W,
                                                             wp0, wp1, wp2, kind, partials);
  } else {
    vpass_de_kernel<false><<<grid, kThreads, vpass_bytes, s>>>(t7, target, kv, taps, pop, H, W,
                                                              wp0, wp1, wp2, kind, partials);
  }
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  reduce_kernel<<<members, kReduceThreads, 0, s>>>(partials, blocks_x(W) * H, sums);
  return (int)cudaGetLastError();
}
