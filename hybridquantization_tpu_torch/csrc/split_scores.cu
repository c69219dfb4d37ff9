// T3, T5, T6 and T4's `dotmax`: the row max of split-bf16 scores on the
// tensor cores (split_rowmax).
//
// Replaces the TPU probes tools/vpu_assign_exp.py make_dotprobe_kernel
// (:309-333, pallas_call in run_dotprobe, :342), tools/kexp_assign.py
// make_kernel's `dotmax` (pallas_call in run_variant, :271) and
// tools/minidot_probe.py _dense_kernel and _mini_kernel (:48-110,
// pallas_calls at :204, :220). All of them compute, per member p, pixel i
// and candidate k, the split-bf16 score: each operand is split into bf16
// hi = bf16(a) and lo = bf16(a - hi), and the 12-deep contraction
//   s = [ch; ch; cl] . [xh; xl; xh]   (over the 4 rows of x and c)
// sums exact bf16 x bf16 products in f32 (pallas_assign.py:144-148,
// :177-188); then the max over k of s, each s optionally rounded to bf16
// (to nearest, ties to even) first (T3's `out_bf16`). A NaN score never
// enters the max; a pixel whose scores are all NaN gets -inf. (The
// assignment on the same score, T4/T7/T8, is csrc/split_assign.cu.)
//
// Candidates are one dense set per member, c (pop, 4, K), or one set per
// run of `run` pixels, c (pop, R, 4, KC) (the minidot probe's candidate
// palettes per 128/256-pixel run). A block owns a run (or, dense, a range
// of pixels), builds its candidates' B fragments in shared memory once, and
// each warp walks its 16-pixel tiles:
//  - the scores of 16 pixels x 8 candidates are one
//    mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, the contraction
//    padded 12 -> 16 by zeros: A is [xh; xl; xh; 0] of the 16 pixels, built
//    in registers once per tile and reused for every member, B is
//    [ch; ch; cl; 0] of the 8 candidates; the accumulator starts at 0;
//  - each lane keeps a running max for its two pixels (rows g and g + 8)
//    over its two candidate columns of every n-tile, and the four lanes of
//    a row group merge with shuffles.
// The tensor core's f32 accumulation is not a sequential IEEE sum, so the
// scores agree with the plain torch version to a few f32 ulps of the
// largest product, not bit for bit.
//
// What bounds it on the H100: at 4 members x 8.3 M pixels x 256 candidates
// the 16 x 8 x 16 mma tiles are 12/16 useful and the tensor cores are far
// from busy; the max over the accumulator (fp32 pipe) and the pixel loads
// dominate. A plain tiling: no wgmma, TMA or pipelining.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kTilesPerWarp = 8;  // dense: 16-pixel tiles per warp and block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void split(float a, __nv_bfloat16& hi, __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(a);
  lo = __float2bfloat16_rn(__fsub_rn(a, __bfloat162float(hi)));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void mma(const uint32_t a[4], uint2 b, float d[4]) {
  const float z = 0.0f;
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y), "f"(z), "f"(z), "f"(z),
        "f"(z));
}

__global__ void rowmax_kernel(const float* __restrict__ x, const float* __restrict__ c, int P,
                              int Kc, int pop, int run, int R, bool out_bf16,
                              float* __restrict__ rowmax) {
  extern __shared__ uint2 frag[];  // (pop, n-tiles, 32 lanes) B fragments
  const int NT = (Kc + 7) / 8;

  // this block's pixels [px0, px1) and candidate set
  size_t px0, px1;
  int set = 0;
  if (run > 0) {
    set = blockIdx.x;
    px0 = (size_t)set * run;
    px1 = min((size_t)P, px0 + run);
  } else {
    const size_t per = (size_t)(blockDim.x / 32) * 16 * kTilesPerWarp;
    px0 = (size_t)blockIdx.x * per;
    px1 = min((size_t)P, px0 + per);
  }
  auto set_base = [&](const float* a, int p) {
    return a + ((size_t)p * (run > 0 ? R : 1) + set) * 4 * Kc;
  };

  // B fragment of lane l (row group g = l / 4, t = l % 4) for candidate
  // n-tile nt: b0 holds contraction rows 2t, 2t + 1 of candidate nt * 8 + g,
  // b1 rows 2t + 8, 2t + 9; rows 0-3 ch, 4-7 ch, 8-11 cl, 12-15 zero.
  for (int i = threadIdx.x; i < pop * NT * 32; i += blockDim.x) {
    const int l = i & 31, nt = (i >> 5) % NT, p = (i >> 5) / NT;
    const int t = l & 3, cand = nt * 8 + (l >> 2);
    uint2 f = make_uint2(0u, 0u);
    if (cand < Kc) {
      const float* base = set_base(c, p);
      const int r0 = (t & 1) * 2;
      __nv_bfloat16 ah, al, bh, bl;
      split(base[(size_t)r0 * Kc + cand], ah, al);
      split(base[(size_t)(r0 + 1) * Kc + cand], bh, bl);
      f.x = pack2(ah, bh);
      f.y = t < 2 ? pack2(al, bl) : 0u;
    }
    frag[i] = f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m_tiles = (int)((px1 - px0 + 15) / 16);
  for (int m = warp; m < m_tiles; m += nwarps) {
    const size_t pa = px0 + (size_t)m * 16 + g, pb = pa + 8;
    // A fragment: a0 rows g, a1 rows g + 8, contraction columns 2t, 2t + 1;
    // a2, a3 the same rows at columns 2t + 8, 2t + 9. Columns 0-3 xh, 4-7
    // xl, 8-11 xh, 12-15 zero.
    uint32_t a[4];
    {
      const int r0 = (t & 1) * 2;
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (pa < (size_t)P) {
        v[0] = x[(size_t)r0 * P + pa];
        v[1] = x[(size_t)(r0 + 1) * P + pa];
      }
      if (pb < (size_t)P) {
        v[2] = x[(size_t)r0 * P + pb];
        v[3] = x[(size_t)(r0 + 1) * P + pb];
      }
      __nv_bfloat16 h[4], lo[4];
      for (int j = 0; j < 4; ++j) split(v[j], h[j], lo[j]);
      if (t < 2) {
        a[0] = a[2] = pack2(h[0], h[1]);
        a[1] = a[3] = pack2(h[2], h[3]);
      } else {
        a[0] = pack2(lo[0], lo[1]);
        a[1] = pack2(lo[2], lo[3]);
        a[2] = a[3] = 0u;
      }
    }

    for (int p = 0; p < pop; ++p) {
      const uint2* fp = frag + (size_t)p * NT * 32 + lane;
      float best_a = -INFINITY, best_b = -INFINITY;
      for (int nt = 0; nt < NT; ++nt) {
        float d[4];
        mma(a, fp[nt * 32], d);
        const int c0 = nt * 8 + 2 * t;
        if (out_bf16) {
          for (int j = 0; j < 4; ++j) d[j] = bf16_round(d[j]);
        }
        if (c0 < Kc) {
          best_a = fmaxf(best_a, d[0]);
          best_b = fmaxf(best_b, d[2]);
        }
        if (c0 + 1 < Kc) {
          best_a = fmaxf(best_a, d[1]);
          best_b = fmaxf(best_b, d[3]);
        }
      }
      // merge the four lanes of each row group
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float oa = __shfl_xor_sync(kFull, best_a, off);
        const float ob = __shfl_xor_sync(kFull, best_b, off);
        best_a = fmaxf(best_a, oa);
        best_b = fmaxf(best_b, ob);
      }

      // lane t == 0 writes row g's pixel, t == 1 row g + 8's
      const size_t pix = t == 0 ? pa : pb;
      const bool writer = t < 2 && pix < px1;
      if (writer) rowmax[(size_t)p * P + pix] = t == 0 ? best_a : best_b;
    }
  }
}

}  // namespace

// x4 (4, P) f32; c (pop, 4, Kc), or (pop, ceil(P / run), 4, Kc) when run >
// 0; out (pop, P) f32. Returns the cudaGetLastError() of the launch.
extern "C" int hq_split_rowmax(const float* x4, const float* c, int P, int Kc, int pop, int run,
                               int out_bf16, int threads, float* out, void* stream) {
  if (P <= 0 || Kc <= 0 || pop <= 0 || run < 0 || threads < 32 || threads > 1024 ||
      threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int NT = (Kc + 7) / 8;
  const size_t smem = (size_t)pop * NT * 32 * sizeof(uint2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rowmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int R = 1;
  size_t blocks;
  if (run > 0) {
    blocks = ((size_t)P + run - 1) / run;
    R = (int)blocks;
  } else {
    const size_t per = (size_t)(threads / 32) * 16 * kTilesPerWarp;
    blocks = ((size_t)P + per - 1) / per;
  }
  rowmax_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(x4, c, P, Kc, pop, run,
                                                                          R, out_bf16 != 0, out);
  return (int)cudaGetLastError();
}
