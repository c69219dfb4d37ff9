// T3–T8: split-bf16 assignment scores on the tensor cores.
//
// Replaces the TPU probes tools/vpu_assign_exp.py make_dotprobe_kernel
// (:309-333, pallas_call in run_dotprobe, :342), tools/kexp_assign.py
// make_kernel at precision "f32x3" (:67-256, pallas_call in run_variant,
// :271) and tools/minidot_probe.py _dense_kernel, _mini_kernel,
// _mini_full_kernel and _mini_full2_kernel (:48-187, pallas_calls at :204,
// :220, :252, :302). All of them compute, per member p, pixel i and
// candidate k, the split-bf16 score: each operand is split into bf16
// hi = bf16(a) and lo = bf16(a - hi), and the 12-deep contraction
//   s = [ch; ch; cl] . [xh; xl; xh]   (over the 4 rows of x and c)
// sums exact bf16 x bf16 products in f32 (pallas_assign.py:144-148,
// :177-188). Two kernels of one template:
//  - split_rowmax: the max over k of s, each s optionally rounded to bf16
//    (to nearest, ties to even) first (T3's `out_bf16`);
//  - split_assign: the first index of the max (merged by max score, then
//    min index), the winner's colour from 3 exact bf16 parts (T4,
//    pallas_assign.py:151-159, :279-287) or 2 (T7/T8, minidot_probe.py:
//    112-121), and int32 counts per candidate; or, tie mode "average" (T4's
//    `avg`), every maximum a hit, the colour the undivided sum of the hits'
//    colours in index order, counts the hits.
// A NaN score never wins (nor enters the max); a pixel with no winner gets
// index -1, colour 0 and no count.
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
//  - each lane keeps a running best for its two pixels (rows g and g + 8)
//    over its two candidate columns of every n-tile, and the four lanes of
//    a row group merge with shuffles;
//  - average mode recomputes the products in a second pass (the same mma
//    on the same fragments gives the same f32 values) and sums the hits in
//    index order from ballots of the four lanes.
// The tensor core's f32 accumulation is not a sequential IEEE sum, so the
// scores agree with the plain torch version to a few f32 ulps of the
// largest product, not bit for bit.
//
// What bounds it on the H100: at 4 members x 8.3 M pixels x 256 candidates
// the 16 x 8 x 16 mma tiles are 12/16 useful and the tensor cores are far
// from busy; the compare-and-select chain over the accumulator (fp32 pipe)
// and the pixel loads dominate. A plain tiling: no wgmma, TMA or pipelining.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kRowMax = 0, kFirst = 1, kAverage = 2;
constexpr int kTilesPerWarp = 8;  // dense: 16-pixel tiles per warp and block
constexpr int kHistInts = 8192;   // pop * Kc up to this counts in shared memory
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

// The colour the one-hot gather reconstructs from `n` bf16 parts of v.
__device__ __forceinline__ float parts(float v, int n) {
  const float hi = bf16_round(v);
  const float r1 = __fsub_rn(v, hi);
  const float mid = bf16_round(r1);
  if (n == 2) return __fadd_rn(hi, mid);
  return __fadd_rn(__fadd_rn(hi, mid), bf16_round(__fsub_rn(r1, mid)));
}

__device__ __forceinline__ void mma(const uint32_t a[4], uint2 b, float d[4]) {
  const float z = 0.0f;
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y), "f"(z), "f"(z), "f"(z),
        "f"(z));
}

template <int kMode>
__global__ void split_kernel(const float* __restrict__ x, const float* __restrict__ c,
                             const float* __restrict__ o, int P, int Kc, int pop, int run, int R,
                             bool out_bf16, int opp_parts, bool shared_hist,
                             float* __restrict__ rowmax, float* __restrict__ opp,
                             int* __restrict__ counts, int* __restrict__ idx_out) {
  extern __shared__ uint2 frag[];  // (pop, n-tiles, 32 lanes) B fragments, then hist
  const int NT = (Kc + 7) / 8;
  int* hist = reinterpret_cast<int*>(frag + (size_t)pop * NT * 32);

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
  if (kMode != kRowMax && shared_hist) {
    for (int k = threadIdx.x; k < pop * Kc; k += blockDim.x) hist[k] = 0;
  }
  __syncthreads();

  auto count = [&](int p, int k) {
    if (shared_hist) {
      atomicAdd(&hist[p * Kc + k], 1);
    } else {
      atomicAdd(&counts[(size_t)p * Kc + k], 1);
    }
  };

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
      int ia = -1, ib = -1;
      for (int nt = 0; nt < NT; ++nt) {
        float d[4];
        mma(a, fp[nt * 32], d);
        const int c0 = nt * 8 + 2 * t;
        if (kMode == kRowMax) {
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
        } else {
          if (c0 < Kc) {
            if (d[0] > best_a) { best_a = d[0]; ia = c0; }
            if (d[2] > best_b) { best_b = d[2]; ib = c0; }
          }
          if (c0 + 1 < Kc) {
            if (d[1] > best_a) { best_a = d[1]; ia = c0 + 1; }
            if (d[3] > best_b) { best_b = d[3]; ib = c0 + 1; }
          }
        }
      }
      // merge the four lanes of each row group
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float oa = __shfl_xor_sync(kFull, best_a, off);
        const float ob = __shfl_xor_sync(kFull, best_b, off);
        if (kMode == kRowMax) {
          best_a = fmaxf(best_a, oa);
          best_b = fmaxf(best_b, ob);
        } else {
          const int oia = __shfl_xor_sync(kFull, ia, off);
          const int oib = __shfl_xor_sync(kFull, ib, off);
          if (oa > best_a || (oa == best_a && oia < ia)) { best_a = oa; ia = oia; }
          if (ob > best_b || (ob == best_b && oib < ib)) { best_b = ob; ib = oib; }
        }
      }

      // lane t == 0 writes row g's pixel, t == 1 row g + 8's
      const size_t pix = t == 0 ? pa : pb;
      const bool writer = t < 2 && pix < px1;
      if (kMode == kRowMax) {
        if (writer) rowmax[(size_t)p * P + pix] = t == 0 ? best_a : best_b;
        continue;
      }
      const int win = t == 0 ? ia : ib;
      const float* obase = set_base(o, p);
      float col[3] = {0.0f, 0.0f, 0.0f};
      if (kMode == kFirst) {
        if (writer && win >= 0) {
          for (int r = 0; r < 3; ++r) col[r] = parts(obase[(size_t)r * Kc + win], opp_parts);
          count(p, win);
        }
      } else {
        // every maximum is a hit: recompute the scores, ballot the hits of
        // each n-tile and add them in index order
        for (int nt = 0; nt < NT; ++nt) {
          float d[4];
          mma(a, fp[nt * 32], d);
          const int c0 = nt * 8 + 2 * t;
          const unsigned ha0 = __ballot_sync(kFull, ia >= 0 && c0 < Kc && d[0] == best_a);
          const unsigned ha1 = __ballot_sync(kFull, ia >= 0 && c0 + 1 < Kc && d[1] == best_a);
          const unsigned hb0 = __ballot_sync(kFull, ib >= 0 && c0 < Kc && d[2] == best_b);
          const unsigned hb1 = __ballot_sync(kFull, ib >= 0 && c0 + 1 < Kc && d[3] == best_b);
          if (!writer) continue;
          const unsigned q0 = ((t == 0 ? ha0 : hb0) >> (4 * g)) & 0xFu;  // bit u: candidate 2u
          const unsigned q1 = ((t == 0 ? ha1 : hb1) >> (4 * g)) & 0xFu;  // bit u: candidate 2u + 1
          if ((q0 | q1) == 0u) continue;
          for (int e = 0; e < 8; ++e) {
            if ((((e & 1) ? q1 : q0) >> (e >> 1)) & 1u) {
              const int k = nt * 8 + e;
              for (int r = 0; r < 3; ++r) {
                col[r] = __fadd_rn(col[r], parts(obase[(size_t)r * Kc + k], opp_parts));
              }
              count(p, k);
            }
          }
        }
      }
      if (writer) {
        float* out = opp + (size_t)p * 3 * P;
        out[pix] = col[0];
        out[(size_t)P + pix] = col[1];
        out[2 * (size_t)P + pix] = col[2];
        if (idx_out != nullptr) idx_out[(size_t)p * P + pix] = win;
      }
    }
  }

  if (kMode != kRowMax && shared_hist) {
    __syncthreads();
    for (int k = threadIdx.x; k < pop * Kc; k += blockDim.x) {
      const int h = hist[k];
      if (h != 0) atomicAdd(&counts[k], h);
    }
  }
}

template <int kMode>
int launch(const float* x, const float* c, const float* o, int P, int Kc, int pop, int run,
           int threads, bool out_bf16, int opp_parts, float* rowmax, float* opp, int* counts,
           int* idx_out, cudaStream_t s) {
  if (P <= 0 || Kc <= 0 || pop <= 0 || run < 0 || threads < 32 || threads > 1024 ||
      threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int NT = (Kc + 7) / 8;
  const bool shared_hist = kMode != kRowMax && pop * Kc <= kHistInts;
  const size_t smem =
      (size_t)pop * NT * 32 * sizeof(uint2) + (shared_hist ? (size_t)pop * Kc * sizeof(int) : 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        split_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
  split_kernel<kMode><<<(unsigned)blocks, threads, smem, s>>>(
      x, c, o, P, Kc, pop, run, R, out_bf16, opp_parts, shared_hist, rowmax, opp, counts, idx_out);
  return (int)cudaGetLastError();
}

}  // namespace

// x4 (4, P) f32; c (pop, 4, Kc), or (pop, ceil(P / run), 4, Kc) when run >
// 0; out (pop, P) f32. Returns the cudaGetLastError() of the launch.
extern "C" int hq_split_rowmax(const float* x4, const float* c, int P, int Kc, int pop, int run,
                               int out_bf16, int threads, float* out, void* stream) {
  return launch<kRowMax>(x4, c, nullptr, P, Kc, pop, run, threads, out_bf16 != 0, 3, out, nullptr,
                         nullptr, nullptr, (cudaStream_t)stream);
}

// x4, c as above; o shaped as c (row 3 unused); opp (pop, 3, P) f32; counts
// (pop, Kc) int32, zeroed by the caller; idx (pop, P) int32 or null.
// average: tie mode "average"; opp_parts 2 or 3.
extern "C" int hq_split_assign(const float* x4, const float* c, const float* o, int P, int Kc,
                               int pop, int run, int average, int opp_parts, int threads,
                               float* opp, int* counts, int* idx, void* stream) {
  if (opp_parts != 2 && opp_parts != 3) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (average) {
    return launch<kAverage>(x4, c, o, P, Kc, pop, run, threads, false, opp_parts, nullptr, opp,
                            counts, idx, s);
  }
  return launch<kFirst>(x4, c, o, P, Kc, pop, run, threads, false, opp_parts, nullptr, opp, counts,
                        idx, s);
}
