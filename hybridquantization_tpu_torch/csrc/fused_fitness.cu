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
// (parallel/fast.py): the columns beyond the shard's two borders come from
// two guards of taps / 2 columns, by index, with no concatenated copy of
// the shard; the shard that holds a true image border gets a locally
// mirrored guard there from its wrapper. Rows are whole on every shard, so
// rows mirror at -1 and H as before. The TPU's 128-column slabs and
// R-folded band matrices are layout devices and are not ported.
//
// bf16 mode follows the TPU kernel's rounding points (its DEFAULT dots,
// fused_fitness.py:345-354, :398, :428): the opponent values and the
// horizontal taps are rounded to bf16 for the horizontal pass, the f32
// intermediate and the vertical taps for the vertical pass. Each value is
// rounded once, where it is written to shared memory (or, for the default
// taps, on the host), which equals rounding it at every load; products of
// two bf16 values are exact in f32, so each tap is one exact product and
// one f32 add, as in the TPU's f32 accumulator. Recombination, LAB and
// Delta-E stay f32.
//
// split mode is the TPU kernel's f32x3 (fused_fitness.py:369-393, :415-424,
// the matrix split :550-555): every conv operand is split into bf16 hi and
// lo, x = hi + lo with hi = bf16(x), lo = bf16(x - hi), and each product is
// hi.hi + hi.lo + lo.hi (lo.lo dropped), three exact products added to the
// f32 accumulator with fmaf. The horizontal pass's output is kept as its
// hi/lo pair (the TPU's t7a/t7b bf16 scratches, :388-392, :595-596), which
// the vertical pass multiplies the same way. A split value travels as one
// 32-bit word, hi's bf16 bits above lo's (split_pack), in the staging
// buffers, the ring and the two-pass scratch, so shared memory is as in
// fp32 mode; the coefficients in shared memory are packed words too, the
// default taps' hi and lo two kernel parameters. The R-folded edge matrices
// of the TPU multiply the clamped edge block by reversed taps, product by
// product, which is reflection by index here. LAB and Delta-E stay f32.
//
// What bounds it on the H100: fp32 operations. Two passes of 7 filters x
// taps multiply-adds per member pixel (294 at the default 21 taps) against
// 12 bytes of opponent image read per member pixel; at 4K/pop4 that is
// 0.29 ms of fp32 FMA peak against 0.12 ms of bytes. The earlier two-kernel
// design wrote the 7-channel intermediate to device memory (929 MB at
// 4K/pop4, read back once) and issued one shared load per FMA. This design:
//  - one fused kernel per (member, 32-column strip, segment of rows): the
//    intermediate never leaves the SM. The block stages the opponent
//    channels 32 rows at a time with their column halo into shared memory
//    with cp.async (double-buffered: the next group's copy runs under this
//    group's passes), resolving the half-sample mirror at true borders and
//    B2s's guards by index while staging, so the passes run without edge
//    tests; the horizontal pass writes the 7 channels into a ring of
//    shared rows; the vertical pass reads the ring, recombines, converts to
//    LAB, takes Delta-E against the target, and the block reduces its
//    pixels in a fixed order into one partial;
//  - the strip walks down its segment (rows_per_block, 512 by default) with
//    a ring of G x 32 intermediate rows, G = 1 + ceil((taps - 1) / 32), so
//    the horizontal pass recomputes only the segment's top taps - 1 halo
//    rows. A 2-D tile (rows_per_block = 32) recomputes them for every 32
//    output rows and is the slower of the two (chip_smoke.py times both at
//    4K/pop4, PERF.md), so segments are 512 rows, or the image's height
//    (the wrapper's plan, ops/fused_fitness.py fused_plan, sets the segment,
//    the shared bytes and the number of partials);
//  - register blocking: a horizontal-pass thread computes 4 neighbouring
//    columns of one row (one float4 shared load of each channel feeds 4 x 7
//    filters' taps), a vertical-pass thread 4 neighbouring rows of one
//    column (each ring load feeds 4 outputs);
//  - at the default 21 taps the filter coefficients travel as a
//    __grid_constant__ kernel parameter and the tap loops are unrolled, so
//    every coefficient is an FMA operand from the constant bank, never a
//    load (faster than shared-memory loads when the two were timed while
//    the kernel was built); at other tap counts each coefficient is read
//    from shared memory once per group of rows, as two float4 loads, and
//    held in a register window for the 4 outputs it feeds;
//  - reduce: one block per member sums its partials in double, in a fixed
//    order, so a fitness value is the same from run to run (no float atomics)
//    and the same whether its image ran alone or in a bucket (the tiles and
//    the partials' layout depend only on H, W and taps).
// Filters above the plan's MAX_FUSED_TAPS (a high --dpi or a long viewing
// distance) run the two-pass kernels below, which keep the intermediate in a
// (members, 7, H, W) device scratch.
//
// ops/fused_fitness.py mirrors kTileW, kTileH, kDefaultTaps, kMaxSmem and the
// shared-memory layout (stage_width, ring_groups) in its fused_plan.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <atomic>

#include "delta_e.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kReduceThreads = 256;

// the fused kernel's tile: kTileW columns; rows staged and filtered
// horizontally kTileH at a time, and output kTileH at a time
constexpr int kTileW = 32;
constexpr int kTileH = 32;
constexpr int kRX = 4;  // horizontal-pass outputs per thread (columns)
constexpr int kRY = 4;  // vertical-pass outputs per thread (rows)
static_assert((kTileW / kRX) * kTileH == kThreads, "one horizontal item per thread");
static_assert(kTileW * (kTileH / kRY) == kThreads, "one vertical item per thread");
constexpr int kDefaultTaps = 21;  // scielab/filters.build_filters at 72 dpi, 45 cm
constexpr size_t kMaxSmem = 232448;  // shared bytes a block may use
constexpr int kMaxDevices = 64;

// the default filter's coefficients as a kernel parameter (1176 bytes)
struct DefaultTaps {
  float h[7][kDefaultTaps];
  float v[7][kDefaultTaps];
};

// the conv arithmetic (the wrapper's precision): fp32, bf16 operands, or
// the TPU's f32x3 hi/lo split
enum Mode : int { kFp32 = 0, kBf16 = 1, kSplit = 2 };

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x as its hi/lo bf16 pair in one word (hi's bits high), read back as a float
// slot; both roundings to nearest even, as the TPU's astype
__device__ __forceinline__ float split_pack(float x) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(x);
  const __nv_bfloat16 lo = __float2bfloat16_rn(x - __bfloat162float(hi));
  return __uint_as_float(((unsigned)__bfloat16_as_ushort(hi) << 16) | __bfloat16_as_ushort(lo));
}
__device__ __forceinline__ float split_hi(float w) { return __uint_as_float(__float_as_uint(w) & 0xffff0000u); }
__device__ __forceinline__ float split_lo(float w) { return __uint_as_float(__float_as_uint(w) << 16); }

// a conv operand as the mode stores it: the value, rounded, or packed
template <int kMode>
__device__ __forceinline__ float convert(float x) {
  return kMode == kBf16 ? bf16_round(x) : (kMode == kSplit ? split_pack(x) : x);
}

template <int kMode>
__device__ __forceinline__ float load(const float* p) {
  return convert<kMode>(*p);
}

// acc + coefficient x sample in the mode's arithmetic: one fmaf, or in split
// mode (v packed; the coefficient's hi and lo given) th.vh + th.vl + tl.vh
template <int kMode>
__device__ __forceinline__ float fma_tap(float th, float tl, float v, float acc) {
  if (kMode != kSplit) return fmaf(th, v, acc);
  const float vh = split_hi(v);
  acc = fmaf(th, vh, acc);
  acc = fmaf(th, split_lo(v), acc);
  return fmaf(tl, vh, acc);
}

// the same with the coefficient as the mode stores it (packed in split mode)
template <int kMode>
__device__ __forceinline__ float fma_packed(float c, float v, float acc) {
  return kMode == kSplit ? fma_tap<kMode>(split_hi(c), split_lo(c), v, acc) : fmaf(c, v, acc);
}

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

// ---- the layout of the fused kernel's shared memory, in floats: 2 staging
// ---- buffers [3][kTileH][stage_width], the ring [ring_groups * kTileH][7]
// ---- [kTileW], and except at kDefaultTaps the two stacks [2][taps][8]

__device__ __forceinline__ int stage_width(int half) { return (kTileW + 2 * half + 3) / 4 * 4; }
__device__ __forceinline__ int ring_groups(int half) {
  return 1 + (kTileH + 2 * half - 1) / kTileH;
}

// Copy group g's kTileH opponent rows (3 channels, the strip's columns and
// their halo) into buffer `buf`, mirrored or from the guards by index.
template <bool kSlabs>
__device__ __forceinline__ void stage_group(float* buf, const float* q, const float* left,
                                            const float* right, int p, int H, int W, int half,
                                            int sw, int x0, int y_first) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int rc = warp; rc < 3 * kTileH; rc += kThreads / 32) {
    const int c = rc / kTileH;
    const int i = rc - c * kTileH;
    const int row = mirror_clamped(y_first + i, H);
    const size_t plane = (size_t)(p * 3 + c) * H + row;  // (member, channel, row)
    const float* qrow = q + plane * W;
    float* dst = buf + (size_t)rc * sw;
    for (int s = lane; s < sw; s += 32) {
      const int x = x0 - half + s;
      const float* src;
      if (kSlabs && x < 0) {
        src = left + plane * half + max(x + half, 0);
      } else if (kSlabs && x >= W) {
        src = right + plane * half + min(x - W, half - 1);
      } else {
        src = qrow + (kSlabs ? x : mirror_clamped(x, W));
      }
      cp_async4(dst + s, src);
    }
  }
}

// bf16 and split modes: round or split what this thread staged (its own
// copies have landed), so that each sample is converted once
template <int kMode>
__device__ __forceinline__ void convert_group(float* buf, int sw) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int rc = warp; rc < 3 * kTileH; rc += kThreads / 32) {
    float* row = buf + (size_t)rc * sw;
    for (int s = lane; s < sw; s += 32) row[s] = convert<kMode>(row[s]);
  }
}

// Tap t's seven coefficients from a [taps][8] shared stack: two float4 loads.
__device__ __forceinline__ void tap_coeffs(const float* sk, int t, float (&c)[7]) {
  const float4 lo = *reinterpret_cast<const float4*>(sk + 8 * t);
  const float4 hi = *reinterpret_cast<const float4*>(sk + 8 * t + 4);
  c[0] = lo.x;
  c[1] = lo.y;
  c[2] = lo.z;
  c[3] = lo.w;
  c[4] = hi.x;
  c[5] = hi.y;
  c[6] = hi.z;
}

// Step s4 of the horizontal pass at any taps: samples 4 s4 .. 4 s4 + 3 of
// the three channels; it loads taps 4 s4 .. 4 s4 + 3 into slots kU .. kU + 3
// (kU = 4 (s4 % 2), so tap t is in slot t % 8). kGuard: skip taps outside
// [0, taps) (the first and last steps).
template <int kMode, int kU, bool kGuard>
__device__ __forceinline__ void hpass_step(const float* r, size_t cs, const float* skh, int taps,
                                           int s4, float (&c)[8][7], float (&acc)[kRX][7]) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (!kGuard || 4 * s4 + u < taps) tap_coeffs(skh, 4 * s4 + u, c[kU + u]);
  const float4 a = *reinterpret_cast<const float4*>(r + 4 * s4);
  const float4 b = *reinterpret_cast<const float4*>(r + cs + 4 * s4);
  const float4 d = *reinterpret_cast<const float4*>(r + 2 * cs + 4 * s4);
  const float v0[4] = {a.x, a.y, a.z, a.w};
  const float v1[4] = {b.x, b.y, b.z, b.w};
  const float v2[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
    for (int k = 0; k < kRX; ++k) {
      const int t = 4 * s4 + jj - k;
      if (!kGuard || (t >= 0 && t < taps)) {
        const int w = (kU + jj - k) & 7;
        acc[k][0] = fma_packed<kMode>(c[w][0], v0[jj], acc[k][0]);
        acc[k][1] = fma_packed<kMode>(c[w][1], v1[jj], acc[k][1]);
        acc[k][2] = fma_packed<kMode>(c[w][2], v2[jj], acc[k][2]);
        acc[k][3] = fma_packed<kMode>(c[w][3], v0[jj], acc[k][3]);
        acc[k][4] = fma_packed<kMode>(c[w][4], v1[jj], acc[k][4]);
        acc[k][5] = fma_packed<kMode>(c[w][5], v2[jj], acc[k][5]);
        acc[k][6] = fma_packed<kMode>(c[w][6], v0[jj], acc[k][6]);
      }
    }
  }
}

// Ring row j of the vertical pass at any taps: it loads tap j into slot kU
// (= j % 4) and feeds output k with tap j - k. kGuard: skip taps outside
// [0, taps).
template <int kMode, int kU, bool kGuard>
__device__ __forceinline__ void vpass_row(const float* skv, int taps, int j, const float (&v)[7],
                                          float (&c)[4][7], float (&acc)[kRY][7]) {
  if (!kGuard || j < taps) tap_coeffs(skv, j, c[kU]);
#pragma unroll
  for (int k = 0; k < kRY; ++k) {
    const int t = j - k;
    if (!kGuard || (t >= 0 && t < taps)) {
#pragma unroll
      for (int f = 0; f < 7; ++f) acc[k][f] = fma_packed<kMode>(c[(kU - k) & 3][f], v[f], acc[k][f]);
    }
  }
}

// The horizontal pass of one staged group: thread (row i, columns 4 cg ..
// 4 cg + 3) writes its 4 x 7 outputs to ring rows `slot` (rounded to bf16
// in bf16 mode, as hi/lo pairs in split mode). Each accumulator takes its
// taps in ascending order.
template <int kTaps, int kMode>
__device__ __forceinline__ void hpass_group(const float* buf, float* ring, int slot0,
                                            const DefaultTaps& dt, const DefaultTaps& dtl,
                                            const float* skh, int taps, int sw) {
  const int i = threadIdx.x / (kTileW / kRX);
  const int cg = threadIdx.x - i * (kTileW / kRX);
  const size_t cs = (size_t)kTileH * sw;  // channel stride of the staging buffer
  const float* r = buf + (size_t)i * sw + kRX * cg;
  float acc[kRX][7];
#pragma unroll
  for (int k = 0; k < kRX; ++k)
#pragma unroll
    for (int f = 0; f < 7; ++f) acc[k][f] = 0.0f;
  if (kTaps) {
    // samples r[j], j < kTaps + 3, in float4 steps; sample j feeds output
    // k with tap t = j - k
#pragma unroll
    for (int j4 = 0; j4 < (kTaps + kRX - 1 + 3) / 4; ++j4) {
      const float4 a = *reinterpret_cast<const float4*>(r + 4 * j4);
      const float4 b = *reinterpret_cast<const float4*>(r + cs + 4 * j4);
      const float4 c = *reinterpret_cast<const float4*>(r + 2 * cs + 4 * j4);
      const float v0[4] = {a.x, a.y, a.z, a.w};
      const float v1[4] = {b.x, b.y, b.z, b.w};
      const float v2[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int k = 0; k < kRX; ++k) {
          const int t = 4 * j4 + jj - k;
          if (t >= 0 && t < kTaps) {
            acc[k][0] = fma_tap<kMode>(dt.h[0][t], dtl.h[0][t], v0[jj], acc[k][0]);
            acc[k][1] = fma_tap<kMode>(dt.h[1][t], dtl.h[1][t], v1[jj], acc[k][1]);
            acc[k][2] = fma_tap<kMode>(dt.h[2][t], dtl.h[2][t], v2[jj], acc[k][2]);
            acc[k][3] = fma_tap<kMode>(dt.h[3][t], dtl.h[3][t], v0[jj], acc[k][3]);
            acc[k][4] = fma_tap<kMode>(dt.h[4][t], dtl.h[4][t], v1[jj], acc[k][4]);
            acc[k][5] = fma_tap<kMode>(dt.h[5][t], dtl.h[5][t], v2[jj], acc[k][5]);
            acc[k][6] = fma_tap<kMode>(dt.h[6][t], dtl.h[6][t], v0[jj], acc[k][6]);
          }
        }
      }
    }
  } else {
    // any taps: the same float4 steps; tap t's coefficients, loaded once
    // from shared memory, wait in slot t % 8 of a register window for the
    // steps that use them. Steps go in pairs (slots 0-3, then 4-7); a pair
    // whose taps all lie in [0, taps) runs without tests.
    float c[8][7] = {};
    const int steps = (taps + kRX - 1 + 3) / 4;
    for (int s4 = 0; s4 < steps; s4 += 2) {
      if (s4 >= 1 && 4 * s4 + 7 < taps) {
        hpass_step<kMode, 0, false>(r, cs, skh, taps, s4, c, acc);
        hpass_step<kMode, 4, false>(r, cs, skh, taps, s4 + 1, c, acc);
      } else {
        hpass_step<kMode, 0, true>(r, cs, skh, taps, s4, c, acc);
        if (s4 + 1 < steps) hpass_step<kMode, 4, true>(r, cs, skh, taps, s4 + 1, c, acc);
      }
    }
  }
  float* out = ring + ((size_t)(slot0 + i) * 7) * kTileW + kRX * cg;
#pragma unroll
  for (int f = 0; f < 7; ++f) {
    const float4 o = make_float4(convert<kMode>(acc[0][f]), convert<kMode>(acc[1][f]),
                                 convert<kMode>(acc[2][f]), convert<kMode>(acc[3][f]));
    *reinterpret_cast<float4*>(out + f * kTileW) = o;
  }
}

// The vertical pass of one output chunk and its Delta-E: thread (column
// col, rows 4 rg .. 4 rg + 3 of the chunk). Returns the sum of its valid
// pixels' Delta-E, in row order. The ring holds the mode's operands.
template <int kTaps, int kMode>
__device__ __forceinline__ float vpass_chunk(const float* ring, int slot, int ring_rows,
                                             const DefaultTaps& dt, const DefaultTaps& dtl,
                                             const float* skv, int taps,
                                             const float* tgt, int y, int y_end, int x, int W,
                                             size_t plane, float wp0, float wp1, float wp2,
                                             int kind) {
  const int col = threadIdx.x & (kTileW - 1);
  float acc[kRY][7];
#pragma unroll
  for (int k = 0; k < kRY; ++k)
#pragma unroll
    for (int f = 0; f < 7; ++f) acc[k][f] = 0.0f;
  // ring row j of the window (j < taps + 3, read in order by `row`) feeds
  // output k with tap j - k
  auto row = [&](float (&v)[7]) {
    const float* rp = ring + (size_t)slot * 7 * kTileW + col;
#pragma unroll
    for (int f = 0; f < 7; ++f) v[f] = rp[f * kTileW];
    slot = slot + 1 == ring_rows ? 0 : slot + 1;
  };
  if (kTaps) {
#pragma unroll
    for (int j = 0; j < kTaps + kRY - 1; ++j) {
      float v[7];
      row(v);
#pragma unroll
      for (int k = 0; k < kRY; ++k) {
        const int t = j - k;
        if (t >= 0 && t < kTaps) {
#pragma unroll
          for (int f = 0; f < 7; ++f) acc[k][f] = fma_tap<kMode>(dt.v[f][t], dtl.v[f][t], v[f], acc[k][f]);
        }
      }
    }
  } else {
    // any taps: tap t's coefficients, loaded once when row t is read, wait
    // in slot t % 4 for the next three rows; rows go in fours, and four rows
    // whose taps all lie in [0, taps) run without tests
    float c[4][7] = {};
    const int rows = taps + kRY - 1;
    for (int j0 = 0; j0 < rows; j0 += 4) {
      float v[7];
      if (j0 >= 3 && j0 + 3 < taps) {
        row(v);
        vpass_row<kMode, 0, false>(skv, taps, j0, v, c, acc);
        row(v);
        vpass_row<kMode, 1, false>(skv, taps, j0 + 1, v, c, acc);
        row(v);
        vpass_row<kMode, 2, false>(skv, taps, j0 + 2, v, c, acc);
        row(v);
        vpass_row<kMode, 3, false>(skv, taps, j0 + 3, v, c, acc);
      } else {
        row(v);
        vpass_row<kMode, 0, true>(skv, taps, j0, v, c, acc);
        if (j0 + 1 < rows) {
          row(v);
          vpass_row<kMode, 1, true>(skv, taps, j0 + 1, v, c, acc);
        }
        if (j0 + 2 < rows) {
          row(v);
          vpass_row<kMode, 2, true>(skv, taps, j0 + 2, v, c, acc);
        }
        if (j0 + 3 < rows) {
          row(v);
          vpass_row<kMode, 3, true>(skv, taps, j0 + 3, v, c, acc);
        }
      }
    }
  }
  float de = 0.0f;
#pragma unroll
  for (int k = 0; k < kRY; ++k) {
    if (y + k < y_end && x < W) {
      const float o0 = (acc[k][0] + acc[k][3]) + acc[k][6];
      const float o1 = acc[k][1] + acc[k][4];
      const float o2 = acc[k][2] + acc[k][5];
      float L, a, b;
      hq::opp_to_lab(o0, o1, o2, wp0, wp1, wp2, L, a, b);
      const float* t = tgt + (size_t)(y + k) * W + x;
      de += hq::delta_e(kind, t[0], t[plane], t[2 * plane], L, a, b);
    }
  }
  return de;
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

// One block: member blockIdx.z, columns [32 blockIdx.x, + 32), rows
// [rows_per_block blockIdx.y, + rows_per_block). kTaps: the default taps
// (coefficients in dt, and in split mode their lo parts in dtl) or 0 (any
// odd taps whose layout fits, from kh, kv).
template <int kTaps, int kMode, bool kSlabs>
__global__ void __launch_bounds__(kThreads, 2)
fused_kernel(const float* __restrict__ q, const float* __restrict__ left,
             const float* __restrict__ right, const float* __restrict__ target,
             const float* __restrict__ kh, const float* __restrict__ kv,
             const __grid_constant__ DefaultTaps dt, const __grid_constant__ DefaultTaps dtl,
             int taps, int pop, int H, int W, int rows_per_block, float wp0, float wp1,
             float wp2, int kind, float* __restrict__ partials) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float warp_sums[kThreads / 32];
  if (kTaps) taps = kTaps;
  const int half = taps / 2;
  const int sw = stage_width(half);
  const int G = ring_groups(half);
  const int ring_rows = G * kTileH;
  float* stage = smem;                                 // [2][3][kTileH][sw]
  float* ring = stage + 2 * 3 * kTileH * sw;           // [ring_rows][7][kTileW]
  float* skh = ring + (size_t)ring_rows * 7 * kTileW;  // [taps][8] (kTaps == 0)
  float* skv = skh + 8 * taps;
  if (!kTaps) {
    for (int i = threadIdx.x; i < 8 * taps; i += kThreads) {
      const int t = i >> 3, f = i & 7;
      skh[i] = f < 7 ? load<kMode>(kh + f * taps + t) : 0.0f;
      skv[i] = f < 7 ? load<kMode>(kv + f * taps + t) : 0.0f;
    }
  }

  const int p = blockIdx.z;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * rows_per_block;
  const int y_end = min(y0 + rows_per_block, H);
  const int chunks = (y_end - y0 + kTileH - 1) / kTileH;
  const int groups = chunks + G - 1;
  const size_t plane = (size_t)H * W;
  const float* tgt = target + (size_t)(p / pop) * 3 * plane;
  const size_t buf_floats = (size_t)3 * kTileH * sw;

  // row y0 - half + r of the strip (r >= 0) lives in ring row r mod ring_rows
  stage_group<kSlabs>(stage, q, left, right, p, H, W, half, sw, x0, y0 - half);
  cp_async_commit();
  float de = 0.0f;
  for (int g = 0; g < groups; ++g) {
    float* buf = stage + (g & 1) * buf_floats;
    if (g + 1 < groups) {
      // the other buffer was last read by group g - 1's pass, before the
      // barrier that ended it
      stage_group<kSlabs>(stage + ((g + 1) & 1) * buf_floats, q, left, right, p, H, W, half,
                          sw, x0, y0 - half + (g + 1) * kTileH);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (kMode != kFp32) convert_group<kMode>(buf, sw);
    __syncthreads();  // the group is staged; the ring's old rows are read
    hpass_group<kTaps, kMode>(buf, ring, (g % G) * kTileH, dt, dtl, skh, taps, sw);
    __syncthreads();
    const int c = g - (G - 1);  // the output chunk whose window is now complete
    if (c >= 0) {
      const int rg = threadIdx.x / kTileW;
      const int y = y0 + c * kTileH + kRY * rg;
      de += vpass_chunk<kTaps, kMode>(ring, (c % G) * kTileH + kRY * rg, ring_rows, dt, dtl, skv,
                                      taps, tgt, y, y_end, x0 + (threadIdx.x & (kTileW - 1)), W,
                                      plane, wp0, wp1, wp2, kind);
    }
  }
  block_sum(de, warp_sums,
            partials + ((size_t)p * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x);
}

// ---- the two-pass path, for filters above the plan's MAX_FUSED_TAPS

// One tap of the seven horizontal filters: the three opponent samples at
// src, src + cs, src + 2 cs feed filters (0, 3, 6), (1, 4) and (2, 5); sk
// holds the mode's coefficients.
template <int kMode>
__device__ __forceinline__ void tap7(float (&acc)[7], const float* sk, int taps, int t,
                                     const float* src, size_t cs) {
  const float v0 = load<kMode>(src);
  const float v1 = load<kMode>(src + cs);
  const float v2 = load<kMode>(src + 2 * cs);
  acc[0] = fma_packed<kMode>(sk[0 * taps + t], v0, acc[0]);
  acc[1] = fma_packed<kMode>(sk[1 * taps + t], v1, acc[1]);
  acc[2] = fma_packed<kMode>(sk[2 * taps + t], v2, acc[2]);
  acc[3] = fma_packed<kMode>(sk[3 * taps + t], v0, acc[3]);
  acc[4] = fma_packed<kMode>(sk[4 * taps + t], v1, acc[4]);
  acc[5] = fma_packed<kMode>(sk[5 * taps + t], v2, acc[5]);
  acc[6] = fma_packed<kMode>(sk[6 * taps + t], v0, acc[6]);
}

// One thread per output pixel; kSlabs (B2s): column x - half + t < 0 reads
// column x - half + t + half of `left`, one at W or beyond column
// x - half + t - W of `right`, both (members, 3, H, half); no mirroring.
// Split mode writes the hi/lo pairs into t7; the other modes write f32.
template <int kMode, bool kSlabs>
__global__ void __launch_bounds__(kThreads)
hpass_kernel(const float* __restrict__ q, const float* __restrict__ left,
             const float* __restrict__ right, const float* __restrict__ kh, int taps, int H,
             int W, float* __restrict__ t7) {
  extern __shared__ float sk[];  // 7 * taps
  for (int i = threadIdx.x; i < 7 * taps; i += blockDim.x) sk[i] = load<kMode>(kh + i);
  __syncthreads();

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int p = blockIdx.z;
  if (x >= W) return;
  const int half = taps / 2;
  const size_t plane = (size_t)H * W;
  const float* row = q + (size_t)p * 3 * plane + (size_t)y * W;
  const size_t gplane = (size_t)H * half;
  const size_t goff = (size_t)p * 3 * gplane + (size_t)y * half;
  float acc[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (x >= half && x + half < W) {
    const float* src = row + (x - half);
    for (int t = 0; t < taps; ++t) tap7<kMode>(acc, sk, taps, t, src + t, plane);
  } else {
    for (int t = 0; t < taps; ++t) {
      const int xi = x - half + t;
      if (kSlabs && xi < 0) {
        tap7<kMode>(acc, sk, taps, t, left + goff + (xi + half), gplane);
      } else if (kSlabs && xi >= W) {
        tap7<kMode>(acc, sk, taps, t, right + goff + (xi - W), gplane);
      } else {
        tap7<kMode>(acc, sk, taps, t, row + (kSlabs ? xi : mirror(xi, W)), plane);
      }
    }
  }
  float* out = t7 + (size_t)p * 7 * plane + (size_t)y * W + x;
#pragma unroll
  for (int f = 0; f < 7; ++f) out[f * plane] = kMode == kSplit ? split_pack(acc[f]) : acc[f];
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
vpass_de_kernel(const float* __restrict__ t7, const float* __restrict__ target,
                const float* __restrict__ kv, int taps, int pop, int H, int W, float wp0,
                float wp1, float wp2, int kind, float* __restrict__ partials) {
  extern __shared__ float sk[];  // 7 * taps
  __shared__ float warp_sums[kThreads / 32];
  __shared__ const float* image_target;
  if (threadIdx.x == 0) image_target = target + (size_t)(blockIdx.z / pop) * 3 * H * W;
  for (int i = threadIdx.x; i < 7 * taps; i += blockDim.x) sk[i] = load<kMode>(kv + i);
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
        // split mode: t7 already holds the pairs
        const float v = kMode == kSplit ? r[f * plane] : load<kMode>(r + f * plane);
        acc[f] = fma_packed<kMode>(sk[f * taps + t], v, acc[f]);
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
  block_sum(de, warp_sums, partials + ((size_t)p * gridDim.y + y) * gridDim.x + blockIdx.x);
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

// one call's arguments, as the C entry point takes them
struct Call {
  const float *q, *left, *right, *target, *kh, *kv;
  int taps, pop, H, W, rows_per_block;
  float wp0, wp1, wp2;
  int kind;
  float *t7, *partials;
  dim3 grid;
  size_t smem;
  cudaStream_t stream;
};

template <int kTaps, int kMode, bool kSlabs>
int launch_fused(const Call& a, const DefaultTaps& dt, const DefaultTaps& dtl) {
  auto kernel = fused_kernel<kTaps, kMode, kSlabs>;
  // the dynamic shared memory this variant may use on each device, raised
  // only when a launch needs more (not set again on every launch)
  static std::atomic<int> allowed[kMaxDevices];
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err == 0 && dev >= kMaxDevices) err = (int)cudaErrorInvalidDevice;
  if (err == 0 && (int)a.smem > allowed[dev].load()) {
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)a.smem);
    if (err == 0) allowed[dev].store((int)a.smem);
  }
  if (err != 0) {
    cudaGetLastError();  // leave no error behind for the next launch to report
    return err;
  }
  kernel<<<a.grid, kThreads, a.smem, a.stream>>>(a.q, a.left, a.right, a.target, a.kh, a.kv, dt,
                                                 dtl, a.taps, a.pop, a.H, a.W, a.rows_per_block,
                                                 a.wp0, a.wp1, a.wp2, a.kind, a.partials);
  return (int)cudaGetLastError();
}

template <int kTaps, int kMode>
int launch_fused_mode(const Call& a, const DefaultTaps& dt, const DefaultTaps& dtl) {
  return a.left != nullptr ? launch_fused<kTaps, kMode, true>(a, dt, dtl)
                           : launch_fused<kTaps, kMode, false>(a, dt, dtl);
}

template <int kTaps>
int launch_fused_variant(int mode, const Call& a, const DefaultTaps& dt, const DefaultTaps& dtl) {
  if (mode == kBf16) return launch_fused_mode<kTaps, kBf16>(a, dt, dtl);
  if (mode == kSplit) return launch_fused_mode<kTaps, kSplit>(a, dt, dtl);
  return launch_fused_mode<kTaps, kFp32>(a, dt, dtl);
}

template <int kMode>
int launch_two_pass(const Call& a) {
  if (a.left != nullptr) {
    hpass_kernel<kMode, true><<<a.grid, kThreads, a.smem, a.stream>>>(a.q, a.left, a.right, a.kh,
                                                                      a.taps, a.H, a.W, a.t7);
  } else {
    hpass_kernel<kMode, false><<<a.grid, kThreads, a.smem, a.stream>>>(a.q, a.left, a.right, a.kh,
                                                                       a.taps, a.H, a.W, a.t7);
  }
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  vpass_de_kernel<kMode><<<a.grid, kThreads, a.smem, a.stream>>>(
      a.t7, a.target, a.kv, a.taps, a.pop, a.H, a.W, a.wp0, a.wp1, a.wp2, a.kind, a.partials);
  return (int)cudaGetLastError();
}

}  // namespace

// q (members, 3, H, W) opponent images, members = B * pop (image-major);
// left, right: null (mirror at both column borders), or the (members, 3, H,
// taps / 2) column guards of a shard (B2s: what lies left of column 0 and
// right of column W - 1); target (B, 3, H, W) LAB, one per image; kh, kv
// (7, taps) horizontal / vertical filter stacks on the device; host_taps:
// at the default 21 taps on the fused path, the same two stacks on the host
// (kh then kv, 294 floats, already rounded to bf16 in bf16 mode; in split
// mode 588 floats, the two stacks' hi parts, then their lo parts), which the
// kernel takes as FMA operands; else null. The plan (ops/fused_fitness.py
// fused_plan): rows_per_block, the fused kernel's segment, a positive
// multiple of 32, or 0 for the two-pass path (which then needs the t7
// (members, 7, H, W) scratch); smem_bytes, a block's dynamic shared memory;
// n_partials, the blocks of a member. partials: (members, n_partials)
// scratch; sums (members,) output. All f32 contiguous. kind: 0 CIE76, 1
// CIE94, 2 CIEDE2000; mode: 0 fp32, 1 bf16 (round the conv operands to
// bf16), 2 split (the TPU's f32x3). Needs taps odd, taps / 2 < H, without
// guards taps / 2 < W. Returns the first non-zero CUDA error of the launches.
extern "C" int hq_fused_err_sums(const float* q, const float* left, const float* right,
                                 const float* target, const float* kh, const float* kv,
                                 const float* host_taps, int taps, int members, int pop, int H,
                                 int W, float wp0, float wp1, float wp2, int kind, int mode,
                                 int rows_per_block, int smem_bytes, int n_partials, float* t7,
                                 float* partials, float* sums, void* stream) {
  const bool slabs = left != nullptr;
  const bool fused = rows_per_block > 0;
  if (members <= 0 || pop <= 0 || members % pop != 0 || H <= 0 || W <= 0 || taps <= 0 ||
      taps % 2 == 0 || taps / 2 >= H || (!slabs && taps / 2 >= W) || slabs != (right != nullptr) ||
      kind < 0 || kind > 2 || mode < kFp32 || mode > kSplit || members > 65535 ||
      rows_per_block < 0 || rows_per_block % kTileH != 0 || smem_bytes < 0 ||
      (size_t)smem_bytes > kMaxSmem || (host_taps != nullptr) != (fused && taps == kDefaultTaps))
    return (int)cudaErrorInvalidValue;
  const dim3 grid = fused ? dim3((W + kTileW - 1) / kTileW, (H + rows_per_block - 1) / rows_per_block,
                                 members)
                          : dim3((W + kThreads - 1) / kThreads, H, members);
  if (grid.y > 65535 || (long long)grid.x * grid.y != n_partials) return (int)cudaErrorInvalidValue;
  const Call a = {q, left, right, target, kh, kv, taps, pop, H, W, rows_per_block, wp0, wp1, wp2,
                  kind, t7, partials, grid, (size_t)smem_bytes, (cudaStream_t)stream};
  int err = 0;
  if (fused) {
    DefaultTaps dt = {}, dtl = {};
    if (host_taps != nullptr) {
      const int stack = 2 * 7 * kDefaultTaps;  // kh then kv
      for (int f = 0; f < 7; ++f)
        for (int t = 0; t < kDefaultTaps; ++t) {
          dt.h[f][t] = host_taps[f * kDefaultTaps + t];
          dt.v[f][t] = host_taps[(7 + f) * kDefaultTaps + t];
          if (mode == kSplit) {
            dtl.h[f][t] = host_taps[stack + f * kDefaultTaps + t];
            dtl.v[f][t] = host_taps[stack + (7 + f) * kDefaultTaps + t];
          }
        }
    }
    err = host_taps != nullptr ? launch_fused_variant<kDefaultTaps>(mode, a, dt, dtl)
                               : launch_fused_variant<0>(mode, a, dt, dtl);
  } else {
    err = mode == kBf16 ? launch_two_pass<kBf16>(a)
                        : (mode == kSplit ? launch_two_pass<kSplit>(a) : launch_two_pass<kFp32>(a));
  }
  if (err != 0) return err;
  reduce_kernel<<<members, kReduceThreads, 0, (cudaStream_t)stream>>>(partials, n_partials, sums);
  return (int)cudaGetLastError();
}
