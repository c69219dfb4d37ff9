// B2's split mode on the tensor cores: fused S-CIELAB Delta-E sums for a
// population of quantized images in the TPU kernel's f32x3 arithmetic.
//
// Replaces the TPU kernel hybridquantization_tpu/ops/fused_fitness.py at
// precision "f32x3" (_fused_kernel, :296-450, its three dots a filter and
// pass at :384-396 and :419-426; pallas_call in fused_scielab_err_sums,
// :597) up to ops/fused_fitness.MAX_FUSED_TAPS taps; above that the
// two-pass kernels of fused_fitness.cu run split mode. The function is
// fused_fitness.cu's (see its header): seven separable filters a pass with
// half-sample reflection at the true image borders, or B2s's column guards
// by index; o0 = y0 + y3 + y6, o1 = y1 + y4, o2 = y2 + y5; Opp -> LAB;
// Delta-E against the target; summed per member, the members of a bucket
// over grid z. The arithmetic is the TPU's f32x3: every conv operand split
// into bf16 hi = bf16(x) and lo = bf16(x - hi); each filter and pass the
// three products hi.hi + lo.hi + hi.lo of samples and taps (lo.lo dropped)
// into one f32 accumulator; the horizontal output split again into its
// hi/lo pair (the TPU's t7a/t7b) for the vertical pass. A product of two
// bf16 values is exact in f32, so each term is a bf16 tensor-core product
// with f32 accumulation, and this kernel runs them as such (wgmma, the
// helpers of wgmma.cuh).
//
// What bounds it on the H100: the bytes. The useful work, 7 filters x taps
// x 3 products x 2 passes per member pixel (882 multiply-adds at the
// default 21 taps), takes 0.059 ms at 4K/pop4 at the dense bf16 rate; the
// opponent images and the target, read once, 0.149 ms. A band product
// multiplies whole tiles, taps wide bands included (the useful share taps
// / Kp = 21/96 in the horizontal pass and 21/64 in the vertical one), and
// each step takes its main product twice (add_steps) and, for the four
// filters with a tail, two more: 7488 multiply-adds a member pixel at 21
// taps, 0.50 ms at 4K/pop4 at the dense rate. The design (tile sizes and
// why):
//  - a block is one warpgroup on a strip of 64 output columns (wgmma's M)
//    and a segment of rows_per_block rows (the wrapper's plan; a multiple
//    of 64), walked in tiles of 64 x 64 output pixels;
//  - per tile and channel, the window the channel's filters read (Kp =
//    16 ceil((63 + taps) / 16) columns, nh rows) is staged into shared
//    memory as bf16 hi and lo in wgmma's K-major layout, each sample split
//    once: its f32 rows come 16 at a time by cp.async (lanes along a row,
//    the mirror at the true borders and B2s's guards resolved by index), two
//    pieces in flight, the first two copied while the last channel's
//    products run; a pass over each piece splits it into the layout;
//  - horizontal pass, transposed: D_h (64 output columns x 32 intermediate
//    rows, wgmma m64n32k16, a chunk of the nh rows) = T (64 x Kp, the band,
//    T[m][k] = tap[k - m]) x X (Kp x 32, the staged window), both operands
//    from shared memory;
//  - the chunk's output, split into hi and lo bf16 in registers, is
//    already the vertical pass's A operand for two of its steps (its
//    columns of 8 rows are the A fragment's contraction halves): the
//    intermediate never leaves the registers;
//  - vertical pass: D_v (64 output columns x 32 output rows) = I (64 x 16
//    intermediate rows a step) x V (16 x 32, V[k][n] = vtap[k - n]); each
//    chunk of 32 output rows takes only the steps its taps reach (Kp / 16
//    - 2: 4 of the 6 at 21 taps);
//  - the sums, step by step (add_steps): the tensor cores chop each term of
//    a sum to 2^-25 of the sum's largest term and round the sum toward zero
//    (measured on this card), always the same way, and a bias of an ulp in
//    the outputs moves a frame's Delta-E sums by more than B2's limit (on
//    B1's winners; PERF.md). So no output is taken from a sum they round at
//    its own scale: a step's main product P (the taps' hi part without its
//    tail, the taps under 2^-8 of the filter's largest, whose low bits the
//    chop would take), then R = (-P + the same product) + the rest (the
//    tail, and the products with a lo part), which cancels to P's
//    remainder, are each added to the output in f32 rounded to nearest;
//    that is 4 to 6 products a step where the TPU has 3, and a wait a step;
//  - the bands: every 8 x 8 core matrix of a band is one of a few, C[d][i][j]
//    = tap[8 d + j - i], so one table of them a filter and part (core, tail
//    and lo) serves every step and chunk through descriptors whose two
//    strides are both one core matrix; the contraction halves of a step are
//    swapped in both operands, so that the table's index grows along both
//    strides (core matrix (r, h) of step s is table entry top - 2s - 1 + h +
//    r). A vertical table is a stretch of the horizontal one where the
//    filter's vertical taps are its horizontal ones (every filter but |k3|'s
//    where k3 changes sign), so only the others take room. The wrapper
//    builds the tables (ops/fused_fitness.band_tables); a block copies them
//    into shared memory once;
//  - registers: o0, o1, o2 (the tile's recombined outputs, 96), the filter's
//    y (32), a horizontal chunk (16), its split (16) and add_steps' two
//    accumulators (32), which is why the products are 32 wide; two blocks
//    (8 warps) fit an SM, by registers and by shared memory (102.5 KiB at 21
//    taps with one vertical table of its own);
//  - the tail is fused_fitness.cu's formulas (delta_e.cuh), a quarter tile
//    at a time through shared memory (so that a thread's 8 pixels are
//    independent and the target is read along rows), the kernel compiled
//    for one Delta-E formula, and the divisions by the whitepoint and 116
//    by the fast path of IEEE division (delta_e.cuh div_fast_path: no range
//    check's branch at every division).
//    Then the block's pixels are summed in a fixed order into one partial,
//    and fitness_common.cuh's double-precision reduce follows, so a launch
//    is bit-equal to itself and an image in a bucket to the same image
//    alone (the plan depends only on H, W and taps).
// A step's products wait for the step before (add_steps), and a tile's
// staging, products and tail run one after another in a block; the SM's
// two blocks overlap them only where one waits while the other runs.
// The outputs are the same exact products summed in another order than the
// plain version's (which adds each tap's three in ascending order), rounded
// to nearest: they agree to a few f32 ulps of each output, not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

#include "delta_e.cuh"
#include "fitness_common.cuh"
#include "wgmma.cuh"

namespace {

using namespace hq;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kTile = 64;      // output columns of a strip (wgmma M), output rows of a tile
constexpr int kChunk = 32;     // rows of a product: intermediate (horizontal), output (vertical)
constexpr int kPiece = 16;     // window rows staged at a time (a piece), in f32
constexpr int kSlots = 2;      // pieces in flight: one converts while the next lands
constexpr int kCore = 128;     // bytes of an 8 x 8 core matrix of bf16
constexpr int kMaxTaps = 97;   // ops/fused_fitness.MAX_FUSED_TAPS
constexpr size_t kMaxSmem = 232448;
constexpr int kMaxDevices = 64;
// the tail's row stride (floats) in shared memory: 4 mod 32, so that each
// store of a warp's outputs falls on 32 distinct banks (8 (lane % 4) +
// lane / 4, up to a constant)
constexpr int kTailStride = 68;
static_assert(3 * 16 * kTailStride * 4 <= 4 * 64 * 64, "a quarter's o0-o2 fit the smallest staging buffers");

// The layout for `taps` and `vtables` vertical tables of their own
// (ops/fused_fitness.band_plan mirrors it): a pass's contraction in `steps`
// steps of 16, Kp = 16 steps staged columns (and intermediate rows read by
// the vertical pass), nh staged rows (chunks of 32 covering the steps), the
// core matrices of a horizontal and of a vertical band table (one filter
// and part), and the shared bytes: the staged window's hi and lo, then the
// tables (the seven filters' horizontal ones, then the vertical ones that
// are not read from them; each filter's three parts: core, tail, lo), then
// kSlots pieces of kPiece f32 window rows.
struct Layout {
  int half, steps, kp, nh, hcores, vcores, cores;
  size_t smem;
};

__host__ __device__ inline Layout layout(int taps, int vtables) {
  Layout l;
  l.half = taps / 2;
  l.steps = (63 + taps + 15) / 16;
  l.kp = 16 * l.steps;
  l.nh = kChunk * ((l.steps + 1) / 2);
  l.hcores = 2 * l.steps + 7;
  l.vcores = 2 * l.steps - 1;
  l.cores = 3 * (7 * l.hcores + vtables * l.vcores);
  l.smem = (size_t)4 * l.kp * l.nh + (size_t)kCore * l.cores + (size_t)4 * kSlots * kPiece * (l.kp + 4);
  return l;
}

// Where each filter's vertical table lies among the tables (in core
// matrices: its core part at base[f], tail and lo stride[f] further on
// each), and which filters have a tail (bit f: horizontal, bit 7 + f:
// vertical); ops/fused_fitness.band_tables.
struct VMap {
  int base[7];
  int stride[7];
  int tails;
};

// Two values' bf16 splits as packed pairs (the first value in the low
// half): hi = bf16(v), lo = bf16(v - hi), as split() does one at a time.
__device__ __forceinline__ void split2(float2 v, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __float22bfloat162_rn(v);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __float22bfloat162_rn(make_float2(__fsub_rn(v.x, hf.x), __fsub_rn(v.y, hf.y)));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The f32 rows of a piece of the window: raw row n (n < kPiece) holds
// channel plane row rows0 + mirror(yw + n), columns x0 - half + k (k < Kp)
// at raw[n x (Kp + 4) + k], copied with cp.async (lanes along the row, so
// a warp's copies are 128 contiguous bytes) as one commit group. Rows
// mirror at the true borders (clamped beyond, for outputs never summed);
// columns mirror too, or come from the guards (B2s); a guard of no columns
// (taps 1) is never read by an output that is summed.
template <bool kSlabs>
__device__ __forceinline__ void copy_piece(float* raw, const float* q, const float* left,
                                           const float* right, size_t rows0, int H, int W,
                                           const Layout& lay, int x0, int yw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int xs = x0 - lay.half;
  const bool inside = xs >= 0 && xs + lay.kp <= W;  // no column mirrored or from a guard
  for (int n = warp; n < kPiece; n += kThreads / 32) {
    const size_t r = rows0 + mirror_clamped(yw + n, H);  // (member, channel, row)
    const float* qrow = q + r * W;
    float* dst = raw + (size_t)n * (lay.kp + 4);
    for (int k = lane; k < lay.kp; k += 32) {
      const int x = xs + k;
      const float* src;
      if (inside) {
        src = qrow + x;
      } else if (kSlabs && x < 0 && lay.half > 0) {
        src = left + r * lay.half + max(x + lay.half, 0);
      } else if (kSlabs && x >= W && lay.half > 0) {
        src = right + r * lay.half + min(x - W, lay.half - 1);
      } else {
        src = qrow + (kSlabs ? min(max(x, 0), W - 1) : mirror_clamped(x, W));
      }
      cp_async4(dst + k, src);
    }
  }
  cp_async_commit();
}

// The piece's rows, split into bf16 hi and lo, to window rows n0 + n of the
// staging buffers: (row n, column k) at 16-byte unit (k / 16) x nh x 2 +
// (n / 8) x 16 + (1 - (k / 8) % 2) x 8 + n % 8, byte (k % 8) x 2 (the
// contraction halves swapped, module doc). A thread takes 8 columns of a
// row: two 16-byte loads (a quarter warp's 8 rows on distinct banks, the
// row stride being 4 mod 32 words) and one 16-byte store to each buffer (a
// quarter warp's 8 rows of one core matrix, 128 contiguous bytes).
__device__ __forceinline__ void convert_piece(uint4* xh, uint4* xl, const float* raw,
                                              const Layout& lay, int n0) {
  const int kb8 = lay.kp / 8;
  for (int u = threadIdx.x; u < kPiece * kb8; u += kThreads) {
    const int i = u & 7;
    const int kb = (u >> 3) % kb8;
    const int n = ((u >> 3) / kb8) * 8 + i;
    const float4* src = reinterpret_cast<const float4*>(raw + (size_t)n * (lay.kp + 4) + 8 * kb);
    const float4 a = src[0], b = src[1];
    const float2 v[4] = {{a.x, a.y}, {a.z, a.w}, {b.x, b.y}, {b.z, b.w}};
    uint32_t h[4], l[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) split2(v[j], h[j], l[j]);
    const int row = n0 + n;
    const size_t at = (size_t)(kb >> 1) * lay.nh * 2 + (row >> 3) * 16 + (1 - (kb & 1)) * 8 + i;
    xh[at] = make_uint4(h[0], h[1], h[2], h[3]);
    xl[at] = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// The window of a channel (rows yw + n, n < nh, of the member's channel
// plane from rows0; columns x0 - half + k, k < Kp) flows through kSlots f32
// pieces of kPiece rows. Piece pc goes to slot pc % kSlots; the caller
// issues the first kSlots pieces (prefetch) while the last channel's
// products run, and stage_channel the rest as slots free up.
struct Window {
  float* raw;  // the slots
  size_t rows0;
  int yw;
};

template <bool kSlabs>
__device__ __forceinline__ void copy_window_piece(const Window& win, int pc, const float* q,
                                                  const float* left, const float* right, int H,
                                                  int W, const Layout& lay, int x0) {
  copy_piece<kSlabs>(win.raw + (size_t)(pc % kSlots) * kPiece * (lay.kp + 4), q, left, right,
                     win.rows0, H, W, lay, x0, win.yw + pc * kPiece);
}

template <bool kSlabs>
__device__ __forceinline__ void prefetch_window(const Window& win, const float* q, const float* left,
                                                const float* right, int H, int W, const Layout& lay,
                                                int x0) {
  for (int pc = 0; pc < kSlots; ++pc) copy_window_piece<kSlabs>(win, pc, q, left, right, H, W, lay, x0);
}

// The window, its first kSlots pieces already issued, into the staging
// buffers as bf16 hi and lo: piece by piece, each slot refilled with the
// piece kSlots further on once converted. Ends with the buffers written
// for the async proxy and every thread past them.
template <bool kSlabs>
__device__ __forceinline__ void stage_channel(uint4* xh, uint4* xl, const Window& win, const float* q,
                                              const float* left, const float* right, int H, int W,
                                              const Layout& lay, int x0) {
  const int pieces = lay.nh / kPiece;
  static_assert(kSlots == 2, "the waits below keep one piece in flight");
  for (int pc = 0; pc < pieces; ++pc) {
    if (pc + 1 < pieces) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // piece pc has landed
    convert_piece(xh, xl, win.raw + (size_t)(pc % kSlots) * kPiece * (lay.kp + 4), lay, pc * kPiece);
    __syncthreads();  // its slot is free
    if (pc + kSlots < pieces) copy_window_piece<kSlabs>(win, pc + kSlots, q, left, right, H, W, lay, x0);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// out += the sums S_i = M_i + E_i of n steps, M_i the step's main product
// (`main(d, scale_d, i)`: the core of the taps' hi part with the samples' hi
// part) and E_i its small ones (`rest(d, i)`, issued adding: the tail of the
// taps' hi part, the products with the samples' lo part and the taps' lo
// part). The tensor cores chop every term of a sum to 2^-25 of its largest
// and round the sum toward zero, so S_i is never taken from a sum they
// round at its own scale: P_i = M_i alone; then R_i = (-P_i + M_i) + E_i,
// whose first terms cancel to the remainder of P_i, so that R_i is small
// beside S_i and so are its chops and its rounding; out += P_i, then out
// += R_i, each rounded to nearest on the CUDA cores. The taps' tail (hi
// parts under 2^-8 of the filter's largest) is kept out of M_i, where the
// chop would take its low bits. P_{i+1} runs beside R_i: n + 1 waits.
template <class Main, class Rest>
__device__ __forceinline__ void add_steps(float (&out)[16], float (&p)[16], float (&r)[16], int n, Main main,
                                          Rest rest) {
  if (n <= 0) return;
  wgmma_fence();
  main(p, 0, 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(p);
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      r[e] = -p[e];
      out[e] = __fadd_rn(out[e], p[e]);
    }
    fence_regs(r);
    fence_regs(p);
    wgmma_fence();
    main(r, 1, i);
    rest(r, i);
    if (i + 1 < n) main(p, 0, i + 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(r);
    fence_regs(p);
#pragma unroll
    for (int e = 0; e < 16; ++e) out[e] = __fadd_rn(out[e], r[e]);
  }
}

// A filter's band table in one pass: the descriptors of its three parts.
struct Band {
  uint64_t core, tail, lo;
  bool has_tail;
};

// The horizontal pass of chunk j (intermediate rows 32 j .. 32 j + 31)
// into h (zeroed here), its steps through add_steps; the band's step s at
// table entry 2 steps - 2 - 2s (16-byte units: 8 an entry). p, r:
// add_steps' accumulators.
__device__ __forceinline__ void hpass_chunk(float (&h)[16], float (&p)[16], float (&r)[16], uint64_t xh,
                                            uint64_t xl, const Band& t, const Layout& lay, int j) {
#pragma unroll
  for (int i = 0; i < 16; ++i) h[i] = 0.0f;
  auto xs = [&](int s) { return (uint64_t)j * 64 + (uint64_t)s * lay.nh * 2; };
  auto ts = [&](int s) { return (uint64_t)(lay.steps - 1 - s) * 16; };
  add_steps(
      h, p, r, lay.steps, [&](float(&d)[16], int scale, int s) { wgmma_n32_ss(d, t.core + ts(s), xh + xs(s), scale); },
      [&](float(&d)[16], int s) {
        if (t.has_tail) {
          wgmma_n32_ss(d, t.tail + ts(s), xh + xs(s), 1);
          wgmma_n32_ss(d, t.tail + ts(s), xl + xs(s), 1);
        }
        wgmma_n32_ss(d, t.core + ts(s), xl + xs(s), 1);
        wgmma_n32_ss(d, t.lo + ts(s), xh + xs(s), 1);
      });
}

// Chunk j's horizontal output (64 output columns x 32 intermediate rows)
// as the vertical pass's A fragments of steps 2j + r, split into hi (ih)
// and lo (il): its columns of 8 rows 2r + 1 and 2r are step r's
// contraction halves 0 and 1 (the swapped order of the band tables).
__device__ __forceinline__ void split_fragments(const float (&d)[16], uint32_t (&ih)[2][4],
                                                uint32_t (&il)[2][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // rows g and g + 8 of the warp's columns
        const int v = 4 * (2 * r + 1 - h) + 2 * e;
        split2(make_float2(d[v], d[v + 1]), ih[r][2 * h + e], il[r][2 * h + e]);
      }
}

// The vertical pass's steps 2j and 2j + 1 into the output chunks cc whose
// steps [2 cc, 2 cc + steps - 2) hold them (add_steps: none, step 2j, or
// both, the range's lower end being even), the band of chunk cc's step s
// at table entry 2 steps - 6 - 2s + 4 cc.
__device__ __forceinline__ void vpass_steps(float (&y)[2][16], float (&p)[16], float (&r)[16],
                                            const uint32_t (&ih)[2][4], const uint32_t (&il)[2][4],
                                            const Band& v, const Layout& lay, int j) {
#pragma unroll
  for (int cc = 0; cc < 2; ++cc) {
    const int end = 2 * cc + lay.steps - 2;
    const int n = 2 * j < 2 * cc || 2 * j >= end ? 0 : (2 * j + 1 < end ? 2 : 1);
    auto o = [&](int k) { return (uint64_t)(2 * lay.steps - 6 - 2 * (2 * j + k) + 4 * cc) * 8; };
    add_steps(
        y[cc], p, r, n,
        [&](float(&d)[16], int scale, int k) {
          if (k == 0) {
            wgmma_n32(d, ih[0], v.core + o(0), scale);
          } else {
            wgmma_n32(d, ih[1], v.core + o(1), scale);
          }
        },
        [&](float(&d)[16], int k) {
          if (k == 0) {
            if (v.has_tail) {
              wgmma_n32(d, ih[0], v.tail + o(0), 1);
              wgmma_n32(d, il[0], v.tail + o(0), 1);
            }
            wgmma_n32(d, il[0], v.core + o(0), 1);
            wgmma_n32(d, ih[0], v.lo + o(0), 1);
          } else {
            if (v.has_tail) {
              wgmma_n32(d, ih[1], v.tail + o(1), 1);
              wgmma_n32(d, il[1], v.tail + o(1), 1);
            }
            wgmma_n32(d, il[1], v.core + o(1), 1);
            wgmma_n32(d, ih[1], v.lo + o(1), 1);
          }
        });
  }
}

// One filter of the staged channel, both passes, into y (output rows 32 cc
// .. 32 cc + 31 of the tile in y[cc]; zero on entry), a chunk of 32
// intermediate rows at a time: its horizontal pass, split into the
// vertical pass's A fragments in registers, then the vertical steps they
// hold. x*: the staged window's descriptors; t, v: the filter's horizontal
// and vertical bands.
__device__ __forceinline__ void filter(float (&y)[2][16], uint64_t xh, uint64_t xl, const Band& t, const Band& v,
                                       const Layout& lay) {
  float h[16], p[16], r[16];
  uint32_t ih[2][4], il[2][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) p[i] = r[i] = 0.0f;
  for (int j = 0; j < lay.nh / kChunk; ++j) {
    hpass_chunk(h, p, r, xh, xl, t, lay, j);
    split_fragments(h, ih, il);
    vpass_steps(y, p, r, ih, il, v, lay, j);
  }
}

// One pixel's Delta-E: its filtered opponent values to LAB, against the
// target's (L, a, b), by the formula kKind (a kernel parameter, so only one
// formula is compiled into a kernel); the divisions by their fast path
// (delta_e.cuh div_fast_path: equal to IEEE division on these ranges).
template <int kKind>
__device__ __forceinline__ float pixel_de(float o0, float o1, float o2, float tl, float ta, float tb,
                                          float wp0, float wp1, float wp2) {
  float L, a, b;
  hq::opp_to_lab<true>(o0, o1, o2, wp0, wp1, wp2, L, a, b);
  return hq::delta_e(kKind, tl, ta, tb, L, a, b);
}

// CIEDE2000 is several times longer than the other two: called, not
// inlined into each of a thread's 32 pixels, where 32 copies would crowd
// the instruction cache.
__device__ __noinline__ float pixel_de2000(float o0, float o1, float o2, float tl, float ta, float tb,
                                           float wp0, float wp1, float wp2) {
  return pixel_de<hq::kCIEDE2000>(o0, o1, o2, tl, ta, tb, wp0, wp1, wp2);
}

// One block: member blockIdx.z, output columns [64 blockIdx.x, + 64), rows
// [rows_per_block blockIdx.y, + rows_per_block). bands: the band tables
// (ops/fused_fitness.band_tables), vtables vertical ones of their own, laid
// out by vmap. kKind: the Delta-E formula (hq::DeltaEKind).
template <bool kSlabs, int kKind>
__global__ void __launch_bounds__(kThreads, 2)
band_kernel(const float* __restrict__ q, const float* __restrict__ left,
            const float* __restrict__ right, const float* __restrict__ target,
            const uint4* __restrict__ bands, const __grid_constant__ VMap vmap, int vtables, int taps,
            int pop, int H, int W, int rows_per_block, float wp0, float wp1, float wp2,
            float* __restrict__ partials) {
  extern __shared__ __align__(128) uint4 smem[];
  __shared__ float warp_sums[kThreads / 32];
  const Layout lay = layout(taps, vtables);
  const size_t stage = (size_t)lay.kp * lay.nh / 8;  // 16-byte units of a staging buffer
  uint4* xh = smem;
  uint4* xl = xh + stage;
  uint4* tables = xl + stage;  // [7][3][hcores], then [vtables][3][vcores]
  float* raw = reinterpret_cast<float*>(tables + lay.cores * 8);  // [kSlots][kPiece][Kp + 4]
  for (int i = threadIdx.x; i < lay.cores * 8; i += kThreads)
    cp_async16(tables + i, bands + i);  // waited for by the staging

  const int p = blockIdx.z;
  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * rows_per_block;
  const int y_end = min(y0 + rows_per_block, H);
  const size_t plane = (size_t)H * W;
  const float* tgt = target + (size_t)(p / pop) * 3 * plane;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const uint64_t dxh = kmajor_desc(xh, 128, 256), dxl = kmajor_desc(xl, 128, 256);
  float de = 0.0f;
  // the first pieces of each channel's window are copied ahead, while the
  // previous channel's products (or the last tile's tail) run
  auto window = [&](int ty, int c) { return Window{raw, (size_t)(p * 3 + c) * H, ty - lay.half}; };
  prefetch_window<kSlabs>(window(y0, 0), q, left, right, H, W, lay, x0);
  for (int ty = y0; ty < y_end; ty += kTile) {
    float o[3][2][16];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc)
#pragma unroll
        for (int i = 0; i < 16; ++i) o[c][cc][i] = 0.0f;
#pragma unroll 1
    for (int c = 0; c < 3; ++c) {
      __syncthreads();  // the last channel's products are done with the staging buffers
      stage_channel<kSlabs>(xh, xl, window(ty, c), q, left, right, H, W, lay, x0);
      if (c < 2) {
        prefetch_window<kSlabs>(window(ty, c + 1), q, left, right, H, W, lay, x0);
      } else if (ty + kTile < y_end) {
        prefetch_window<kSlabs>(window(ty + kTile, 0), q, left, right, H, W, lay, x0);
      }
#pragma unroll 1
      for (int f = c; f < 7; f += 3) {  // the filters of channel c (SRC7 = 0, 1, 2, 0, 1, 2, 0)
        const uint4* hf = tables + (size_t)3 * f * lay.hcores * 8;
        const uint4* vf = tables + (size_t)vmap.base[f] * 8;
        const int vs = vmap.stride[f] * 8;
        const Band tb = {kmajor_desc(hf, kCore, kCore), kmajor_desc(hf + lay.hcores * 8, kCore, kCore),
                         kmajor_desc(hf + 2 * lay.hcores * 8, kCore, kCore), ((vmap.tails >> f) & 1) != 0};
        const Band vb = {kmajor_desc(vf, kCore, kCore), kmajor_desc(vf + vs, kCore, kCore),
                         kmajor_desc(vf + 2 * vs, kCore, kCore), ((vmap.tails >> (7 + f)) & 1) != 0};
        float y[2][16];
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
#pragma unroll
          for (int i = 0; i < 16; ++i) y[cc][i] = 0.0f;
        filter(y, dxh, dxl, tb, vb, lay);
        // o0 = (y0 + y3) + y6, o1 = y1 + y4, o2 = y2 + y5
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            if (c == 0) {
              o[0][cc][i] += y[cc][i];
            } else if (c == 1) {
              o[1][cc][i] += y[cc][i];
            } else {
              o[2][cc][i] += y[cc][i];
            }
          }
      }
    }
    // the tail, a quarter of the tile (16 output rows) at a time: the quarter's o0, o1, o2
    // through shared memory (the staging buffers, done with once every product is waited
    // for), then each thread's 8 pixels of it, independent, the target read along rows
    float* ot = reinterpret_cast<float*>(xh);  // [3][16][kTailStride]
#pragma unroll
    for (int qr = 0; qr < 4; ++qr) {
      __syncthreads();  // every warp's products, or the last quarter's pixels, are done
#pragma unroll
      for (int i = 0; i < 8; ++i) {  // this thread's outputs of the quarter, n = 2 (qr % 2) + i / 4
        const int v = 8 * (qr & 1) + i;
        const int col = 16 * warp + g + 8 * ((v >> 1) & 1);
        const int row = 8 * ((v >> 2) & 1) + 2 * t + (v & 1);
#pragma unroll
        for (int c = 0; c < 3; ++c) ot[(c * 16 + row) * kTailStride + col] = o[c][qr >> 1][v];
      }
      __syncthreads();
      float tv[3][8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // pixel (row 2j + threadIdx.x / 64, column threadIdx.x % 64)
        const int x = x0 + (threadIdx.x & 63);
        const int y = ty + 16 * qr + 2 * j + (threadIdx.x >> 6);
        const float* tp = tgt + (size_t)y * W + x;
#pragma unroll
        for (int k = 0; k < 3; ++k) tv[k][j] = x < W && y < y_end ? __ldg(tp + k * plane) : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int x = x0 + (threadIdx.x & 63);
        const int y = ty + 16 * qr + 2 * j + (threadIdx.x >> 6);
        const float* op = ot + (2 * j + (threadIdx.x >> 6)) * kTailStride + (threadIdx.x & 63);
        if (x < W && y < y_end)
          de += kKind == hq::kCIEDE2000
                    ? pixel_de2000(op[0], op[16 * kTailStride], op[32 * kTailStride], tv[0][j],
                                   tv[1][j], tv[2][j], wp0, wp1, wp2)
                    : pixel_de<kKind>(op[0], op[16 * kTailStride], op[32 * kTailStride], tv[0][j],
                                      tv[1][j], tv[2][j], wp0, wp1, wp2);
      }
    }
  }
  block_sum(de, warp_sums,
            partials + ((size_t)p * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x);
}

// one call's arguments, as the C entry point takes them
struct Call {
  const float *q, *left, *right, *target;
  const uint4* bands;
  VMap vmap;
  int vtables, taps, pop, H, W, rows_per_block;
  float wp0, wp1, wp2;
  float* partials;
  dim3 grid;
  size_t smem;
  cudaStream_t stream;
};

template <bool kSlabs, int kKind>
int launch_band(const Call& a) {
  auto kernel = band_kernel<kSlabs, kKind>;
  // the dynamic shared memory this variant may use on each device, raised
  // only when a launch needs more (not set again on every launch)
  static std::atomic<int> allowed[kMaxDevices];
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err == 0 && dev >= kMaxDevices) err = (int)cudaErrorInvalidDevice;
  if (err == 0 && (int)a.smem > allowed[dev].load()) {
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
    if (err == 0) allowed[dev].store((int)a.smem);
  }
  if (err != 0) {
    cudaGetLastError();  // leave no error behind for the next launch to report
    return err;
  }
  kernel<<<a.grid, kThreads, a.smem, a.stream>>>(a.q, a.left, a.right, a.target, a.bands, a.vmap,
                                                 a.vtables, a.taps, a.pop, a.H, a.W, a.rows_per_block,
                                                 a.wp0, a.wp1, a.wp2, a.partials);
  return (int)cudaGetLastError();
}

template <int kKind>
int launch_kind(const Call& a) {
  return a.left != nullptr ? launch_band<true, kKind>(a) : launch_band<false, kKind>(a);
}

}  // namespace

// q (members, 3, H, W) opponent images, members = B * pop (image-major);
// left, right: null (mirror at both column borders), or the (members, 3, H,
// taps / 2) column guards of a shard (B2s); target (B, 3, H, W) LAB, one
// per image; bands: the band tables of kh and kv (ops/fused_fitness.py
// band_tables: (3 (7 hcores + vtables vcores), 8, 8) bf16 core matrices,
// 16-byte aligned, hcores = 2 steps + 7, vcores = 2 steps - 1), vmap: 15
// ints on the host, the VMap of the tables (base[7], stride[7], tails).
// The plan (ops/fused_fitness.py band_plan): rows_per_block, a positive
// multiple of 64; smem_bytes, the layout's; n_partials, the blocks of a
// member. partials: (members, n_partials) f32 scratch; sums (members,) f32
// output. kind: 0 CIE76, 1 CIE94, 2 CIEDE2000. Needs taps odd, at most 97,
// taps / 2 < H, without guards taps / 2 < W. Returns the first non-zero
// CUDA error of the launches.
extern "C" int hq_band_err_sums(const float* q, const float* left, const float* right,
                                const float* target, const void* bands, const int* vmap, int vtables,
                                int taps, int members, int pop, int H, int W, float wp0, float wp1,
                                float wp2, int kind, int rows_per_block, int smem_bytes, int n_partials,
                                float* partials, float* sums, void* stream) {
  const bool slabs = left != nullptr;
  if (members <= 0 || pop <= 0 || members % pop != 0 || H <= 0 || W <= 0 || taps <= 0 ||
      taps % 2 == 0 || taps > kMaxTaps || taps / 2 >= H || (!slabs && taps / 2 >= W) ||
      slabs != (right != nullptr) || kind < 0 || kind > 2 || members > 65535 ||
      rows_per_block <= 0 || rows_per_block % kTile != 0 || bands == nullptr || vmap == nullptr ||
      (uintptr_t)bands % 16 != 0 || vtables < 0 || vtables > 7 || smem_bytes < 0 ||
      (size_t)smem_bytes != layout(taps, vtables).smem || (size_t)smem_bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const Layout lay = layout(taps, vtables);
  VMap vm;
  for (int f = 0; f < 7; ++f) {
    vm.base[f] = vmap[f];
    vm.stride[f] = vmap[7 + f];
    if (vm.base[f] < 0 || vm.stride[f] < lay.vcores || vm.base[f] + 2 * vm.stride[f] + lay.vcores > lay.cores)
      return (int)cudaErrorInvalidValue;
  }
  vm.tails = vmap[14];
  const dim3 grid((W + kTile - 1) / kTile, (H + rows_per_block - 1) / rows_per_block, members);
  if (grid.y > 65535 || (long long)grid.x * grid.y != n_partials) return (int)cudaErrorInvalidValue;
  const Call a = {q, left, right, target, static_cast<const uint4*>(bands), vm, vtables, taps, pop, H, W,
                  rows_per_block, wp0, wp1, wp2, partials, grid, (size_t)smem_bytes, (cudaStream_t)stream};
  const int err = kind == hq::kCIE94 ? launch_kind<hq::kCIE94>(a)
                                     : (kind == hq::kCIEDE2000 ? launch_kind<hq::kCIEDE2000>(a)
                                                               : launch_kind<hq::kCIE76>(a));
  if (err != 0) return err;
  reduce_kernel<<<members, kReduceThreads, 0, a.stream>>>(partials, n_partials, sums);
  return (int)cudaGetLastError();
}
