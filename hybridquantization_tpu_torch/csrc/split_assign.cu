// T4 (at f32x3), T7, T8: the split-bf16 assignment on the tensor cores;
// T3, T5, T6 and T4's `dotmax`: the row max of the same scores (max mode).
//
// Replaces the TPU probes tools/kexp_assign.py make_kernel at precision
// "f32x3" (:67-256, pallas_call in run_variant, :271) and
// tools/minidot_probe.py _mini_full_kernel and _mini_full2_kernel
// (:129-187, pallas_calls at :252, :302); in max mode
// tools/vpu_assign_exp.py make_dotprobe_kernel (:309-333, pallas_call in
// run_dotprobe, :342), make_kernel's `dotmax` and minidot_probe.py
// _dense_kernel and _mini_kernel (:48-81, pallas_calls at :204, :220).
// Per member p, pixel i and
// candidate k the split-bf16 score: each operand split into bf16 hi =
// bf16(a) and lo = bf16(a - hi), and the 12-deep contraction
//   s = [ch; ch; cl] . [xh; xl; xh]   (over the 4 rows of x and c)
// of exact bf16 x bf16 products summed in f32 (pallas_assign.py:144-148,
// :177-188). Then the first index of the max, the winner's colour from 3
// exact bf16 parts (T4, pallas_assign.py:151-159, :279-287) or 2 (T7/T8,
// minidot_probe.py:112-121) and int32 counts per candidate; or, tie mode
// "average" (T4's `avg`), every maximum a hit, the colour the undivided
// sum of the hits' colours in index order, counts the hits. A NaN score
// never wins (nor enters the max); a pixel with no winner gets index -1,
// colour 0 and no count. Max mode: the max over k of s alone (a pixel
// whose scores are all NaN gets -inf), optionally rounded to bf16 (to
// nearest, ties to even). Candidates are one dense set per member, c (pop,
// 4, Kc), or one set per run of `run` pixels, c (pop, R, 4, Kc).
//
// What bounds it on the H100: the products are 64 x 16 x Kc bf16 MACs a
// 64-pixel tile and member (0.21 ms at 4K/K256/pop4 at the dense bf16
// peak, the 16-deep contraction included); the argmax needs at least one
// fp32 instruction a score (0.25 ms at one instruction a lane and clock)
// and this design issues about 2.3 plus a product's own. fp32 instruction
// issue bounds it: the argmax, then the per-product work and the writes,
// not the products. Max mode issues one fmaxf a score (0.25 ms, or 0.51
// if FMNMX issues at half the FMA pipe's rate), beside the products'
// 16-deep contraction (0.27 ms) and the wait for each product, which the
// other warpgroups of the SM must cover: keeping a second product in
// flight in the warpgroup made ptxas serialise (C7514) or cost occupancy,
// and ran slower (PERF.md §6).
// The design:
//  - one warpgroup takes 64 pixels: A = [xh; xl; xh; 1, 0, 0, 0] of its
//    pixels, 16 bf16 deep, is built once per tile in registers (the
//    mma.m16n8k16 A fragment of each warp's 16 rows) and serves every
//    member; B = [ch; ch; cl; 0 (-inf for padding); 0, 0, 0] of each
//    member's candidates lies in shared memory in wgmma's K-major layout
//    without swizzle (8 x 16-byte core matrices: candidate n at (n / 8) x
//    256 + half x 128 + (n % 8) x 16 bytes; descriptor LBO 128, SBO 256),
//    so a padding candidate scores -inf and needs no mask;
//  - wgmma.mma_async m64nNk16 (wgmma_n64/wgmma_n128 below, N = 64 for up
//    to 64 candidates, else 128; scale-d 0) computes each score once; each
//    product is waited for before its argmax (ptxas serialises a product
//    in flight across non-wgmma reads of an accumulator anyway), and the
//    warpgroups of an SM (four at N = 128, six at N = 64) overlap each
//    other's products and argmaxes;
//  - the argmax runs on the held accumulator (row_argmax): a tree of fmaxf
//    over each of a lane's two rows, then a last-to-first scan over the
//    tree's quad maxima with selects, and two compares inside the chosen
//    quad (registers cannot be indexed at run time, so no rescan). Each
//    lane keeps its own running best and first index across chunks (a
//    strict `>`); the row's four lanes merge once per member (max, then
//    min index) into shared memory;
//  - average mode: the hits of a lane's row are counted in the chosen quad;
//    a lane with ties across quads takes the full mask (rare); a row with
//    one hit (almost all) is written like first mode, a row with two or
//    more walks its lanes' masks, kept per member and chunk in shared
//    memory, in index order, adding colours and counts;
//  - max mode (max_tile): four chains of fmaxf over each of a lane's two
//    rows into a running max a row and lane, one instruction a score (NaN
//    never enters, padding is -inf: no compare, select or branch); the
//    row's four lanes merge by two shuffles once per member and two lanes
//    store the row's maxima; no index, colour or count. bf16 output rounds
//    the merged f32 max once, at the store. The next tile's pixels are
//    loaded while the products run;
//  - the assignment: after a tile's last product the warpgroup writes
//    every member's 64 pixels (colours from device memory, coalesced
//    stores);
//  - dense: a persistent grid (as many blocks as fit at once) stages every
//    member's B once per block and strides over the 64-pixel tiles;
//  - per run: each warpgroup strides over runs on its own (its own B and
//    ring, named barriers): a run's raw f32 candidates come ahead of use by
//    cp.async (16-byte copies) into a ring of kStages sets and are split
//    into B. A ragged run (run = 100: tiles of 64 and 36 pixels) computes
//    the tile's 64 rows and writes only its own pixels;
//  - counts: a per-block shared int32 histogram, flushed once per block.
// The tensor core's f32 accumulation is not a sequential IEEE sum, so the
// scores agree with the plain torch version to a few f32 ulps of the
// largest product, not bit for bit. The wrapper
// (ops/probe_kernels.split_assign_plan) sizes the grid and shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "persistent_grid.cuh"

namespace {

constexpr int kRows = 64;        // pixels of a warpgroup's tile (wgmma M)
constexpr int kWarpgroup = 128;  // threads of a warpgroup
constexpr int kStages = 3;       // per-run candidate sets in flight
constexpr unsigned kFull = 0xffffffffu;

// first index of the max; every maximum a hit (tie mode "average"); the max alone
enum class Mode { kFirst, kAverage, kMax };

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

// D (64 x 64, f32, held) = A (64 x 16 bf16, registers) x B (16 x 64 bf16, shared, K-major)
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

// D (64 x 128, f32, held) = A (64 x 16 bf16, registers) x B (16 x 128 bf16, shared, K-major)
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

template <int NB>
__device__ __forceinline__ void wgmma(float (&d)[NB / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (NB == 64) {
    wgmma_n64(d, a, b);
  } else {
    wgmma_n128(d, a, b);
  }
}

// Keep the compiler from moving reads or writes of the accumulator across
// the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The wgmma descriptor of a K-major B tile without swizzle at `smem`.
__device__ __forceinline__ uint64_t b_desc(const void* smem) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem);
  return (uint64_t)((addr & 0x3FFFF) >> 4)  // start address
         | (uint64_t)(128 >> 4) << 16       // LBO: the contraction's two 8-deep core matrices
         | (uint64_t)(256 >> 4) << 32;      // SBO: the next 8 candidates
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Barrier of one warpgroup's 128 threads (named barrier 1 + wg; 0 is
// __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(wg + 1), "n"(kWarpgroup) : "memory");
}

// Every member's candidates (member p's rows r at c + p * pstride + r *
// Kc) into B: candidate k of member p at 16-byte units p x kpad x 2 + (k /
// 8) x 16 + half x 8 + k % 8 (so a product of NB candidates is NB x 2
// units), half 0 = ch rows 0-3 twice, half 1 = cl rows 0-3, then at
// contraction row 12 a 0 (-inf for a padding candidate past Kc; A's column
// 12 is 1, so a padding candidate scores -inf and a real one adds an exact
// 0), then three zeros. Threads tid of n. Callers fence the async proxy
// and synchronise.
__device__ __forceinline__ void stage_b(const float* c, size_t pstride, int Kc, int kpad, int pop,
                                        uint4* b, int tid, int n) {
  const uint32_t neg_inf = 0xFF80u;  // bf16 -inf
  for (int i = tid; i < pop * kpad; i += n) {
    const int p = i / kpad, k = i % kpad;
    uint4 hi = make_uint4(0u, 0u, 0u, 0u), lo = make_uint4(0u, 0u, neg_inf, 0u);
    if (k < Kc) {
      const float* cp = c + p * pstride + k;
      __nv_bfloat16 h[4], l[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) split(cp[(size_t)r * Kc], h[r], l[r]);
      hi = make_uint4(pack2(h[0], h[1]), pack2(h[2], h[3]), pack2(h[0], h[1]), pack2(h[2], h[3]));
      lo = make_uint4(pack2(l[0], l[1]), pack2(l[2], l[3]), 0u, 0u);
    }
    uint4* u = b + (size_t)p * kpad * 2 + (k / 8) * 16 + k % 8;
    u[0] = hi;
    u[8] = lo;
  }
}

// Bytes of one B and one ring (ops/probe_kernels.split_assign_plan sums the
// kernel's regions in this order: B (one, or one a warpgroup per run), the
// per-run rings, average mode's hit masks, the merged rows, hist; max mode
// has B and the rings alone).
__host__ __device__ constexpr size_t b_bytes(int pop, int kpad) { return (size_t)pop * kpad * 32; }
__host__ __device__ constexpr size_t ring_bytes(int pop, int Kc) {
  return (size_t)kStages * pop * 4 * Kc * sizeof(float);
}
// ints of one warpgroup's merged rows: per member and row the winner (and
// in average mode its hits and the four lanes' first chunks), then a slot
// the lanes that write nothing write to (none in max mode)
__host__ __device__ constexpr int res_ints(int pop, bool average) {
  return pop * kRows * (average ? 6 : 1) + 8;
}

// One row's running state in one lane, over that lane's own columns: the
// best score, the first index reaching it, and in average mode the hits
// at it and the chunk where it was reached.
struct Row {
  float best;
  int idx, hits, start;
};

__device__ __forceinline__ void reset(Row& r) {
  r.best = -INFINITY;
  r.idx = -1;
  r.hits = 0;
  r.start = 0;
}

// One row of a product held by this lane: v[2i + e] is column 8i + 2t + e
// of the chunk, i < NB / 8. Its maximum m, the first of its values equal
// to m (f: 8i + e), and in average mode the count h of values equal to m
// and their mask q (bit 2i + e). The first index comes from the tree of
// maxima: a last-to-first scan over the quads' maxima (a compare and four
// selects a quad: the quad, its left pair's maximum and the first value of
// each pair) and two compares inside the chosen quad; about 2.3
// instructions a score with the tree. Average mode also counts the quads
// at m and keeps the chosen quad's other two values: one quad at m (almost
// always) gives h from its four values; two or more (ties across quads)
// take the full mask, value by value.
template <int NB, bool kAverage>
__device__ __forceinline__ void row_argmax(const float (&v)[NB / 4], float& m, int& f, int& h,
                                           uint32_t& q) {
  constexpr int kPairs = NB / 8, kQuads = NB / 16;
  float x[kPairs], y[kQuads];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) x[i] = fmaxf(v[2 * i], v[2 * i + 1]);
#pragma unroll
  for (int j = 0; j < kQuads; ++j) y[j] = fmaxf(x[2 * j], x[2 * j + 1]);
  float z[kQuads];
#pragma unroll
  for (int j = 0; j < kQuads; ++j) z[j] = y[j];
#pragma unroll
  for (int n = kQuads; n > 1; n /= 2) {
#pragma unroll
    for (int j = 0; j < n / 2; ++j) z[j] = fmaxf(z[2 * j], z[2 * j + 1]);
  }
  m = z[0];
  int quad = 0, quads = 0;
  float left = 0.0f, v0 = 0.0f, v1 = 0.0f, v2 = 0.0f, v3 = 0.0f;
#pragma unroll
  for (int j = kQuads - 1; j >= 0; --j) {
    const bool at = y[j] == m;
    quad = at ? j : quad;
    left = at ? x[2 * j] : left;
    v0 = at ? v[4 * j] : v0;
    v2 = at ? v[4 * j + 2] : v2;
    if (kAverage) {
      v1 = at ? v[4 * j + 1] : v1;
      v3 = at ? v[4 * j + 3] : v3;
      quads += at ? 1 : 0;
    }
  }
  const bool in_left = left == m;
  const int pair = 2 * quad + (in_left ? 0 : 1);
  f = 8 * pair + ((in_left ? v0 : v2) == m ? 0 : 1);
  h = 0;
  q = 0u;
  if (kAverage) {
    h = (v0 == m) + (v1 == m) + (v2 == m) + (v3 == m);
    if (quads >= 2 || h >= 2) {  // rare: ties inside this lane's row of the chunk
      h = 0;
#pragma unroll
      for (int i = 0; i < NB / 4; ++i) {
        h += v[i] == m ? 1 : 0;
        q |= v[i] == m ? 1u << i : 0u;
      }
    } else {
      q = h ? 1u << (2 * pair + (f & 1)) : 0u;
    }
  }
}

// A lane's chunk result for a row into the row's state; average mode
// keeps the mask (0 where m is below the best) at *rec.
template <int NB, bool kAverage>
__device__ __forceinline__ void take(Row& r, float m, int f, int h, uint32_t q, int nc, int t,
                                     uint32_t* rec) {
  const bool up = m > r.best;
  if (kAverage) {
    const bool same = m == r.best && m > -INFINITY;
    *rec = up || same ? q : 0u;
    r.hits = up ? h : same ? r.hits + h : r.hits;
    r.start = up ? nc : r.start;
  }
  r.idx = up ? nc * NB + f + 2 * t : r.idx;
  r.best = up ? m : r.best;
}

// A row's result from its four lanes into out[0..]: the first index at
// the max (-1 if none); average mode also the hits at it and each lane's
// first chunk at it (chunks where the lane is below it). The lane with
// w writes; the others write to `spare`.
template <bool kAverage>
__device__ __forceinline__ void merge(const Row& r, int chunks, int lane, bool w, int* out,
                                      int* spare) {
  float m = r.best;
  m = fmaxf(m, __shfl_xor_sync(kFull, m, 1));
  m = fmaxf(m, __shfl_xor_sync(kFull, m, 2));
  const bool at = r.best == m && m > -INFINITY;
  int i = at ? r.idx : INT_MAX;
  i = min(i, __shfl_xor_sync(kFull, i, 1));
  i = min(i, __shfl_xor_sync(kFull, i, 2));
  int* dst = w ? out : spare;
  dst[0] = m > -INFINITY ? i : -1;
  if (kAverage) {
    int h = at ? r.hits : 0;
    h += __shfl_xor_sync(kFull, h, 1);
    h += __shfl_xor_sync(kFull, h, 2);
    dst[1] = h;
    const int s = at ? r.start : chunks;
#pragma unroll
    for (int u = 0; u < 4; ++u) dst[2 + u] = __shfl_sync(kFull, s, (lane & ~3) | u);
  }
}

struct Args {
  const float* x;
  const float* o;  // this set's colours: member p's rows at o + p * opstride
  size_t opstride;
  int P, Kc, chunks, pop, opp_parts;
  bool shared_hist;
  float* opp;
  int* counts;
  int* idx_out;
  float* maxima;  // max mode: (pop, P)
  bool out_bf16;
};

// Member p's colour, count and index of the pixel `pix` from its merged
// row m; in average mode a row with two or more hits walks the kept masks
// of its row (rec, chunks x 4 lanes) in index order.
template <int NB, bool kAverage>
__device__ __forceinline__ void emit(const Args& g, int* hist, int p, size_t pix, const int* m,
                                     const uint32_t* rec) {
  const int Kc = g.Kc, P = g.P, win = m[0];
  const float* ob = g.o + (size_t)p * g.opstride;
  auto count = [&](int k) {
    if (g.shared_hist) {
      atomicAdd(&hist[p * Kc + k], 1);
    } else {
      atomicAdd(&g.counts[(size_t)p * Kc + k], 1);
    }
  };
  float col[3] = {0.0f, 0.0f, 0.0f};
  if (win >= 0) {
    if (!kAverage || m[1] <= 1) {
#pragma unroll
      for (int r = 0; r < 3; ++r) col[r] = parts(ob[(size_t)r * Kc + win], g.opp_parts);
      count(win);
    } else {
      bool any = false;
      const int first = min(min(m[2], m[3]), min(m[4], m[5]));
      for (int nc = first; nc < g.chunks; ++nc) {
        uint32_t w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) w[u] = nc >= m[2 + u] ? rec[nc * 4 + u] : 0u;
        if ((w[0] | w[1] | w[2] | w[3]) == 0u) continue;
        for (int i = 0; i < NB / 8; ++i) {
          for (int k = 0; k < 8; ++k) {
            if (!((w[k >> 1] >> (2 * i + (k & 1))) & 1u)) continue;
            const int cand = nc * NB + 8 * i + k;
#pragma unroll
            for (int r = 0; r < 3; ++r) {
              const float v = parts(ob[(size_t)r * Kc + cand], g.opp_parts);
              col[r] = any ? __fadd_rn(col[r], v) : v;
            }
            any = true;
            count(cand);
          }
        }
      }
    }
  }
  float* out = g.opp + (size_t)p * 3 * P + pix;
  out[0] = col[0];
  out[P] = col[1];
  out[2 * (size_t)P] = col[2];
  if (g.idx_out != nullptr) g.idx_out[(size_t)p * P + pix] = win;
}

// The x values of this lane's A fragment: rows r0, r0 + 1 (r0 = 0 or 2
// by t) of pixels pa and pb, 0 past px1.
__device__ __forceinline__ void load_x(const float* x, int P, size_t pa, size_t pb, size_t px1,
                                       int t, float (&v)[4]) {
  const int r0 = (t & 1) * 2;
  v[0] = v[1] = v[2] = v[3] = 0.0f;
  if (pa < px1) {
    v[0] = x[(size_t)r0 * P + pa];
    v[1] = x[(size_t)(r0 + 1) * P + pa];
  }
  if (pb < px1) {
    v[2] = x[(size_t)r0 * P + pb];
    v[3] = x[(size_t)(r0 + 1) * P + pb];
  }
}

// A fragment (mma.m16n8k16 layout for this warp's 16 rows) from load_x's
// values: a0 row g, a1 row g + 8, contraction columns 2t, 2t + 1; a2, a3
// columns 2t + 8, 2t + 9. Columns 0-3 xh, 4-7 xl, 8-11 xh, 12 one, 13-15
// zero.
__device__ __forceinline__ void a_fragment(const float (&v)[4], int t, uint32_t (&a)[4]) {
  __nv_bfloat16 h[4], lo[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) split(v[j], h[j], lo[j]);
  const uint32_t one = t == 2 ? pack2(__float2bfloat16_rn(1.0f), __float2bfloat16_rn(0.0f)) : 0u;
  if (t < 2) {
    a[0] = a[2] = pack2(h[0], h[1]);
    a[1] = a[3] = pack2(h[2], h[3]);
  } else {
    a[0] = pack2(lo[0], lo[1]);
    a[1] = pack2(lo[2], lo[3]);
    a[2] = a[3] = one;
  }
}

// One product into the held accumulator, waited for. Issued by every
// thread of the warpgroup, converged.
template <int NB>
__device__ __forceinline__ void product(float (&d)[NB / 2], const uint32_t (&a)[4], uint64_t desc) {
  __syncwarp();
  fence_regs(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  wgmma<NB>(d, a, desc);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  wgmma_wait<0>();
  fence_regs(d);
}

// One row of a product held by this lane (E = 0: row a, its values
// d[4i], d[4i + 1]; E = 2: row b, d[4i + 2], d[4i + 3]) folded into the
// running max r: four chains of fmaxf, NB / 4 instructions for NB / 4
// scores (loops of unit stride only, so every value stays in a register).
// fmaxf drops a NaN operand, so a NaN score never enters the max.
template <int NB, int E>
__device__ __forceinline__ float fold_max(const float (&d)[NB / 2], float r) {
  float m[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) m[j] = fmaxf(d[4 * j + E], d[4 * j + E + 1]);
#pragma unroll
  for (int i = 4; i < NB / 8; ++i) {
    m[i & 3] = fmaxf(m[i & 3], d[4 * i + E]);
    m[i & 3] = fmaxf(m[i & 3], d[4 * i + E + 1]);
  }
  return fmaxf(fmaxf(r, fmaxf(m[0], m[1])), fmaxf(m[2], m[3]));
}

// One warpgroup's 64-pixel tile [px0, px1): for every member and chunk of
// NB candidates (product j = p x chunks + chunk, B at b + j x NB x 2
// uint4s) one wgmma, waited for, then the argmax on the held accumulator;
// a member's rows are merged into `res` after its last chunk. The products
// are not overlapped within a warpgroup (ptxas serialises a product in
// flight across the argmax's reads anyway); the warpgroups of an SM overlap
// each other's products and argmaxes. Then the warpgroup writes every
// member's 64 pixels from res (coalesced). rec: this warpgroup's hit masks
// (average mode), pop x 64 rows x chunks x 4 lanes.
template <int NB, bool kAverage>
__device__ __forceinline__ void do_tile(const Args& g, const uint4* b, uint32_t* rec, int* res,
                                        int* hist, int wg, size_t px0, size_t px1,
                                        float (&d)[NB / 2]) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3;
  const int gr = lane >> 2, t = lane & 3;
  const int row_a = 16 * warp + gr, row_b = row_a + 8;
  const size_t pa = px0 + row_a, pb = px0 + row_b;
  const int P = g.P, chunks = g.chunks, pop = g.pop;
  constexpr int kRes = kAverage ? 6 : 1;
  int* spare = res + pop * kRows * kRes;

  uint32_t a[4];
  {
    float v[4];
    load_x(g.x, P, pa, pb, px1, t, v);
    a_fragment(v, t, a);
  }

  // the descriptor's start address field counts 16 bytes: a product is NB x 2 of them
  uint64_t desc = b_desc(b);
  for (int p = 0; p < pop; ++p) {
    Row ra, rb;
    reset(ra);
    reset(rb);
    for (int nc = 0; nc < chunks; ++nc, desc += NB * 2) {
      product<NB>(d, a, desc);
      // value 4i + e is (row a, column 8i + 2t + e), 4i + 2 + e row b
      float va[NB / 4], vb[NB / 4];
#pragma unroll
      for (int i = 0; i < NB / 8; ++i) {
        va[2 * i] = d[4 * i];
        va[2 * i + 1] = d[4 * i + 1];
        vb[2 * i] = d[4 * i + 2];
        vb[2 * i + 1] = d[4 * i + 3];
      }
      float ma, mb;
      int fa, fb, ha, hb;
      uint32_t qa, qb;
      row_argmax<NB, kAverage>(va, ma, fa, ha, qa);
      row_argmax<NB, kAverage>(vb, mb, fb, hb, qb);
      uint32_t* ka = rec + ((size_t)(p * kRows + row_a) * chunks + nc) * 4 + t;
      uint32_t* kb = rec + ((size_t)(p * kRows + row_b) * chunks + nc) * 4 + t;
      take<NB, kAverage>(ra, ma, fa, ha, qa, nc, t, ka);
      take<NB, kAverage>(rb, mb, fb, hb, qb, nc, t, kb);
    }
    merge<kAverage>(ra, chunks, lane, t == 0, res + (p * kRows + row_a) * kRes, spare);
    merge<kAverage>(rb, chunks, lane, t == 1, res + (p * kRows + row_b) * kRes, spare);
  }

  wg_sync(wg);  // every member's rows are in res (and the masks in rec)
  for (int i = threadIdx.x % kWarpgroup; i < pop * kRows; i += kWarpgroup) {
    const int p = i / kRows, row = i % kRows;
    const size_t pix = px0 + row;
    if (pix < px1) {
      emit<NB, kAverage>(g, hist, p, pix, res + i * kRes, rec + (size_t)i * chunks * 4);
    }
  }
  wg_sync(wg);  // res and rec are free for the next tile
}

// Max mode's tile [px0, px1), whose x values this lane holds in xv: for
// every member and chunk one product, waited for, then the running max of
// each of the lane's two rows over the held values (fold_max); after a
// member's last chunk the row's four lanes merge (two shuffles) and lanes
// t = 0 and 1 store rows a and b. A warp's two stores of a member fill two
// whole 32-byte sectors (rows 16w .. 16w + 7 and 16w + 8 .. 16w + 15), so
// staging the tile in shared memory would buy no coalescing for its two
// barriers. The next tile's x values [nx0, nx1) are loaded into xv while
// the products run.
template <int NB>
__device__ __forceinline__ void max_tile(const Args& g, const uint4* b, size_t px0, size_t px1,
                                         float (&xv)[4], size_t nx0, size_t nx1,
                                         float (&d)[NB / 2]) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x / 32) & 3;
  const int gr = lane >> 2, t = lane & 3;
  const int row_a = 16 * warp + gr, row_b = row_a + 8;
  const int P = g.P, chunks = g.chunks, pop = g.pop;

  uint32_t a[4];
  a_fragment(xv, t, a);
  load_x(g.x, P, nx0 + row_a, nx0 + row_b, nx1, t, xv);
  // the descriptor's start address field counts 16 bytes: a product is NB x 2 of them
  uint64_t desc = b_desc(b);
  float ma = -INFINITY, mb = -INFINITY;
  // products p x chunks + nc in turn, in one loop (nested member and chunk
  // loops made ptxas spill at N = 64)
  for (int p = 0, nc = 0, j = 0; j < pop * chunks; ++j, desc += NB * 2) {
    product<NB>(d, a, desc);
    ma = fold_max<NB, 0>(d, ma);
    mb = fold_max<NB, 2>(d, mb);
    if (++nc < chunks) continue;
    ma = fmaxf(ma, __shfl_xor_sync(kFull, ma, 1));
    mb = fmaxf(mb, __shfl_xor_sync(kFull, mb, 1));
    ma = fmaxf(ma, __shfl_xor_sync(kFull, ma, 2));
    mb = fmaxf(mb, __shfl_xor_sync(kFull, mb, 2));
    // Rounding to nearest (ties to even) is monotone (non-decreasing), so
    // the bf16 rounding of the f32 max is the max of the rounded scores
    // (and -inf stays -inf): one rounding an output instead of one a score.
    const size_t pix = px0 + (t == 0 ? row_a : row_b);
    const float m = t == 0 ? ma : mb;
    if (t < 2 && pix < px1) g.maxima[(size_t)p * P + pix] = g.out_bf16 ? bf16_round(m) : m;
    ma = mb = -INFINITY;
    nc = 0;
    ++p;
  }
}

template <int NB, Mode M>
__global__ void __launch_bounds__(2 * kWarpgroup, NB == 64 ? 3 : 2)
    assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                  const float* __restrict__ o, int P, int Kc, int pop, int run, int R,
                  int opp_parts, bool shared_hist, float* __restrict__ opp,
                  int* __restrict__ counts, int* __restrict__ idx_out,
                  float* __restrict__ maxima, bool out_bf16) {
  constexpr bool kAverage = M == Mode::kAverage;
  extern __shared__ __align__(128) unsigned char smem[];
  const int kpad = (Kc + NB - 1) / NB * NB, chunks = kpad / NB;
  const int wgs = blockDim.x / kWarpgroup, wg = threadIdx.x / kWarpgroup;
  const int tid = threadIdx.x % kWarpgroup;
  // carve: B (dense: one; per run: one a warpgroup), rings, masks, rows, hist
  unsigned char* base = smem;
  uint4* b = reinterpret_cast<uint4*>(base + (run > 0 ? wg * b_bytes(pop, kpad) : 0));
  base += (run > 0 ? wgs : 1) * b_bytes(pop, kpad);
  float* raw = reinterpret_cast<float*>(base + wg * ring_bytes(pop, Kc));
  base += run > 0 ? wgs * ring_bytes(pop, Kc) : 0;
  const size_t rec_words = (size_t)pop * kRows * chunks * 4;
  uint32_t* rec = reinterpret_cast<uint32_t*>(base) + wg * rec_words;
  base += kAverage ? wgs * rec_words * sizeof(uint32_t) : 0;
  int* res = reinterpret_cast<int*>(base) + wg * res_ints(pop, kAverage);
  base += M == Mode::kMax ? 0 : (size_t)wgs * res_ints(pop, kAverage) * sizeof(int);
  int* hist = reinterpret_cast<int*>(base);

  float d[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) d[i] = 0.0f;
  if (shared_hist) {
    for (int k = threadIdx.x; k < pop * Kc; k += blockDim.x) hist[k] = 0;
  }
  Args g{x, o, (size_t)4 * Kc, P, Kc, chunks, pop, opp_parts, shared_hist, opp, counts, idx_out,
         maxima, out_bf16};
  // max mode: this lane's x values of its warpgroup's next tile
  float xv[4];
  auto load_next = [&](size_t nx0, size_t nx1) {
    const int row_a = 16 * ((threadIdx.x / 32) & 3) + (threadIdx.x & 31) / 4;
    load_x(x, P, nx0 + row_a, nx0 + row_a + 8, nx1, threadIdx.x & 3, xv);
  };
  // one tile [px0, px1), the next one of this warpgroup [nx0, nx1) (empty
  // if none): the assignment's, or max mode's
  auto run_tile = [&](size_t px0, size_t px1, size_t nx0, size_t nx1) {
    if constexpr (M == Mode::kMax) {
      max_tile<NB>(g, b, px0, px1, xv, nx0, nx1, d);
    } else {
      do_tile<NB, kAverage>(g, b, rec, res, hist, wg, px0, px1, d);
    }
  };
  const size_t gw = (size_t)blockIdx.x * wgs + wg, nw = (size_t)gridDim.x * wgs;

  if (run == 0) {
    // dense: every member's B once per block, then a stride over the tiles
    stage_b(c, (size_t)4 * Kc, Kc, kpad, pop, b, threadIdx.x, blockDim.x);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const size_t tiles = ((size_t)P + kRows - 1) / kRows;
    auto end = [&](size_t tile) { return tile < tiles ? min((size_t)P, (tile + 1) * kRows) : 0; };
    if constexpr (M == Mode::kMax) load_next(gw * kRows, end(gw));
    for (size_t tile = gw; tile < tiles; tile += nw) {
      run_tile(tile * kRows, end(tile), (tile + nw) * kRows, end(tile + nw));
    }
  } else {
    // per run: each warpgroup strides over the runs on its own (its own B
    // and ring, named barriers), the candidates coming ahead of use
    // through a ring of kStages raw sets by cp.async
    __syncthreads();  // hist is zeroed
    const size_t set_f4 = (size_t)pop * Kc;  // float4s of a run's raw set: (pop, 4, Kc) floats
    auto prefetch = [&](size_t it) {
      const size_t r = gw + it * nw;
      if (r < (size_t)R) {
        float4* dst = reinterpret_cast<float4*>(raw) + (it % kStages) * set_f4;
        const float4* src = reinterpret_cast<const float4*>(c);
        for (size_t i = tid; i < set_f4; i += kWarpgroup) {
          const size_t p = i / Kc, j = i % Kc;
          cp_async16(dst + i, src + (p * R + r) * Kc + j);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    const size_t its = gw < (size_t)R ? ((size_t)R - 1 - gw) / nw + 1 : 0;
#pragma unroll
    for (int it = 0; it < kStages - 1; ++it) prefetch(it);
    const int tiles = (run + kRows - 1) / kRows;
    // the first tile of run r: [r x run, its end)
    auto first_end = [&](size_t r) {
      return r < (size_t)R ? min((size_t)P, r * run + min(run, kRows)) : 0;
    };
    if constexpr (M == Mode::kMax) load_next(gw * run, first_end(gw));
    for (size_t it = 0; it < its; ++it) {
      prefetch(it + kStages - 1);
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
      wg_sync(wg);  // run `it` has landed; the last run's tiles are done with B
      const size_t r = gw + it * nw;
      stage_b(raw + (it % kStages) * set_f4 * 4, (size_t)4 * Kc, Kc, kpad, pop, b, tid, kWarpgroup);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync(wg);
      if constexpr (M != Mode::kMax) {  // this run's colours
        g.o = o + r * 4 * Kc;
        g.opstride = (size_t)R * 4 * Kc;
      }
      const size_t run0 = r * run, run1 = min((size_t)P, run0 + run);
      for (int m = 0; m < tiles; ++m) {
        const size_t px0 = run0 + (size_t)m * kRows, px1 = min(run1, px0 + kRows);
        if (px0 < run1) {
          // the next tile: this run's, or the first of the warpgroup's next run
          const bool in_run = px1 < run1;
          run_tile(px0, px1, in_run ? px1 : (r + nw) * run,
                   in_run ? min(run1, px1 + kRows) : first_end(r + nw));
        }
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }

  if (shared_hist) {
    __syncthreads();
    for (int k = threadIdx.x; k < pop * Kc; k += blockDim.x) {
      const int h = hist[k];
      if (h != 0) atomicAdd(&counts[k], h);
    }
  }
}

template <int NB, Mode M>
int launch(const float* x4, const float* c, const float* o, int P, int Kc, int pop, int run, int R,
           int opp_parts, int wgs, int blocks, int shared_hist, int smem, float* opp, int* counts,
           int* idx, float* maxima, bool out_bf16, cudaStream_t s) {
  auto kernel = assign_kernel<NB, M>;
  const int e = hq_persistent_grid(kernel, wgs * kWarpgroup, smem, &blocks);
  if (e != 0) return e;
  kernel<<<blocks, wgs * kWarpgroup, smem, s>>>(x4, c, o, P, Kc, pop, run, R, opp_parts,
                                                shared_hist != 0, opp, counts, idx, maxima,
                                                out_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

// x4 (4, P) f32; c (pop, 4, Kc), or (pop, R = ceil(P / run), 4, Kc) when run
// > 0; o shaped as c (row 3 unused); opp (pop, 3, P) f32; counts (pop, Kc)
// int32, zeroed by the caller; idx (pop, P) int32 or null. average: tie
// mode "average"; opp_parts 2 or 3. The plan (ops/probe_kernels.
// split_assign_plan): nb the candidates of one product (64 or 128), wgs
// warpgroups a block (1 or 2), blocks of the persistent grid (an upper
// bound), whether counts go through shared memory, and the shared bytes.
// Returns the cudaGetLastError() of the launch.
extern "C" int hq_split_assign(const float* x4, const float* c, const float* o, int P, int Kc,
                               int pop, int run, int average, int opp_parts, int nb, int wgs,
                               int blocks, int shared_hist, int smem, float* opp, int* counts,
                               int* idx, void* stream) {
  if (P <= 0 || Kc <= 0 || pop <= 0 || run < 0 || blocks <= 0 || wgs < 1 || wgs > 2 ||
      (opp_parts != 2 && opp_parts != 3)) {
    return (int)cudaErrorInvalidValue;
  }
  const int R = run > 0 ? (int)(((size_t)P + run - 1) / run) : 1;
  cudaStream_t s = (cudaStream_t)stream;
#define HQ_LAUNCH(NB, M)                                                                       \
  launch<NB, M>(x4, c, o, P, Kc, pop, run, R, opp_parts, wgs, blocks, shared_hist, smem, opp, \
                counts, idx, nullptr, false, s)
  if (nb == 64) return average ? HQ_LAUNCH(64, Mode::kAverage) : HQ_LAUNCH(64, Mode::kFirst);
  if (nb == 128) return average ? HQ_LAUNCH(128, Mode::kAverage) : HQ_LAUNCH(128, Mode::kFirst);
#undef HQ_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Max mode (split_rowmax): x4 and c as above; out (pop, P) f32, each the
// max over the candidates of the split-bf16 score, -inf where every score
// is NaN, rounded to bf16 (nearest, ties to even) when out_bf16. The plan
// (split_assign_plan with max_only): nb 64 or 128, wgs, blocks, the
// shared bytes. Returns the cudaGetLastError() of the launch.
extern "C" int hq_split_rowmax(const float* x4, const float* c, int P, int Kc, int pop, int run,
                               int out_bf16, int nb, int wgs, int blocks, int smem, float* out,
                               void* stream) {
  if (P <= 0 || Kc <= 0 || pop <= 0 || run < 0 || blocks <= 0 || wgs < 1 || wgs > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const int R = run > 0 ? (int)(((size_t)P + run - 1) / run) : 1;
  cudaStream_t s = (cudaStream_t)stream;
#define HQ_LAUNCH(NB)                                                                          \
  launch<NB, Mode::kMax>(x4, c, nullptr, P, Kc, pop, run, R, 2, wgs, blocks, 0, smem, nullptr, \
                         nullptr, nullptr, out, out_bf16 != 0, s)
  if (nb == 64) return HQ_LAUNCH(64);
  if (nb == 128) return HQ_LAUNCH(128);
#undef HQ_LAUNCH
  return (int)cudaErrorInvalidValue;
}
