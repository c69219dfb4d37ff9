// T1, T2: B1's first-index assignment as a k-loop over the palette.
//
// Replaces the TPU probes tools/vpu_assign_exp.py make_vpu_kernel (:138-222,
// pallas_call in run_vpu, :235) and make_grp8_kernel (:47-135, pallas_call
// in _grp8_call, :272). Both compute one function: for every member p and
// pixel i the first entry k maximising the score
//   s = (x0 c0 + x1 c1) + (x2 c2 + cb)
// (cb the bias row -|c|^2/2 of the packed palette), every product and sum
// rounded on its own (__fmul_rn/__fadd_rn: nvcc would otherwise contract to
// FMAs, and the plain torch version rounds each operation), as a strict `>`
// scan in index order from a best of -1e30, so NaN and scores at or below
// -1e30 never win; then the winner's opponent colour (0 without a winner)
// and int32 counts per entry.
//
// What bounds it on the H100: fp32 instruction issue. With the separate
// rounding the function defines, a score is at least 3 FMUL + 3 FADD and
// its max 1 FMNMX: 4 x 8.3 M x 256 scores x 7 instructions over 132 SMs x
// 128 lanes x 1.98 GHz is 1.78 ms at 4K/K256/pop4, the floor of any kernel
// of this function. (The 0.761 ms bound in PERF.md counts 6 FLOPs a score
// at the FMA peak, as B1's does; half of it is out of reach by definition.)
//
// The design, B1's max-then-rescan scan (nearest_scan.cuh) with this
// function's score and starting best:
//  - a thread holds kPx = 4 pixels, so one broadcast float4 load of an
//    entry (c0, c1, c2, cb) from shared memory feeds four scores;
//  - each chunk of 16 entries is scanned with fmaxf alone (a NaN drops
//    out); after the chunk one compare and select records a chunk maximum
//    strictly above the running best and the chunk's number; at the end of
//    a staged tile, a pixel whose best moved in it rescans its winning
//    chunk with the same rounded operations (so the same bits) for the
//    first entry equal to the best;
//  - no colour in the loop: the winner's opponent colour is read from
//    device memory once, after the scan;
//  - a persistent grid (about as many blocks as fit on the SMs at once)
//    strides over tiles of pixels. When every member's packed palette fits
//    (K up to the plan's tile of KLOOP_TILE entries, and the shared bytes
//    it allows), a block stages them once and keeps them; else it stages
//    tiles of KLOOP_TILE entries per pixel tile. Each 16-entry chunk is
//    padded to 17 float4s, so the rescans of different chunks by the
//    threads of a warp spread over the banks; a tile's last chunks are
//    filled with entries that score -inf;
//  - counts go to a shared int32 histogram, flushed once per block.
// The probes' schedules are template parameters and give the same bits:
//  - SLOTS = 1 (T1: pixels on lanes): one lane scans every entry;
//  - SLOTS = 8 (T2: eight sublane slots): eight lanes share four pixels,
//    lane j scanning entries j, j + 8, ... in chunks of 16 of its own
//    entries; at a tile's end the eight rescan together only the chunks of
//    lanes at the group's best (rescan_group); they merge with
//    __shfl_xor_sync by max score, then min index (vpu_assign_exp.py:100-107);
//  - FUSED (T1's `fused`): every member's chains share one pass over k
//    (NP = 2, 4 or 8 chains; members beyond pop are staged as -inf and
//    never written);
//  - UNROLL: entries of a chunk per step of the scan, unrolled by hand;
//  - threads: the block size.
// The wrapper (ops/probe_kernels.kloop_plan) chooses the grid, the tile and
// whether the palettes stay resident, and sizes the shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "persistent_grid.cuh"

namespace {

constexpr float kNeg = -1e30f;  // vpu_assign_exp.py:93, :154
constexpr int kPx = 4;          // pixels a thread (a slot group)
constexpr int kChunk = 16;      // entries a max-then-rescan chunk (of one lane)

__device__ __forceinline__ float score(const float (&x)[3], float4 c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x[0], c.x), __fmul_rn(x[1], c.y)),
                   __fadd_rn(__fmul_rn(x[2], c.z), c.w));
}

// Shared slot of entry j of a staged tile: chunks of 16 padded to 17.
__device__ __forceinline__ int slot(int j) { return j / kChunk * (kChunk + 1) + j % kChunk; }

// Slot offset of step j of a lane's chunk from the chunk's base (c x
// kSlots x 17 + lane): entry kSlots x j + lane of the chunk's kSlots x 16.
template <int kSlots>
__device__ __forceinline__ int step_slot(int j) {
  return (kSlots * j) / kChunk * (kChunk + 1) + (kSlots * j) % kChunk;
}

// Stage entries [k0, k0 + n) of member p as (c0, c1, c2, cb) float4s into a
// tile of `padded` entries, entries past n (and every entry of a member p
// >= pop) scoring -inf. Callers synchronise around it.
__device__ __forceinline__ void stage(const float* c4, int K, int pop, int p, int k0, int n,
                                      int padded, float4* tile) {
  const float* c = c4 + (size_t)p * 4 * K + k0;
  for (int j = threadIdx.x; j < padded; j += blockDim.x) {
    tile[slot(j)] = p < pop && j < n ? make_float4(c[j], c[K + j], c[2 * K + j], c[3 * K + j])
                                     : make_float4(0.0f, 0.0f, 0.0f, -INFINITY);
  }
}

// SLOTS > 1: the rescans of a pixel's group at the end of a tile. Only a
// lane whose best moved in the tile and equals the group's best can still
// win (bests only grow), so only those are resolved: the group's lanes
// rescan such a lane's chunk together, two steps each (16 = 2 x 8), and a
// ballot gives its first step equal to the best. A lane below the group's
// best keeps its chunk number unresolved; it never wins the merge.
template <int kSlots>
__device__ __forceinline__ void rescan_group(const float4* tl, const float (&x)[3], float best,
                                             int& win, int k0, int c0, int lane) {
  static_assert(kChunk == 2 * kSlots, "two rescan steps a lane");
  constexpr unsigned kFull = 0xffffffffu;
  float top = best;
#pragma unroll
  for (int off = 1; off < kSlots; off <<= 1) top = fmaxf(top, __shfl_xor_sync(kFull, top, off));
  const int base = (threadIdx.x & 31) & ~(kSlots - 1);  // the group's first lane in the warp
  bool todo = win >= c0 && best == top;
  for (unsigned pending = __ballot_sync(kFull, todo); pending != 0u;
       pending = __ballot_sync(kFull, todo)) {
    const unsigned mine = (pending >> base) & ((1u << kSlots) - 1u);
    const int L = mine ? __ffs(mine) - 1 : 0;
    const int cc = __shfl_sync(kFull, win, base + L) - c0;
    const float bl = __shfl_sync(kFull, best, base + L);
    const float4* e = tl + (mine ? cc : 0) * kSlots * (kChunk + 1) + L;
    const bool h0 = mine && score(x, e[step_slot<kSlots>(lane)]) == bl;
    const bool h1 = mine && score(x, e[step_slot<kSlots>(lane + kSlots)]) == bl;
    const unsigned b0 = (__ballot_sync(kFull, h0) >> base) & ((1u << kSlots) - 1u);
    const unsigned b1 = (__ballot_sync(kFull, h1) >> base) & ((1u << kSlots) - 1u);
    const int j = b0 ? __ffs(b0) - 1 : b1 ? __ffs(b1) - 1 + kSlots : kChunk - 1;
    if (mine && lane == L) {
      win = -(k0 + (cc * kChunk + j) * kSlots + L) - 2;
      todo = false;
    }
  }
}

template <int kSlots, int kUnroll, int kNP>
__global__ void kloop_kernel(const float* __restrict__ x, const float* __restrict__ c4,
                             const float* __restrict__ o4, int P, int K, int pop, int tile,
                             int tile_f4, int staged, bool resident, bool shared_hist,
                             float* __restrict__ opp, int* __restrict__ counts) {
  // dynamic shared memory: `staged` members' tiles of tile_f4 float4s, then hist
  extern __shared__ float4 smem[];
  float4* pal = smem;
  int* hist = reinterpret_cast<int*>(smem + (size_t)staged * tile_f4);
  constexpr int kStep = kChunk * kSlots;  // entries of one chunk of every lane

  const int groups = blockDim.x / kSlots;  // pixel groups (kSlots lanes each)
  const int lane = threadIdx.x % kSlots, gi = threadIdx.x / kSlots;
  const int block_px = groups * kPx;

  if (shared_hist) {
    for (int k = threadIdx.x; k < pop * K; k += blockDim.x) hist[k] = 0;
  }
  if (resident) {
    const int padded = (K + kStep - 1) / kStep * kStep;
    for (int p = 0; p < staged; ++p) stage(c4, K, pop, p, 0, K, padded, pal + (size_t)p * tile_f4);
  }
  __syncthreads();

  const size_t n_tiles = ((size_t)P + block_px - 1) / block_px;
  for (size_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    size_t pix[kPx];
    float f[kPx][3];
#pragma unroll
    for (int r = 0; r < kPx; ++r) {
      pix[r] = t * block_px + (size_t)r * groups + gi;
#pragma unroll
      for (int d = 0; d < 3; ++d) f[r][d] = pix[r] < (size_t)P ? x[(size_t)d * P + pix[r]] : 0.0f;
    }
    for (int p0 = 0; p0 < pop; p0 += kNP) {
      // win: the chunk number of a best that moved in the current tile, or
      // after its rescan -(entry + 2); -1 while there is no winner
      float best[kNP][kPx];
      int win[kNP][kPx];
#pragma unroll
      for (int q = 0; q < kNP; ++q) {
#pragma unroll
        for (int r = 0; r < kPx; ++r) {
          best[q][r] = kNeg;
          win[q][r] = -1;
        }
      }
      for (int k0 = 0; k0 < K; k0 += tile) {
        const int n = min(tile, K - k0);
        const int chunks = (n + kStep - 1) / kStep;
        const int c0 = k0 / kStep;  // global number of this tile's first chunk
        const float4* tl = pal + (resident ? (size_t)p0 * tile_f4 : 0);
        if (!resident) {
          __syncthreads();  // the previous tile is consumed
#pragma unroll
          for (int q = 0; q < kNP; ++q) {
            stage(c4, K, pop, p0 + q, k0, n, chunks * kStep, pal + (size_t)q * tile_f4);
          }
          __syncthreads();
        }
        // the max pass: fmaxf over each chunk, a strict `>` per chunk
#pragma unroll 1
        for (int c = 0; c < chunks; ++c) {
          const float4* e = tl + c * kSlots * (kChunk + 1) + lane;
          float m[kNP][kPx];
#pragma unroll
          for (int q = 0; q < kNP; ++q) {
#pragma unroll
            for (int r = 0; r < kPx; ++r) m[q][r] = -INFINITY;
          }
#pragma unroll 1
          for (int j0 = 0; j0 < kChunk; j0 += kUnroll) {
            // j0 is even (kUnroll is) or u is 0: the slot splits into a
            // run-time base and a compile-time offset
            const float4* ej = e + step_slot<kSlots>(j0);
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              const int off = step_slot<kSlots>(u);
#pragma unroll
              for (int q = 0; q < kNP; ++q) {
                const float4 v = ej[(size_t)q * tile_f4 + off];
#pragma unroll
                for (int r = 0; r < kPx; ++r) m[q][r] = fmaxf(m[q][r], score(f[r], v));
              }
            }
          }
#pragma unroll
          for (int q = 0; q < kNP; ++q) {
#pragma unroll
            for (int r = 0; r < kPx; ++r) {
              if (m[q][r] > best[q][r]) {
                best[q][r] = m[q][r];
                win[q][r] = c0 + c;
              }
            }
          }
        }
        // a best that moved in this tile: rescan its chunk for the first equal entry
#pragma unroll
        for (int q = 0; q < kNP; ++q) {
#pragma unroll
          for (int r = 0; r < kPx; ++r) {
            if constexpr (kSlots == 1) {
              if (win[q][r] >= c0) {
                const int cc = win[q][r] - c0;
                const float4* e = tl + (size_t)q * tile_f4 + cc * (kChunk + 1);
                int j = 0;
                while (j < kChunk - 1 && !(score(f[r], e[j]) == best[q][r])) ++j;
                win[q][r] = -(k0 + cc * kChunk + j) - 2;
              }
            } else {
              rescan_group<kSlots>(tl + (size_t)q * tile_f4, f[r], best[q][r], win[q][r], k0, c0,
                                   lane);
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kNP; ++q) {
        const int p = p0 + q;
#pragma unroll
        for (int r = 0; r < kPx; ++r) {
          float b = best[q][r];
          int i = -win[q][r] - 2;  // -1 without a winner
          if constexpr (kSlots > 1) {
#pragma unroll
            for (int off = 1; off < kSlots; off <<= 1) {
              const float ob = __shfl_xor_sync(0xffffffffu, b, off);
              const int oi = __shfl_xor_sync(0xffffffffu, i, off);
              if (ob > b || (ob == b && oi < i)) {
                b = ob;
                i = oi;
              }
            }
          }
          if (p >= pop || lane != 0 || pix[r] >= (size_t)P) continue;
          float* out = opp + (size_t)p * 3 * P + pix[r];
          const float* o = o4 + (size_t)p * 4 * K;
          out[0] = i >= 0 ? o[i] : 0.0f;
          out[P] = i >= 0 ? o[K + i] : 0.0f;
          out[2 * (size_t)P] = i >= 0 ? o[2 * K + i] : 0.0f;
          if (i >= 0) {
            if (shared_hist) {
              atomicAdd(&hist[p * K + i], 1);
            } else {
              atomicAdd(&counts[(size_t)p * K + i], 1);
            }
          }
        }
      }
    }
  }

  if (shared_hist) {
    __syncthreads();
    for (int k = threadIdx.x; k < pop * K; k += blockDim.x) {
      const int h = hist[k];
      if (h != 0) atomicAdd(&counts[k], h);
    }
  }
}

template <int kSlots, int kUnroll, int kNP>
int launch(const float* x, const float* c4, const float* o4, int P, int K, int pop, int threads,
           int blocks, int tile, int tile_f4, int staged, int resident, int shared_hist,
           int smem, float* opp, int* counts, cudaStream_t s) {
  auto kernel = kloop_kernel<kSlots, kUnroll, kNP>;
  const int e = hq_persistent_grid(kernel, threads, smem, &blocks);
  if (e != 0) return e;
  kernel<<<blocks, threads, smem, s>>>(x, c4, o4, P, K, pop, tile, tile_f4, staged, resident != 0,
                                       shared_hist != 0, opp, counts);
  return (int)cudaGetLastError();
}

template <int kSlots, int kNP>
int by_unroll(int unroll, const float* x, const float* c4, const float* o4, int P, int K, int pop,
              int threads, int blocks, int tile, int tile_f4, int staged, int resident,
              int shared_hist, int smem, float* opp, int* counts, cudaStream_t s) {
#define HQ_LAUNCH(U)                                                                              \
  launch<kSlots, U, kNP>(x, c4, o4, P, K, pop, threads, blocks, tile, tile_f4, staged, resident, \
                         shared_hist, smem, opp, counts, s)
  switch (unroll) {
    case 1: return HQ_LAUNCH(1);
    case 4: return HQ_LAUNCH(4);
    case 8: return HQ_LAUNCH(8);
    case 16: return HQ_LAUNCH(16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef HQ_LAUNCH
}

template <int kSlots>
int by_width(int width, int unroll, const float* x, const float* c4, const float* o4, int P, int K,
             int pop, int threads, int blocks, int tile, int tile_f4, int staged, int resident,
             int shared_hist, int smem, float* opp, int* counts, cudaStream_t s) {
#define HQ_WIDTH(NP)                                                                        \
  by_unroll<kSlots, NP>(unroll, x, c4, o4, P, K, pop, threads, blocks, tile, tile_f4, staged, \
                        resident, shared_hist, smem, opp, counts, s)
  switch (width) {
    case 1: return HQ_WIDTH(1);
    case 2: return HQ_WIDTH(2);
    case 4: return HQ_WIDTH(4);
    case 8: return HQ_WIDTH(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef HQ_WIDTH
}

}  // namespace

// x (>= 3 rows, row stride P), c4 and o4 (pop, 4, K), all f32 contiguous;
// opp (pop, 3, P) f32; counts (pop, K) int32, zeroed by the caller. slots 1
// or 8; width the members of one pass over k (1, or 2, 4 or 8 fused);
// unroll 1, 4, 8 or 16; threads a multiple of 32 (and of slots). The plan
// (ops/probe_kernels.kloop_plan): blocks of the persistent grid, entries of
// a staged tile and its float4s, members staged, whether they stay resident,
// whether counts go through shared memory, and the shared bytes. Returns the
// cudaGetLastError() of the launch.
extern "C" int hq_probe_kloop(const float* x, const float* c4, const float* o4, int P, int K,
                              int pop, int slots, int width, int unroll, int threads, int blocks,
                              int tile, int tile_f4, int staged, int resident, int shared_hist,
                              int smem, float* opp, int* counts, void* stream) {
  if (P <= 0 || K <= 0 || pop <= 0 || blocks <= 0 || threads < 32 || threads > 1024 ||
      threads % 32 != 0 || tile <= 0 || tile_f4 <= 0 || staged < width) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (slots == 1) {
    return by_width<1>(width, unroll, x, c4, o4, P, K, pop, threads, blocks, tile, tile_f4, staged,
                       resident, shared_hist, smem, opp, counts, s);
  }
  if (slots == 8) {
    return by_width<8>(width, unroll, x, c4, o4, P, K, pop, threads, blocks, tile, tile_f4, staged,
                       resident, shared_hist, smem, opp, counts, s);
  }
  return (int)cudaErrorInvalidValue;
}
