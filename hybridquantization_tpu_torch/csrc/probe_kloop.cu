// T1, T2: B1's first-index assignment as a k-loop over the palette.
//
// Replaces the TPU probes tools/vpu_assign_exp.py make_vpu_kernel (:138-222,
// pallas_call in run_vpu, :235) and make_grp8_kernel (:47-135, pallas_call
// in _grp8_call, :272). Both compute one function: for every member p and
// pixel i the first entry k maximising the score
//   s = (x0 c0 + x1 c1) + (x2 c2 + cb)
// (cb the bias row -|c|^2/2 of the packed palette), every product and sum
// rounded on its own (__fmul_rn/__fadd_rn: nvcc would otherwise contract to
// FMAs, and the plain torch version rounds each operation), scanned with a
// strict `>` from a best of -1e30, so NaN and scores at or below -1e30 never
// win; then the winner's opponent colour (0 without a winner) and int32
// counts per entry. The probes' schedules become template parameters:
//  - SLOTS=1 (T1: pixels on lanes, palette entry broadcast): one thread per
//    pixel scans K and tracks the winner's colour by selects, as T1 does;
//  - SLOTS=8 (T2: eight sublane slots): eight lanes of a warp share a pixel,
//    lane j scanning entries j, j + 8, ...; the eight merge with
//    __shfl_xor_sync by max score, then min index (vpu_assign_exp.py:100-107),
//    and the winner's colour is read after the merge;
//  - FUSED (T1's `fused`): every member's compare chain shares one pass over
//    k (registers for at most kMaxFused members);
//  - UNROLL: entries per step of the scan, unrolled by hand (T1's `unroll`).
// Palettes are staged in shared memory in tiles, as B1 stages them (no K
// ceiling); counts go through a shared int32 histogram, then atomics.
//
// What bounds it on the H100: fp32 instruction rate, as B1: 3 multiplies,
// 3 adds, a compare and the selects per (member, pixel, entry), against 28
// bytes of pixel traffic per pixel. It is a probe: it measures these
// schedules against B1 (csrc/assign_pop.cu, which fuses the score into 3
// FMAs), not a replacement of it.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float kNeg = -1e30f;  // vpu_assign_exp.py:93, :154
constexpr int kMaxFused = 8;
constexpr int kTileEntries = 1024;  // (c, o) float4 pairs per block: 32 KB
constexpr int kHistInts = 4096;     // pop * K up to this counts in shared memory

__device__ __forceinline__ float score(float x0, float x1, float x2, float4 c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x0, c.x), __fmul_rn(x1, c.y)),
                   __fadd_rn(__fmul_rn(x2, c.z), c.w));
}

struct Chain {
  float best, b0, b1, b2;
  int idx;
};

__device__ __forceinline__ void init(Chain& ch) {
  ch.best = kNeg;
  ch.b0 = ch.b1 = ch.b2 = 0.0f;
  ch.idx = -1;
}

__device__ __forceinline__ void step(Chain& ch, float s, float4 o, int k) {
  if (s > ch.best) {
    ch.best = s;
    ch.b0 = o.x;
    ch.b1 = o.y;
    ch.b2 = o.z;
    ch.idx = k;
  }
}

// Stage entries [k0, k0 + n) of member p as (c0, c1, c2, cb) and (o0, o1,
// o2, 0) float4s from the (pop, 4, K) arrays. Callers synchronise around it.
__device__ __forceinline__ void stage(const float* c4, const float* o4, int K, int p, int k0,
                                      int n, float4* cs, float4* os) {
  const float* c = c4 + (size_t)p * 4 * K + k0;
  const float* o = o4 + (size_t)p * 4 * K + k0;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    cs[j] = make_float4(c[j], c[K + j], c[2 * K + j], c[3 * K + j]);
    os[j] = make_float4(o[j], o[K + j], o[2 * K + j], 0.0f);
  }
}

// One member's chain over a staged tile of n entries starting at entry k0:
// this lane's entries lane, lane + SLOTS, ..., UNROLL per step.
template <int kSlots, int kUnroll>
__device__ __forceinline__ void scan(Chain& ch, float x0, float x1, float x2, const float4* cs,
                                     const float4* os, int k0, int n, int lane) {
  const int steps = (n - lane + kSlots - 1) / kSlots;  // entries of this lane
  int s = 0;
  for (; s + kUnroll <= steps; s += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = (s + u) * kSlots + lane;
      step(ch, score(x0, x1, x2, cs[j]), os[j], k0 + j);
    }
  }
  for (; s < steps; ++s) {
    const int j = s * kSlots + lane;
    step(ch, score(x0, x1, x2, cs[j]), os[j], k0 + j);
  }
}

// Merge the SLOTS lanes of a pixel (max score, then min index) and return
// the winner's colour; every lane of the warp takes part.
template <int kSlots>
__device__ __forceinline__ void finish(Chain& ch, const float* o4, int K, int p) {
  if constexpr (kSlots > 1) {
#pragma unroll
    for (int off = 1; off < kSlots; off <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, ch.best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, ch.idx, off);
      if (ob > ch.best || (ob == ch.best && oi < ch.idx)) {
        ch.best = ob;
        ch.idx = oi;
      }
    }
    ch.b0 = ch.b1 = ch.b2 = 0.0f;
    if (ch.idx >= 0) {
      const float* o = o4 + (size_t)p * 4 * K + ch.idx;
      ch.b0 = o[0];
      ch.b1 = o[K];
      ch.b2 = o[2 * K];
    }
  }
}

template <int kSlots, bool kFused, int kUnroll>
__global__ void kloop_kernel(const float* __restrict__ x, const float* __restrict__ c4,
                             const float* __restrict__ o4, int P, int K, int pop, int tile,
                             bool shared_hist, float* __restrict__ opp, int* __restrict__ counts) {
  extern __shared__ float4 smem[];
  const int tile_all = kFused ? tile * pop : tile;
  float4* cs = smem;
  float4* os = smem + tile_all;
  int* hist = reinterpret_cast<int*>(smem + 2 * tile_all);

  const int per_block = blockDim.x / kSlots;
  const int lane = threadIdx.x % kSlots;
  const size_t pix = (size_t)blockIdx.x * per_block + threadIdx.x / kSlots;
  const bool active = pix < (size_t)P;
  const float x0 = active ? x[pix] : 0.0f;
  const float x1 = active ? x[(size_t)P + pix] : 0.0f;
  const float x2 = active ? x[2 * (size_t)P + pix] : 0.0f;
  if (shared_hist) {
    for (int k = threadIdx.x; k < pop * K; k += blockDim.x) hist[k] = 0;
  }

  auto emit = [&](const Chain& ch, int p) {
    if (!active || lane != 0) return;
    float* out = opp + (size_t)p * 3 * P;
    out[pix] = ch.b0;
    out[(size_t)P + pix] = ch.b1;
    out[2 * (size_t)P + pix] = ch.b2;
    if (ch.idx >= 0) {
      if (shared_hist) {
        atomicAdd(&hist[p * K + ch.idx], 1);
      } else {
        atomicAdd(&counts[(size_t)p * K + ch.idx], 1);
      }
    }
  };

  if (!kFused) {
    for (int p = 0; p < pop; ++p) {
      Chain ch;
      init(ch);
      for (int k0 = 0; k0 < K; k0 += tile) {
        const int n = min(tile, K - k0);
        __syncthreads();  // the previous tile is consumed; hist is zeroed
        stage(c4, o4, K, p, k0, n, cs, os);
        __syncthreads();
        scan<kSlots, kUnroll>(ch, x0, x1, x2, cs, os, k0, n, lane);
      }
      finish<kSlots>(ch, o4, K, p);
      emit(ch, p);
    }
  } else {
    Chain ch[kMaxFused];
#pragma unroll
    for (int p = 0; p < kMaxFused; ++p) init(ch[p]);
    for (int k0 = 0; k0 < K; k0 += tile) {
      const int n = min(tile, K - k0);
      __syncthreads();
      for (int p = 0; p < pop; ++p) stage(c4, o4, K, p, k0, n, cs + p * tile, os + p * tile);
      __syncthreads();
      const int steps = (n - lane + kSlots - 1) / kSlots;
      int s = 0;
      for (; s + kUnroll <= steps; s += kUnroll) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = (s + u) * kSlots + lane;
#pragma unroll
          for (int p = 0; p < kMaxFused; ++p) {
            if (p < pop) {
              step(ch[p], score(x0, x1, x2, cs[p * tile + j]), os[p * tile + j], k0 + j);
            }
          }
        }
      }
      for (; s < steps; ++s) {
        const int j = s * kSlots + lane;
#pragma unroll
        for (int p = 0; p < kMaxFused; ++p) {
          if (p < pop) step(ch[p], score(x0, x1, x2, cs[p * tile + j]), os[p * tile + j], k0 + j);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kMaxFused; ++p) {
      if (p < pop) {
        finish<kSlots>(ch[p], o4, K, p);
        emit(ch[p], p);
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

template <int kSlots, bool kFused, int kUnroll>
int launch(const float* x, const float* c4, const float* o4, int P, int K, int pop, int threads,
           float* opp, int* counts, cudaStream_t s) {
  const int k8 = (K + 7) / 8 * 8;
  int tile = kFused ? max(8, kTileEntries / pop / 8 * 8) : kTileEntries;
  tile = min(tile, k8);
  const bool shared_hist = pop * K <= kHistInts;
  const size_t smem = 2 * (size_t)tile * (kFused ? pop : 1) * sizeof(float4) +
                      (shared_hist ? (size_t)pop * K * sizeof(int) : 0);
  const int per_block = threads / kSlots;
  const unsigned blocks = (unsigned)(((size_t)P + per_block - 1) / per_block);
  kloop_kernel<kSlots, kFused, kUnroll><<<blocks, threads, smem, s>>>(
      x, c4, o4, P, K, pop, tile, shared_hist, opp, counts);
  return (int)cudaGetLastError();
}

template <int kSlots, bool kFused>
int by_unroll(int unroll, const float* x, const float* c4, const float* o4, int P, int K, int pop,
              int threads, float* opp, int* counts, cudaStream_t s) {
  switch (unroll) {
    case 1: return launch<kSlots, kFused, 1>(x, c4, o4, P, K, pop, threads, opp, counts, s);
    case 4: return launch<kSlots, kFused, 4>(x, c4, o4, P, K, pop, threads, opp, counts, s);
    case 8: return launch<kSlots, kFused, 8>(x, c4, o4, P, K, pop, threads, opp, counts, s);
    case 16: return launch<kSlots, kFused, 16>(x, c4, o4, P, K, pop, threads, opp, counts, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (>= 3 rows, row stride P), c4 and o4 (pop, 4, K), all f32 contiguous;
// opp (pop, 3, P) f32; counts (pop, K) int32, zeroed by the caller. slots 1
// or 8; fused 0 or 1 (at most 8 members); unroll 1, 4, 8 or 16; threads a
// multiple of 32. Returns the cudaGetLastError() of the launch.
extern "C" int hq_probe_kloop(const float* x, const float* c4, const float* o4, int P, int K,
                              int pop, int slots, int fused, int unroll, int threads, float* opp,
                              int* counts, void* stream) {
  if (P <= 0 || K <= 0 || pop <= 0 || threads < 32 || threads > 1024 || threads % 32 != 0 ||
      (fused && pop > kMaxFused)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (slots == 1) {
    return fused ? by_unroll<1, true>(unroll, x, c4, o4, P, K, pop, threads, opp, counts, s)
                 : by_unroll<1, false>(unroll, x, c4, o4, P, K, pop, threads, opp, counts, s);
  }
  if (slots == 8) {
    return fused ? by_unroll<8, true>(unroll, x, c4, o4, P, K, pop, threads, opp, counts, s)
                 : by_unroll<8, false>(unroll, x, c4, o4, P, K, pop, threads, opp, counts, s);
  }
  return (int)cudaErrorInvalidValue;
}
