// B3: nearest-palette index, and the Lloyd step built on it, for a batch
// of (features, palette) problems in one grid.
//
// Replaces the TPU kernel hybridquantization_tpu/ops/pallas_assign.py
// (_assign_idx_kernel, :314-323; pallas_call in assign_idx, :420) and, in
// the Lloyd-step mode, the segment sums JAX takes beside it
// (hybridquantization_tpu/ops/assign.py:175-176, ops/kmeans.py:104-107).
// A problem (f, m) is feature set f, P rows of 3 floats with optional
// weights, against palette m of K entries of that feature set (the members
// of one image, the images of a bucket: the axes JAX vmaps). For every row:
// the palette entry maximising f . c - |c|^2 / 2 (= nearest in the feature
// space), first index on ties, a NaN score never winning, -1 where no
// score is a number.
//  - index mode (hq_assign_idx): the (F, M, P) int32 indices;
//  - Lloyd-step mode (hq_lloyd_step): the (F, M, K, 3) palettes with every
//    entry moved to the weighted mean of its rows, entries with no weight
//    keeping their colour, rows with index -1 dropped: the port's
//    centroid_update(rows, index, palette, weights) with its float64 sums
//    and totals, the mean cast to f32 once.
//
// What bounds it on the H100: fp32 instruction issue, as for B1. The scan
// costs 3 FMAs per (row, entry) (a 4K frame at K=256: 0.19 ms at the fp32
// FMA peak) against 16 bytes of traffic a row (12 in, 4 out or the weight).
// The design:
//  - the scan of nearest_scan.cuh (B1's: 4 rows a thread, chunks of 16
//    entries scanned with fmaxf alone, a strict `>` against the running
//    best, one rescan of the first winning chunk); each block packs its
//    problem's palette into a shared tile, looped over above kTileK;
//  - the grid is (row blocks, M, F), so a bucket's seeding step (16 images
//    x 4 members x 32,768 bins) or polish step is one launch that fills
//    the card; a row block is kRows-row tiles, as many a block as keep a
//    problem to kMaxBlocks blocks, so the partial sums stay small;
//  - the Lloyd step's sums never leave the block as float64 atomics: a
//    block sorts each tile's rows by winner in shared memory, stably (a
//    warp's lanes ranked by __match_any_sync, the warps' counts per entry
//    turned into positions in warp order, per-entry offsets by a block
//    scan), and a thread per entry adds its rows in row order into the
//    block's float64 (sum w x0, sum w x1, sum w x2, sum w) in shared
//    memory. The block writes them as its partial; a second kernel adds a
//    problem's partials in block order (each warp an entry, lanes strided
//    over the blocks, a fixed shuffle tree) and writes the mean. Every
//    order is fixed by the row and block numbers, so a step's output is
//    the same bits run to run, and a problem's output does not depend on
//    the other problems of its launch. Above kLloydMaxK entries the sums
//    do not fit in shared memory: the wrapper runs the index mode and its
//    plain sums instead.
// A tensor-core score tile is left for later work: for B1 it did not beat
// three FMAs and a max (PERF.md, the assignment probes T1-T8).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "nearest_scan.cuh"

namespace {

using hq::kChunk;
using hq::kPx;
using hq::kTileK;
constexpr int kThreads = hq::kScanThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kThreads * kPx;  // rows a tile: 1024
constexpr int kLloydMaxK = 2048;       // most entries of a Lloyd step (its sums in shared memory)

// Shared bytes of the Lloyd mode: the palette tile, a tile's sorted rows,
// the f64 sums, the per-entry counts (K + 1), the warps' counts and totals.
size_t lloyd_smem(int K) {
  return ((size_t)hq::tile_float4s(K) + kRows) * sizeof(float4) + (size_t)K * 4 * sizeof(double) +
         ((size_t)K + 1 + (size_t)kWarps * K + kWarps) * sizeof(int);
}

// In place: a[k] <- a[0] + ... + a[k - 1] for k < K, a[K] <- the total.
// Every thread of the block calls it.
__device__ void exclusive_scan(int* a, int K, int* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (K + kThreads - 1) / kThreads;
  const int lo = min((int)threadIdx.x * per, K), hi = min(lo + per, K);
  int own = 0;
  for (int k = lo; k < hi; ++k) own += a[k];
  int inc = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += v;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  int acc = inc - own;
  for (int v = 0; v < warp; ++v) acc += warp_tot[v];
  for (int k = lo; k < hi; ++k) {
    const int c = a[k];
    a[k] = acc;
    acc += c;
  }
  if (threadIdx.x == kThreads - 1) a[K] = acc;
  __syncthreads();
}

template <bool kLloyd>
__global__ void __launch_bounds__(kThreads)
b3_kernel(const float* __restrict__ feats, const float* __restrict__ weights,
          const float* __restrict__ pal, int P, int K, int M, int tiles_per_block,
          int* __restrict__ idx_out, double* __restrict__ partials) {
  // dynamic shared memory: the tile; in Lloyd mode also rows, sums, run, wc, warp_tot
  extern __shared__ float4 smem[];
  float4* tile = smem;
  float4* rows = tile + hq::tile_float4s(K);  // a tile's (x0, x1, x2, w), sorted by winner
  double* sums = reinterpret_cast<double*>(rows + kRows);  // (K, 4)
  int* run = reinterpret_cast<int*>(sums + (size_t)4 * K);  // counts, then offsets (K + 1)
  int* wc = run + K + 1;                                     // (kWarps, K) warp counts
  int* warp_tot = wc + kWarps * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // problem (f, m): feature set f's rows against member m's palette
  const size_t f = blockIdx.z, prob = f * M + blockIdx.y;
  feats += f * P * 3;
  if (weights != nullptr) weights += f * P;
  pal += prob * K * 3;
  auto packed = [&](int k) {
    const float* c = pal + (size_t)k * 3;
    return hq::pack_entry(c[0], c[1], c[2]);
  };
  const bool one_tile = K <= kTileK;  // the tile holds the palette for every row tile
  if (one_tile) hq::stage(packed, 0, K, tile);
  if (kLloyd) {
    for (int i = threadIdx.x; i < 4 * K; i += kThreads) sums[i] = 0.0;
    for (int i = threadIdx.x; i < kWarps * K; i += kThreads) wc[i] = 0;
  }

  const size_t first = (size_t)blockIdx.x * tiles_per_block * kRows;
  for (int t = 0; t < tiles_per_block; ++t) {
    const size_t base = first + (size_t)t * kRows;
    if (base >= (size_t)P) break;  // the same for every thread of the block
    size_t pix[kPx];
    bool active[kPx];
    float x[kPx][3], w[kPx];
#pragma unroll
    for (int r = 0; r < kPx; ++r) {
      pix[r] = base + r * kThreads + threadIdx.x;
      active[r] = pix[r] < (size_t)P;
#pragma unroll
      for (int d = 0; d < 3; ++d) x[r][d] = active[r] ? feats[pix[r] * 3 + d] : 0.0f;
      w[r] = weights != nullptr && active[r] ? weights[pix[r]] : 1.0f;
    }
    float best[kPx];
    int win[kPx], wins[kPx];
#pragma unroll
    for (int r = 0; r < kPx; ++r) {
      best[r] = -INFINITY;
      win[r] = -1;
      wins[r] = 0;
    }
    if (one_tile) {
      __syncthreads();  // the tile is staged (and the sums zeroed)
      hq::scan_tile<false>(tile, K, 0, x, best, win, wins);
    } else {
      for (int k0 = 0; k0 < K; k0 += kTileK) {
        const int n = min(kTileK, K - k0);
        __syncthreads();  // the previous tile is consumed
        hq::stage(packed, k0, n, tile);
        __syncthreads();
        hq::scan_tile<false>(tile, n, k0 / kChunk, x, best, win, wins);
      }
    }
    // each row's winner: the first entry of its first winning chunk that
    // reaches its best (a real entry: padding scores -inf, below any best
    // that won); -1 for an inactive row or one with no number among its scores
    int bi[kPx];
#pragma unroll
    for (int r = 0; r < kPx; ++r) {
      bi[r] = -1;
      if (active[r] && win[r] >= 0) {
        const int lo = win[r] * kChunk, hi = min(lo + kChunk, K);
        for (int k = lo; k < hi; ++k) {
          const float4 e = one_tile ? tile[hq::tile_slot(k)] : packed(k);
          if (hq::score(x[r][0], x[r][1], x[r][2], e) == best[r]) {
            bi[r] = k;
            break;
          }
        }
      }
    }
    if (!kLloyd) {
#pragma unroll
      for (int r = 0; r < kPx; ++r) {
        if (active[r]) idx_out[prob * P + pix[r]] = bi[r];
      }
      continue;
    }

    // Lloyd mode: the tile's rows sorted by winner, in row order within an
    // entry. Row r x kThreads + i of the tile is thread i's row r: rounds r
    // in order, warps in order within a round, lanes within a warp.
    for (int k = threadIdx.x; k < K; k += kThreads) run[k] = 0;
    __syncthreads();
    const unsigned below = (1u << lane) - 1u;
    int rel[kPx];  // a row's position among its entry's rows of the tile
#pragma unroll
    for (int r = 0; r < kPx; ++r) {
      const int k = bi[r];
      const unsigned peers = __match_any_sync(0xffffffffu, k);
      const int rank = __popc(peers & below);
      const bool lead = k >= 0 && rank == 0;
      if (lead) wc[warp * K + k] = __popc(peers);
      __syncthreads();
      // per entry, each warp's count becomes its first position (warps in
      // order after the rows of the earlier rounds); wc stays 0 elsewhere
      for (int e = threadIdx.x; e < K; e += kThreads) {
        int acc = run[e];
#pragma unroll
        for (int v = 0; v < kWarps; ++v) {
          const int c = wc[v * K + e];
          if (c != 0) {
            wc[v * K + e] = acc;
            acc += c;
          }
        }
        run[e] = acc;
      }
      __syncthreads();
      rel[r] = k >= 0 ? wc[warp * K + k] + rank : 0;
      __syncwarp();
      if (lead) wc[warp * K + k] = 0;
      __syncwarp();
    }
    exclusive_scan(run, K, warp_tot);  // run[k]: entry k's first row; run[K]: the tile's rows
#pragma unroll
    for (int r = 0; r < kPx; ++r) {
      if (bi[r] >= 0) rows[run[bi[r]] + rel[r]] = make_float4(x[r][0], x[r][1], x[r][2], w[r]);
    }
    __syncthreads();
    // a thread per entry adds its rows, in row order, to the block's sums
    // (w x is exact in f64, so fma rounds as the plain version's add)
    for (int k = threadIdx.x; k < K; k += kThreads) {
      const int lo = run[k], hi = run[k + 1];
      if (lo == hi) continue;
      double s0 = sums[4 * k], s1 = sums[4 * k + 1], s2 = sums[4 * k + 2], sw = sums[4 * k + 3];
      for (int i = lo; i < hi; ++i) {
        const float4 v = rows[i];
        const double dw = (double)v.w;
        s0 = fma((double)v.x, dw, s0);
        s1 = fma((double)v.y, dw, s1);
        s2 = fma((double)v.z, dw, s2);
        sw += dw;
      }
      sums[4 * k] = s0;
      sums[4 * k + 1] = s1;
      sums[4 * k + 2] = s2;
      sums[4 * k + 3] = sw;
    }
    __syncthreads();  // rows and run are free for the next tile
  }

  if (kLloyd) {
    __syncthreads();
    double* out = partials + (prob * gridDim.x + blockIdx.x) * (size_t)K * 4;
    for (int i = threadIdx.x; i < 4 * K; i += kThreads) out[i] = sums[i];
  }
}

// A problem's partials (blocks, K, 4) added in block order, a warp per
// entry (lanes strided over the blocks, then a fixed shuffle tree); the
// entry moves to sum / max(total, 1) cast to f32 where the total is above
// 0 and keeps its colour elsewhere (centroid_update's rule).
__global__ void __launch_bounds__(kThreads)
lloyd_finish_kernel(const double* __restrict__ partials, const float* __restrict__ pal, int K,
                    int M, int blocks, float* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = blockIdx.x * kWarps + warp;
  if (k >= K) return;  // a whole warp
  const size_t prob = (size_t)blockIdx.z * M + blockIdx.y;
  const double* p = partials + prob * blocks * (size_t)K * 4 + (size_t)k * 4;
  double s0 = 0.0, s1 = 0.0, s2 = 0.0, sw = 0.0;
  for (int b = lane; b < blocks; b += 32) {
    const double2 a = *reinterpret_cast<const double2*>(p + (size_t)b * K * 4);
    const double2 c = *reinterpret_cast<const double2*>(p + (size_t)b * K * 4 + 2);
    s0 += a.x;
    s1 += a.y;
    s2 += c.x;
    sw += c.y;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    s0 += __shfl_down_sync(0xffffffffu, s0, d);
    s1 += __shfl_down_sync(0xffffffffu, s1, d);
    s2 += __shfl_down_sync(0xffffffffu, s2, d);
    sw += __shfl_down_sync(0xffffffffu, sw, d);
  }
  if (lane != 0) return;
  const float* c = pal + (prob * K + k) * 3;
  float* o = out + (prob * K + k) * 3;
  if (sw > 0.0) {
    const double t = fmax(sw, 1.0);
    o[0] = (float)(s0 / t);
    o[1] = (float)(s1 / t);
    o[2] = (float)(s2 / t);
  } else {
    o[0] = c[0];
    o[1] = c[1];
    o[2] = c[2];
  }
}

bool bad_shape(int F, int M, int P, int K) {
  return F <= 0 || F > 65535 || M <= 0 || M > 65535 || P <= 0 || K <= 0;
}

}  // namespace

// feats (F, P, 3) and pal (F, M, K, 3), f32 contiguous; idx_out (F, M, P)
// int32. Returns cudaGetLastError() of the launch.
extern "C" int hq_assign_idx(const float* feats, const float* pal, int F, int M, int P, int K,
                             int* idx_out, void* stream) {
  if (bad_shape(F, M, P, K)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(((size_t)P + kRows - 1) / kRows), (unsigned)M, (unsigned)F);
  const size_t smem = (size_t)hq::tile_float4s(K) * sizeof(float4);
  b3_kernel<false><<<grid, kThreads, smem, (cudaStream_t)stream>>>(feats, nullptr, pal, P, K, M,
                                                                    1, idx_out, nullptr);
  return (int)cudaGetLastError();
}

// feats (F, P, 3), weights (F, P) or null (every weight 1), pal (F, M, K, 3),
// all f32 contiguous, K <= kLloydMaxK; blocks row blocks a problem of
// tiles_per_block tiles of kRows rows, covering P with none empty;
// partials (F, M, blocks, K, 4) f64 scratch; out (F, M, K, 3) f32. Returns
// the first non-zero cudaGetLastError() of the two launches.
extern "C" int hq_lloyd_step(const float* feats, const float* weights, const float* pal, int F,
                             int M, int P, int K, int blocks, int tiles_per_block,
                             double* partials, float* out, void* stream) {
  const size_t span = (size_t)tiles_per_block * kRows;
  if (bad_shape(F, M, P, K) || K > kLloydMaxK || blocks <= 0 || blocks > 65535 ||
      tiles_per_block <= 0 || (size_t)blocks * span < (size_t)P ||
      (size_t)(blocks - 1) * span >= (size_t)P) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = lloyd_smem(K);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        b3_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  b3_kernel<true><<<dim3((unsigned)blocks, (unsigned)M, (unsigned)F), kThreads, smem, s>>>(
      feats, weights, pal, P, K, M, tiles_per_block, nullptr, partials);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  lloyd_finish_kernel<<<dim3((unsigned)((K + kWarps - 1) / kWarps), (unsigned)M, (unsigned)F),
                        kThreads, 0, s>>>(partials, pal, K, M, blocks, out);
  return (int)cudaGetLastError();
}
