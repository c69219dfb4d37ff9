// B1: population nearest-palette assignment with winner colour and counts.
//
// Replaces the TPU kernel hybridquantization_tpu/ops/pallas_assign.py
// (_assign_opp_pop_kernel, :238-311; pallas_call in assign_opp_pop, :371).
// For every image b, member p and pixel i: the palette entries k maximising
// f_i . c_k - |c_k|^2 / 2 (= nearest in the feature space), a NaN score
// never winning, and from them the winner's opponent colour and per-entry
// counts. Two tie modes, as the Pallas kernel's:
//  - first:   the first index of the maximum wins; counts are pixel counts;
//  - average: every entry that reaches the maximum is a hit
//             (pallas_assign.py:231-235, :262-267); the colour is the sum of
//             the hits' colours in index order times 1 / max(hits, 1)
//             (:288-290), and every hit adds one to its entry's count, so
//             counts are hits and `counts > 0` is the usage flag.
// Two score precisions: fp32, and the TPU's single-pass bf16 dot
// (pallas_assign.py:175-176): each feature and palette coordinate is rounded
// to bf16, the bias -|c|^2/2 is formed in f32 from the unrounded palette and
// then rounded (pack_palette, :129-133), and since a bf16 x bf16 product is
// exact in f32 the FMA chain below computes bias + f0 c0 + f1 c1 + f2 c2
// with one f32 rounding per add. The bias is formed with explicit _rn
// operations in a fixed order, so the plain torch version repeats every
// bf16 score bit for bit. The image axis is the grid's y dimension: one
// launch serves a bucket of same-size images, each with its own palettes.
//
// What bounds it on the H100: fp32 instruction issue. The scan's work is 3
// FMAs per (member, pixel, entry) (4 x 8.3 M x 256 entries at 4K/K256/pop4,
// 0.76 ms at the fp32 FMA peak) against 48 bytes of pixel traffic per
// pixel. The earlier design issued about 7 instructions per such triple: a
// shared load of the entry per pixel, 3 FMAs, a compare and two selects
// of the running best and its index. This design issues about 4.3 (on an
// H100 80GB HBM3 at 700 W, first/fp32 at 4K/K256/pop4: 1.737 ms against
// the earlier 2.479, chip_smoke.py; of 2 or 4 pixels a thread and chunks of
// 8 or 16, timed against each other while the kernel was built, 4 and 16
// were the fastest):
//  - kPx pixels per thread (pixel r of a thread at r x 256 + its lane, so
//    loads and stores stay coalesced): one shared float4 load of an entry,
//    a broadcast across the warp, feeds all of them;
//  - a max-then-rescan scan: over each chunk of kChunk entries a pixel keeps
//    only fmaxf of its scores (fmaxf drops NaN, so a NaN never wins; an
//    all-NaN pixel keeps index -1); after the chunk one compare and two
//    selects record a chunk maximum strictly above the running best and
//    that chunk's number (in average mode: whether it equals the best, and
//    how many chunks reached it). After the scan one rescan of the first
//    winning chunk, by the same FMA chain in the same order, takes its first
//    entry equal to the best, so winners are exactly those of a strict `>`
//    scan in index order: first index within the chunk, and across chunks
//    because the chunk is the first to reach the best. In average mode the
//    rescan of the winning chunk counts and sums its hits in index order; a
//    pixel whose best is reached in two or more chunks (duplicate entries
//    in different chunks) rescans from the first of them to the end;
//  - a first small kernel packs each palette entry once as a (c0, c1, c2,
//    bias) float4, the counterpart of JAX's pack_palette; the main kernel
//    stages those in shared memory in tiles of kTileK entries, each chunk
//    padded to kChunk + 1 float4s (so the rescans of different chunks by the
//    threads of a warp spread over the banks) and the last chunk filled with
//    entries that score -inf, and loops over the tiles, so K has no ceiling
//    (a rescan of a chunk in an earlier tile reads the packed entries from
//    device memory);
//  - counts go to a per-block shared-memory int32 histogram, then to the
//    global counts with one int32 atomicAdd per non-empty bin. Integer
//    atomics are exact and their order does not matter. K above kHistK adds
//    straight to global memory;
//  - shared memory is sized for K (dynamic), so a small palette leaves room
//    for the most blocks per SM.
// The bf16 mode runs on the same fp32 pipes (its products are exact there),
// so it costs what fp32 costs. A tensor-core score tile does not beat three
// FMAs and a max here (PERF.md, the assignment probes T1-T8).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPx = 4;       // pixels per thread
constexpr int kChunk = 16;   // entries per max-then-rescan chunk
constexpr int kTileK = 1024;  // most palette entries per shared tile (17 KB padded)
constexpr int kHistK = 4096;  // K up to this uses the shared histogram (up to 16 KB)

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Pack every palette entry (all images and members) once: c4 = (c0, c1,
// c2, -|c|^2/2), the bias (c0 c0 + c1 c1) + c2 c2 with every product and
// sum rounded on its own (no contraction), then halved; in bf16 mode all
// four then rounded.
__global__ void __launch_bounds__(kThreads)
pack_kernel(const float* __restrict__ pal, int n, bool bf16, float4* __restrict__ c4) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float* c = pal + (size_t)i * 3;
  const float c0 = c[0], c1 = c[1], c2 = c[2];
  const float sq =
      __fadd_rn(__fadd_rn(__fmul_rn(c0, c0), __fmul_rn(c1, c1)), __fmul_rn(c2, c2));
  const float bias = __fmul_rn(-0.5f, sq);
  c4[i] = bf16 ? make_float4(bf16_round(c0), bf16_round(c1), bf16_round(c2), bf16_round(bias))
               : make_float4(c0, c1, c2, bias);
}

__device__ __forceinline__ float score(float f0, float f1, float f2, float4 t) {
  return fmaf(f2, t.z, fmaf(f1, t.y, fmaf(f0, t.x, t.w)));
}

// Stage packed entries [k0, k0 + n) of one member into the padded tile,
// the last chunk filled with entries scoring -inf. Callers synchronise
// around it.
__device__ __forceinline__ void stage(const float4* c4, int k0, int n, float4* tile) {
  const int padded = (n + kChunk - 1) / kChunk * kChunk;
  for (int j = threadIdx.x; j < padded; j += kThreads) {
    tile[j / kChunk * (kChunk + 1) + j % kChunk] =
        j < n ? c4[k0 + j] : make_float4(0.0f, 0.0f, 0.0f, -INFINITY);
  }
}

template <bool kAverage>
__global__ void __launch_bounds__(kThreads)
assign_pop_kernel(const float* __restrict__ feats, const float4* __restrict__ c4,
                  const float* __restrict__ opp_pal, int P, int K, int pop, bool bf16,
                  float* __restrict__ opp_out, int* __restrict__ counts,
                  int* __restrict__ idx_out) {
  // dynamic shared memory, sized for this K by hq_assign_pop: tile, hist
  extern __shared__ float4 smem[];
  float4* tile = smem;
  const int tile_chunks = (min(K, kTileK) + kChunk - 1) / kChunk;
  int* hist = reinterpret_cast<int*>(smem + tile_chunks * (kChunk + 1));

  // image b of the bucket: its pixels, palettes and outputs
  const size_t b = blockIdx.y;
  feats += b * P * 3;
  c4 += b * pop * K;
  opp_pal += b * pop * K * 3;
  opp_out += b * pop * 3 * P;
  counts += b * pop * K;
  if (idx_out != nullptr) idx_out += b * pop * P;

  size_t pix[kPx];
  bool active[kPx];
  float f[kPx][3];
#pragma unroll
  for (int r = 0; r < kPx; ++r) {
    pix[r] = (size_t)blockIdx.x * (kThreads * kPx) + r * kThreads + threadIdx.x;
    active[r] = pix[r] < (size_t)P;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float v = active[r] ? feats[pix[r] * 3 + d] : 0.0f;
      f[r][d] = bf16 ? bf16_round(v) : v;
    }
  }
  const bool shared_hist = K <= kHistK;
  const bool one_tile = K <= kTileK;  // the tile still holds every chunk after the scan

  for (int p = 0; p < pop; ++p) {
    const float4* mc4 = c4 + (size_t)p * K;
    const float* oc = opp_pal + (size_t)p * K * 3;
    int* member_counts = counts + (size_t)p * K;
    auto count = [&](int k) {
      if (shared_hist) {
        atomicAdd(&hist[k], 1);
      } else {
        atomicAdd(&member_counts[k], 1);
      }
    };
    // entry k of this member: from the tile while it holds it, else from
    // device memory
    auto entry = [&](int k) {
      return one_tile ? tile[k / kChunk * (kChunk + 1) + k % kChunk] : mc4[k];
    };
    if (shared_hist) {
      for (int k = threadIdx.x; k < K; k += kThreads) hist[k] = 0;
    }
    float best[kPx];
    int win[kPx];   // the first chunk whose maximum is the best, -1 for none
    int wins[kPx];  // average mode: chunks whose maximum equals the best
#pragma unroll
    for (int r = 0; r < kPx; ++r) {
      best[r] = -INFINITY;
      win[r] = -1;
      wins[r] = 0;
    }
    for (int k0 = 0; k0 < K; k0 += kTileK) {
      const int n = min(kTileK, K - k0);
      __syncthreads();  // the previous tile is consumed; hist is zeroed
      stage(mc4, k0, n, tile);
      __syncthreads();
      const int chunks = (n + kChunk - 1) / kChunk;
      for (int c = 0; c < chunks; ++c) {
        const float4* e = tile + c * (kChunk + 1);
        float m[kPx];
#pragma unroll
        for (int r = 0; r < kPx; ++r) m[r] = -INFINITY;
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const float4 t = e[j];
#pragma unroll
          for (int r = 0; r < kPx; ++r) m[r] = fmaxf(m[r], score(f[r][0], f[r][1], f[r][2], t));
        }
        const int cg = k0 / kChunk + c;
#pragma unroll
        for (int r = 0; r < kPx; ++r) {
          if (kAverage && m[r] == best[r]) wins[r] += 1;
          if (m[r] > best[r]) {
            best[r] = m[r];
            win[r] = cg;
            wins[r] = 1;
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kPx; ++r) {
      // the winner: the first entry of the first winning chunk that reaches
      // the best (a real entry: padding scores -inf, below any best that won)
      const bool won = active[r] && win[r] >= 0;
      int bi = -1;
      float o0 = 0.0f, o1 = 0.0f, o2 = 0.0f;
      int hits = 0;
      if (won) {
        const int lo = win[r] * kChunk;
        // first mode, or average with one winning chunk: that chunk; two or
        // more: from it to the end
        const int hi = kAverage && wins[r] > 1 ? K : min(lo + kChunk, K);
        for (int k = lo; k < hi; ++k) {
          if (score(f[r][0], f[r][1], f[r][2], entry(k)) == best[r]) {
            if (bi < 0) bi = k;
            if (!kAverage) break;
            const float* o = oc + (size_t)k * 3;
            o0 += o[0];
            o1 += o[1];
            o2 += o[2];
            hits += 1;
            count(k);
          }
        }
        if (!kAverage) {
          const float* o = oc + (size_t)bi * 3;
          o0 = o[0];
          o1 = o[1];
          o2 = o[2];
          count(bi);
        } else {
          const float inv = 1.0f / fmaxf((float)hits, 1.0f);
          o0 *= inv;
          o1 *= inv;
          o2 *= inv;
        }
      }
      if (active[r]) {
        float* out = opp_out + (size_t)p * 3 * P;
        out[pix[r]] = o0;
        out[(size_t)P + pix[r]] = o1;
        out[2 * (size_t)P + pix[r]] = o2;
        if (idx_out != nullptr) idx_out[(size_t)p * P + pix[r]] = bi;
      }
    }

    if (shared_hist) {
      __syncthreads();
      for (int k = threadIdx.x; k < K; k += kThreads) {
        const int h = hist[k];
        if (h != 0) atomicAdd(&member_counts[k], h);
      }
      __syncthreads();  // flushed before the next member zeroes hist
    }
  }
}

int launch_scan(bool average, int B, int P, int K, int pop, bool bf16, const float* feats,
                const float4* c4, const float* opp_pal, float* opp_out, int* counts,
                int* idx_out, cudaStream_t s) {
  const dim3 grid((unsigned)(((size_t)P + kThreads * kPx - 1) / (kThreads * kPx)), (unsigned)B);
  // only what this K needs (about 5 KB at K=256), so a small palette does
  // not hold an SM to fewer blocks
  const int chunks = (min(K, kTileK) + kChunk - 1) / kChunk;
  const size_t smem = (size_t)chunks * (kChunk + 1) * sizeof(float4) +
                      (K <= kHistK ? (size_t)K * sizeof(int) : 0);
  if (average) {
    assign_pop_kernel<true><<<grid, kThreads, smem, s>>>(
        feats, c4, opp_pal, P, K, pop, bf16, opp_out, counts, idx_out);
  } else {
    assign_pop_kernel<false><<<grid, kThreads, smem, s>>>(
        feats, c4, opp_pal, P, K, pop, bf16, opp_out, counts, idx_out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// feats (B, P, 3), pal and opp_pal (B, pop, K, 3), all f32 contiguous;
// packed: (B, pop, K, 4) f32 scratch for the packed palettes; opp_out (B,
// pop, 3, P) f32; counts (B, pop, K) int32, zeroed by the caller; idx_out
// (B, pop, P) int32 (the first index of the maximum, -1 where no score is a
// number) or null. bf16: round the score operands to bf16; average:
// tie_mode "average". Returns the first non-zero cudaGetLastError() of the
// two launches.
extern "C" int hq_assign_pop(const float* feats, const float* pal, const float* opp_pal, int B,
                             int P, int K, int pop, int bf16, int average, float* packed,
                             float* opp_out, int* counts, int* idx_out, void* stream) {
  if (B <= 0 || B > 65535 || P <= 0 || K <= 0 || pop <= 0) return (int)cudaErrorInvalidValue;
  const int entries = B * pop * K;
  float4* c4 = reinterpret_cast<float4*>(packed);
  cudaStream_t s = (cudaStream_t)stream;
  pack_kernel<<<(entries + kThreads - 1) / kThreads, kThreads, 0, s>>>(pal, entries, bf16 != 0,
                                                                     c4);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_scan(average != 0, B, P, K, pop, bf16 != 0, feats, c4, opp_pal, opp_out, counts,
                     idx_out, s);
}
