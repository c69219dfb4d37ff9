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
// What bounds it on the H100: fp32 instruction rate. The scan costs 3 FMAs, a compare
// and a select per (member, pixel, entry): 4 x 8.3 M x 256 entries at
// 4K/K256/pop4, against 48 bytes of pixel traffic per pixel. The design:
//  - one thread per pixel, features held in registers and read once for the
//    whole population (the member loop runs inside the block);
//  - a first small kernel packs each palette entry once as a (c0, c1, c2,
//    bias) float4, the counterpart of JAX's pack_palette; the main kernel
//    stages those in shared memory in tiles of kTileK entries, read by every
//    thread of a warp at the same address (a broadcast), and loops over the
//    tiles, so K has no ceiling;
//  - the scan is a strict `>` in index order, which keeps first-index ties
//    exact (Mosaic's argmax got them wrong on hardware) and lets no NaN win;
//  - average mode scans once too, counting the entries that equal the
//    running maximum (registers only). A pixel with one hit takes its
//    winner's colour as in first mode; only a pixel with two or more scans
//    its tiles again past the first, summing the hits' colours and counting
//    them;
//  - counts go to a per-block shared-memory int32 histogram, then to the
//    global counts with one int32 atomicAdd per non-empty bin. Integer
//    atomics are exact and their order does not matter. K above kHistK adds
//    straight to global memory;
//  - shared memory is sized for K (dynamic), so a small palette leaves room
//    for the most blocks per SM.
// The bf16 mode runs on the same fp32 pipes (its products are exact there),
// so it costs what fp32 costs. Several pixels per thread and a tensor-core
// formulation of the score tile are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileK = 1024;  // most palette entries per shared tile (16 KB)
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

// Stage packed entries [k0, k0 + n) of one member into shared memory.
// Callers synchronise around it.
__device__ __forceinline__ void stage(const float4* c4, int k0, int n, float4* tile) {
  for (int j = threadIdx.x; j < n; j += kThreads) tile[j] = c4[k0 + j];
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
  int* hist = reinterpret_cast<int*>(smem + min(K, kTileK));

  // image b of the bucket: its pixels, palettes and outputs
  const size_t b = blockIdx.y;
  feats += b * P * 3;
  c4 += b * pop * K;
  opp_pal += b * pop * K * 3;
  opp_out += b * pop * 3 * P;
  counts += b * pop * K;
  if (idx_out != nullptr) idx_out += b * pop * P;

  const size_t pix = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const bool active = pix < (size_t)P;
  float f0 = 0.0f, f1 = 0.0f, f2 = 0.0f;
  if (active) {
    f0 = feats[pix * 3 + 0];
    f1 = feats[pix * 3 + 1];
    f2 = feats[pix * 3 + 2];
    if (bf16) {
      f0 = bf16_round(f0);
      f1 = bf16_round(f1);
      f2 = bf16_round(f2);
    }
  }
  const bool shared_hist = K <= kHistK;

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
    if (shared_hist) {
      for (int k = threadIdx.x; k < K; k += kThreads) hist[k] = 0;
    }
    float best = -INFINITY;
    int bi = -1;
    int hits = 0;  // average mode: entries equal to the running maximum
    for (int k0 = 0; k0 < K; k0 += kTileK) {
      const int n = min(kTileK, K - k0);
      __syncthreads();  // the previous tile is consumed; hist is zeroed
      stage(mc4, k0, n, tile);
      __syncthreads();
#pragma unroll 8
      for (int j = 0; j < n; ++j) {
        const float s = score(f0, f1, f2, tile[j]);
        if (!kAverage) {
          if (s > best) {
            best = s;
            bi = k0 + j;
          }
        } else if (s >= best) {  // rare once the maximum has settled
          if (s > best) {
            hits = 1;
            bi = k0 + j;
            best = s;
          } else {
            // an empty asm keeps this a branch: if-converted into selects, the
            // update costs every entry three more instructions
            asm volatile("" ::: "memory");
            hits += 1;
          }
        }
      }
    }

    const bool won = active && bi >= 0;
    float o0 = 0.0f, o1 = 0.0f, o2 = 0.0f;
    if (won) {
      count(bi);
      const float* o = oc + (size_t)bi * 3;
      o0 = o[0];
      o1 = o[1];
      o2 = o[2];
    }
    if (kAverage) {
      // two or more hits: their colours summed in index order from the
      // first, and the later hits counted, from a second scan past bi
      const bool many = won && hits > 1;
      auto add_hit = [&](int k) {
        const float* o = oc + (size_t)k * 3;
        o0 += o[0];
        o1 += o[1];
        o2 += o[2];
        count(k);
      };
      if (K <= kTileK) {
        if (many) {
          for (int j = bi + 1; j < K; ++j) {
            if (score(f0, f1, f2, tile[j]) == best) add_hit(j);
          }
        }
      } else if (__syncthreads_or(many)) {
        for (int k0 = 0; k0 < K; k0 += kTileK) {
          const int n = min(kTileK, K - k0);
          __syncthreads();
          stage(mc4, k0, n, tile);
          __syncthreads();
          if (many) {
            for (int j = max(bi + 1 - k0, 0); j < n; ++j) {
              if (score(f0, f1, f2, tile[j]) == best) add_hit(k0 + j);
            }
          }
        }
      }
      if (won) {
        const float inv = 1.0f / fmaxf((float)hits, 1.0f);
        o0 *= inv;
        o1 *= inv;
        o2 *= inv;
      }
    }

    if (active) {
      float* out = opp_out + (size_t)p * 3 * P;
      out[pix] = o0;
      out[(size_t)P + pix] = o1;
      out[2 * (size_t)P + pix] = o2;
      if (idx_out != nullptr) idx_out[(size_t)p * P + pix] = bi;
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
  const dim3 grid((unsigned)(((size_t)P + kThreads - 1) / kThreads), (unsigned)B);
  // only what this K needs (5 KB at K=256), so a small palette does not hold
  // an SM to fewer blocks
  const size_t smem = (size_t)min(K, kTileK) * sizeof(float4) +
                      (K <= kHistK ? (size_t)K * sizeof(int) : 0);
  if (average) {
    assign_pop_kernel<true><<<grid, kThreads, smem, s>>>(feats, c4, opp_pal, P, K, pop,
                                                         bf16 != 0, opp_out, counts, idx_out);
  } else {
    assign_pop_kernel<false><<<grid, kThreads, smem, s>>>(feats, c4, opp_pal, P, K, pop,
                                                          bf16 != 0, opp_out, counts, idx_out);
  }
  return (int)cudaGetLastError();
}
