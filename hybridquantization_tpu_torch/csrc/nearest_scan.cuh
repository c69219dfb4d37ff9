// The nearest-palette scan shared by B1 (assign_pop.cu) and B3
// (assign_idx.cu): the max-then-rescan design of B1.
//
// For a pixel with features f and a palette entry c the score is
// f . c - |c|^2 / 2 (its argmax is the nearest entry), computed as the chain
// fmaf(f2, c2, fmaf(f1, c1, fmaf(f0, c0, bias))) on the packed entry
// (c0, c1, c2, bias), the bias (c0 c0 + c1 c1) + c2 c2 with every product
// and sum rounded on its own (no contraction), then halved, so a stage and
// a rescan of the same entry compute the same bits.
//
// A thread holds kPx pixels in registers (pixel r of a thread at
// r x kScanThreads + its lane, so loads and stores stay coalesced); one
// shared float4 load of an entry, a broadcast across the warp, feeds all
// of them. Over each chunk of kChunk entries a pixel keeps only fmaxf of
// its scores (fmaxf drops NaN, so a NaN never wins; an all-NaN pixel keeps
// no chunk); after the chunk one compare and two selects record a chunk
// maximum strictly above the running best and that chunk's number (with
// kAverage also whether it equals the best, and how many chunks reached
// it). A rescan of the first winning chunk by the same chain in the same
// order then takes its first entry equal to the best, so the winners are
// exactly those of a strict `>` scan in index order.
//
// The palette is staged in shared memory in tiles of kTileK entries, each
// chunk padded to kChunk + 1 float4s (so rescans of different chunks by
// the threads of a warp spread over the banks) and the last chunk filled
// with entries that score -inf; K has no ceiling (callers loop over tiles).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace hq {

constexpr int kScanThreads = 256;  // threads a block
constexpr int kPx = 4;             // pixels a thread
constexpr int kChunk = 16;         // entries a max-then-rescan chunk
constexpr int kTileK = 1024;       // most palette entries a shared tile (17 KB padded)

__device__ __forceinline__ float4 pack_entry(float c0, float c1, float c2) {
  const float sq =
      __fadd_rn(__fadd_rn(__fmul_rn(c0, c0), __fmul_rn(c1, c1)), __fmul_rn(c2, c2));
  return make_float4(c0, c1, c2, __fmul_rn(-0.5f, sq));
}

__device__ __forceinline__ float score(float f0, float f1, float f2, float4 t) {
  return fmaf(f2, t.z, fmaf(f1, t.y, fmaf(f0, t.x, t.w)));
}

// Shared-memory slot of entry j of a staged tile.
__device__ __forceinline__ int tile_slot(int j) { return j / kChunk * (kChunk + 1) + j % kChunk; }

// float4s a staged tile of (up to kTileK of) K entries takes.
__host__ __device__ constexpr int tile_float4s(int K) {
  return ((K < kTileK ? K : kTileK) + kChunk - 1) / kChunk * (kChunk + 1);
}

// Stage entries [k0, k0 + n) into the padded tile, entry(k) giving the
// packed entry k, the last chunk filled with entries scoring -inf. Callers
// synchronise around it.
template <class Entry>
__device__ __forceinline__ void stage(Entry entry, int k0, int n, float4* tile) {
  const int padded = (n + kChunk - 1) / kChunk * kChunk;
  for (int j = threadIdx.x; j < padded; j += kScanThreads) {
    tile[tile_slot(j)] = j < n ? entry(k0 + j) : make_float4(0.0f, 0.0f, 0.0f, -INFINITY);
  }
}

// The max pass over a staged tile of n entries whose first chunk is chunk
// number c0 of the palette: best, win (the first chunk whose maximum is the
// best, -1 for none) and, with kAverage, wins (chunks whose maximum equals
// the best) carried from tile to tile.
template <bool kAverage>
__device__ __forceinline__ void scan_tile(const float4* tile, int n, int c0,
                                          const float (&f)[kPx][3], float (&best)[kPx],
                                          int (&win)[kPx], int (&wins)[kPx]) {
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
#pragma unroll
    for (int r = 0; r < kPx; ++r) {
      if (kAverage && m[r] == best[r]) wins[r] += 1;
      if (m[r] > best[r]) {
        best[r] = m[r];
        win[r] = c0 + c;
        wins[r] = 1;
      }
    }
  }
}

}  // namespace hq
