// The AND-NOT + popcount word op under every gain kernel, and the warp
// reductions the senders (greedy_core.cuh), the receiver
// (bucket_insert.cu) and the gain sweeps (coverage.cu, topk_gain.cu)
// build from.  Replaces the shared Pallas tile body
// repro/kernels/gain_core.py:28-48 (andnot_popcount, gain_tile_sum); it
// is a device helper, not a launch of its own.
#pragma once
#include <cstdint>

// popcount(x & ~cover): the gain of one incidence word against a cover.
__device__ __forceinline__ int andnot_popc(uint32_t x, uint32_t cover) {
  return __popc(x & ~cover);
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    unsigned long long o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

// Gain of one row against a cover, one warp per row, lanes along the
// words; every lane returns the sum.  With ``vec`` (row and cover
// 16-byte aligned, W a multiple of 4) each lane loads 16 bytes at once.
__device__ __forceinline__ int warp_row_gain(const uint32_t* row,
                                             const uint32_t* cov, int64_t W,
                                             bool vec, int lane) {
  int g = 0;
  if (vec) {
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
    const uint4* c4 = reinterpret_cast<const uint4*>(cov);
    for (int64_t i = lane; i < (W >> 2); i += 32) {
      const uint4 a = r4[i], c = c4[i];
      g += andnot_popc(a.x, c.x) + andnot_popc(a.y, c.y) +
           andnot_popc(a.z, c.z) + andnot_popc(a.w, c.w);
    }
  } else {
    for (int64_t w = lane; w < W; w += 32) g += andnot_popc(row[w], cov[w]);
  }
  return warp_sum(g);
}

// Gains of one row against G covers at once (cover q at covs + q * W,
// in shared memory), one warp per row, lanes along the words: each word
// of the row is loaded once, through the read-only path, and folded
// against the G covers' matching words — one global load and G shared
// loads a word.  With ``vec`` each lane keeps eight 16-byte chunks in
// flight, and the count of four chunks is skipped where they are zero
// in every lane of the warp.  Every lane returns the G sums.
template <int G>
__device__ __forceinline__ void warp_row_gains(const uint32_t* row,
                                               const uint32_t* covs,
                                               int64_t W, bool vec, int lane,
                                               int (&g)[G]) {
#pragma unroll
  for (int q = 0; q < G; ++q) g[q] = 0;
  if (vec) {
    constexpr int U = 8;
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
    const uint4* c4 = reinterpret_cast<const uint4*>(covs);
    const int64_t W4 = W >> 2;
    int64_t base = 0;  // warp-uniform, for the vote below
    for (; base + 32 * U <= W4; base += 32 * U) {
      const int64_t i = base + lane;
      uint4 a[U];
#pragma unroll
      for (int u = 0; u < U; ++u) a[u] = __ldg(r4 + i + 32 * u);
#pragma unroll
      for (int h = 0; h < U; h += 4) {
        // chunks zero in every lane gain nothing for any query: skip
        // their count and their covers' loads (incidence rows are sparse)
        uint32_t any = 0;
#pragma unroll
        for (int u = h; u < h + 4; ++u) any |= a[u].x | a[u].y | a[u].z | a[u].w;
        if (!__any_sync(0xffffffffu, any)) continue;
#pragma unroll
        for (int q = 0; q < G; ++q)
#pragma unroll
          for (int u = h; u < h + 4; ++u) {
            const uint4 c = c4[q * W4 + i + 32 * u];
            g[q] += andnot_popc(a[u].x, c.x) + andnot_popc(a[u].y, c.y) +
                    andnot_popc(a[u].z, c.z) + andnot_popc(a[u].w, c.w);
          }
      }
    }
    for (int64_t i = base + lane; i < W4; i += 32) {
      const uint4 a = __ldg(r4 + i);
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const uint4 c = c4[q * W4 + i];
        g[q] += andnot_popc(a.x, c.x) + andnot_popc(a.y, c.y) +
                andnot_popc(a.z, c.z) + andnot_popc(a.w, c.w);
      }
    }
  } else {
    for (int64_t w = lane; w < W; w += 32) {
      const uint32_t x = __ldg(row + w);
#pragma unroll
      for (int q = 0; q < G; ++q) g[q] += andnot_popc(x, covs[q * W + w]);
    }
  }
#pragma unroll
  for (int q = 0; q < G; ++q) g[q] = warp_sum(g[q]);
}

// True when 16-byte loads of rows of W words starting at ``base`` stay
// aligned.
inline bool vec_rows(const void* base, int64_t W) {
  return (reinterpret_cast<uintptr_t>(base) & 15) == 0 && (W & 3) == 0;
}
