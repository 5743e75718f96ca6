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

// True when 16-byte loads of rows of W words starting at ``base`` stay
// aligned.
inline bool vec_rows(const void* base, int64_t W) {
  return (reinterpret_cast<uintptr_t>(base) & 15) == 0 && (W & 3) == 0;
}
