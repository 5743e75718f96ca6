// The AND-NOT + popcount word op under every gain kernel, and the warp
// reductions the sender (greedy_pick.cu) and receiver (bucket_insert.cu)
// build their sweeps from.  Replaces the shared Pallas tile body
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
