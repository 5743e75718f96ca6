// The random bits of the IC coins and the LT live-edge uniforms:
// threefry-2x32 (20 rounds) as jax.random draws them in partitionable
// mode, and the mapping of 32 bits to a float32 uniform in [0, 1).
// Shared by coin_pack.cu (the coin plane) and rrr_expand.cu (the IC and
// LT sampler and cascade steps, which draw inside the expansion); a
// device helper, not a launch of its own.
#pragma once
#include <cstdint>

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define TF_ROUND(r) \
  { x0 += x1; x1 = rotl(x1, r); x1 ^= x0; }

// threefry-2x32, 20 rounds (jax/_src/prng.py _threefry2x32_lowering);
// the bits of element (x0, x1) = (hi, lo) of the 64-bit flat index.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

#undef TF_ROUND

// uniform(key)[idx], with jax.random.uniform's mapping: (bits >> 9) |
// 0x3f800000 read as a float, minus 1 (exact: the float lies in [1, 2)).
__device__ __forceinline__ float uniform_at(uint32_t k0, uint32_t k1,
                                            uint64_t idx) {
  const uint32_t bits =
      threefry_bits(k0, k1, (uint32_t)(idx >> 32), (uint32_t)idx);
  return __uint_as_float((bits >> 9) | 0x3f800000u) - 1.0f;
}

// True iff uniform(key)[idx] < p.
__device__ __forceinline__ bool coin_fires(uint32_t k0, uint32_t k1,
                                           uint64_t idx, float p) {
  return uniform_at(k0, k1, idx) < p;
}
