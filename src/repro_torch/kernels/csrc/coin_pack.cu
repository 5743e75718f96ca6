// The IC coin plane of one BFS step, restricted to the frontier:
//   plane[v, s, w] bit b = frontier[v, w] bit b
//                          & (uniform(key[c])[32w + b, v, j] < prob_p[v, s])
// with s = c * chunk + j.  The coin term is bit-identical to the
// reference's XLA-side draw (repro/core/rrr.py:309-325, a
// jax.random.uniform of shape [batch, n, chunk] per chunk key
// fold_in(sub, c), then _pack_batch_lane).  There is no TPU kernel for
// it: the reference draws every coin of every (sample, vertex, slot).
//
// The expansion reads plane[v, s, w] only where frontier[v, w] != 0
// (rrr_expand.cu ANDs the plane word with that frontier word), so coins
// of samples whose frontier does not hold v can never matter; this
// kernel hashes only the set bits of the frontier word and writes zero
// elsewhere.  The expansion's result is the same word for word.
//
// Bound on the H100: the plane write (bytes) on sparse frontiers, the
// threefry hashes (integer operations: 20 rounds of add/rotate/xor plus
// 5 key injections, ~90 ops per coin; threefry.cuh) on dense ones.
// The expansion's IC route no longer reads this plane: rrr_expand_ic
// (rrr_expand.cu) draws the same coins where it needs them, so the
// plane is built only for the streamed layout.  One thread per
// output word, threads along w so the frontier read and the plane write
// coalesce; 32-bit rotates are funnel shifts.  The flat draw index
// (b * n + v) * chunk + j passes 2^32 at real sizes, so it is split
// into the (hi, lo) counter words exactly as jax's iota_2x32_shape.
#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

__global__ void coin_pack_kernel(const uint32_t* __restrict__ keys,
                                 const float* __restrict__ prob_p,
                                 const uint32_t* __restrict__ frontier,
                                 int64_t n, int64_t d_pad, int64_t chunk,
                                 int64_t W, uint32_t* __restrict__ plane) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * d_pad * W) return;
  const int64_t w = t % W;
  const int64_t vs = t / W;
  const int64_t s = vs % d_pad;
  const int64_t v = vs / d_pad;
  uint32_t f = frontier[v * W + w];
  const float p = prob_p[v * d_pad + s];
  uint32_t out = 0;
  if (p > 0.0f) {
    const int64_t c = s / chunk;
    const int64_t j = s - c * chunk;
    const uint32_t k0 = keys[2 * c], k1 = keys[2 * c + 1];
    while (f) {
      const int bit = __ffs(f) - 1;
      f &= f - 1;
      const uint64_t idx =
          ((uint64_t)(32 * w + bit) * (uint64_t)n + (uint64_t)v) *
              (uint64_t)chunk + (uint64_t)j;
      if (coin_fires(k0, k1, idx, p)) out |= 1u << bit;
    }
  }
  plane[t] = out;
}

extern "C" int coin_pack(const void* keys, const void* prob_p,
                         const void* frontier, void* plane, int64_t n,
                         int64_t d_pad, int64_t chunk, int64_t W,
                         void* stream) {
  const int threads = 256;
  const int64_t total = n * d_pad * W;
  const int64_t blocks = (total + threads - 1) / threads;
  coin_pack_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)keys, (const float*)prob_p,
      (const uint32_t*)frontier, n, d_pad, chunk, W, (uint32_t*)plane);
  return (int)cudaGetLastError();
}
