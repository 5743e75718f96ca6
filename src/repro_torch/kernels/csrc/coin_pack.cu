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
// elsewhere.  The expansion's result is the same word for word.  The
// plane is built only for the streamed layout (IC --gather streamed):
// rrr_expand_ic (rrr_expand.cu) draws the same coins where it needs
// them and builds no plane.
//
// Bound on the H100: the plane write (bytes) on sparse frontiers, the
// threefry hashes (integer operations, threefry.cuh) on dense ones.  At
// the IMM's first step the plane is n x d_pad x W = 262,144 x 16 x 1,024
// words (17.2 GB) and almost every word is zero, so the design serves
// the store rate:
//   - a block takes a run of vertices, its threads along w, four words
//     a thread (a power of two of threads a vertex, so (v, word) comes
//     from shifts of the thread index: no 64-bit division anywhere);
//   - a thread loads its four frontier words once (one 16-byte load)
//     and walks the vertex's slots in the order c, then j, which takes
//     the place of s / chunk; each slot is one 16-byte streaming store
//     (the plane cannot stay in the 50 MB L2);
//   - a thread whose four words are zero stores d_pad zero chunks and
//     reads neither a key nor a probability;
//   - the draw index ((32w + b) n + v) chunk + j passes 2^32 at real
//     sizes: it is kept in 64 bits, a base per word plus b n chunk a
//     bit, and split into threefry's (hi, lo) words as jax's
//     iota_2x32_shape does.
// A W that is not a multiple of 4, or a frontier or plane that is not
// 16-byte aligned, takes 4-byte loads and stores (the last thread of a
// row holds fewer than four words).
#include <cstdint>
#include <cuda_runtime.h>

#include "gain_core.cuh"
#include "kernel_table.cuh"
#include "threefry.cuh"

constexpr int kCoinThreads = 256;

// The fired bits of frontier word ``f``: bit b draws index base + b * nc.
__device__ __forceinline__ uint32_t fired(uint32_t f, uint32_t k0,
                                          uint32_t k1, uint64_t base,
                                          uint64_t nc, float p) {
  uint32_t out = 0;
  while (f) {
    const int b = __ffs(f) - 1;
    f &= f - 1;
    if (coin_fires(k0, k1, base + (uint64_t)b * nc, p)) out |= 1u << b;
  }
  return out;
}

template <bool Vec>
__global__ void __launch_bounds__(kCoinThreads) coin_pack_kernel(
    const uint32_t* __restrict__ keys, const float* __restrict__ prob_p,
    const uint32_t* __restrict__ frontier, int64_t n, int64_t n_chunks,
    int64_t chunk, int64_t W, int tpv_log2, uint32_t* __restrict__ plane) {
  const int64_t v = (int64_t)blockIdx.x * (kCoinThreads >> tpv_log2) +
                    (threadIdx.x >> tpv_log2);
  if (v >= n) return;
  const int tpv = 1 << tpv_log2;
  const int64_t d_pad = n_chunks * chunk;
  const int64_t quads = (W + 3) >> 2;
  const uint64_t nc = (uint64_t)n * (uint64_t)chunk;
  const uint32_t* fv = frontier + v * W;
  const float* pv = prob_p + v * d_pad;
  for (int64_t i = threadIdx.x & (tpv - 1); i < quads; i += tpv) {
    const int64_t w0 = 4 * i;
    uint32_t f[4];
    if (Vec) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(fv) + i);
      f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    } else {
#pragma unroll
      for (int x = 0; x < 4; ++x) f[x] = w0 + x < W ? __ldg(fv + w0 + x) : 0u;
    }
    uint32_t* out = plane + v * d_pad * W + w0;  // slot s at out + s * W
    auto store = [&](uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
      if (Vec) {
        __stcs(reinterpret_cast<uint4*>(out), make_uint4(a, b, c, d));
      } else {
        const uint32_t r[4] = {a, b, c, d};
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (w0 + x < W) __stcs(out + x, r[x]);
      }
      out += W;
    };
    if (!(f[0] | f[1] | f[2] | f[3])) {
      for (int64_t s = 0; s < d_pad; ++s) store(0u, 0u, 0u, 0u);
      continue;
    }
    uint64_t base[4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
      base[x] = ((uint64_t)(32 * (w0 + x)) * (uint64_t)n + (uint64_t)v) *
                (uint64_t)chunk;
    const float* p = pv;
    for (int64_t c = 0; c < n_chunks; ++c) {
      const uint32_t k0 = __ldg(keys + 2 * c), k1 = __ldg(keys + 2 * c + 1);
      for (int64_t j = 0; j < chunk; ++j) {
        const float pj = __ldg(p++);
        if (pj > 0.0f)
          store(fired(f[0], k0, k1, base[0] + j, nc, pj),
                fired(f[1], k0, k1, base[1] + j, nc, pj),
                fired(f[2], k0, k1, base[2] + j, nc, pj),
                fired(f[3], k0, k1, base[3] + j, nc, pj));
        else
          store(0u, 0u, 0u, 0u);
      }
    }
  }
}

extern "C" int coin_pack(const void* keys, const void* prob_p,
                         const void* frontier, void* plane, int64_t n,
                         int64_t d_pad, int64_t chunk, int64_t W,
                         void* stream) {
  // threads a vertex: one a four-word chunk of its row, a power of two,
  // at most the block
  const int64_t quads = (W + 3) >> 2;
  int tpv_log2 = 0;
  while ((1 << tpv_log2) < quads && (1 << tpv_log2) < kCoinThreads)
    ++tpv_log2;
  const int64_t per_block = kCoinThreads >> tpv_log2;
  const int64_t blocks = (n + per_block - 1) / per_block;
  const int64_t n_chunks = d_pad / chunk;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec_rows(frontier, W) && vec_rows(plane, W))
    coin_pack_kernel<true><<<(unsigned)blocks, kCoinThreads, 0, s>>>(
        (const uint32_t*)keys, (const float*)prob_p,
        (const uint32_t*)frontier, n, n_chunks, chunk, W, tpv_log2,
        (uint32_t*)plane);
  else
    coin_pack_kernel<false><<<(unsigned)blocks, kCoinThreads, 0, s>>>(
        (const uint32_t*)keys, (const float*)prob_p,
        (const uint32_t*)frontier, n, n_chunks, chunk, W, tpv_log2,
        (uint32_t*)plane);
  return (int)cudaGetLastError();
}

// The dynamic shared memory of a launch (kernel_table.cuh): none.
extern "C" int64_t launch_smem(const char* launch, int64_t, int64_t) {
  return same_launch(launch, "coin_pack") ? 0 : -1;
}

static const KernelEntry kKernels[] = {
    {"coin_pack", "coin_pack_kernel<true>",
     (const void*)coin_pack_kernel<true>, kCoinThreads},
    {"coin_pack", "coin_pack_kernel<false>",
     (const void*)coin_pack_kernel<false>, kCoinThreads},
};
KERNEL_TABLE_EXPORTS(kKernels)
