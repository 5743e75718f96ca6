// One packed BFS / cascade expansion step:
//   hit[u, w] = OR_s frontier[fwd_nbr[u, s], w] & mask(u, s, w)
//   new = hit & ~visited;  visited_out = visited | new
// Replaces repro/kernels/rrr_expand.py: rrr_expand_step_resident_pallas
// (mask = plane[gidx[u, s], w], gidx == rows reading zero) and
// rrr_expand_step_pallas (mask = gmask[u, s, w], pre-gathered).
//
// Bound on the H100: bytes.  Each output word costs df frontier loads
// and a handful of integer ops.  One thread per output word (u, w),
// threads along w, so the frontier-row and mask-row gathers of a warp
// coalesce; blocks run over the flattened (u, w) index, so a small W
// (down to one word) still fills every lane.  The mask word is loaded
// only where the gathered frontier word is non-zero: late BFS steps
// have sparse frontiers, and the plane load is most of the traffic.
// There is no on-chip tiling of the forward-slot axis: each thread
// loops over all df slots and ORs into a register, so hub rows cost
// time, not scratch.  Invalid slots follow the reference's contract:
// fwd_nbr is pre-clipped to 0 and the mask word is zero (gmask) or
// gidx names row `rows`, read as zero (resident).  The IC sampler's
// step is rrr_expand_ic at the end of this file: the resident layout
// with the coin plane drawn in the kernel instead of read from HBM.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "threefry.cuh"

struct PlaneMask {  // resident layout
  const uint32_t* plane;
  const int32_t* gidx;
  int64_t rows;
  __device__ __forceinline__ uint32_t operator()(int64_t u, int s, int df,
                                                 int64_t w,
                                                 int64_t W) const {
    const int64_t g = gidx[u * df + s];
    return g < rows ? plane[g * W + w] : 0u;
  }
};

struct GatheredMask {  // streamed layout
  const uint32_t* gmask;
  __device__ __forceinline__ uint32_t operator()(int64_t u, int s, int df,
                                                 int64_t w,
                                                 int64_t W) const {
    return gmask[(u * df + s) * W + w];
  }
};

template <class Mask>
__global__ void expand_kernel(const uint32_t* __restrict__ frontier,
                              const uint32_t* __restrict__ visited,
                              const int32_t* __restrict__ fwd_nbr,
                              Mask mask, int64_t n, int df, int64_t W,
                              uint32_t* __restrict__ new_frontier,
                              uint32_t* __restrict__ visited_out) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * W) return;
  const int64_t u = t / W;
  const int64_t w = t - u * W;
  uint32_t hit = 0;
  for (int s = 0; s < df; ++s) {
    const int64_t v = fwd_nbr[u * df + s];
    const uint32_t f = frontier[v * W + w];
    if (f) hit |= f & mask(u, s, df, w, W);
  }
  const uint32_t vis = visited[t];
  const uint32_t nw = hit & ~vis;
  new_frontier[t] = nw;
  visited_out[t] = vis | nw;
}

static constexpr int kThreads = 256;

template <class Mask>
static int launch(const void* frontier, const void* visited,
                  const void* fwd_nbr, Mask mask, int64_t n, int64_t df,
                  int64_t W, void* new_frontier, void* visited_out,
                  void* stream) {
  const int64_t total = n * W;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  expand_kernel<Mask><<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)frontier, (const uint32_t*)visited,
      (const int32_t*)fwd_nbr, mask, n, (int)df, W,
      (uint32_t*)new_frontier, (uint32_t*)visited_out);
  return (int)cudaGetLastError();
}

extern "C" int rrr_expand_resident(const void* frontier, const void* visited,
                                   const void* fwd_nbr, const void* gidx,
                                   const void* plane, void* new_frontier,
                                   void* visited_out, int64_t n, int64_t df,
                                   int64_t W, int64_t rows, void* stream) {
  PlaneMask m{(const uint32_t*)plane, (const int32_t*)gidx, rows};
  return launch(frontier, visited, fwd_nbr, m, n, df, W, new_frontier,
                visited_out, stream);
}

extern "C" int rrr_expand_streamed(const void* frontier, const void* visited,
                                   const void* fwd_nbr, const void* gmask,
                                   void* new_frontier, void* visited_out,
                                   int64_t n, int64_t df, int64_t W,
                                   void* stream) {
  GatheredMask m{(const uint32_t*)gmask};
  return launch(frontier, visited, fwd_nbr, m, n, df, W, new_frontier,
                visited_out, stream);
}

// IC sampling step with the coins drawn in the expansion
// (rrr_expand_ic):
//   hit[u, w] = OR over valid s of frontier[v, w] & coin(v, rslot, w)
// with v = nbr_c[u, s], g = gidx[u, s] = v * d_pad + rslot (g == n *
// d_pad marks an invalid slot), and bit b of coin(v, rslot, w) set iff
// uniform(keys[c])[idx] < prob_p.flat[g], c = rslot / chunk, j = rslot
// % chunk, idx = ((32w + b) * n + v) * chunk + j: the reference's coin
// draw (repro/core/rrr.py:309-325) fused into
// rrr_expand_step_resident_pallas (repro/kernels/rrr_expand.py:351).
// The result is word for word rrr_expand_resident(coin_pack(...)), and
// the [n, d_pad, W] coin plane between them never reaches HBM (each
// edge is one forward slot, so each coin is hashed once, as coin_pack
// hashes it).
//
// Bound on the H100: bytes on the sampler's sparse frontiers (each
// frontier word read once, visited read, two outputs written, nbr_c,
// gidx and prob_p); the hashes' integer operations (~80 a coin) only
// where frontier words are dense.  One thread per output word (u, w),
// threads along w so the frontier gathers of a warp coalesce, with
// 32-bit index arithmetic: rows of u are cut into bands of at most 2^31
// threads (blockIdx.y), so the one division a thread makes (its row in
// the band) and the one a live slot makes (its chunk) are 32-bit.  A
// slot is skipped before its frontier load when invalid, and before any
// hash when its frontier word is zero or its probability is not above
// zero (such a coin never fires).  The draw index of bit b is the
// slot's base index plus b * n * chunk, so a coin costs one 64-bit
// multiply-add besides the hash.  A warp waits for its lane with the
// most set bits; on the sampler's frontiers (a bit or two per non-zero
// word) that costs under 0.1% more hash rounds than a perfect spread of
// each warp's coins over its lanes (chip_smoke.py, phase timing), so the
// bits are not redistributed with warp shuffles.
__global__ void expand_ic_kernel(const uint32_t* __restrict__ frontier,
                                 const uint32_t* __restrict__ visited,
                                 const int32_t* __restrict__ nbr_c,
                                 const int32_t* __restrict__ gidx,
                                 const float* __restrict__ prob_p,
                                 const uint32_t* __restrict__ keys,
                                 uint32_t n, int df, uint32_t d_pad,
                                 uint32_t chunk, uint32_t W,
                                 uint32_t band_rows,
                                 uint32_t* __restrict__ new_frontier,
                                 uint32_t* __restrict__ visited_out) {
  const uint32_t local = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t du = local / W;
  const uint32_t u = blockIdx.y * band_rows + du;
  if (du >= band_rows || u >= n) return;
  const uint32_t w = local - du * W;
  const uint32_t sentinel = n * d_pad;
  const uint64_t bit_stride = (uint64_t)n * chunk;
  const int32_t* g_row = gidx + (uint64_t)u * df;
  const int32_t* v_row = nbr_c + (uint64_t)u * df;
  uint32_t hit = 0;
  for (int s = 0; s < df; ++s) {
    const uint32_t g = (uint32_t)g_row[s];
    if (g >= sentinel) continue;
    const uint32_t v = (uint32_t)v_row[s];
    uint32_t f = frontier[(uint64_t)v * W + w];
    if (!f) continue;
    const float p = prob_p[g];
    if (!(p > 0.0f)) continue;
    const uint32_t rslot = g - v * d_pad;
    const uint32_t c = rslot / chunk;
    const uint32_t j = rslot - c * chunk;
    const uint32_t k0 = keys[2 * c], k1 = keys[2 * c + 1];
    const uint64_t base = ((uint64_t)(32u * w) * n + v) * chunk + j;
    while (f) {
      const int bit = __ffs(f) - 1;
      f &= f - 1;
      if (coin_fires(k0, k1, base + (uint64_t)bit * bit_stride, p))
        hit |= 1u << bit;
    }
  }
  const uint64_t t = (uint64_t)u * W + w;
  const uint32_t vis = visited[t];
  const uint32_t nw = hit & ~vis;
  new_frontier[t] = nw;
  visited_out[t] = vis | nw;
}

extern "C" int rrr_expand_ic(const void* frontier, const void* visited,
                             const void* nbr_c, const void* gidx,
                             const void* prob_p, const void* keys,
                             void* new_frontier, void* visited_out,
                             int64_t n, int64_t df, int64_t d_pad,
                             int64_t chunk, int64_t W, void* stream) {
  // 32-bit indices: the sentinel n * d_pad is an int32 gidx entry, and
  // the sample index 32 * W fits in 32 bits.
  if (n * d_pad >= (int64_t(1) << 31) || 32 * W >= (int64_t(1) << 32))
    return (int)cudaErrorInvalidValue;
  const int64_t band_rows = std::min<int64_t>(n, (int64_t(1) << 31) / W);
  const int64_t bands = (n + band_rows - 1) / band_rows;
  if (bands > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)((band_rows * W + kThreads - 1) / kThreads),
                  (unsigned)bands);
  expand_ic_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)frontier, (const uint32_t*)visited,
      (const int32_t*)nbr_c, (const int32_t*)gidx, (const float*)prob_p,
      (const uint32_t*)keys, (uint32_t)n, (int)df, (uint32_t)d_pad,
      (uint32_t)chunk, (uint32_t)W, (uint32_t)band_rows,
      (uint32_t*)new_frontier, (uint32_t*)visited_out);
  return (int)cudaGetLastError();
}
