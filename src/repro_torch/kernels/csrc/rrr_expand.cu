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
// step is rrr_expand_ic at the end of this file: a push over the live
// frontier words that draws each coin in the kernel instead of reading
// a coin plane from HBM.
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

// IC sampling step as a push over the live frontier words, with the
// coins drawn in the kernel (rrr_expand_ic).  Replaces
// rrr_expand_step_resident_pallas (repro/kernels/rrr_expand.py:351)
// fed by the reference's XLA coin draw (repro/core/rrr.py:309-325).
//
// Input: the list of live words, flat indices v * W + w of the non-zero
// words of the frontier plane.  For each entry, every valid reverse
// slot rslot of v (nbr[v, rslot] = u >= 0; the valid slots come first
// in each row, as padded_adjacency builds it) with p = prob_p[v, rslot]
// > 0 hashes each set bit b of the frontier word f: bit b fires iff
// uniform(keys[c])[idx] < p, c = rslot / chunk, j = rslot % chunk, idx
// = ((32w + b) * n + v) * chunk + j — the reference's draw index, so
// each coin is the reference's coin, hashed once.  The fired bits of a
// slot are pushed into word (u, w):
//   new = bits & ~atomicOr(&visited[u, w], bits)      (visited in place)
//   if new: old = atomicOr(&next[u, w], new); if !old: append u * W + w
// OR is order-free, so the planes are word for word the pull's result
// (hit & ~visited, visited | hit) whatever order the threads run in;
// the first thread to set a word of `next` (zero on entry) appends it,
// so each word enters the next list once and the list is exactly the
// next plane's non-zero words, in no particular order.
//
// Bound on the H100: the work is the list, the live words, the rows of
// nbr and prob_p behind them, a read-modify-write of visited and next
// at each hit word, and ~80 integer operations a coin — no pass over
// the [n, W] planes.  On the sampler's frontiers (about 1 in 8,000 words
// live) that is a few MB, and the step's time is set by latency: the
// launch and a few waves of short dependent chains of loads and
// atomics.  Where most words are live, the random atomics at the hit
// words cost more than a pull's streaming writes (chip_smoke.py, phase
// timing, "one bit a word").
//
// One group of G lanes per entry, G the row width d rounded up to a
// power of two, at most 32 (a warp per entry on hub rows, several
// entries a warp on narrow rows).  Lane 0 of the group loads the word,
// zeroes it in the frontier plane (only this group reads that entry, so
// after the step the plane is all zero again and can be the next step's
// target: ping-pong planes, no clearing pass) and shuffles it to the
// group, whose lanes stride over the row's slots.  A lane stops at the
// row's first invalid slot.  Before its atomics a lane reads the target
// visited word plainly: visited only grows, so a stale read costs an
// atomic and never loses a bit, and a coin that reaches an already
// visited sample (frequent at hubs) costs no atomic.
__global__ void push_ic_kernel(const int32_t* __restrict__ words,
                               uint32_t count, uint32_t* frontier,
                               uint32_t* visited,
                               const int32_t* __restrict__ nbr,
                               const float* __restrict__ prob_p,
                               const uint32_t* __restrict__ keys, uint32_t n,
                               uint32_t d, uint32_t d_pad, uint32_t chunk,
                               uint32_t W, int lg, uint32_t* next,
                               int32_t* __restrict__ next_words,
                               uint32_t* next_count) {
  const uint32_t group = 1u << lg;
  const uint32_t lane = threadIdx.x & (group - 1);
  const uint32_t e = blockIdx.x * (blockDim.x >> lg) + (threadIdx.x >> lg);
  uint32_t word = 0, f = 0;
  if (lane == 0 && e < count) {
    word = (uint32_t)words[e];
    f = frontier[word];
    frontier[word] = 0u;
  }
  word = __shfl_sync(0xffffffffu, word, 0, group);
  f = __shfl_sync(0xffffffffu, f, 0, group);
  if (!f) return;
  const uint32_t v = word / W;
  const uint32_t w = word - v * W;
  const int32_t* row = nbr + (uint64_t)v * d;
  const float* p_row = prob_p + (uint64_t)v * d_pad;
  const uint64_t bit_stride = (uint64_t)n * chunk;
  const uint64_t sample0 = (uint64_t)(32u * w) * n + v;
  for (uint32_t s = lane; s < d; s += group) {
    const int32_t u = row[s];
    if (u < 0) break;
    const float p = p_row[s];
    if (!(p > 0.0f)) continue;
    const uint32_t c = s / chunk;
    const uint32_t j = s - c * chunk;
    const uint32_t k0 = keys[2 * c], k1 = keys[2 * c + 1];
    const uint64_t base = sample0 * chunk + j;
    uint32_t bits = 0;
    for (uint32_t rest = f; rest; rest &= rest - 1) {
      const int b = __ffs(rest) - 1;
      if (coin_fires(k0, k1, base + (uint64_t)b * bit_stride, p))
        bits |= 1u << b;
    }
    const uint64_t t = (uint64_t)u * W + w;
    if (!(bits & ~visited[t])) continue;
    const uint32_t nw = bits & ~atomicOr(&visited[t], bits);
    if (nw && !atomicOr(&next[t], nw))
      next_words[atomicAdd(next_count, 1u)] = (int32_t)t;
  }
}

extern "C" int rrr_expand_ic(const void* words, int64_t count,
                             void* frontier, void* visited, const void* nbr,
                             const void* prob_p, const void* keys, void* next,
                             void* next_words, void* next_count, int64_t n,
                             int64_t d, int64_t d_pad, int64_t chunk,
                             int64_t W, void* stream) {
  // 32-bit words: the list holds int32 flat indices v * W + w, and the
  // sample index 32 * W fits in 32 bits.
  if (count < 1 || n * W >= (int64_t(1) << 31) ||
      32 * W >= (int64_t(1) << 32))
    return (int)cudaErrorInvalidValue;
  int lg = 0;
  while ((int64_t(1) << lg) < d && lg < 5) ++lg;
  cudaError_t err = cudaMemsetAsync(next_count, 0, sizeof(uint32_t),
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const int64_t per_block = kThreads >> lg;
  const int64_t blocks = (count + per_block - 1) / per_block;
  push_ic_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)words, (uint32_t)count, (uint32_t*)frontier,
      (uint32_t*)visited, (const int32_t*)nbr, (const float*)prob_p,
      (const uint32_t*)keys, (uint32_t)n, (uint32_t)d, (uint32_t)d_pad,
      (uint32_t)chunk, (uint32_t)W, lg, (uint32_t*)next,
      (int32_t*)next_words, (uint32_t*)next_count);
  return (int)cudaGetLastError();
}
