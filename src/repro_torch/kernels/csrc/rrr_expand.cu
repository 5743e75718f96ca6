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
// step is rrr_expand_ic below: a push over the live frontier words that
// draws each coin in the kernel instead of reading a coin plane from
// HBM; cascade_ic does the same for the IC cascade, and rrr_expand_lt
// and cascade_lt at the end of this file for LT's one live in-edge.
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

// The forward cascade's IC step with its live edges drawn in the kernel
// (cascade_ic).  Replaces rrr_expand_step_pallas
// (repro/kernels/rrr_expand.py:271) in its cascade role, fed by the
// reference's XLA live-edge draw (repro/core/cascade.py:231-257), which
// this port drew as an [n, d_pad, W] plane before each spread.
//
// A pull over the reverse table: output word (v, w) ORs, over the valid
// reverse slots r of v (nbr[v, r] = u >= 0, valid slots first), the set
// bits b of frontier[u, w] whose edge is live in simulation s = 32w + b:
//   uniform(K[c][s])[v * chunk + j] < prob[v, r],  c = r / chunk,
//   j = r % chunk,  K[c][s] = fold_in(fold_in(key, c), s)
// — the reference's per-lane cascade draw of shape [n, chunk], so each
// coin is the reference's coin.  new = hit & ~visited, visited_out =
// visited | new.  A coin is hashed only behind a frontier bit that can
// still become new: the bits of a simulation lane (32w + b < num_sims;
// the plane holds no live edge in pad lanes), not yet visited at v and
// not yet hit by an earlier slot.  Dropping the others is exact: they
// cannot change the result.  A row stops at its first invalid slot, and
// once every open bit is hit.
//
// G = 1 << lg lanes share an output word and stride over its slots, each
// lane loading four of its slots' neighbours, then their frontier words,
// before it hashes (independent loads in flight), then the group ORs its
// hits with shuffles: G = 1 (a thread per word, adjacent words of a row
// in adjacent lanes, so a warp reads each row once) suits short rows; a
// wider group spreads a hub row over lanes.  The key table ([n_chunks,
// num_sims] pairs, built once per spread) is staged in shared memory
// when it fits in 48 KB, else read through the read-only cache.  With
// `count`, the kernel adds the number of non-zero new words (one atomic
// a warp), so the cascade's loop stops on a 4-byte read.
//
// Bound on the H100: at the spread's shapes the frontier is sparse (a
// few hundred vertices a simulation), so the work is the rows' valid
// slots, the frontier words gathered at them, visited and both outputs:
// bytes; dense frontiers make it the coins' hashing.
template <bool kSharedKeys>
__global__ void cascade_ic_kernel(const uint32_t* __restrict__ frontier,
                                  const uint32_t* __restrict__ visited,
                                  const int32_t* __restrict__ nbr,
                                  const float* __restrict__ prob,
                                  const uint32_t* __restrict__ keys,
                                  int64_t n, int d, int chunk, int W,
                                  int num_sims, int table_words, int lg,
                                  uint32_t* __restrict__ new_frontier,
                                  uint32_t* __restrict__ visited_out,
                                  uint32_t* __restrict__ count) {
  extern __shared__ uint32_t staged[];
  const uint32_t* table = keys;
  if (kSharedKeys) {
    for (int i = threadIdx.x; i < table_words; i += blockDim.x)
      staged[i] = keys[i];
    __syncthreads();
    table = staged;
  }
  const int group = 1 << lg;
  const int lane = threadIdx.x & (group - 1);
  const int64_t t =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> lg;
  const bool in = t < n * W;
  uint32_t hit = 0, vis = 0;
  if (in) {
    const int64_t v = t / W;
    const int w = (int)(t - v * W);
    vis = visited[t];
    const int rem = num_sims - 32 * w;
    const uint32_t lanes = rem >= 32 ? 0xffffffffu : (1u << rem) - 1u;
    const uint32_t open = lanes & ~vis;
    const int32_t* row = nbr + v * d;
    const float* p_row = prob + v * d;
    const uint32_t* kw = table + 2 * 32 * w;    // + 2 * (c * num_sims + b)
    bool done = !open;
    for (int r0 = lane; r0 < d && !done; r0 += 4 * group) {
      int32_t u[4];
      uint32_t f[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + i * group;
        u[i] = r < d ? row[r] : -1;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        f[i] = u[i] >= 0 ? frontier[(int64_t)u[i] * W + w] : 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (u[i] < 0) { done = true; break; }
        const uint32_t live = f[i] & open & ~hit;
        if (!live) continue;
        const int r = r0 + i * group;
        const float p = p_row[r];
        if (!(p > 0.0f)) continue;
        const int c = r / chunk;
        const uint64_t idx = (uint64_t)v * chunk + (r - c * chunk);
        const uint32_t* kc = kw + 2 * c * num_sims;
        for (uint32_t rest = live; rest; rest &= rest - 1) {
          const int b = __ffs(rest) - 1;
          if (coin_fires(kc[2 * b], kc[2 * b + 1], idx, p)) hit |= 1u << b;
        }
      }
      if (!(open & ~hit)) done = true;
    }
  }
  for (int off = group >> 1; off; off >>= 1)
    hit |= __shfl_xor_sync(0xffffffffu, hit, off, group);
  if (in && lane == 0) {
    new_frontier[t] = hit;
    visited_out[t] = vis | hit;
  }
  if (count) {
    const unsigned live = __ballot_sync(0xffffffffu, in && lane == 0 && hit);
    if ((threadIdx.x & 31) == 0 && live) atomicAdd(count, __popc(live));
  }
}

static constexpr int kSharedKeyBytes = 48 * 1024;

extern "C" int cascade_ic(const void* frontier, const void* visited,
                          const void* nbr, const void* prob, const void* keys,
                          void* new_frontier, void* visited_out, void* count,
                          int64_t n, int64_t d, int64_t chunk,
                          int64_t n_chunks, int64_t W, int64_t num_sims,
                          int64_t lg, void* stream) {
  if (d < 1 || d >= (int64_t(1) << 31) || chunk < 1 || W < 1 ||
      num_sims <= 32 * (W - 1) || num_sims > 32 * W || lg < 0 || lg > 5 ||
      n_chunks * chunk < d || n_chunks * num_sims >= (int64_t(1) << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (count) {
    cudaError_t err = cudaMemsetAsync(count, 0, sizeof(uint32_t), s);
    if (err != cudaSuccess) return (int)err;
  }
  const int table_words = (int)(2 * n_chunks * num_sims);
  const int64_t blocks = ((n * W << lg) + kThreads - 1) / kThreads;
  const size_t bytes = sizeof(uint32_t) * (size_t)table_words;
  if (bytes <= (size_t)kSharedKeyBytes)
    cascade_ic_kernel<true><<<(unsigned)blocks, kThreads, bytes, s>>>(
        (const uint32_t*)frontier, (const uint32_t*)visited,
        (const int32_t*)nbr, (const float*)prob, (const uint32_t*)keys, n,
        (int)d, (int)chunk, (int)W, (int)num_sims, table_words, (int)lg,
        (uint32_t*)new_frontier, (uint32_t*)visited_out, (uint32_t*)count);
  else
    cascade_ic_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const uint32_t*)frontier, (const uint32_t*)visited,
        (const int32_t*)nbr, (const float*)prob, (const uint32_t*)keys, n,
        (int)d, (int)chunk, (int)W, (int)num_sims, table_words, (int)lg,
        (uint32_t*)new_frontier, (uint32_t*)visited_out, (uint32_t*)count);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// LT: one live in-edge per (sample or simulation, vertex), drawn in the
// step.  The reference draws a uniform r per (sample, vertex) and takes
// chosen = sum_j (cumw[v, j] <= r) over all d slots of the padded row
// (jnp.sum(r >= cumw), repro/core/rrr.py:326-345 and
// repro/core/cascade.py:243-257); the edge is live iff chosen <
// in_deg[v], and is then slot `chosen` (valid slots come first).  cumw
// holds the reference's cumulative sums in XLA's blocked order, each row
// ascending, built once per sampling call or spread by the wrapper's
// caller (rrr_expand.lt_tables): the kernels never sum.  A blocked sum
// can round a later sum an ulp below an earlier one (10 of the IMM-size
// rmat graph's rows); such a row is stored sorted, which leaves the count
// unchanged, and rows[v] = -1 - in_deg[v] marks it; every other row is
// the reference's as it is, rows[v] = in_deg[v].  In such a row the
// valid slots decide: if some valid sum passes r, no later one counts,
// and if none does, chosen >= in_deg and no edge is live whatever the
// padded slots add.  So a choice binary searches in_deg sums (all d for
// a marked row): ceil(log2) + 1 loads, within one or two sectors on a
// short row.

__device__ __forceinline__ int lt_in_deg(int32_t code) {
  return code >= 0 ? code : -1 - code;
}

// The live slot of a draw r on a row (chosen < in_deg), or a value >=
// in_deg when no in-edge is live.
__device__ __forceinline__ int lt_choice(const float* __restrict__ row,
                                         int d, int32_t code, float r) {
  int lo = 0, hi = code >= 0 ? code : d;  // the first slot whose sum
  while (lo < hi) {                        // passes r
    const int mid = (lo + hi) >> 1;
    if (row[mid] <= r) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Push `bits` into word t of visited and of the next plane; the first
// thread to make the next plane's word non-zero appends it to the list.
__device__ __forceinline__ void push_bits(uint64_t t, uint32_t bits,
                                          uint32_t* visited, uint32_t* next,
                                          int32_t* next_words,
                                          uint32_t* next_count) {
  if (!(bits & ~visited[t])) return;
  const uint32_t nw = bits & ~atomicOr(&visited[t], bits);
  if (nw && !atomicOr(&next[t], nw))
    next_words[atomicAdd(next_count, 1u)] = (int32_t)t;
}

// LT sampling step as a push over the live frontier words, with each
// walk's live in-edge drawn in the kernel (rrr_expand_lt).  Replaces
// rrr_expand_step_resident_pallas (repro/kernels/rrr_expand.py:351) in
// its LT role, fed by the reference's XLA selection mask
// (repro/core/rrr.py:326-345), which this port drew as an [n, d_pad, W]
// plane each step (17 GB at the IMM shape).
//
// The list and the planes are rrr_expand_ic's: each entry v * W + w
// names a non-zero frontier word, read and zeroed by its thread (the
// planes ping-pong), and each new word of the next plane is appended
// once.  Bit b of the word is sample s = 32w + b: it draws r =
// uniform(key)[s * n + v] (the reference's [batch, n] draw; the index
// passes 2^32 at the IMM shape and is split into hi and lo words), picks
// slot j = lt_choice(r), and, if j < in_deg[v], pushes bit b into word
// (nbr[v, j], w).  Consecutive bits that pick the same target are pushed
// with one atomic.
//
// One thread per entry with a loop over its set bits: an LT walk has at
// most one frontier vertex per sample, so the sampler's words hold one
// bit or a few, and a bit has one target, not one per slot as IC's coins
// have (IC's push spreads a word over a lane group per slot).  Bound on
// the H100: the list, the live words, a cumw row and one nbr entry per
// bit, the visited and next words read-modify-written, and ~80 integer
// operations a draw — a few MB at the sampler's frontiers (at most
// theta live bits a step), so the step's time is latency: the launch and
// a chain of dependent loads and atomics per thread.
__global__ void push_lt_kernel(const int32_t* __restrict__ words,
                               uint32_t count, uint32_t* frontier,
                               uint32_t* visited,
                               const int32_t* __restrict__ nbr,
                               const float* __restrict__ cumw,
                               const int32_t* __restrict__ rows, uint32_t k0,
                               uint32_t k1, uint32_t n, uint32_t d,
                               uint32_t W, uint32_t* next,
                               int32_t* __restrict__ next_words,
                               uint32_t* next_count) {
  const uint32_t e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  const uint32_t word = (uint32_t)words[e];
  const uint32_t f = frontier[word];
  frontier[word] = 0u;
  const uint32_t v = word / W;
  const int32_t code = rows[v];
  const int deg = lt_in_deg(code);
  if (!f || !deg) return;               // no in-edge: no walk goes on
  const uint32_t w = word - v * W;
  const float* row = cumw + (uint64_t)v * d;
  const int32_t* nrow = nbr + (uint64_t)v * d;
  const uint64_t sample0 = (uint64_t)(32u * w) * n + v;
  uint64_t pend_t = 0;
  uint32_t pend = 0;
  for (uint32_t rest = f; rest; rest &= rest - 1) {
    const int b = __ffs(rest) - 1;
    const int j = lt_choice(row, (int)d, code,
                            uniform_at(k0, k1, sample0 + (uint64_t)b * n));
    if (j >= deg) continue;
    const uint64_t t = (uint64_t)nrow[j] * W + w;
    if (pend && t != pend_t) {
      push_bits(pend_t, pend, visited, next, next_words, next_count);
      pend = 0;
    }
    pend_t = t;
    pend |= 1u << b;
  }
  if (pend) push_bits(pend_t, pend, visited, next, next_words, next_count);
}

extern "C" int rrr_expand_lt(const void* words, int64_t count,
                             void* frontier, void* visited, const void* nbr,
                             const void* cumw, const void* rows, int64_t k0,
                             int64_t k1, void* next, void* next_words,
                             void* next_count, int64_t n, int64_t d,
                             int64_t W, void* stream) {
  // 32-bit words, as rrr_expand_ic: int32 list entries, 32 * W samples.
  if (count < 1 || d < 1 || d >= (int64_t(1) << 31) ||
      n * W >= (int64_t(1) << 31) || 32 * W >= (int64_t(1) << 32))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(next_count, 0, sizeof(uint32_t),
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (count + kThreads - 1) / kThreads;
  push_lt_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)words, (uint32_t)count, (uint32_t*)frontier,
      (uint32_t*)visited, (const int32_t*)nbr, (const float*)cumw,
      (const int32_t*)rows, (uint32_t)k0, (uint32_t)k1, (uint32_t)n,
      (uint32_t)d, (uint32_t)W, (uint32_t*)next, (int32_t*)next_words,
      (uint32_t*)next_count);
  return (int)cudaGetLastError();
}

// The forward cascade's LT step with its one live in-edge drawn in the
// kernel (cascade_lt).  Replaces rrr_expand_step_pallas
// (repro/kernels/rrr_expand.py:271) in its LT cascade role, fed by the
// reference's XLA one-hot selection (repro/core/cascade.py:243-257),
// which this port drew as an [n, d_pad, W] plane, a simulation at a
// time, before each spread.
//
// A pull: output word (v, w) holds simulations s = 32w + b.  A bit can
// become new only if it is open (s < num_sims, not yet active at v) and
// some valid in-neighbour's frontier word holds it: the group's lanes
// stride over the row's valid slots and OR those words (cand).  Each
// candidate bit then draws r = uniform(K[s])[v], K[s] = fold_in(key, s)
// (the reference's per-simulation [n] draw; keys hashed once per spread,
// staged in shared memory when they fit in 48 KB), picks slot j =
// lt_choice(r), and is hit iff j < in_deg[v] and the frontier word of
// nbr[v, j] holds bit b.  The candidate bits are dealt round robin to
// the group's lanes.  new = hit & ~visited (hit holds open bits only),
// visited_out = visited | new; with `count`, the number of non-zero new
// words is added (one atomic a warp), so the loop stops on a 4-byte read.
//
// Bound on the H100: bytes at the spread's shapes (the rows' valid slots
// for words that are open, the frontier words gathered at them, visited
// and both outputs); the draws (one per candidate bit) are few, since a
// cascade's frontier is sparse.
template <bool kSharedKeys>
__global__ void cascade_lt_kernel(const uint32_t* __restrict__ frontier,
                                  const uint32_t* __restrict__ visited,
                                  const int32_t* __restrict__ nbr,
                                  const float* __restrict__ cumw,
                                  const int32_t* __restrict__ rows,
                                  const uint32_t* __restrict__ keys,
                                  int64_t n, int d, int W, int num_sims,
                                  int lg, uint32_t* __restrict__ new_frontier,
                                  uint32_t* __restrict__ visited_out,
                                  uint32_t* __restrict__ count) {
  extern __shared__ uint32_t staged[];
  const uint32_t* table = keys;
  if (kSharedKeys) {
    for (int i = threadIdx.x; i < 2 * num_sims; i += blockDim.x)
      staged[i] = keys[i];
    __syncthreads();
    table = staged;
  }
  const int group = 1 << lg;
  const int lane = threadIdx.x & (group - 1);
  const int64_t t =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> lg;
  const bool in = t < n * W;
  int64_t v = 0;
  int w = 0, deg = 0;
  int32_t code = 0;
  uint32_t vis = 0, cand = 0;
  if (in) {
    v = t / W;
    w = (int)(t - v * W);
    vis = visited[t];
    const int rem = num_sims - 32 * w;
    const uint32_t open =
        (rem >= 32 ? 0xffffffffu : (1u << rem) - 1u) & ~vis;
    code = rows[v];
    deg = lt_in_deg(code);
    if (open) {
      const int32_t* row = nbr + v * d;
#pragma unroll 4
      for (int r = lane; r < deg; r += group)
        cand |= frontier[(int64_t)row[r] * W + w];
      cand &= open;
    }
  }
  for (int off = group >> 1; off; off >>= 1)
    cand |= __shfl_xor_sync(0xffffffffu, cand, off, group);
  uint32_t hit = 0;
  if (cand) {
    const float* crow = cumw + v * d;
    const int32_t* row = nbr + v * d;
    const uint32_t* kw = table + 2 * 32 * w;
    int i = 0;
    for (uint32_t rest = cand; rest; rest &= rest - 1, ++i) {
      if ((i & (group - 1)) != lane) continue;
      const int b = __ffs(rest) - 1;
      const int j = lt_choice(crow, d, code,
                              uniform_at(kw[2 * b], kw[2 * b + 1],
                                         (uint64_t)v));
      if (j < deg && ((frontier[(int64_t)row[j] * W + w] >> b) & 1u))
        hit |= 1u << b;
    }
  }
  for (int off = group >> 1; off; off >>= 1)
    hit |= __shfl_xor_sync(0xffffffffu, hit, off, group);
  if (in && lane == 0) {
    new_frontier[t] = hit;
    visited_out[t] = vis | hit;
  }
  if (count) {
    const unsigned live = __ballot_sync(0xffffffffu, in && lane == 0 && hit);
    if ((threadIdx.x & 31) == 0 && live) atomicAdd(count, __popc(live));
  }
}

extern "C" int cascade_lt(const void* frontier, const void* visited,
                          const void* nbr, const void* cumw, const void* rows,
                          const void* keys, void* new_frontier,
                          void* visited_out, void* count, int64_t n,
                          int64_t d, int64_t W, int64_t num_sims, int64_t lg,
                          void* stream) {
  if (d < 1 || d >= (int64_t(1) << 31) || W < 1 ||
      num_sims <= 32 * (W - 1) || num_sims > 32 * W || lg < 0 || lg > 5)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (count) {
    cudaError_t err = cudaMemsetAsync(count, 0, sizeof(uint32_t), s);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t blocks = ((n * W << lg) + kThreads - 1) / kThreads;
  const size_t bytes = 2 * sizeof(uint32_t) * (size_t)num_sims;
  if (bytes <= (size_t)kSharedKeyBytes)
    cascade_lt_kernel<true><<<(unsigned)blocks, kThreads, bytes, s>>>(
        (const uint32_t*)frontier, (const uint32_t*)visited,
        (const int32_t*)nbr, (const float*)cumw, (const int32_t*)rows,
        (const uint32_t*)keys, n, (int)d, (int)W, (int)num_sims, (int)lg,
        (uint32_t*)new_frontier, (uint32_t*)visited_out, (uint32_t*)count);
  else
    cascade_lt_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const uint32_t*)frontier, (const uint32_t*)visited,
        (const int32_t*)nbr, (const float*)cumw, (const int32_t*)rows,
        (const uint32_t*)keys, n, (int)d, (int)W, (int)num_sims, (int)lg,
        (uint32_t*)new_frontier, (uint32_t*)visited_out, (uint32_t*)count);
  return (int)cudaGetLastError();
}
