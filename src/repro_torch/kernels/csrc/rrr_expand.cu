// One packed BFS / cascade expansion step:
//   hit[u, w] = OR_s frontier[fwd_nbr[u, s], w] & mask(u, s, w)
//   new = hit & ~visited;  visited_out = visited | new
// Replaces repro/kernels/rrr_expand.py: rrr_expand_step_resident_pallas
// (mask = plane[gidx[u, s], w], gidx == rows reading zero) and
// rrr_expand_step_pallas (mask = gmask[u, s, w], pre-gathered).  Invalid
// slots follow the reference's contract: fwd_nbr is pre-clipped to 0 and
// the mask word is zero (gmask) or gidx names row `rows` (resident).
//
// Bound on the H100: bytes.  The outputs are two whole planes and visited
// is read once, but the frontier is sparse on the sampler's and the
// cascade's steps (about 1 word in 8,000 live at the IMM's first step), so
// a gather of every slot's frontier word reads ~4x the plane for nothing.
// Two optional inputs let the step read only what can set a bit:
//   - slots, int32 [n]: row u's valid slots come first and number
//     slots[u] (the forward table, csr.padded_forward_adjacency, and the
//     cascade's reverse table, csr.padded_adjacency, are built so); the
//     rest of the row is never read.  Without it every slot is read and a
//     gidx == rows sentinel may stand anywhere in a row.
//   - lines, uint8 [n, L], L = ceil(W / 32): the frontier's line summary,
//     non-zero where the 32-word line (v, l) may hold a set bit.  A slot's
//     frontier line is loaded only where its byte is set.  Without it every
//     line is live (every valid slot's words are read).  Extra set bytes
//     cost loads and never change a word; only this kernel and the
//     first-step builders (rrr.root_lines, the cascade's seed rows) write
//     a summary, so no live line lacks its byte.
// The step writes its new frontier's summary (next_lines, if given; the
// loops pass it to the next step) and adds the number of non-zero lines to
// count (if given; zeroed first, one atomic a warp over its whole share of
// the grid), so a loop stops on a 4-byte read, not on frontier.any().
//
// Mapping.  W >= 17 (lines_kernel): a warp owns four 32-word lines of a
// row, (u, l0) to (u, l0 + 3), a word a lane, and walks the grid's groups
// of lines with a stride.  The row's slot indices (fwd_nbr, and gidx for
// the resident layout) are loaded by the lanes, one slot a lane, in
// coalesced chunks of 32 (hub rows take several); each lane probes its
// slot's four summary bytes and a ballot a line leaves the live slots;
// their frontier lines are loaded four slots at a time (up to 16 128-byte
// lines in flight), and a mask word only behind a non-zero frontier word.
// On the H100 one line a warp took 2.4-2.7 ms at the IMM's first step
// (W = 1,024) against a 0.97 ms bound: each warp waited on one dependent
// chain (count, slot index, summary byte) and one visited load at a time.
// W <= 16 (rows_kernel): a group of G = the next power of two >= W lanes
// owns a row (L = 1), a word a lane, adjacent words of a row in adjacent
// lanes as cascade_ic's threads are, so W = 1 and W = 2 still fill the
// warp; each lane walks its row's slots four at a time (index, summary
// byte, frontier word, mask word).  In both, a row's first slot indices
// load beside its count, which they do not depend on.  Both write the two
// planes with streaming stores (the step never reads them again) and run
// a grid of the blocks the card holds at once.
#include <cstdint>
#include <cuda_runtime.h>

#include "kernel_table.cuh"
#include "threefry.cuh"

static constexpr int kThreads = 256;
static constexpr unsigned kFull = 0xffffffffu;

struct PlaneMask {  // resident layout: plane[gidx[u, s], w]
  const uint32_t* plane;
  const int32_t* gidx;
  int64_t rows;
  __device__ __forceinline__ int32_t index(int64_t slot) const {
    return gidx[slot];
  }
  __device__ __forceinline__ bool valid(int32_t g) const { return g < rows; }
  __device__ __forceinline__ uint32_t word(int32_t g, int64_t, int64_t w,
                                           int64_t W) const {
    return plane[(int64_t)g * W + w];
  }
};

struct GatheredMask {  // streamed layout: gmask[u, s, w]
  const uint32_t* gmask;
  __device__ __forceinline__ int32_t index(int64_t) const { return 0; }
  __device__ __forceinline__ bool valid(int32_t) const { return true; }
  __device__ __forceinline__ uint32_t word(int32_t, int64_t slot, int64_t w,
                                           int64_t W) const {
    return gmask[slot * W + w];
  }
};

struct Step {
  const uint32_t* frontier;
  const uint32_t* visited;
  const int32_t* fwd_nbr;
  const int32_t* slots;     // or null: every slot
  const uint8_t* lines;     // or null: every line live
  uint32_t* new_frontier;
  uint32_t* visited_out;
  uint8_t* next_lines;      // or null
  uint32_t* count;          // or null
  int64_t n, W, L;
  int df;
};

// Lines a warp takes at once in lines_kernel: four 128-byte lines of one
// row, so four dependent chains (count, slot indices, summary bytes) and
// their visited loads are in flight a warp, not one.
static constexpr int kLines = 4;

template <class Mask>
__global__ void __launch_bounds__(kThreads)
    lines_kernel(const Step p, const Mask mask) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const int64_t groups = (p.L + kLines - 1) / kLines;   // a row's groups
  const int64_t total = p.n * groups;
  uint32_t live_lines = 0;
  for (int64_t grp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       grp < total; grp += stride) {
    const int64_t u = grp / groups;
    const int64_t l0 = (grp - u * groups) * kLines;
    bool word[kLines];
    uint32_t vis[kLines], hit[kLines];
#pragma unroll
    for (int k = 0; k < kLines; ++k) {
      const int64_t w = 32 * (l0 + k) + lane;
      word[k] = l0 + k < p.L && w < p.W;
      vis[k] = word[k] ? p.visited[u * p.W + w] : 0u;
      hit[k] = 0;
    }
    const int c = p.slots ? min(p.slots[u], p.df) : p.df;
    const int64_t row = u * p.df;
    int s0 = 0;
    do {
      const int s = s0 + lane;
      int32_t v = 0, g = 0;
      if (s < p.df) {
        v = p.fwd_nbr[row + s];
        g = mask.index(row + s);
      }
      const bool valid = s < c && mask.valid(g);
      // the slots whose frontier line k is live, and their union
      unsigned live[kLines], todo = 0;
#pragma unroll
      for (int k = 0; k < kLines; ++k) {
        bool on = valid && l0 + k < p.L;
        if (on && p.lines) on = p.lines[(int64_t)v * p.L + l0 + k] != 0;
        live[k] = __ballot_sync(kFull, on);
        todo |= live[k];
      }
      while (todo) {            // four slots, each on its live lines
        int src[4];
        int32_t vs[4], gs[4];
        uint32_t f[4][kLines];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          src[i] = todo ? __ffs(todo) - 1 : -1;
          todo &= todo - 1;
          vs[i] = __shfl_sync(kFull, v, src[i] & 31);
          gs[i] = __shfl_sync(kFull, g, src[i] & 31);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < kLines; ++k)
            f[i][k] = src[i] >= 0 && word[k] && (live[k] >> src[i] & 1u)
                          ? p.frontier[(int64_t)vs[i] * p.W + 32 * (l0 + k)
                                       + lane]
                          : 0u;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < kLines; ++k)
            if (f[i][k])
              hit[k] |= f[i][k] & mask.word(gs[i], row + s0 + src[i],
                                            32 * (l0 + k) + lane, p.W);
      }
      s0 += 32;
    } while (s0 < c);
#pragma unroll
    for (int k = 0; k < kLines; ++k) {
      const uint32_t nw = hit[k] & ~vis[k];
      if (word[k]) {
        const int64_t t = u * p.W + 32 * (l0 + k) + lane;
        __stcs(p.new_frontier + t, nw);
        __stcs(p.visited_out + t, vis[k] | nw);
      }
      const bool any = __any_sync(kFull, nw != 0);
      if (lane == 0 && l0 + k < p.L) {
        if (p.next_lines) p.next_lines[u * p.L + l0 + k] = any;
        live_lines += any;
      }
    }
  }
  if (p.count && lane == 0 && live_lines) atomicAdd(p.count, live_lines);
}

template <class Mask>
__global__ void __launch_bounds__(kThreads)
    rows_kernel(const Step p, const Mask mask, const int lg) {
  const int group = 1 << lg;
  const int lane = threadIdx.x & 31;
  const int j = lane & (group - 1);
  const unsigned team = (kFull >> (32 - group)) << (lane & ~(group - 1));
  const int64_t stride = ((int64_t)gridDim.x * blockDim.x) >> lg;
  uint32_t live_rows = 0;
  // `base` is the warp's first row, the same for its lanes, so every lane
  // reaches the ballots below
  for (int64_t base = ((int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31))
                      >> lg;
       base < p.n; base += stride) {
    const int64_t u = base + (lane >> lg);
    const bool word = u < p.n && j < p.W;
    const int64_t t = u * p.W + j;
    uint32_t vis = 0, hit = 0;
    if (word) {
      vis = p.visited[t];
      const int c = p.slots ? min(p.slots[u], p.df) : p.df;
      const int64_t row = u * p.df;
      int r0 = 0;
      do {
        int32_t v[4], g[4];
        bool ok[4];
        uint32_t f[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool in = r0 + i < p.df;
          v[i] = in ? p.fwd_nbr[row + r0 + i] : 0;
          g[i] = in ? mask.index(row + r0 + i) : 0;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ok[i] = r0 + i < c && mask.valid(g[i]) &&
                  (!p.lines || p.lines[v[i]]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          f[i] = ok[i] ? p.frontier[(int64_t)v[i] * p.W + j] : 0u;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (f[i]) hit |= f[i] & mask.word(g[i], row + r0 + i, j, p.W);
        r0 += 4;
      } while (r0 < c);
    }
    const uint32_t nw = hit & ~vis;
    if (word) {
      __stcs(p.new_frontier + t, nw);
      __stcs(p.visited_out + t, vis | nw);
    }
    const bool any = (__ballot_sync(kFull, nw != 0) & team) != 0;
    const bool lead = u < p.n && j == 0;
    if (lead && p.next_lines) p.next_lines[u] = any;
    const unsigned leads = __ballot_sync(kFull, lead && any);
    if (lane == 0) live_rows += __popc(leads);
  }
  if (p.count && lane == 0 && live_rows) atomicAdd(p.count, live_rows);
}

// A grid of the blocks the card holds at once (at most one block a
// kThreads threads of work): the kernels stride over their lines or rows.
template <class Kernel>
static unsigned resident_blocks(Kernel kernel, int64_t threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int64_t want = (threads + kThreads - 1) / kThreads;
  const int64_t held =
      (int64_t)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  return (unsigned)(want < held ? want : held);
}

template <class Mask>
static int launch(Step p, Mask mask, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (p.n < 1 || p.W < 1 || p.df < 0) return (int)cudaErrorInvalidValue;
  if (p.count) {
    cudaError_t err = cudaMemsetAsync(p.count, 0, sizeof(uint32_t), s);
    if (err != cudaSuccess) return (int)err;
  }
  p.L = (p.W + 31) / 32;
  int lg = 0;
  while ((int64_t(1) << lg) < p.W && lg < 5) ++lg;
  if (lg == 5) {
    const unsigned blocks = resident_blocks(
        lines_kernel<Mask>, p.n * ((p.L + kLines - 1) / kLines) * 32);
    lines_kernel<Mask><<<blocks, kThreads, 0, s>>>(p, mask);
  } else {
    const unsigned blocks = resident_blocks(rows_kernel<Mask>, p.n << lg);
    rows_kernel<Mask><<<blocks, kThreads, 0, s>>>(p, mask, lg);
  }
  return (int)cudaGetLastError();
}

static Step step_args(const void* frontier, const void* visited,
                      const void* fwd_nbr, const void* slots,
                      const void* lines, void* new_frontier,
                      void* visited_out, void* next_lines, void* count,
                      int64_t n, int64_t df, int64_t W) {
  return Step{(const uint32_t*)frontier, (const uint32_t*)visited,
              (const int32_t*)fwd_nbr,   (const int32_t*)slots,
              (const uint8_t*)lines,     (uint32_t*)new_frontier,
              (uint32_t*)visited_out,    (uint8_t*)next_lines,
              (uint32_t*)count,          n, W, 0, (int)df};
}

extern "C" int rrr_expand_resident(const void* frontier, const void* visited,
                                   const void* fwd_nbr, const void* gidx,
                                   const void* plane, const void* slots,
                                   const void* lines, void* new_frontier,
                                   void* visited_out, void* next_lines,
                                   void* count, int64_t n, int64_t df,
                                   int64_t W, int64_t rows, void* stream) {
  return launch(step_args(frontier, visited, fwd_nbr, slots, lines,
                          new_frontier, visited_out, next_lines, count, n,
                          df, W),
                PlaneMask{(const uint32_t*)plane, (const int32_t*)gidx, rows},
                stream);
}

extern "C" int rrr_expand_streamed(const void* frontier, const void* visited,
                                   const void* fwd_nbr, const void* gmask,
                                   const void* slots, const void* lines,
                                   void* new_frontier, void* visited_out,
                                   void* next_lines, void* count, int64_t n,
                                   int64_t df, int64_t W, void* stream) {
  return launch(step_args(frontier, visited, fwd_nbr, slots, lines,
                          new_frontier, visited_out, next_lines, count, n,
                          df, W),
                GatheredMask{(const uint32_t*)gmask}, stream);
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

// The shared memory a cascade step stages its key table of ``words``
// words in: all of it when it fits in kSharedKeyBytes, else none (the
// table is read through the read-only cache).
static size_t staged_key_bytes(int64_t words) {
  const int64_t bytes = words * (int64_t)sizeof(uint32_t);
  return bytes <= kSharedKeyBytes ? (size_t)bytes : 0;
}

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
  const size_t bytes = staged_key_bytes(table_words);
  if (bytes)
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
// in_deg[v], and is then slot `chosen` (valid slots come first).  The
// cascade's cumw holds the reference's cumulative sums in XLA's blocked
// order, each row ascending, built once per spread by the wrapper's
// caller (rrr_expand.lt_tables; the sampler's push reads a CSR form,
// below): the kernels never sum.  A blocked sum
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
// slot j = lt_choice(r) and, if j < in_deg[v], pushes bit b into word
// (src[indptr[v] + j], w).  Consecutive bits that pick the same target
// are pushed with one atomic.
//
// The graph is read as its reverse CSR, with no padded table: row v is
// edges indptr[v] .. indptr[v + 1] - 1 of src and cumw, and cumw holds
// the row's in_deg smallest sums of the reference's padded row,
// ascending (graphs.csr.lt_reverse builds them): the reference's count
// over all d sums is below in_deg exactly when the in_deg-th smallest
// passes r, and then equals the count over those in_deg.  So every row
// is binary searched over its own in_deg sums, marked or not.
//
// One thread per entry with a loop over its set bits: an LT walk has at
// most one frontier vertex per sample, so the sampler's words hold one
// bit or a few, and a bit has one target, not one per slot as IC's coins
// have (IC's push spreads a word over a lane group per slot).  Bound on
// the H100: the list, the live words, a row's two offsets, ceil(log2
// in_deg) + 1 sums a draw and one src entry per bit, the visited and
// next words read-modify-written, and ~80 integer operations a draw -- a
// few MB at the sampler's frontiers (at most theta live bits a step), so
// the step's time is latency: the launch and a chain of dependent loads
// and atomics per thread.
__global__ void push_lt_kernel(const int32_t* __restrict__ words,
                               uint32_t count, uint32_t* frontier,
                               uint32_t* visited,
                               const int32_t* __restrict__ indptr,
                               const int32_t* __restrict__ src,
                               const float* __restrict__ cumw, uint32_t k0,
                               uint32_t k1, uint32_t n, uint32_t W,
                               uint32_t* next,
                               int32_t* __restrict__ next_words,
                               uint32_t* next_count) {
  const uint32_t e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  const uint32_t word = (uint32_t)words[e];
  const uint32_t f = frontier[word];
  frontier[word] = 0u;
  const uint32_t v = word / W;
  const int32_t first = indptr[v];
  const int deg = indptr[v + 1] - first;
  if (!f || !deg) return;               // no in-edge: no walk goes on
  const uint32_t w = word - v * W;
  const float* row = cumw + first;
  const int32_t* srow = src + first;
  const uint64_t sample0 = (uint64_t)(32u * w) * n + v;
  uint64_t pend_t = 0;
  uint32_t pend = 0;
  for (uint32_t rest = f; rest; rest &= rest - 1) {
    const int b = __ffs(rest) - 1;
    const int j = lt_choice(row, deg, deg,
                            uniform_at(k0, k1, sample0 + (uint64_t)b * n));
    if (j >= deg) continue;
    const uint64_t t = (uint64_t)srow[j] * W + w;
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
                             void* frontier, void* visited,
                             const void* indptr, const void* src,
                             const void* cumw, int64_t k0, int64_t k1,
                             void* next, void* next_words, void* next_count,
                             int64_t n, int64_t edges, int64_t W,
                             void* stream) {
  // 32-bit words, as rrr_expand_ic: int32 list entries, 32 * W samples;
  // int32 row offsets.
  if (count < 1 || edges < 1 || edges >= (int64_t(1) << 31) ||
      n * W >= (int64_t(1) << 31) || 32 * W >= (int64_t(1) << 32))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(next_count, 0, sizeof(uint32_t),
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (count + kThreads - 1) / kThreads;
  push_lt_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)words, (uint32_t)count, (uint32_t*)frontier,
      (uint32_t*)visited, (const int32_t*)indptr, (const int32_t*)src,
      (const float*)cumw, (uint32_t)k0, (uint32_t)k1, (uint32_t)n,
      (uint32_t)W, (uint32_t*)next, (int32_t*)next_words,
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
  const size_t bytes = staged_key_bytes(2 * num_sims);
  if (bytes)
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

// The dynamic shared memory of a launch (kernel_table.cuh): the cascade
// steps' staged key table, x its words (2 x n_chunks x num_sims for
// cascade_ic, 2 x num_sims for cascade_lt); the other steps take none.
extern "C" int64_t launch_smem(const char* launch, int64_t, int64_t x) {
  if (same_launch(launch, "cascade_ic") || same_launch(launch, "cascade_lt"))
    return (int64_t)staged_key_bytes(x);
  if (same_launch(launch, "rrr_expand_resident") ||
      same_launch(launch, "rrr_expand_streamed") ||
      same_launch(launch, "rrr_expand_ic") ||
      same_launch(launch, "rrr_expand_lt"))
    return 0;
  return -1;
}

static const KernelEntry kKernels[] = {
    {"rrr_expand_resident", "lines_kernel<PlaneMask>",
     (const void*)lines_kernel<PlaneMask>, kThreads},
    {"rrr_expand_resident", "rows_kernel<PlaneMask>",
     (const void*)rows_kernel<PlaneMask>, kThreads},
    {"rrr_expand_streamed", "lines_kernel<GatheredMask>",
     (const void*)lines_kernel<GatheredMask>, kThreads},
    {"rrr_expand_streamed", "rows_kernel<GatheredMask>",
     (const void*)rows_kernel<GatheredMask>, kThreads},
    {"rrr_expand_ic", "push_ic_kernel", (const void*)push_ic_kernel,
     kThreads},
    {"cascade_ic", "cascade_ic_kernel<true>",
     (const void*)cascade_ic_kernel<true>, kThreads},
    {"cascade_ic", "cascade_ic_kernel<false>",
     (const void*)cascade_ic_kernel<false>, kThreads},
    {"rrr_expand_lt", "push_lt_kernel", (const void*)push_lt_kernel,
     kThreads},
    {"cascade_lt", "cascade_lt_kernel<true>",
     (const void*)cascade_lt_kernel<true>, kThreads},
    {"cascade_lt", "cascade_lt_kernel<false>",
     (const void*)cascade_lt_kernel<false>, kThreads},
};
KERNEL_TABLE_EXPORTS(kKernels)
