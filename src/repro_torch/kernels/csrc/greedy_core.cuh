// The pick of the greedy senders, shared by greedy_pick.cu (the resident
// solve) and lazy_greedy.cu (the lazy solve), as the reference's
// lazy_greedy.py reuses greedy_pick.sweep_tile_argmax and commit_pick:
// the bit-exactness contract has one implementation.
//
// A row's key for the argmax is ((gain + 1) << 32) | (0xFFFFFFFF - row):
// the largest gain wins and, among equal gains, the lowest row index —
// jnp.argmax's tie-break.  Picked and excluded rows score gain -1.  A
// solve's winner is the 64-bit atomicMax of its blocks' keys.  The
// query-axis kernels sweep each row once for a group of G queries
// (gain_core.cuh's warp_row_gains) and keep one key slot, one taken-flag
// row and one cover per query (lane_key, block_post_keys).
#pragma once
#include <cstdint>
#include <type_traits>

#include "gain_core.cuh"

// The largest query group of the query-axis kernels: they are
// instantiated for G = 1 .. kMaxGroup (G covers in shared memory, G
// accumulators a lane) and keep G x 32 keys of scratch.
constexpr int kMaxGroup = 8;

// Host side: f(std::integral_constant<int, G>) for the runtime G, or -6
// (no such instantiation).
template <class F>
int with_group(int64_t G, F f) {
  switch (G) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return -6;
  }
}
static_assert(kMaxGroup == 8, "with_group covers G = 1 .. 8");

__device__ __forceinline__ unsigned long long pick_key(int gain, int64_t r) {
  return ((unsigned long long)(uint32_t)(gain + 1) << 32) |
         (unsigned long long)(0xFFFFFFFFu - (uint32_t)r);
}

__device__ __forceinline__ int key_gain(unsigned long long key) {
  return (int)(uint32_t)(key >> 32) - 1;
}

__device__ __forceinline__ int64_t key_row(unsigned long long key) {
  return (int64_t)(0xFFFFFFFFu - (uint32_t)key);
}

// Best key of the rows first, first + stride, ... < end, one warp per
// row (the tile sweep + argmax of sweep_tile_argmax).  ``taken`` marks
// picked and excluded rows.
__device__ __forceinline__ unsigned long long warp_sweep_argmax(
    const uint32_t* R, const uint8_t* taken, const uint32_t* cov, int64_t W,
    bool vec, int64_t first, int64_t end, int64_t stride, int lane) {
  unsigned long long best = 0;
  for (int64_t r = first; r < end; r += stride) {
    int g = warp_row_gain(R + r * W, cov, W, vec, lane);
    if (taken[r]) g = -1;
    const unsigned long long key = pick_key(g, r);
    best = key > best ? key : best;
  }
  return best;
}

// The largest of the warps' keys; the result is valid in warp 0.
// ``scratch`` holds 32 keys of shared memory; every thread must call.
__device__ __forceinline__ unsigned long long block_max_key(
    unsigned long long v, unsigned long long* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  unsigned long long b = 0;
  if (warp == 0) b = warp_max(lane < wpb ? scratch[lane] : 0ull);
  __syncthreads();
  return b;
}

// The G query keys of row r from gains ``g`` (every lane holds all G):
// lane q < gq returns query q's key, masked by its taken flag (``taken``
// points at the group's first query, rows of n flags; read from L2, as
// another block may have set it); other lanes 0.
template <int G>
__device__ __forceinline__ unsigned long long lane_key(const int (&g)[G],
                                                       const uint8_t* taken,
                                                       int64_t n, int64_t r,
                                                       int gq, int lane) {
  int mine = 0;
#pragma unroll
  for (int q = 0; q < G; ++q)
    if (lane == q) mine = g[q];
  if (lane >= gq) return 0;
  if (__ldcg(taken + (int64_t)lane * n + r)) mine = -1;
  return pick_key(mine, r);
}

// Fold the warps' per-query keys (lane q holds query q's) into the
// block's best key per query and hand each to ``post(q, key)`` on lane 0
// of warp q.  ``scratch`` holds G x 32 keys of shared memory; needs at
// least G warps; every thread must call.
template <int G, class Post>
__device__ __forceinline__ void block_post_keys(unsigned long long v,
                                                unsigned long long (*scratch)[32],
                                                int gq, Post post) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  if (lane < G) scratch[lane][warp] = v;
  __syncthreads();
  if (warp < gq) {
    const unsigned long long b = warp_max(lane < wpb ? scratch[warp][lane] : 0ull);
    if (lane == 0) post(warp, b);
  }
  __syncthreads();
}

// Rows a block owns come in units of ``unit`` rows, dealt round-robin to
// the machine's ``bpm`` blocks; only the owner reads or writes a row's
// taken flag.
__device__ __forceinline__ bool owns(int64_t r, int64_t unit, int bpm,
                                     int lb) {
  return (r / unit) % bpm == lb;
}

// Mark the excluded rows this block owns (the serving seed-constraint,
// masked like picked rows).  Thread 0 only.
__device__ __forceinline__ void mark_excluded(const int32_t* excluded,
                                              int64_t E, int64_t n,
                                              int64_t unit, int bpm, int lb,
                                              uint8_t* taken) {
  for (int64_t e = 0; e < E; ++e) {
    const int64_t r = excluded[e];
    if (r >= 0 && r < n && owns(r, unit, bpm, lb)) taken[r] = 1;
  }
}

// commit_pick: decode the machine's winning key, OR the winner's row
// into this block's shared-memory cover, mark it taken in its owner
// block, and (the machine's first block) write the seed, gain and row.
// A best gain <= 0 gives seed -1, gain 0 and a zero row.
__device__ __forceinline__ void commit_pick(
    unsigned long long win, const uint32_t* R, int64_t W, int64_t unit,
    int bpm, int lb, uint32_t* cov, uint8_t* taken, int32_t* seed_out,
    int32_t* gain_out, uint32_t* row_out) {
  const int gain = key_gain(win);
  const int64_t idx = key_row(win);
  const bool take = gain > 0;
  const uint32_t* wrow = R + idx * W;
  for (int64_t w = threadIdx.x; w < W; w += blockDim.x) {
    const uint32_t word = take ? wrow[w] : 0u;
    cov[w] |= word;
    if (lb == 0) row_out[w] = word;
  }
  if (threadIdx.x == 0) {
    if (take && owns(idx, unit, bpm, lb)) taken[idx] = 1;
    if (lb == 0) {
      *seed_out = take ? (int32_t)idx : -1;
      *gain_out = take ? gain : 0;
    }
  }
  __syncthreads();
}

// commit_pick for a group of gq queries at once (query q's key slot at
// keys[q * k], its cover at cov + q * W, its taken flags at taken + q *
// n): one pass over the words ORs every winner's row into its cover (a
// block writes the outputs of the queries q0 + q with (q0 + q) % nb ==
// lb), then one barrier.  ``s_win`` holds G keys of shared memory.
template <int G>
__device__ __forceinline__ void commit_group(
    const unsigned long long* keys, int64_t k, int64_t p, const uint32_t* R,
    int64_t W, int64_t n, int64_t unit, int nb, int lb, int64_t q0, int gq,
    uint32_t* cov, uint8_t* taken, int32_t* seeds, int32_t* gains,
    uint32_t* rows_out, unsigned long long* s_win) {
  if (threadIdx.x < gq) s_win[threadIdx.x] = __ldcg(keys + threadIdx.x * k);
  __syncthreads();
  int gain[G];
  int64_t idx[G];
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const unsigned long long win = q < gq ? s_win[q] : 0ull;
    gain[q] = key_gain(win);
    idx[q] = key_row(win);
  }
  for (int64_t w = threadIdx.x; w < W; w += blockDim.x) {
#pragma unroll
    for (int q = 0; q < G; ++q) {
      if (q >= gq) continue;
      const uint32_t word = gain[q] > 0 ? __ldg(R + idx[q] * W + w) : 0u;
      cov[q * W + w] |= word;
      if ((q0 + q) % nb == lb) rows_out[((q0 + q) * k + p) * W + w] = word;
    }
  }
  if (threadIdx.x < gq) {
    const int q = threadIdx.x;
    const bool take = gain[q] > 0;
    if (take && owns(idx[q], unit, nb, lb)) taken[q * n + idx[q]] = 1;
    if ((q0 + q) % nb == lb) {
      seeds[(q0 + q) * k + p] = take ? (int32_t)idx[q] : -1;
      gains[(q0 + q) * k + p] = take ? gain[q] : 0;
    }
  }
  __syncthreads();
}
