// The pick of the greedy senders, shared by greedy_pick.cu (the resident
// solve) and lazy_greedy.cu (the lazy solve), as the reference's
// lazy_greedy.py reuses greedy_pick.sweep_tile_argmax and commit_pick:
// the bit-exactness contract has one implementation.
//
// A row's key for the argmax is ((gain + 1) << 32) | (0xFFFFFFFF - row):
// the largest gain wins and, among equal gains, the lowest row index —
// jnp.argmax's tie-break.  Picked and excluded rows score gain -1.  A
// machine's winner is the 64-bit atomicMax of its blocks' keys.
#pragma once
#include <cstdint>

#include "gain_core.cuh"

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
