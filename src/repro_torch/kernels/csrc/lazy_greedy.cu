// Lazy greedy max-k-cover, all k picks in one launch.  Replaces
// repro/kernels/lazy_greedy.py: greedy_maxcover_lazy_pallas —
// the resident solve plus a stale upper bound per row tile (INT32_MAX at
// first), so a pick re-reads only the tiles whose bound can still reach
// the best gain — for m machines with rows of their own
// (lazy_greedy_compact_kernel, lazy_greedy_kernel) and, vmapped over
// queries at repro/kernels/ops.py:83, for B queries over one shared
// [n, W] pool (lazy_greedy_batch_kernel).  A tile is ``tile`` rows.  On
// the TPU the tiles are swept in order against a running best; here
// warps and blocks run in any order, so a pick first sweeps some tiles,
// reads the best so far, and then skips a tile only when its bound is
// below that best (the machine axis: when the best key its rows could
// hold, its bound at its first row, is below the best's key, so a tile
// that could only tie the best at a higher row skips too;
// greedy_core.cuh: tile_key).  Any best read during a pick is <= the
// pick's final best, so a skipped tile could neither win nor tie at a
// lower row: seeds, rows, covered and gains are those of the resident
// solve in every schedule.  A swept tile's bound becomes its fresh masked
// max, which bounds every later pick (the cover and the picked set only
// grow).  tiles_swept counts the sweeps; it depends on the schedule.
//
// lazy_greedy_compact_kernel — the machine axis on the compact layout
// (greedy_core.cuh; the list from greedy_pick.cu's compact_rows_kernel,
// taken while it is short enough: greedy_pick.py, compact_pays).  One
// block of 1024 threads per machine, the cover in shared memory, no
// grid-wide sync.
// The bounds are kept per 32-row tile of the row index, as before, and
// apply to the tile's listed rows (its slots are contiguous).  Tiles are
// dealt to the 32 warps; phase 1, every warp sweeps its own tile with the
// largest bound (a lane per listed row); phase 2, after a barrier, each
// warp tests 32 tiles of its own at once against the block's best so far
// (a shared-memory key) and sweeps those it may not skip, one after
// another, reading the best again before each.  A swept tile's bound becomes the larger
// of its listed rows' fresh masked gains and 0 (its unlisted rows gain
// 0), still an upper bound.  Bound on the H100: bytes — the dense rows
// read once (the compaction) and the outputs written once; the list lies
// in L2, so a pick is latency: a few dependent L2 reads and barriers.
//
// lazy_greedy_kernel — the machine axis on the dense layout (longer
// lists: the rows of supercritical cascades).  Tiles are dealt round-robin to the machine's
// blocks, and only a tile's owner sweeps it or writes its bound.  Phase
// 1: every block sweeps its own tile with the largest bound.  Phase 2,
// after a grid-wide sync: every block sweeps each other tile of its own
// unless the best read again (from L2) before each tile lets it skip.  It
// stops and hands over as greedy_pick.cu's greedy_pick_kernel: a machine
// whose best gain is <= 0 sweeps no more, and the residual it hands
// over on is the sum of each tile's count from its last sweep (``tres``; an upper
// bound, as the cover and the taken rows only grow; every tile is swept
// in the first pick).  lazy_greedy_compact_kernel goes on from the
// handover with the bounds ub as they stand: both layouts bound the same
// 32-row tiles.
//
// lazy_greedy_batch_kernel: a group of G queries shares every sweep (G
// covers in shared memory, each row word loaded once for all G, as in
// greedy_pick.cu), and each query keeps its own bounds ub[q, t].  Tiles
// are dealt to blocks for listing only; the rows of every listed tile
// are spread over all warps of the grid, so a pick costs its rows over
// the whole card, not a tile's time on one SM.  Per pick:
//   1. each block lists its tiles whose bound is some query's largest
//      over all tiles (ub_top, folded during the pick before) — an exact
//      schedule sweeps those too — and the grid sweeps their rows;
//   2. after a grid-wide sync, each block reads the G bests once and
//      lists every other tile of its own unless ub[q, t] < best_q for
//      every query q of the group, and the grid sweeps those rows.
// A listed tile's bounds are set to -1 and raised by atomicMax from its
// rows, so a sweep refreshes all G bounds (each a fresh masked max, still
// an upper bound); the last row of a tile in phase 2 folds its bounds
// into the next pick's ub_top, and so do the owners of the tiles phase 2
// does not list.  tiles_swept[q] counts the tiles listed for q's group.
//
// The pick's argmax and commit are greedy_core.cuh's, shared with
// greedy_pick.cu.  Bound on the H100 of the dense layout and the query
// axis: the rows of the tiles an exact schedule that knows each pick's
// best sweeps (lazy_plain's tiles_needed) — bytes for the machines; for
// the queries, bytes of the tiles any query needs, once
// (tiles_needed_shared), against the integer ops of each query's own,
// whichever is more.
#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "greedy_core.cuh"
#include "kernel_table.cuh"

namespace cg = cooperative_groups;

__global__ void lazy_greedy_kernel(
    const uint32_t* __restrict__ rows, const int32_t* __restrict__ excluded,
    int64_t E, int64_t m, int64_t n, int64_t W, int64_t k, int64_t tile,
    int64_t num_tiles, int64_t cap, int bpm, bool vec,
    unsigned long long* keys, uint8_t* taken, int32_t* ub, int64_t* tres,
    unsigned long long* tally, int32_t* swept, int32_t* seeds,
    uint32_t* rows_out, uint32_t* covered, int32_t* gains) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) uint32_t cov[];
  __shared__ unsigned long long scratch[32];
  __shared__ long long cscratch[32];
  __shared__ int64_t s_tile;
  __shared__ int s_go;
  const int mach = blockIdx.x / bpm;
  const int lb = blockIdx.x % bpm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  const uint32_t* R = rows + (int64_t)mach * n * W;
  uint8_t* T = taken + (int64_t)mach * n;
  unsigned long long* K = keys + (int64_t)mach * k;
  int32_t* U = ub + (int64_t)mach * num_tiles;
  int64_t* TR = tres + (int64_t)mach * num_tiles;
  int my_swept = 0;

  for (int64_t w = threadIdx.x; w < W; w += blockDim.x) cov[w] = 0;
  if (threadIdx.x == 0)
    mark_excluded(excluded + (int64_t)mach * E, E, n, tile, bpm, lb, T);
  __syncthreads();

  // Sweep tile t: post its best key, refresh its bound and its residual
  // count (thread 0).
  auto sweep = [&](int64_t t, unsigned long long* slot) {
    const int64_t end = (t + 1) * tile < n ? (t + 1) * tile : n;
    long long mine = 0, resid = 0;
    const unsigned long long best = block_max_key_count(
        warp_sweep_argmax(R, T, cov, W, vec, t * tile + warp, end, wpb, lane,
                          &mine),
        mine, scratch, cscratch, &resid);
    if (threadIdx.x == 0) {
      U[t] = key_gain(best);
      TR[t] = resid;
      if (best) atomicMax(slot, best);
      ++my_swept;
    }
  };

  bool spent = false;      // this machine's gains ran out: it sweeps no more
  bool all_spent = false;  // every machine's did: the launch ends
  int64_t p = 0;
  for (; p < k; ++p) {
    int64_t lead = -1;
    if (!spent) {
      if (threadIdx.x == 0) {  // phase 1: this block's largest bound
        int top = INT_MIN;
        for (int64_t t = lb; t < num_tiles; t += bpm)
          if (U[t] > top) top = U[t], lead = t;
        s_tile = lead;
      }
      __syncthreads();
      lead = s_tile;
      if (lead >= 0) sweep(lead, K + p);
    }
    grid.sync();
    if (!spent) {
      for (int64_t t = lb; t < num_tiles; t += bpm) {  // phase 2
        if (t == lead) continue;
        if (threadIdx.x == 0)
          s_go = !(tile_key(U[t], t * tile) < __ldcg(K + p));
        __syncthreads();
        const bool go = s_go;
        __syncthreads();
        if (go) sweep(t, K + p);
      }
      // The residual of this block's tiles: each tile's count from its
      // last sweep, which bounds it now (the cover and the taken rows only
      // grow).  Every tile is swept in the first pick (bounds INT_MAX).
      __syncthreads();
      if (warp == 0) {
        long long s = 0;
        for (int64_t t = lb + (int64_t)lane * bpm; t < num_tiles;
             t += 32ll * bpm)
          s += TR[t];
        s = warp_sum64(s);
        if (lane == 0 && s) atomicAdd(tally + p, (unsigned long long)s);
      }
    }
    grid.sync();
    if (!any_gain(keys, m, k, p)) {
      all_spent = true;
      break;
    }
    const unsigned long long win = __ldcg(K + p);
    spent = key_gain(win) <= 0;
    if (!spent) {
      const int64_t out = (int64_t)mach * k + p;
      commit_pick(win, R, W, tile, bpm, lb, cov, T, seeds + out, gains + out,
                  rows_out + out * W);
    }
    if (cap > 0 && __ldcg(tally + p) <= (unsigned long long)cap) {
      ++p;
      break;
    }
  }
  if (lb == 0)
    for (int64_t w = threadIdx.x; w < W; w += blockDim.x)
      covered[(int64_t)mach * W + w] = cov[w];
  if (threadIdx.x == 0) atomicAdd(swept + mach, my_swept);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    tally[k] = (unsigned long long)p;
    tally[k + 1] = all_spent;
  }
}

constexpr int kCompactThreads = 1024;

// Picks p0 .. k - 1 of m machines over their compact lists, one block
// per machine; ``tiles`` (first slot, listed rows) per 32-row tile.  The
// cover starts from ``covered``, the taken flags, bounds ``ub`` and
// ``swept`` from what they hold (a fresh solve's zeros and INT_MAX, or a
// dense launch's at its handover); a machine stops at the first pick
// whose best gain is <= 0.
__global__ void __launch_bounds__(kCompactThreads, 1)
lazy_greedy_compact_kernel(
    const uint32_t* __restrict__ rows, const int32_t* __restrict__ excluded,
    int64_t E, int64_t n, int64_t W, int64_t k, int64_t p0, int64_t num_tiles,
    const int32_t* __restrict__ row_ids, const int32_t* __restrict__ counts,
    const int64_t* __restrict__ starts, const int2* __restrict__ tiles,
    const int2* __restrict__ ent, uint8_t* taken, int32_t* ub,
    int32_t* swept, int32_t* seeds, uint32_t* rows_out, uint32_t* covered,
    int32_t* gains) {
  extern __shared__ __align__(16) uint32_t cov[];
  __shared__ unsigned long long scratch[32];
  __shared__ unsigned long long s_best;
  __shared__ int s_swept;
  const int64_t mach = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  const uint32_t* R = rows + mach * n * W;
  uint8_t* T = taken + mach * n;
  int32_t* U = ub + mach * num_tiles;  // this block's alone: through L1
  const int2* TL = tiles + mach * num_tiles;
  const RowList L{row_ids + mach * n, counts + mach * n, starts + mach * n,
                  ent};

  for (int64_t w = threadIdx.x; w < W; w += blockDim.x)
    cov[w] = covered[mach * W + w];
  if (threadIdx.x == 0) {
    mark_excluded(excluded + mach * E, E, n, 1, 1, 0, T);
    s_swept = 0;
  }
  __syncthreads();

  // Sweep tile t (``td``: its first slot, its listed rows) with the whole
  // warp, a lane per listed row: post its best key and refresh its bound
  // (a tile of no listed rows gains 0: no loads).
  auto sweep = [&](int64_t t, int2 td) {
    unsigned long long key = 0;
    if (td.y)
      key = warp_max(warp_listed_best<1>(L, (int64_t)td.x + lane, 0,
                                         (int64_t)td.x + td.y, T, cov, lane));
    if (lane == 0) {
      U[t] = max(key_gain(key), 0);
      if (key) atomicMax(&s_best, key);
      atomicAdd(&s_swept, 1);
    }
  };
  // The best read so far lets tile t be skipped (greedy_core.cuh:
  // tile_key).
  auto skip = [&](int64_t t) {
    return tile_key(U[t], t * kTileRows) <
           *reinterpret_cast<volatile unsigned long long*>(&s_best);
  };

  for (int64_t p = p0; p < k; ++p) {
    if (threadIdx.x == 0) s_best = 0;
    __syncthreads();
    // phase 1: each warp sweeps its own tile with the largest bound (the
    // lowest among equals); warp w owns tiles 32 w + lane + 32 wpb i
    unsigned long long top = 0;
    for (int64_t t0 = (int64_t)warp * 32; t0 < num_tiles;
         t0 += (int64_t)wpb * 32) {
      const int64_t t = t0 + lane;
      if (t < num_tiles) {
        const unsigned long long key =
            ((unsigned long long)((uint32_t)U[t] ^ 0x80000000u) << 32) |
            (0xFFFFFFFFu - (uint32_t)t);
        top = key > top ? key : top;
      }
    }
    top = warp_max(top);
    const int64_t lead = top ? (int64_t)(0xFFFFFFFFu - (uint32_t)top) : -1;
    if (lead >= 0) sweep(lead, __ldg(TL + lead));
    __syncthreads();
    // phase 2: each warp's other tiles, 32 at a time (their descriptors
    // loaded at once), against the best so far, read again before each
    // sweep
    for (int64_t t0 = (int64_t)warp * 32; t0 < num_tiles;
         t0 += (int64_t)wpb * 32) {
      const int64_t t = t0 + lane;
      const bool go = t < num_tiles && t != lead && !skip(t);
      const int2 td = go ? __ldg(TL + t) : make_int2(0, 0);
      for (unsigned b = __ballot_sync(0xffffffffu, go); b; b &= b - 1) {
        const int src = __ffs(b) - 1;
        const int2 tds = make_int2(__shfl_sync(0xffffffffu, td.x, src),
                                   __shfl_sync(0xffffffffu, td.y, src));
        // lane 0's reading decides for the warp: the sweep's collectives
        // need every lane
        if (!__shfl_sync(0xffffffffu, (int)skip(t0 + src), 0))
          sweep(t0 + src, tds);
      }
    }
    __syncthreads();
    if (key_gain(s_best) <= 0) break;  // the gains ran out
    const int64_t out = mach * k + p;
    commit_pick(s_best, R, W, 1, 1, 0, cov, T, seeds + out, gains + out,
                rows_out + out * W);
  }
  for (int64_t w = threadIdx.x; w < W; w += blockDim.x)
    covered[mach * W + w] = cov[w];
  if (threadIdx.x == 0) swept[mach] += s_swept;
}

// The compact layout's lazy picks p0 .. k - 1: one block of
// kCompactThreads per machine over the list of greedy_pick.cu's
// compact_rows.
extern "C" int lazy_greedy_compact(const void* rows, const void* excluded,
                                   const void* row_ids, const void* counts,
                                   const void* starts, const void* tiles,
                                   const void* ent, void* taken, void* ub,
                                   void* swept, void* seeds, void* rows_out,
                                   void* covered, void* gains, int64_t m,
                                   int64_t n, int64_t W, int64_t k, int64_t E,
                                   int64_t p0, void* stream) {
  size_t smem = 0;
  const int planned = cover_smem(lazy_greedy_compact_kernel, W, &smem);
  if (planned) return planned;
  const int64_t num_tiles = (n + kTileRows - 1) / kTileRows;
  lazy_greedy_compact_kernel<<<(unsigned)m, kCompactThreads, smem,
                               (cudaStream_t)stream>>>(
      (const uint32_t*)rows, (const int32_t*)excluded, E, n, W, k, p0,
      num_tiles,
      (const int32_t*)row_ids, (const int32_t*)counts, (const int64_t*)starts,
      (const int2*)tiles, (const int2*)ent, (uint8_t*)taken, (int32_t*)ub,
      (int32_t*)swept, (int32_t*)seeds, (uint32_t*)rows_out,
      (uint32_t*)covered, (int32_t*)gains);
  return (int)cudaGetLastError();
}

static const int kThreads = 256;

// The launch's blocks per machine (``bpm``) and dynamic shared memory;
// returns 0, a refusal (-2, -3) or a cudaError_t.
static int plan(int64_t m, int64_t n, int64_t W, int64_t tile,
                int64_t min_tiles_per_block, size_t* smem, int64_t* bpm) {
  *smem = (size_t)cover_bytes(W);
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (*smem > (size_t)optin) return -2;
  cudaError_t err = cudaFuncSetAttribute(
      lazy_greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)*smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, lazy_greedy_kernel, kThreads, *smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t resident = (int64_t)per_sm * sms;
  if (m > resident) return -3;
  const int64_t num_tiles = (n + tile - 1) / tile;
  // Enough tiles per block that phase 1 leaves most of them to skip.
  *bpm = resident / m;
  const int64_t useful =
      (num_tiles + min_tiles_per_block - 1) / min_tiles_per_block;
  if (*bpm > useful) *bpm = useful > 0 ? useful : 1;
  return 0;
}

// The tiles of one machine that phase 1 sweeps in every pick (its
// blocks), or a refusal / error code as lazy_greedy returns it.
extern "C" int lazy_greedy_blocks_per_machine(int64_t m, int64_t n, int64_t W,
                                              int64_t tile,
                                              int64_t min_tiles_per_block) {
  size_t smem = 0;
  int64_t bpm = 0;
  const int err = plan(m, n, W, tile, min_tiles_per_block, &smem, &bpm);
  return err ? err : (int)bpm;
}

// The dense lazy picks from pick 0: ``tres`` (int64 [m, tiles]) keeps
// each tile's residual count from its last sweep; ``tally`` and ``cap``
// as greedy_pick.cu's greedy_pick.
extern "C" int lazy_greedy(const void* rows, const void* excluded, void* keys,
                           void* taken, void* ub, void* tres, void* tally,
                           void* swept, void* seeds, void* rows_out,
                           void* covered, void* gains, int64_t m, int64_t n,
                           int64_t W, int64_t k, int64_t E, int64_t tile,
                           int64_t min_tiles_per_block, int64_t cap,
                           void* stream) {
  size_t smem = 0;
  int64_t bpm = 0;
  const int planned = plan(m, n, W, tile, min_tiles_per_block, &smem, &bpm);
  if (planned) return planned;
  const int64_t num_tiles = (n + tile - 1) / tile;
  int bpm_ = (int)bpm;
  int64_t E_ = E, m_ = m, n_ = n, W_ = W, k_ = k, tile_ = tile,
          nt_ = num_tiles, cap_ = cap;
  bool vec = vec_rows(rows, W);
  void* args[] = {(void*)&rows, (void*)&excluded, &E_, &m_, &n_, &W_, &k_,
                  &tile_, &nt_, &cap_, &bpm_, &vec, &keys, &taken, &ub,
                  &tres, &tally, &swept, &seeds, &rows_out, &covered, &gains};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (void*)lazy_greedy_kernel, dim3((unsigned)(m * bpm)), dim3(kThreads),
      args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

constexpr int kBatchThreads = 512;

template <int G>
__global__ void __launch_bounds__(kBatchThreads, 1) lazy_greedy_batch_kernel(
    const uint32_t* __restrict__ rows, const int32_t* __restrict__ excluded,
    int64_t E, int64_t n, int64_t W, int64_t k, int64_t B, int64_t tile,
    int64_t num_tiles, bool vec, unsigned long long* keys, uint8_t* taken,
    int32_t* ub, int32_t* ub_top, int32_t* work, int32_t* swept,
    int32_t* seeds, uint32_t* rows_out, uint32_t* covered, int32_t* gains) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) uint32_t cov[];  // G covers of W words
  __shared__ unsigned long long scratch[kMaxGroup][32];
  __shared__ unsigned long long s_best[kMaxGroup];
  __shared__ unsigned long long s_win[kMaxGroup];
  __shared__ int s_top[kMaxGroup];
  const int nb = gridDim.x, lb = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  const int64_t gwarp = (int64_t)lb * wpb + warp, nwarps = (int64_t)nb * wpb;
  // this block's tiles: lb, lb + nb, ...
  const int64_t owned = lb < num_tiles ? (num_tiles - 1 - lb) / nb + 1 : 0;
  // work: per (group, pick) the shortlist's length; the shortlist; per
  // tile the pick that listed it in phase 1 (owner only) and the rows of
  // it swept so far in phase 2.  Any block sweeps any listed row, so
  // bounds and taken flags are read from L2 (__ldcg), never a stale L1.
  int32_t* list = work + (B + G - 1) / G * k;
  int32_t* stamp = list + num_tiles;
  int32_t* done = stamp + num_tiles;

  for (int64_t q0 = 0; q0 < B; q0 += G) {
    const int gq = (int)(B - q0 < G ? B - q0 : G);
    uint8_t* T = taken + q0 * n;
    unsigned long long* K = keys + q0 * k;
    int32_t* U = ub + q0 * num_tiles;
    int32_t* UT = ub_top + q0 * k;
    int32_t* count = work + q0 / G * k;
    int64_t listed = 0;
    for (int64_t w = threadIdx.x; w < (int64_t)G * W; w += blockDim.x)
      cov[w] = 0;
    if (threadIdx.x == 0)
      for (int q = 0; q < gq; ++q)
        mark_excluded(excluded + (q0 + q) * E, E, n, tile, nb, lb, T + q * n);
    __syncthreads();

    // Sweep the rows of shortlist entries [from, to) with every warp of
    // the grid: each query's masked gain of a row raises the query's
    // bound of the row's tile (set to -1 when listed) and the warp's best
    // key, which the block then posts.  With ``fold``, the lane that
    // counts a tile's last row folds its fresh bounds into ub_top[., p + 1].
    auto sweep_rows = [&](int64_t from, int64_t to, int64_t p, bool fold) {
      unsigned long long best = 0;
      for (int64_t i = from * tile + gwarp; i < to * tile; i += nwarps) {
        const int64_t t = __ldcg(list + i / tile);
        const int64_t r = t * tile + i % tile;
        if (r >= n) continue;  // the last tile is short
        int g[G];
        warp_row_gains<G>(rows + r * W, cov, W, vec, lane, g);
        const unsigned long long key = lane_key<G>(g, T, n, r, gq, lane);
        best = key > best ? key : best;
        if (lane < gq) {
          atomicMax(U + lane * num_tiles + t, key_gain(key));
          if (fold) {
            __threadfence();
            const int64_t rows_t = n - t * tile < tile ? n - t * tile : tile;
            if (atomicAdd(done + t, 1) == rows_t * gq - 1 && p + 1 < k) {
              __threadfence();
              for (int q = 0; q < gq; ++q)
                atomicMax(UT + q * k + p + 1, __ldcg(U + q * num_tiles + t));
            }
          }
        }
      }
      block_post_keys<G>(best, scratch, gq,
                         [&](int q, unsigned long long b) {
                           if (b) atomicMax(K + q * k + p, b);
                         });
    };

    for (int64_t p = 0; p < k; ++p) {
      const int32_t pick_id = (int32_t)(q0 / G * k + p + 1);
      // phase 1: list every tile of ours whose bound is a query's largest
      // over all tiles (ub_top; every tile at the first pick): an exact
      // schedule sweeps it too
      if (threadIdx.x < gq)
        s_top[threadIdx.x] = p == 0 ? INT_MAX : __ldcg(UT + threadIdx.x * k + p);
      __syncthreads();
      for (int64_t j = threadIdx.x; j < owned; j += blockDim.x) {
        const int64_t t = lb + j * nb;
        bool at_top = false;
#pragma unroll
        for (int q = 0; q < G; ++q)
          if (q < gq) at_top |= __ldcg(U + q * num_tiles + t) >= s_top[q];
        if (at_top) {
          list[atomicAdd(count + p, 1)] = (int32_t)t;
          stamp[t] = pick_id;
          for (int q = 0; q < gq; ++q) U[q * num_tiles + t] = -1;
        }
      }
      grid.sync();
      const int64_t leads = __ldcg(count + p);
      sweep_rows(0, leads, p, false);
      grid.sync();
      // phase 2: against the group's bests now (<= the pick's final
      // ones), list every other tile of ours that some query may still
      // need, and fold the bounds of the rest, final for the next pick,
      // into ub_top
      if (threadIdx.x < gq) s_best[threadIdx.x] = __ldcg(K + threadIdx.x * k + p);
      __syncthreads();
      int m[G];
#pragma unroll
      for (int q = 0; q < G; ++q) m[q] = INT_MIN;
      for (int64_t j = threadIdx.x; j < owned; j += blockDim.x) {
        const int64_t t = lb + j * nb;
        bool go = false;
        if (stamp[t] != pick_id)
#pragma unroll
          for (int q = 0; q < G; ++q)
            if (q < gq) {
              const unsigned long long cur = s_best[q];
              go |= !(cur && __ldcg(U + q * num_tiles + t) < key_gain(cur));
            }
        if (go) {
          list[atomicAdd(count + p, 1)] = (int32_t)t;
          done[t] = 0;
          for (int q = 0; q < gq; ++q) U[q * num_tiles + t] = -1;
        } else {
#pragma unroll
          for (int q = 0; q < G; ++q)
            if (q < gq) m[q] = max(m[q], __ldcg(U + q * num_tiles + t));
        }
      }
      if (p + 1 < k) {
        unsigned long long mine = 0;
#pragma unroll
        for (int q = 0; q < G; ++q) {
          const int v = warp_max(m[q]);
          if (lane == q && q < gq) mine = (uint32_t)v ^ 0x80000000u;
        }
        block_post_keys<G>(mine, scratch, gq,
                           [&](int q, unsigned long long b) {
                             atomicMax(UT + q * k + p + 1,
                                       (int)((uint32_t)b ^ 0x80000000u));
                           });
      }
      grid.sync();
      const int64_t total = __ldcg(count + p);
      sweep_rows(leads, total, p, true);
      listed += total;
      grid.sync();
      commit_group<G>(K + p, k, p, rows, W, n, tile, nb, lb, q0, gq, cov, T,
                      seeds, gains, rows_out, s_win);
    }
    if (lb == 0 && threadIdx.x < gq) swept[q0 + threadIdx.x] = (int32_t)listed;
    for (int q = 0; q < gq; ++q)
      if ((q0 + q) % nb == lb)
        for (int64_t w = threadIdx.x; w < W; w += blockDim.x)
          covered[(q0 + q) * W + w] = cov[q * W + w];
    __syncthreads();  // the next group zeroes the covers
  }
}

// Shared memory a block of the batch kernel may give to query covers:
// the opt-in maximum less the kernel's static scratch.  The caller picks
// G so that G x W x 4 bytes fit (greedy_pick.py: query_groups).
extern "C" int lazy_greedy_batch_budget() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, lazy_greedy_batch_kernel<kMaxGroup>);
  if (err != cudaSuccess) return -(int)err;
  return optin - (int)attr.sharedSizeBytes;
}

// The batch launch's blocks (all that fit, at most one warp a row) and
// dynamic shared memory; returns 0, -2 or a cudaError_t.
template <int G>
static int plan_batch(int64_t n, int64_t W, size_t* smem, int64_t* nb) {
  *smem = (size_t)group_cover_bytes(G, W);
  const int budget = lazy_greedy_batch_budget();
  if (budget < 0) return -budget;
  if (*smem > (size_t)budget) return -2;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = cudaFuncSetAttribute(
      lazy_greedy_batch_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)*smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, lazy_greedy_batch_kernel<G>, kBatchThreads, *smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm == 0) return -2;
  const int64_t useful = (n + kBatchThreads / 32 - 1) / (kBatchThreads / 32);
  *nb = (int64_t)per_sm * sms;
  if (*nb > useful) *nb = useful;
  return 0;
}

template <int G>
static int launch_batch(const void* rows, const void* excluded, void* keys,
                        void* taken, void* ub, void* ub_top, void* work,
                        void* swept, void* seeds, void* rows_out,
                        void* covered, void* gains, int64_t B, int64_t n,
                        int64_t W, int64_t k, int64_t E, int64_t tile,
                        void* stream) {
  size_t smem = 0;
  int64_t nb = 0;
  const int planned = plan_batch<G>(n, W, &smem, &nb);
  if (planned) return planned;
  const int64_t num_tiles = (n + tile - 1) / tile;
  int64_t E_ = E, n_ = n, W_ = W, k_ = k, B_ = B, tile_ = tile,
          nt_ = num_tiles;
  bool vec = vec_rows(rows, W);
  void* args[] = {(void*)&rows, (void*)&excluded, &E_, &n_, &W_, &k_, &B_,
                  &tile_, &nt_, &vec, &keys, &taken, &ub, &ub_top, &work,
                  &swept, &seeds, &rows_out, &covered, &gains};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (void*)lazy_greedy_batch_kernel<G>, dim3((unsigned)nb),
      dim3(kBatchThreads), args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// B queries over one shared pool in groups of G (1 .. kMaxGroup).
extern "C" int lazy_greedy_batch(const void* rows, const void* excluded,
                                 void* keys, void* taken, void* ub,
                                 void* ub_top, void* work, void* swept,
                                 void* seeds, void* rows_out, void* covered,
                                 void* gains, int64_t B, int64_t n, int64_t W,
                                 int64_t k, int64_t E, int64_t tile,
                                 int64_t G, void* stream) {
  return with_group(G, [&](auto g) {
    return launch_batch<decltype(g)::value>(
        rows, excluded, keys, taken, ub, ub_top, work, swept, seeds,
        rows_out, covered, gains, B, n, W, k, E, tile, stream);
  });
}

// The dynamic shared memory of a launch (kernel_table.cuh): the cover of
// W words (lazy_greedy, lazy_greedy_compact), or a group's x covers
// (lazy_greedy_batch, x = G).
extern "C" int64_t launch_smem(const char* launch, int64_t W, int64_t x) {
  if (same_launch(launch, "lazy_greedy") ||
      same_launch(launch, "lazy_greedy_compact"))
    return cover_bytes(W);
  if (same_launch(launch, "lazy_greedy_batch"))
    return group_cover_bytes(x, W);
  return -1;
}

static const KernelEntry kKernels[] = {
    {"lazy_greedy", "lazy_greedy_kernel", (const void*)lazy_greedy_kernel,
     kThreads},
    {"lazy_greedy_compact", "lazy_greedy_compact_kernel",
     (const void*)lazy_greedy_compact_kernel, kCompactThreads},
    GROUP_ENTRIES("lazy_greedy_batch", lazy_greedy_batch_kernel,
                  kBatchThreads),
};
KERNEL_TABLE_EXPORTS(kKernels)
