// Lazy greedy max-k-cover of m independent solves, all k picks in one
// cooperative launch.  Replaces repro/kernels/lazy_greedy.py:
// greedy_maxcover_lazy_pallas — the resident solve plus a stale upper
// bound per row tile, ub[m, num_tiles] (INT32_MAX at first), so a pick
// re-reads only the tiles whose bound can still reach the best gain —
// vmapped over queries at repro/kernels/ops.py:83.
//
// Solve s reads its rows at rows + s * rstride: n * W for machines, 0
// for queries over one shared [n, W] pool.  Each query keeps its own
// bounds (they depend on its exclusions and picks).
//
// A tile is ``tile`` rows; tiles are dealt round-robin to the machine's
// blocks, and only a tile's owner sweeps it or writes its bound.  On
// the TPU the tiles are swept in order against a running best; here the
// blocks run in any order, so each pick has two phases:
//   1. every block sweeps its own tile with the largest bound and folds
//      the tile's best key into the machine's key slot (atomicMax);
//   2. after a grid-wide sync, every block walks its other tiles and
//      sweeps tile t only unless ub[t] < best, where best is the gain of
//      the machine's key slot read just before (from L2).  A tile whose
//      bound equals best is swept.
// Any best read during a pick is <= that pick's final best, so a
// skipped tile (fresh masked max <= ub < best) could neither win nor
// tie: seeds, rows, covered and gains are those of the resident solve
// in every schedule.  A swept tile's bound becomes its fresh masked max,
// which bounds every later pick (the cover and the picked set only
// grow).  tiles_swept[m] counts the sweeps; it depends on the schedule.
//
// The pick's argmax and commit are greedy_core.cuh's, shared with
// greedy_pick.cu.  Bound on the H100: bytes — the rows of the tiles an
// exact schedule that knows each pick's best sweeps (lazy_plain's
// tiles_needed), read once a sweep.
#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "greedy_core.cuh"

namespace cg = cooperative_groups;

__global__ void lazy_greedy_kernel(
    const uint32_t* __restrict__ rows, const int32_t* __restrict__ excluded,
    int64_t E, int64_t n, int64_t W, int64_t k, int64_t tile,
    int64_t num_tiles, int64_t rstride, int bpm, bool vec,
    unsigned long long* keys, uint8_t* taken, int32_t* ub, int32_t* swept,
    int32_t* seeds, uint32_t* rows_out, uint32_t* covered, int32_t* gains) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) uint32_t cov[];
  __shared__ unsigned long long scratch[32];
  __shared__ int64_t s_tile;
  __shared__ int s_go;
  const int mach = blockIdx.x / bpm;
  const int lb = blockIdx.x % bpm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  const uint32_t* R = rows + (int64_t)mach * rstride;
  uint8_t* T = taken + (int64_t)mach * n;
  unsigned long long* K = keys + (int64_t)mach * k;
  int32_t* U = ub + (int64_t)mach * num_tiles;
  int my_swept = 0;

  for (int64_t w = threadIdx.x; w < W; w += blockDim.x) cov[w] = 0;
  if (threadIdx.x == 0)
    mark_excluded(excluded + (int64_t)mach * E, E, n, tile, bpm, lb, T);
  __syncthreads();

  // Sweep tile t: post its best key and refresh its bound (thread 0).
  auto sweep = [&](int64_t t, unsigned long long* slot) {
    const int64_t end = (t + 1) * tile < n ? (t + 1) * tile : n;
    const unsigned long long best = block_max_key(
        warp_sweep_argmax(R, T, cov, W, vec, t * tile + warp, end, wpb,
                          lane),
        scratch);
    if (threadIdx.x == 0) {
      U[t] = key_gain(best);
      if (best) atomicMax(slot, best);
      ++my_swept;
    }
  };

  for (int64_t p = 0; p < k; ++p) {
    if (threadIdx.x == 0) {  // phase 1: this block's largest bound
      int64_t lead = -1;
      int top = INT_MIN;
      for (int64_t t = lb; t < num_tiles; t += bpm)
        if (U[t] > top) top = U[t], lead = t;
      s_tile = lead;
    }
    __syncthreads();
    const int64_t lead = s_tile;
    if (lead >= 0) sweep(lead, K + p);
    grid.sync();
    for (int64_t t = lb; t < num_tiles; t += bpm) {  // phase 2
      if (t == lead) continue;
      if (threadIdx.x == 0) {
        const unsigned long long cur = __ldcg(K + p);
        s_go = !(cur && U[t] < key_gain(cur));
      }
      __syncthreads();
      const bool go = s_go;
      __syncthreads();
      if (go) sweep(t, K + p);
    }
    grid.sync();
    const int64_t out = (int64_t)mach * k + p;
    commit_pick(__ldcg(K + p), R, W, tile, bpm, lb, cov, T, seeds + out,
                gains + out, rows_out + out * W);
  }
  if (lb == 0)
    for (int64_t w = threadIdx.x; w < W; w += blockDim.x)
      covered[(int64_t)mach * W + w] = cov[w];
  if (threadIdx.x == 0) atomicAdd(swept + mach, my_swept);
}

static const int kThreads = 256;

// The launch's blocks per machine (``bpm``) and dynamic shared memory;
// returns 0, a refusal (-2, -3) or a cudaError_t.
static int plan(int64_t m, int64_t n, int64_t W, int64_t tile,
                int64_t min_tiles_per_block, size_t* smem, int64_t* bpm) {
  *smem = (size_t)W * sizeof(uint32_t);
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

extern "C" int lazy_greedy(const void* rows, const void* excluded, void* keys,
                           void* taken, void* ub, void* swept, void* seeds,
                           void* rows_out, void* covered, void* gains,
                           int64_t m, int64_t n, int64_t W, int64_t k,
                           int64_t E, int64_t tile, int64_t min_tiles_per_block,
                           int64_t rstride, void* stream) {
  size_t smem = 0;
  int64_t bpm = 0;
  const int planned = plan(m, n, W, tile, min_tiles_per_block, &smem, &bpm);
  if (planned) return planned;
  const int64_t num_tiles = (n + tile - 1) / tile;
  int bpm_ = (int)bpm;
  int64_t E_ = E, n_ = n, W_ = W, k_ = k, tile_ = tile, nt_ = num_tiles,
          rs_ = rstride;
  bool vec = vec_rows(rows, W);
  void* args[] = {(void*)&rows, (void*)&excluded, &E_, &n_, &W_, &k_,
                  &tile_, &nt_, &rs_, &bpm_, &vec, &keys, &taken, &ub, &swept,
                  &seeds, &rows_out, &covered, &gains};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (void*)lazy_greedy_kernel, dim3((unsigned)(m * bpm)), dim3(kThreads),
      args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
