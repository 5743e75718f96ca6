// Greedy max-k-cover of m independent solves, all k picks in one
// cooperative launch.  Replaces repro/kernels/greedy_pick.py:
// greedy_maxcover_resident_pallas (sweep_tile_argmax, commit_pick,
// _kernel), vmapped over machines at repro/core/randgreedi.py:131 and
// over queries at repro/kernels/ops.py:68.
//
// Solve s reads its rows at rows + s * rstride: rstride = n * W for m
// machines with rows of their own, 0 for m queries over one shared
// [n, W] pool (the serving batch), which is then never copied.  All
// other state (cover, taken flags, keys, outputs) is per solve.
//
// Per pick: every block sweeps its share of its machine's rows (one warp
// per row, the cover in shared memory), folds its best key into the
// machine's key slot with a 64-bit atomicMax, and after one grid-wide
// sync commits the winner (greedy_core.cuh).  Each pick owns its key
// slot, zeroed by the caller, so nothing is reset between picks.
//
// Bound on the H100: bytes — each pick re-reads the solve's rows
// (k * m * n * W * 4 bytes per launch); the bound counts the rows an
// exact lazy schedule must sweep (lazy_plain's tiles_needed).
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "greedy_core.cuh"

namespace cg = cooperative_groups;

__global__ void greedy_pick_kernel(const uint32_t* __restrict__ rows,
                                   const int32_t* __restrict__ excluded,
                                   int64_t E, int64_t n, int64_t W, int64_t k,
                                   int64_t rstride, int bpm, bool vec,
                                   unsigned long long* keys, uint8_t* taken,
                                   int32_t* seeds,
                                   uint32_t* rows_out, uint32_t* covered,
                                   int32_t* gains) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) uint32_t cov[];
  __shared__ unsigned long long scratch[32];
  const int mach = blockIdx.x / bpm;
  const int lb = blockIdx.x % bpm;  // block rank within the machine
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  const uint32_t* R = rows + (int64_t)mach * rstride;
  uint8_t* T = taken + (int64_t)mach * n;
  unsigned long long* K = keys + (int64_t)mach * k;

  for (int64_t w = threadIdx.x; w < W; w += blockDim.x) cov[w] = 0;
  if (threadIdx.x == 0)
    mark_excluded(excluded + (int64_t)mach * E, E, n, 1, bpm, lb, T);
  __syncthreads();

  for (int64_t p = 0; p < k; ++p) {
    const unsigned long long best = block_max_key(
        warp_sweep_argmax(R, T, cov, W, vec, lb + (int64_t)warp * bpm, n,
                          (int64_t)wpb * bpm, lane),
        scratch);
    if (threadIdx.x == 0 && best) atomicMax(K + p, best);
    grid.sync();
    const int64_t out = (int64_t)mach * k + p;
    commit_pick(__ldcg(K + p), R, W, 1, bpm, lb, cov, T, seeds + out,
                gains + out, rows_out + out * W);
  }
  if (lb == 0)
    for (int64_t w = threadIdx.x; w < W; w += blockDim.x)
      covered[(int64_t)mach * W + w] = cov[w];
}

extern "C" int greedy_pick(const void* rows, const void* excluded, void* keys,
                           void* taken, void* seeds, void* rows_out,
                           void* covered, void* gains, int64_t m, int64_t n,
                           int64_t W, int64_t k, int64_t E, int64_t rstride,
                           void* stream) {
  const int threads = 256;
  const size_t smem = (size_t)W * sizeof(uint32_t);
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)optin) return -2;
  cudaError_t err = cudaFuncSetAttribute(
      greedy_pick_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, greedy_pick_kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t resident = (int64_t)per_sm * sms;
  if (m > resident) return -3;
  int bpm = (int)(resident / m);
  const int64_t useful = (n + (threads / 32) - 1) / (threads / 32);
  if (bpm > useful) bpm = (int)(useful > 0 ? useful : 1);
  int64_t E_ = E, n_ = n, W_ = W, k_ = k, rs_ = rstride;
  bool vec = vec_rows(rows, W);
  void* args[] = {(void*)&rows, (void*)&excluded, &E_, &n_, &W_, &k_,
                  &rs_, &bpm, &vec, &keys, &taken, &seeds, &rows_out,
                  &covered, &gains};
  err = cudaLaunchCooperativeKernel((void*)greedy_pick_kernel,
                                    dim3((unsigned)(m * bpm)), dim3(threads),
                                    args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
