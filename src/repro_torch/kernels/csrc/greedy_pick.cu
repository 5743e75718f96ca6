// Greedy max-k-cover of m independent machines, all k picks in one
// cooperative launch.  Replaces repro/kernels/greedy_pick.py:
// greedy_maxcover_resident_pallas (sweep_tile_argmax, commit_pick,
// _kernel), vmapped over machines at repro/core/randgreedi.py:131.
//
// Per pick: every block sweeps its share of its machine's rows
// (one warp per row, lanes along the words, gain = sum popc(row & ~cov)
// with the cover in shared memory), masks picked and excluded rows to
// gain -1, and folds its best row into the machine's key slot with a
// 64-bit atomicMax on ((gain + 1) << 32) | (0xFFFFFFFF - row): the
// largest gain wins and, among equal gains, the lowest row index —
// jnp.argmax's tie-break.  One grid-wide sync later, every block reads
// the winner, ORs its row into its own shared-memory cover, and the
// machine's first block writes the seed, gain and row
// (commit_pick: a best gain <= 0 gives seed -1, gain 0, a zero row).
// Each pick owns its key slot, zeroed by the caller, so nothing is
// reset between picks.  A row's picked flag is written and read only
// by the block that sweeps that row.
//
// Bound on the H100: bytes — each pick re-reads the machine's rows
// (k * m * n * W * 4 bytes per solve; the roofline counts them once).
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "gain_core.cuh"

namespace cg = cooperative_groups;

__global__ void greedy_pick_kernel(const uint32_t* __restrict__ rows,
                                   const int32_t* __restrict__ excluded,
                                   int64_t E, int64_t n, int64_t W, int64_t k,
                                   int bpm, unsigned long long* keys,
                                   uint8_t* taken, int32_t* seeds,
                                   uint32_t* rows_out, uint32_t* covered,
                                   int32_t* gains) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ uint32_t cov[];
  __shared__ unsigned long long warp_best[32];
  const int mach = blockIdx.x / bpm;
  const int lb = blockIdx.x % bpm;  // block rank within the machine
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  const uint32_t* R = rows + (int64_t)mach * n * W;
  uint8_t* T = taken + (int64_t)mach * n;
  unsigned long long* K = keys + (int64_t)mach * k;

  for (int64_t w = threadIdx.x; w < W; w += blockDim.x) cov[w] = 0;
  if (threadIdx.x == 0) {  // rows this block owns that may not be picked
    for (int64_t e = 0; e < E; ++e) {
      const int64_t r = excluded[(int64_t)mach * E + e];
      if (r >= 0 && r < n && r % bpm == lb) T[r] = 1;
    }
  }
  __syncthreads();

  for (int64_t p = 0; p < k; ++p) {
    unsigned long long best = 0;
    for (int64_t r = lb + (int64_t)warp * bpm; r < n;
         r += (int64_t)wpb * bpm) {
      const uint32_t* row = R + r * W;
      int g = 0;
      for (int64_t w = lane; w < W; w += 32) g += andnot_popc(row[w], cov[w]);
      g = warp_sum(g);
      if (T[r]) g = -1;
      const unsigned long long key =
          ((unsigned long long)(uint32_t)(g + 1) << 32) |
          (unsigned long long)(0xFFFFFFFFu - (uint32_t)r);
      best = key > best ? key : best;
    }
    if (lane == 0) warp_best[warp] = best;
    __syncthreads();
    if (warp == 0) {
      unsigned long long b = lane < wpb ? warp_best[lane] : 0ull;
      b = warp_max(b);
      if (lane == 0 && b) atomicMax(K + p, b);
    }
    grid.sync();
    const unsigned long long win = __ldcg(K + p);
    const int gain = (int)(uint32_t)(win >> 32) - 1;
    const int64_t idx = (int64_t)(0xFFFFFFFFu - (uint32_t)win);
    const bool take = gain > 0;
    const uint32_t* wrow = R + idx * W;
    const int64_t out = (int64_t)mach * k + p;
    for (int64_t w = threadIdx.x; w < W; w += blockDim.x) {
      const uint32_t word = take ? wrow[w] : 0u;
      cov[w] |= word;
      if (lb == 0) rows_out[out * W + w] = word;
    }
    if (threadIdx.x == 0) {
      if (take && idx % bpm == lb) T[idx] = 1;
      if (lb == 0) {
        seeds[out] = take ? (int32_t)idx : -1;
        gains[out] = take ? gain : 0;
      }
    }
    __syncthreads();
  }
  if (lb == 0)
    for (int64_t w = threadIdx.x; w < W; w += blockDim.x)
      covered[(int64_t)mach * W + w] = cov[w];
}

extern "C" int greedy_pick(const void* rows, const void* excluded, void* keys,
                           void* taken, void* seeds, void* rows_out,
                           void* covered, void* gains, int64_t m, int64_t n,
                           int64_t W, int64_t k, int64_t E, void* stream) {
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
  int64_t E_ = E, n_ = n, W_ = W, k_ = k;
  void* args[] = {(void*)&rows, (void*)&excluded, &E_, &n_, &W_, &k_,
                  &bpm, &keys, &taken, &seeds, &rows_out, &covered, &gains};
  err = cudaLaunchCooperativeKernel((void*)greedy_pick_kernel,
                                    dim3((unsigned)(m * bpm)), dim3(threads),
                                    args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
