// Greedy max-k-cover, all k picks in one cooperative launch.  Replaces
// repro/kernels/greedy_pick.py: greedy_maxcover_resident_pallas
// (sweep_tile_argmax, commit_pick, _kernel), vmapped over machines at
// repro/core/randgreedi.py:131 and over queries at
// repro/kernels/ops.py:68.  Two kernels:
//
// greedy_pick_kernel — m machines, each with rows of its own ([m, n, W]).
// Each machine has its share of the blocks; per pick every block sweeps
// its share of its machine's rows (one warp per row, the cover in shared
// memory), folds its best key into the machine's key slot with a 64-bit
// atomicMax, and after one grid-wide sync commits the winner
// (greedy_core.cuh).  Each pick owns its key slot, zeroed by the caller,
// so nothing is reset between picks.  Bound on the H100: bytes — each
// pick re-reads the machine's rows; the bound counts the rows an exact
// lazy schedule must sweep (lazy_plain's tiles_needed).
//
// greedy_pick_batch_kernel — B queries over one shared [n, W] pool (the
// serving batch; the pool is never copied).  Blocks own rows, not
// queries: the queries go in groups of G (their G covers in shared
// memory, G x W x 4 bytes), and for every row it sweeps a warp loads
// each word once and folds it against all G covers, so a pick reads the
// pool once per group — ceil(B / G) x n x W x 4 bytes, not B times that.
// Groups run one after another in the same launch, each with all k
// picks.  Argmax and commit are per query as above: one key slot per
// (query, pick), taken flags per query (its exclusions and picks mask
// only its own gains), and after the grid sync every block ORs each
// query's winner into that query's cover.  Every row is read in every
// pick (the resident solve; the lazy skip is the other solver): ceil(B /
// G) pools of traffic a pick.  The gain work, B x k x n x W words, is
// skipped for 16-byte chunks zero across the warp (gain_core.cuh), so on
// a sparse pool the traffic binds.  The bound (as for every greedy
// solve) counts only the tiles an exact lazy schedule needs.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "greedy_core.cuh"

namespace cg = cooperative_groups;

__global__ void greedy_pick_kernel(const uint32_t* __restrict__ rows,
                                   const int32_t* __restrict__ excluded,
                                   int64_t E, int64_t n, int64_t W, int64_t k,
                                   int bpm, bool vec,
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
  const uint32_t* R = rows + (int64_t)mach * n * W;
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

constexpr int kBatchThreads = 512;

template <int G>
__global__ void __launch_bounds__(kBatchThreads, 1)
greedy_pick_batch_kernel(const uint32_t* __restrict__ rows,
                         const int32_t* __restrict__ excluded, int64_t E,
                         int64_t n, int64_t W, int64_t k, int64_t B, bool vec,
                         unsigned long long* keys, uint8_t* taken,
                         int32_t* seeds, uint32_t* rows_out,
                         uint32_t* covered, int32_t* gains) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) uint32_t cov[];  // G covers of W words
  __shared__ unsigned long long scratch[kMaxGroup][32];
  __shared__ unsigned long long s_win[kMaxGroup];
  const int nb = gridDim.x, lb = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;

  for (int64_t q0 = 0; q0 < B; q0 += G) {
    const int gq = (int)(B - q0 < G ? B - q0 : G);
    uint8_t* T = taken + q0 * n;
    unsigned long long* K = keys + q0 * k;
    for (int64_t w = threadIdx.x; w < (int64_t)G * W; w += blockDim.x)
      cov[w] = 0;
    if (threadIdx.x == 0)
      for (int q = 0; q < gq; ++q)
        mark_excluded(excluded + (q0 + q) * E, E, n, 1, nb, lb, T + q * n);
    __syncthreads();

    for (int64_t p = 0; p < k; ++p) {
      unsigned long long best = 0;  // lane q: query q's best so far
      for (int64_t r = lb + (int64_t)warp * nb; r < n;
           r += (int64_t)wpb * nb) {
        int g[G];
        warp_row_gains<G>(rows + r * W, cov, W, vec, lane, g);
        const unsigned long long key = lane_key<G>(g, T, n, r, gq, lane);
        best = key > best ? key : best;
      }
      block_post_keys<G>(best, scratch, gq,
                         [&](int q, unsigned long long b) {
                           if (b) atomicMax(K + q * k + p, b);
                         });
      grid.sync();
      commit_group<G>(K + p, k, p, rows, W, n, 1, nb, lb, q0, gq, cov, T,
                      seeds, gains, rows_out, s_win);
    }
    for (int q = 0; q < gq; ++q)
      if ((q0 + q) % nb == lb)
        for (int64_t w = threadIdx.x; w < W; w += blockDim.x)
          covered[(q0 + q) * W + w] = cov[q * W + w];
    __syncthreads();  // the next group zeroes the covers
  }
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
  bool vec = vec_rows(rows, W);
  void* args[] = {(void*)&rows, (void*)&excluded, &E_, &n_, &W_, &k_,
                  &bpm, &vec, &keys, &taken, &seeds, &rows_out, &covered,
                  &gains};
  err = cudaLaunchCooperativeKernel((void*)greedy_pick_kernel,
                                    dim3((unsigned)(m * bpm)), dim3(threads),
                                    args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Shared memory a block of the batch kernel may give to query covers:
// the opt-in maximum less the kernel's static scratch.  The caller picks
// G so that G x W x 4 bytes fit (greedy_pick.py: query_groups).
extern "C" int greedy_pick_batch_budget() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, greedy_pick_batch_kernel<kMaxGroup>);
  if (err != cudaSuccess) return -(int)err;
  return optin - (int)attr.sharedSizeBytes;
}

template <int G>
static int launch_batch(const void* rows, const void* excluded, void* keys,
                        void* taken, void* seeds, void* rows_out,
                        void* covered, void* gains, int64_t B, int64_t n,
                        int64_t W, int64_t k, int64_t E, void* stream) {
  const size_t smem = (size_t)G * W * sizeof(uint32_t);
  const int budget = greedy_pick_batch_budget();
  if (budget < 0) return -budget;
  if (smem > (size_t)budget) return -2;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = cudaFuncSetAttribute(
      greedy_pick_batch_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, greedy_pick_batch_kernel<G>, kBatchThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm == 0) return -2;
  int64_t nb = (int64_t)per_sm * sms;
  const int64_t useful = (n + kBatchThreads / 32 - 1) / (kBatchThreads / 32);
  if (nb > useful) nb = useful;
  int64_t E_ = E, n_ = n, W_ = W, k_ = k, B_ = B;
  bool vec = vec_rows(rows, W);
  void* args[] = {(void*)&rows, (void*)&excluded, &E_, &n_, &W_, &k_, &B_,
                  &vec, &keys, &taken, &seeds, &rows_out, &covered, &gains};
  err = cudaLaunchCooperativeKernel((void*)greedy_pick_batch_kernel<G>,
                                    dim3((unsigned)nb), dim3(kBatchThreads),
                                    args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// B queries over one shared pool in groups of G (1 .. kMaxGroup).
extern "C" int greedy_pick_batch(const void* rows, const void* excluded,
                                 void* keys, void* taken, void* seeds,
                                 void* rows_out, void* covered, void* gains,
                                 int64_t B, int64_t n, int64_t W, int64_t k,
                                 int64_t E, int64_t G, void* stream) {
  return with_group(G, [&](auto g) {
    return launch_batch<decltype(g)::value>(rows, excluded, keys, taken,
                                            seeds, rows_out, covered, gains,
                                            B, n, W, k, E, stream);
  });
}
