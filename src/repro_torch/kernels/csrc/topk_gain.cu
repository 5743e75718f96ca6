// One greedy pick: the masked marginal-gain sweep fused with the argmax.
// Replaces repro/kernels/topk_gain.py: best_gain_index_pallas (the
// solver="fused" per-pick engine), with the machine axis added
// (best_gain_kernel), and its vmap over queries at
// repro/core/maxcover.py:141 (best_gain_batch_kernel: rows shared).
//
//   gain[q, v] = picked[q, v] ? -1 : sum_w popc(rows[(q,) v, w] & ~cov[q, w])
//   best[q], index[q] = max and lowest argmax of gain[q, :]
//
// Each block folds its best key ((gain + 1) << 32 | ~row, greedy_core.cuh)
// into the solve's key with a 64-bit atomicMax, so the gain vector never
// reaches device memory and ties go to the lowest row as in jnp.argmax.
// A second one-block launch decodes the keys.  Rows beyond n are never
// swept (the reference pads them as picked).  Bound on the H100: bytes.
//
// best_gain_kernel — m machines, each over its own rows: one warp per
// row, the machine's cover in shared memory, a share of the grid per
// machine.  One read of the rows a pick.
//
// best_gain_batch_kernel — B queries over one shared [n, W] pool (the
// serving batch's fused solver).  Blocks own rows, not queries: the
// queries go in groups of G (greedy_pick.py: query_groups, with the
// budget topk_gain_batch_budget exports), the group's G covers sit in
// shared memory (G x W x 4 bytes), and each warp loads every word of its
// row once and folds it against all G covers (gain_core.cuh:
// warp_row_gains, 16-byte loads, chunks zero across the warp skipped).
// A lane keeps query q's running key (lane_key: a picked row scores -1
// for its own query only) and each block posts one atomicMax a query.
// Groups run one after another in the same C call (the last one, if
// ragged, instantiated for its own size), so a pick reads the pool
// ceil(B / G) times, not B times.
#include <cstdint>
#include <cuda_runtime.h>

#include "greedy_core.cuh"
#include "kernel_table.cuh"

constexpr int kThreads = 256;

__global__ void best_gain_kernel(const uint32_t* __restrict__ rows,
                                 const uint32_t* __restrict__ covered,
                                 const uint8_t* __restrict__ picked, int64_t n,
                                 int64_t W, bool vec,
                                 unsigned long long* keys) {
  extern __shared__ __align__(16) uint32_t cov[];
  __shared__ unsigned long long scratch[32];
  const int64_t mach = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  for (int64_t w = threadIdx.x; w < W; w += blockDim.x)
    cov[w] = covered[mach * W + w];
  __syncthreads();
  const unsigned long long best = block_max_key(
      warp_sweep_argmax(rows + mach * n * W, picked + mach * n, cov, W, vec,
                        (int64_t)blockIdx.x * wpb + warp, n,
                        (int64_t)gridDim.x * wpb, lane),
      scratch);
  if (threadIdx.x == 0 && best) atomicMax(keys + mach, best);
}

constexpr int kBatchThreads = 512;

// Queries q0 .. q0 + G - 1 over the shared pool ``rows``: query q's cover
// at covered + q * W, its picked flags at picked + q * n, its key at
// keys[q].
template <int G>
__global__ void __launch_bounds__(kBatchThreads) best_gain_batch_kernel(
    const uint32_t* __restrict__ rows, const uint32_t* __restrict__ covered,
    const uint8_t* __restrict__ picked, int64_t n, int64_t W, int64_t q0,
    bool vec, unsigned long long* keys) {
  extern __shared__ __align__(16) uint32_t cov[];  // G covers of W words
  __shared__ unsigned long long scratch[kMaxGroup][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  for (int64_t i = threadIdx.x; i < (int64_t)G * W; i += blockDim.x)
    cov[i] = covered[q0 * W + i];
  __syncthreads();
  unsigned long long best = 0;  // lane q: query q's best key so far
  for (int64_t r = (int64_t)blockIdx.x * wpb + warp; r < n;
       r += (int64_t)gridDim.x * wpb) {
    int g[G];
    warp_row_gains<G>(rows + r * W, cov, W, vec, lane, g);
    const unsigned long long key =
        lane_key<G>(g, picked + q0 * n, n, r, G, lane);
    best = key > best ? key : best;
  }
  block_post_keys<G>(best, scratch, G, [&](int q, unsigned long long b) {
    if (b) atomicMax(keys + q0 + q, b);
  });
}

__global__ void decode_kernel(const unsigned long long* __restrict__ keys,
                              int64_t m, int32_t* best, int32_t* index) {
  for (int64_t i = threadIdx.x; i < m; i += blockDim.x) {
    best[i] = key_gain(keys[i]);
    index[i] = (int32_t)key_row(keys[i]);
  }
}

static int decode(const void* keys, void* best, void* index, int64_t m,
                  cudaStream_t s) {
  decode_kernel<<<1, kThreads, 0, s>>>((const unsigned long long*)keys, m,
                                  (int32_t*)best, (int32_t*)index);
  return (int)cudaGetLastError();
}

extern "C" int best_gain_index(const void* rows, const void* covered,
                               const void* picked, void* keys, void* best,
                               void* index, int64_t m, int64_t n, int64_t W,
                               void* stream) {
  const int threads = kThreads;
  const size_t smem = (size_t)cover_bytes(W);
  int dev = 0, sms = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)optin) return -2;
  if (m > 65535) return -4;
  cudaError_t err = cudaFuncSetAttribute(
      best_gain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // About eight blocks of 256 threads per SM over all machines.
  int64_t bx = (n + (threads / 32) - 1) / (threads / 32);
  const int64_t cap = (8 * (int64_t)sms + m - 1) / m;
  if (bx > cap) bx = cap;
  if (bx < 1) bx = 1;
  cudaStream_t s = (cudaStream_t)stream;
  best_gain_kernel<<<dim3((unsigned)bx, (unsigned)m), threads, smem, s>>>(
      (const uint32_t*)rows, (const uint32_t*)covered, (const uint8_t*)picked,
      n, W, vec_rows(rows, W), (unsigned long long*)keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return decode(keys, best, index, m, s);
}

// Shared memory a block of the batch kernel may give to query covers:
// the opt-in maximum less the kernel's static scratch.  The caller picks
// G so that G x W x 4 bytes fit (greedy_pick.py: query_groups).
extern "C" int topk_gain_batch_budget() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, best_gain_batch_kernel<kMaxGroup>);
  if (err != cudaSuccess) return -(int)err;
  return optin - (int)attr.sharedSizeBytes;
}

// One group of G queries from q0: as many blocks as fit on the card at
// once, at most one warp per row.
template <int G>
static int launch_group(const void* rows, const void* covered,
                        const void* picked, void* keys, int64_t q0, int64_t n,
                        int64_t W, bool vec, cudaStream_t s) {
  const size_t smem = (size_t)group_cover_bytes(G, W);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = cudaFuncSetAttribute(
      best_gain_batch_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, best_gain_batch_kernel<G>, kBatchThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm == 0) return -2;
  int64_t nb = (int64_t)per_sm * sms;
  const int64_t useful = (n + kBatchThreads / 32 - 1) / (kBatchThreads / 32);
  if (nb > useful) nb = useful;
  best_gain_batch_kernel<G><<<(unsigned)nb, kBatchThreads, smem, s>>>(
      (const uint32_t*)rows, (const uint32_t*)covered, (const uint8_t*)picked,
      n, W, q0, vec, (unsigned long long*)keys);
  return (int)cudaGetLastError();
}

// One pick of each of B queries over one shared pool, in groups of G
// (1 .. kMaxGroup, else -6): -2 when G covers do not fit in shared
// memory.
extern "C" int best_gain_index_batch(const void* rows, const void* covered,
                                     const void* picked, void* keys,
                                     void* best, void* index, int64_t B,
                                     int64_t n, int64_t W, int64_t G,
                                     void* stream) {
  if (G < 1 || G > kMaxGroup) return -6;
  const int budget = topk_gain_batch_budget();
  if (budget < 0) return -budget;
  if (group_cover_bytes(G, W) > budget) return -2;
  const bool vec = vec_rows(rows, W);
  cudaStream_t s = (cudaStream_t)stream;
  for (int64_t q0 = 0; q0 < B; q0 += G) {
    const int64_t gq = B - q0 < G ? B - q0 : G;
    const int err = with_group(gq, [&](auto g) {
      return launch_group<decltype(g)::value>(rows, covered, picked, keys, q0,
                                              n, W, vec, s);
    });
    if (err) return err;
  }
  return decode(keys, best, index, B, s);
}

// The dynamic shared memory of a launch (kernel_table.cuh): the cover of
// W words (topk_gain), or a group's x covers (topk_gain_batch, x = G;
// a ragged last group asks for its own size).
extern "C" int64_t launch_smem(const char* launch, int64_t W, int64_t x) {
  if (same_launch(launch, "topk_gain")) return cover_bytes(W);
  if (same_launch(launch, "topk_gain_batch")) return group_cover_bytes(x, W);
  return -1;
}

static const KernelEntry kKernels[] = {
    {"topk_gain", "best_gain_kernel", (const void*)best_gain_kernel,
     kThreads},
    {"topk_gain", "decode_kernel", (const void*)decode_kernel, kThreads},
    GROUP_ENTRIES("topk_gain_batch", best_gain_batch_kernel, kBatchThreads),
    {"topk_gain_batch", "decode_kernel", (const void*)decode_kernel,
     kThreads},
};
KERNEL_TABLE_EXPORTS(kKernels)
