// One greedy pick of m independent machines: the masked marginal-gain
// sweep fused with the argmax.  Replaces repro/kernels/topk_gain.py:
// best_gain_index_pallas (the solver="fused" per-pick engine), with the
// machine axis added; the same launch serves the query axis of
// repro/core/maxcover.py:141 (vmapped, rows shared).  Solve s reads its
// rows at rows + s * rstride: n * W for machines, 0 for queries over
// one shared [n, W] pool.
//
//   gain[m, v] = picked[m, v] ? -1 : sum_w popc(rows[m, v, w] & ~cov[m, w])
//   best[m], index[m] = max and lowest argmax of gain[m, :]
//
// One warp per row, the machine's cover in shared memory; each block
// folds its best key ((gain + 1) << 32 | ~row, greedy_core.cuh) into the
// machine's key with a 64-bit atomicMax, so the gain vector never
// reaches device memory and ties go to the lowest row as in jnp.argmax.
// A second one-block launch decodes the keys.  Rows beyond n are never
// swept (the reference pads them as picked).  Bound on the H100: bytes
// (the rows, read once per pick).
#include <cstdint>
#include <cuda_runtime.h>

#include "greedy_core.cuh"

__global__ void best_gain_kernel(const uint32_t* __restrict__ rows,
                                 const uint32_t* __restrict__ covered,
                                 const uint8_t* __restrict__ picked, int64_t n,
                                 int64_t W, int64_t rstride, bool vec,
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
      warp_sweep_argmax(rows + mach * rstride, picked + mach * n, cov, W, vec,
                        (int64_t)blockIdx.x * wpb + warp, n,
                        (int64_t)gridDim.x * wpb, lane),
      scratch);
  if (threadIdx.x == 0 && best) atomicMax(keys + mach, best);
}

__global__ void decode_kernel(const unsigned long long* __restrict__ keys,
                              int64_t m, int32_t* best, int32_t* index) {
  for (int64_t i = threadIdx.x; i < m; i += blockDim.x) {
    best[i] = key_gain(keys[i]);
    index[i] = (int32_t)key_row(keys[i]);
  }
}

extern "C" int best_gain_index(const void* rows, const void* covered,
                               const void* picked, void* keys, void* best,
                               void* index, int64_t m, int64_t n, int64_t W,
                               int64_t rstride, void* stream) {
  const int threads = 256;
  const size_t smem = (size_t)W * sizeof(uint32_t);
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
      n, W, rstride, vec_rows(rows, W), (unsigned long long*)keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_kernel<<<1, 256, 0, s>>>((const unsigned long long*)keys, m,
                                  (int32_t*)best, (int32_t*)index);
  return (int)cudaGetLastError();
}
