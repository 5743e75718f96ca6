// Marginal gains of every row of m machines against each machine's
// cover:  gains[m, v] = sum_w popc(rows[m, v, w] & ~covered[m, w]).
// Replaces repro/kernels/coverage.py: marginal_gain_pallas (the gain
// sweep of the Ripples round under use_kernel), with the machine axis
// added.
//
// One warp per row, lanes along the words (16-byte loads when aligned),
// the machine's cover in shared memory, one int32 written per row.
// Bound on the H100: bytes (the rows, read once).
#include <cstdint>
#include <cuda_runtime.h>

#include "gain_core.cuh"
#include "kernel_table.cuh"

__global__ void coverage_kernel(const uint32_t* __restrict__ rows,
                                const uint32_t* __restrict__ covered,
                                int64_t n, int64_t W, bool vec,
                                int32_t* __restrict__ gains) {
  extern __shared__ __align__(16) uint32_t cov[];
  const int64_t mach = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  for (int64_t w = threadIdx.x; w < W; w += blockDim.x)
    cov[w] = covered[mach * W + w];
  __syncthreads();
  const uint32_t* R = rows + mach * n * W;
  for (int64_t r = (int64_t)blockIdx.x * wpb + warp; r < n;
       r += (int64_t)gridDim.x * wpb) {
    const int g = warp_row_gain(R + r * W, cov, W, vec, lane);
    if (lane == 0) gains[mach * n + r] = g;
  }
}

constexpr int kThreads = 256;

// A block's dynamic shared memory: the machine's cover of W words.
static int64_t cover_bytes(int64_t W) { return W * (int64_t)sizeof(uint32_t); }

// The dynamic shared memory of a launch (kernel_table.cuh).
extern "C" int64_t launch_smem(const char* launch, int64_t W, int64_t) {
  return same_launch(launch, "coverage") ? cover_bytes(W) : -1;
}

extern "C" int coverage(const void* rows, const void* covered, void* gains,
                        int64_t m, int64_t n, int64_t W, void* stream) {
  const int threads = kThreads;
  const size_t smem = (size_t)cover_bytes(W);
  int dev = 0, sms = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)optin) return -2;
  if (m > 65535) return -4;
  cudaError_t err = cudaFuncSetAttribute(
      coverage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // About eight blocks of 256 threads per SM over all machines.
  int64_t bx = (n + (threads / 32) - 1) / (threads / 32);
  const int64_t cap = (8 * (int64_t)sms + m - 1) / m;
  if (bx > cap) bx = cap;
  if (bx < 1) bx = 1;
  coverage_kernel<<<dim3((unsigned)bx, (unsigned)m), threads, smem,
                    (cudaStream_t)stream>>>(
      (const uint32_t*)rows, (const uint32_t*)covered, n, W,
      vec_rows(rows, W), (int32_t*)gains);
  return (int)cudaGetLastError();
}

static const KernelEntry kKernels[] = {
    {"coverage", "coverage_kernel", (const void*)coverage_kernel, kThreads},
};
KERNEL_TABLE_EXPORTS(kKernels)
