// Arrival-order insertion of C streamed candidates into B threshold
// buckets (paper Algorithm 5): for each candidate c in order and each
// bucket b,
//   accept = id[c] >= 0 && count[b] < k && float(gain) >= thr[b],
//   gain = sum_w popc(row[c, w] & ~cover[b, w]);
// an accepted candidate ORs its row into the cover and takes seed slot
// count[b].  Replaces repro/kernels/bucket_insert.py:
// bucket_insert_chunk_pallas (_insert_candidates).
//
// Buckets never interact, so one block owns one bucket, with its cover
// in shared memory for the whole chunk.  The candidates form a serial
// chain inside each bucket: per candidate the block reduces the gain,
// every thread takes the same accept decision from the broadcast sum
// (the float32 comparison of the reference), and the accepting block
// ORs the row in.  Bound on the H100: bytes (the candidate rows, read
// once per bucket from L2) and the per-candidate block barrier.  A
// cover larger than the block's shared memory is refused (-2).
#include <cstdint>
#include <cuda_runtime.h>

#include "gain_core.cuh"

__global__ void bucket_insert_kernel(
    const int32_t* __restrict__ ids, const uint32_t* __restrict__ rows,
    const float* __restrict__ thr, const uint32_t* __restrict__ covers_in,
    const int32_t* __restrict__ counts_in, const int32_t* __restrict__ seeds_in,
    int64_t C, int64_t W, int64_t k, uint32_t* __restrict__ covers,
    int32_t* __restrict__ counts, int32_t* __restrict__ seeds) {
  extern __shared__ uint32_t cov[];
  __shared__ int partial[32];
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int64_t w = threadIdx.x; w < W; w += blockDim.x)
    cov[w] = covers_in[b * W + w];
  for (int64_t j = threadIdx.x; j < k; j += blockDim.x)
    seeds[b * k + j] = seeds_in[b * k + j];
  int count = counts_in[b];
  const float t = thr[b];
  __syncthreads();

  for (int64_t c = 0; c < C; ++c) {
    const int32_t sid = ids[c];
    if (sid < 0 || count >= k) continue;  // uniform across the block
    const uint32_t* row = rows + c * W;
    int g = 0;
    for (int64_t w = threadIdx.x; w < W; w += blockDim.x)
      g += andnot_popc(row[w], cov[w]);
    g = warp_sum(g);
    if (lane == 0) partial[warp] = g;
    __syncthreads();
    int gain = 0;
    for (int i = 0; i < nwarps; ++i) gain += partial[i];
    if ((float)gain >= t) {
      for (int64_t w = threadIdx.x; w < W; w += blockDim.x) cov[w] |= row[w];
      if (threadIdx.x == 0) seeds[b * k + count] = sid;
      ++count;
    }
    __syncthreads();
  }
  for (int64_t w = threadIdx.x; w < W; w += blockDim.x)
    covers[b * W + w] = cov[w];
  if (threadIdx.x == 0) counts[b] = count;
}

extern "C" int bucket_insert(const void* ids, const void* rows,
                             const void* thr, const void* covers_in,
                             const void* counts_in, const void* seeds_in,
                             void* covers, void* counts, void* seeds,
                             int64_t B, int64_t C, int64_t W, int64_t k,
                             void* stream) {
  const int threads = 256;
  const size_t smem = (size_t)W * sizeof(uint32_t);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)optin) return -2;
  cudaError_t err = cudaFuncSetAttribute(
      bucket_insert_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  bucket_insert_kernel<<<(unsigned)B, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)ids, (const uint32_t*)rows, (const float*)thr,
      (const uint32_t*)covers_in, (const int32_t*)counts_in,
      (const int32_t*)seeds_in, C, W, k, (uint32_t*)covers, (int32_t*)counts,
      (int32_t*)seeds);
  return (int)cudaGetLastError();
}
