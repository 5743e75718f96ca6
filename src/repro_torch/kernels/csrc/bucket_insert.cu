// Arrival-order insertion of streamed candidates into B threshold
// buckets (paper Algorithm 5): for each candidate c in order and each
// bucket b,
//   accept = id[c] >= 0 && count[b] < k && float(gain) >= thr[b],
//   gain = sum_w popc(row[c, w] & ~cover[b, w]);
// an accepted candidate ORs its row into the cover and takes seed slot
// count[b].  Replaces repro/kernels/bucket_insert.py:
// bucket_insert_chunk_pallas (one chunk) and bucket_insert_stream_pallas
// (a whole [R, C] stream in one launch), which share _insert_candidates
// as these two kernels share insert_candidates below.
//
// Buckets never interact, so one block owns one bucket, with its cover
// in shared memory for the whole chunk or stream.  The candidates form
// a serial chain inside each bucket: per candidate the block reduces the
// gain, every thread takes the same accept decision from the broadcast
// sum (the float32 comparison of the reference), and the accepting block
// ORs the row in.  The stream kernel reads the [R, C] stream as one
// flat stream of R * C candidates and stages it S = min(C, capacity)
// candidates at a time: stage s+1's rows go into shared memory with
// cp.async (a double buffer) while stage s inserts, so the chain reads
// its rows from shared memory and any C runs.  Bound on the H100: bytes
// (the candidate rows, read once per bucket from L2) and the
// per-candidate block barrier.  A cover larger than the block's shared
// memory is refused (-2); streamed, a cover with no room for a double
// buffer of one candidate next to it (-5).
#include <cstdint>
#include <cuda_runtime.h>

#include "gain_core.cuh"

extern __shared__ __align__(16) uint32_t dyn_smem[];

// Insert C candidates (ids, rows of W words; rows in global or shared
// memory) in order into one bucket; returns its new count.  Every
// thread calls it and gets the same count.
__device__ int insert_candidates(const int32_t* ids, const uint32_t* rows,
                                 int64_t C, int64_t W, int64_t k, float t,
                                 uint32_t* cov, int count, int32_t* seeds_b,
                                 int* partial) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
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
      if (threadIdx.x == 0) seeds_b[count] = sid;
      ++count;
    }
    __syncthreads();
  }
  return count;
}

__global__ void bucket_insert_kernel(
    const int32_t* __restrict__ ids, const uint32_t* __restrict__ rows,
    const float* __restrict__ thr, const uint32_t* __restrict__ covers_in,
    const int32_t* __restrict__ counts_in, const int32_t* __restrict__ seeds_in,
    int64_t C, int64_t W, int64_t k, uint32_t* __restrict__ covers,
    int32_t* __restrict__ counts, int32_t* __restrict__ seeds) {
  uint32_t* cov = dyn_smem;
  __shared__ int partial[32];
  const int64_t b = blockIdx.x;
  for (int64_t w = threadIdx.x; w < W; w += blockDim.x)
    cov[w] = covers_in[b * W + w];
  for (int64_t j = threadIdx.x; j < k; j += blockDim.x)
    seeds[b * k + j] = seeds_in[b * k + j];
  __syncthreads();
  const int count = insert_candidates(ids, rows, C, W, k, thr[b], cov,
                                      counts_in[b], seeds + b * k, partial);
  for (int64_t w = threadIdx.x; w < W; w += blockDim.x)
    covers[b * W + w] = cov[w];
  if (threadIdx.x == 0) counts[b] = count;
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t* dst,
                                           const uint32_t* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// Start copying ``words`` words into shared memory as one cp.async group.
__device__ __forceinline__ void stage(uint32_t* dst, const uint32_t* src,
                                      int64_t words, bool vec) {
  if (vec) {
    for (int64_t i = 4 * (int64_t)threadIdx.x; i < words;
         i += 4 * (int64_t)blockDim.x)
      cp_async16(dst + i, src + i);
  } else {
    for (int64_t i = threadIdx.x; i < words; i += blockDim.x)
      cp_async4(dst + i, src + i);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void bucket_insert_stream_kernel(
    const int32_t* __restrict__ ids, const uint32_t* __restrict__ rows,
    const float* __restrict__ thr, const uint32_t* __restrict__ covers_in,
    const int32_t* __restrict__ counts_in, const int32_t* __restrict__ seeds_in,
    int64_t N, int64_t S, int64_t W, int64_t k, bool vec,
    uint32_t* __restrict__ covers, int32_t* __restrict__ counts,
    int32_t* __restrict__ seeds) {
  const int64_t slot = S * W;
  uint32_t* buf = dyn_smem;             // [2, S, W] double buffer
  uint32_t* cov = dyn_smem + 2 * slot;  // [W] this bucket's cover
  __shared__ int partial[32];
  const int64_t b = blockIdx.x;
  const int64_t stages = (N + S - 1) / S;
  for (int64_t w = threadIdx.x; w < W; w += blockDim.x)
    cov[w] = covers_in[b * W + w];
  for (int64_t j = threadIdx.x; j < k; j += blockDim.x)
    seeds[b * k + j] = seeds_in[b * k + j];
  int count = counts_in[b];
  const float t = thr[b];
  stage(buf, rows, (S < N ? S : N) * W, vec);
  for (int64_t s = 0; s < stages; ++s) {
    if (s + 1 < stages) {
      const int64_t next = N - (s + 1) * S < S ? N - (s + 1) * S : S;
      stage(buf + ((s + 1) & 1) * slot, rows + (s + 1) * slot, next * W, vec);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // stage s has landed (and cov/seeds are written)
    const int64_t here = N - s * S < S ? N - s * S : S;
    count = insert_candidates(ids + s * S, buf + (s & 1) * slot, here, W, k,
                              t, cov, count, seeds + b * k, partial);
    __syncthreads();  // slot s & 1 is free for stage s + 2
  }
  for (int64_t w = threadIdx.x; w < W; w += blockDim.x)
    covers[b * W + w] = cov[w];
  if (threadIdx.x == 0) counts[b] = count;
}

static int optin_smem() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return optin;
}

extern "C" int bucket_insert(const void* ids, const void* rows,
                             const void* thr, const void* covers_in,
                             const void* counts_in, const void* seeds_in,
                             void* covers, void* counts, void* seeds,
                             int64_t B, int64_t C, int64_t W, int64_t k,
                             void* stream) {
  const int threads = 256;
  const size_t smem = (size_t)W * sizeof(uint32_t);
  if (smem > (size_t)optin_smem()) return -2;
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

// The largest chunk C whose double buffer fits the stream kernel's
// shared memory next to one cover of W words (0 when none does).
extern "C" int stream_chunk_capacity(int64_t W) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, bucket_insert_stream_kernel) !=
      cudaSuccess || W <= 0)
    return 0;
  const int64_t avail =
      (int64_t)optin_smem() - (int64_t)attr.sharedSizeBytes - 4 * W;
  return avail > 0 ? (int)(avail / (8 * W)) : 0;
}

extern "C" int bucket_insert_stream(const void* ids, const void* rows,
                                    const void* thr, const void* covers_in,
                                    const void* counts_in,
                                    const void* seeds_in, void* covers,
                                    void* counts, void* seeds, int64_t B,
                                    int64_t R, int64_t C, int64_t W, int64_t k,
                                    void* stream) {
  const int threads = 256;
  const int64_t cap = stream_chunk_capacity(W);
  if (cap < 1) return -5;
  const int64_t S = C < cap ? C : cap;
  const size_t smem = (size_t)(2 * S + 1) * W * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      bucket_insert_stream_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  bucket_insert_stream_kernel<<<(unsigned)B, threads, smem,
                                (cudaStream_t)stream>>>(
      (const int32_t*)ids, (const uint32_t*)rows, (const float*)thr,
      (const uint32_t*)covers_in, (const int32_t*)counts_in,
      (const int32_t*)seeds_in, R * C, S, W, k, vec_rows(rows, W),
      (uint32_t*)covers, (int32_t*)counts, (int32_t*)seeds);
  return (int)cudaGetLastError();
}
