// Gains of one candidate row against B bucket covers:
//   gains[b] = sum_w popc(row[w] & ~covers[b, w])
// Replaces repro/kernels/bucket.py: bucket_gains_pallas (the legacy
// receiver's per-candidate gain pass, reached only through the public op
// repro/kernels/ops.py:33).  The TPU kernel tiles the word axis over a
// sequential grid and accumulates in its output block; here one block
// owns one bucket, its threads stride the words (16-byte loads when the
// row, the covers and W allow), and a warp-shuffle plus block reduction
// writes the bucket's one int32.  Any B >= 1 and W >= 1; nothing is
// padded.  Bound on the H100: bytes (the covers and the row read once,
// the gains written once; at B = 63, W = 4096 about 1 MB, so a launch
// costs more than the bytes).
#include <cstdint>
#include <cuda_runtime.h>

#include "gain_core.cuh"

__global__ void bucket_gains_kernel(const uint32_t* __restrict__ row,
                                    const uint32_t* __restrict__ covers,
                                    int64_t W, bool vec,
                                    int32_t* __restrict__ gains) {
  __shared__ int partial[32];
  const uint32_t* C = covers + (int64_t)blockIdx.x * W;
  int g = 0;
  if (vec) {
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
    const uint4* c4 = reinterpret_cast<const uint4*>(C);
    for (int64_t i = threadIdx.x; i < (W >> 2); i += blockDim.x) {
      const uint4 a = __ldg(r4 + i), c = c4[i];
      g += andnot_popc(a.x, c.x) + andnot_popc(a.y, c.y) +
           andnot_popc(a.z, c.z) + andnot_popc(a.w, c.w);
    }
  } else {
    for (int64_t w = threadIdx.x; w < W; w += blockDim.x)
      g += andnot_popc(__ldg(row + w), C[w]);
  }
  g = warp_sum(g);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = g;
  __syncthreads();
  if (warp == 0) {
    g = warp_sum(lane < (int)(blockDim.x >> 5) ? partial[lane] : 0);
    if (lane == 0) gains[blockIdx.x] = g;
  }
}

extern "C" int bucket_gains(const void* row, const void* covers, void* gains,
                            int64_t B, int64_t W, void* stream) {
  if (B > 0x7FFFFFFF) return -4;
  const bool vec = vec_rows(covers, W) && vec_rows(row, W);
  // One thread per 16-byte (or 4-byte) load, whole warps, at most 256.
  const int64_t loads = vec ? W >> 2 : W;
  int64_t threads = (loads + 31) / 32 * 32;
  if (threads > 256) threads = 256;
  if (threads < 32) threads = 32;
  bucket_gains_kernel<<<(unsigned)B, (unsigned)threads, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)row, (const uint32_t*)covers, W, vec,
      (int32_t*)gains);
  return (int)cudaGetLastError();
}
