// Gains of one candidate row against B bucket covers:
//   gains[b] = sum_w popc(row[w] & ~covers[b, w])
// Replaces repro/kernels/bucket.py: bucket_gains_pallas (the legacy
// receiver's per-candidate gain pass, reached only through the public op
// repro/kernels/ops.py:33).  The TPU kernel tiles the word axis over a
// sequential grid and accumulates in its output block.  Here a bucket's
// words are split over a cluster of S blocks (S <= 8, the portable
// cluster size): block s of bucket b folds slice s of the words (16-byte
// loads when the row, the covers and W allow; the row through the
// read-only path), and each warp stores its sum into the shared memory
// of the cluster's first block (distributed shared memory).  After a
// cluster barrier that block adds the S blocks' sums in a fixed order and
// stores the bucket's one int32; the others may leave at the barrier, as
// nothing reads their shared memory.  A split barrier (arrive before the
// loads, wait after them) makes sure the first block runs before anyone
// stores into it.  No atomics, no zeroing pass.  With S = 1 the launch
// is a plain one (a block is then its own cluster of one).
//
// S is the least power of two with B x S blocks at least twice the SMs,
// halved while a block's slice would hold fewer than kMinSliceUnits
// loads (S = 1 where W is too narrow to split); GAINS_CLUSTER (0 by
// default: the rule) fixes S at build time for tools/time_gains.py
// --layouts.  Any B >= 1 and W >= 1; nothing is padded.  Bound on the
// H100: bytes (the covers and the row read once, the gains written once;
// at B = 63, W = 4096 about 1 MB, so a lone launch costs more than its
// bytes).
#include <cooperative_groups.h>

#include <cstdint>
#include <cuda_runtime.h>

#include "gain_core.cuh"
#include "kernel_table.cuh"

namespace cg = cooperative_groups;

#ifndef GAINS_CLUSTER
#define GAINS_CLUSTER 0
#endif
static_assert(GAINS_CLUSTER == 0 || GAINS_CLUSTER == 1 ||
                  GAINS_CLUSTER == 2 || GAINS_CLUSTER == 4 ||
                  GAINS_CLUSTER == 8,
              "GAINS_CLUSTER is 0 (the rule) or a cluster size 1 .. 8");

constexpr int kMaxThreads = 256;
constexpr int kMaxCluster = 8;
// A block's slice holds at least this many loads (16 or 4 bytes each),
// so that splitting a bucket pays for the cluster's barriers.
constexpr int64_t kMinSliceUnits = 128;

template <bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
    bucket_gains_kernel(const uint32_t* __restrict__ row,
                        const uint32_t* __restrict__ covers, int64_t W,
                        int32_t* __restrict__ gains) {
  // the cluster's warp sums, by block then warp (the first block's holds
  // them all; the others' go unused)
  __shared__ int partial[kMaxCluster * (kMaxThreads / 32)];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int s = (int)cluster.block_rank();
  const int64_t b = blockIdx.x / S;
  const uint32_t* C = covers + b * W;
  const int64_t units = kVec ? W >> 2 : W;
  const int64_t per = (units + S - 1) / S;
  const int64_t lo = s * per;
  const int64_t hi = lo + per < units ? lo + per : units;
  // every block of the cluster has started once this barrier completes
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  int g = 0;
  if (kVec) {
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
    const uint4* c4 = reinterpret_cast<const uint4*>(C);
#pragma unroll 4
    for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      const uint4 a = __ldg(r4 + i), c = c4[i];
      g += andnot_popc(a.x, c.x) + andnot_popc(a.y, c.y) +
           andnot_popc(a.z, c.z) + andnot_popc(a.w, c.w);
    }
  } else {
#pragma unroll 4
    for (int64_t w = lo + threadIdx.x; w < hi; w += blockDim.x)
      g += andnot_popc(__ldg(row + w), C[w]);
  }
  g = warp_sum(g);
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (lane == 0)
    cluster.map_shared_rank(partial, 0)[s * warps + (threadIdx.x >> 5)] = g;
  cluster.sync();  // every warp's sum is in the first block
  if (s == 0 && threadIdx.x < 32) {
    int v = 0;
    for (int i = lane; i < S * warps; i += 32) v += partial[i];
    v = warp_sum(v);
    if (lane == 0) gains[b] = v;
  }
}

// The blocks a bucket (the cluster size S) for B buckets of W words on a
// card of ``sms`` SMs: the least power of two with B x S >= 2 x sms, at
// most 8, halved while a slice would hold fewer than kMinSliceUnits loads.
static int cluster_size(int64_t B, int64_t W, bool vec, int sms) {
  if (GAINS_CLUSTER) return GAINS_CLUSTER;
  const int64_t units = vec ? W >> 2 : W;
  int S = 1;
  while (S < kMaxCluster && B * S < 2 * (int64_t)sms) S <<= 1;
  while (S > 1 && units < S * kMinSliceUnits) S >>= 1;
  return S;
}

static int card_sms() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// The launch's cluster size on the current device (kernels/bucket.py:
// cluster_size is its model).
extern "C" int bucket_gains_cluster(int64_t B, int64_t W, int64_t vec) {
  return cluster_size(B, W, vec != 0, card_sms());
}

extern "C" int bucket_gains(const void* row, const void* covers, void* gains,
                            int64_t B, int64_t W, void* stream) {
  if (B > 0x7FFFFFFF / kMaxCluster) return -4;
  const bool vec = vec_rows(covers, W) && vec_rows(row, W);
  const int S = cluster_size(B, W, vec, card_sms());
  // One thread per load of a slice, whole warps, at most kMaxThreads.
  const int64_t units = vec ? W >> 2 : W;
  int64_t threads = ((units + S - 1) / S + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < 32) threads = 32;
  auto kernel = vec ? bucket_gains_kernel<true> : bucket_gains_kernel<false>;
  cudaStream_t st = (cudaStream_t)stream;
  if (S == 1) {  // a block its own cluster: no cluster launch to pay for
    kernel<<<(unsigned)B, (unsigned)threads, 0, st>>>(
        (const uint32_t*)row, (const uint32_t*)covers, W, (int32_t*)gains);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * S));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, (const uint32_t*)row,
                         (const uint32_t*)covers, W, (int32_t*)gains);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The dynamic shared memory of a launch (kernel_table.cuh): none.
extern "C" int64_t launch_smem(const char* launch, int64_t, int64_t) {
  return same_launch(launch, "bucket_gains") ? 0 : -1;
}

static const KernelEntry kKernels[] = {
    {"bucket_gains", "bucket_gains_kernel<true>",
     (const void*)bucket_gains_kernel<true>, kMaxThreads},
    {"bucket_gains", "bucket_gains_kernel<false>",
     (const void*)bucket_gains_kernel<false>, kMaxThreads},
};
KERNEL_TABLE_EXPORTS(kKernels)
