// Arrival-order insertion of streamed candidates into B threshold
// buckets (paper Algorithm 5): for each candidate c in order and each
// bucket b,
//   accept = id[c] >= 0 && count[b] < k && float(gain) >= thr[b],
//   gain = sum_w popc(row[c, w] & ~cover[b, w]);
// an accepted candidate ORs its row into the cover and takes seed slot
// count[b].  Replaces repro/kernels/bucket_insert.py:
// bucket_insert_chunk_pallas (one chunk) and bucket_insert_stream_pallas
// (a whole [R, C] stream in one launch), which share _insert_candidates
// as both launches here share settle_kernel below: a chunk is a stream
// of C candidates, the stream one of R * C.
//
// Buckets never interact, so a bucket belongs to one block, or to a
// cluster of CS blocks that split its words, its cover in shared memory.
// Each thread owns the same words of the cover and of every row for the
// whole launch, so the cover needs no barrier; the one barrier of a pass
// is the gain reduction's (a cluster barrier, the partial sums read
// across the cluster's shared memory, when CS > 1).  The candidates
// settle G at a time (a group).  A cover only grows, so a candidate's
// gain only falls.  A pass computes, for each undecided valid candidate
// j of the group, U_j against the cover (an upper bound) and L_j against
// the cover ORed with the rows of every earlier undecided valid
// candidate of the group (a lower bound, whichever of them are
// accepted).  The int-to-float cast is monotone, so in arrival order j
// is skipped once the bucket is full, rejected if float(U_j) < t and
// accepted if float(L_j) >= t.  Otherwise j is ambiguous: the rows
// accepted so far go into the cover and the next pass starts at j, whose
// bounds are then its exact gain.  So a pass settles at least one
// candidate, and a bucket takes at most ceil(C / G) + (its ambiguous
// candidates) passes, where the sequential chain took one barrier pair
// per candidate.  A full bucket stops: the block leaves the loop and
// reads no more rows.  A pass issues all of its G row loads (L2, 16
// bytes a thread where rows are aligned) before it counts.  Staging the
// next groups' rows into shared memory, by cp.async or by the TMA
// engine's bulk copies, was measured slower at every shape of the
// full-size runs, and so was skipping the counts of rows with no new
// bit in a warp; neither is done.  Bound on the H100: the rows each
// block reads from L2 and the popcounts (16 a clock a SM), per pass;
// the passes (latency).  A cover larger than the block's shared memory
// is refused (-2); streamed, a cover with no room for a double buffer
// of one candidate next to it (-5), the stream's chunk rule.
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "gain_core.cuh"
#include "kernel_table.cuh"

namespace cg = cooperative_groups;

extern __shared__ __align__(16) uint32_t dyn_smem[];

// The layout, fixed at compile time and measured at the full-size runs'
// shapes (tools/time_receiver.py --layouts builds the others with -D):
// groups of RECV_GROUP candidates (a power of two up to 32), and
// RECV_CLUSTER blocks a bucket, 0 taking the rule of settle() below.
#ifndef RECV_GROUP
#define RECV_GROUP 32
#endif
#ifndef RECV_CLUSTER
#define RECV_CLUSTER 0
#endif
static_assert(RECV_GROUP >= 1 && RECV_GROUP <= 32 &&
                  (RECV_GROUP & (RECV_GROUP - 1)) == 0,
              "RECV_GROUP is a power of two up to 32");
static_assert(RECV_CLUSTER >= 0 && RECV_CLUSTER <= 2,
              "RECV_CLUSTER is 0, 1 or 2");

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
// Static shared memory of the group's partial sums.
constexpr int64_t PART_BYTES = sizeof(int) * 2 * WARPS * 2 * RECV_GROUP;
// The per-bucket figures a launch writes when given a stats buffer.
enum { ST_PASSES, ST_AMBIGUOUS, ST_FILLED_AT, ST_ROWS_READ, ST_GROUP,
       ST_CLUSTER, ST_FIELDS };

// A unit is the words one thread handles at once: four (16-byte loads,
// rows and covers 16-byte aligned, W a multiple of 4) or one.
__device__ __forceinline__ int gain_of(uint32_t x, uint32_t cover) {
  return andnot_popc(x, cover);
}
__device__ __forceinline__ int gain_of(uint4 x, uint4 c) {
  return andnot_popc(x.x, c.x) + andnot_popc(x.y, c.y) +
         andnot_popc(x.z, c.z) + andnot_popc(x.w, c.w);
}
__device__ __forceinline__ uint32_t unit_or(uint32_t a, uint32_t b) {
  return a | b;
}
__device__ __forceinline__ uint4 unit_or(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}

// G sums at once over the warp (G a power of two up to 32): lane l ends
// with the warp's sum of v[l % G], after G - 1 + log2(32 / G) shuffles.
// Each step halves the values a lane holds and doubles the lanes each
// value is summed over; the steps are a template recursion, so every
// index is a constant and v stays in registers.  v is clobbered.
template <int OFF, int G>
__device__ __forceinline__ void fold_halves(int (&v)[G], int lane) {
  if constexpr (OFF >= 1) {
    const bool upper = lane & OFF;
#pragma unroll
    for (int i = 0; i < OFF; ++i) {
      const int send = upper ? v[i] : v[i + OFF];
      const int keep = upper ? v[i + OFF] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, OFF);
    }
    fold_halves<OFF / 2>(v, lane);
  }
}

template <int G>
__device__ __forceinline__ int warp_sum_each(int (&v)[G], int lane) {
  fold_halves<G / 2>(v, lane);
  int s = v[0];
#pragma unroll
  for (int off = G; off < 32; off <<= 1) s += __shfl_xor_sync(FULL, s, off);
  return s;
}

template <int G, int CS, typename Unit>
__global__ void __launch_bounds__(THREADS) settle_kernel(
    const int32_t* __restrict__ ids, const uint32_t* __restrict__ rows,
    const float* __restrict__ thr, const uint32_t* __restrict__ covers_in,
    const int32_t* __restrict__ counts_in, const int32_t* __restrict__ seeds_in,
    int64_t N, int64_t W, int64_t k, uint32_t* __restrict__ covers,
    int32_t* __restrict__ counts, int32_t* __restrict__ seeds,
    int32_t* __restrict__ stats) {
  constexpr int PER = sizeof(Unit) / sizeof(uint32_t);
  __shared__ int part[2][WARPS][2 * G];  // by pass parity: one barrier a pass
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rank = CS > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int64_t b = blockIdx.x / CS, units = W / PER;
  // this block's share of the words: units [lo_u, lo_u + mine)
  const int64_t share = (units + CS - 1) / CS, lo_u = rank * share;
  const int64_t mine = units - lo_u < share ? units - lo_u : share;
  Unit* cov = reinterpret_cast<Unit*>(dyn_smem);
  const Unit* src = reinterpret_cast<const Unit*>(rows) + lo_u;
  const Unit* cin = reinterpret_cast<const Unit*>(covers_in + b * W) + lo_u;
  for (int64_t u = threadIdx.x; u < mine; u += THREADS) cov[u] = cin[u];
  int32_t* seeds_b = seeds + b * k;
  if (rank == 0)
    for (int64_t j = threadIdx.x; j < k; j += THREADS)
      seeds_b[j] = seeds_in[b * k + j];
  __syncthreads();  // the copied slots land before warp 0 writes any
  const float t = thr[b];
  int count = counts_in[b];
  int passes = 0, ambiguous = 0, rows_read = 0;  // this block's figures
  int64_t filled_at = -1;
  const int64_t groups = (N + G - 1) / G;
  const bool one_unit = mine <= THREADS;  // a thread's rows stay in registers

  // lane l of every warp holds the id of candidate g * G + l (-1 past N)
  auto group_id = [&](int64_t g) -> int32_t {
    const int64_t n = g * G + lane;
    return lane < G && n < N ? __ldg(ids + n) : -1;
  };
  // the ids of groups g .. g + 3, read three groups ahead of their use
  int32_t id0 = group_id(0), id1 = group_id(1), id2 = group_id(2),
          id3 = group_id(3);
  for (int64_t g = 0; g < groups && count < k; ++g) {
    const int32_t id = id0;
    const int64_t g0 = g * G;
    const Unit* grp = src + g0 * units;  // the group's rows
    unsigned live = __ballot_sync(FULL, id >= 0);  // its undecided candidates
    while (live) {
      int up[G], lo[G];
      Unit x[G];
#pragma unroll
      for (int i = 0; i < G; ++i) up[i] = lo[i] = 0;
      for (int64_t u0 = 0; u0 < mine; u0 += THREADS) {
        const int64_t u = u0 + threadIdx.x;
        const bool in = u < mine;
#pragma unroll
        for (int i = 0; i < G; ++i)  // every load issued before the first use
          x[i] = in && (live >> i & 1) ? __ldg(grp + i * units + u) : Unit{};
        const Unit c = in ? cov[u] : Unit{};
        Unit run = c;
#pragma unroll
        for (int i = 0; i < G; ++i) {
          up[i] += gain_of(x[i], c);
          lo[i] += gain_of(x[i], run);
          run = unit_or(run, x[i]);
        }
      }
      const int us = warp_sum_each<G>(up, lane);
      const int ls = warp_sum_each<G>(lo, lane);
      int(*p)[2 * G] = part[passes & 1];
      if (lane < G) {
        p[warp][lane] = us;
        p[warp][G + lane] = ls;
      }
      int upper = 0, lower = 0;
      if constexpr (CS > 1) {
        cg::cluster_group cluster = cg::this_cluster();
        cluster.sync();  // every block's partial sums are written
        if (lane < G)
          for (int r = 0; r < CS; ++r) {
            int(*q)[2 * G] = cluster.map_shared_rank(p, r);
            for (int w = 0; w < WARPS; ++w) {
              upper += q[w][lane];
              lower += q[w][G + lane];
            }
          }
      } else {
        __syncthreads();
        if (lane < G)
          for (int w = 0; w < WARPS; ++w) {
            upper += p[w][lane];
            lower += p[w][G + lane];
          }
      }
      ++passes;
      rows_read += __popc(live);
      // The walk in arrival order, as bit masks (every warp of the
      // cluster takes the same decisions): the first live candidate's
      // bounds are its exact gain, so it is accepted or rejected; the
      // first other candidate that neither bound decides is ambiguous,
      // and the candidates before it are settled.  Of those accepted,
      // the first k - count enter.
      const unsigned accept =
          live & __ballot_sync(FULL, lane < G && (float)lower >= t);
      const unsigned reject =
          live & ~accept &
          (__ballot_sync(FULL, lane < G && (float)upper < t) |
           (live & (0u - live)));
      const unsigned unsure = live & ~accept & ~reject;
      const unsigned before = unsure ? (unsure & (0u - unsure)) - 1 : FULL;
      unsigned take = accept & before;
      const int room = (int)(k - count);
      const bool fills = __popc(take) >= room;
      if (fills) {  // keep the first ``room`` accepted candidates
        unsigned last = take;
        for (int j = 1; j < room; ++j) last &= last - 1;
        const int at = __ffs(last) - 1;
        take &= at == 31 ? FULL : (2u << at) - 1;
        filled_at = g0 + at;
      }
      if (rank == 0 && warp == 0 && (take >> lane & 1))
        seeds_b[count + __popc(take & ((1u << lane) - 1))] = id;
      count += __popc(take);
      live = !fills && unsure ? live & ~before : 0;  // settle from there
      ambiguous += live != 0;
      if (take) {  // fold the accepted rows into this thread's words
        if (one_unit) {
          if (threadIdx.x < mine) {
            Unit c = cov[threadIdx.x];
#pragma unroll
            for (int i = 0; i < G; ++i)
              if (take >> i & 1) c = unit_or(c, x[i]);
            cov[threadIdx.x] = c;
          }
        } else {
          for (int64_t u = threadIdx.x; u < mine; u += THREADS) {
            Unit c = cov[u];
#pragma unroll
            for (int i = 0; i < G; ++i)
              if (take >> i & 1) c = unit_or(c, __ldg(grp + i * units + u));
            cov[u] = c;
          }
        }
      }
    }
    id0 = id1;
    id1 = id2;
    id2 = id3;
    id3 = group_id(g + 4);
  }
  Unit* cout_ = reinterpret_cast<Unit*>(covers + b * W) + lo_u;
  for (int64_t u = threadIdx.x; u < mine; u += THREADS) cout_[u] = cov[u];
  if (rank == 0 && threadIdx.x == 0) {
    counts[b] = count;
    if (stats) {
      int32_t* s = stats + b * ST_FIELDS;
      s[ST_PASSES] = passes;
      s[ST_AMBIGUOUS] = ambiguous;
      s[ST_FILLED_AT] = (int32_t)filled_at;
      s[ST_ROWS_READ] = rows_read;
      s[ST_GROUP] = G;
      s[ST_CLUSTER] = CS;
    }
  }
  if constexpr (CS > 1)  // the others' last reads of this block's sums
    cg::this_cluster().sync();
}

static int optin_smem() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return optin;
}

struct Launch {
  const void *ids, *rows, *thr, *covers_in, *counts_in, *seeds_in;
  void *covers, *counts, *seeds, *stats;
  int64_t B, N, W, k;
};

// One block a bucket, or a cluster of two blocks splitting its words
// once one block's threads would hold more than one unit of a row each
// (W > 1,024 words with 16-byte units: the round's W = 4,096); below
// that the cluster barrier costs more than the half of the words saves.
static int recv_cluster(int64_t W, bool vec) {
  return RECV_CLUSTER ? RECV_CLUSTER : W / (vec ? 4 : 1) > THREADS ? 2 : 1;
}

// A block's dynamic shared memory: its share of the bucket's cover, in
// units of 16 bytes (``vec``: rows and covers 16-byte aligned, W a
// multiple of 4) or 4.
static int64_t cover_share_bytes(int64_t W, bool vec) {
  const int64_t unit = vec ? 16 : 4, cs = recv_cluster(W, vec);
  return (W / (unit / 4) + cs - 1) / cs * unit;
}

template <int G, int CS, typename Unit>
static int launch_as(const Launch& a, cudaStream_t st) {
  auto kern = settle_kernel<G, CS, Unit>;
  const size_t smem = (size_t)cover_share_bytes(a.W, sizeof(Unit) == 16);
  if ((int64_t)smem + PART_BYTES > optin_smem()) return -2;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.B * CS));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kern, (const int32_t*)a.ids, (const uint32_t*)a.rows,
      (const float*)a.thr, (const uint32_t*)a.covers_in,
      (const int32_t*)a.counts_in, (const int32_t*)a.seeds_in, a.N, a.W, a.k,
      (uint32_t*)a.covers, (int32_t*)a.counts, (int32_t*)a.seeds,
      (int32_t*)a.stats);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

static int settle(const Launch& a, cudaStream_t st) {
  const bool vec = vec_rows(a.rows, a.W) && vec_rows(a.covers_in, a.W) &&
                   vec_rows(a.covers, a.W);
  if (recv_cluster(a.W, vec) == 2)
    return vec ? launch_as<RECV_GROUP, 2, uint4>(a, st)
               : launch_as<RECV_GROUP, 2, uint32_t>(a, st);
  return vec ? launch_as<RECV_GROUP, 1, uint4>(a, st)
             : launch_as<RECV_GROUP, 1, uint32_t>(a, st);
}

extern "C" int bucket_insert(const void* ids, const void* rows,
                             const void* thr, const void* covers_in,
                             const void* counts_in, const void* seeds_in,
                             void* covers, void* counts, void* seeds,
                             void* stats, int64_t B, int64_t C, int64_t W,
                             int64_t k, void* stream) {
  const Launch a{ids,    rows,  thr,   covers_in, counts_in, seeds_in,
                 covers, counts, seeds, stats,     B,         C,
                 W,      k};
  return settle(a, (cudaStream_t)stream);
}

// The largest chunk C whose double buffer ([2, C, W] words) fits a
// block's shared memory next to one cover of W words (0 when none
// does): the pipelined receiver's chunk (results never depend on it).
extern "C" int stream_chunk_capacity(int64_t W) {
  if (W <= 0) return 0;
  const int64_t avail =
      (int64_t)optin_smem() - PART_BYTES - 4 * ((W + 3) & ~int64_t(3));
  return avail > 0 ? (int)(avail / (8 * W)) : 0;
}

extern "C" int bucket_insert_stream(const void* ids, const void* rows,
                                    const void* thr, const void* covers_in,
                                    const void* counts_in,
                                    const void* seeds_in, void* covers,
                                    void* counts, void* seeds, void* stats,
                                    int64_t B, int64_t R, int64_t C, int64_t W,
                                    int64_t k, void* stream) {
  if (stream_chunk_capacity(W) < 1) return -5;
  const Launch a{ids,    rows,  thr,   covers_in, counts_in, seeds_in,
                 covers, counts, seeds, stats,     B,         R * C,
                 W,      k};
  return settle(a, (cudaStream_t)stream);
}

// The dynamic shared memory of a launch (kernel_table.cuh): a block's
// share of the cover, x = 1 for 16-byte units, 0 for 4-byte ones.
extern "C" int64_t launch_smem(const char* launch, int64_t W, int64_t x) {
  if (same_launch(launch, "bucket_insert") ||
      same_launch(launch, "bucket_insert_stream"))
    return cover_share_bytes(W, x != 0);
  return -1;
}

// Both launch names run the same four instantiations.
#define SETTLE_ENTRIES(LAUNCH)                                              \
  {LAUNCH, "settle_kernel<G, 1, uint4>",                                    \
   (const void*)settle_kernel<RECV_GROUP, 1, uint4>, THREADS},              \
      {LAUNCH, "settle_kernel<G, 1, uint32_t>",                             \
       (const void*)settle_kernel<RECV_GROUP, 1, uint32_t>, THREADS},       \
      {LAUNCH, "settle_kernel<G, 2, uint4>",                                \
       (const void*)settle_kernel<RECV_GROUP, 2, uint4>, THREADS},          \
      {LAUNCH, "settle_kernel<G, 2, uint32_t>",                             \
       (const void*)settle_kernel<RECV_GROUP, 2, uint32_t>, THREADS}

static const KernelEntry kKernels[] = {
    SETTLE_ENTRIES("bucket_insert"),
    SETTLE_ENTRIES("bucket_insert_stream"),
};
KERNEL_TABLE_EXPORTS(kKernels)
