// Greedy max-k-cover, all k picks in one launch.  Replaces
// repro/kernels/greedy_pick.py: greedy_maxcover_resident_pallas
// (sweep_tile_argmax, commit_pick, _kernel), vmapped over machines at
// repro/core/randgreedi.py:131 and over queries at
// repro/kernels/ops.py:68.  The machine axis has two layouts, chosen by
// the wrapper (greedy_pick.py: row_lists) from compact_rows_kernel's
// count of non-zero words:
//
// compact_rows_kernel + greedy_pick_compact_kernel — the compact layout
// (greedy_core.cuh), taken while the list is short enough for one block
// a machine (greedy_pick.py: compact_pays, a rule measured on the H100),
// and after a dense solve's handover over the list of its residual.
// compact_rows_kernel reads the dense rows once, 1-8 warps per 32-row
// tile over the whole grid, and lists each machine's rows that hold a
// non-zero word.  greedy_pick_compact_kernel gives each machine
// one block of 1024 threads (the cover in shared memory, no grid-wide
// sync: __syncthreads is the pick's only barrier); per pick the block
// sweeps its machine's list, a lane per listed row and kSlotsPerLane
// rows a lane at once, folds the best key and commits the winner from
// the dense rows (greedy_core.cuh: commit_pick).  Bound on the H100: bytes — the dense rows read once
// (the compaction) and the outputs written once; the picks read the list
// (about 0.3 MB at the IMM shape, 1.3 MB at the round's) from L2, so each
// pick is a few dependent L2 reads and block barriers: latency, not
// traffic.
//
// greedy_pick_kernel — the dense layout, for longer lists (the rows of
// supercritical cascades, nearly every word non-zero), which one block a
// machine would sweep more slowly than all SMs sweep the rows.  Each
// machine has its share of the blocks; per pick every block sweeps its
// share of its machine's rows (one warp per row, the cover in shared
// memory), folds its best key into the machine's key slot with a 64-bit
// atomicMax, and after one grid-wide sync commits the winner
// (greedy_core.cuh).  Each pick owns its key slot, zeroed by the caller,
// so nothing is reset between picks.  A sweep re-reads every row at HBM
// rate, so the kernel sweeps only while that pays:
//   - after each sync every block reads all m machines' keys: a machine
//     whose best gain is <= 0 sweeps and commits no more (its later picks
//     keep the pre-filled outputs, as the reference writes them), and the
//     launch ends once every machine's gains have run out;
//   - each sweep also counts, in the registers it already holds, the
//     residual of the untaken rows (their non-zero words of row & ~cover)
//     into one counter a pick (``tally``, zeroed by the caller) — after
//     the cover of the first pick a supercritical solve's residual is a
//     few thousand words of 33.5M;
//   - after the first pick whose residual is at most ``cap`` (the compact
//     layout's room, greedy_pick.py: list_room) the launch ends; the
//     wrapper lists the residual (compact_rows_kernel with the cover and
//     the taken flags) and greedy_pick_compact_kernel goes on from the
//     next pick.  The decisions are read after a grid sync, so every
//     block takes them alike and none waits at a sync the others skip.
// Bound: bytes — the rows read once; the sweeps before the handover read
// them once each.
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
#include "kernel_table.cuh"

namespace cg = cooperative_groups;

__global__ void greedy_pick_kernel(const uint32_t* __restrict__ rows,
                                   const int32_t* __restrict__ excluded,
                                   int64_t E, int64_t m, int64_t n, int64_t W,
                                   int64_t k, int64_t cap, int bpm, bool vec,
                                   unsigned long long* keys, uint8_t* taken,
                                   unsigned long long* tally, int32_t* seeds,
                                   uint32_t* rows_out, uint32_t* covered,
                                   int32_t* gains) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) uint32_t cov[];
  __shared__ unsigned long long scratch[32];
  __shared__ long long cscratch[32];
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

  bool spent = false;      // this machine's gains ran out: it sweeps no more
  bool all_spent = false;  // every machine's did: the launch ends
  int64_t p = 0;
  for (; p < k; ++p) {
    if (!spent) {
      long long mine = 0, resid = 0;
      const unsigned long long best = block_max_key_count(
          warp_sweep_argmax(R, T, cov, W, vec, lb + (int64_t)warp * bpm, n,
                            (int64_t)wpb * bpm, lane, &mine),
          mine, scratch, cscratch, &resid);
      if (threadIdx.x == 0) {
        if (best) atomicMax(K + p, best);
        if (resid) atomicAdd(tally + p, (unsigned long long)resid);
      }
    }
    grid.sync();
    // Read after the sync, the same in every block: whether any machine
    // goes on, and the residual of all of them before this pick's commit.
    if (!any_gain(keys, m, k, p)) {
      all_spent = true;
      break;
    }
    const unsigned long long win = __ldcg(K + p);
    spent = key_gain(win) <= 0;  // picks p .. k - 1 keep their pre-fill
    if (!spent) {
      const int64_t out = (int64_t)mach * k + p;
      commit_pick(win, R, W, 1, bpm, lb, cov, T, seeds + out, gains + out,
                  rows_out + out * W);
    }
    if (cap > 0 && __ldcg(tally + p) <= (unsigned long long)cap) {
      ++p;  // hand over: the compact picks go on from pick p + 1
      break;
    }
  }
  if (lb == 0)
    for (int64_t w = threadIdx.x; w < W; w += blockDim.x)
      covered[(int64_t)mach * W + w] = cov[w];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    tally[k] = (unsigned long long)p;
    tally[k + 1] = all_spent;
  }
}

// The compact layout's list of m machines' rows [m, n, W]: a group of g
// warps per 32-row tile (g = 1, 2, 4 or 8, chosen at launch), tiles of
// all machines dealt over the grid (greedy_core.cuh: compact_tile).
constexpr int kCompactRowsThreads = 256;
constexpr int kCompactRowsWarps = kCompactRowsThreads / 32;

template <bool kMasked>
__global__ void __launch_bounds__(kCompactRowsThreads) compact_rows_kernel(
    const uint32_t* __restrict__ rows, const uint32_t* __restrict__ cover,
    const uint8_t* __restrict__ taken, int64_t m, int64_t n, int64_t W,
    int64_t num_tiles, bool vec, int64_t cap, int g,
    unsigned long long* total, int32_t* listed, int32_t* row_ids,
    int32_t* counts, int64_t* starts, int2* tiles, int2* ent) {
  __shared__ int s_count[kCompactRowsWarps][kTileRows];
  __shared__ int64_t s_start[kCompactRowsWarps][kTileRows];
  const int warp = threadIdx.x >> 5;
  const int group = warp / g, groups = kCompactRowsWarps / g;
  for (int64_t i = (int64_t)blockIdx.x * groups + group; i < m * num_tiles;
       i += (int64_t)gridDim.x * groups) {
    const int64_t mach = i / num_tiles;
    compact_tile<kMasked>(
        rows + mach * n * W, kMasked ? cover + mach * W : nullptr,
        kMasked ? taken + mach * n : nullptr, n, W, vec, i % num_tiles, cap,
        total, listed + mach, row_ids + mach * n, counts + mach * n,
        starts + mach * n, tiles + mach * num_tiles, ent, g, warp % g, group,
        s_count[group], s_start[group]);
  }
}

constexpr int kCompactThreads = 1024;
// Listed rows a lane sweeps at once in each pass over the list: their
// loads in flight together.
constexpr int kSlotsPerLane = 4;

// Picks p0 .. k - 1 of m machines over their lists, one block per
// machine, from the cover in ``covered`` and the taken flags (zero for a
// fresh solve; a dense launch's at its handover); a machine stops at the
// first pick whose best gain is <= 0, the later picks keeping their
// pre-filled outputs.
__global__ void __launch_bounds__(kCompactThreads, 1)
greedy_pick_compact_kernel(const uint32_t* __restrict__ rows,
                           const int32_t* __restrict__ excluded, int64_t E,
                           int64_t n, int64_t W, int64_t k, int64_t p0,
                           const int32_t* __restrict__ listed,
                           const int32_t* __restrict__ row_ids,
                           const int32_t* __restrict__ counts,
                           const int64_t* __restrict__ starts,
                           const int2* __restrict__ ent, uint8_t* taken,
                           int32_t* seeds, uint32_t* rows_out,
                           uint32_t* covered, int32_t* gains) {
  extern __shared__ __align__(16) uint32_t cov[];
  __shared__ unsigned long long scratch[32];
  __shared__ unsigned long long s_win;
  const int64_t mach = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  const uint32_t* R = rows + mach * n * W;
  uint8_t* T = taken + mach * n;
  const RowList L{row_ids + mach * n, counts + mach * n, starts + mach * n,
                  ent};
  const int64_t slots = listed[mach];

  for (int64_t w = threadIdx.x; w < W; w += blockDim.x)
    cov[w] = covered[mach * W + w];
  if (threadIdx.x == 0)
    mark_excluded(excluded + mach * E, E, n, 1, 1, 0, T);
  __syncthreads();

  for (int64_t p = p0; p < k; ++p) {
    unsigned long long best = 0;
    for (int64_t j0 = (int64_t)warp * 32; j0 < slots;
         j0 += (int64_t)wpb * 32 * kSlotsPerLane) {
      const unsigned long long key = warp_listed_best<kSlotsPerLane>(
          L, j0 + lane, (int64_t)wpb * 32, slots, T, cov, lane);
      best = key > best ? key : best;
    }
    best = block_max_key(warp_max(best), scratch);
    if (threadIdx.x == 0) s_win = best;
    __syncthreads();
    if (key_gain(s_win) <= 0) break;  // the gains ran out
    const int64_t out = mach * k + p;
    commit_pick(s_win, R, W, 1, 1, 0, cov, T, seeds + out, gains + out,
                rows_out + out * W);
  }
  for (int64_t w = threadIdx.x; w < W; w += blockDim.x)
    covered[mach * W + w] = cov[w];
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

constexpr int kDenseThreads = 256;

// The dense picks of m machines from pick 0: ``tally`` (uint64 [k + 2],
// zeroed) gets each swept pick's residual count, then the picks made and
// whether every machine's gains ran out; ``cap`` > 0 hands over after the
// first pick whose residual is at most ``cap``.
extern "C" int greedy_pick(const void* rows, const void* excluded, void* keys,
                           void* taken, void* tally, void* seeds,
                           void* rows_out, void* covered, void* gains,
                           int64_t m, int64_t n, int64_t W, int64_t k,
                           int64_t E, int64_t cap, void* stream) {
  const int threads = kDenseThreads;
  const size_t smem = (size_t)cover_bytes(W);
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
  int64_t E_ = E, m_ = m, n_ = n, W_ = W, k_ = k, cap_ = cap;
  bool vec = vec_rows(rows, W);
  void* args[] = {(void*)&rows, (void*)&excluded, &E_, &m_, &n_, &W_, &k_,
                  &cap_, &bpm, &vec, &keys, &taken, &tally, &seeds,
                  &rows_out, &covered, &gains};
  err = cudaLaunchCooperativeKernel((void*)greedy_pick_kernel,
                                    dim3((unsigned)(m * bpm)), dim3(threads),
                                    args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Build the compact list of rows [m, n, W] (greedy_core.cuh): ``total``
// (one uint64, zeroed) counts every non-zero word, ``listed`` (int32 [m],
// zeroed) the listed rows of each machine; entries past ``cap`` are
// counted but not written.  ``cover`` (uint32 [m, W]) and ``taken``
// (uint8 [m, n]), both null or both given, list the residual of a dense
// solve instead: untaken rows, words & ~cover.
extern "C" int compact_rows(const void* rows, const void* cover,
                            const void* taken, void* total, void* listed,
                            void* row_ids, void* counts, void* starts,
                            void* tiles, void* ent, int64_t m, int64_t n,
                            int64_t W, int64_t cap, void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // the residual of a dense solve (cover and taken flags), or the rows
  auto kernel = cover ? compact_rows_kernel<true> : compact_rows_kernel<false>;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kCompactRowsThreads, 0);
  if (err != cudaSuccess) return (int)err;
  const int64_t num_tiles = (n + kTileRows - 1) / kTileRows;
  // As many warps a tile (at most 8) as the resident warps leave once
  // every tile has one: a warp a tile where tiles fill the card (it hides
  // latency without barriers), a block a tile where they are few.
  const int64_t resident = (int64_t)per_sm * sms;
  int g = kCompactRowsWarps;
  while (g > 1 && m * num_tiles * g > resident * kCompactRowsWarps) g >>= 1;
  int64_t blocks = (m * num_tiles + kCompactRowsWarps / g - 1) /
                   (kCompactRowsWarps / g);
  if (blocks > resident) blocks = resident;
  const bool vec = vec_rows(rows, W) && (!cover || vec_rows(cover, W));
  kernel<<<(unsigned)blocks, kCompactRowsThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)rows, (const uint32_t*)cover, (const uint8_t*)taken,
      m, n, W, num_tiles, vec, cap, g,
      (unsigned long long*)total, (int32_t*)listed, (int32_t*)row_ids,
      (int32_t*)counts, (int64_t*)starts, (int2*)tiles, (int2*)ent);
  return (int)cudaGetLastError();
}

// The compact layout's picks p0 .. k - 1: one block of kCompactThreads
// per machine; ``covered`` holds the cover of the picks before p0.
extern "C" int greedy_pick_compact(const void* rows, const void* excluded,
                                   const void* listed, const void* row_ids,
                                   const void* counts, const void* starts,
                                   const void* ent, void* taken, void* seeds,
                                   void* rows_out, void* covered, void* gains,
                                   int64_t m, int64_t n, int64_t W, int64_t k,
                                   int64_t E, int64_t p0, void* stream) {
  size_t smem = 0;
  const int planned = cover_smem(greedy_pick_compact_kernel, W, &smem);
  if (planned) return planned;
  greedy_pick_compact_kernel<<<(unsigned)m, kCompactThreads, smem,
                               (cudaStream_t)stream>>>(
      (const uint32_t*)rows, (const int32_t*)excluded, E, n, W, k, p0,
      (const int32_t*)listed, (const int32_t*)row_ids, (const int32_t*)counts,
      (const int64_t*)starts, (const int2*)ent, (uint8_t*)taken,
      (int32_t*)seeds, (uint32_t*)rows_out, (uint32_t*)covered,
      (int32_t*)gains);
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
  const size_t smem = (size_t)group_cover_bytes(G, W);
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

// The dynamic shared memory of a launch (kernel_table.cuh): the cover of
// W words (greedy_pick, greedy_pick_compact), a group's x covers
// (greedy_pick_batch, x = G), none (compact_rows).
extern "C" int64_t launch_smem(const char* launch, int64_t W, int64_t x) {
  if (same_launch(launch, "greedy_pick") ||
      same_launch(launch, "greedy_pick_compact"))
    return cover_bytes(W);
  if (same_launch(launch, "greedy_pick_batch"))
    return group_cover_bytes(x, W);
  if (same_launch(launch, "compact_rows")) return 0;
  return -1;
}

static const KernelEntry kKernels[] = {
    {"greedy_pick", "greedy_pick_kernel", (const void*)greedy_pick_kernel,
     kDenseThreads},
    {"compact_rows", "compact_rows_kernel<false>",
     (const void*)compact_rows_kernel<false>, kCompactRowsThreads},
    {"compact_rows", "compact_rows_kernel<true>",
     (const void*)compact_rows_kernel<true>, kCompactRowsThreads},
    {"greedy_pick_compact", "greedy_pick_compact_kernel",
     (const void*)greedy_pick_compact_kernel, kCompactThreads},
    GROUP_ENTRIES("greedy_pick_batch", greedy_pick_batch_kernel,
                  kBatchThreads),
};
KERNEL_TABLE_EXPORTS(kKernels)
