// The pick of the greedy senders, shared by greedy_pick.cu (the resident
// solve) and lazy_greedy.cu (the lazy solve), as the reference's
// lazy_greedy.py reuses greedy_pick.sweep_tile_argmax and commit_pick:
// the bit-exactness contract has one implementation.
//
// A row's key for the argmax is ((gain + 1) << 32) | (0xFFFFFFFF - row):
// the largest gain wins and, among equal gains, the lowest row index —
// jnp.argmax's tie-break.  Picked and excluded rows score gain -1.  A
// solve's winner is the 64-bit atomicMax of its blocks' keys.  The
// query-axis kernels sweep each row once for a group of G queries
// (gain_core.cuh's warp_row_gains) and keep one key slot, one taken-flag
// row and one cover per query (lane_key, block_post_keys).
#pragma once
#include <cstdint>
#include <type_traits>

#include "gain_core.cuh"

// The largest query group of the query-axis kernels: they are
// instantiated for G = 1 .. kMaxGroup (G covers in shared memory, G
// accumulators a lane) and keep G x 32 keys of scratch.
constexpr int kMaxGroup = 8;

// The dynamic shared memory of the senders' covers: one cover of W words
// (the machine axis, the Ripples sweep), or a query group's G.
inline int64_t cover_bytes(int64_t W) {
  return W * (int64_t)sizeof(uint32_t);
}
inline int64_t group_cover_bytes(int64_t G, int64_t W) {
  return G * cover_bytes(W);
}

// Host side: f(std::integral_constant<int, G>) for the runtime G, or -6
// (no such instantiation).
template <class F>
int with_group(int64_t G, F f) {
  switch (G) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return -6;
  }
}
static_assert(kMaxGroup == 8, "with_group covers G = 1 .. 8");

__device__ __forceinline__ unsigned long long pick_key(int gain, int64_t r) {
  return ((unsigned long long)(uint32_t)(gain + 1) << 32) |
         (unsigned long long)(0xFFFFFFFFu - (uint32_t)r);
}

__device__ __forceinline__ int key_gain(unsigned long long key) {
  return (int)(uint32_t)(key >> 32) - 1;
}

__device__ __forceinline__ int64_t key_row(unsigned long long key) {
  return (int64_t)(0xFFFFFFFFu - (uint32_t)key);
}

// The largest key any row of a tile could hold: its bound ``ub`` (a gain,
// or INT32_MAX before the first sweep) at its first row ``r0``.  The lazy
// machine-axis solves skip a tile whose tile_key is below the best key
// read so far (always <= the pick's final one): none of its rows can win,
// nor tie it at a lower index, so tied tiles after the best row skip too.
__device__ __forceinline__ unsigned long long tile_key(int ub, int64_t r0) {
  return ((unsigned long long)((uint32_t)ub + 1u) << 32) |
         (unsigned long long)(0xFFFFFFFFu - (uint32_t)r0);
}

__device__ __forceinline__ long long warp_sum64(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The gain and the residual words (non-zero words of row & ~cov) of one
// 16-byte chunk, added into ``g`` and ``z``.
__device__ __forceinline__ void chunk_gain_residual(uint4 a, uint4 c, int& g,
                                                   int& z) {
  const uint32_t d[4] = {a.x & ~c.x, a.y & ~c.y, a.z & ~c.z, a.w & ~c.w};
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    g += __popc(d[x]);
    z += d[x] != 0;
  }
}

// warp_row_gain that also counts, into ``*nz`` (this lane's part, not
// summed over the warp), the row's residual words: the non-zero words of
// row & ~cov, which a compaction against this cover would list.  The
// and-not is taken once for both.  With ``vec`` each lane keeps
// kRowChunks 16-byte loads of the row in flight: the lazy kernel's tile
// sweeps run on few warps, where a load at a time leaves them waiting.
constexpr int kRowChunks = 8;
__device__ __forceinline__ int warp_row_gain_residual(const uint32_t* row,
                                                      const uint32_t* cov,
                                                      int64_t W, bool vec,
                                                      int lane, int* nz) {
  int g = 0, z = 0;
  if (vec) {
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
    const uint4* c4 = reinterpret_cast<const uint4*>(cov);
    const int64_t W4 = W >> 2;
    int64_t base = 0;
    for (; base + 32 * kRowChunks <= W4; base += 32 * kRowChunks) {
      uint4 a[kRowChunks];
#pragma unroll
      for (int u = 0; u < kRowChunks; ++u)
        a[u] = __ldg(r4 + base + lane + 32 * u);
#pragma unroll
      for (int u = 0; u < kRowChunks; ++u)
        chunk_gain_residual(a[u], c4[base + lane + 32 * u], g, z);
    }
    for (int64_t i = base + lane; i < W4; i += 32)
      chunk_gain_residual(__ldg(r4 + i), c4[i], g, z);
  } else {
    for (int64_t w = lane; w < W; w += 32) {
      const uint32_t d = row[w] & ~cov[w];
      g += __popc(d);
      z += d != 0;
    }
  }
  *nz = z;
  return warp_sum(g);
}

// Best key of the rows first, first + stride, ... < end, one warp per
// row (the tile sweep + argmax of sweep_tile_argmax).  ``taken`` marks
// picked and excluded rows.  With ``resid``, the residual words of the
// rows not taken (warp_row_gain_residual) are added into ``*resid``,
// this lane's part: the count the dense machine-axis kernels hand over
// on (greedy_pick.cu).
__device__ __forceinline__ unsigned long long warp_sweep_argmax(
    const uint32_t* R, const uint8_t* taken, const uint32_t* cov, int64_t W,
    bool vec, int64_t first, int64_t end, int64_t stride, int lane,
    long long* resid = nullptr) {
  unsigned long long best = 0;
  for (int64_t r = first; r < end; r += stride) {
    int nz = 0;
    int g = resid ? warp_row_gain_residual(R + r * W, cov, W, vec, lane, &nz)
                  : warp_row_gain(R + r * W, cov, W, vec, lane);
    if (taken[r])
      g = -1;
    else if (resid)
      *resid += nz;
    const unsigned long long key = pick_key(g, r);
    best = key > best ? key : best;
  }
  return best;
}

// The largest of the warps' keys; the result is valid in warp 0.
// ``scratch`` holds 32 keys of shared memory; every thread must call.
__device__ __forceinline__ unsigned long long block_max_key(
    unsigned long long v, unsigned long long* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  unsigned long long b = 0;
  if (warp == 0) b = warp_max(lane < wpb ? scratch[lane] : 0ull);
  __syncthreads();
  return b;
}

// block_max_key (``v`` the same in every lane of a warp) that also sums
// every lane's count ``c`` into ``*sum``, valid in warp 0.  ``cscratch``
// holds 32 counts of shared memory; every thread must call.
__device__ __forceinline__ unsigned long long block_max_key_count(
    unsigned long long v, long long c, unsigned long long* scratch,
    long long* cscratch, long long* sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  c = warp_sum64(c);
  if (lane == 0) {
    scratch[warp] = v;
    cscratch[warp] = c;
  }
  __syncthreads();
  unsigned long long b = 0;
  long long s = 0;
  if (warp == 0) {
    b = warp_max(lane < wpb ? scratch[lane] : 0ull);
    s = warp_sum64(lane < wpb ? cscratch[lane] : 0ll);
  }
  __syncthreads();
  *sum = s;
  return b;
}

// After the grid-wide sync of pick p of m machine solves (machine j's
// key slot at keys[j * k + p], zeroed by the caller, so a machine that
// posted nothing reads gain -1): whether some machine's best gain is
// positive.  The same answer in every block; every thread must call.
__device__ __forceinline__ bool any_gain(const unsigned long long* keys,
                                         int64_t m, int64_t k, int64_t p) {
  int pos = 0;
  for (int64_t j = threadIdx.x; j < m; j += blockDim.x)
    pos |= key_gain(__ldcg(keys + j * k + p)) > 0;
  return __syncthreads_or(pos) != 0;
}

// The G query keys of row r from gains ``g`` (every lane holds all G):
// lane q < gq returns query q's key, masked by its taken flag (``taken``
// points at the group's first query, rows of n flags; read from L2, as
// another block may have set it); other lanes 0.
template <int G>
__device__ __forceinline__ unsigned long long lane_key(const int (&g)[G],
                                                       const uint8_t* taken,
                                                       int64_t n, int64_t r,
                                                       int gq, int lane) {
  int mine = 0;
#pragma unroll
  for (int q = 0; q < G; ++q)
    if (lane == q) mine = g[q];
  if (lane >= gq) return 0;
  if (__ldcg(taken + (int64_t)lane * n + r)) mine = -1;
  return pick_key(mine, r);
}

// Fold the warps' per-query keys (lane q holds query q's) into the
// block's best key per query and hand each to ``post(q, key)`` on lane 0
// of warp q.  ``scratch`` holds G x 32 keys of shared memory; needs at
// least G warps; every thread must call.
template <int G, class Post>
__device__ __forceinline__ void block_post_keys(unsigned long long v,
                                                unsigned long long (*scratch)[32],
                                                int gq, Post post) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  if (lane < G) scratch[lane][warp] = v;
  __syncthreads();
  if (warp < gq) {
    const unsigned long long b = warp_max(lane < wpb ? scratch[warp][lane] : 0ull);
    if (lane == 0) post(warp, b);
  }
  __syncthreads();
}

// Rows a block owns come in units of ``unit`` rows, dealt round-robin to
// the machine's ``bpm`` blocks; only the owner reads or writes a row's
// taken flag.
__device__ __forceinline__ bool owns(int64_t r, int64_t unit, int bpm,
                                     int lb) {
  return (r / unit) % bpm == lb;
}

// Mark the excluded rows this block owns (the serving seed-constraint,
// masked like picked rows).  Thread 0 only.
__device__ __forceinline__ void mark_excluded(const int32_t* excluded,
                                              int64_t E, int64_t n,
                                              int64_t unit, int bpm, int lb,
                                              uint8_t* taken) {
  for (int64_t e = 0; e < E; ++e) {
    const int64_t r = excluded[e];
    if (r >= 0 && r < n && owns(r, unit, bpm, lb)) taken[r] = 1;
  }
}

// commit_pick: decode the machine's winning key, OR the winner's row
// into this block's shared-memory cover, mark it taken in its owner
// block, and (the machine's first block) write the seed, gain and row.
// A best gain <= 0 gives seed -1, gain 0 and a zero row.
__device__ __forceinline__ void commit_pick(
    unsigned long long win, const uint32_t* R, int64_t W, int64_t unit,
    int bpm, int lb, uint32_t* cov, uint8_t* taken, int32_t* seed_out,
    int32_t* gain_out, uint32_t* row_out) {
  const int gain = key_gain(win);
  const int64_t idx = key_row(win);
  const bool take = gain > 0;
  const uint32_t* wrow = R + idx * W;
  for (int64_t w = threadIdx.x; w < W; w += blockDim.x) {
    const uint32_t word = take ? wrow[w] : 0u;
    cov[w] |= word;
    if (lb == 0) row_out[w] = word;
  }
  if (threadIdx.x == 0) {
    if (take && owns(idx, unit, bpm, lb)) taken[idx] = 1;
    if (lb == 0) {
      *seed_out = take ? (int32_t)idx : -1;
      *gain_out = take ? gain : 0;
    }
  }
  __syncthreads();
}

// commit_pick for a group of gq queries at once (query q's key slot at
// keys[q * k], its cover at cov + q * W, its taken flags at taken + q *
// n): one pass over the words ORs every winner's row into its cover (a
// block writes the outputs of the queries q0 + q with (q0 + q) % nb ==
// lb), then one barrier.  ``s_win`` holds G keys of shared memory.
template <int G>
__device__ __forceinline__ void commit_group(
    const unsigned long long* keys, int64_t k, int64_t p, const uint32_t* R,
    int64_t W, int64_t n, int64_t unit, int nb, int lb, int64_t q0, int gq,
    uint32_t* cov, uint8_t* taken, int32_t* seeds, int32_t* gains,
    uint32_t* rows_out, unsigned long long* s_win) {
  if (threadIdx.x < gq) s_win[threadIdx.x] = __ldcg(keys + threadIdx.x * k);
  __syncthreads();
  int gain[G];
  int64_t idx[G];
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const unsigned long long win = q < gq ? s_win[q] : 0ull;
    gain[q] = key_gain(win);
    idx[q] = key_row(win);
  }
  for (int64_t w = threadIdx.x; w < W; w += blockDim.x) {
#pragma unroll
    for (int q = 0; q < G; ++q) {
      if (q >= gq) continue;
      const uint32_t word = gain[q] > 0 ? __ldg(R + idx[q] * W + w) : 0u;
      cov[q * W + w] |= word;
      if ((q0 + q) % nb == lb) rows_out[((q0 + q) * k + p) * W + w] = word;
    }
  }
  if (threadIdx.x < gq) {
    const int q = threadIdx.x;
    const bool take = gain[q] > 0;
    if (take && owns(idx[q], unit, nb, lb)) taken[q * n + idx[q]] = 1;
    if ((q0 + q) % nb == lb) {
      seeds[(q0 + q) * k + p] = take ? (int32_t)idx[q] : -1;
      gains[(q0 + q) * k + p] = take ? gain[q] : 0;
    }
  }
  __syncthreads();
}

// ---- The compact layout of the machine-axis solves ------------------
//
// Incidence rows are almost all zero words (about 1 in 7,000 words is
// non-zero at the full-size runs), and a row's gain is the sum over its
// non-zero words alone.  So the machine-axis kernels (greedy_pick.cu,
// lazy_greedy.cu) read the dense rows once, in compact_rows_kernel
// (greedy_pick.cu, 1-8 warps a 32-row tile), into a list, and sweep only
// the list in every pick:
//   - per machine, slots 0 .. listed - 1, one for each row that holds a
//     non-zero word: its row id, its entry count and its first entry;
//     the slots of one 32-row tile are contiguous (tiles[t] = first slot,
//     slots), so the lazy solve can skip a tile by its bound;
//   - entries (word index, word) of one row contiguous, in word order;
//     rows and machines share one array, in no fixed order.
// Rows absent from the list gain 0, and a best gain <= 0 commits nothing,
// so leaving them out changes no output.  A machine's one block marks its
// excluded and picked rows in its taken flags and alone reads them.  The
// cover stays in shared memory and the winner's row is read from the
// dense rows, as in the dense sweep.

constexpr int kTileRows = 32;    // rows of a tile: one lane of a warp each
constexpr int kLaneEntries = 4;  // longer rows are summed by the whole warp

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// 16-byte chunks a lane loads at once when it reads a row: a group is
// kChunkGroup x 32 chunks of the row.
constexpr int kChunkGroup = 8;

// 16-byte chunk i of a row, less the cover's chunk i when ``kMasked``;
// zeros past the row's W4 chunks.
template <bool kMasked>
__device__ __forceinline__ uint4 masked_chunk(const uint4* r4,
                                              const uint4* cov4, int64_t i,
                                              int64_t W4) {
  if (i >= W4) return make_uint4(0, 0, 0, 0);
  uint4 a = __ldg(r4 + i);
  if (kMasked) {
    const uint4 c = __ldg(cov4 + i);
    a = make_uint4(a.x & ~c.x, a.y & ~c.y, a.z & ~c.z, a.w & ~c.w);
  }
  return a;
}

// Non-zero words of one row (with ``kMasked``, of row & ~cov: the
// residual of a solve part-way), one warp per row; every lane returns the
// count.  With ``vec`` (row and cover aligned) each lane keeps
// kChunkGroup 16-byte loads in flight, and ``groups`` gets bit g set when
// group g holds a non-zero word (groups past the 32nd are not marked;
// warp_list_row reads them all).
template <bool kMasked>
__device__ __forceinline__ int warp_row_nonzero(const uint32_t* row,
                                                const uint32_t* cov,
                                                int64_t W, bool vec,
                                                int lane, unsigned* groups) {
  int c = 0;
  unsigned gm = 0;
  if (vec) {
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
    const uint4* c4 = reinterpret_cast<const uint4*>(cov);
    const int64_t W4 = W >> 2;
    int g = 0;
    for (int64_t base = 0; base < W4; base += 32 * kChunkGroup, ++g) {
      uint4 a[kChunkGroup];
#pragma unroll
      for (int u = 0; u < kChunkGroup; ++u)
        a[u] = masked_chunk<kMasked>(r4, c4, base + lane + 32 * u, W4);
      int cg = 0;
#pragma unroll
      for (int u = 0; u < kChunkGroup; ++u)
        cg += (a[u].x != 0) + (a[u].y != 0) + (a[u].z != 0) + (a[u].w != 0);
      if (__any_sync(0xffffffffu, cg) && g < 32) gm |= 1u << g;
      c += cg;
    }
  } else {
    for (int64_t w = lane; w < W; w += 32)
      c += (__ldg(row + w) & ~(kMasked ? __ldg(cov + w) : 0u)) != 0;
  }
  *groups = gm;
  return warp_sum(c);
}

// Write the ``c`` entries of a row at ent + start, in word order: the
// warp reads the row (and ``cov``, as warp_row_nonzero) again (it has
// just counted it: from L1 or L2) and places each non-zero word by a
// prefix count over the lanes.  With ``vec`` it reads only the groups
// ``groups`` marks (and any past the 32nd), kChunkGroup chunks a lane at
// once; it stops once all ``c`` are written.
template <bool kMasked>
__device__ __forceinline__ void warp_list_row(const uint32_t* row,
                                              const uint32_t* cov, int64_t W,
                                              bool vec, unsigned groups,
                                              int2* ent, int64_t start, int c,
                                              int lane) {
  const int64_t end = start + c;
  int64_t pos = start;  // warp-uniform
  if (vec) {
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
    const uint4* c4 = reinterpret_cast<const uint4*>(cov);
    const int64_t W4 = W >> 2;
    int g = 0;
    for (int64_t base = 0; base < W4 && pos < end;
         base += 32 * kChunkGroup, ++g) {
      if (g < 32 && !(groups >> g & 1u)) continue;
      uint4 a[kChunkGroup];
#pragma unroll
      for (int u = 0; u < kChunkGroup; ++u)
        a[u] = masked_chunk<kMasked>(r4, c4, base + lane + 32 * u, W4);
#pragma unroll
      for (int u = 0; u < kChunkGroup; ++u) {
        const uint32_t v[4] = {a[u].x, a[u].y, a[u].z, a[u].w};
        const int mine = (v[0] != 0) + (v[1] != 0) + (v[2] != 0) + (v[3] != 0);
        if (!__any_sync(0xffffffffu, mine)) continue;
        int incl = mine;  // inclusive prefix count over the lanes
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int o = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += o;
        }
        int64_t p = pos + incl - mine;
        const int64_t i = base + lane + 32 * u;
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (v[x]) ent[p++] = make_int2((int)(4 * i + x), (int)v[x]);
        pos += __shfl_sync(0xffffffffu, incl, 31);
      }
    }
  } else {
    for (int64_t w0 = 0; w0 < W && pos < end; w0 += 32) {
      const int64_t w = w0 + lane;
      const uint32_t x =
          w < W ? __ldg(row + w) & ~(kMasked ? __ldg(cov + w) : 0u) : 0u;
      const unsigned b = __ballot_sync(0xffffffffu, x != 0);
      if (x) ent[pos + __popc(b & lanes_below(lane))] = make_int2((int)w, (int)x);
      pos += __popc(b);
    }
  }
}

// Wait for the ``g`` warps of tile group ``group`` of this block (one
// warp: __syncwarp; more: named barrier group + 1), ordering their
// shared-memory accesses.
__device__ __forceinline__ void group_sync(int group, int g) {
  if (g == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(g * 32) : "memory");
}

// List tile t of one machine (rows ``R``, its slot arrays and tile table)
// with a group of ``g`` warps of one block (``wg`` this warp's rank in
// it): the warps take the tile's rows in turn (row i to warp i mod g), so
// where tiles are few each warp reads a few rows, not all 32.  A row with
// c non-zero words reserves c entries with one atomicAdd on ``total``
// (which counts every entry, also past ``cap``) and writes them while
// they fit; after the group's barrier its first warp reserves the slots
// of the tile's listed rows with one atomicAdd on the machine's
// ``listed``.  With ``kMasked``, the cover ``cov`` and taken flags
// ``taken`` of a dense solve at its handover, it lists the residual: each
// untaken row's non-zero words of row & ~cov.  ``s_count`` and
// ``s_start`` hold the group's kTileRows counts and starts of shared
// memory; every thread of the group must call.
template <bool kMasked>
__device__ __forceinline__ void compact_tile(
    const uint32_t* R, const uint32_t* cov, const uint8_t* taken, int64_t n,
    int64_t W, bool vec, int64_t t, int64_t cap, unsigned long long* total,
    int32_t* listed, int32_t* row_ids, int32_t* counts, int64_t* starts,
    int2* tiles, int2* ent, int g, int wg, int group, int* s_count,
    int64_t* s_start) {
  const int lane = threadIdx.x & 31;
  const int64_t r0 = t * kTileRows;
  for (int i = wg; i < kTileRows; i += g) {
    const int64_t r = r0 + i;
    int c = 0;
    unsigned long long s = 0;
    if (r < n && !(kMasked && taken[r])) {
      const uint32_t* row = R + r * W;
      unsigned groups = 0;
      c = warp_row_nonzero<kMasked>(row, cov, W, vec, lane, &groups);
      if (c) {
        if (lane == 0) s = atomicAdd(total, (unsigned long long)c);
        s = __shfl_sync(0xffffffffu, s, 0);
        if (s + c <= (unsigned long long)cap)
          warp_list_row<kMasked>(row, cov, W, vec, groups, ent, (int64_t)s, c,
                                 lane);
      }
    }
    if (lane == 0) {
      s_count[i] = c;
      s_start[i] = (int64_t)s;
    }
  }
  group_sync(group, g);
  if (wg == 0) {
    const int my_count = s_count[lane];
    const unsigned b = __ballot_sync(0xffffffffu, my_count > 0);
    int first = 0;
    if (lane == 0 && b) first = atomicAdd(listed, __popc(b));
    first = __shfl_sync(0xffffffffu, first, 0);
    if (my_count) {
      const int slot = first + __popc(b & lanes_below(lane));
      row_ids[slot] = (int32_t)(r0 + lane);
      counts[slot] = my_count;
      starts[slot] = s_start[lane];
    }
    if (lane == 0) tiles[t] = make_int2(first, __popc(b));
  }
  group_sync(group, g);  // the group's next tile reuses s_count, s_start
}

// One machine's list, as the pick kernels read it.
struct RowList {
  const int32_t* row_ids;  // [slots]
  const int32_t* counts;
  const int64_t* starts;
  const int2* ent;         // shared by all machines
};

// Best masked key of the listed rows in slots j + u * stride (u < U;
// lanes whose slot is < end), or 0: a row's gain is the sum of
// popc(word & ~cov[idx]) over its entries, -1 if ``taken`` marks it.  The
// U slots' loads are issued together: their descriptors, then their
// first entries and taken flags, then each slot's other entries at
// once.  A lane sums a row of at most kLaneEntries entries itself; the
// warp sums longer ones together, one at a time.  All 32 lanes must call.  ``taken`` is read through L1:
// only this block writes it.
template <int U>
__device__ __forceinline__ unsigned long long warp_listed_best(
    const RowList& L, int64_t j, int64_t stride, int64_t end,
    const uint8_t* taken, const uint32_t* cov, int lane) {
  int row[U], c[U];
  long long s[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t slot = j + u * stride;
    row[u] = c[u] = 0;
    s[u] = 0;
    if (slot < end) {  // a listed row has at least one entry
      row[u] = __ldg(L.row_ids + slot);
      c[u] = __ldg(L.counts + slot);
      s[u] = __ldg(reinterpret_cast<const long long*>(L.starts) + slot);
    }
  }
  int2 first[U];
  bool tk[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool light = c[u] && c[u] <= kLaneEntries;
    first[u] = light ? __ldg(L.ent + s[u]) : make_int2(0, 0);
    tk[u] = c[u] && taken[row[u]];
  }
  unsigned long long best = 0;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    int g = andnot_popc((uint32_t)first[u].y, cov[first[u].x]);
    if (c[u] > 1 && c[u] <= kLaneEntries) {  // the rest at once
      int2 rest[kLaneEntries - 1];
#pragma unroll
      for (int i = 0; i < kLaneEntries - 1; ++i)
        rest[i] = i + 1 < c[u] ? __ldg(L.ent + s[u] + 1 + i) : make_int2(0, 0);
#pragma unroll
      for (int i = 0; i < kLaneEntries - 1; ++i)
        g += andnot_popc((uint32_t)rest[i].y, cov[rest[i].x]);
    }
    unsigned hv = __ballot_sync(0xffffffffu, c[u] > kLaneEntries);
    while (hv) {
      const int src = __ffs(hv) - 1;
      hv &= hv - 1;
      const long long hs = __shfl_sync(0xffffffffu, s[u], src);
      const int hc = __shfl_sync(0xffffffffu, c[u], src);
      int h = 0;
      for (int i = lane; i < hc; i += 32) {
        const int2 x = __ldg(L.ent + hs + i);
        h += andnot_popc((uint32_t)x.y, cov[x.x]);
      }
      h = warp_sum(h);
      if (lane == src) g = h;
    }
    if (c[u]) {
      const unsigned long long key = pick_key(tk[u] ? -1 : g, row[u]);
      best = key > best ? key : best;
    }
  }
  return best;
}

// Host side: let ``kernel`` take W x 4 bytes of dynamic shared memory
// (the cover) beside its static scratch.  0, -2 (it does not fit) or a
// cudaError_t.
template <class Kernel>
inline int cover_smem(Kernel kernel, int64_t W, size_t* smem) {
  *smem = (size_t)cover_bytes(W);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  if (*smem + attr.sharedSizeBytes > (size_t)optin) return -2;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)*smem);
  return (int)err;
}
