// One packed BFS / cascade expansion step:
//   hit[u, w] = OR_s frontier[fwd_nbr[u, s], w] & mask(u, s, w)
//   new = hit & ~visited;  visited_out = visited | new
// Replaces repro/kernels/rrr_expand.py: rrr_expand_step_resident_pallas
// (mask = plane[gidx[u, s], w], gidx == rows reading zero) and
// rrr_expand_step_pallas (mask = gmask[u, s, w], pre-gathered).
//
// Bound on the H100: bytes.  Each output word costs df frontier loads
// and a handful of integer ops.  One thread per output word (u, w),
// threads along w, so the frontier-row and mask-row gathers of a warp
// coalesce; blocks run over the flattened (u, w) index, so a small W
// (down to one word) still fills every lane.  The mask word is loaded
// only where the gathered frontier word is non-zero: late BFS steps
// have sparse frontiers, and the plane load is most of the traffic.
// There is no on-chip tiling of the forward-slot axis: each thread
// loops over all df slots and ORs into a register, so hub rows cost
// time, not scratch.  Invalid slots follow the reference's contract:
// fwd_nbr is pre-clipped to 0 and the mask word is zero (gmask) or
// gidx names row `rows`, read as zero (resident).
#include <cstdint>
#include <cuda_runtime.h>

struct PlaneMask {  // resident layout
  const uint32_t* plane;
  const int32_t* gidx;
  int64_t rows;
  __device__ __forceinline__ uint32_t operator()(int64_t u, int s, int df,
                                                 int64_t w,
                                                 int64_t W) const {
    const int64_t g = gidx[u * df + s];
    return g < rows ? plane[g * W + w] : 0u;
  }
};

struct GatheredMask {  // streamed layout
  const uint32_t* gmask;
  __device__ __forceinline__ uint32_t operator()(int64_t u, int s, int df,
                                                 int64_t w,
                                                 int64_t W) const {
    return gmask[(u * df + s) * W + w];
  }
};

template <class Mask>
__global__ void expand_kernel(const uint32_t* __restrict__ frontier,
                              const uint32_t* __restrict__ visited,
                              const int32_t* __restrict__ fwd_nbr,
                              Mask mask, int64_t n, int df, int64_t W,
                              uint32_t* __restrict__ new_frontier,
                              uint32_t* __restrict__ visited_out) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * W) return;
  const int64_t u = t / W;
  const int64_t w = t - u * W;
  uint32_t hit = 0;
  for (int s = 0; s < df; ++s) {
    const int64_t v = fwd_nbr[u * df + s];
    const uint32_t f = frontier[v * W + w];
    if (f) hit |= f & mask(u, s, df, w, W);
  }
  const uint32_t vis = visited[t];
  const uint32_t nw = hit & ~vis;
  new_frontier[t] = nw;
  visited_out[t] = vis | nw;
}

static constexpr int kThreads = 256;

template <class Mask>
static int launch(const void* frontier, const void* visited,
                  const void* fwd_nbr, Mask mask, int64_t n, int64_t df,
                  int64_t W, void* new_frontier, void* visited_out,
                  void* stream) {
  const int64_t total = n * W;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  expand_kernel<Mask><<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)frontier, (const uint32_t*)visited,
      (const int32_t*)fwd_nbr, mask, n, (int)df, W,
      (uint32_t*)new_frontier, (uint32_t*)visited_out);
  return (int)cudaGetLastError();
}

extern "C" int rrr_expand_resident(const void* frontier, const void* visited,
                                   const void* fwd_nbr, const void* gidx,
                                   const void* plane, void* new_frontier,
                                   void* visited_out, int64_t n, int64_t df,
                                   int64_t W, int64_t rows, void* stream) {
  PlaneMask m{(const uint32_t*)plane, (const int32_t*)gidx, rows};
  return launch(frontier, visited, fwd_nbr, m, n, df, W, new_frontier,
                visited_out, stream);
}

extern "C" int rrr_expand_streamed(const void* frontier, const void* visited,
                                   const void* fwd_nbr, const void* gmask,
                                   void* new_frontier, void* visited_out,
                                   int64_t n, int64_t df, int64_t W,
                                   void* stream) {
  GatheredMask m{(const uint32_t*)gmask};
  return launch(frontier, visited, fwd_nbr, m, n, df, W, new_frontier,
                visited_out, stream);
}
