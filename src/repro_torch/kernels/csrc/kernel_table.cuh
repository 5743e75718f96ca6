// The device functions a library launches, for the launch and footprint
// checker (repro_torch/analysis/contracts.py): each library lists them in
// a table of KernelEntry, by the launch name they serve (ops.KERNELS),
// and KERNEL_TABLE_EXPORTS gives the checker
//   kernel_count(), kernel_launch(i), kernel_name(i)
//   kernel_attributes(i, out): cudaFuncGetAttributes of function i as
//     out[0] static shared memory, out[1] registers a thread, out[2]
//     local memory a thread (stack frame and spills), out[3] the largest
//     block it may launch, out[4] the block the library launches it with;
//     returns 0 or a cudaError_t
//   kernel_occupancy(i, smem, &blocks): its resident blocks an SM at that
//     block and ``smem`` bytes of dynamic shared memory, as the
//     cooperative launches ask it; returns 0 or a cudaError_t.
// Each library also exports launch_smem(launch, W, x), the dynamic shared
// memory its launch asks for at that shape (kernels/smem_budget.py is the
// model of it), or -1 for a launch it does not make.
#pragma once
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

struct KernelEntry {
  const char* launch;  // the launch name it serves
  const char* name;    // the device function
  const void* fn;
  int threads;         // the block it is launched with
};

// The entries of a query-axis kernel instantiated for groups of 1 .. 8
// queries (greedy_core.cuh: kMaxGroup, with_group).
#define GROUP_ENTRY(LAUNCH, KERNEL, G, THREADS) \
  { LAUNCH, #KERNEL "<" #G ">", (const void*)KERNEL<G>, THREADS }
#define GROUP_ENTRIES(LAUNCH, KERNEL, THREADS)                   \
  GROUP_ENTRY(LAUNCH, KERNEL, 1, THREADS),                       \
      GROUP_ENTRY(LAUNCH, KERNEL, 2, THREADS),                   \
      GROUP_ENTRY(LAUNCH, KERNEL, 3, THREADS),                   \
      GROUP_ENTRY(LAUNCH, KERNEL, 4, THREADS),                   \
      GROUP_ENTRY(LAUNCH, KERNEL, 5, THREADS),                   \
      GROUP_ENTRY(LAUNCH, KERNEL, 6, THREADS),                   \
      GROUP_ENTRY(LAUNCH, KERNEL, 7, THREADS),                   \
      GROUP_ENTRY(LAUNCH, KERNEL, 8, THREADS)

inline bool same_launch(const char* a, const char* b) {
  return std::strcmp(a, b) == 0;
}

#define KERNEL_TABLE_EXPORTS(TABLE)                                         \
  extern "C" int kernel_count() {                                          \
    return (int)(sizeof(TABLE) / sizeof(TABLE[0]));                        \
  }                                                                        \
  extern "C" const char* kernel_launch(int i) { return TABLE[i].launch; }  \
  extern "C" const char* kernel_name(int i) { return TABLE[i].name; }      \
  extern "C" int kernel_attributes(int i, int64_t* out) {                  \
    cudaFuncAttributes a;                                                  \
    const cudaError_t err = cudaFuncGetAttributes(&a, TABLE[i].fn);        \
    if (err != cudaSuccess) return (int)err;                               \
    out[0] = (int64_t)a.sharedSizeBytes;                                   \
    out[1] = a.numRegs;                                                    \
    out[2] = (int64_t)a.localSizeBytes;                                    \
    out[3] = a.maxThreadsPerBlock;                                         \
    out[4] = TABLE[i].threads;                                             \
    return 0;                                                              \
  }                                                                        \
  extern "C" int kernel_occupancy(int i, int64_t smem, int* blocks) {      \
    cudaError_t err = cudaFuncSetAttribute(                                \
        TABLE[i].fn, cudaFuncAttributeMaxDynamicSharedMemorySize,          \
        (int)smem);                                                        \
    if (err != cudaSuccess) return (int)err;                               \
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                   \
        blocks, TABLE[i].fn, TABLE[i].threads, (size_t)smem);              \
    return (int)err;                                                       \
  }
