// What the card says of a source's kernels: cudaFuncGetAttributes of each
// __global__ kernel, and cudaOccupancyMaxActiveBlocksPerMultiprocessor at
// the block size and dynamic shared memory its launcher uses.
//
// Each source lists its kernels in a table of KernelEntry and exports,
// through REPRO_KERNEL_ATTRIBUTES(table), three C functions:
//
//   int repro_kernel_count(void);
//   int repro_kernel_attributes(int i, const char** name,
//                               const char** symbol, int* out);
//   int repro_device_limits(int* out);
//
// repro_kernel_attributes sets *symbol to the kernel's mangled entry name
// (cudaFuncGetName), the name ptxas reports it under, and fills out[0..8]
// with: registers a thread, static
// shared memory, max threads a block (as compiled), local memory a thread,
// the launch's threads, the launch's dynamic shared memory, the blocks an
// SM the occupancy calculator gives at that launch, the blocks an SM the
// kernel's __launch_bounds__ promise (0 without a promise), and the
// kernel's max dynamic shared memory attribute.  repro_device_limits fills
// out[0..5] with: registers an SM, opt-in shared memory a block, shared
// memory an SM, threads an SM, SMs, registers a block.  Both return a CUDA
// error code (0 on success).  repro_torch.verify.kernel_budget holds the
// numbers against each other.
#pragma once

#include <cuda_runtime.h>

namespace repro_attrs {

struct KernelEntry {
  const char* name;
  const void* fn;
  int threads;      // the launch's threads a block (the largest it uses)
  int dyn_smem;     // the launch's dynamic shared memory, bytes
  int min_blocks;   // blocks an SM promised by __launch_bounds__ (0: none)
};

constexpr int kAttrFields = 9;
constexpr int kLimitFields = 6;

inline int kernel_attributes(const KernelEntry* table, int n, int i,
                             const char** name, const char** symbol,
                             int* out) {
  if (i < 0 || i >= n) return (int)cudaErrorInvalidValue;
  const KernelEntry& e = table[i];
  *name = e.name;
  cudaError_t serr = cudaFuncGetName(symbol, e.fn);
  if (serr != cudaSuccess) {
    cudaGetLastError();
    return (int)serr;
  }
  if (e.dyn_smem > 48 * 1024) {
    // as the launcher does before its first launch
    cudaError_t err = cudaFuncSetAttribute(
        e.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, e.dyn_smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, e.fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, e.fn,
                                                      e.threads, e.dyn_smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    blocks = 0;
  }
  const int fields[kAttrFields] = {
      a.numRegs, (int)a.sharedSizeBytes, a.maxThreadsPerBlock,
      (int)a.localSizeBytes, e.threads, e.dyn_smem, blocks, e.min_blocks,
      a.maxDynamicSharedSizeBytes};
  for (int f = 0; f < kAttrFields; ++f) out[f] = fields[f];
  return 0;
}

inline int device_limits(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const cudaDeviceAttr attrs[kLimitFields] = {
      cudaDevAttrMaxRegistersPerMultiprocessor,
      cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrMaxThreadsPerMultiProcessor,
      cudaDevAttrMultiProcessorCount,
      cudaDevAttrMaxRegistersPerBlock};
  for (int f = 0; f < kLimitFields; ++f) {
    err = cudaDeviceGetAttribute(&out[f], attrs[f], dev);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace repro_attrs

// The three exports over `table`, a function returning the source's
// static KernelEntry array and setting its length.
#define REPRO_KERNEL_ATTRIBUTES(table)                                       \
  extern "C" int repro_kernel_count(void) {                                  \
    int n = 0;                                                               \
    table(&n);                                                               \
    return n;                                                                \
  }                                                                          \
  extern "C" int repro_kernel_attributes(int i, const char** name,           \
                                         const char** symbol, int* out) {    \
    int n = 0;                                                               \
    const repro_attrs::KernelEntry* t = table(&n);                           \
    return repro_attrs::kernel_attributes(t, n, i, name, symbol, out);       \
  }                                                                          \
  extern "C" int repro_device_limits(int* out) {                             \
    return repro_attrs::device_limits(out);                                  \
  }
