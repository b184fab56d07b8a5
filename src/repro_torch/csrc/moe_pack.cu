// MoE dispatch pack and combine kernels K5, K6 for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of
// src/repro/kernels/moe_pack/moe_pack.py:
//   K5 gather_rows   (_pack_kernel)     -> gather_rows_kernel
//   K6 combine_rows  (_combine_kernel)  -> combine_lanes_kernel
//
// K5: out[i, :] = x[idx[i], :], and a zero row for an index outside
// [0, N) (the reference points pad indices at a zero row N-1 that its
// caller appends; the port's callers still append it).  The MoE layer
// stacks its EP lanes on one card and offsets each lane's indices into the
// lane-stacked row table, so one launch packs every lane.
// K6 over G stacked lanes: buf [G, R, D], idx and w [G, N, K],
//   out[g, n, :] = sum_k w[g, n, k] * buf[g, idx[g, n, k], :]
// accumulated in fp32 in ascending k and cast once to buf's type.  An index
// outside [0, R) -- the MoE layer's dropped-pair sentinel R -- adds exactly
// zero whatever its weight, and the kernel loads no row for it: the TPU
// kernel reads a zero row appended to its resident table, which on the card
// cost the caller a copy of every lane's table a layer.  The kernel adds
// each lane's row offset g * R itself.  It is a gather over the K rows a
// token reads, never a scatter-add, so no two threads write one element.
//
// Bound.  Both move bytes and do almost no arithmetic.  K5 reads M rows and
// writes M rows; on the served path (DeepSeek-V2-Lite, d_model 2048, bf16,
// 8 lanes) the prefill send pack moves 8 * 64 * 32 rows of 4 KB each way,
// about 134 MB, some 40 us at 3.35 TB/s.  K6 reads the real rows its tokens
// name and writes one row a token: K = 6 in DeepSeek-V2-Lite, under 1 flop a
// byte.  A decode step's call reads 48 rows of 4 KB (0.23 MB, 0.0001 ms at
// 3.35 TB/s), so its time is the latency of its loads, not their bytes.
// The design answers both sizes.  A thread owns one 16-byte chunk of one
// token's output row (the path's rows are 2048 bf16: 256 chunks a row), so
// a decode call of 8 tokens runs 2048 threads over 16 blocks and a prefill
// call of 1600 tokens 3200 blocks: a small call still spreads over the
// card.  A thread reads its token's K indices and weights (the same
// addresses for every thread of the token: one broadcast from L1), then
// issues all its row loads, up to KMAX of them, before the first multiply,
// then accumulates them in order: one index latency and one row latency a
// thread, not K of each back to back.  K above KMAX runs in groups of
// KMAX, in order.  On the 16-byte path the row loads are cp.async copies
// into shared memory, which hold no registers while in flight: 40
// registers a thread and 12 blocks an SM, where loads into registers took
// 78 and fit fewer, and read slower at prefill size (both, and a
// grid-stride variant, timed on one card: PERF.md section 6).
// Rows that are not 16-byte aligned go through registers, one element a
// thread.  Hopper has no TMA row gather, and at decode size the limit is
// latency, not issue slots.  Measured by chip_smoke.py from a cold L2 on
// NVIDIA H100 80GB HBM3, 700.00 W: the decode call 0.0026 ms (torch's
// embedding_bag 0.0047, the one-block-a-token kernel before it 0.0059),
// the prefill call 0.0120-0.0122 ms against its 0.0098 ms bound, 80-82 %
// (the kernel before it 0.0131-0.0132).
//
// Both kernels follow one index rule, as their plain versions do: an index
// outside [0, N) (K5) or [0, R) (K6) reads a zero row and loads nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include "kernel_attrs.cuh"

#include <algorithm>

namespace {

constexpr int kThreads = 128;
// K6: the rows a thread keeps in flight; a larger K runs in groups of it.
constexpr int kKmax = 8;
// K6's blocks an SM: 16 KB of stage each at most, and the registers
// bounded to fit them.
constexpr int kCombineBlocksPerSm = 12;

// K5 over raw rows: V is the unit each thread copies (uint4, uint32_t,
// uint16_t or uint8_t), row_units the row's length in units.
// An index outside [0, N) writes a zero row and reads nothing of x.
template <typename V>
__global__ void gather_rows_kernel(const V* __restrict__ x,
                                   const int* __restrict__ idx,
                                   V* __restrict__ out, int N,
                                   int row_units) {
  const long long i = blockIdx.x;
  const int r = __ldg(idx + i);
  const long long dst = i * row_units;
  if ((unsigned)r < (unsigned)N) {
    const long long src = (long long)r * row_units;
    for (int u = threadIdx.x; u < row_units; u += blockDim.x) {
      out[dst + u] = __ldg(x + src + u);
    }
  } else {
    const V zero{};
    for (int u = threadIdx.x; u < row_units; u += blockDim.x) {
      out[dst + u] = zero;
    }
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_float(float a, float* o) { *o = a; }
__device__ __forceinline__ void from_float(float a, __nv_bfloat16* o) {
  *o = __float2bfloat16(a);
}

// The indices and weights of one group of up to kKmax of token t's K;
// past K a sentinel, so every row load is predicated on one compare.
__device__ __forceinline__ void load_group(const int* __restrict__ idx,
                                           const float* __restrict__ w,
                                           int t, int k0, int K, int R,
                                           int (&r)[kKmax],
                                           float (&wk)[kKmax]) {
  const long long base = (long long)t * K + k0;
#pragma unroll
  for (int j = 0; j < kKmax; ++j) {
    const bool in = k0 + j < K;
    r[j] = in ? __ldg(idx + base + j) : R;
    wk[j] = in ? __ldg(w + base + j) : 0.0f;
  }
}

// K6: a thread per VEC-element chunk of one token's output row (VEC *
// sizeof(T) == 16 on the vector path, VEC == 1 on the scalar path); tokens
// lane-major, t = g * N + n, `chunks` chunks a row, `items` in all.  On the
// vector path the rows go to shared memory by cp.async, which holds no
// registers while in flight, so that kCombineBlocksPerSm blocks fit an SM;
// `stage` holds a block's chunks of one group, [kKmax][kThreads] 16-byte
// slots (as many rows as the group has).  The scalar path loads into
// registers.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kCombineBlocksPerSm)
combine_lanes_kernel(const T* __restrict__ buf, const int* __restrict__ idx,
                     const float* __restrict__ w, T* __restrict__ out,
                     int N, int K, int R, int D, int chunks, int items) {
  constexpr bool kStaged = VEC * sizeof(T) == 16;
  extern __shared__ uint4 stage[];
  // items = G * N * chunks <= the output's elements, below 2^31
  const unsigned gid = blockIdx.x * kThreads + threadIdx.x;
  if (gid >= (unsigned)items) return;
  const int t = (int)gid / chunks;
  const int e = ((int)gid - t * chunks) * VEC;
  const T* lane = buf + (long long)(t / N) * R * D + e;
  float acc[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c) acc[c] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kKmax) {
    int r[kKmax];
    float wk[kKmax];
    load_group(idx, w, t, k0, K, R, r, wk);
    // every real row's chunk of the group in flight before a multiply
    alignas(16) T vals[kStaged ? 1 : kKmax][VEC];
#pragma unroll
    for (int j = 0; j < kKmax; ++j) {
      if ((unsigned)r[j] < (unsigned)R) {
        const T* src = lane + (long long)r[j] * D;
        if constexpr (kStaged) {
          const unsigned dst = (unsigned)__cvta_generic_to_shared(
              stage + j * kThreads + threadIdx.x);
          // "memory": no shared-memory access of this thread moves
          // across the copy's issue or its wait
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                       :: "r"(dst), "l"(src) : "memory");
        } else {
#pragma unroll
          for (int c = 0; c < VEC; ++c) vals[j][c] = src[c];
        }
      }
    }
    if constexpr (kStaged) asm volatile("cp.async.wait_all;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < kKmax; ++j) {
      if ((unsigned)r[j] < (unsigned)R) {
        if constexpr (kStaged) {
          *reinterpret_cast<uint4*>(vals[0]) =
              stage[j * kThreads + threadIdx.x];
        }
        const T* v = vals[kStaged ? 0 : j];
#pragma unroll
        for (int c = 0; c < VEC; ++c) acc[c] += wk[j] * to_float(v[c]);
      }
    }
  }
  alignas(16) T res[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c) from_float(acc[c], &res[c]);
  T* dst = out + (long long)t * D + e;
  if constexpr (kStaged) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<uint4*>(res);
  } else {
#pragma unroll
    for (int c = 0; c < VEC; ++c) dst[c] = res[c];
  }
}

template <typename V>
int launch_gather(const void* x, const int* idx, void* out, int M, int N,
                  int row_bytes, cudaStream_t stream) {
  const int units = row_bytes / (int)sizeof(V);
  gather_rows_kernel<V><<<M, kThreads, 0, stream>>>(
      static_cast<const V*>(x), idx, static_cast<V*>(out), N, units);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_combine_vec(const void* buf, const int* idx, const float* w,
                       void* out, int GN, int N, int K, int R, int D,
                       cudaStream_t stream) {
  const int chunks = D / VEC;
  const int items = GN * chunks;
  const int blocks = items / kThreads + (items % kThreads != 0);
  const size_t smem = VEC * sizeof(T) == 16
      ? (size_t)std::min(K, kKmax) * kThreads * sizeof(uint4) : 0;
  combine_lanes_kernel<T, VEC><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(buf), idx, w, static_cast<T*>(out), N, K, R, D,
      chunks, items);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_combine(const void* buf, const int* idx, const float* w,
                   void* out, int G, int N, int K, int R, int D, int vector,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (vector) {
    return launch_combine_vec<T, kVec>(buf, idx, w, out, G * N, N, K, R, D,
                                       stream);
  }
  return launch_combine_vec<T, 1>(buf, idx, w, out, G * N, N, K, R, D,
                                  stream);
}

// ------------------------------------------------- attributes (verify)

// Every kernel of this source at its launch: K5 at kThreads; K6 at
// kThreads with, on the staged path, kKmax groups of stage (its largest),
// kCombineBlocksPerSm blocks an SM promised by its __launch_bounds__.
const repro_attrs::KernelEntry* kernel_table(int* n) {
  constexpr int kStage = kKmax * kThreads * (int)sizeof(uint4);
  static const repro_attrs::KernelEntry table[] = {
      {"gather_rows_kernel<16>", (const void*)gather_rows_kernel<uint4>,
       kThreads, 0, 0},
      {"gather_rows_kernel<4>", (const void*)gather_rows_kernel<uint32_t>,
       kThreads, 0, 0},
      {"gather_rows_kernel<2>", (const void*)gather_rows_kernel<uint16_t>,
       kThreads, 0, 0},
      {"gather_rows_kernel<1>", (const void*)gather_rows_kernel<uint8_t>,
       kThreads, 0, 0},
      {"combine_lanes_kernel<bf16,8>",
       (const void*)combine_lanes_kernel<__nv_bfloat16, 8>, kThreads, kStage,
       kCombineBlocksPerSm},
      {"combine_lanes_kernel<bf16,1>",
       (const void*)combine_lanes_kernel<__nv_bfloat16, 1>, kThreads, 0,
       kCombineBlocksPerSm},
      {"combine_lanes_kernel<f32,4>",
       (const void*)combine_lanes_kernel<float, 4>, kThreads, kStage,
       kCombineBlocksPerSm},
      {"combine_lanes_kernel<f32,1>",
       (const void*)combine_lanes_kernel<float, 1>, kThreads, 0,
       kCombineBlocksPerSm}};
  *n = (int)(sizeof(table) / sizeof(table[0]));
  return table;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K5: x [N, row_bytes], idx [M] -> out [M, row_bytes].  unit: bytes each
// thread copies per step (16, 4, 2 or 1); the wrapper picks the widest
// that divides row_bytes and both pointers' alignment.
int repro_gather_rows(const void* x, const int* idx, void* out, int M, int N,
                      int row_bytes, int unit, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 16: return launch_gather<uint4>(x, idx, out, M, N, row_bytes, s);
    case 4: return launch_gather<uint32_t>(x, idx, out, M, N, row_bytes, s);
    case 2: return launch_gather<uint16_t>(x, idx, out, M, N, row_bytes, s);
    case 1: return launch_gather<uint8_t>(x, idx, out, M, N, row_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K6 over G lanes: buf [G, R, D], idx / w [G, N, K] -> out [G, N, D].
// vector: 16-byte loads and stores (D * sizeof(T) % 16 == 0 and the
// pointers 16-byte aligned, checked by the wrapper).
int repro_combine_lanes_bf16(const void* buf, const int* idx, const float* w,
                             void* out, int G, int N, int K, int R, int D,
                             int vector, void* stream) {
  return launch_combine<__nv_bfloat16>(buf, idx, w, out, G, N, K, R, D,
                                       vector,
                                       static_cast<cudaStream_t>(stream));
}

int repro_combine_lanes_f32(const void* buf, const int* idx, const float* w,
                            void* out, int G, int N, int K, int R, int D,
                            int vector, void* stream) {
  return launch_combine<float>(buf, idx, w, out, G, N, K, R, D, vector,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"

REPRO_KERNEL_ATTRIBUTES(kernel_table)
