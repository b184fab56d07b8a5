// MoE dispatch pack and combine kernels K5, K6 for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of
// src/repro/kernels/moe_pack/moe_pack.py:
//   K5 gather_rows   (_pack_kernel)     -> gather_rows_kernel
//   K6 combine_rows  (_combine_kernel)  -> combine_rows_kernel
//
// K5: out[i, :] = x[idx[i], :].  The caller appends a zero row to x and
// points pad indices at it (the reference's "zero row N-1").  The MoE layer
// stacks its EP lanes on one card and offsets each lane's indices into the
// lane-stacked row table, so one launch packs every lane.
// K6: out[t, :] = sum_k w[t, k] * buf[idx[t, k], :], accumulated in fp32 in
// ascending k and cast once to buf's type.  It is a gather over the K rows
// a token reads, never a scatter-add, so no two blocks write one row.
//
// Bound.  Both move bytes and do almost no arithmetic.  K5 reads M rows and
// writes M rows; on the served path (DeepSeek-V2-Lite, d_model 2048, bf16,
// 8 lanes) the prefill send pack moves 8 * 64 * 32 rows of 4 KB each way,
// about 134 MB, some 40 us at 3.35 TB/s.  K6 reads the K rows of every token
// and writes one: K = 6 in DeepSeek-V2-Lite, 1 flop per byte read at most.
// The design answers with what a simple kernel can do: one thread block per
// output row, 16-byte loads and stores where the row and the pointers allow
// (the wrapper checks), each source row read once per output row, the index
// and weight of each k read once per thread from L1.  Gathering several rows
// per block through cp.async or TMA is left to later work.
//
// Indices are not range-checked on the card: the MoE packing produces them
// in range, and the plain versions raise on an index out of range.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// K5 over raw rows: V is the unit each thread copies (uint4, uint32_t,
// uint16_t or uint8_t), row_units the row's length in units.
template <typename V>
__global__ void gather_rows_kernel(const V* __restrict__ x,
                                   const int* __restrict__ idx,
                                   V* __restrict__ out, int row_units) {
  const long long i = blockIdx.x;
  const long long src = (long long)__ldg(idx + i) * row_units;
  const long long dst = i * row_units;
  for (int u = threadIdx.x; u < row_units; u += blockDim.x) {
    out[dst + u] = __ldg(x + src + u);
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

// K6: VEC elements of T per thread and step (VEC * sizeof(T) == 16 on the
// vector path, 1 on the scalar path).
template <typename T, int VEC>
__global__ void combine_rows_kernel(const T* __restrict__ buf,
                                    const int* __restrict__ idx,
                                    const float* __restrict__ w,
                                    T* __restrict__ out, int K, int D) {
  const long long t = blockIdx.x;
  const int* it = idx + t * K;
  const float* wt = w + t * K;
  for (int e = threadIdx.x * VEC; e < D; e += blockDim.x * VEC) {
    float acc[VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[c] = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float wk = __ldg(wt + k);
      const T* row = buf + (long long)__ldg(it + k) * D + e;
      alignas(16) T vals[VEC];
      if constexpr (VEC * sizeof(T) == 16) {
        *reinterpret_cast<uint4*>(vals) =
            __ldg(reinterpret_cast<const uint4*>(row));
      } else {
#pragma unroll
        for (int c = 0; c < VEC; ++c) vals[c] = row[c];
      }
#pragma unroll
      for (int c = 0; c < VEC; ++c) acc[c] += wk * to_float(vals[c]);
    }
    alignas(16) T res[VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c) from_float(acc[c], &res[c]);
    T* dst = out + t * D + e;
    if constexpr (VEC * sizeof(T) == 16) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<uint4*>(res);
    } else {
#pragma unroll
      for (int c = 0; c < VEC; ++c) dst[c] = res[c];
    }
  }
}

template <typename V>
int launch_gather(const void* x, const int* idx, void* out, int M,
                  int row_bytes, cudaStream_t stream) {
  const int units = row_bytes / (int)sizeof(V);
  gather_rows_kernel<V><<<M, kThreads, 0, stream>>>(
      static_cast<const V*>(x), idx, static_cast<V*>(out), units);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_combine(const void* buf, const int* idx, const float* w,
                   void* out, int T_, int K, int D, int vector,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (vector) {
    combine_rows_kernel<T, kVec><<<T_, kThreads, 0, stream>>>(
        static_cast<const T*>(buf), idx, w, static_cast<T*>(out), K, D);
  } else {
    combine_rows_kernel<T, 1><<<T_, kThreads, 0, stream>>>(
        static_cast<const T*>(buf), idx, w, static_cast<T*>(out), K, D);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K5.  unit: bytes each thread copies per step (16, 4, 2 or 1); the wrapper
// picks the widest that divides row_bytes and both pointers' alignment.
int repro_gather_rows(const void* x, const int* idx, void* out, int M,
                      int row_bytes, int unit, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 16: return launch_gather<uint4>(x, idx, out, M, row_bytes, s);
    case 4: return launch_gather<uint32_t>(x, idx, out, M, row_bytes, s);
    case 2: return launch_gather<uint16_t>(x, idx, out, M, row_bytes, s);
    case 1: return launch_gather<uint8_t>(x, idx, out, M, row_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K6.  vector: 16-byte loads and stores (D * sizeof(T) % 16 == 0 and the
// pointers 16-byte aligned, checked by the wrapper).
int repro_combine_rows_bf16(const void* buf, const int* idx, const float* w,
                            void* out, int T, int K, int D, int vector,
                            void* stream) {
  return launch_combine<__nv_bfloat16>(buf, idx, w, out, T, K, D, vector,
                                       static_cast<cudaStream_t>(stream));
}

int repro_combine_rows_f32(const void* buf, const int* idx, const float* w,
                           void* out, int T, int K, int D, int vector,
                           void* stream) {
  return launch_combine<float>(buf, idx, w, out, T, K, D, vector,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
