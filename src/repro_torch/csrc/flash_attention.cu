// Online-softmax attention K7 for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::flash_attention_bh
// (_attn_kernel): attention over flattened (batch * heads) rows,
// q [BH, Tq, D], k / v [BH, Tk, D], with an explicit scale, the causal
// mask (key <= q_offset + row), the sliding window (key > q_pos - window),
// the padding mask (key < kv_len) and q_offset for decode.  The running
// max m, the running sum l and the accumulator are fp32 whatever the input
// type; the output is written once, in the input type.  A row whose every
// key is masked has l == 0 and outputs exactly 0.
//
// Layout of the work.  The Pallas kernel's sequential KV grid dim, which
// carried (m, l, acc) in VMEM scratch, becomes a loop inside the block.  A
// block of 4 warps owns 16 query rows of one (batch, head), 4 rows a warp;
// it walks the key tiles that any of its rows can see (tiles past kv_len,
// past the causal bound of its last row, or before the window of its first
// row are skipped), staging each tile of 32 keys of K and V in shared
// memory.  Lane j scores key j of the tile against the warp's 4 rows (the
// query rows sit in shared memory as fp32 and are read as broadcasts), the
// warp reduces the tile's max and sum with shuffles, and each lane
// accumulates D / 32 output dims of each row.  D is a template parameter,
// built for 64, 128, 192 and 256: MLA's 192 (128 nope + 64 rope, v
// zero-padded to 192 by the caller) and the GQA models' 64 / 128 / 256;
// the wrapper pads any other head dim up to the next of these.
// The K tile's rows are padded by one 32-bit word so that 32 lanes reading
// 32 different key rows hit 32 different banks.
//
// Bound.  In prefill the work is D multiply-adds twice for every visible
// (query, key) pair: DeepSeek-V2-Lite's MLA at 16 heads, d 192 and a
// 400-token prompt does some 4 GFLOP a layer, a few microseconds at the
// tensor cores' 989 TFLOP/s, and the bytes (q, k, v, out) are fewer still.
// This first kernel runs on the CUDA cores in fp32 (67 TFLOP/s), so it is
// bound by its own arithmetic; wgmma tiles fed by TMA are later work.  In
// decode (one query row per (batch, head)) it reads the visible K and V
// once: bound by bytes, and by the 64 blocks that one decode step gives it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeys = 32;                     // keys per tile, one per lane
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float a, float* o) { *o = a; }
__device__ __forceinline__ void store(float a, __nv_bfloat16* o) {
  *o = __float2bfloat16(a);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFull, v, off);
  }
  return v;
}

// Elements of padding on each staged K row: one 32-bit word.
template <typename T>
constexpr int kPad = 4 / (int)sizeof(T);

template <typename T, int D>
constexpr int smem_bytes() {
  return kRows * D * 4 + kKeys * D * (int)sizeof(T) +
         kKeys * (D + kPad<T>) * (int)sizeof(T);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int Tq, int Tk, float scale,
    int causal, int window, int kv_len, int q_offset) {
  constexpr int KS = D + kPad<T>;  // staged K row stride, elements
  constexpr int DL = D / 32;          // output dims per lane
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kVecs = D / kVec;     // 16-byte vectors per row
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);           // [kRows][D]
  T* vs = reinterpret_cast<T*>(qs + kRows * D);         // [kKeys][D]
  T* ks = vs + kKeys * D;                               // [kKeys][KS]

  const long long bh = blockIdx.x;
  const int q0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* qb = q + bh * Tq * D;
  const T* kb = k + bh * Tk * D;
  const T* vb = v + bh * Tk * D;

  for (int e = threadIdx.x; e < kRows * D; e += kThreads) {
    const int r = q0 + e / D;
    qs[e] = r < Tq ? to_float(qb[(long long)r * D + e % D]) : 0.0f;
  }

  // the keys any row of this block can see
  const int q_last = min(q0 + kRows, Tq) - 1;
  const int k_lim = min(kv_len, Tk);
  int k_end = k_lim;
  if (causal) k_end = min(k_end, q_offset + q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q_offset + q0 - window + 1);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < DL; ++c) acc[r][c] = 0.0f;
  }

  for (int t0 = (k_begin / kKeys) * kKeys; t0 < k_end; t0 += kKeys) {
    __syncthreads();  // the previous tile is consumed, qs is staged
    for (int e = threadIdx.x; e < kKeys * kVecs; e += kThreads) {
      const int j = e / kVecs;
      const int c = (e % kVecs) * kVec;
      const int key = t0 + j;
      uint4 kk = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (key < Tk) {
        kk = __ldg(reinterpret_cast<const uint4*>(kb + (long long)key * D + c));
        vv = __ldg(reinterpret_cast<const uint4*>(vb + (long long)key * D + c));
      }
      *reinterpret_cast<uint4*>(vs + j * D + c) = vv;
      unsigned* kd = reinterpret_cast<unsigned*>(ks + j * KS + c);
      kd[0] = kk.x;
      kd[1] = kk.y;
      kd[2] = kk.z;
      kd[3] = kk.w;
    }
    __syncthreads();

    // scores of key t0 + lane against the warp's rows
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.0f;
    const T* kr = ks + lane * KS;
    const float* qw = qs + warp * kRowsPerWarp * D;
    if constexpr (sizeof(T) == 2) {
#pragma unroll 4
      for (int c = 0; c < D; c += 2) {
        const float2 kf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(kr + c));
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float2 qf = *reinterpret_cast<const float2*>(qw + r * D + c);
          s[r] += qf.x * kf.x + qf.y * kf.y;
        }
      }
    } else {
#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        const float kf = to_float(kr[c]);
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) s[r] += qw[r * D + c] * kf;
      }
    }

    const int key = t0 + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qp = q_offset + q0 + warp * kRowsPerWarp + r;
      const bool ok = key < k_lim && (!causal || key <= qp) &&
                      (window <= 0 || key > qp - window);
      const float sc = ok ? s[r] * scale : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sc));
      float corr = 1.0f;
      p[r] = 0.0f;
      if (m_new != -INFINITY) {  // some key of the row is visible so far
        p[r] = ok ? expf(sc - m_new) : 0.0f;
        corr = expf(m[r] - m_new);
      }
      l[r] = l[r] * corr + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DL; ++c) acc[r][c] *= corr;
    }
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      float vj[DL];
#pragma unroll
      for (int c = 0; c < DL; ++c) vj[c] = to_float(vs[j * D + lane + 32 * c]);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pj = __shfl_sync(kFull, p[r], j);
#pragma unroll
        for (int c = 0; c < DL; ++c) acc[r][c] += pj * vj[c];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + warp * kRowsPerWarp + r;
    if (row >= Tq) continue;
    T* orow = o + (bh * Tq + row) * D;
#pragma unroll
    for (int c = 0; c < DL; ++c) {
      store(l[r] > 0.0f ? acc[r][c] / l[r] : 0.0f, orow + lane + 32 * c);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int Tq, int Tk, float scale, int causal, int window, int kv_len,
           int q_offset, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T, D>();
  auto kernel = flash_attention_kernel<T, D>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  dim3 grid(BH, (Tq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Tq, Tk, scale, causal,
      window, kv_len, q_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int BH,
             int Tq, int Tk, int D, float scale, int causal, int window,
             int kv_len, int q_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_ATTN_CASE(DIM)                                               \
  case DIM:                                                                \
    return launch<T, DIM>(q, k, v, o, BH, Tq, Tk, scale, causal, window, \
                          kv_len, q_offset, s);
  switch (D) {
    REPRO_ATTN_CASE(64)
    REPRO_ATTN_CASE(128)
    REPRO_ATTN_CASE(192)
    REPRO_ATTN_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_ATTN_CASE
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K7 on [BH, Tq, D] / [BH, Tk, D] rows; D one of 64, 128, 192, 256 (the
// wrapper pads other head dims with zeros).
int repro_flash_attention_bh_bf16(const void* q, const void* k,
                                  const void* v, void* o, int BH, int Tq,
                                  int Tk, int D, float scale, int causal,
                                  int window, int kv_len, int q_offset,
                                  void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, BH, Tq, Tk, D, scale, causal,
                                 window, kv_len, q_offset, stream);
}

int repro_flash_attention_bh_f32(const void* q, const void* k, const void* v,
                                 void* o, int BH, int Tq, int Tk, int D,
                                 float scale, int causal, int window,
                                 int kv_len, int q_offset, void* stream) {
  return dispatch<float>(q, k, v, o, BH, Tq, Tk, D, scale, causal, window,
                         kv_len, q_offset, stream);
}

}  // extern "C"
