// Mamba-2 SSD chunked scan K8 for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/ssd_scan/ssd_scan.py::ssd_scan_h (_ssd_kernel).  Per
// (batch, head), with l_t the running sum of dt_u * A over the chunk up to
// and including step t:
//   intra-chunk:  y[t]  = sum_{s<=t} (C_t . B_s) exp(l_t - l_s) dt_s x_s
//   inter-chunk:  y[t] += exp(l_t) C_t S_prev
//   state update: S = exp(l_L) S_prev + sum_s exp(l_L - l_s) dt_s B_s (x) x_s
// The state S [N, P] is fp32 and carried across the chunks in order; all
// arithmetic is fp32 and y is rounded once, to x's type, on store.
//
// Layout of the work.  The kernel takes the model's own layout: x and y
// [Bt, T, H, P], dt [Bt, T, H] and B / C [Bt, T, G, N], with A [H].  It
// reads the group of head h as h / (H / G) and bounds the ragged last
// chunk itself, so the caller makes none of the Pallas wrapper's copies
// (B and C repeated over heads, heads moved to the front, T padded).  The
// Pallas grid (heads, chunks), whose sequential chunk dim carried the
// state in VMEM scratch, becomes one block per (batch, head) that walks
// the chunks in a loop with the state in shared memory: a prefill of 4
// slots of zamba2-7b gives 448 blocks on 132 SMs.  Per chunk of kChunk
// steps the block stages x, B, C and dt in shared memory as fp32 (zero
// past the ragged end, where dt = 0 decays nothing and adds nothing),
// takes l by an in-block prefix sum, builds the [L, L] intra-chunk matrix
// M over the pairs s <= t only (so the exponent l_t - l_s is never
// positive; the masked pairs are never exponentiated), then writes
// y = M x + exp(l_t) C S_prev, and last updates S.  Each thread owns one
// column p of y and of S and a strided set of rows, so every shared read
// in the two products is a broadcast or a run of consecutive words; the
// rows of B, C and M carry one word of padding, so 32 lanes reading 32
// rows of B hit 32 banks.  The kernel's chunk (64) is its own choice: any
// chunk computes the same function.
//
// Bound.  Bytes: x and y once each, plus dt, B and C; for zamba2-7b's
// prefill (Bt 4, T about 430, H 112, P 64, N 64, bf16) some 50 MB, about
// 15 us at 3.35 TB/s.  Operations: 2 L^2 N + 2 L^2 P + 4 L N P a chunk of
// L per (batch, head), some 10 GFLOP at L = 128, about 10 us on the tensor
// cores.  This first kernel runs on the CUDA cores in fp32 out of shared
// memory, so it is bound by its own shared-memory traffic; tensor cores
// for C B^T and M x, TMA staging and a split over chunks with a second
// pass for the state are later work.
//
// Shared memory: S [N][P] plus x [L][P], B and C [L][N + 1], M [L][L + 1]
// and three [L] vectors, in fp32: 83,456 bytes for N = 64 and 132,608 for
// N = 128 at P = 64, above the 48 KB default, so the launcher opts in.
// Two blocks fit an SM at N = 64 (the launch bounds cap the registers at
// 128 a thread to match), one at N = 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;        // time steps per chunk, L

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float a, float* o) { *o = a; }
__device__ __forceinline__ void store(float a, __nv_bfloat16* o) {
  *o = __float2bfloat16(a);
}

// Floats of dynamic shared memory for head dim P and state dim N.
constexpr int smem_floats(int P, int N) {
  return N * P                    // S, the carried state [N][P]
         + kChunk * P             // x of the chunk [L][P]
         + 2 * kChunk * (N + 1)   // B and C of the chunk [L][N + 1]
         + kChunk * (kChunk + 1)  // M, the intra-chunk matrix [L][L + 1]
         + 3 * kChunk;            // l, dt and the state-update weights w
}

template <typename E, int P, int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_kernel(const E* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const E* __restrict__ Bm,
                const E* __restrict__ Cm, E* __restrict__ y, int T, int H,
                int G) {
  static_assert(kThreads % P == 0, "a pass of the block covers whole rows");
  constexpr int kRows = kThreads / P;     // rows one pass of the block owns
  static_assert(kChunk % kRows == 0 && N % kRows == 0, "rows per thread");
  static_assert(kChunk <= kThreads, "one thread per step of the chunk");
  constexpr int kYRows = kChunk / kRows;  // rows of y per thread
  constexpr int kSRows = N / kRows;       // rows of S per thread
  constexpr int kNB = N + 1;              // padded rows of B and C
  constexpr int kLM = kChunk + 1;         // padded rows of M

  extern __shared__ float smem[];
  float* S = smem;
  float* xs = S + N * P;
  float* Bs = xs + kChunk * P;
  float* Cs = Bs + kChunk * kNB;
  float* M = Cs + kChunk * kNB;
  float* l = M + kChunk * kLM;
  float* dts = l + kChunk;
  float* w = dts + kChunk;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int g = h / (H / G);
  const float a = A[h];
  const long long x_row = (long long)H * P;     // x / y: one time step
  const long long bc_row = (long long)G * N;    // B / C: one time step
  const E* xb = x + (long long)b * T * x_row + (long long)h * P;
  E* yb = y + (long long)b * T * x_row + (long long)h * P;
  const E* Bb = Bm + (long long)b * T * bc_row + (long long)g * N;
  const E* Cb = Cm + (long long)b * T * bc_row + (long long)g * N;
  const float* dtb = dt + (long long)b * T * H + h;

  const int p = tid % P;     // the column of y and S this thread owns
  const int r0 = tid / P;    // its first row; the others follow kRows apart

  for (int i = tid; i < N * P; i += kThreads) S[i] = 0.0f;

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int len = min(kChunk, T - t0);
    if (tid < kChunk) {
      const float d = tid < len ? dtb[(long long)(t0 + tid) * H] : 0.0f;
      dts[tid] = d;
      l[tid] = d * a;
    }
    for (int i = tid; i < kChunk * P; i += kThreads) {
      const int t = i / P, c = i - t * P;
      xs[i] = t < len ? to_float(xb[(long long)(t0 + t) * x_row + c]) : 0.0f;
    }
    for (int i = tid; i < kChunk * N; i += kThreads) {
      const int t = i / N, n = i - t * N;
      const long long off = (long long)(t0 + t) * bc_row + n;
      Bs[t * kNB + n] = t < len ? to_float(Bb[off]) : 0.0f;
      Cs[t * kNB + n] = t < len ? to_float(Cb[off]) : 0.0f;
    }
    __syncthreads();
    // l: inclusive prefix sum over the chunk (Hillis-Steele)
    for (int off = 1; off < kChunk; off <<= 1) {
      float v = 0.0f;
      if (tid < kChunk) v = l[tid] + (tid >= off ? l[tid - off] : 0.0f);
      __syncthreads();
      if (tid < kChunk) l[tid] = v;
      __syncthreads();
    }
    const float l_last = l[kChunk - 1];
    if (tid < kChunk) w[tid] = expf(l_last - l[tid]) * dts[tid];
    // M[t][s] = (C_t . B_s) exp(l_t - l_s) dt_s over s <= t, else 0
    for (int i = tid; i < kChunk * kChunk; i += kThreads) {
      const int t = i / kChunk, s = i - t * kChunk;
      float m = 0.0f;
      if (s <= t) {
        float dot = 0.0f;
#pragma unroll 8
        for (int n = 0; n < N; ++n) dot += Cs[t * kNB + n] * Bs[s * kNB + n];
        m = dot * expf(l[t] - l[s]) * dts[s];
      }
      M[t * kLM + s] = m;
    }
    __syncthreads();
    // y[t][p] = sum_s M[t][s] x[s][p] + exp(l_t) sum_n C[t][n] S_prev[n][p]
    {
      float intra[kYRows], inter[kYRows];
#pragma unroll
      for (int k = 0; k < kYRows; ++k) intra[k] = inter[k] = 0.0f;
      for (int s = 0; s < kChunk; ++s) {
        const float xv = xs[s * P + p];
#pragma unroll
        for (int k = 0; k < kYRows; ++k) {
          intra[k] += M[(r0 + k * kRows) * kLM + s] * xv;
        }
      }
      for (int n = 0; n < N; ++n) {
        const float sv = S[n * P + p];
#pragma unroll
        for (int k = 0; k < kYRows; ++k) {
          inter[k] += Cs[(r0 + k * kRows) * kNB + n] * sv;
        }
      }
#pragma unroll
      for (int k = 0; k < kYRows; ++k) {
        const int t = r0 + k * kRows;
        if (t < len) {
          store(intra[k] + expf(l[t]) * inter[k],
                yb + (long long)(t0 + t) * x_row + p);
        }
      }
    }
    __syncthreads();   // every read of S_prev is done
    // S = exp(l_L) S_prev + sum_s w_s B_s (x) x_s, w_s = exp(l_L - l_s) dt_s
    {
      const float decay = expf(l_last);
      float acc[kSRows];
#pragma unroll
      for (int k = 0; k < kSRows; ++k) {
        acc[k] = decay * S[(r0 + k * kRows) * P + p];
      }
      for (int s = 0; s < kChunk; ++s) {
        const float xv = xs[s * P + p] * w[s];
#pragma unroll
        for (int k = 0; k < kSRows; ++k) {
          acc[k] += Bs[s * kNB + r0 + k * kRows] * xv;
        }
      }
#pragma unroll
      for (int k = 0; k < kSRows; ++k) S[(r0 + k * kRows) * P + p] = acc[k];
    }
    __syncthreads();   // S is updated; the chunk's staging may be reused
  }
}

template <typename E, int P, int N>
int launch(const void* x, const float* dt, const float* A, const void* B,
           const void* C, void* y, int Bt, int T, int H, int G,
           cudaStream_t stream) {
  constexpr int bytes = (int)sizeof(float) * smem_floats(P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<E, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();   // clear it: the launch below is not made
    return (int)err;
  }
  ssd_scan_kernel<E, P, N><<<Bt * H, kThreads, bytes, stream>>>(
      static_cast<const E*>(x), dt, A, static_cast<const E*>(B),
      static_cast<const E*>(C), static_cast<E*>(y), T, H, G);
  return (int)cudaGetLastError();
}

// The (P, N) the source is built for: zamba2-7b's (64, 64) and
// mamba2-780m's (64, 128).
template <typename E>
int dispatch(const void* x, const float* dt, const float* A, const void* B,
             const void* C, void* y, int Bt, int T, int H, int G, int P,
             int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P == 64 && N == 64) {
    return launch<E, 64, 64>(x, dt, A, B, C, y, Bt, T, H, G, s);
  }
  if (P == 64 && N == 128) {
    return launch<E, 64, 128>(x, dt, A, B, C, y, Bt, T, H, G, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K8: x / y [Bt, T, H, P] and B / C [Bt, T, G, N] in bf16, dt [Bt, T, H]
// and A [H] in fp32; all contiguous (checked by the wrapper).
int repro_ssd_scan_bf16(const void* x, const float* dt, const float* A,
                        const void* B, const void* C, void* y, int Bt, int T,
                        int H, int G, int P, int N, void* stream) {
  return dispatch<__nv_bfloat16>(x, dt, A, B, C, y, Bt, T, H, G, P, N,
                                 stream);
}

// K8 with x, y, B and C in fp32.
int repro_ssd_scan_f32(const void* x, const float* dt, const float* A,
                       const void* B, const void* C, void* y, int Bt, int T,
                       int H, int G, int P, int N, void* stream) {
  return dispatch<float>(x, dt, A, B, C, y, Bt, T, H, G, P, N, stream);
}

}  // extern "C"
