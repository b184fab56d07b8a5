// Mamba-2 SSD chunked scan K8 for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/ssd_scan/ssd_scan.py::ssd_scan_h (_ssd_kernel).  Per
// (batch, head), with l_t the running sum of dt_u * A over the chunk up to
// and including step t:
//   intra-chunk:  y[t]  = sum_{s<=t} (C_t . B_s) exp(l_t - l_s) dt_s x_s
//   inter-chunk:  y[t] += exp(l_t) C_t S_prev
//   state update: S = exp(l_L) S_prev + sum_s exp(l_L - l_s) dt_s B_s (x) x_s
// The state S [N, P] is fp32 and carried across the chunks in order; y is
// rounded once, to x's type, on store.
//
// Bound.  Bytes: x and y once each, plus dt, B and C: for zamba2-7b's
// prefill (Bt 4, T 400, H 112, P 64, N 64, bf16) 47 MB, 14 us at
// 3.35 TB/s.  Operations: some 10 GFLOP, 10 us on the tensor cores.  So
// the kernel has to keep the whole card busy with both, and the state and
// the [L, L] intra-chunk matrix out of device memory.
//
// Layout of the work.  One block per (batch, head) walks the chunks of
// kChunk = 64 steps in order with the head's fp32 state on the chip, so no
// state goes through device memory: zamba2-7b's prefill gives 448 blocks,
// two an SM.  Measured on the card, the scan is bound by the latency of
// its chain of dependent steps per chunk, not by bytes or by the tensor
// cores: blocks over slices of 16 columns of P (1,792 of them, four an
// SM, each recomputing the chunk's C B^T, decays and staging) ran slower
// than whole heads (PERF.md, section 6).  A chunk's x, B, C and dt are
// staged in shared memory by cp.async (zeros past the ragged end, where
// dt = 0 decays nothing and adds nothing), the next chunk's while this one
// is computed; B and C ([Bt, T, G, N], one group for all 112 heads) come
// from the L2.  Four warps each own 16 steps t of the chunk and N / 4 rows n of
// the state:
//   1. l: each warp scans dt * A over the chunk by shuffles (no block
//      barrier rounds) into its own copy in shared memory, in log2 units
//      so that every decay is one exp2; the block writes w x, with
//      w_s = exp(l_L - l_s) dt_s, to shared memory;
//   2. C B^T for its rows, the column tiles s <= t only; scaled in
//      registers to M[t][s] = (C_t . B_s) exp(l_t - l_s) dt_s over s <= t
//      (the masked pairs are never exponentiated, so the exponent is never
//      positive);
//   3. y = exp(l_t) C S_prev + M x, M feeding the product from registers;
//   4. after a block barrier (every read of S_prev done, w x written),
//      S = exp(l_L) S + B^T (w x), the warp's rows of the state kept in
//      registers across the chunks and stored for the next chunk's step 3.
// Two block barriers a chunk.  All four products run as 16 x 8 x 16 warp
// tiles (tile_mma.cuh): in bf16 on the tensor cores, an fp32 operand
// (M, S_prev, w x) split into two bf16 halves, so every product keeps its
// fp32 operand to about 2^-17 as the reference's fp32 products do; S and
// w x, which every warp reads, are split once where they are stored.  In
// float32 (the oracle replay's type) the same skeleton runs fp32 FMAs.
// The kernel's chunk (64) is its own choice: any chunk computes the same
// function.
//
// Shared memory per block: two stages of C and B [L][N + 16 bytes], x
// [L][P + 16 bytes] and dt [L]; the state [N][P + 16 bytes] and w x
// [L][P + 16 bytes], as bf16 hi and lo (one fp32 array in float32); four
// copies of l [L]: 93,696 bytes at (bf16, P 64, N 64), two blocks an SM;
// 144,896 at (bf16, N 128), one; 140,800 and 223,744 in float32.  128
// threads a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include "kernel_attrs.cuh"

#include "tile_mma.cuh"

namespace {

using tile::Frag;

constexpr int kChunk = 64;                 // time steps per chunk, L
constexpr int kWarps = kChunk / 16;        // 16 steps a warp
static_assert(kChunk == 64, "the scan gives each lane two steps");
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ void store2(float a, float b, float* o) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
__device__ __forceinline__ void store2(float a, float b, __nv_bfloat16* o) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}

template <typename E, int P, int N>
struct Smem {
  using T = typename tile::Staged<E>::T;            // staged fp32 operands
  static constexpr int kPad = 16 / (int)sizeof(E);  // 16 bytes a row
  static constexpr int kLdN = N + kPad;             // C and B row stride
  static constexpr int kLdX = P + kPad;             // x row stride
  static constexpr int kLdT = P + 16 / (int)sizeof(T);   // S, w x
  static constexpr int kStage =                     // bytes of one stage
      (2 * kChunk * kLdN + kChunk * kLdX) * (int)sizeof(E) + kChunk * 4;
  static constexpr int kArray = (N + kChunk) * kLdT;   // S, then w x
  static constexpr int kBytes =
      2 * kStage + tile::Staged<E>::kArrays * kArray * (int)sizeof(T) +
      kWarps * kChunk * 4;
};

template <typename E, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const E* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const E* __restrict__ Bm,
                const E* __restrict__ Cm, E* __restrict__ y, int T, int H,
                int G) {
  using Sm = Smem<E, P, N>;
  using TS = typename Sm::T;
  constexpr int kLdN = Sm::kLdN, kLdX = Sm::kLdX, kLdT = Sm::kLdT;
  constexpr int kVec = 16 / (int)sizeof(E);     // elements a 16-byte copy
  constexpr int kNT = N / 16;                   // k-steps over N
  constexpr int kMT = N / (16 * kWarps);        // state m-tiles a warp
  constexpr int kPT = P / 8;                    // n-tiles over P
  static_assert(N % (16 * kWarps) == 0 && P % 16 == 0, "shapes");

  extern __shared__ __align__(16) unsigned char smem[];
  auto Cs = [&](int s) {
    return reinterpret_cast<E*>(smem + s * Sm::kStage);
  };
  auto Bs = [&](int s) { return Cs(s) + kChunk * kLdN; };
  auto Xs = [&](int s) { return Bs(s) + kChunk * kLdN; };
  auto Ds = [&](int s) {
    return reinterpret_cast<float*>(Xs(s) + kChunk * kLdX);
  };
  // the state [N][kLdT] then w x [L][kLdT], hi (and in bf16 lo)
  TS* Shi = reinterpret_cast<TS*>(smem + 2 * Sm::kStage);
  TS* Slo = Shi + (tile::Staged<E>::kArrays - 1) * Sm::kArray;
  TS* Whi = Shi + N * kLdT;
  TS* Wlo = Slo + N * kLdT;
  float* lw = reinterpret_cast<float*>(
                  Shi + tile::Staged<E>::kArrays * Sm::kArray) +
              (threadIdx.x / 32) * kChunk;            // this warp's l

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const int grp = h / (H / G);
  const float a = A[h] * 1.4426950408889634f;   // A log2(e): l in log2 units
  const long long x_row = (long long)H * P;     // x / y: one time step
  const long long bc_row = (long long)G * N;    // B / C: one time step
  const E* xb = x + (long long)b * T * x_row + (long long)h * P;
  E* yb = y + (long long)b * T * x_row + (long long)h * P;
  const E* Bb = Bm + (long long)b * T * bc_row + (long long)grp * N;
  const E* Cb = Cm + (long long)b * T * bc_row + (long long)grp * N;
  const float* dtb = dt + (long long)b * T * H + h;

  auto stage = [&](int t0, int s) {
    const int len = min(kChunk, T - t0);
    constexpr int kRowN = N / kVec, kRowX = P / kVec;
    for (int i = tid; i < kChunk * kRowN; i += kThreads) {
      const int t = i / kRowN, q = (i - t * kRowN) * kVec;
      const bool ok = t < len;
      const long long off = ok ? (long long)(t0 + t) * bc_row + q : 0;
      tile::cp16(Cs(s) + t * kLdN + q, Cb + off, ok);
      tile::cp16(Bs(s) + t * kLdN + q, Bb + off, ok);
    }
    for (int i = tid; i < kChunk * kRowX; i += kThreads) {
      const int t = i / kRowX, q = (i - t * kRowX) * kVec;
      const bool ok = t < len;
      tile::cp16(Xs(s) + t * kLdX + q,
                 xb + (ok ? (long long)(t0 + t) * x_row + q : 0), ok);
    }
    if (tid < kChunk) {
      const bool ok = tid < len;
      tile::cp4(Ds(s) + tid, dtb + (ok ? (long long)(t0 + tid) * H : 0), ok);
    }
    tile::cp_commit();
  };

  // the warp's rows of the state, [kMT m-tiles][kPT n-tiles][4]
  float st[kMT][kPT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int n = 0; n < kPT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[m][n][i] = 0.0f;
  for (int i = tid; i < tile::Staged<E>::kArrays * N * kLdT; i += kThreads) {
    (i < N * kLdT ? Shi[i] : Slo[i - N * kLdT]) = TS(0.0f);
  }

  const int n_chunks = (T + kChunk - 1) / kChunk;
  stage(0, 0);
  const int r0 = 16 * warp;                   // the warp's steps t
  const int nrow = kMT * 16 * warp;           // the warp's state rows n
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int s = ci & 1;
    const int t0 = ci * kChunk;
    const int len = min(kChunk, T - t0);
    tile::cp_wait_all();
    __syncthreads();   // chunk ci staged; chunk ci - 1 done by every warp
    if (ci + 1 < n_chunks) stage(t0 + kChunk, s ^ 1);
    const E* Cc = Cs(s);
    const E* Bc = Bs(s);
    const E* Xc = Xs(s);
    const float* dtc = Ds(s);

    // 1. l: inclusive prefix sum of dt * A log2(e), lane holding steps
    //    2i and 2i+1; then the block's w x, 8 elements at a time
    {
      const float2 d = *reinterpret_cast<const float2*>(dtc + 2 * lane);
      const float v0 = d.x * a, v1 = d.y * a;
      float incl = v0 + v1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(tile::kFull, incl, off);
        if (lane >= off) incl += u;
      }
      float excl = __shfl_up_sync(tile::kFull, incl, 1);
      if (lane == 0) excl = 0.0f;
      lw[2 * lane] = excl + v0;
      lw[2 * lane + 1] = incl;
      __syncwarp();
    }
    const float l_last = lw[kChunk - 1];
    for (int e = tid; e < kChunk * kPT; e += kThreads) {
      const int sw = e / kPT, p0 = (e % kPT) * 8;
      const float w = exp2f(l_last - lw[sw]) * dtc[sw];
      float xv[8];
      tile::load8(Xc + sw * kLdX + p0, xv);
#pragma unroll
      for (int i = 0; i < 8; i += 2) {
        tile::store_staged(Whi + sw * kLdT + p0 + i, Wlo + sw * kLdT + p0 + i,
                           w * xv[i], w * xv[i + 1]);
      }
    }
    const int ta = r0 + g, tb = ta + 8;
    const float l_ta = lw[ta], l_tb = lw[tb];

    // 2. M = (C B^T) o decay o dt over s <= t, the warp's 16 rows
    typename Frag<E>::A cf[kNT];
#pragma unroll
    for (int k = 0; k < kNT; ++k) {
      tile::load_a(cf[k], Cc + r0 * kLdN + 16 * k, kLdN);
    }
    float m[kChunk / 8][4];
#pragma unroll
    for (int j = 0; j < kChunk / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) m[j][i] = 0.0f;
      if (j <= 2 * warp + 1) {
#pragma unroll
        for (int k = 0; k < kNT; ++k) {
          typename Frag<E>::B bf;
          tile::load_b(bf, Bc + 8 * j * kLdN + 16 * k, kLdN);
          tile::mma(m[j], cf[k], bf);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int sc = 8 * j + 2 * c + e;
          const float ls = lw[sc], ds = dtc[sc];
          m[j][e] = sc <= ta ? m[j][e] * exp2f(l_ta - ls) * ds : 0.0f;
          m[j][2 + e] = sc <= tb ? m[j][2 + e] * exp2f(l_tb - ls) * ds : 0.0f;
        }
      }
    }

    // 3. y = exp(l_t) C S_prev + M x
    float yo[kPT][4];
#pragma unroll
    for (int n = 0; n < kPT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) yo[n][i] = 0.0f;
#pragma unroll
    for (int k = 0; k < kNT; ++k) {
#pragma unroll
      for (int n = 0; n < kPT; ++n) {
        const int off = 16 * k * kLdT + 8 * n;
        tile::mma_staged_b_trans(yo[n], cf[k], Shi + off, Slo + off, kLdT);
      }
    }
    {
      const float ea = exp2f(l_ta), eb = exp2f(l_tb);
#pragma unroll
      for (int n = 0; n < kPT; ++n) {
        yo[n][0] *= ea;
        yo[n][1] *= ea;
        yo[n][2] *= eb;
        yo[n][3] *= eb;
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk / 16; ++k) {
      if (k <= warp) {
        const float av[8] = {m[2 * k][0], m[2 * k][1], m[2 * k][2],
                             m[2 * k][3], m[2 * k + 1][0], m[2 * k + 1][1],
                             m[2 * k + 1][2], m[2 * k + 1][3]};
        typename Frag<E>::SplitA ma;
        tile::split_a(ma, av);
#pragma unroll
        for (int n = 0; n < kPT; ++n) {
          typename Frag<E>::B xf;
          tile::load_b_trans(xf, Xc + 16 * k * kLdX + 8 * n, kLdX);
          tile::mma(yo[n], ma, xf);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kPT; ++n) {
      const int p = 8 * n + 2 * c;
      if (ta < len) {
        store2(yo[n][0], yo[n][1], yb + (long long)(t0 + ta) * x_row + p);
      }
      if (tb < len) {
        store2(yo[n][2], yo[n][3], yb + (long long)(t0 + tb) * x_row + p);
      }
    }
    __syncthreads();   // every read of S_prev done; w x written

    // 4. S = exp(l_L) S + B^T (w x): the warp's kMT m-tiles of rows n
    {
      const float decay = exp2f(l_last);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int n = 0; n < kPT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) st[mt][n][i] *= decay;
#pragma unroll
      for (int k = 0; k < kChunk / 16; ++k) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          typename Frag<E>::A bt;
          tile::load_a_trans(bt, Bc + 16 * k * kLdN + nrow + 16 * mt, kLdN);
#pragma unroll
          for (int n = 0; n < kPT; ++n) {
            const int off = 16 * k * kLdT + 8 * n;
            tile::mma_staged_b_trans(st[mt][n], bt, Whi + off, Wlo + off,
                                     kLdT);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int n = 0; n < kPT; ++n) {
          const int off = (nrow + 16 * mt + g) * kLdT + 8 * n + 2 * c;
          tile::store_staged(Shi + off, Slo + off, st[mt][n][0], st[mt][n][1]);
          tile::store_staged(Shi + off + 8 * kLdT, Slo + off + 8 * kLdT,
                             st[mt][n][2], st[mt][n][3]);
        }
      }
    }
  }
}

template <typename E, int P, int N>
int launch(const void* x, const float* dt, const float* A, const void* B,
           const void* C, void* y, int Bt, int T, int H, int G,
           cudaStream_t stream) {
  constexpr int bytes = Smem<E, P, N>::kBytes;
  auto kernel = ssd_scan_kernel<E, P, N>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();   // clear it: the launch below is not made
      return (int)err;
    }
    attr_set = true;
  }
  kernel<<<Bt * H, kThreads, bytes, stream>>>(
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

// ------------------------------------------------- attributes (verify)

// Every kernel of this source at its launch: kThreads a block with
// Smem<E, P, N>::kBytes of dynamic shared memory.
const repro_attrs::KernelEntry* kernel_table(int* n) {
  static const repro_attrs::KernelEntry table[] = {
      {"ssd_scan_kernel<bf16,64,64>",
       (const void*)ssd_scan_kernel<__nv_bfloat16, 64, 64>, kThreads,
       Smem<__nv_bfloat16, 64, 64>::kBytes, 1},
      {"ssd_scan_kernel<bf16,64,128>",
       (const void*)ssd_scan_kernel<__nv_bfloat16, 64, 128>, kThreads,
       Smem<__nv_bfloat16, 64, 128>::kBytes, 1},
      {"ssd_scan_kernel<f32,64,64>",
       (const void*)ssd_scan_kernel<float, 64, 64>, kThreads,
       Smem<float, 64, 64>::kBytes, 1},
      {"ssd_scan_kernel<f32,64,128>",
       (const void*)ssd_scan_kernel<float, 64, 128>, kThreads,
       Smem<float, 64, 128>::kBytes, 1}};
  *n = (int)(sizeof(table) / sizeof(table[0]));
  return table;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K8: x / y [Bt, T, H, P] and B / C [Bt, T, G, N] in bf16, dt [Bt, T, H]
// and A [H] in fp32; all contiguous and 16-byte aligned (checked by the
// wrapper).
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

REPRO_KERNEL_ATTRIBUTES(kernel_table)
