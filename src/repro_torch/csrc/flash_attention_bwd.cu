// The backward of online-softmax attention K7 for Hopper (sm_90a).
//
// Replaces no Pallas kernel: src/repro has no Pallas backward; its gradient
// through attention is jax's VJP of the chunked attention_ref
// (src/repro/kernels/flash_attention/ref.py).  The port's training path
// runs K7's CUDA forward (flash_attention.cu), so its gradient is this
// source.  It takes a prefill call over all its keys from position 0
// (kv_len == Tk, q_offset == 0; the wrapper refuses any other), with the
// causal mask and the sliding window, q / k / v / o / dO [BH, T, D] in
// bf16 or float32 and the forward's lse [BH, Tq] (fp32, natural units,
// +inf for a row that sees no key), and writes dq, dk, dv in the inputs'
// type.  With s = scale q.k, P = exp(s - lse), D_i = rowsum(dO o)_i:
//
//   dV = P^T dO,  dS = P (dO V^T - D),  dQ = scale dS K,  dK = scale dS^T Q.
//
// Bound: five products of D multiply-adds over every visible (query, key)
// pair, 4.7 GFLOP for one 1,024-token sequence of qwen2-0.5b (14 heads of
// 64, causal), against some 29 MB of q, k, v, o, dO in and dq, dk, dv out
// in float32: 70 us on the CUDA cores at 67 TFLOP/s in float32, 4.8 us on
// the tensor cores in bf16.  Deterministic (no atomics, so a rerun is
// bitwise equal); S and dP are recomputed in both passes (seven products
// where five would do), and wgmma / TMA are later work.  Three launches:
//
// 1. delta: one warp a row, D_i = sum_d dO o in fp32, into a scratch.
// 2. dK / dV by key tiles: a block stages its keys' K and V once and walks
//    the query steps that can see any of them (from the block's first key
//    under the causal mask, to its last key + window - 1 under a window),
//    staging Q, dO, lse and D of each; it computes S^T = K Q^T and
//    dP^T = V dO^T, P^T and dS^T from them, and accumulates dV += P^T dO
//    and dK += dS^T Q in fp32 registers.
// 3. dQ by query tiles: a block stages its rows' Q and dO once and walks
//    the key steps the rows can see, as the forward does, issued last row
//    block first, and accumulates dQ += dS K.
//
// bf16 runs on tile_mma.cuh's warp tiles, as the forward does: a block of
// 4 warps owns 64 rows (16 a warp) and walks 32 a step, the products on
// the tensor cores with exact products of the bf16 inputs, P and dS (fp32
// intermediates) split into bf16 hi + lo so that they keep their fp32
// value to about 2^-17, P^T and dS^T feeding the products from the score
// registers.  float32 runs attn_bwd_f32.cuh's register-blocked fp32 FMAs
// from shared memory on the CUDA cores (32 rows a block, 64 or 32 a step).
// Masked entries of P are set to 0, so a row that sees no key adds
// nothing and gets a zero dq.  Built for D 64 and 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "attn_bwd_f32.cuh"
#include "kernel_attrs.cuh"
#include "tile_mma.cuh"

namespace {

using attn_bwd::kLog2e;
using attn_bwd::seen;
using tile::Frag;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;     // rows a block owns
constexpr int kStep = 32;              // rows of the other side a step
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store2(float a, float b, float* o) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
__device__ __forceinline__ void store2(float a, float b, __nv_bfloat16* o) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}

template <typename E, int D>
struct Bwd {
  static constexpr int kVec = 16 / (int)sizeof(E);   // elements a vector
  static constexpr int kLd = D + kVec;               // staged row stride
  static constexpr int kRowV = D / kVec;             // vectors a row
  static constexpr int kTiles = (2 * kRows + 2 * kStep) * kLd * (int)sizeof(E);
  // dK / dV: K, V (kRows), Q, dO (kStep), then lse and D of the step
  static constexpr int kBytesKV = kTiles + 2 * kStep * (int)sizeof(float);
  // dQ: Q, dO (kRows), K, V (kStep)
  static constexpr int kBytesQ = kTiles;
};

// rows [r0, r0 + n) of src [T][D] into dst [n][kLd] by cp.async, zeros
// past T
template <typename E, int D>
__device__ __forceinline__ void stage_rows(E* dst, const E* src, int r0,
                                           int n, int T) {
  using B = Bwd<E, D>;
  for (int i = threadIdx.x; i < n * B::kRowV; i += kThreads) {
    const int r = i / B::kRowV, col = (i - r * B::kRowV) * B::kVec;
    const bool ok = r0 + r < T;
    const long long off = ok ? (long long)(r0 + r) * D + col : 0;
    tile::cp16(dst + r * B::kLd + col, src + off, ok);
  }
}

// ------------------------------------------------------------------ delta
template <typename E, int D>
__global__ void __launch_bounds__(kThreads) attn_bwd_delta_kernel(
    const E* __restrict__ o, const E* __restrict__ dO,
    float* __restrict__ delta, long long rows) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;     // the whole warp leaves together
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32) {
    acc = fmaf(to_f(o[row * D + d]), to_f(dO[row * D + d]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(kFull, acc, off);
  }
  if (lane == 0) delta[row] = acc;
}

// ------------------------------------------------------------------ dK, dV
template <typename E, int D>
__global__ void __launch_bounds__(kThreads) attn_bwd_dkdv_kernel(
    const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
    const E* __restrict__ dO, const float* __restrict__ lse,
    const float* __restrict__ delta, E* __restrict__ dk, E* __restrict__ dv,
    int Tq, int Tk, float scale, int causal, int window) {
  using B = Bwd<E, D>;
  constexpr int kLd = B::kLd;
  constexpr int kKT = D / 16;       // k-steps over D
  constexpr int kNT = D / 8;        // n-tiles over D
  constexpr int kST = kStep / 8;    // n-tiles over the step's queries
  extern __shared__ __align__(16) unsigned char smem[];
  E* Ks = reinterpret_cast<E*>(smem);
  E* Vs = Ks + kRows * kLd;
  E* Qs = Vs + kRows * kLd;
  E* Gs = Qs + kStep * kLd;                                // dO
  float* Ls = reinterpret_cast<float*>(Gs + kStep * kLd);  // lse, log2 units
  float* Ds = Ls + kStep;                                  // D

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const long long bh = blockIdx.x;
  const int k0 = blockIdx.y * kRows;
  const E* qb = q + bh * Tq * D;
  const E* gb = dO + bh * Tq * D;
  const float* lb = lse + bh * Tq;
  const float* db = delta + bh * Tq;

  // the queries that see any key of this block, in whole steps
  const int k_last = min(k0 + kRows, Tk) - 1;
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(Tq, k_last + window) : Tq;
  const int qt0 = q_begin / kStep;
  const int qt1 = q_end > q_begin ? (q_end + kStep - 1) / kStep : qt0;

  stage_rows<E, D>(Ks, k + bh * Tk * D, k0, kRows, Tk);
  stage_rows<E, D>(Vs, v + bh * Tk * D, k0, kRows, Tk);
  tile::cp_commit();
  tile::cp_wait_all();

  const float sl2 = scale * kLog2e;
  // the lane's two keys, rows g and g + 8 of the warp's 16
  const int ka = k0 + 16 * warp + g, kb = ka + 8;
  float dka[kNT][4], dva[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[n][i] = dva[n][i] = 0.0f;

  for (int qt = qt0; qt < qt1; ++qt) {
    const int q0 = qt * kStep;
    __syncthreads();   // every warp is done with the last step's tiles
    stage_rows<E, D>(Qs, qb, q0, kStep, Tq);
    stage_rows<E, D>(Gs, gb, q0, kStep, Tq);
    tile::cp_commit();
    for (int i = tid; i < kStep; i += kThreads) {
      const bool in = q0 + i < Tq;
      Ls[i] = in ? lb[q0 + i] * kLog2e : INFINITY;
      Ds[i] = in ? db[q0 + i] : 0.0f;
    }
    tile::cp_wait_all();
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x kStep queries a warp
    float st[kST][4], dpt[kST][4];
#pragma unroll
    for (int j = 0; j < kST; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[j][i] = dpt[j][i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kKT; ++kk) {
      typename Frag<E>::A kf, vf;
      tile::load_a(kf, Ks + 16 * warp * kLd + 16 * kk, kLd);
      tile::load_a(vf, Vs + 16 * warp * kLd + 16 * kk, kLd);
#pragma unroll
      for (int j = 0; j < kST; ++j) {
        typename Frag<E>::B qf, gf;
        tile::load_b(qf, Qs + 8 * j * kLd + 16 * kk, kLd);
        tile::mma(st[j], kf, qf);
        tile::load_b(gf, Gs + 8 * j * kLd + 16 * kk, kLd);
        tile::mma(dpt[j], vf, gf);
      }
    }
    // P^T = exp(S^T scale - lse) where seen, dS^T = P^T (dP^T - D); the
    // lane's columns are queries 8 j + 2 c + e
#pragma unroll
    for (int j = 0; j < kST; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * c + e, qi = q0 + col;
        const float l2 = Ls[col], dl = Ds[col];
        const float pa = seen(qi, ka, Tq, Tk, causal, window)
                             ? exp2f(st[j][e] * sl2 - l2) : 0.0f;
        const float pb = seen(qi, kb, Tq, Tk, causal, window)
                             ? exp2f(st[j][2 + e] * sl2 - l2) : 0.0f;
        st[j][e] = pa;
        st[j][2 + e] = pb;
        dpt[j][e] = pa * (dpt[j][e] - dl);
        dpt[j][2 + e] = pb * (dpt[j][2 + e] - dl);
      }
    }
    // dV += P^T dO, dK += dS^T Q, P^T and dS^T from the score registers
#pragma unroll
    for (int kk = 0; kk < kStep / 16; ++kk) {
      const float pv[8] = {st[2 * kk][0], st[2 * kk][1], st[2 * kk][2],
                           st[2 * kk][3], st[2 * kk + 1][0],
                           st[2 * kk + 1][1], st[2 * kk + 1][2],
                           st[2 * kk + 1][3]};
      const float sv[8] = {dpt[2 * kk][0], dpt[2 * kk][1], dpt[2 * kk][2],
                           dpt[2 * kk][3], dpt[2 * kk + 1][0],
                           dpt[2 * kk + 1][1], dpt[2 * kk + 1][2],
                           dpt[2 * kk + 1][3]};
      typename Frag<E>::SplitA pf, sf;
      tile::split_a(pf, pv);
      tile::split_a(sf, sv);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        typename Frag<E>::B gf, qf;
        tile::load_b_trans(gf, Gs + 16 * kk * kLd + 8 * n, kLd);
        tile::mma(dva[n], pf, gf);
        tile::load_b_trans(qf, Qs + 16 * kk * kLd + 8 * n, kLd);
        tile::mma(dka[n], sf, qf);
      }
    }
  }

#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const int col = 8 * n + 2 * c;
    if (ka < Tk) {
      store2(dka[n][0] * scale, dka[n][1] * scale,
             dk + (bh * Tk + ka) * D + col);
      store2(dva[n][0], dva[n][1], dv + (bh * Tk + ka) * D + col);
    }
    if (kb < Tk) {
      store2(dka[n][2] * scale, dka[n][3] * scale,
             dk + (bh * Tk + kb) * D + col);
      store2(dva[n][2], dva[n][3], dv + (bh * Tk + kb) * D + col);
    }
  }
}

// --------------------------------------------------------------------- dQ
template <typename E, int D>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq_kernel(
    const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
    const E* __restrict__ dO, const float* __restrict__ lse,
    const float* __restrict__ delta, E* __restrict__ dq, int Tq, int Tk,
    float scale, int causal, int window) {
  using B = Bwd<E, D>;
  constexpr int kLd = B::kLd;
  constexpr int kKT = D / 16;
  constexpr int kNT = D / 8;
  constexpr int kST = kStep / 8;    // n-tiles over the step's keys
  extern __shared__ __align__(16) unsigned char smem[];
  E* Qs = reinterpret_cast<E*>(smem);
  E* Gs = Qs + kRows * kLd;          // dO
  E* Ks = Gs + kRows * kLd;
  E* Vs = Ks + kStep * kLd;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const long long bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const E* kb = k + bh * Tk * D;
  const E* vb = v + bh * Tk * D;

  // the keys any row of this block sees, in whole steps
  const int q_last = min(q0 + kRows, Tq) - 1;
  const int k_end = causal ? min(Tk, q_last + 1) : Tk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt0 = k_begin / kStep;
  const int kt1 = k_end > k_begin ? (k_end + kStep - 1) / kStep : kt0;

  stage_rows<E, D>(Qs, q + bh * Tq * D, q0, kRows, Tq);
  stage_rows<E, D>(Gs, dO + bh * Tq * D, q0, kRows, Tq);
  tile::cp_commit();

  const float sl2 = scale * kLog2e;
  // the lane's two rows, g and g + 8 of the warp's 16
  const int ra = q0 + 16 * warp + g, rb = ra + 8;
  const float l2a = ra < Tq ? lse[bh * Tq + ra] * kLog2e : INFINITY;
  const float l2b = rb < Tq ? lse[bh * Tq + rb] * kLog2e : INFINITY;
  const float dla = ra < Tq ? delta[bh * Tq + ra] : 0.0f;
  const float dlb = rb < Tq ? delta[bh * Tq + rb] : 0.0f;
  tile::cp_wait_all();
  float dqa[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dqa[n][i] = 0.0f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int key0 = kt * kStep;
    __syncthreads();   // every warp is done with the last step's tiles
    stage_rows<E, D>(Ks, kb, key0, kStep, Tk);
    stage_rows<E, D>(Vs, vb, key0, kStep, Tk);
    tile::cp_commit();
    tile::cp_wait_all();
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 rows x kStep keys a warp
    float s[kST][4], dp[kST][4];
#pragma unroll
    for (int j = 0; j < kST; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kKT; ++kk) {
      typename Frag<E>::A qf, gf;
      tile::load_a(qf, Qs + 16 * warp * kLd + 16 * kk, kLd);
      tile::load_a(gf, Gs + 16 * warp * kLd + 16 * kk, kLd);
#pragma unroll
      for (int j = 0; j < kST; ++j) {
        typename Frag<E>::B kf, vf;
        tile::load_b(kf, Ks + 8 * j * kLd + 16 * kk, kLd);
        tile::mma(s[j], qf, kf);
        tile::load_b(vf, Vs + 8 * j * kLd + 16 * kk, kLd);
        tile::mma(dp[j], gf, vf);
      }
    }
    // dS = P (dP - D), P = exp(S scale - lse) where seen
#pragma unroll
    for (int j = 0; j < kST; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + 8 * j + 2 * c + e;
        const float pa = seen(ra, key, Tq, Tk, causal, window)
                             ? exp2f(s[j][e] * sl2 - l2a) : 0.0f;
        const float pb = seen(rb, key, Tq, Tk, causal, window)
                             ? exp2f(s[j][2 + e] * sl2 - l2b) : 0.0f;
        s[j][e] = pa * (dp[j][e] - dla);
        s[j][2 + e] = pb * (dp[j][2 + e] - dlb);
      }
    }
    // dQ += dS K, dS from the score registers
#pragma unroll
    for (int kk = 0; kk < kStep / 16; ++kk) {
      const float sv[8] = {s[2 * kk][0], s[2 * kk][1], s[2 * kk][2],
                           s[2 * kk][3], s[2 * kk + 1][0], s[2 * kk + 1][1],
                           s[2 * kk + 1][2], s[2 * kk + 1][3]};
      typename Frag<E>::SplitA sf;
      tile::split_a(sf, sv);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        typename Frag<E>::B kf;
        tile::load_b_trans(kf, Ks + 16 * kk * kLd + 8 * n, kLd);
        tile::mma(dqa[n], sf, kf);
      }
    }
  }

#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const int col = 8 * n + 2 * c;
    if (ra < Tq) {
      store2(dqa[n][0] * scale, dqa[n][1] * scale,
             dq + (bh * Tq + ra) * D + col);
    }
    if (rb < Tq) {
      store2(dqa[n][2] * scale, dqa[n][3] * scale,
             dq + (bh * Tq + rb) * D + col);
    }
  }
}

// ----------------------------------------------------------------- launch
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, bool* done) {
  if (*done) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  *done = true;
  return 0;
}

// bf16: dK / dV and dQ on the mma.sync tiles
template <typename E, int D>
int launch_passes(const E* q, const E* k, const E* v, const float* lse,
                  const E* dO, const float* delta, E* dq, E* dk, E* dv,
                  int BH, int Tq, int Tk, float scale, int causal,
                  int window, cudaStream_t stream) {
  using B = Bwd<E, D>;
  static bool kv_set = false, q_set = false;
  int err = allow_smem(attn_bwd_dkdv_kernel<E, D>, B::kBytesKV, &kv_set);
  if (err) return err;
  err = allow_smem(attn_bwd_dq_kernel<E, D>, B::kBytesQ, &q_set);
  if (err) return err;
  if (BH > 0 && Tk > 0) {
    attn_bwd_dkdv_kernel<E, D>
        <<<dim3(BH, (Tk + kRows - 1) / kRows), kThreads, B::kBytesKV,
           stream>>>(q, k, v, dO, lse, delta, dk, dv, Tq, Tk, scale, causal,
                     window);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (BH > 0 && Tq > 0) {
    attn_bwd_dq_kernel<E, D>
        <<<dim3(BH, (Tq + kRows - 1) / kRows), kThreads, B::kBytesQ,
           stream>>>(q, k, v, dO, lse, delta, dq, Tq, Tk, scale, causal,
                     window);
    err = (int)cudaGetLastError();
  }
  return err;
}

// float32: dK / dV and dQ by register-blocked FMAs (attn_bwd_f32.cuh)
template <int D>
int launch_passes_f32(const float* q, const float* k, const float* v,
                      const float* lse, const float* dO, const float* delta,
                      float* dq, float* dk, float* dv, int BH, int Tq,
                      int Tk, float scale, int causal, int window,
                      cudaStream_t stream) {
  namespace f = attn_bwd::f32;
  using T = f::Tiles<D>;
  static bool kv_set = false, q_set = false;
  int err = allow_smem(f::attn_bwd_dkdv_f32_kernel<D>, T::kBytesKV, &kv_set);
  if (err) return err;
  err = allow_smem(f::attn_bwd_dq_f32_kernel<D>, T::kBytesQ, &q_set);
  if (err) return err;
  if (BH > 0 && Tk > 0) {
    f::attn_bwd_dkdv_f32_kernel<D>
        <<<dim3(BH, (Tk + f::kOwn - 1) / f::kOwn), f::kThreads, T::kBytesKV,
           stream>>>(q, k, v, dO, lse, delta, dk, dv, Tq, Tk, scale, causal,
                     window);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (BH > 0 && Tq > 0) {
    f::attn_bwd_dq_f32_kernel<D>
        <<<dim3(BH, (Tq + f::kOwn - 1) / f::kOwn), f::kThreads, T::kBytesQ,
           stream>>>(q, k, v, dO, lse, delta, dq, Tq, Tk, scale, causal,
                     window);
    err = (int)cudaGetLastError();
  }
  return err;
}

template <typename E, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const float* lse, const void* dO, float* delta, void* dq,
               void* dk, void* dv, int BH, int Tq, int Tk, float scale,
               int causal, int window, cudaStream_t stream) {
  const E* qe = static_cast<const E*>(q);
  const E* ke = static_cast<const E*>(k);
  const E* ve = static_cast<const E*>(v);
  const E* ge = static_cast<const E*>(dO);
  const long long rows = (long long)BH * Tq;
  if (rows > 0) {
    attn_bwd_delta_kernel<E, D>
        <<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
            static_cast<const E*>(o), ge, delta, rows);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if constexpr (std::is_same<E, float>::value) {
    return launch_passes_f32<D>(qe, ke, ve, lse, ge, delta,
                                static_cast<float*>(dq),
                                static_cast<float*>(dk),
                                static_cast<float*>(dv), BH, Tq, Tk, scale,
                                causal, window, stream);
  } else {
    return launch_passes<E, D>(qe, ke, ve, lse, ge, delta,
                               static_cast<E*>(dq), static_cast<E*>(dk),
                               static_cast<E*>(dv), BH, Tq, Tk, scale,
                               causal, window, stream);
  }
}

#define REPRO_ATTN_BWD_DIMS(X) X(64) X(128)

template <typename E>
int backward(const void* q, const void* k, const void* v, const void* o,
             const float* lse, const void* dO, float* delta, void* dq,
             void* dk, void* dv, int BH, int Tq, int Tk, int D, float scale,
             int causal, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_ATTN_BWD_CASE(DIM)                                             \
  case DIM:                                                                  \
    return launch_bwd<E, DIM>(q, k, v, o, lse, dO, delta, dq, dk, dv, BH,    \
                              Tq, Tk, scale, causal, window, s);
  switch (D) {
    REPRO_ATTN_BWD_DIMS(REPRO_ATTN_BWD_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_ATTN_BWD_CASE
}

// ------------------------------------------------- attributes (verify)

// Every kernel of this source at its launch: the delta kernel; bf16's
// dK / dV and dQ (kThreads a block) and float32's (f32::kThreads, with the
// blocks an SM their __launch_bounds__ promise), each with its dynamic
// shared memory.
#define REPRO_ATTN_BWD_DELTA(E, EN, DIM)                                    \
  {"attn_bwd_delta_kernel<" EN "," #DIM ">",                                \
   (const void*)attn_bwd_delta_kernel<E, DIM>, kThreads, 0, 1},
#define REPRO_ATTN_BWD_BF16(DIM)                                            \
  REPRO_ATTN_BWD_DELTA(__nv_bfloat16, "bf16", DIM)                          \
  {"attn_bwd_dkdv_kernel<bf16," #DIM ">",                                   \
   (const void*)attn_bwd_dkdv_kernel<__nv_bfloat16, DIM>, kThreads,         \
   Bwd<__nv_bfloat16, DIM>::kBytesKV, 1},                                   \
  {"attn_bwd_dq_kernel<bf16," #DIM ">",                                     \
   (const void*)attn_bwd_dq_kernel<__nv_bfloat16, DIM>, kThreads,           \
   Bwd<__nv_bfloat16, DIM>::kBytesQ, 1},
#define REPRO_ATTN_BWD_F32(DIM)                                             \
  REPRO_ATTN_BWD_DELTA(float, "f32", DIM)                                   \
  {"attn_bwd_dkdv_f32_kernel<" #DIM ">",                                    \
   (const void*)attn_bwd::f32::attn_bwd_dkdv_f32_kernel<DIM>,               \
   attn_bwd::f32::kThreads, attn_bwd::f32::Tiles<DIM>::kBytesKV,            \
   attn_bwd::f32::Tiles<DIM>::kBlocksKV},                                   \
  {"attn_bwd_dq_f32_kernel<" #DIM ">",                                      \
   (const void*)attn_bwd::f32::attn_bwd_dq_f32_kernel<DIM>,                 \
   attn_bwd::f32::kThreads, attn_bwd::f32::Tiles<DIM>::kBytesQ,             \
   attn_bwd::f32::Tiles<DIM>::kBlocksQ},

const repro_attrs::KernelEntry* kernel_table(int* n) {
  static const repro_attrs::KernelEntry table[] = {
      REPRO_ATTN_BWD_DIMS(REPRO_ATTN_BWD_BF16)
          REPRO_ATTN_BWD_DIMS(REPRO_ATTN_BWD_F32)};
  *n = (int)(sizeof(table) / sizeof(table[0]));
  return table;
}

#undef REPRO_ATTN_BWD_F32
#undef REPRO_ATTN_BWD_BF16
#undef REPRO_ATTN_BWD_DELTA

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K7's backward: q / o / dO / dq [BH, Tq, D], k / v / dk / dv [BH, Tk, D],
// lse [BH, Tq] fp32, delta an fp32 scratch of BH * Tq; D 64 or 128;
// kv_len == Tk and q_offset == 0.  Three launches.
int repro_flash_attention_bh_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dO, float* delta, void* dq, void* dk,
    void* dv, int BH, int Tq, int Tk, int D, float scale, int causal,
    int window, void* stream) {
  return backward<__nv_bfloat16>(q, k, v, o, lse, dO, delta, dq, dk, dv, BH,
                                 Tq, Tk, D, scale, causal, window, stream);
}

int repro_flash_attention_bh_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dO, float* delta, void* dq, void* dk,
    void* dv, int BH, int Tq, int Tk, int D, float scale, int causal,
    int window, void* stream) {
  return backward<float>(q, k, v, o, lse, dO, delta, dq, dk, dv, BH, Tq, Tk,
                         D, scale, causal, window, stream);
}

}  // extern "C"

REPRO_KERNEL_ATTRIBUTES(kernel_table)
