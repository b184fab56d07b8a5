// K7's backward in float32 on the H100's CUDA cores: the dK / dV and dQ
// passes of flash_attention_bwd.cu's float instantiation (the bf16 one
// runs on the tensor cores through tile_mma.cuh).
//
// The products are fp32 FMAs, as the oracle's 1e-5 needs (TF32 would miss
// it).  Fed through tile_mma.cuh's float primitive, each 16 x 8 x 16 tile
// cost a lane 64 warp shuffles for its 64 FMAs, a shuffle issuing at a
// quarter of the FMA rate, in an out-of-line call: 6 % of the float32
// rate.  Here every product is register-blocked from shared memory, with
// no shuffle and no call:
//
// * 128 threads a block in an 8 x 16 grid (tm, tn).  A product's A
//   operand is a 32-row tile, row-major with k contiguous; a thread owns
//   its rows tm + 8 i (i < 4).  Its B operand is read by rows ([n][k]:
//   the score products, the thread owning columns tn + 16 j) or by columns
//   ([k][n]: the D-wide sums, the thread owning the four-column chunks
//   4 tn + 64 h).  A thread keeps 4 x 4 sums a product (4 x 2 and 4 x 8 at
//   D 128) and reads its operands as float4: 8 loads for 64 FMAs over
//   four k.
// * Row strides of D + 4 floats for the staged tiles and step + 8 for
//   P^T / dS^T keep a warp's loads and stores free of bank conflicts (a
//   warp is 4 tm x 8 tn).
// * A block owns 32 rows (keys in dK / dV, queries in dQ) and walks the
//   other side 64 rows a step at D 64 (32 at D 128), so the training
//   call [14, 1024, 64] causal is 448 blocks a pass and three blocks (12
//   warps, 3 an SMSP) fit an SM.  Under the causal mask dK / dV issues key
//   block 0 first and dQ the last query block first: the longest blocks
//   (Tq / step steps) start in the first wave.
//
// Each pass stages its own side once and the other side a step at a time
// by cp.async, computes S and dP by rows of the step, P and dS per element
// in registers, stores P^T / dS^T (dS in dQ) to shared memory and adds
// the D-wide products from there.  Sums run in a fixed order: no atomics,
// a rerun is bitwise equal.  Built for D 64 and 128.
#pragma once

#include <math.h>

#include "tile_mma.cuh"

namespace attn_bwd {

constexpr float kLog2e = 1.4426950408889634f;

// query row qi sees key kj (kv_len == Tk, q_offset == 0)
__device__ __forceinline__ bool seen(int qi, int kj, int Tq, int Tk,
                                     int causal, int window) {
  return qi < Tq && kj < Tk && (!causal || kj <= qi) &&
         (window <= 0 || kj > qi - window);
}

namespace f32 {

constexpr int kThreads = 128;
constexpr int kOwn = 32;         // rows a block owns

template <int D>
struct Tiles {
  static constexpr int kStep = D == 64 ? 64 : 32;   // rows a step
  static constexpr int kLd = D + 4;                 // staged row stride
  static constexpr int kLdP = kStep + 8;            // P^T / dS^T stride
  static constexpr int kNJ = kStep / 16;            // score columns a thread
  static constexpr int kH = D / 64;                 // D chunks a thread
  // dK / dV: K, V; Q, dO of the step; P^T, dS^T; lse and D of the step
  static constexpr int kBytesKV =
      4 * (2 * kOwn * kLd + 2 * kStep * kLd + 2 * kOwn * kLdP + 2 * kStep);
  // dQ: Q, dO; K, V of the step; dS
  static constexpr int kBytesQ =
      4 * (2 * kOwn * kLd + 2 * kStep * kLd + kOwn * kLdP);
  // blocks an SM the shared memory allows (228 KB, 1 KB of it a block's)
  static constexpr int kBlocksKV = D == 64 ? 3 : 2;
  static constexpr int kBlocksQ = 3;
};

// rows [r0, r0 + n) of src [T][D] into dst [n][ld] by cp.async, zeros
// past T
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, int r0,
                                      int n, int T, int ld) {
  constexpr int kRowV = D / 4;
  for (int i = threadIdx.x; i < n * kRowV; i += kThreads) {
    const int r = i / kRowV, col = (i - r * kRowV) * 4;
    const bool ok = r0 + r < T;
    const long long off = ok ? (long long)(r0 + r) * D + col : 0;
    tile::cp16(dst + r * ld + col, src + off, ok);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[i][j] += sum_k A[tm + 8 i][k] B[tn + 16 j][k], k < K: A [32][lda],
// B [n][ldb], both k-contiguous
template <int K, int NJ>
__device__ __forceinline__ void mm_rows(float (&acc)[4][NJ], const float* a,
                                        int lda, const float* b, int ldb,
                                        int tm, int tn) {
#pragma unroll 4
  for (int k = 0; k < K; k += 4) {
    float4 av[4], bv[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = ld4(a + (tm + 8 * i) * lda + k);
#pragma unroll
    for (int j = 0; j < NJ; ++j) bv[j] = ld4(b + (tn + 16 * j) * ldb + k);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
    }
  }
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a, float4 b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// acc[i][4 h + e] += sum_k A[tm + 8 i][k] B[k][4 tn + 64 h + e], k < K:
// A [32][lda] k-contiguous, B [K][ldb] n-contiguous
template <int K, int H>
__device__ __forceinline__ void mm_cols(float (&acc)[4][H][4],
                                        const float* a, int lda,
                                        const float* b, int ldb, int tm,
                                        int tn) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = ld4(a + (tm + 8 * i) * lda + k);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      float4 bv[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        bv[kk] = ld4(b + (k + kk) * ldb + 4 * tn + 64 * h);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        fma4(acc[i][h], av[i].x, bv[0]);
        fma4(acc[i][h], av[i].y, bv[1]);
        fma4(acc[i][h], av[i].z, bv[2]);
        fma4(acc[i][h], av[i].w, bv[3]);
      }
    }
  }
}

template <int H>
__device__ __forceinline__ void zero(float (&acc)[4][H][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][h][e] = 0.0f;
}

// rows r0 + tm + 8 i (below T) of out [T][D] from acc times s
template <int D, int H>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[4][H][4],
                                           float s, int r0, int T, int tm,
                                           int tn) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + tm + 8 * i;
    if (r >= T) continue;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      *reinterpret_cast<float4*>(out + (long long)r * D + 4 * tn + 64 * h) =
          make_float4(acc[i][h][0] * s, acc[i][h][1] * s, acc[i][h][2] * s,
                      acc[i][h][3] * s);
    }
  }
}

// ----------------------------------------------------------------- dK, dV
// A block owns keys [k0, k0 + 32) of one (batch, head) and walks the
// query steps that can see any of them (from the block's first key under
// the causal mask, to its last key + window - 1 under a window).
template <int D>
__global__ void __launch_bounds__(kThreads, Tiles<D>::kBlocksKV)
    attn_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dO,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int Tq, int Tk, float scale, int causal,
                             int window) {
  using T = Tiles<D>;
  constexpr int kLd = T::kLd, kLdP = T::kLdP, kStep = T::kStep;
  constexpr int kNJ = T::kNJ, kH = T::kH;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + kOwn * kLd;
  float* Qs = Vs + kOwn * kLd;
  float* Gs = Qs + kStep * kLd;      // dO
  float* Ps = Gs + kStep * kLd;      // P^T [key][query]
  float* Ss = Ps + kOwn * kLdP;      // dS^T
  float* Ls = Ss + kOwn * kLdP;      // lse of the step, log2 units
  float* Ds = Ls + kStep;            // D of the step

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tm = (warp / 2) * 4 + lane / 8, tn = (warp % 2) * 8 + lane % 8;
  const long long bh = blockIdx.x;
  const int k0 = blockIdx.y * kOwn;
  const float* qb = q + bh * Tq * D;
  const float* gb = dO + bh * Tq * D;
  const float* lb = lse + bh * Tq;
  const float* db = delta + bh * Tq;

  const int k_last = min(k0 + kOwn, Tk) - 1;
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(Tq, k_last + window) : Tq;
  const int qt0 = q_begin / kStep;
  const int qt1 = q_end > q_begin ? (q_end + kStep - 1) / kStep : qt0;

  stage<D>(Ks, k + bh * Tk * D, k0, kOwn, Tk, kLd);
  stage<D>(Vs, v + bh * Tk * D, k0, kOwn, Tk, kLd);
  tile::cp_commit();

  const float sl2 = scale * kLog2e;
  float dka[4][kH][4], dva[4][kH][4];
  zero(dka);
  zero(dva);

  for (int qt = qt0; qt < qt1; ++qt) {
    const int q0 = qt * kStep;
    __syncthreads();   // every thread is done with the last step's tiles
    stage<D>(Qs, qb, q0, kStep, Tq, kLd);
    stage<D>(Gs, gb, q0, kStep, Tq, kLd);
    tile::cp_commit();
    for (int i = tid; i < kStep; i += kThreads) {
      const bool in = q0 + i < Tq;
      Ls[i] = in ? lb[q0 + i] * kLog2e : INFINITY;
      Ds[i] = in ? db[q0 + i] : 0.0f;
    }
    tile::cp_wait_all();
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T, keys tm + 8 i by queries tn + 16 j
    float st[4][kNJ], dpt[4][kNJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kNJ; ++j) st[i][j] = dpt[i][j] = 0.0f;
    mm_rows<D, kNJ>(st, Ks, kLd, Qs, kLd, tm, tn);
    mm_rows<D, kNJ>(dpt, Vs, kLd, Gs, kLd, tm, tn);
    // P^T = exp(S^T scale - lse) where seen, dS^T = P^T (dP^T - D)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int col = tn + 16 * j, qi = q0 + col;
      const float l2 = Ls[col], dl = Ds[col];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = tm + 8 * i;
        const float p = seen(qi, k0 + row, Tq, Tk, causal, window)
                            ? exp2f(st[i][j] * sl2 - l2) : 0.0f;
        Ps[row * kLdP + col] = p;
        Ss[row * kLdP + col] = p * (dpt[i][j] - dl);
      }
    }
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q
    mm_cols<kStep, kH>(dva, Ps, kLdP, Gs, kLd, tm, tn);
    mm_cols<kStep, kH>(dka, Ss, kLdP, Qs, kLd, tm, tn);
  }
  // a block that walks no step has not waited for its K and V
  tile::cp_wait_all();

  store_rows<D>(dk + bh * Tk * D, dka, scale, k0, Tk, tm, tn);
  store_rows<D>(dv + bh * Tk * D, dva, 1.0f, k0, Tk, tm, tn);
}

// --------------------------------------------------------------------- dQ
// A block owns query rows [q0, q0 + 32), the last row block first, and
// walks the key steps the rows can see.
template <int D>
__global__ void __launch_bounds__(kThreads, Tiles<D>::kBlocksQ)
    attn_bwd_dq_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dO,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq, int Tq, int Tk,
                           float scale, int causal, int window) {
  using T = Tiles<D>;
  constexpr int kLd = T::kLd, kLdP = T::kLdP, kStep = T::kStep;
  constexpr int kNJ = T::kNJ, kH = T::kH;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Gs = Qs + kOwn * kLd;       // dO
  float* Ks = Gs + kOwn * kLd;
  float* Vs = Ks + kStep * kLd;
  float* Ss = Vs + kStep * kLd;      // dS [query][key]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tm = (warp / 2) * 4 + lane / 8, tn = (warp % 2) * 8 + lane % 8;
  const long long bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kOwn;
  const float* kb = k + bh * Tk * D;
  const float* vb = v + bh * Tk * D;

  const int q_last = min(q0 + kOwn, Tq) - 1;
  const int k_end = causal ? min(Tk, q_last + 1) : Tk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt0 = k_begin / kStep;
  const int kt1 = k_end > k_begin ? (k_end + kStep - 1) / kStep : kt0;

  stage<D>(Qs, q + bh * Tq * D, q0, kOwn, Tq, kLd);
  stage<D>(Gs, dO + bh * Tq * D, q0, kOwn, Tq, kLd);
  tile::cp_commit();

  const float sl2 = scale * kLog2e;
  float l2[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + tm + 8 * i;
    l2[i] = r < Tq ? lse[bh * Tq + r] * kLog2e : INFINITY;
    dl[i] = r < Tq ? delta[bh * Tq + r] : 0.0f;
  }
  float dqa[4][kH][4];
  zero(dqa);

  for (int kt = kt0; kt < kt1; ++kt) {
    const int key0 = kt * kStep;
    __syncthreads();   // every thread is done with the last step's tiles
    stage<D>(Ks, kb, key0, kStep, Tk, kLd);
    stage<D>(Vs, vb, key0, kStep, Tk, kLd);
    tile::cp_commit();
    tile::cp_wait_all();
    __syncthreads();

    // S = Q K^T and dP = dO V^T, rows tm + 8 i by keys tn + 16 j
    float s[4][kNJ], dp[4][kNJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kNJ; ++j) s[i][j] = dp[i][j] = 0.0f;
    mm_rows<D, kNJ>(s, Qs, kLd, Ks, kLd, tm, tn);
    mm_rows<D, kNJ>(dp, Gs, kLd, Vs, kLd, tm, tn);
    // dS = P (dP - D), P = exp(S scale - lse) where seen
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = tm + 8 * i;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int col = tn + 16 * j;
        const float p = seen(q0 + row, key0 + col, Tq, Tk, causal, window)
                            ? exp2f(s[i][j] * sl2 - l2[i]) : 0.0f;
        Ss[row * kLdP + col] = p * (dp[i][j] - dl[i]);
      }
    }
    __syncthreads();
    // dQ += dS K
    mm_cols<kStep, kH>(dqa, Ss, kLdP, Ks, kLd, tm, tn);
  }
  tile::cp_wait_all();

  store_rows<D>(dq + bh * Tq * D, dqa, scale, q0, Tq, tm, tn);
}

}  // namespace f32
}  // namespace attn_bwd
