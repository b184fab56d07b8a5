// K7's prefill in float32 on the H100's CUDA cores: the float
// instantiation of flash_attention.cu's prefill (Tq > 1; the bf16 one runs
// on the tensor cores through tile_mma.cuh).
//
// The products are fp32 FMAs, as the oracle's 1e-5 needs (TF32 would miss
// it).  Fed through tile_mma.cuh's float primitive, each 16 x 8 x 16 tile
// cost a lane 64 warp shuffles for its 64 FMAs, a shuffle issuing at a
// quarter of the FMA rate, in an out-of-line call, with one block barrier
// a 32-key tile.  Here, as in attn_bwd_f32.cuh, every product is
// register-blocked from shared memory, with no shuffle and no call:
//
// * 128 threads a block own 32 query rows of one (batch, head), the row
//   blocks issued last-first, so the causal blocks with the most keys
//   start in the first wave.  A warp is 4 x 8 threads (tm, tn); thread
//   (tm, tn) owns rows tm + 16 i (i < 2), of the scores the keys
//   tn + 8 j of the step, of the output the four-column chunks tn + 8 h.
//   A row's 8 threads are 8 lanes of one warp, so its max over a step is
//   3 shuffles, once a step and not once a product.
// * S = Q K^T: 2 x 8 sums a thread at a step of 64 keys (2 x 4 at 32),
//   read as float4 from Q and K staged at row stride D + 4 floats: 10
//   loads for 64 FMAs over four k.  O += P V: 2 x 4 h sums, O kept in
//   registers, P staged at row stride step + 8.  The strides keep a warp's
//   loads and stores free of bank conflicts at every built D.
// * The online softmax (row max, correction, row sum) is fp32 in log2
//   units; a thread keeps its share of each row's sum, the row's 8 shares
//   summed once at the end.  Only steps that cross the causal diagonal,
//   the window's edge or kv_len test the mask per element.
// * The keys any row of the block sees (past kv_len, past the causal bound
//   of the last row and before the window of the first skipped) are
//   walked a step at a time: 64 keys at D 64, 32 above.  K and V are
//   staged by cp.async half a step apart in one buffer each: V of a step
//   loads under its S, K of the next step under its P V; two block
//   barriers a step.  So shared memory is Q, K, V and P once: 52,736
//   bytes at D 64 and 55,808 at D 128, four blocks an SM; 80,384 at D 192
//   and 104,960 at D 256, two.  D 112 is 28 chunks: the last h of the
//   threads tn >= 4 is idle, nothing is padded.
//
// A row that sees no key has l == 0, outputs exactly 0 and an lse of
// +inf.  Sums run in a fixed order: no atomics, a rerun is bitwise equal.
#pragma once

#include <math.h>

#include "attn_bwd_f32.cuh"   // stage, ld4, fma4: the backward's helpers

namespace attn_fwd {
namespace f32 {

using attn_bwd::kLog2e;
using attn_bwd::f32::fma4;
using attn_bwd::f32::ld4;
using attn_bwd::f32::stage;

constexpr int kThreads = attn_bwd::f32::kThreads;   // stage's 128
constexpr int kRows = 32;                 // query rows a block
constexpr int kTN = 8;                    // threads sharing a row
constexpr int kTM = kThreads / kTN;       // 16
constexpr int kRI = kRows / kTM;          // rows a thread: 2
constexpr unsigned kFull = 0xffffffffu;

template <int D>
struct Tiles {
  static_assert(D % 4 == 0, "rows of whole float4 chunks");
  static constexpr int kStep = D == 64 ? 64 : 32;   // keys a step
  static constexpr int kLd = D + 4;                 // Q / K / V row stride
  static constexpr int kLdP = kStep + 8;            // P row stride
  static constexpr int kNJ = kStep / kTN;           // score columns a thread
  static constexpr int kChunks = D / 4;             // float4 chunks a row
  static constexpr int kH = (kChunks + kTN - 1) / kTN;   // chunks a thread
  // Q; K and V of a step; P
  static constexpr int kBytes =
      4 * (kRows * kLd + 2 * kStep * kLd + kRows * kLdP);
  // blocks an SM the shared memory allows (228 KB, 1 KB of it a block's)
  static constexpr int kBlocks = D <= 128 ? 4 : 2;
};

// s[i][j] += sum_k Q[tm + 16 i][k] K[tn + 8 j][k], k < D
template <int D>
__device__ __forceinline__ void scores(float (&s)[kRI][Tiles<D>::kNJ],
                                       const float* qs, const float* ks,
                                       int tm, int tn) {
  constexpr int kLd = Tiles<D>::kLd, kNJ = Tiles<D>::kNJ;
#pragma unroll 4
  for (int k = 0; k < D; k += 4) {
    float4 a[kRI], b[kNJ];
#pragma unroll
    for (int i = 0; i < kRI; ++i) a[i] = ld4(qs + (tm + kTM * i) * kLd + k);
#pragma unroll
    for (int j = 0; j < kNJ; ++j) b[j] = ld4(ks + (tn + kTN * j) * kLd + k);
#pragma unroll
    for (int i = 0; i < kRI; ++i) {
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
      }
    }
  }
}

// acc[i][h][e] += sum_k P[tm + 16 i][k] V[k][4 (tn + 8 h) + e], k < step
template <int D>
__device__ __forceinline__ void pv(float (&acc)[kRI][Tiles<D>::kH][4],
                                   const float* ps, const float* vs, int tm,
                                   int tn) {
  using T = Tiles<D>;
  constexpr int kLd = T::kLd, kLdP = T::kLdP;
#pragma unroll 2
  for (int k = 0; k < T::kStep; k += 4) {
    float4 a[kRI];
#pragma unroll
    for (int i = 0; i < kRI; ++i) a[i] = ld4(ps + (tm + kTM * i) * kLdP + k);
#pragma unroll
    for (int h = 0; h < T::kH; ++h) {
      const int c = tn + kTN * h;
      if (T::kChunks % kTN == 0 || c < T::kChunks) {
        float4 b[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) b[e] = ld4(vs + (k + e) * kLd + 4 * c);
#pragma unroll
        for (int i = 0; i < kRI; ++i) {
          fma4(acc[i][h], a[i].x, b[0]);
          fma4(acc[i][h], a[i].y, b[1]);
          fma4(acc[i][h], a[i].z, b[2]);
          fma4(acc[i][h], a[i].w, b[3]);
        }
      }
    }
  }
}

// q [BH, Tq, D], k / v [BH, Tk, D] -> o [BH, Tq, D] and, given a pointer,
// lse [BH, Tq] (natural units); grid (BH, ceil(Tq / 32)).
template <int D>
__global__ void __launch_bounds__(kThreads, Tiles<D>::kBlocks)
    attn_prefill_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ o, float* __restrict__ lse,
                            int Tq, int Tk, float scale, int causal,
                            int window, int kv_len, int q_offset) {
  using T = Tiles<D>;
  constexpr int kLd = T::kLd, kLdP = T::kLdP, kStep = T::kStep;
  constexpr int kNJ = T::kNJ, kH = T::kH;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kRows * kLd;
  float* Vs = Ks + kStep * kLd;
  float* Ps = Vs + kStep * kLd;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tm = warp * (32 / kTN) + lane / kTN, tn = lane % kTN;
  const long long bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const float* kb = k + bh * Tk * D;
  const float* vb = v + bh * Tk * D;

  // the keys any row of this block can see, in whole steps
  const int q_last = min(q0 + kRows, Tq) - 1;
  const int k_lim = min(kv_len, Tk);
  int k_end = k_lim;
  if (causal) k_end = min(k_end, q_offset + q_last + 1);
  const int k_begin = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
  const int kt0 = k_begin / kStep;
  const int kt1 = k_end > k_begin ? (k_end + kStep - 1) / kStep : kt0;

  stage<D>(Qs, q + bh * Tq * D, q0, kRows, Tq, kLd);
  if (kt0 < kt1) stage<D>(Ks, kb, kt0 * kStep, kStep, Tk, kLd);
  tile::cp_commit();

  // scores in log2 units, so that each exponential is one exp2
  const float sl2 = scale * kLog2e;
  int pos[kRI];
  float m[kRI], l[kRI], acc[kRI][kH][4];
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    pos[i] = q_offset + q0 + tm + kTM * i;
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int h = 0; h < kH; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][h][e] = 0.0f;
  }

  for (int kt = kt0; kt < kt1; ++kt) {
    const int key0 = kt * kStep;
    tile::cp_wait_all();
    __syncthreads();   // K staged; every thread done with the last V and P
    stage<D>(Vs, vb, key0, kStep, Tk, kLd);
    tile::cp_commit();

    float s[kRI][kNJ];
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < kNJ; ++j) s[i][j] = 0.0f;
    scores<D>(s, Qs, Ks, tm, tn);

    // every row of the block sees every key of the step, or the mask is
    // tested per element
    const bool full = key0 + kStep <= k_lim &&
                      (!causal || key0 + kStep - 1 <= q_offset + q0) &&
                      (window <= 0 || key0 > q_offset + q_last - window);
    if (full) {
#pragma unroll
      for (int i = 0; i < kRI; ++i)
#pragma unroll
        for (int j = 0; j < kNJ; ++j) s[i][j] *= sl2;
    } else {
#pragma unroll
      for (int i = 0; i < kRI; ++i) {
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          const int key = key0 + tn + kTN * j;
          const bool ok = key < k_lim && (!causal || key <= pos[i]) &&
                          (window <= 0 || key > pos[i] - window);
          s[i][j] = ok ? s[i][j] * sl2 : -INFINITY;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRI; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = 1; off < kTN; off <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      }
      const float mn = fmaxf(m[i], mx);
      const float corr = mn == -INFINITY ? 1.0f : exp2f(m[i] - mn);
      m[i] = mn;
      float ps = 0.0f;
      float* prow = Ps + (tm + kTM * i) * kLdP + tn;
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.0f : exp2f(s[i][j] - mn);
        prow[kTN * j] = p;
        ps += p;
      }
      l[i] = l[i] * corr + ps;   // this thread's share; the row's summed last
#pragma unroll
      for (int h = 0; h < kH; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][h][e] *= corr;
    }

    tile::cp_wait_all();
    __syncthreads();   // V staged, P complete; every thread done with K
    if (kt + 1 < kt1) {
      stage<D>(Ks, kb, key0 + kStep, kStep, Tk, kLd);
      tile::cp_commit();
    }
    pv<D>(acc, Ps, Vs, tm, tn);
  }
  // a block that walks no step has not waited for its Q
  tile::cp_wait_all();

#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 1; off < kTN; off <<= 1) {
      li += __shfl_xor_sync(kFull, li, off);
    }
    const int r = q0 + tm + kTM * i;
    if (r >= Tq) continue;
    if (lse != nullptr && tn == 0) {
      // m is in log2 units: lse = (m + log2 l) ln 2
      lse[bh * Tq + r] =
          li > 0.0f ? (m[i] + log2f(li)) * 0.6931471805599453f : INFINITY;
    }
    const float inv = li > 0.0f ? 1.0f / li : 0.0f;
    float* orow = o + (bh * Tq + r) * D;
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      const int c = tn + kTN * h;
      if (T::kChunks % kTN == 0 || c < T::kChunks) {
        *reinterpret_cast<float4*>(orow + 4 * c) =
            make_float4(acc[i][h][0] * inv, acc[i][h][1] * inv,
                        acc[i][h][2] * inv, acc[i][h][3] * inv);
      }
    }
  }
}

}  // namespace f32
}  // namespace attn_fwd
