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
// key is masked has l == 0 and outputs exactly 0.  D is a template
// parameter, built for 64, 112, 128, 192 and 256: the GQA models' 64, 112
// (zamba2-7b), 128 and 256, and MLA's 192 (v zero-padded to 192 by the
// caller).  Two paths, chosen by the wrapper on Tq:
//
// Prefill (Tq > 1).  Bound: D multiply-adds twice for every visible
// (query, key) pair, some 4 GFLOP for DeepSeek-V2-Lite's MLA at a
// 400-token prompt (4 us on the tensor cores), against some 40 MB of q, k,
// v and out (12 us at 3.35 TB/s): the kernel has to keep the tensor cores
// fed and the scores out of device memory.  A block of 4 warps owns 64
// query rows of one (batch, head), 16 a warp; the row blocks are issued
// last-first, so the causal rows with the most keys start first.  Q is
// staged once and held in registers as the A fragments of the products;
// the key tiles any row of the block can see (tiles past kv_len, past the
// causal bound of the last row or before the window of the first are
// skipped) are staged by cp.async, the next tile's K and V while this one
// is computed, one block barrier a tile.  S = Q K^T runs as 16 x 8 x 16
// warp tiles (tile_mma.cuh), in bf16 on the tensor cores with exact
// products; the online softmax stays in registers in fp32; P V takes P
// from the score registers, split into two bf16 halves, so P keeps its
// fp32 value to about 2^-17 as in the reference, where P is fp32.  Key
// tiles are 64 keys; shared memory is two stages of K and V,
// [keys][D + 16 bytes] each (Q is staged over the second): 102,400 bytes
// at D 192, two blocks an SM; 61,440 at D 112, three.  In float32, the
// oracle replay's and the training path's type, attn_fwd_f32.cuh's
// register-blocked fp32 FMAs on the CUDA cores run instead (32 rows a
// block, 64 or 32 keys a step).  Given an lse pointer (training; null
// when serving) the epilogue also writes each row's log-sum-exp of the
// scaled scores, m + log l in natural units, fp32 [BH, Tq], +inf for a
// row that sees no key, so that the backward (flash_attention_bwd.cu)
// recomputes P as exp(S scale - lse) without a second pass over the keys.
//
// Decode (Tq = 1), split over keys.  One query row per (batch, head) reads
// its visible K and V once: bound by bytes (DeepSeek's step, 64 rows over
// up to 512 keys of D 192, some 25 MB, 7.5 us).  A first kernel gives
// each (batch * head, split of kSplit = 64 visible keys) a block of 4
// warps, 16 keys a warp; lanes read K and V rows in 16-byte vectors (a
// row of D / 8 vectors spread over a group of lanes, 32 / group keys a
// pass), every K load of the warp (and V load, where the registers allow)
// issued before the first is used, score by a shuffle reduction within the
// group, and reduce the split to a partial (m, l, acc[D]) in fp32, written
// to a scratch the wrapper allocates.  A second kernel combines the
// partials of each row in split order.  DeepSeek at 512 keys gives 512
// blocks, four an SM; the two launches are one call of K7.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "attn_fwd_f32.cuh"
#include "kernel_attrs.cuh"
#include "tile_mma.cuh"

namespace {

using tile::Frag;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;     // prefill: query rows a block
constexpr int kSplit = 64;             // decode: keys a block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void store2(float a, float b, float* o) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
__device__ __forceinline__ void store2(float a, float b, __nv_bfloat16* o) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store1(float a, float* o) { *o = a; }
__device__ __forceinline__ void store1(float a, __nv_bfloat16* o) {
  *o = __float2bfloat16(a);
}

// ----------------------------------------------------------------- prefill
// bf16 only: float32 runs attn_fwd_f32.cuh
template <typename E, int D>
struct Prefill {
  static_assert(sizeof(E) == 2, "float32 runs attn_fwd::f32");
  static constexpr int kPad = 16 / (int)sizeof(E);   // 16 bytes a row
  static constexpr int kLd = D + kPad;               // staged row stride
  static constexpr int kKeys = 64;
  static constexpr int kTile = kKeys * kLd;          // elements of a tile
  static constexpr int kBytes = 4 * kTile * (int)sizeof(E);
  static_assert(2 * kKeys >= kRows, "Q is staged over the second stage");
};

template <typename E, int D>
__global__ void __launch_bounds__(kThreads) attn_prefill_kernel(
    const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
    E* __restrict__ o, float* __restrict__ lse, int Tq, int Tk, float scale,
    int causal, int window, int kv_len, int q_offset) {
  using Sm = Prefill<E, D>;
  constexpr int kLd = Sm::kLd, kKeys = Sm::kKeys;
  constexpr int kVec = 16 / (int)sizeof(E);
  constexpr int kRowV = D / kVec;       // 16-byte vectors a row
  constexpr int kKT = D / 16;           // k-steps of Q K^T
  constexpr int kNT = D / 8;            // n-tiles of the output
  constexpr int kST = kKeys / 8;        // n-tiles of a score tile
  extern __shared__ __align__(16) unsigned char smem[];
  E* base = reinterpret_cast<E*>(smem);
  auto Ks = [&](int s) { return base + 2 * s * Sm::kTile; };
  auto Vs = [&](int s) { return base + (2 * s + 1) * Sm::kTile; };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const long long bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const E* qb = q + bh * Tq * D;
  const E* kb = k + bh * Tk * D;
  const E* vb = v + bh * Tk * D;

  // the keys any row of this block can see, in whole tiles
  const int q_last = min(q0 + kRows, Tq) - 1;
  const int k_lim = min(kv_len, Tk);
  int k_end = k_lim;
  if (causal) k_end = min(k_end, q_offset + q_last + 1);
  const int k_begin = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
  const int kt0 = k_begin / kKeys;
  const int kt1 = k_end > k_begin ? (k_end + kKeys - 1) / kKeys : kt0;

  auto stage = [&](int kt, int s) {
    const int key0 = kt * kKeys;
    for (int i = tid; i < kKeys * kRowV; i += kThreads) {
      const int j = i / kRowV, col = (i - j * kRowV) * kVec;
      const bool ok = key0 + j < Tk;
      const long long off = ok ? (long long)(key0 + j) * D + col : 0;
      tile::cp16(Ks(s) + j * kLd + col, kb + off, ok);
      tile::cp16(Vs(s) + j * kLd + col, vb + off, ok);
    }
  };

  E* Qs = Ks(1);
  for (int i = tid; i < kRows * kRowV; i += kThreads) {
    const int r = i / kRowV, col = (i - r * kRowV) * kVec;
    const bool ok = q0 + r < Tq;
    const long long off = ok ? (long long)(q0 + r) * D + col : 0;
    tile::cp16(Qs + r * kLd + col, qb + off, ok);
  }
  if (kt0 < kt1) stage(kt0, 0);
  tile::cp_commit();
  tile::cp_wait_all();
  __syncthreads();
  typename Frag<E>::A qf[kKT];
#pragma unroll
  for (int kk = 0; kk < kKT; ++kk) {
    tile::load_a(qf[kk], Qs + 16 * warp * kLd + 16 * kk, kLd);
  }
  __syncthreads();   // Q's region is the second stage from here

  // scores in log2 units, so that each exponential is one exp2
  const float sl2 = scale * 1.4426950408889634f;
  // rows g and g + 8 of the warp's 16, at absolute positions pa and pb
  const int pa = q_offset + q0 + 16 * warp + g, pb = pa + 8;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;
  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.0f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int s = (kt - kt0) & 1;
    if (kt > kt0) {
      tile::cp_wait_all();
      __syncthreads();   // tile kt staged; tile kt - 1 done by every warp
    }
    if (kt + 1 < kt1) {
      stage(kt + 1, s ^ 1);
      tile::cp_commit();
    }
    const E* Kc = Ks(s);
    const E* Vc = Vs(s);

    float sc[kST][4];
#pragma unroll
    for (int j = 0; j < kST; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[j][i] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kKT; ++kk) {
        typename Frag<E>::B kf;
        tile::load_b(kf, Kc + 8 * j * kLd + 16 * kk, kLd);
        tile::mma(sc[j], qf[kk], kf);
      }
    }

    // mask, scale and the rows' max over the tile
    const int key0 = kt * kKeys;
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < kST; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + 8 * j + 2 * c + e;
        const bool in = key < k_lim;
        const bool ok_a = in && (!causal || key <= pa) &&
                          (window <= 0 || key > pa - window);
        const bool ok_b = in && (!causal || key <= pb) &&
                          (window <= 0 || key > pb - window);
        sc[j][e] = ok_a ? sc[j][e] * sl2 : -INFINITY;
        sc[j][2 + e] = ok_b ? sc[j][2 + e] * sl2 : -INFINITY;
        mx_a = fmaxf(mx_a, sc[j][e]);
        mx_b = fmaxf(mx_b, sc[j][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(kFull, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(kFull, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float corr_a = mn_a == -INFINITY ? 1.0f : exp2f(m_a - mn_a);
    const float corr_b = mn_b == -INFINITY ? 1.0f : exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.0f, ps_b = 0.0f;
#pragma unroll
    for (int j = 0; j < kST; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[j][e] = sc[j][e] == -INFINITY ? 0.0f : exp2f(sc[j][e] - mn_a);
        sc[j][2 + e] =
            sc[j][2 + e] == -INFINITY ? 0.0f : exp2f(sc[j][2 + e] - mn_b);
        ps_a += sc[j][e];
        ps_b += sc[j][2 + e];
      }
    }
    l_a = l_a * corr_a + ps_a;   // this lane's share; the quad's summed last
    l_b = l_b * corr_b + ps_b;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      acc[n][0] *= corr_a;
      acc[n][1] *= corr_a;
      acc[n][2] *= corr_b;
      acc[n][3] *= corr_b;
    }

    // O += P V, P from the score registers
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const float pv[8] = {sc[2 * kk][0], sc[2 * kk][1], sc[2 * kk][2],
                           sc[2 * kk][3], sc[2 * kk + 1][0],
                           sc[2 * kk + 1][1], sc[2 * kk + 1][2],
                           sc[2 * kk + 1][3]};
      typename Frag<E>::SplitA pf;
      tile::split_a(pf, pv);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        typename Frag<E>::B vf;
        tile::load_b_trans(vf, Vc + 16 * kk * kLd + 8 * n, kLd);
        tile::mma(acc[n], pf, vf);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(kFull, l_a, off);
    l_b += __shfl_xor_sync(kFull, l_b, off);
  }
  const float inv_a = l_a > 0.0f ? 1.0f / l_a : 0.0f;
  const float inv_b = l_b > 0.0f ? 1.0f / l_b : 0.0f;
  const int ra = q0 + 16 * warp + g, rb = ra + 8;
  if (lse != nullptr && c == 0) {
    // m is in log2 units: lse = (m + log2 l) ln 2
    const float kLn2 = 0.6931471805599453f;
    if (ra < Tq) {
      lse[bh * Tq + ra] = l_a > 0.0f ? (m_a + log2f(l_a)) * kLn2 : INFINITY;
    }
    if (rb < Tq) {
      lse[bh * Tq + rb] = l_b > 0.0f ? (m_b + log2f(l_b)) * kLn2 : INFINITY;
    }
  }
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const int col = 8 * n + 2 * c;
    if (ra < Tq) {
      store2(acc[n][0] * inv_a, acc[n][1] * inv_a,
             o + (bh * Tq + ra) * D + col);
    }
    if (rb < Tq) {
      store2(acc[n][2] * inv_b, acc[n][3] * inv_b,
             o + (bh * Tq + rb) * D + col);
    }
  }
}

// ------------------------------------------------------------------ decode
constexpr int pow2_ceil(int n) {
  return n <= 1 ? 1 : 2 * pow2_ceil((n + 1) / 2);
}

template <typename E, int D>
struct Decode {
  static constexpr int kVec = 16 / (int)sizeof(E);   // elements a vector
  static constexpr int kNV = D / kVec;               // vectors a row
  static constexpr int kGroup = kNV >= 32 ? 32 : pow2_ceil(kNV);  // lanes a key
  static constexpr int kVPL = (kNV + kGroup - 1) / kGroup;   // vectors a lane
  static constexpr int kKPP = 32 / kGroup;           // keys a pass
  static constexpr int kPasses = kSplit / kWarps / kKPP;
  static_assert(D % kVec == 0 && kPasses * kKPP * kWarps == kSplit, "shapes");
};

union Vec16 {
  uint4 u;
  float f[4];
  __nv_bfloat162 h[4];
};

template <typename E>
__device__ __forceinline__ void vec_to_float(const Vec16& v, float* out);
template <>
__device__ __forceinline__ void vec_to_float<float>(const Vec16& v,
                                                    float* out) {
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = v.f[i];
}
template <>
__device__ __forceinline__ void vec_to_float<__nv_bfloat16>(const Vec16& v,
                                                            float* out) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(v.h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Per (row bh, split): the partial (m, l, acc[D]) over the split's keys of
// the visible range [k_begin, k_end), m in log2 units; m = -inf and l = 0
// where none is.
template <typename E, int D>
__global__ void __launch_bounds__(kThreads) attn_decode_split_kernel(
    const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int Tk,
    float scale, int k_begin, int k_end) {
  using Sh = Decode<E, D>;
  constexpr int kVec = Sh::kVec, kNV = Sh::kNV, kGroup = Sh::kGroup;
  constexpr int kVPL = Sh::kVPL, kKPP = Sh::kKPP, kPasses = Sh::kPasses;
  __shared__ float sm_acc[kWarps][D];
  __shared__ float sm_m[kWarps], sm_l[kWarps];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gl = lane % kGroup;            // the lane's place in its group
  const long long bh = blockIdx.x;
  const int split = blockIdx.y, n_split = gridDim.y;
  const E* kb = k + bh * Tk * D;
  const E* vb = v + bh * Tk * D;
  const int key_lo = k_begin + split * kSplit + warp * (kSplit / kWarps) +
                     lane / kGroup;

  float qf[kVPL][kVec];
#pragma unroll
  for (int i = 0; i < kVPL; ++i) {
    const int vi = gl + kGroup * i;
    Vec16 t;
    t.u = make_uint4(0, 0, 0, 0);
    if (vi < kNV) t.u = __ldg(reinterpret_cast<const uint4*>(q + bh * D) + vi);
    vec_to_float<E>(t, qf[i]);
  }

  // the warp's K and V vectors, loaded together (V too where the
  // registers allow), so that the split costs one round trip to memory
  constexpr bool kPrefetchV = kPasses * kVPL <= 16;
  Vec16 kr[kPasses][kVPL], vr[kPrefetchV ? kPasses : 1][kVPL];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int key = key_lo + p * kKPP;
#pragma unroll
    for (int i = 0; i < kVPL; ++i) {
      const int vi = gl + kGroup * i;
      const bool ok = key < k_end && vi < kNV;
      const long long off = (long long)key * D / kVec + vi;
      kr[p][i].u = ok ? __ldg(reinterpret_cast<const uint4*>(kb) + off)
                      : make_uint4(0, 0, 0, 0);
      if constexpr (kPrefetchV) {
        vr[p][i].u = ok ? __ldg(reinterpret_cast<const uint4*>(vb) + off)
                        : make_uint4(0, 0, 0, 0);
      }
    }
  }
  float s[kPasses];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    float dot = 0.0f;
#pragma unroll
    for (int i = 0; i < kVPL; ++i) {
      float kf[kVec];
      vec_to_float<E>(kr[p][i], kf);
#pragma unroll
      for (int e = 0; e < kVec; ++e) dot = fmaf(qf[i][e], kf[e], dot);
    }
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1) {
      dot += __shfl_xor_sync(kFull, dot, off);
    }
    s[p] = key_lo + p * kKPP < k_end
               ? dot * scale * 1.4426950408889634f   // log2 units
               : -INFINITY;
  }
  float m = -INFINITY;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) m = fmaxf(m, s[p]);
#pragma unroll
  for (int off = kGroup; off < 32; off <<= 1) {
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  }
  float l = 0.0f, acc[kVPL][kVec];
#pragma unroll
  for (int i = 0; i < kVPL; ++i)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[i][e] = 0.0f;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    if (s[p] == -INFINITY) continue;
    const float w = exp2f(s[p] - m);
    l += w;
    const long long key = key_lo + p * kKPP;
#pragma unroll
    for (int i = 0; i < kVPL; ++i) {
      const int vi = gl + kGroup * i;
      Vec16 t;
      if constexpr (kPrefetchV) {
        t.u = vr[p][i].u;
      } else {
        t.u = vi < kNV ? __ldg(reinterpret_cast<const uint4*>(vb) +
                               key * D / kVec + vi)
                       : make_uint4(0, 0, 0, 0);
      }
      float vf[kVec];
      vec_to_float<E>(t, vf);
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[i][e] = fmaf(w, vf[e], acc[i][e]);
    }
  }
  // the groups of the warp scored different keys over the same columns
#pragma unroll
  for (int off = kGroup; off < 32; off <<= 1) {
    l += __shfl_xor_sync(kFull, l, off);
#pragma unroll
    for (int i = 0; i < kVPL; ++i)
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        acc[i][e] += __shfl_xor_sync(kFull, acc[i][e], off);
      }
  }
  if (lane < kGroup) {
#pragma unroll
    for (int i = 0; i < kVPL; ++i) {
      const int vi = gl + kGroup * i;
      if (vi < kNV) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) sm_acc[warp][vi * kVec + e] = acc[i][e];
      }
    }
  }
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  __syncthreads();
  // the split's partial over the warps, in warp order
  float mb = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, sm_m[w]);
  float wt[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    wt[w] = sm_m[w] == -INFINITY ? 0.0f : exp2f(sm_m[w] - mb);
  }
  const long long part = bh * n_split + split;
  for (int d = tid; d < D; d += kThreads) {
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a = fmaf(wt[w], sm_acc[w][d], a);
    part_acc[part * D + d] = a;
  }
  if (tid == 0) {
    float lb = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) lb = fmaf(wt[w], sm_l[w], lb);
    part_ml[2 * part] = mb;
    part_ml[2 * part + 1] = lb;
  }
}

// out[bh] = sum_s acc_s exp(m_s - m) / sum_s l_s exp(m_s - m), in split
// order; 0 where no key is visible
template <typename E, int D>
__global__ void __launch_bounds__(kThreads) attn_decode_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    E* __restrict__ o, int n_split) {
  const long long bh = blockIdx.x;
  const float* ml = part_ml + 2 * bh * n_split;
  float m = -INFINITY;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, ml[2 * s]);
  float l = 0.0f;
  if (m != -INFINITY) {
    for (int s = 0; s < n_split; ++s) {
      if (ml[2 * s] != -INFINITY) {
        l = fmaf(exp2f(ml[2 * s] - m), ml[2 * s + 1], l);
      }
    }
  }
  const float inv = l > 0.0f ? 1.0f / l : 0.0f;
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float a = 0.0f;
    if (m != -INFINITY) {
      for (int s = 0; s < n_split; ++s) {
        if (ml[2 * s] != -INFINITY) {
          a = fmaf(exp2f(ml[2 * s] - m),
                   part_acc[(bh * n_split + s) * D + d], a);
        }
      }
    }
    store1(a * inv, o + bh * D + d);
  }
}

// ----------------------------------------------------------------- launch
// Allow a kernel the dynamic shared memory of its launch, once.
template <typename K>
int allow_smem(K kernel, int bytes, bool* done) {
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

template <typename E, int D>
int launch_prefill(const void* q, const void* k, const void* v, void* o,
                   float* lse, int BH, int Tq, int Tk, float scale, int causal,
                   int window, int kv_len, int q_offset, cudaStream_t stream) {
  static bool attr_set = false;
  if constexpr (std::is_same<E, float>::value) {
    namespace f = attn_fwd::f32;
    constexpr int bytes = f::Tiles<D>::kBytes;
    const int err = allow_smem(f::attn_prefill_f32_kernel<D>, bytes,
                               &attr_set);
    if (err) return err;
    dim3 grid(BH, (Tq + f::kRows - 1) / f::kRows);
    f::attn_prefill_f32_kernel<D><<<grid, f::kThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, Tq, Tk,
        scale, causal, window, kv_len, q_offset);
  } else {
    constexpr int bytes = Prefill<E, D>::kBytes;
    const int err = allow_smem(attn_prefill_kernel<E, D>, bytes, &attr_set);
    if (err) return err;
    dim3 grid(BH, (Tq + kRows - 1) / kRows);
    attn_prefill_kernel<E, D><<<grid, kThreads, bytes, stream>>>(
        static_cast<const E*>(q), static_cast<const E*>(k),
        static_cast<const E*>(v), static_cast<E*>(o), lse, Tq, Tk, scale,
        causal, window, kv_len, q_offset);
  }
  return (int)cudaGetLastError();
}

template <typename E, int D>
int launch_decode(const void* q, const void* k, const void* v, void* o,
                  float* part_acc, float* part_ml, int BH, int Tk,
                  float scale, int k_begin, int k_end, int n_split,
                  cudaStream_t stream) {
  attn_decode_split_kernel<E, D><<<dim3(BH, n_split), kThreads, 0, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), part_acc, part_ml, Tk, scale, k_begin, k_end);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_decode_combine_kernel<E, D><<<BH, kThreads, 0, stream>>>(
      part_acc, part_ml, static_cast<E*>(o), n_split);
  return (int)cudaGetLastError();
}

#define REPRO_ATTN_DIMS(X) X(64) X(112) X(128) X(192) X(256)

template <typename E>
int prefill(const void* q, const void* k, const void* v, void* o,
            float* lse, int BH, int Tq, int Tk, int D, float scale,
            int causal, int window, int kv_len, int q_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_ATTN_CASE(DIM)                                                 \
  case DIM:                                                                  \
    return launch_prefill<E, DIM>(q, k, v, o, lse, BH, Tq, Tk, scale,        \
                                  causal, window, kv_len, q_offset, s);
  switch (D) {
    REPRO_ATTN_DIMS(REPRO_ATTN_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_ATTN_CASE
}

template <typename E>
int decode(const void* q, const void* k, const void* v, void* o,
           float* part_acc, float* part_ml, int BH, int Tk, int D,
           float scale, int k_begin, int k_end, int n_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_ATTN_CASE(DIM)                                                 \
  case DIM:                                                                  \
    return launch_decode<E, DIM>(q, k, v, o, part_acc, part_ml, BH, Tk,      \
                                 scale, k_begin, k_end, n_split, s);
  switch (D) {
    REPRO_ATTN_DIMS(REPRO_ATTN_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_ATTN_CASE
}

// ------------------------------------------------- attributes (verify)

// Every kernel of this source at its launch: kThreads a block; the bf16
// prefill with Prefill<E, D>::kBytes of dynamic shared memory, the float32
// one (attn_fwd::f32) with its Tiles<D>::kBytes and the blocks an SM its
// __launch_bounds__ promise.
#define REPRO_ATTN_DECODE(E, EN, DIM)                                       \
  {"attn_decode_split_kernel<" EN "," #DIM ">",                             \
   (const void*)attn_decode_split_kernel<E, DIM>, kThreads, 0, 1},          \
  {"attn_decode_combine_kernel<" EN "," #DIM ">",                           \
   (const void*)attn_decode_combine_kernel<E, DIM>, kThreads, 0, 1},
#define REPRO_ATTN_BF16(DIM)                                                \
  {"attn_prefill_kernel<bf16," #DIM ">",                                    \
   (const void*)attn_prefill_kernel<__nv_bfloat16, DIM>, kThreads,          \
   Prefill<__nv_bfloat16, DIM>::kBytes, 1},                                 \
  REPRO_ATTN_DECODE(__nv_bfloat16, "bf16", DIM)
#define REPRO_ATTN_F32(DIM)                                                 \
  {"attn_prefill_f32_kernel<" #DIM ">",                                     \
   (const void*)attn_fwd::f32::attn_prefill_f32_kernel<DIM>,                \
   attn_fwd::f32::kThreads, attn_fwd::f32::Tiles<DIM>::kBytes,              \
   attn_fwd::f32::Tiles<DIM>::kBlocks},                                     \
  REPRO_ATTN_DECODE(float, "f32", DIM)

const repro_attrs::KernelEntry* kernel_table(int* n) {
  static const repro_attrs::KernelEntry table[] = {
      REPRO_ATTN_DIMS(REPRO_ATTN_BF16) REPRO_ATTN_DIMS(REPRO_ATTN_F32)};
  *n = (int)(sizeof(table) / sizeof(table[0]));
  return table;
}

#undef REPRO_ATTN_F32
#undef REPRO_ATTN_BF16
#undef REPRO_ATTN_DECODE

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K7, Tq > 1: [BH, Tq, D] / [BH, Tk, D] rows; D one of 64, 112, 128, 192,
// 256; lse [BH, Tq] fp32, or null.
int repro_flash_attention_bh_bf16(const void* q, const void* k,
                                  const void* v, void* o, float* lse, int BH,
                                  int Tq, int Tk, int D, float scale,
                                  int causal, int window, int kv_len,
                                  int q_offset, void* stream) {
  return prefill<__nv_bfloat16>(q, k, v, o, lse, BH, Tq, Tk, D, scale,
                                causal, window, kv_len, q_offset, stream);
}

int repro_flash_attention_bh_f32(const void* q, const void* k, const void* v,
                                 void* o, float* lse, int BH, int Tq, int Tk,
                                 int D, float scale, int causal, int window,
                                 int kv_len, int q_offset, void* stream) {
  return prefill<float>(q, k, v, o, lse, BH, Tq, Tk, D, scale, causal,
                        window, kv_len, q_offset, stream);
}

// K7, Tq = 1: the visible keys [k_begin, k_end) in n_split splits of 64,
// the partials in part_acc [BH, n_split, D] and part_ml [BH, n_split, 2]
// (fp32 scratch), then combined into o [BH, 1, D]: two launches.
int repro_flash_decode_bf16(const void* q, const void* k, const void* v,
                            void* o, float* part_acc, float* part_ml, int BH,
                            int Tk, int D, float scale, int k_begin,
                            int k_end, int n_split, void* stream) {
  return decode<__nv_bfloat16>(q, k, v, o, part_acc, part_ml, BH, Tk, D,
                               scale, k_begin, k_end, n_split, stream);
}

int repro_flash_decode_f32(const void* q, const void* k, const void* v,
                           void* o, float* part_acc, float* part_ml, int BH,
                           int Tk, int D, float scale, int k_begin,
                           int k_end, int n_split, void* stream) {
  return decode<float>(q, k, v, o, part_acc, part_ml, BH, Tk, D, scale,
                       k_begin, k_end, n_split, stream);
}

}  // extern "C"

REPRO_KERNEL_ATTRIBUTES(kernel_table)
