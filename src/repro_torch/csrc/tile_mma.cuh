// Warp tile products shared by K7 (flash_attention.cu) and K8
// (ssd_scan.cu): one 16 x 8 x 16 product, D[16][8] += A[16][16] B[16][8],
// in the register layout of mma.sync.m16n8k16, with one primitive per
// element type.  A kernel is written once over these primitives:
//
// * bf16: operands are bf16 pairs packed in 32-bit registers, loaded from
//   shared memory by ldmatrix, and the product runs on the tensor cores
//   (mma.sync, bf16 x bf16 -> fp32).  The product of two bf16 values is
//   exact in fp32, so a product of two bf16 inputs is the fp32 product.
//   An operand that is an fp32 intermediate (a softmax weight, a decayed
//   matrix, a carried state) is split into hi = bf16(v) and
//   lo = bf16(v - hi) and multiplied as two products: hi + lo carries v to
//   about 2^-17 of |v|, where one bf16 rounding would carry it to 2^-9.
// * float: the same fragments hold fp32 values, and the product is fp32
//   FMAs on the CUDA cores, each lane gathering the rows and columns it
//   needs from its neighbours by shuffles.  It is the oracle replay's
//   type: TF32 would miss its tolerances.
//
// Fragment layout (lane = 4 g + c, g = lane / 4, c = lane % 4):
//   A (16 x 16, row-major): a0 a1 = A[g][2c, 2c+1],   a2 a3 = A[g+8][2c, 2c+1]
//                           a4 a5 = A[g][2c+8, 2c+9], a6 a7 = A[g+8][2c+8, ..]
//   B (16 x 8, k by n):      b0 b1 = B[2c, 2c+1][g],   b2 b3 = B[2c+8, 2c+9][g]
//   D (16 x 8):              d0 d1 = D[g][2c, 2c+1],   d2 d3 = D[g+8][2c, 2c+1]
// The D fragments of two neighbouring n-tiles are the A fragment of one
// k-step (d of tile 2k as a0..a3, of tile 2k+1 as a4..a7): a product's
// output feeds the next product from registers.
//
// Loads take a pointer to the tile's first element in shared memory and
// the row stride in elements; rows must start on 16 bytes.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tile {

constexpr unsigned kFull = 0xffffffffu;

template <typename E>
struct Frag;

struct SplitA16;
struct SplitA32;

template <>
struct Frag<__nv_bfloat16> {
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };
  using SplitA = SplitA16;   // an fp32 A operand (see split_a)
};

template <>
struct Frag<float> {
  struct A { float r[8]; };
  struct B { float r[4]; };
  using SplitA = SplitA32;
};

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack(float lo_k, float hi_k) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_k, hi_k);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t r) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&r));
}

// hi = bf16(v), lo = bf16(v - hi) for a pair of fp32 values
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi,
                                      uint32_t& lo) {
  hi = pack(v0, v1);
  const float2 h = unpack(hi);
  lo = pack(v0 - h.x, v1 - h.y);
}

// ---------------------------------------------------------------- bf16
__device__ __forceinline__ void mma(float d[4],
                                    const Frag<__nv_bfloat16>::A& a,
                                    const Frag<__nv_bfloat16>::B& b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]),
        "r"(b.r[1]));
}

// A[m][k] from row-major storage (k contiguous)
__device__ __forceinline__ void load_a(Frag<__nv_bfloat16>::A& a,
                                       const __nv_bfloat16* s, int ld) {
  const int l = lane_id(), i = l >> 3;
  const uint32_t p = smem_addr(s + ((i & 1) * 8 + (l & 7)) * ld + (i >> 1) * 8);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a.r[0]), "=r"(a.r[1]), "=r"(a.r[2]), "=r"(a.r[3])
      : "r"(p));
}

// A[m][k] from storage [k][m] (m contiguous)
__device__ __forceinline__ void load_a_trans(Frag<__nv_bfloat16>::A& a,
                                             const __nv_bfloat16* s, int ld) {
  const int l = lane_id(), i = l >> 3;
  const uint32_t p = smem_addr(s + ((i >> 1) * 8 + (l & 7)) * ld + (i & 1) * 8);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(a.r[0]), "=r"(a.r[1]), "=r"(a.r[2]), "=r"(a.r[3])
      : "r"(p));
}

// B[k][n] from storage [n][k] (k contiguous)
__device__ __forceinline__ void load_b(Frag<__nv_bfloat16>::B& b,
                                       const __nv_bfloat16* s, int ld) {
  const int l = lane_id() & 15;
  const uint32_t p = smem_addr(s + (l & 7) * ld + (l >> 3) * 8);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b.r[0]), "=r"(b.r[1])
      : "r"(p));
}

// B[k][n] from storage [k][n] (n contiguous)
__device__ __forceinline__ void load_b_trans(Frag<__nv_bfloat16>::B& b,
                                             const __nv_bfloat16* s, int ld) {
  const int l = lane_id() & 15;
  const uint32_t p = smem_addr(s + ((l >> 3) * 8 + (l & 7)) * ld);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b.r[0]), "=r"(b.r[1])
      : "r"(p));
}

// An A operand given as fp32 values in the A layout (a product's output),
// split once and then multiplied with every B it meets: two products each.
struct SplitA16 {
  Frag<__nv_bfloat16>::A hi, lo;
};

__device__ __forceinline__ void split_a(SplitA16& s, const float a[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    split(a[2 * i], a[2 * i + 1], s.hi.r[i], s.lo.r[i]);
  }
}

__device__ __forceinline__ void mma(float d[4], const SplitA16& a,
                                    const Frag<__nv_bfloat16>::B& b) {
  mma(d, a.hi, b);
  mma(d, a.lo, b);
}

// --------------------------------------------------------------- float
// D += A B by fp32 FMAs: for each quarter cc of k, lane (g, c) gathers
// A's rows g and g+8 from lane 4 g + cc and B's columns 2c and 2c+1 from
// lanes 8c + cc and 8c + 4 + cc.  Out of line: inlined at every tile of
// the float builds, it made the sources take a minute to compile.
__device__ __noinline__ float4 mma_f32(float4 d, const Frag<float>::A a,
                                       const Frag<float>::B b) {
  const int l = lane_id(), g = l >> 2, c = l & 3;
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) {
    float ar[8], b0[4], b1[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) ar[i] = __shfl_sync(kFull, a.r[i], 4 * g + cc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      b0[i] = __shfl_sync(kFull, b.r[i], 8 * c + cc);
      b1[i] = __shfl_sync(kFull, b.r[i], 8 * c + 4 + cc);
    }
    // k = 2cc, 2cc+1, 2cc+8, 2cc+9: A row g in ar 0 1 4 5, row g+8 in
    // ar 2 3 6 7; B in b 0 1 2 3
    d.x = fmaf(ar[0], b0[0], fmaf(ar[1], b0[1],
          fmaf(ar[4], b0[2], fmaf(ar[5], b0[3], d.x))));
    d.y = fmaf(ar[0], b1[0], fmaf(ar[1], b1[1],
          fmaf(ar[4], b1[2], fmaf(ar[5], b1[3], d.y))));
    d.z = fmaf(ar[2], b0[0], fmaf(ar[3], b0[1],
          fmaf(ar[6], b0[2], fmaf(ar[7], b0[3], d.z))));
    d.w = fmaf(ar[2], b1[0], fmaf(ar[3], b1[1],
          fmaf(ar[6], b1[2], fmaf(ar[7], b1[3], d.w))));
  }
  return d;
}

__device__ __forceinline__ void mma(float d[4], const Frag<float>::A& a,
                                    const Frag<float>::B& b) {
  const float4 r = mma_f32(make_float4(d[0], d[1], d[2], d[3]), a, b);
  d[0] = r.x;
  d[1] = r.y;
  d[2] = r.z;
  d[3] = r.w;
}

__device__ __forceinline__ void load_a(Frag<float>::A& a, const float* s,
                                       int ld) {
  const int l = lane_id(), g = l >> 2, c = l & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // (row g / g+8, k 2c / 2c+8)
    const float2 v = *reinterpret_cast<const float2*>(
        s + (g + (i & 1) * 8) * ld + 2 * c + (i >> 1) * 8);
    a.r[2 * i] = v.x;
    a.r[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void load_a_trans(Frag<float>::A& a,
                                             const float* s, int ld) {
  const int l = lane_id(), g = l >> 2, c = l & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* p = s + (2 * c + (i >> 1) * 8) * ld + g + (i & 1) * 8;
    a.r[2 * i] = p[0];
    a.r[2 * i + 1] = p[ld];
  }
}

__device__ __forceinline__ void load_b(Frag<float>::B& b, const float* s,
                                       int ld) {
  const int l = lane_id(), g = l >> 2, c = l & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 v =
        *reinterpret_cast<const float2*>(s + g * ld + 2 * c + i * 8);
    b.r[2 * i] = v.x;
    b.r[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void load_b_trans(Frag<float>::B& b,
                                             const float* s, int ld) {
  const int l = lane_id(), g = l >> 2, c = l & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float* p = s + (2 * c + i * 8) * ld + g;
    b.r[2 * i] = p[0];
    b.r[2 * i + 1] = p[ld];
  }
}

// in float an fp32 A operand is the fragment itself
struct SplitA32 {
  Frag<float>::A f;
};

__device__ __forceinline__ void split_a(SplitA32& s, const float a[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) s.f.r[i] = a[i];
}

__device__ __forceinline__ void mma(float d[4], const SplitA32& a,
                                    const Frag<float>::B& b) {
  mma(d, a.f, b);
}

// ------------------------------------------------- staged fp32 operands
// An fp32 operand that several warps read (a carried state, weighted
// inputs) is split once, where it is stored to shared memory: in bf16 as
// two arrays hi and lo, in float as one array (lo unused).
template <typename E>
struct Staged;
template <>
struct Staged<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int kArrays = 2;
};
template <>
struct Staged<float> {
  using T = float;
  static constexpr int kArrays = 1;
};

__device__ __forceinline__ void store_staged(__nv_bfloat16* hi,
                                             __nv_bfloat16* lo, float v0,
                                             float v1) {
  uint32_t h, l;
  split(v0, v1, h, l);
  *reinterpret_cast<uint32_t*>(hi) = h;
  *reinterpret_cast<uint32_t*>(lo) = l;
}

__device__ __forceinline__ void store_staged(float* hi, float*, float v0,
                                             float v1) {
  *reinterpret_cast<float2*>(hi) = make_float2(v0, v1);
}

// D += A B with B staged from storage [k][n] (n contiguous)
__device__ __forceinline__ void mma_staged_b_trans(
    float d[4], const Frag<__nv_bfloat16>::A& a, const __nv_bfloat16* hi,
    const __nv_bfloat16* lo, int ld) {
  Frag<__nv_bfloat16>::B bh, bl;
  load_b_trans(bh, hi, ld);
  load_b_trans(bl, lo, ld);
  mma(d, a, bh);
  mma(d, a, bl);
}

__device__ __forceinline__ void mma_staged_b_trans(float d[4],
                                                   const Frag<float>::A& a,
                                                   const float* hi,
                                                   const float*, int ld) {
  Frag<float>::B b;
  load_b_trans(b, hi, ld);
  mma(d, a, b);
}

// eight consecutive elements (16-byte aligned) as fp32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t r[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = unpack(r[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// ------------------------------------------------------------- cp.async
// 16 bytes from global to shared memory; zeros where !ok (nothing read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace tile
