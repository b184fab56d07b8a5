// ELL SpMV kernels K1-K4 for Hopper (sm_90a), rank-stacked.
//
// Replaces the four Pallas TPU kernels of
// src/repro/kernels/spmv_ell/spmv_ell.py:
//   K1 spmv_ell                  (_spmv_kernel)                  -> spmv_ell_kernel
//   K2 spmv_ell_blocked          (_spmv_blocked_kernel)          -> spmv_ell_bucket_range_kernel
//   K3 spmv_ell_blocked_partial  (_spmv_blocked_partial_kernel)  -> spmv_ell_bucket_range_kernel
//   K4 spmv_ell_blocked_skip     (_spmv_blocked_skip_kernel)     -> spmv_ell_bucket_skip_kernel
//
// Every operand is stacked over the P ranks of the distributed solve; one
// launch covers all ranks, with the rank on blockIdx.y.
//
// Bound.  Each kernel is bound by device-memory bytes, not arithmetic: per
// stored entry it reads a 4-byte column index and an 8-byte (f64) value and
// does one multiply-add, 1/6 flop per byte, far below the card's balance
// point.  The bound counts the entries a call must read (for K4 only the
// listed buckets), x once and y once, at the data sheet's 3.35 TB/s.
//
// K1 keeps the flat [P, R, K] layout, one thread per row: a warp's 32
// consecutive rows cover one contiguous span of cols/vals, so the k loop
// reuses each fetched cache line from L1.
//
// K2-K4: the bucket-major layout.  The TPU kernels read a row's C buckets
// of K entries from a [R, C*K] layout and copied the tile of one row
// block's bucket, BlockSpec((br, K)), into VMEM.  Kept on this card, that
// layout puts bucket b of 32 neighbouring rows C*K entries apart (3,168
// bytes of f64 vals on the fine level, C = 132, K = 3), so a warp's load
// touched 32 sectors for 24 useful bytes each, and K4 read 256 scattered
// pieces per listed bucket (0.2616 ms by CUDA events on its largest call
// against a 0.0251 ms bound; NVIDIA H100 80GB HBM3, 700.00 W).  The card
// therefore holds the bucketed operator bucket-major, cols/vals
// [P, C, R, K] (repro_torch.kernels.spmv_ell.ops.to_bucket_major, made
// once when the operator goes to the card): bucket b of rows r0..r1 is
// one run of (r1 - r0) * K consecutive entries, the tile the TPU fetched.
//
// The walk.  A thread block owns `rows` consecutive rows of one rank and
// walks their buckets in order (K4: its row block's list; K2/K3: every
// bucket of [lo, hi)).  Each thread reads its own row's K entries of the
// bucket straight into registers: the warp's 32 rows are one contiguous
// run of 32*K entries, so each fetched line is used whole across the K
// loads, and the bytes from device memory are the tile's own.  The K loads
// are unrolled for K <= 8 (the kernel is built for each K up to 8), so all
// are in flight before the x gathers, which go through the read-only path.
//
// Staging each tile through shared memory with cp.async instead (16-byte
// chunks, neighbouring threads on neighbouring chunks), one tile at a
// time or double-buffered, was measured against this on the largest path
// calls of K2-K4 and lost at every one: the staging cost more than it
// saved (the device times, on NVIDIA H100 80GB HBM3, 700.00 W, are in
// PERF.md section 6; that design is not kept).
//
// Threads per row.  A coarse level is small: K2's largest call, R = 2399
// rows of 8 ranks and 10 buckets, gives one thread per row 19,192 threads,
// each walking 10 buckets alone, some 7 % of what the card holds at once.
// So the launcher gives each row tpr threads, lane g taking buckets
// g, g + tpr, ..., with tpr the fewest that fill the card (at most the
// walk's steps and 32), and rows per block as many as fit 1024 threads
// (96 at tpr 10).  Lane g writes its partial to shared memory; lane 0 adds
// the partials in bucket order.  The fine level fills the card with one
// thread per row (tpr 1, 256 rows a block, no shared memory).
//
// The order of summation is the reference's: y0 first, then each bucket's
// K products summed in order into a partial and the partials added in walk
// order; steps past a row block's count are not taken, so they add exactly
// 0.  Products and sums are rounded one by one (no fused multiply-add), as
// the plain versions round them, so the two agree bit for bit.

#include <cuda_runtime.h>
#include "kernel_attrs.cuh"

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kThreads = 256;    // K1 threads per block
constexpr int kMaxRows = 256;    // K2/K3 rows per block, at most
constexpr int kMaxTpr = 32;      // threads per row, at most

// K1: y[p, i] = sum_k vals[p, i, k] * x[p, cols[p, i, k]].
// Replaces spmv_ell.py::spmv_ell (_spmv_kernel).  Bound: bytes; on the
// fine level (524,288 rows, 7 entries a row, 8 ranks) about 52 MB, some
// 16 us.  x (local ++ ghost ++ sentinel) is read through the read-only
// path.
template <typename T>
__global__ void spmv_ell_kernel(const int* __restrict__ cols,
                                const T* __restrict__ vals,
                                const T* __restrict__ x, T* __restrict__ y,
                                int R, int K, int N) {
  const int p = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const long long row = ((long long)p * R + i) * K;
  const T* xp = x + (long long)p * N;
  T acc = T(0);
  for (int k = 0; k < K; ++k) {
    acc += vals[row + k] * __ldg(xp + cols[row + k]);
  }
  y[(long long)p * R + i] = acc;
}

// ------------------------------------------------------ the bucket walk

// Multiply and add, each rounded on its own (never fused into an FMA), as
// the plain versions round them.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// One row's partial over one bucket: its K entries from e, x's slice at
// xj.  KT > 0: K == KT, every entry loaded before the first product.
template <typename T, int KT>
__device__ __forceinline__ T bucket_partial(const int* __restrict__ cols,
                                            const T* __restrict__ vals,
                                            long long e, const T* xj,
                                            int K) {
  if constexpr (KT > 0) {
    int c[KT];
    T v[KT];
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      c[k] = cols[e + k];
      v[k] = vals[e + k];
    }
    T part = mul_rn(v[0], __ldg(xj + c[0]));
#pragma unroll
    for (int k = 1; k < KT; ++k) {
      part = add_rn(part, mul_rn(v[k], __ldg(xj + c[k])));
    }
    return part;
  } else {
    T part = mul_rn(vals[e], __ldg(xj + cols[e]));
    for (int k = 1; k < K; ++k) {
      part = add_rn(part, mul_rn(vals[e + k], __ldg(xj + cols[e + k])));
    }
    return part;
  }
}

// The walk shared by K2/K3 and K4.  The block owns `rows` rows of rank p
// from blockIdx.x * rows on; blockDim = rows * tpr, thread t being row
// t % rows, lane t / rows.  Step j < steps visits bucket bucket_of(j),
// whose x slice starts at (bucket - base) * bc.  With tpr > 1, shared
// memory holds tpr * rows partials.
template <typename T, int KT, typename BucketOf>
__device__ __forceinline__ void bucket_walk(
    const int* __restrict__ cols, const T* __restrict__ vals,
    const T* __restrict__ x, const T* __restrict__ y0, T* __restrict__ y,
    int rows, int tpr, int R, int C, int K, int steps, BucketOf bucket_of,
    int base, int bc, int Nx) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* parts = reinterpret_cast<T*>(smem);
  const int p = blockIdx.y;
  const int r = threadIdx.x % rows;
  const int g = threadIdx.x / rows;
  const int row = blockIdx.x * rows + r;
  const bool live = row < R;
  const long long out = (long long)p * R + row;
  const T* xp = x + (long long)p * Nx;
  T acc = (y0 != nullptr && live && g == 0) ? y0[out] : T(0);
  for (int j0 = 0; j0 < steps; j0 += tpr) {
    const int j = j0 + g;
    T part = T(0);
    if (live && j < steps) {
      const int b = bucket_of(j);
      const long long e = ((long long)(p * C + b) * R + row) * K;
      part = bucket_partial<T, KT>(
          cols, vals, e, xp + (long long)(b - base) * bc, K);
      if (tpr == 1) acc = add_rn(acc, part);
    }
    if (tpr > 1) {
      parts[g * rows + r] = part;
      __syncthreads();
      if (g == 0 && live) {
        const int n = min(tpr, steps - j0);
        for (int s = 0; s < n; ++s) acc = add_rn(acc, parts[s * rows + r]);
      }
      __syncthreads();
    }
  }
  if (g == 0 && live) y[out] = acc;
}

// K2 and K3: every bucket of [lo, hi), x holding exactly the range's
// (hi - lo) * bc values, y0 (may be null) the carried output.
// Replaces spmv_ell.py::spmv_ell_blocked (_spmv_blocked_kernel; lo = 0,
// hi = C, no y0) and spmv_ell.py::spmv_ell_blocked_partial
// (_spmv_blocked_partial_kernel).  Bound: bytes, every stored entry of the
// range.
template <typename T, int KT>
__global__ void __launch_bounds__(1024) spmv_ell_bucket_range_kernel(
    const int* __restrict__ cols, const T* __restrict__ vals,
    const T* __restrict__ x, const T* __restrict__ y0, T* __restrict__ y,
    int rows, int tpr, int R, int C, int K, int lo, int hi, int bc) {
  bucket_walk<T, KT>(
      cols, vals, x, y0, y, rows, tpr, R, C, K, hi - lo,
      [lo](int j) { return lo + j; }, lo, bc, (hi - lo) * bc);
}

// K4: row block rb of rank p visits buckets lists[p, rb, 0:counts[p, rb]]
// in list order; x starts at bucket `base`.
// Replaces spmv_ell.py::spmv_ell_blocked_skip (_spmv_blocked_skip_kernel).
// Bound: bytes of the listed buckets only: on the fine level at most 5 of
// 132 buckets a row block, about 84 MB with x and y, some 25 us.  The
// thread block is exactly one row block of row_block_bucket_map and reads
// its own list and count (one broadcast load each), in place of the TPU's
// scalar prefetch; it touches no bucket it does not list.
template <typename T, int KT>
__global__ void __launch_bounds__(1024) spmv_ell_bucket_skip_kernel(
    const int* __restrict__ cols, const T* __restrict__ vals,
    const T* __restrict__ x, const int* __restrict__ lists,
    const int* __restrict__ counts, const T* __restrict__ y0,
    T* __restrict__ y, int rows, int tpr, int R, int C, int K, int M,
    int base, int bc, int Nx) {
  const long long blk = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  const int* list = lists + blk * M;
  bucket_walk<T, KT>(
      cols, vals, x, y0, y, rows, tpr, R, C, K, __ldg(counts + blk),
      [list](int j) { return __ldg(list + j); }, base, bc, Nx);
}

// ------------------------------------------------------------ launchers

inline dim3 row_grid(int R, int rows, int P) {
  return dim3((unsigned)((R + rows - 1) / rows), (unsigned)P);
}

int device_attribute(cudaDeviceAttr attr, int fallback) {
  int dev = 0, value = fallback;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&value, attr, dev) != cudaSuccess) {
    return fallback;
  }
  return value;
}

// Threads per row for a walk of `steps` buckets over P * R rows: the
// fewest that fill the card's resident threads, at most steps, kMaxTpr
// and `limit`, then evened out over the walk's rounds of tpr buckets.
inline int threads_per_row(long long P, long long R, int steps, int limit) {
  const long long card =
      (long long)device_attribute(cudaDevAttrMultiProcessorCount, 132) *
      device_attribute(cudaDevAttrMaxThreadsPerMultiProcessor, 2048);
  const long long rows = std::max(1LL, P * R);
  const int most = std::max(1, std::min({steps, kMaxTpr, limit}));
  const int tpr = (int)std::min<long long>((card + rows - 1) / rows, most);
  const int rounds = (steps + tpr - 1) / tpr;
  return std::max(1, (steps + rounds - 1) / std::max(1, rounds));
}

// Call f with std::integral_constant<int, KT>: K itself up to 8, else 0
// (the rolled loop).
template <typename F>
void with_unrolled_k(int K, F&& f) {
  switch (K) {
    case 1: f(std::integral_constant<int, 1>{}); break;
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 3: f(std::integral_constant<int, 3>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    case 5: f(std::integral_constant<int, 5>{}); break;
    case 6: f(std::integral_constant<int, 6>{}); break;
    case 7: f(std::integral_constant<int, 7>{}); break;
    case 8: f(std::integral_constant<int, 8>{}); break;
    default: f(std::integral_constant<int, 0>{}); break;
  }
}

template <typename T>
int launch_flat(const void* cols, const void* vals, const void* x, void* y,
                int P, int R, int K, int N, void* stream) {
  spmv_ell_kernel<T>
      <<<row_grid(R, kThreads, P), kThreads, 0, (cudaStream_t)stream>>>(
          (const int*)cols, (const T*)vals, (const T*)x, (T*)y, R, K, N);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_range(const void* cols, const void* vals, const void* x,
                 const void* y0, void* y, int P, int R, int C, int K, int lo,
                 int hi, int bc, void* stream) {
  const int steps = hi - lo;
  const int tpr = threads_per_row(P, R, steps, kMaxTpr);
  const int rows = std::min({kMaxRows, std::max(32, 1024 / tpr / 32 * 32),
                             (R + 31) / 32 * 32});
  const size_t smem = tpr > 1 ? (size_t)tpr * rows * sizeof(T) : 0;
  with_unrolled_k(K, [&](auto kt) {
    constexpr int KT = decltype(kt)::value;
    spmv_ell_bucket_range_kernel<T, KT>
        <<<row_grid(R, rows, P), rows * tpr, smem, (cudaStream_t)stream>>>(
            (const int*)cols, (const T*)vals, (const T*)x, (const T*)y0,
            (T*)y, rows, tpr, R, C, K, lo, hi, bc);
  });
  return (int)cudaGetLastError();
}

template <typename T>
int launch_skip(const void* cols, const void* vals, const void* x,
                const void* lists, const void* counts, const void* y0,
                void* y, int P, int R, int C, int K, int M, int br, int base,
                int bc, int Nx, void* stream) {
  const int tpr = threads_per_row(P, R, M, 1024 / br);
  const size_t smem = tpr > 1 ? (size_t)tpr * br * sizeof(T) : 0;
  with_unrolled_k(K, [&](auto kt) {
    constexpr int KT = decltype(kt)::value;
    spmv_ell_bucket_skip_kernel<T, KT>
        <<<row_grid(R, br, P), br * tpr, smem, (cudaStream_t)stream>>>(
            (const int*)cols, (const T*)vals, (const T*)x,
            (const int*)lists, (const int*)counts, (const T*)y0, (T*)y, br,
            tpr, R, C, K, M, base, bc, Nx);
  });
  return (int)cudaGetLastError();
}

// ------------------------------------------------- attributes (verify)

// Every kernel of this source at its launch's largest block: K1 at
// kThreads, K2-K4 at 1024 threads (rows * tpr) with tpr * rows partials
// of shared memory; __launch_bounds__(1024) promises that block an SM.
#define REPRO_SPMV_WALK(T, TN, KT)                                          \
  {"spmv_ell_bucket_range_kernel<" TN "," #KT ">",                          \
   (const void*)spmv_ell_bucket_range_kernel<T, KT>, 1024,                  \
   1024 * (int)sizeof(T), 1},                                               \
  {"spmv_ell_bucket_skip_kernel<" TN "," #KT ">",                           \
   (const void*)spmv_ell_bucket_skip_kernel<T, KT>, 1024,                   \
   1024 * (int)sizeof(T), 1},
#define REPRO_SPMV_WALKS(T, TN)                                             \
  REPRO_SPMV_WALK(T, TN, 0) REPRO_SPMV_WALK(T, TN, 1)                       \
  REPRO_SPMV_WALK(T, TN, 2) REPRO_SPMV_WALK(T, TN, 3)                       \
  REPRO_SPMV_WALK(T, TN, 4) REPRO_SPMV_WALK(T, TN, 5)                       \
  REPRO_SPMV_WALK(T, TN, 6) REPRO_SPMV_WALK(T, TN, 7)                       \
  REPRO_SPMV_WALK(T, TN, 8)

const repro_attrs::KernelEntry* kernel_table(int* n) {
  static const repro_attrs::KernelEntry table[] = {
      {"spmv_ell_kernel<f32>", (const void*)spmv_ell_kernel<float>,
       kThreads, 0, 0},
      {"spmv_ell_kernel<f64>", (const void*)spmv_ell_kernel<double>,
       kThreads, 0, 0},
      REPRO_SPMV_WALKS(float, "f32") REPRO_SPMV_WALKS(double, "f64")};
  *n = (int)(sizeof(table) / sizeof(table[0]));
  return table;
}

#undef REPRO_SPMV_WALKS
#undef REPRO_SPMV_WALK

}  // namespace

// Plain C interface, loaded with ctypes.  Each function launches on the
// given stream and returns cudaGetLastError() (0 on success).  K2-K4 take
// the bucket-major [P, C, R, K] cols/vals.

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int repro_spmv_ell_f32(const void* cols, const void* vals, const void* x,
                       void* y, int P, int R, int K, int N, void* stream) {
  return launch_flat<float>(cols, vals, x, y, P, R, K, N, stream);
}

int repro_spmv_ell_f64(const void* cols, const void* vals, const void* x,
                       void* y, int P, int R, int K, int N, void* stream) {
  return launch_flat<double>(cols, vals, x, y, P, R, K, N, stream);
}

int repro_spmv_ell_blocked_f32(const void* cols, const void* vals,
                               const void* x, void* y, int P, int R, int C,
                               int K, int bc, void* stream) {
  return launch_range<float>(cols, vals, x, nullptr, y, P, R, C, K, 0, C, bc,
                             stream);
}

int repro_spmv_ell_blocked_f64(const void* cols, const void* vals,
                               const void* x, void* y, int P, int R, int C,
                               int K, int bc, void* stream) {
  return launch_range<double>(cols, vals, x, nullptr, y, P, R, C, K, 0, C,
                              bc, stream);
}

int repro_spmv_ell_blocked_partial_f32(const void* cols, const void* vals,
                                       const void* x, const void* y0,
                                       void* y, int P, int R, int C, int K,
                                       int lo, int hi, int bc, void* stream) {
  return launch_range<float>(cols, vals, x, y0, y, P, R, C, K, lo, hi, bc,
                             stream);
}

int repro_spmv_ell_blocked_partial_f64(const void* cols, const void* vals,
                                       const void* x, const void* y0,
                                       void* y, int P, int R, int C, int K,
                                       int lo, int hi, int bc, void* stream) {
  return launch_range<double>(cols, vals, x, y0, y, P, R, C, K, lo, hi, bc,
                              stream);
}

int repro_spmv_ell_blocked_skip_f32(const void* cols, const void* vals,
                                    const void* x, const void* lists,
                                    const void* counts, const void* y0,
                                    void* y, int P, int R, int C, int K,
                                    int M, int br, int base, int bc, int Nx,
                                    void* stream) {
  return launch_skip<float>(cols, vals, x, lists, counts, y0, y, P, R, C, K,
                            M, br, base, bc, Nx, stream);
}

int repro_spmv_ell_blocked_skip_f64(const void* cols, const void* vals,
                                    const void* x, const void* lists,
                                    const void* counts, const void* y0,
                                    void* y, int P, int R, int C, int K,
                                    int M, int br, int base, int bc, int Nx,
                                    void* stream) {
  return launch_skip<double>(cols, vals, x, lists, counts, y0, y, P, R, C, K,
                             M, br, base, bc, Nx, stream);
}

}  // extern "C"

REPRO_KERNEL_ATTRIBUTES(kernel_table)
