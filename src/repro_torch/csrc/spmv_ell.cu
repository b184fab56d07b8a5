// ELL SpMV kernels K1-K4 for Hopper (sm_90a), rank-stacked.
//
// Replaces the four Pallas TPU kernels of
// src/repro/kernels/spmv_ell/spmv_ell.py:
//   K1 spmv_ell                  (_spmv_kernel)                  -> spmv_ell_kernel
//   K2 spmv_ell_blocked          (_spmv_blocked_kernel)          -> spmv_ell_bucket_range_kernel
//   K3 spmv_ell_blocked_partial  (_spmv_blocked_partial_kernel)  -> spmv_ell_bucket_range_kernel
//   K4 spmv_ell_blocked_skip     (_spmv_blocked_skip_kernel)     -> spmv_ell_bucket_skip_kernel
//
// Every operand is stacked over the P ranks of the distributed solve
// (cols/vals [P, R, W], x [P, N], y [P, R]); one launch covers all ranks,
// with the rank on blockIdx.y.  One thread owns one row.  The Pallas
// kernels' sequential column-bucket grid dim becomes a loop inside the
// thread that visits the buckets in ascending order, summing each bucket's
// partial product before adding it to the row's total, as the Pallas grid
// accumulated it.  K4's thread block is exactly one row block of
// row_block_bucket_map (block_rows threads) and reads that block's bucket
// list and count itself, in place of the TPU's scalar prefetch.
//
// Padding semantics are the reference's: flat padding entries point at the
// zero sentinel appended to x; bucketed padding entries are (in-bucket
// column 0, value 0), so they add exactly 0.  A ragged last row block is
// covered by threads that test i < R.
//
// Bound.  Each kernel is bound by device-memory bytes, not arithmetic: per
// stored entry it reads a 4-byte column index and an 8-byte (f64) value and
// does one multiply-add, 1/6 flop per byte, far below the card's balance
// point.  K1 on the paper problem's fine level (524,288 rows, 7 entries a
// row, 8 ranks stacked) streams about 44 MB of cols/vals plus x and y,
// about 52 MB in all: some 16 us at the data sheet's 3.35 TB/s.  The design
// answers with what a simple kernel can do: cols/vals are each read once,
// a warp's 32 consecutive rows cover one contiguous span of cols/vals so
// the k loop reuses each fetched cache line from L1, x is read through the
// read-only path (the band structure keeps it in L1/L2), and y is written
// once.  Staging cols/vals through shared memory with cp.async/TMA and
// L2-aware reuse of x are left to later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// K1: y[p, i] = sum_k vals[p, i, k] * x[p, cols[p, i, k]].
// Replaces spmv_ell.py::spmv_ell (_spmv_kernel).  Bound: bytes, as above
// (about 52 MB, 16 us, on the fine level).  x (local ++ ghost ++ sentinel)
// is read through the read-only path.
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

// K2 and K3: buckets [lo, hi) of the [P, R, W = C*K] bucketed layout; x
// holds exactly the range's (hi - lo) * bc values; y0 (may be null) is the
// carried output the buckets accumulate into.
// Replaces spmv_ell.py::spmv_ell_blocked (_spmv_blocked_kernel; lo = 0,
// hi = C, no y0) and spmv_ell.py::spmv_ell_blocked_partial
// (_spmv_blocked_partial_kernel).  Bound: bytes.  Every bucket of every
// row is padded to the widest bucket, so the layout is dense in buckets:
// on the fine level (132 buckets of width 3) it is about 2.5 GB of
// cols/vals, some 0.75 ms at 3.35 TB/s, against about 44 MB of stored
// entries.  The kernel streams it once, a row's buckets in one thread;
// skipping the empty buckets is K4's job.
template <typename T>
__global__ void spmv_ell_bucket_range_kernel(
    const int* __restrict__ cols, const T* __restrict__ vals,
    const T* __restrict__ x, const T* __restrict__ y0, T* __restrict__ y,
    int R, int W, int K, int lo, int hi, int bc, int Nx) {
  const int p = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const long long out = (long long)p * R + i;
  const long long row = out * W;
  const T* xp = x + (long long)p * Nx;
  T acc = y0 ? y0[out] : T(0);
  for (int j = lo; j < hi; ++j) {
    const long long e = row + (long long)j * K;
    const T* xj = xp + (long long)(j - lo) * bc;
    T part = T(0);
    for (int k = 0; k < K; ++k) {
      part += vals[e + k] * __ldg(xj + cols[e + k]);
    }
    acc += part;
  }
  y[out] = acc;
}

// K4: row block rb of rank p visits buckets lists[p, rb, 0:counts[p, rb]]
// in list order; x starts at bucket `base`.  Steps past the count are not
// taken, so they add exactly 0.
// Replaces spmv_ell.py::spmv_ell_blocked_skip (_spmv_blocked_skip_kernel).
// Bound: bytes of the listed buckets only: on the fine level at most 5 of
// 132 buckets per row block, about 90 MB with x and y, some 26 us.  The
// thread block reads its own list and count (the same address for every
// thread, served by one broadcast load) and touches no other bucket.
template <typename T>
__global__ void spmv_ell_bucket_skip_kernel(
    const int* __restrict__ cols, const T* __restrict__ vals,
    const T* __restrict__ x, const int* __restrict__ lists,
    const int* __restrict__ counts, const T* __restrict__ y0,
    T* __restrict__ y, int R, int W, int K, int M, int nrb, int base, int bc,
    int Nx) {
  const int p = blockIdx.y;
  const int rb = blockIdx.x;
  const int i = rb * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const long long out = (long long)p * R + i;
  const long long row = out * W;
  const T* xp = x + (long long)p * Nx;
  const long long blk = (long long)p * nrb + rb;
  const int* list = lists + blk * M;
  const int cnt = counts[blk];
  T acc = y0 ? y0[out] : T(0);
  for (int j = 0; j < cnt; ++j) {
    const int b = list[j];
    const long long e = row + (long long)b * K;
    const T* xj = xp + (long long)(b - base) * bc;
    T part = T(0);
    for (int k = 0; k < K; ++k) {
      part += vals[e + k] * __ldg(xj + cols[e + k]);
    }
    acc += part;
  }
  y[out] = acc;
}

inline dim3 row_grid(int R, int P) {
  return dim3((unsigned)((R + kThreads - 1) / kThreads), (unsigned)P);
}

template <typename T>
int launch_flat(const void* cols, const void* vals, const void* x, void* y,
                int P, int R, int K, int N, void* stream) {
  spmv_ell_kernel<T><<<row_grid(R, P), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)cols, (const T*)vals, (const T*)x, (T*)y, R, K, N);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_range(const void* cols, const void* vals, const void* x,
                 const void* y0, void* y, int P, int R, int W, int K, int lo,
                 int hi, int bc, int Nx, void* stream) {
  spmv_ell_bucket_range_kernel<T>
      <<<row_grid(R, P), kThreads, 0, (cudaStream_t)stream>>>(
          (const int*)cols, (const T*)vals, (const T*)x, (const T*)y0,
          (T*)y, R, W, K, lo, hi, bc, Nx);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_skip(const void* cols, const void* vals, const void* x,
                const void* lists, const void* counts, const void* y0,
                void* y, int P, int R, int W, int K, int M, int nrb, int br,
                int base, int bc, int Nx, void* stream) {
  spmv_ell_bucket_skip_kernel<T>
      <<<dim3((unsigned)nrb, (unsigned)P), br, 0, (cudaStream_t)stream>>>(
          (const int*)cols, (const T*)vals, (const T*)x, (const int*)lists,
          (const int*)counts, (const T*)y0, (T*)y, R, W, K, M, nrb, base,
          bc, Nx);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Each function launches on the
// given stream and returns cudaGetLastError() (0 on success).

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
                               const void* x, void* y, int P, int R, int W,
                               int K, int C, int bc, void* stream) {
  return launch_range<float>(cols, vals, x, nullptr, y, P, R, W, K, 0, C, bc,
                             C * bc, stream);
}

int repro_spmv_ell_blocked_f64(const void* cols, const void* vals,
                               const void* x, void* y, int P, int R, int W,
                               int K, int C, int bc, void* stream) {
  return launch_range<double>(cols, vals, x, nullptr, y, P, R, W, K, 0, C,
                              bc, C * bc, stream);
}

int repro_spmv_ell_blocked_partial_f32(const void* cols, const void* vals,
                                       const void* x, const void* y0,
                                       void* y, int P, int R, int W, int K,
                                       int lo, int hi, int bc,
                                       void* stream) {
  return launch_range<float>(cols, vals, x, y0, y, P, R, W, K, lo, hi, bc,
                             (hi - lo) * bc, stream);
}

int repro_spmv_ell_blocked_partial_f64(const void* cols, const void* vals,
                                       const void* x, const void* y0,
                                       void* y, int P, int R, int W, int K,
                                       int lo, int hi, int bc,
                                       void* stream) {
  return launch_range<double>(cols, vals, x, y0, y, P, R, W, K, lo, hi, bc,
                              (hi - lo) * bc, stream);
}

int repro_spmv_ell_blocked_skip_f32(const void* cols, const void* vals,
                                    const void* x, const void* lists,
                                    const void* counts, const void* y0,
                                    void* y, int P, int R, int W, int K,
                                    int M, int nrb, int br, int base, int bc,
                                    int Nx, void* stream) {
  return launch_skip<float>(cols, vals, x, lists, counts, y0, y, P, R, W, K,
                            M, nrb, br, base, bc, Nx, stream);
}

int repro_spmv_ell_blocked_skip_f64(const void* cols, const void* vals,
                                    const void* x, const void* lists,
                                    const void* counts, const void* y0,
                                    void* y, int P, int R, int W, int K,
                                    int M, int nrb, int br, int base, int bc,
                                    int Nx, void* stream) {
  return launch_skip<double>(cols, vals, x, lists, counts, y0, y, P, R, W, K,
                             M, nrb, br, base, bc, Nx, stream);
}

}  // extern "C"
