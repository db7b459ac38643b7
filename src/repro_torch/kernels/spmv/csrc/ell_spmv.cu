// ell_spmv: y[d, i] = sum_k vals[d, i, k] * x[d, cols[d, i, k]]  (cols == -1 is padding)
//
// Replaces the Pallas kernel in repro/kernels/spmv/spmv.py, function ell_spmv
// (_spmv_kernel), with the rank dim of the distributed solve stacked in front
// so that one launch serves all D ranks: cols/vals [D, n, K], x [D, m] -> y [D, n].
//
// Bound on an H100 SXM (80 GB HBM3 at 3.35 TB/s): the kernel has to read
// every slot's column id (4 B, padding included), the value of every stored
// entry (sizeof(T); padded slots' values are never loaded), x once and write
// y once; with nnz = the count of cols >= 0:
//   t >= (D*n*K*4 + nnz*sizeof(T) + D*(m + n)*sizeof(T)) / 3.35e12 s.
// Two flops per slot is far below the card's float32/float64 rates, so the
// bytes bound it.
//
// Design against that bound: G lanes (4, 8, 16 or 32, the power of two at or
// above K, capped at a warp) share one row, so a row's cols/vals are read as
// one contiguous, coalesced segment rather than one strided load per thread.
// The x gathers go through the read-only cache (__ldg), where neighbouring
// rows' columns overlap.  The lanes' partial sums meet through warp shuffles:
// no shared memory, no atomics, no second pass.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename T, int G>
__global__ void ell_spmv_kernel(const int* __restrict__ cols,
                                const T* __restrict__ vals,
                                const T* __restrict__ x, T* __restrict__ y,
                                int64_t rows, int64_t n, int64_t K, int64_t m) {
  const int64_t tid = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int64_t row = tid / G;
  const int lane = static_cast<int>(threadIdx.x % G);
  T acc = T(0);
  if (row < rows) {
    const int64_t d = row / n;
    const int* c = cols + row * K;
    const T* v = vals + row * K;
    const T* xd = x + d * m;
    for (int64_t k = lane; k < K; k += G) {
      const int j = __ldg(c + k);
      if (j >= 0) acc += __ldg(v + k) * __ldg(xd + j);
    }
  }
  // every lane of the warp reaches the shuffles (no early return above)
  for (int off = G / 2; off > 0; off /= 2)
    acc += __shfl_down_sync(0xffffffffu, acc, off, G);
  if (row < rows && lane == 0) y[row] = acc;
}

template <typename T>
int launch(const int* cols, const T* vals, const T* x, T* y, int64_t D,
           int64_t n, int64_t K, int64_t m, cudaStream_t stream) {
  const int64_t rows = D * n;
  const int threads = 256;
  const int G = K <= 4 ? 4 : K <= 8 ? 8 : K <= 16 ? 16 : 32;
  const int64_t blocks = (rows * G + threads - 1) / threads;
  switch (G) {
    case 4:
      ell_spmv_kernel<T, 4><<<blocks, threads, 0, stream>>>(cols, vals, x, y, rows, n, K, m);
      break;
    case 8:
      ell_spmv_kernel<T, 8><<<blocks, threads, 0, stream>>>(cols, vals, x, y, rows, n, K, m);
      break;
    case 16:
      ell_spmv_kernel<T, 16><<<blocks, threads, 0, stream>>>(cols, vals, x, y, rows, n, K, m);
      break;
    default:
      ell_spmv_kernel<T, 32><<<blocks, threads, 0, stream>>>(cols, vals, x, y, rows, n, K, m);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  The caller
// guarantees D, n, K, m > 0, contiguous operands on one device, and
// 0 <= cols < m wherever cols != -1.
extern "C" int ell_spmv_launch(const void* cols, const void* vals, const void* x,
                               void* y, int64_t D, int64_t n, int64_t K,
                               int64_t m, int is_f64, void* stream) {
  const auto* c = static_cast<const int*>(cols);
  auto s = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return launch<double>(c, static_cast<const double*>(vals),
                          static_cast<const double*>(x), static_cast<double*>(y),
                          D, n, K, m, s);
  return launch<float>(c, static_cast<const float*>(vals),
                       static_cast<const float*>(x), static_cast<float*>(y),
                       D, n, K, m, s);
}
