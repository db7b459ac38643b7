// ell_spmm: Y[d, i, :] = sum_s vals[d, i, s] * X[d, cols[d, i, s], :]  (cols == -1 is padding)
//
// Replaces the Pallas kernel in repro/kernels/spmv/spmv.py, function ell_spmm
// (_spmm_kernel), the native multi-RHS form, with the rank dim stacked in
// front: cols/vals [D, n, K], X [D, m, k] -> Y [D, n, k].
//
// Bound on an H100 SXM (80 GB HBM3 at 3.35 TB/s): A is needed once for all k
// columns (every slot's column id, padding included, and the value of every
// stored entry only), X once and Y once; with nnz = the count of cols >= 0:
//   t >= (D*n*K*4 + nnz*sizeof(T) + D*(m + n)*k*sizeof(T)) / 3.35e12 s.
// Two flops per slot and column stay far below the card's float32/float64
// rates, so the bytes bound it.
//
// Design against that bound: one thread per output element with the RHS
// column fastest, so the k threads of one row read the same cols/vals word
// (one broadcast load serves all k columns: A streams once, as in the Pallas
// kernel) and gather the k contiguous values of each X row in one coalesced
// segment.  No shared memory and no atomics: each thread owns its output.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename T>
__global__ void ell_spmm_kernel(const int* __restrict__ cols,
                                const T* __restrict__ vals,
                                const T* __restrict__ X, T* __restrict__ Y,
                                int64_t rows, int64_t n, int64_t K, int64_t m,
                                int64_t k) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (t >= rows * k) return;
  const int64_t row = t / k;
  const int64_t j = t % k;
  const int64_t d = row / n;
  const int* c = cols + row * K;
  const T* v = vals + row * K;
  const T* xd = X + d * m * k + j;
  T acc = T(0);
  for (int64_t s = 0; s < K; ++s) {
    const int col = __ldg(c + s);
    if (col >= 0) acc += __ldg(v + s) * __ldg(xd + static_cast<int64_t>(col) * k);
  }
  Y[t] = acc;
}

template <typename T>
int launch(const int* cols, const T* vals, const T* X, T* Y, int64_t D,
           int64_t n, int64_t K, int64_t m, int64_t k, cudaStream_t stream) {
  const int64_t rows = D * n;
  const int threads = 256;
  const int64_t blocks = (rows * k + threads - 1) / threads;
  ell_spmm_kernel<T><<<blocks, threads, 0, stream>>>(cols, vals, X, Y, rows, n, K, m, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  The caller
// guarantees D, n, K, m, k > 0, contiguous operands on one device, and
// 0 <= cols < m wherever cols != -1.
extern "C" int ell_spmm_launch(const void* cols, const void* vals, const void* X,
                               void* Y, int64_t D, int64_t n, int64_t K,
                               int64_t m, int64_t k, int is_f64, void* stream) {
  const auto* c = static_cast<const int*>(cols);
  auto s = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return launch<double>(c, static_cast<const double*>(vals),
                          static_cast<const double*>(X), static_cast<double*>(Y),
                          D, n, K, m, k, s);
  return launch<float>(c, static_cast<const float*>(vals),
                       static_cast<const float*>(X), static_cast<float*>(Y),
                       D, n, K, m, k, s);
}
