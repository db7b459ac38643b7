// block_diag_apply: y[d, i, j] = x[d, i, j] + w * sum_c Binv[d, i/bs, i%bs, c] * r[d, (i/bs)*bs + c, j]
//
// The block-Jacobi sweep of the distributed solve, x <- x + w * M^-1 (b - A x)
// with M the bs x bs block diagonal of each rank's local square block (the
// block grid restarts at each rank's first row).  It replaces no Pallas
// kernel: the reference applies a dense per-rank factor, `minv @ r` with minv
// [D, m, m] (repro/amg/dist_solve.py, DistHierarchy._relax and
// DistLevel.smoother_minv("bj")), which at laplace_3d(64) on 2 x 4 ranks
// would hold 8 * 32768^2 values (69 GB in float64).  Only the blocks are
// kept: Binv [D, nb, bs, bs], nb = ceil(m / bs), the rows of the last block
// past m never read; r, x, y [D, m, k] (k = 1 for vectors).
//
// Bound on an H100 SXM (80 GB HBM3 at 3.35 TB/s): Binv, r and x are read
// once and y written once:
//   t >= (D*nb*bs*bs + 3*D*m*k) * sizeof(T) / 3.35e12 s.
// 2*bs flops per output are far below the card's rates, so the bytes bound it.
//
// Design: one thread per output (row, column), the column fastest, so a warp
// reads consecutive Binv rows (one 32-byte sector per row at bs 4 in float64)
// and the r entries of a block once per column through the read-only path;
// neighbouring rows of one block read the same r entries, which the L1 serves.
// The sum runs over the block's columns in order, so results repeat bit for
// bit.  Index arithmetic is 32-bit where the operand fits, as the solve's do.
//
// Value types (value_types.cuh): float32 and float64 compute in their own
// type; bfloat16 loads Binv, r and x as bfloat16, widens them, takes the
// products, the block row's sum, w and x + w * sum in float32, and rounds
// once, at the store of y.
#include <cuda_runtime.h>

#include <cstdint>

#include "value_types.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = int64_t{1} << 20;

template <typename T, typename I, typename A = typename Acc<T>::type>
__global__ void __launch_bounds__(THREADS)
block_diag_apply_kernel(const T* __restrict__ binv, const T* __restrict__ r,
                        const T* __restrict__ x, T* __restrict__ y, I total,
                        I m, I nb, I bs, I k, A w) {
  for (I t = static_cast<I>(blockIdx.x) * THREADS + threadIdx.x; t < total;
       t += static_cast<I>(gridDim.x) * THREADS) {
    const I row = t / k;                     // d * m + i
    const I j = t - row * k;
    const I d = row / m;
    const I i = row - d * m;
    const I b = i / bs;
    const I ib = i - b * bs;
    const I c0 = b * bs;
    const I nc = m - c0 < bs ? m - c0 : bs;
    const T* bp = binv + ((d * nb + b) * bs + ib) * bs;
    const T* rp = r + (d * m + c0) * k + j;
    A acc = A(0);
    for (I c = 0; c < nc; ++c) acc += widen(__ldg(bp + c)) * widen(__ldg(rp + c * k));
    store(y + t, widen(__ldg(x + t)) + w * acc);
  }
}

template <typename T>
int launch(const T* binv, const T* r, const T* x, T* y, int64_t D, int64_t m,
           int64_t nb, int64_t bs, int64_t k, double w, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const int64_t total = D * m * k;
  int64_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  // every index, the block's largest offset included, fits 32 bits
  if (total < (int64_t{1} << 31) && D * nb * bs * bs < (int64_t{1} << 31))
    block_diag_apply_kernel<T, uint32_t><<<blocks, THREADS, 0, stream>>>(
        binv, r, x, y, static_cast<uint32_t>(total), static_cast<uint32_t>(m),
        static_cast<uint32_t>(nb), static_cast<uint32_t>(bs),
        static_cast<uint32_t>(k), static_cast<A>(w));
  else
    block_diag_apply_kernel<T, int64_t><<<blocks, THREADS, 0, stream>>>(
        binv, r, x, y, total, m, nb, bs, k, static_cast<A>(w));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an unknown dtype code (0 float32, 1 float64, 2
// bfloat16).  The caller guarantees D, m, bs, k > 0, nb = ceil(m / bs),
// contiguous operands on one device, and that y does not alias r or x.
extern "C" int block_diag_apply_launch(const void* binv, const void* r,
                                       const void* x, void* y, int64_t D,
                                       int64_t m, int64_t nb, int64_t bs,
                                       int64_t k, double w, int dtype,
                                       void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(static_cast<const float*>(binv),
                           static_cast<const float*>(r),
                           static_cast<const float*>(x), static_cast<float*>(y),
                           D, m, nb, bs, k, w, s);
    case 1:
      return launch<double>(static_cast<const double*>(binv),
                            static_cast<const double*>(r),
                            static_cast<const double*>(x),
                            static_cast<double*>(y), D, m, nb, bs, k, w, s);
    case 2:
      return launch<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(binv),
                                   static_cast<const __nv_bfloat16*>(r),
                                   static_cast<const __nv_bfloat16*>(x),
                                   static_cast<__nv_bfloat16*>(y), D, m, nb, bs,
                                   k, w, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
