// bcsr_spmm: block row r of rank d = sum_s bvals[d, r, s] @ Xb[d, bcols[d, r, s]]
//            (bcols == -1 is padding)
//
// Replaces the Pallas kernel in repro/kernels/spmv/bcsr.py, function bcsr_spmm
// (_bcsr_kernel), and with k = 1 its wrapper bcsr_spmv, with the rank dim
// stacked in front: bcols [D, mb, Kb] int32, bvals [D, mb, Kb, bs, bs],
// Xb [D, nb, bs, k] -> Y [D, mb*bs, k], for bs in {8, 16}.
//
// Bound on an H100 SXM (80 GB HBM3 at 3.35 TB/s): every block id is read
// (padding included), the stored blocks once (a padded slot's block is never
// loaded), and X ([D, m, k], before padding to whole blocks) and Y once each;
// with nblk = the count of bcols >= 0:
//   t >= (D*mb*Kb*4 + nblk*bs*bs*sizeof(T) + D*(m + mb*bs)*k*sizeof(T)) / 3.35e12 s.
// 2 flops per stored value and column (about 0.25 flop/B at k = 1 in
// float64) sit far below the card's float32/float64 rates, so the bytes bound
// it, explicit zero fill inside the blocks included.
//
// Design against that bound: one thread per output element (bs*k threads per
// block row, RHS column fastest, several block rows per CUDA block).  A thread
// streams its own row of each bs x bs block as bs contiguous values (so a
// warp reads whole blocks), the bs-long inner product is unrolled at compile
// time, and the Xb slab is shared through the read-only cache by the bs rows
// that use it.  No shared memory and no atomics: each thread owns its output.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename T, int BS>
__global__ void bcsr_spmm_kernel(const int* __restrict__ bcols,
                                 const T* __restrict__ bvals,
                                 const T* __restrict__ Xb, T* __restrict__ Y,
                                 int64_t total, int64_t mb, int64_t Kb,
                                 int64_t nb, int64_t k) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (t >= total) return;
  const int64_t per_brow = BS * k;
  const int64_t brow = t / per_brow;          // d * mb + r
  const int64_t rem = t % per_brow;
  const int64_t i = rem / k;
  const int64_t j = rem % k;
  const int64_t d = brow / mb;
  const int* bc = bcols + brow * Kb;
  const T* a = bvals + brow * Kb * BS * BS + i * BS;
  const T* xd = Xb + d * nb * BS * k + j;
  T acc = T(0);
  for (int64_t s = 0; s < Kb; ++s) {
    const int c = __ldg(bc + s);
    if (c < 0) continue;
    const T* as = a + s * BS * BS;
    const T* xs = xd + static_cast<int64_t>(c) * BS * k;
#pragma unroll
    for (int q = 0; q < BS; ++q) acc += __ldg(as + q) * __ldg(xs + q * k);
  }
  Y[t] = acc;   // Y[d, r*BS + i, j]
}

template <typename T>
int launch(const int* bcols, const T* bvals, const T* Xb, T* Y, int64_t D,
           int64_t mb, int64_t Kb, int64_t nb, int64_t bs, int64_t k,
           cudaStream_t stream) {
  const int64_t total = D * mb * bs * k;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  if (bs == 8)
    bcsr_spmm_kernel<T, 8><<<blocks, threads, 0, stream>>>(bcols, bvals, Xb, Y, total, mb, Kb, nb, k);
  else if (bs == 16)
    bcsr_spmm_kernel<T, 16><<<blocks, threads, 0, stream>>>(bcols, bvals, Xb, Y, total, mb, Kb, nb, k);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a block size other than 8 or 16.  The caller
// guarantees D, mb, Kb, nb, k > 0, contiguous operands on one device, and
// 0 <= bcols < nb wherever bcols != -1.
extern "C" int bcsr_spmm_launch(const void* bcols, const void* bvals,
                                const void* Xb, void* Y, int64_t D, int64_t mb,
                                int64_t Kb, int64_t nb, int64_t bs, int64_t k,
                                int is_f64, void* stream) {
  const auto* c = static_cast<const int*>(bcols);
  auto s = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return launch<double>(c, static_cast<const double*>(bvals),
                          static_cast<const double*>(Xb), static_cast<double*>(Y),
                          D, mb, Kb, nb, bs, k, s);
  return launch<float>(c, static_cast<const float*>(bvals),
                       static_cast<const float*>(Xb), static_cast<float*>(Y),
                       D, mb, Kb, nb, bs, k, s);
}
