// bcsr_spmm: block row r of rank d = sum_s bvals[d, r, s] @ X[d, bcols[d, r, s]*bs : +bs]
//            (bcols == -1 is padding; rows of X past m read as zero)
//
// Replaces the Pallas kernel in repro/kernels/spmv/bcsr.py, function bcsr_spmm
// (_bcsr_kernel), and with k = 1 its wrapper bcsr_spmv, with the rank dim
// stacked in front: bcols [D, mb, Kb] int32, bvals [D, mb, Kb, bs, bs],
// X [D, m, k] as it is (not padded to whole blocks) -> Y [D, rows, k], the
// first rows <= mb*bs rows of the product, for bs in {8, 16}.
//
// Value types: float32, float64 and bfloat16.  A bfloat16 instance loads
// bfloat16 blocks and X, widens them to float32, sums in float32 (the
// shuffles too) and rounds once, at the store; no tensor cores.
//
// Bound on an H100 SXM (80 GB HBM3 at 3.35 TB/s): every block id is read
// (padding included), the stored blocks once (a padded slot's block is never
// loaded), and X and Y once each; with nblk = the count of bcols >= 0:
//   t >= (D*mb*Kb*4 + nblk*bs*bs*sizeof(T) + D*(m + rows)*k*sizeof(T)) / 3.35e12 s.
// 2 flops per stored value and column (about 0.25 flop/B at k = 1 in
// float64) sit far below the card's float32/float64 rates, so the bytes bound
// it, explicit zero fill inside the blocks included.  On the AMG path the
// BCSR levels are tiny (8 x 8 block rows of Kb 8 at level 3, 8 x 2 of Kb 2 at
// level 4): the bound is a fraction of a microsecond and what a launch costs
// is memory latency, counted in dependent round trips.
//
// Design against that latency: a CUDA block serves one block row and up to
// JT right-hand-side columns.  Its threads are (output row i, column j, slot
// group g): G lanes side by side share an output and split its Kb slots
// (slot s goes to lane s mod G), so a thread handles ceil(Kb / G) slots, one
// on the path.  A thread loads its block ids, then issues all bs values of
// its block's row i and all bs entries of X's column j before the first FMA:
// two round trips to memory in all.  The G partial sums meet through warp
// shuffles in a fixed butterfly order.  X is read unpadded, rows bounds-
// checked against m, and only the first `rows` output rows are written, so a
// BCSR apply is this one launch, with no pad copy before and no slice copy
// after.
#include <cuda_runtime.h>

#include <cstdint>

#include "value_types.cuh"

namespace {

constexpr int MAX_THREADS = 512;

template <typename T, int BS>
__global__ void __launch_bounds__(MAX_THREADS)
bcsr_spmm_kernel(const int* __restrict__ bcols, const T* __restrict__ bvals,
                 const T* __restrict__ x, T* __restrict__ y, int64_t mb,
                 int Kb, int64_t m, int k, int rows, int JT, int G) {
  using A = typename Acc<T>::type;
  constexpr int NS = 16 / BS;     // slots a thread loads before its FMAs
  const int64_t brow = blockIdx.x;                  // d * mb + r
  const int64_t d = brow / mb;
  const int r = static_cast<int>(brow - d * mb);
  const int g = threadIdx.x % G;
  const int o = threadIdx.x / G;                    // output (i, jj) of the tile
  const int i = o / JT;
  const int j = blockIdx.y * JT + o % JT;
  const bool live = i < BS && j < k;                // threads past the tile idle
  const int* bc = bcols + brow * Kb;
  const T* a = bvals + (brow * Kb * BS + i) * BS;   // row i of slot 0's block
  const T* xd = x + d * m * k + j;
  A acc = A(0);
  if (live) {
    for (int s0 = g; s0 < Kb; s0 += NS * G) {
      int c[NS];
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        const int s = s0 + t * G;
        c[t] = s < Kb ? __ldg(bc + s) : -1;
      }
      A av[NS][BS], xv[NS][BS];
#pragma unroll
      for (int t = 0; t < NS; ++t) {
        const int64_t s = s0 + t * G;
#pragma unroll
        for (int q = 0; q < BS; ++q) {
          const int64_t xr = static_cast<int64_t>(c[t]) * BS + q;
          av[t][q] = c[t] >= 0 ? widen(__ldg(a + s * BS * BS + q)) : A(0);
          xv[t][q] = c[t] >= 0 && xr < m ? widen(__ldg(xd + xr * k)) : A(0);
        }
      }
#pragma unroll
      for (int t = 0; t < NS; ++t) {
#pragma unroll
        for (int q = 0; q < BS; ++q) acc += av[t][q] * xv[t][q];
      }
    }
  }
  // every thread of the block (a multiple of 32) reaches the shuffles
  for (int off = G / 2; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off, G);
  const int row = r * BS + i;
  if (live && g == 0 && row < rows) store(y + (d * rows + row) * k + j, acc);
}

int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

template <typename T, int BS>
int launch_bs(const int* bcols, const T* bvals, const T* x, T* y, int64_t D,
              int64_t mb, int64_t Kb, int64_t m, int64_t k, int64_t rows,
              cudaStream_t stream) {
  const int JT = static_cast<int>(k < 128 / BS ? k : 128 / BS);   // columns per block
  const int outs = BS * JT;                                       // <= 128
  int G = pow2_at_least(static_cast<int>(Kb < 32 ? Kb : 32));
  while (G > 1 && outs * G > MAX_THREADS) G /= 2;
  const int threads = (outs * G + 31) / 32 * 32;
  const dim3 grid(static_cast<unsigned>(D * mb), static_cast<unsigned>((k + JT - 1) / JT));
  bcsr_spmm_kernel<T, BS><<<grid, threads, 0, stream>>>(
      bcols, bvals, x, y, mb, static_cast<int>(Kb), m, static_cast<int>(k),
      static_cast<int>(rows), JT, G);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const int* bcols, const T* bvals, const T* x, T* y, int64_t D,
           int64_t mb, int64_t Kb, int64_t m, int64_t bs, int64_t k,
           int64_t rows, cudaStream_t stream) {
  if (bs == 8) return launch_bs<T, 8>(bcols, bvals, x, y, D, mb, Kb, m, k, rows, stream);
  if (bs == 16) return launch_bs<T, 16>(bcols, bvals, x, y, D, mb, Kb, m, k, rows, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a block size other than 8 or 16 or an unknown
// dtype code.  dtype: 0 float32, 1 float64, 2 bfloat16.  The caller
// guarantees D, mb, Kb, m, k, rows > 0, rows <= mb*bs, contiguous operands
// on one device, and 0 <= bcols*bs < m wherever bcols != -1.
extern "C" int bcsr_spmm_launch(const void* bcols, const void* bvals,
                                const void* x, void* y, int64_t D, int64_t mb,
                                int64_t Kb, int64_t m, int64_t bs, int64_t k,
                                int64_t rows, int dtype, void* stream) {
  const auto* c = static_cast<const int*>(bcols);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(c, static_cast<const float*>(bvals),
                           static_cast<const float*>(x), static_cast<float*>(y),
                           D, mb, Kb, m, bs, k, rows, s);
    case 1:
      return launch<double>(c, static_cast<const double*>(bvals),
                            static_cast<const double*>(x), static_cast<double*>(y),
                            D, mb, Kb, m, bs, k, rows, s);
    case 2:
      return launch<__nv_bfloat16>(c, static_cast<const __nv_bfloat16*>(bvals),
                                   static_cast<const __nv_bfloat16*>(x),
                                   static_cast<__nv_bfloat16*>(y), D, mb, Kb, m,
                                   bs, k, rows, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
