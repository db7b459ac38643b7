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
//
// bfloat16 at bs = 4 (the main path's block size): a thread an output made
// nine 2-byte loads, four runtime divisions and one 2-byte store for 16
// bytes of work, so the kernel ran at a quarter of its bound.  There, where
// every rank's rows fill whole blocks (m % 4 == 0) and the operands are
// aligned, one thread takes a block and a group of W columns (W = 1 at
// k = 1, else 8, 4 or 2, the widest dividing k): the 4 x 4 block of Binv
// as two 16-byte loads, the block's 4 rows of r and of x as one 8-byte load
// each at k = 1 (one W * 2-byte load a row otherwise), y stored the same
// way.  Block b of rank d starts at row 4 (d nb + b), so the flat block
// index is the row index over 4 and no division by nb is left (one by the
// column groups where k > W).  Each output sums c = 0..3 in turn (a
// float32 fused multiply-add each, products of two bfloat16 exact) and
// stores fma(w, sum, x) rounded once: the order of the thread-an-output
// kernel, bit for bit (kernels/smoother/bf16_order.py emulates it): 0.0030
// against 0.0044 ms at level 0 of laplace_3d(64) on 2 x 4, k = 1, and
// 0.0065 against 0.0163 at k = 8 (PERF.md).  Other shapes keep the
// thread-an-output kernel, by a rule decided before the launch.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "value_types.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = int64_t{1} << 20;
constexpr int BS4 = 4;        // the block size of the bfloat16 vector path

using bf16 = __nv_bfloat16;

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

// W bfloat16 values at p (W * 2 bytes, as aligned) widened into o
template <int W>
__device__ __forceinline__ void load_bf16(const bf16* p, float* o) {
  if constexpr (W == 1) {
    o[0] = __bfloat162float(__ldg(p));
  } else if constexpr (W == 2) {
    const float2 a = __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
    o[0] = a.x;
    o[1] = a.y;
  } else {
    constexpr int N = W / 2;     // bf16 pairs: 2 (8 bytes) or 4 (16 bytes)
    unsigned u[N];
    if constexpr (W == 4) {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
      u[0] = t.x;
      u[1] = t.y;
    } else {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
      u[0] = t.x;
      u[1] = t.y;
      u[2] = t.z;
      u[3] = t.w;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
      o[2 * i] = a.x;
      o[2 * i + 1] = a.y;
    }
  }
}

__device__ __forceinline__ unsigned bf16x2_bits(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// the W values v rounded to bfloat16 at p, one store
template <int W>
__device__ __forceinline__ void store_bf16(bf16* p, const float* v) {
  if constexpr (W == 1) {
    *p = __float2bfloat16_rn(v[0]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<unsigned*>(p) = bf16x2_bits(v[0], v[1]);
  } else if constexpr (W == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(bf16x2_bits(v[0], v[1]), bf16x2_bits(v[2], v[3]));
  } else {
    *reinterpret_cast<uint4*>(p) = make_uint4(bf16x2_bits(v[0], v[1]), bf16x2_bits(v[2], v[3]),
                                              bf16x2_bits(v[4], v[5]), bf16x2_bits(v[6], v[7]));
  }
}

// bfloat16, bs = 4, m % 4 == 0: thread t takes flat block t / groups (rows
// 4 (t / groups) ...) and columns (t % groups) * W ... of it.  At k = 1 (W =
// 1) the block's 4 values of r, x and y are one 8-byte piece each.
template <int W>
__global__ void __launch_bounds__(THREADS)
block_diag_bf16_bs4_kernel(const bf16* __restrict__ binv, const bf16* __restrict__ r,
                           const bf16* __restrict__ x, bf16* __restrict__ y,
                           uint32_t total, uint32_t groups, uint32_t k, float w) {
  for (uint32_t t = blockIdx.x * THREADS + threadIdx.x; t < total;
       t += gridDim.x * THREADS) {
    const uint32_t b = groups == 1 ? t : t / groups;   // the flat block
    const uint32_t col = (t - b * groups) * W;
    float B[BS4 * BS4];
    load_bf16<8>(binv + b * (BS4 * BS4), B);
    load_bf16<8>(binv + b * (BS4 * BS4) + 8, B + 8);
    float R[BS4][W], X[BS4][W], Y[BS4][W];
    const uint32_t row0 = b * BS4;
    if constexpr (W == 1) {
      float v[BS4];
      load_bf16<4>(r + row0, v);
#pragma unroll
      for (int c = 0; c < BS4; ++c) R[c][0] = v[c];
      load_bf16<4>(x + row0, v);
#pragma unroll
      for (int c = 0; c < BS4; ++c) X[c][0] = v[c];
    } else {
#pragma unroll
      for (int c = 0; c < BS4; ++c) {
        load_bf16<W>(r + (row0 + c) * k + col, R[c]);
        load_bf16<W>(x + (row0 + c) * k + col, X[c]);
      }
    }
#pragma unroll
    for (int i = 0; i < BS4; ++i) {
#pragma unroll
      for (int j = 0; j < W; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < BS4; ++c) acc = fmaf(B[i * BS4 + c], R[c][j], acc);
        Y[i][j] = fmaf(w, acc, X[i][j]);
      }
    }
    if constexpr (W == 1) {
      const float v[BS4] = {Y[0][0], Y[1][0], Y[2][0], Y[3][0]};
      store_bf16<4>(y + row0, v);
    } else {
#pragma unroll
      for (int i = 0; i < BS4; ++i) store_bf16<W>(y + (row0 + i) * k + col, Y[i]);
    }
  }
}

template <int W>
int launch_bf16_bs4(const bf16* binv, const bf16* r, const bf16* x, bf16* y,
                    int64_t blocks, int64_t k, double w, cudaStream_t stream) {
  const int64_t groups = W == 1 ? 1 : k / W;
  const int64_t total = blocks * groups;
  int64_t grid = (total + THREADS - 1) / THREADS;
  if (grid > MAX_BLOCKS) grid = MAX_BLOCKS;
  block_diag_bf16_bs4_kernel<W><<<grid, THREADS, 0, stream>>>(
      binv, r, x, y, static_cast<uint32_t>(total), static_cast<uint32_t>(groups),
      static_cast<uint32_t>(k), static_cast<float>(w));
  return static_cast<int>(cudaGetLastError());
}

// W of the bfloat16 vector path for this launch, or 0 where it cannot take
// it: bs = 4, whole blocks (m % 4 == 0), 32-bit indices (r's and x's, and
// Binv's, its last block's largest offset included: D * nb * 16), Binv
// 16-byte aligned, and r, x, y aligned to their pieces (8 bytes at k = 1;
// W * 2 at k % W == 0, W the widest of 8, 4, 2)
int bs4_width(const void* binv, const void* r, const void* x, const void* y,
              int64_t D, int64_t m, int64_t bs, int64_t k) {
  if (bs != BS4 || m % BS4 != 0 || D * m * k >= (int64_t{1} << 31) ||
      D * (m / BS4) * BS4 * BS4 >= (int64_t{1} << 31))
    return 0;
  if (reinterpret_cast<uintptr_t>(binv) % 16 != 0) return 0;
  const uintptr_t at = reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(x) |
                       reinterpret_cast<uintptr_t>(y);
  if (k == 1) return at % 8 == 0 ? 1 : 0;
  for (int W = 8; W >= 2; W /= 2)
    if (k % W == 0 && at % (2 * W) == 0) return W;
  return 0;
}

template <typename T>
int launch(const T* binv, const T* r, const T* x, T* y, int64_t D, int64_t m,
           int64_t nb, int64_t bs, int64_t k, double w, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  if constexpr (std::is_same_v<T, bf16>) {
    switch (bs4_width(binv, r, x, y, D, m, bs, k)) {
      case 1: return launch_bf16_bs4<1>(binv, r, x, y, D * nb, k, w, stream);
      case 2: return launch_bf16_bs4<2>(binv, r, x, y, D * nb, k, w, stream);
      case 4: return launch_bf16_bs4<4>(binv, r, x, y, D * nb, k, w, stream);
      case 8: return launch_bf16_bs4<8>(binv, r, x, y, D * nb, k, w, stream);
      default: break;
    }
  }
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
