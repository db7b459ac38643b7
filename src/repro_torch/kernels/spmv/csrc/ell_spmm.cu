// ell_spmm: Y[d, i, :] = sum_s vals[d, i, s] * X[d, cols[d, i, s], :]  (cols == -1 is padding)
//
// Replaces the Pallas kernel in repro/kernels/spmv/spmv.py, function ell_spmm
// (_spmm_kernel), the native multi-RHS form, with the rank dim stacked in
// front: cols/vals [D, n, K], X [D, m, k] -> Y [D, n, k].
//
// Value types: float32, float64 and bfloat16.  A bfloat16 instance loads
// bfloat16 values and X rows (a row of k = 8 is one 16-byte load), widens
// them to float32, sums in float32 and rounds once, at the store.
// bfloat16 operands take the design of ell_bf16.cuh instead (a persistent
// grid, A streamed by 1-D bulk copies into shared memory, lanes of a row
// summing in registers), except those of rows shorter than FLAT_K with
// FLAT_SLOTS slots or more, which stay on this file's kernel.  On an H100
// (NVIDIA H100 80GB HBM3, 700 W; scripts/tune_kernel.py --dtype bfloat16,
// PERF.md), k = 8: the bulk design took level-0 A_on [8, 32768, 27] from
// 0.0435 to 0.0396 ms and the coarser levels' operands from 0.0106-0.0291
// to 0.0039-0.0105 ms, and lost at level 0's A_off, P_on and P_off ([8,
// 32768, 9 / 8 / 4], fill 0.04-0.25): 0.0144 / 0.0119 / 0.0095 against
// 0.0084 / 0.0093 / 0.0057 ms (units of little work, whose copies' latency
// the few summing threads cannot hide).
//
// Bound on an H100 SXM (80 GB HBM3 at 3.35 TB/s): A is needed once for all k
// columns (every slot's column id, padding included, and the value of every
// stored entry only), X once and Y once; with nnz = the count of cols >= 0:
//   t >= (D*n*K*4 + nnz*sizeof(T) + D*(m + n)*k*sizeof(T)) / 3.35e12 s.
// Two flops per slot and column stay far below the card's float32/float64
// rates, so the bytes bound it.
//
// What stands between the kernel and that bound on the path (K = 27, k = 8,
// float64) is the SM's load/store data path (128 bytes a clock for L1 and
// shared memory together), not device memory: every slot gathers a 64-byte
// X row, so each shared or L1 access a slot makes costs about as much as
// its share of the bytes.  The design spends about one such access a slot:
//   - A block takes R consecutive rows (R a multiple of 4, so it starts
//     16-byte aligned), which in the row-major layout are R*K contiguous
//     slots, and streams them into shared memory as one flat run: column
//     ids in 16-byte loads, issued before any other index arithmetic, then
//     the values of each 16-byte group that holds a stored entry (padding,
//     which the lowering packs at the row's end, costs no value bytes).
//   - Then one thread per (row, vector of W right-hand-side columns), the
//     vector fastest (W = 2 in float64, 4 in float32, 8 in bfloat16: 16
//     bytes, where k and the alignment of X and Y allow; else W = 1), walks
//     its row's slots in
//     order, summing in registers: a fixed order, so results repeat bit for
//     bit.  The lanes of a warp take consecutive rows at the same slot,
//     which on a stencil gather neighbouring X rows: 16-byte pieces of a
//     few cache lines.  A slot's column id and value are broadcast reads.
//   - Columns are tiled by 32 (grid.y); the path's k = 8 is one tile.
//   - Rows longer than one round of the shared run (ROUND slots) take the
//     run in rounds; a thread's sum stays in its registers from round to
//     round, so rows of any length take the same code.
// One kernel serves every K, k and fill: there is no width switch.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "ell_bf16.cuh"
#include "value_types.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int KT = 32;                             // RHS columns a block takes at most
constexpr int ROUND = 2048;                        // slots of A in shared memory at once
constexpr int64_t MAX_K = 0x7fffffff;              // K is an int in the kernel
constexpr int64_t FLAT_K = 16;                     // bfloat16: rows shorter than this
constexpr int64_t FLAT_SLOTS = int64_t{1} << 20;   // and this many slots stay here

template <typename T, int W>
struct alignas(sizeof(T) * W) Vec {
  T v[W];
};

// W entries of X from p, widened to the sum type A (one 16-byte load
// where W > 1)
template <typename T, int W, typename A = typename Acc<T>::type>
__device__ __forceinline__ void load_vec(const T* p, A* v) {
  if constexpr (W == 1) {
    v[0] = widen(__ldg(p));
  } else if constexpr (sizeof(T) == 8) {
    const double2 t = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  } else if constexpr (sizeof(T) == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {                                   // bfloat16, W == 8
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

// W sums to p, in T (bfloat16: each rounded once from float32)
template <typename T, int W, typename A = typename Acc<T>::type>
__device__ __forceinline__ void store_vec(T* p, const A* v) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if constexpr (W == 1) {
      *p = __float2bfloat16_rn(v[0]);
    } else {                                 // W == 8: one 16-byte store
      unsigned u[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        u[i] = *reinterpret_cast<const unsigned*>(&h);
      }
      *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
    }
  } else {
    Vec<T, W> r;
#pragma unroll
    for (int w = 0; w < W; ++w) r.v[w] = v[w];
    *reinterpret_cast<Vec<T, W>*>(p) = r;
  }
}

// The values of one chunk of 4 slots into shared memory, a 16-byte load for
// each group that holds a stored entry (c < 0 marks padding; c0 & c1 < 0
// iff both are); a group of padding is left unwritten and never read.
__device__ __forceinline__ void stage_vals4(const float* p, const int4 c, float* s) {
  if ((c.x & c.y & c.z & c.w) >= 0)
    *reinterpret_cast<float4*>(s) = __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void stage_vals4(const double* p, const int4 c, double* s) {
  if ((c.x & c.y) >= 0)
    *reinterpret_cast<double2*>(s) = __ldg(reinterpret_cast<const double2*>(p));
  if ((c.z & c.w) >= 0)
    *reinterpret_cast<double2*>(s + 2) = __ldg(reinterpret_cast<const double2*>(p + 2));
}

// bfloat16: the chunk's 4 values are one 8-byte group
__device__ __forceinline__ void stage_vals4(const __nv_bfloat16* p, const int4 c,
                                            __nv_bfloat16* s) {
  if ((c.x & c.y & c.z & c.w) >= 0)
    *reinterpret_cast<uint2*>(s) = __ldg(reinterpret_cast<const uint2*>(p));
}

// Shared memory: scol int[min(R*K, ROUND)], then sval T[min(R*K, ROUND)]
// (one round of the block's slots).  The span is a multiple of 4, so sval
// starts 16-byte aligned whatever T is.
template <typename T, int W>
__global__ void __launch_bounds__(THREADS)
ell_spmm_kernel(const int* __restrict__ cols, const T* __restrict__ vals,
                const T* __restrict__ X, T* __restrict__ Y, int64_t rows,
                int64_t n, int K, int R, int Vf, int64_t m, int64_t k, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  // slot counts of a block are int64 (R * K passes 2^31 for K above
  // 2^31 / R); offsets within one round are ints
  using A = typename Acc<T>::type;
  const int span = static_cast<int64_t>(R) * K < ROUND ? R * K : ROUND;
  int* scol = reinterpret_cast<int*>(smem);
  T* sval = reinterpret_cast<T*>(scol + span);

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * R;
  const int nr = static_cast<int>(rows - row0 < R ? rows - row0 : R);
  const int64_t ns = static_cast<int64_t>(nr) * K;   // this block's slots
  const int64_t s0 = row0 * K;                        // its first slot

  // the len slots of a round from the block's slot jr on into shared
  // memory, 4 a thread
  auto stage = [&](int64_t jr, int len) {
    const int* cb = cols + s0 + jr;
    const T* vb = vals + s0 + jr;
    for (int j = 4 * static_cast<int>(threadIdx.x); j < len; j += 4 * THREADS) {
      if (vec && j + 4 <= len) {
        const int4 c = __ldg(reinterpret_cast<const int4*>(cb + j));
        *reinterpret_cast<int4*>(scol + j) = c;
        stage_vals4(vb + j, c, sval + j);
      } else {
        for (int q = 0; q < 4 && j + q < len; ++q) {
          const int c = __ldg(cb + j + q);
          scol[j + q] = c;
          if (c >= 0) sval[j + q] = __ldg(vb + j + q);
        }
      }
    }
  };
  stage(0, ns < span ? static_cast<int>(ns) : span);   // the first column ids go out first

  // this thread's row and vector of columns
  const int r = static_cast<int>(threadIdx.x) / Vf;
  const int jv = static_cast<int>(threadIdx.x) - r * Vf;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * KT + jv * W;
  const bool active = r < nr && col0 < k;
  const int64_t row = row0 + r;
  // row ids fit 32 bits wherever a card's memory could hold the operand;
  // a 32-bit division is a few instructions, a 64-bit one a long call
  const int64_t d = rows <= 0x7fffffff
      ? static_cast<int64_t>(static_cast<unsigned>(row) / static_cast<unsigned>(n))
      : row / n;
  const T* xd = X + d * m * k + col0;

  A acc[W];
#pragma unroll
  for (int w = 0; w < W; ++w) acc[w] = A(0);
  for (int64_t jr = 0; jr < ns; jr += span) {
    const int len = ns - jr < span ? static_cast<int>(ns - jr) : span;
    if (jr > 0) {
      __syncthreads();                    // the last round is read
      stage(jr, len);
    }
    __syncthreads();
    if (active) {
      // this row's slots in the round, [a, e) of it, in order
      const int64_t ra = static_cast<int64_t>(r) * K - jr;
      const int a = ra <= 0 ? 0 : ra < len ? static_cast<int>(ra) : len;
      const int e = ra + K <= 0 ? 0 : ra + K < len ? static_cast<int>(ra + K) : len;
#pragma unroll 4
      for (int j = a; j < e; ++j) {
        const int c = scol[j];
        if (c >= 0) {
          const A v = widen(sval[j]);
          A x[W];
          load_vec<T, W>(xd + static_cast<int64_t>(c) * k, x);
#pragma unroll
          for (int w = 0; w < W; ++w) acc[w] += v * x[w];
        }
      }
    }
  }
  if (active) store_vec<T, W>(Y + row * k + col0, acc);
}

template <typename T, int W>
int launch_w(const int* cols, const T* vals, const T* X, T* Y, int64_t D,
             int64_t n, int64_t K, int64_t m, int64_t k, cudaStream_t stream) {
  const int Vf = static_cast<int>((k < KT ? k : KT) / W);   // vectors of a tile
  const int R = THREADS / Vf / 4 * 4;                       // >= 4: Vf <= 32
  const int64_t span = R * K < ROUND ? R * K : ROUND;
  const int64_t smem = span * static_cast<int64_t>(sizeof(T) + sizeof(int));
  const int64_t rows = D * n;
  const dim3 grid(static_cast<unsigned>((rows + R - 1) / R),
                  static_cast<unsigned>((k + KT - 1) / KT));
  const bool vec =
      (reinterpret_cast<uintptr_t>(cols) | reinterpret_cast<uintptr_t>(vals)) % 16 == 0;
  ell_spmm_kernel<T, W><<<grid, THREADS, smem, stream>>>(
      cols, vals, X, Y, rows, n, static_cast<int>(K), R, Vf, m, k, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const int* cols, const T* vals, const T* X, T* Y, int64_t D,
           int64_t n, int64_t K, int64_t m, int64_t k, cudaStream_t stream) {
  if (K > MAX_K || (k + KT - 1) / KT > 65535 || (D * n + 3) / 4 > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int WV = 16 / sizeof(T);
  const bool wide =
      k % WV == 0 && (reinterpret_cast<uintptr_t>(X) | reinterpret_cast<uintptr_t>(Y)) % 16 == 0;
  if (wide) return launch_w<T, WV>(cols, vals, X, Y, D, n, K, m, k, stream);
  return launch_w<T, 1>(cols, vals, X, Y, D, n, K, m, k, stream);
}

// bfloat16: ell_bf16.cuh's kernel, but this file's for rows shorter than
// FLAT_K in operands of FLAT_SLOTS slots and more
int launch_bf16(const int* cols, const __nv_bfloat16* vals, const __nv_bfloat16* X,
                __nv_bfloat16* Y, int64_t D, int64_t n, int64_t K, int64_t m, int64_t k,
                cudaStream_t stream) {
  if (K < FLAT_K && D * n * K >= FLAT_SLOTS)
    return launch<__nv_bfloat16>(cols, vals, X, Y, D, n, K, m, k, stream);
  if (K > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
  return ell_bf16::launch(cols, vals, X, Y, D, n, K, m, k, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for K above 2^31 - 1, a grid the card cannot take
// or an unknown dtype code.  dtype: 0 float32, 1 float64, 2 bfloat16.
// The caller guarantees D, n, K, m, k > 0,
// contiguous operands on one device, and 0 <= cols < m wherever cols != -1.
extern "C" int ell_spmm_launch(const void* cols, const void* vals, const void* X,
                               void* Y, int64_t D, int64_t n, int64_t K,
                               int64_t m, int64_t k, int dtype, void* stream) {
  const auto* c = static_cast<const int*>(cols);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(c, static_cast<const float*>(vals),
                           static_cast<const float*>(X), static_cast<float*>(Y),
                           D, n, K, m, k, s);
    case 1:
      return launch<double>(c, static_cast<const double*>(vals),
                            static_cast<const double*>(X), static_cast<double*>(Y),
                            D, n, K, m, k, s);
    case 2:
      return launch_bf16(c, static_cast<const __nv_bfloat16*>(vals),
                         static_cast<const __nv_bfloat16*>(X),
                         static_cast<__nv_bfloat16*>(Y), D, n, K, m, k, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
