// ell_spmv: y[d, i] = sum_k vals[d, i, k] * x[d, cols[d, i, k]]  (cols == -1 is padding)
//
// Replaces the Pallas kernel in repro/kernels/spmv/spmv.py, function ell_spmv
// (_spmv_kernel), with the rank dim of the distributed solve stacked in front
// so that one launch serves all D ranks: cols/vals [D, n, K], x [D, m] -> y [D, n].
//
// Value types: float32, float64 and bfloat16.  A bfloat16 instance loads
// bfloat16 values and x, widens them to float32, takes products and row
// sums in float32 and rounds once, at the store (__float2bfloat16_rn).
// bfloat16 operands of at least BULK_SLOTS slots (the AMG path's level-0
// A_on) take the design of ell_bf16.cuh instead (a persistent grid, A
// streamed by 1-D bulk copies into shared memory, one thread a row summing
// in registers); the rest take this file's kernel.  On an H100 (NVIDIA H100
// 80GB HBM3, 700 W; scripts/tune_kernel.py --dtype bfloat16, PERF.md) the
// bulk design took level-0 A_on [8, 32768, 27] from 0.0309 to 0.0242 ms,
// and lost on every other operand of the bfloat16 solve: 0.0118 against
// 0.0087 ms at A_off [8, 32768, 9] (fill 0.21), 0.0070 against 0.0055 at
// the [8, 2689, 18..36] operands of level 1 (work a unit too small for the
// copy's latency to hide), within 0.0005 ms on the small levels.
//
// Bound on an H100 SXM (80 GB HBM3 at 3.35 TB/s): the kernel has to read
// every slot's column id (4 B, padding included), the value of every stored
// entry (sizeof(T); padded slots' values are never loaded), x once and write
// y once; with nnz = the count of cols >= 0:
//   t >= (D*n*K*4 + nnz*sizeof(T) + D*(m + n)*sizeof(T)) / 3.35e12 s,
// in bfloat16 (D*n*K*4 + nnz*2 + D*(m + n)*2) / 3.35e12 s, where the int32
// column ids are most of the bytes.
// Two flops per slot is far below the card's float32/float64 rates, so the
// bytes bound it.
//
// Design against that bound: rows are short (K = 1..66 on the AMG path, fill
// 0.04..0.97), so a row is no unit of work for a group of lanes -- lanes
// would idle on short rows and on padding.  Instead a block takes a run of R
// consecutive rows (R a multiple of 4, R*K up to one round of 4*THREADS*UNROLL
// slots), which in the row-major layout are R*K contiguous slots, and
// streams them as one flat array: consecutive lanes take consecutive chunks
// of 4 slots, every lane is busy and every sector is read once.
//   - Each thread carries UNROLL chunks: their column ids come in 16-byte
//     loads, then every value and x load of those 4*UNROLL slots is issued
//     before the first product, so many independent loads are in flight.
//     Small blocks (128 threads; 1 chunk a thread in float64, 4 in float32)
//     keep the registers low and many blocks on each SM, so one block's sums
//     overlap the others' loads.
//   - A group of values is loaded only where one of its column ids is >= 0:
//     the card moves 32-byte sectors, so padding that fills a group (the
//     lowering packs it at the row's end) costs no value bytes.  A group is
//     16 bytes in float32 and float64 (4 values, or 2), and in bfloat16 the
//     8 bytes of a chunk's 4 values: the 16-byte load of 4 ids decides it.
//   - x is gathered through the read-only path (__ldg); at the solve's sizes
//     it stays in the 50 MB L2.
//   - Products land in shared memory (rows at an odd stride), and one thread
//     per row then sums its products in slot order (no shuffles, no atomics;
//     the order is fixed, so results repeat bit for bit).
//   - Rows longer than a quarter of a round (K > 128 in float64, 512 in
//     float32; never on the AMG path) take R = 4 and several rounds: each
//     round sums its part of a row, and the row that runs on into the next
//     round leaves its partial sum in shared memory for it.  Shared memory
//     is one round's products whatever K is.  The launch picks the
//     kernel's instance with rounds only for such K.
//   - On the small levels a launch is one wave of blocks and its time is
//     latency: the first column ids go out before anything else, and the
//     rank lookup (32-bit divisions) runs while they are in flight.
// One kernel serves every K and fill: there is no width switch.
#include <cuda_runtime.h>

#include <cstdint>

#include "ell_bf16.cuh"
#include "value_types.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MAX_ROWS = 1024;                     // rows a block takes at most
constexpr int64_t MAX_K = int64_t{1} << 28;        // a block's slots fit an int
constexpr int64_t BULK_SLOTS = int64_t{1} << 22;   // bfloat16: ell_bf16.cuh from here on

// chunks of 4 slots a thread carries a round (the fastest at the AMG path's
// level-0 A_on on an H100; PERF.md): 1 in float64, 4 in float32 and in
// bfloat16 (whose sums are float32 too)
template <typename T>
__host__ __device__ constexpr int unroll() { return sizeof(T) == 8 ? 1 : 4; }

template <typename T>
__host__ __device__ constexpr int span() { return 4 * THREADS * unroll<T>(); }

// Rows per block for row length K: as many as fit one round's slots, a
// multiple of 4 (so that every block starts 16-byte aligned), at least 4.
template <typename T>
int rows_per_block(int64_t K) {
  const int64_t r = (span<T>() / K) / 4 * 4;
  return static_cast<int>(r < 4 ? 4 : r > MAX_ROWS ? MAX_ROWS : r);
}

// The values of one chunk of 4 slots, a 16-byte load for each group that
// holds a stored entry (c < 0 marks padding; c0 & c1 < 0 iff both are).
__device__ __forceinline__ void load_vals4(const float* p, const int* c, float* v) {
  float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
  if ((c[0] & c[1] & c[2] & c[3]) >= 0) t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load_vals4(const double* p, const int* c, double* v) {
  double2 a = make_double2(0.0, 0.0), b = make_double2(0.0, 0.0);
  if ((c[0] & c[1]) >= 0) a = __ldg(reinterpret_cast<const double2*>(p));
  if ((c[2] & c[3]) >= 0) b = __ldg(reinterpret_cast<const double2*>(p + 2));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// bfloat16: the chunk's 4 values are one 8-byte group, widened to float32
__device__ __forceinline__ void load_vals4(const __nv_bfloat16* p, const int* c, float* v) {
  uint2 t = make_uint2(0u, 0u);
  if ((c[0] & c[1] & c[2] & c[3]) >= 0) t = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// Shared memory: xoff int64[R] (d * m of each row, when a block spans
// ranks), prod A[min(R*K, SPAN) + R] (a round's products in the sum type A;
// row r - rf of the round at offset (r - rf) * pad, pad = 1 for even K: an
// odd row stride), carry A[2] (a row's partial sum across rounds, by the
// round's parity).
// (prod right after xoff, 16-byte aligned, was 5% faster in float32 on an
// H100 than behind the carry; PERF.md.)
// ROUNDS is false where a block's slots fit one round (every K up to a
// quarter of a round, all of the AMG path): that instance is compiled
// without the rounds' bookkeeping, which costs the short rows registers
// and so blocks on each SM.
template <typename T, bool ROUNDS>
__global__ void __launch_bounds__(THREADS)
ell_spmv_kernel(const int* __restrict__ cols, const T* __restrict__ vals,
                const T* __restrict__ x, T* __restrict__ y, int64_t rows,
                int64_t n, int K, int pad, int R, int64_t m, bool vec) {
  using A = typename Acc<T>::type;
  constexpr int UNROLL = unroll<T>();
  constexpr int SPAN = span<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* xoff = reinterpret_cast<int64_t*>(smem);
  A* prod = reinterpret_cast<A*>(smem + R * sizeof(int64_t));
  A* carry = prod + (R * K < SPAN ? R * K : SPAN) + R;

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * R;
  const int nr = static_cast<int>(rows - row0 < R ? rows - row0 : R);
  const int ns = nr * K;                  // this block's slots
  const int64_t s0 = row0 * K;            // its first slot
  // column ids of a round's chunks (jr: the round's first slot)
  int c[UNROLL][4];
  auto load_cols = [&](int jr) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = jr + (static_cast<int>(threadIdx.x) + u * THREADS) * 4;
      if (vec && j + 4 <= ns) {
        const int4 t = __ldg(reinterpret_cast<const int4*>(cols + s0 + j));
        c[u][0] = t.x; c[u][1] = t.y; c[u][2] = t.z; c[u][3] = t.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) c[u][q] = j + q < ns ? __ldg(cols + s0 + j + q) : -1;
      }
    }
  };
  // the first round's column ids go out before the rank lookup below
  load_cols(0);
  // row ids fit 32 bits wherever a card's memory could hold the operand;
  // a 32-bit division is a few instructions, a 64-bit one a long call
  const bool narrow = rows <= 0x7fffffff;
  auto rank_of = [&](int64_t row) -> int64_t {
    return narrow ? static_cast<int64_t>(static_cast<unsigned>(row) / static_cast<unsigned>(n))
                  : row / n;
  };
  const int64_t d0 = rank_of(row0);
  const bool one_rank = rank_of(row0 + nr - 1) == d0;
  if (!one_rank) {
    for (int r = threadIdx.x; r < nr; r += THREADS) xoff[r] = rank_of(row0 + r) * m;
    __syncthreads();
  }
  const T* xd = x + d0 * m;
  // j / K through a float reciprocal: exact while j < 2^22, as (j + 0.5) / K
  // keeps 0.5 / K away from every integer; longer blocks divide
  const bool by_recip = !ROUNDS || ns <= (1 << 22);
  const float inv_k = 1.0f / static_cast<float>(K);

  // one round's products into prod (jr: its first slot, rf: its first row)
  auto products = [&](int jr, int rf) {
    if (jr + static_cast<int>(threadIdx.x) * 4 >= ns) return;   // no slot here
    A v[UNROLL][4];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = jr + (static_cast<int>(threadIdx.x) + u * THREADS) * 4;
      if (vec && j + 4 <= ns) {
        load_vals4(vals + s0 + j, c[u], v[u]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v[u][q] = c[u][q] >= 0 ? widen(__ldg(vals + s0 + j + q)) : A(0);
      }
    }
    A xv[UNROLL][4];
    int at[UNROLL][4];                    // where each product goes in prod
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = jr + (static_cast<int>(threadIdx.x) + u * THREADS) * 4 + q;
        const int r = by_recip ? static_cast<int>((static_cast<float>(j) + 0.5f) * inv_k)
                               : j / K;
        at[u][q] = j < ns ? (j - jr) + (r - rf) * pad : -1;
        const int cj = c[u][q];
        xv[u][q] = A(0);
        if (cj >= 0) xv[u][q] = widen(__ldg((one_rank ? xd : x + xoff[r]) + cj));
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (at[u][q] >= 0) prod[at[u][q]] = c[u][q] >= 0 ? v[u][q] * xv[u][q] : A(0);
    }
  };

  if constexpr (!ROUNDS) {                // ns <= SPAN: one round
    products(0, 0);
    __syncthreads();
    for (int r = threadIdx.x; r < nr; r += THREADS) {
      const A* p = prod + r * (K + pad);
      A acc = A(0);
      for (int k = 0; k < K; ++k) acc += p[k];
      store(y + row0 + r, acc);
    }
  } else {
    for (int jr = 0, pass = 0; jr < ns; jr += SPAN, ++pass) {
      if (jr > 0) {
        __syncthreads();                  // the last round's sums are read
        load_cols(jr);
      }
      const int rf = jr / K;              // the round's first row
      products(jr, rf);
      __syncthreads();
      // each row of the round sums its part; a row begun in an earlier
      // round adds the carried sum, one that runs on leaves its sum for
      // the next
      const int je = ns - jr < SPAN ? ns : jr + SPAN;
      const int re = (je + K - 1) / K;
      for (int r = rf + static_cast<int>(threadIdx.x); r < re; r += THREADS) {
        const int a = r * K > jr ? r * K : jr;
        const int e = r * K + K < je ? r * K + K : je;
        const A* p = prod + (a - jr) + (r - rf) * pad;
        A acc = A(0);
        for (int k = 0; k < e - a; ++k) acc += p[k];
        if (r * K < jr) acc = carry[(pass + 1) & 1] + acc;
        if (r * K + K > je) carry[pass & 1] = acc;
        else store(y + row0 + r, acc);
      }
    }
  }
}

template <typename T>
int launch(const int* cols, const T* vals, const T* x, T* y, int64_t D,
           int64_t n, int64_t K, int64_t m, cudaStream_t stream) {
  if (K > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
  const int R = rows_per_block<T>(K);
  const int64_t slots = R * K < span<T>() ? R * K : span<T>();   // a round's
  const int64_t smem = R * static_cast<int64_t>(sizeof(int64_t)) +
                       (2 + slots + R) * sizeof(typename Acc<T>::type);
  const int64_t rows = D * n;
  const int64_t blocks = (rows + R - 1) / R;
  const bool vec =
      (reinterpret_cast<uintptr_t>(cols) | reinterpret_cast<uintptr_t>(vals)) % 16 == 0;
  const int k = static_cast<int>(K), pad = K % 2 == 0;
  if (R * K > span<T>())
    ell_spmv_kernel<T, true><<<blocks, THREADS, smem, stream>>>(
        cols, vals, x, y, rows, n, k, pad, R, m, vec);
  else
    ell_spmv_kernel<T, false><<<blocks, THREADS, smem, stream>>>(
        cols, vals, x, y, rows, n, k, pad, R, m, vec);
  return static_cast<int>(cudaGetLastError());
}

// bfloat16: ell_bf16.cuh's kernel (x as X of one column) for operands of
// BULK_SLOTS slots and more, this file's below
int launch_bf16(const int* cols, const __nv_bfloat16* vals, const __nv_bfloat16* x,
                __nv_bfloat16* y, int64_t D, int64_t n, int64_t K, int64_t m,
                cudaStream_t stream) {
  if (K > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
  if (D * n * K >= BULK_SLOTS)
    return ell_bf16::launch_w<1>(ell_bf16::args(cols, vals, x, y, D, n, K, m, 1), stream);
  return launch<__nv_bfloat16>(cols, vals, x, y, D, n, K, m, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for K above 2^28 (a row of 1 GiB of column ids) or
// an unknown dtype code.  dtype: 0 float32, 1 float64, 2 bfloat16.
// The caller guarantees D, n, K, m > 0, contiguous operands on one device,
// and 0 <= cols < m wherever cols != -1.
extern "C" int ell_spmv_launch(const void* cols, const void* vals, const void* x,
                               void* y, int64_t D, int64_t n, int64_t K,
                               int64_t m, int dtype, void* stream) {
  const auto* c = static_cast<const int*>(cols);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(c, static_cast<const float*>(vals),
                           static_cast<const float*>(x), static_cast<float*>(y),
                           D, n, K, m, s);
    case 1:
      return launch<double>(c, static_cast<const double*>(vals),
                            static_cast<const double*>(x), static_cast<double*>(y),
                            D, n, K, m, s);
    case 2:
      return launch_bf16(c, static_cast<const __nv_bfloat16*>(vals),
                         static_cast<const __nv_bfloat16*>(x),
                         static_cast<__nv_bfloat16*>(y), D, n, K, m, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
