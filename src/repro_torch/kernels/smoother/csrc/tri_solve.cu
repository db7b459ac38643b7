// tri_solve: y = x + w * T^-1 r on rank-stacked operands, T the lower
// (forward) or upper (backward) triangle of each rank's local square block
//
// The hybrid Gauss-Seidel sweeps of the distributed solve: hybrid_gs is
// x <- x + (D+L)^-1 (b - A x), hybrid_gs_sym that sweep and then
// x <- x + (D+U)^-1 (b - A x), each on a freshly exchanged residual.  It
// replaces no Pallas kernel: the reference applies a dense per-rank inverse,
// `minv @ r` with minv [D, m, m] (repro/amg/dist_solve.py, DistHierarchy._relax
// and DistLevel.smoother_minv("gs" / "gsu")), 69 GB in float64 at
// laplace_3d(64) on 2 x 4 ranks.  Here T stays sparse: the strict triangle in
// ELL, cols/vals [D, m, K] (cols == -1 is padding, column ids local to the
// rank), and its diagonal apart, diag [D, m] (a zero or padded diagonal is 1).
// r, x, y and the scratch z = T^-1 r are [D, m, k] (k = 1 for vectors).
//
// Bound on an H100 SXM (80 GB HBM3 at 3.35 TB/s): the stored entries' column
// ids and values, diag, r and x are read once, y written once (the scratch z
// and the ELL padding are this design's, not the function's):
//   t >= (nnz*(4 + sizeof(T)) + D*m*sizeof(T) + 3*D*m*k*sizeof(T)) / 3.35e12 s.
// What holds it in practice is neither: row i needs z of every row it
// couples to, so a solve is a chain of dependent steps as long as the
// triangle's DAG is deep (218 level sets at level 0 of laplace_3d(64) on
// 2 x 4), each step a few round trips through the L2.
//
// Design (sync-free, one launch): persistent warps take rows by an atomic
// ticket, ticket t being row order[t] -- every rank's rows sorted by their
// level set in the triangle's DAG (host-computed once per pattern) -- so a
// row's dependencies, all in lower level sets, hold smaller tickets, taken by
// warps that are running: no warp waits on one that cannot run, whatever the
// grid.  (Tickets in row order, ascending for the lower triangle and
// descending for the upper, would be as safe, but the rows in flight are then
// a window of consecutive rows, of which a 27-point stencil in natural order
// lets only a few lines run at once: 8.6 ms at level 0 of laplace_3d(64) on
// an H100, against the DAG's 218 level sets of about 1,200 rows each.)  The
// lanes wait on the row's dependencies' ready flags together (lane e on slots
// e, e + 32, ...) with acquire loads, then read their z through the L2
// (ld.cg: z is written during the launch, and the L1 is not coherent); the
// warp solves its row, writes z and y, and publishes its flag with a release
// store.  With one right-hand side the row's own r and x load while the warp
// waits, the lanes' products meet in a fixed butterfly, and lane 0's release
// orders its own stores (a fence before it cost 15% at level 0).  With k of
// them each lane takes a column and sums the row's slots in order, the
// slots' columns and values broadcast by shuffles so that several z loads
// are in flight at once, and each lane fences its stores before lane 0's
// release.  Either way the order is fixed and results repeat bit for bit.
// The flags and the ticket live in one scratch buffer that the launch clears
// with a cudaMemsetAsync on the same stream, so the pair is captured into a
// CUDA graph as a memset node and a kernel node and replays correctly.  A
// wait that outlasts about a second of polling traps rather than hanging the
// card.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
// resident blocks an SM at most (32 warps): 6% faster at level 0 of
// laplace_3d(64) on an H100 than 4, 5% slower at level 1
constexpr int BLOCKS_PER_SM = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned SPIN_LIMIT = 1u << 21;   // polls: about a second

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void wait_ready(const unsigned* flag) {
  unsigned polls = 0;
  while (ld_acquire(flag) == 0u) {
    if (++polls > SPIN_LIMIT) __trap();
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
tri_solve_kernel(const int* __restrict__ cols, const T* __restrict__ vals,
                 const T* __restrict__ diag, const T* __restrict__ r,
                 const T* __restrict__ x, const int* __restrict__ order, T* z,
                 T* __restrict__ y, unsigned long long* ticket, unsigned* flags,
                 int64_t D, int64_t m, int K, int64_t k, T w) {
  const int lane = threadIdx.x & 31;
  const unsigned long long total = static_cast<unsigned long long>(D * m);
  for (;;) {
    unsigned long long t = 0;
    if (lane == 0) t = atomicAdd(ticket, 1ull);
    t = __shfl_sync(FULL, t, 0);
    if (t >= total) return;
    const int64_t row = __ldg(order + t);           // d * m + i
    const int64_t d = row / m;
    const int* rc = cols + row * K;
    const T* rv = vals + row * K;
    const unsigned* fl = flags + d * m;
    const T* zd = z + d * m * k;
    const T dg = __ldg(diag + row);
    if (k == 1) {
      // the row's own operands load while the warp waits on its slots
      const T ri = lane == 0 ? __ldg(r + row) : T(0);
      const T xi = lane == 0 ? __ldg(x + row) : T(0);
      T acc = T(0);
      for (int e = lane; e < K; e += 32) {
        const int c = __ldg(rc + e);
        if (c >= 0) {
          wait_ready(fl + c);
          acc += __ldg(rv + e) * __ldcg(zd + c);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
      if (lane == 0) {
        const T zi = (ri - acc) / dg;
        __stcg(z + row, zi);
        y[row] = xi + w * zi;
        st_release(flags + row, 1u);     // orders this lane's stores before it
      }
    } else {
      // lane e holds slot e0 + e of each chunk of 32 slots and waits on it;
      // then lane j sums column j0 + j over the chunk's slots in order, the
      // slots' columns and values broadcast by shuffles so that the z loads
      // of several slots are in flight at once
      for (int64_t j0 = 0; j0 < k; j0 += 32) {
        const int64_t j = j0 + lane;
        const bool live = j < k;
        T acc = T(0);
        for (int e0 = 0; e0 < K; e0 += 32) {
          int c = -1;
          T v = T(0);
          if (e0 + lane < K) {
            c = __ldg(rc + e0 + lane);
            v = __ldg(rv + e0 + lane);
            if (c >= 0 && j0 == 0) wait_ready(fl + c);
          }
          __syncwarp();
          const int n = K - e0 < 32 ? K - e0 : 32;
#pragma unroll 4
          for (int e = 0; e < n; ++e) {
            const int ce = __shfl_sync(FULL, c, e);
            const T ve = __shfl_sync(FULL, v, e);
            const T zv = live && ce >= 0 ? __ldcg(zd + ce * k + j) : T(0);
            acc += ve * zv;
          }
        }
        if (live) {
          const int64_t at = row * k + j;
          const T zi = (__ldg(r + at) - acc) / dg;
          __stcg(z + at, zi);
          y[at] = __ldg(x + at) + w * zi;
        }
      }
      __threadfence();
      __syncwarp();
      if (lane == 0) st_release(flags + row, 1u);
    }
  }
}

template <typename T>
int resident_blocks() {
  static int cached[32] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 32 && cached[dev] > 0) return cached[dev];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tri_solve_kernel<T>, THREADS, 0);
  if (per_sm > BLOCKS_PER_SM) per_sm = BLOCKS_PER_SM;
  const int n = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (dev < 32) cached[dev] = n;
  return n;
}

template <typename T>
int launch(const int* cols, const T* vals, const T* diag, const T* r, const T* x,
           const int* order, T* z, T* y, void* scratch, int64_t D, int64_t m,
           int64_t K, int64_t k, double w, cudaStream_t stream) {
  // scratch: the ticket (8 bytes) and then one ready flag a row
  const size_t bytes = 8 + static_cast<size_t>(D * m) * sizeof(unsigned);
  cudaError_t err = cudaMemsetAsync(scratch, 0, bytes, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* ticket = static_cast<unsigned long long*>(scratch);
  auto* flags = reinterpret_cast<unsigned*>(static_cast<char*>(scratch) + 8);
  int64_t blocks = (D * m + WARPS - 1) / WARPS;
  const int resident = resident_blocks<T>();
  if (blocks > resident) blocks = resident;
  tri_solve_kernel<T><<<blocks, THREADS, 0, stream>>>(
      cols, vals, diag, r, x, order, z, y, ticket, flags, D, m,
      static_cast<int>(K), k, static_cast<T>(w));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the memset's error, else cudaGetLastError() after the launch (0 on
// success).  The caller guarantees D, m, k > 0, K >= 0, contiguous operands on
// one device, D * m < 2^31, cols != -1 only for columns of the row's rank
// that come before the row in `order` (a permutation of 0 .. D*m - 1, each
// row d * m + i after every row it depends on), scratch of 8 + 4*D*m bytes,
// 8-byte aligned, and z, y apart from every input.
extern "C" int tri_solve_launch(const void* cols, const void* vals,
                                const void* diag, const void* r, const void* x,
                                const void* order, void* z, void* y,
                                void* scratch, int64_t D, int64_t m, int64_t K,
                                int64_t k, double w, int is_f64, void* stream) {
  const auto* c = static_cast<const int*>(cols);
  const auto* o = static_cast<const int*>(order);
  auto s = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return launch<double>(c, static_cast<const double*>(vals),
                          static_cast<const double*>(diag),
                          static_cast<const double*>(r),
                          static_cast<const double*>(x), o,
                          static_cast<double*>(z), static_cast<double*>(y),
                          scratch, D, m, K, k, w, s);
  return launch<float>(c, static_cast<const float*>(vals),
                       static_cast<const float*>(diag),
                       static_cast<const float*>(r), static_cast<const float*>(x),
                       o, static_cast<float*>(z), static_cast<float*>(y), scratch,
                       D, m, K, k, w, s);
}
