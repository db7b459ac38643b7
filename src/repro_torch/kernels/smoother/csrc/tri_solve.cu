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
// r, x and y are [D, m, k] (k = 1 for vectors); z = T^-1 r is scratch.
//
// Bounds on an H100 SXM (80 GB HBM3 at 3.35 TB/s).  Bytes: the stored
// entries' column ids and values, diag, r and x are read once, y written once
//   t >= (nnz*(4 + sizeof(T)) + D*m*sizeof(T) + 3*D*m*k*sizeof(T)) / 3.35e12 s,
// 0.0134 ms at level 0 of laplace_3d(64) on 2 x 4 in float64.  Dependent
// steps: row i needs z of every row it couples to, so a solve is a chain as
// long as the triangle's DAG is deep (218 level sets at that level):
//   t >= depth * (one dependent step).
// That bound binds; the bytes do not.
//
// What a step costs, on an H100 (scripts/tune_kernel.py --kernel tri_solve,
// --chain for a pure chain of rows; PERF.md): far more than a memory round
// trip.  Waiting on values as the L2 route does, with each z in a thread-block
// cluster's shared memory, a chain took 2.5 us a step at 1024 threads a
// block and 1.6 at 256, slower than through the L2 (1.3-1.7): fewer waiting
// lanes, a shorter step, so their loads compete with the lane that has
// work.  Waiting at barriers instead took about 0.8 us a level set on one
// block (__syncthreads) and 1.4-1.9 on clusters of 2-8 blocks (the cluster
// barrier), which lost to the L2 route at every size; so a rank is one
// block or the L2 route, and the wrapper's rule (smoother.tri_plan) takes
// the block where it measured faster.  Both routes load each row's data
// from device memory on the chain of steps.  The staged route (bfloat16,
// k = 1) streams it into shared memory ahead of the solve, so a step is a
// named barrier, the row's shared-memory gathers and its division: 0.241
// us on a chain (about 0.165 of it the set loop and barrier, measured
// without the rows), 0.132 ms over level 0's 218 sets, where the bulk
// copies move about 25 GB/s an SM (PERF.md).
//
// Design.  No rank's triangle depends on another's (cols are rank-local), so
// each rank solves on its own; `order` [D, m] lists each rank's rows by
// level set, `starts` [D, nlev + 1] where each set begins.
//
// * Block route: one thread block a rank, z of the rank's m rows in its
//   shared memory.  The block's groups take a level set's rows by a static
//   stride, then every thread meets at __syncthreads before the next set.
//   A dependency lies in an earlier set, so its z is there: one plain load
//   from shared memory, and no flag.  A group fetches its next row's column
//   ids, values, r, x and diag (and the row index after it) before it
//   solves the current one.  No memset and no scratch in device memory:
//   captured in a CUDA graph, a launch is one kernel node.
// * Staged route (bfloat16 operands, k = 1): one thread block a rank, as the
//   block route, but every row's data streamed ahead of the solve.  The
//   wrapper builds a "slab" once a factor and row order (smoother.TriSlab):
//   each rank's rows in `order`, cut into stages of R = STAGED_ROWS rows, a
//   stage one contiguous, 16-byte aligned run of 32-bit words laid out as
//   [row header R][slot words KP x R] (slot-major, so lanes of consecutive
//   rows read consecutive words).  A header is the row index in its low 16
//   bits and the diagonal's bfloat16 bits in its high 16, a slot word the
//   column in its low 16 bits and the value's bfloat16 bits in its high
//   16: a bfloat16 widens to float32 by its place in the word, one AND.
//   Rows of K <= 32 slots take KP = K slots (an instance of the kernel for
//   each K, every slot's load unrolled), longer ones K rounded up to 32; the
//   extra slots, and the padding ones, are column m and value 0: z[m] is
//   0, so they add +0 and no slot is tested.  m < 65536 (z fits a block
//   only below 58,000 rows).  One producer thread copies stage after stage
//   by cp.async.bulk into a ring of shared-memory stages, each with a full
//   and an empty mbarrier (kernels/csrc/bulk_copy.cuh); it runs as far
//   ahead as the ring holds, never meeting the set barrier.  Shared memory also holds the
//   rank's z as float32 [m + 1], filled first with widened r (one coalesced
//   pass), so each row solves in place, z_i <- (z_i - sum v z_c) / d_i, and
//   the rank's level-set starts.  STAGED_CONSUMERS threads take a level
//   set's rows by a static stride, one lane a row: all of the row's z
//   gathers from shared memory at once, then its sum in the L2 route's
//   order (below), one division, one store; then a named barrier of the
//   consumers alone (bar.sync, never __syncthreads).  After each set one
//   consumer releases the stages whose rows are all solved.  An epilogue
//   writes y = x + w z for all m rows, coalesced, rounded once.  No memset
//   and no scratch in device memory: captured, a launch is one kernel node.
// * L2 route: z [D, m, k] in device memory, set to all-ones bits by a memset
//   on the same stream (a memset node and a kernel node in a graph), and a
//   persistent grid (two blocks an SM) whose groups take global positions p
//   by a static stride, position p being rank p % D's row order[p % D][p / D].
//   There is no barrier across a grid, so a dependency is waited on: z is
//   its own ready flag, all-ones bits (a NaN no result may take: a computed
//   z with that pattern, only a NaN carried in from r, is stored as the
//   canonical NaN) until written, and a consumer's one load at .gpu scope
//   returns either that (load again) or z itself; no flag array, no second
//   load, no ticket.  Progress: every group takes its rows in increasing
//   position, so the group holding the smallest unfinished position has
//   finished every row it took before and every dependency of that row (all
//   at smaller positions): it completes.  That needs only that every group
//   runs: the grid is sized to blocks the card holds at once and waits on
//   nothing outside the launch.  A wait that outlasts about a second traps
//   rather than hanging the card.
//
// Each row's sum runs in a fixed order (k = 1: lane g of a group of G lanes
// sums slots g, g + G, ... in turn, then a butterfly over the G lanes;
// k > 1: lane j sums column j over the slots in turn), so results repeat bit
// for bit whatever order the rows of a level set come in, and the routes
// give the same bits.  The staged route's one lane keeps the L2 route's
// order at G = 32: slot e goes into leaf e mod 32 (a fused multiply-add,
// in increasing e), and the leaves meet as the butterfly's lane 0 sums
// them, leaf[i] += leaf[i + o] for o = 16, 8, 4, 2, 1 (a float sum is
// commutative, so every lane of the butterfly holds the same bits).  The
// staged route keeps the least power of two of leaves that holds its KP
// slots and skips the butterfly's steps past them, which add zeros, as its
// padding slots do (x + 0 = x: only a zero's sign could differ).
// kernels/smoother/bf16_order.py emulates both orders on the CPU.
//
// Value types (value_types.cuh): float32 and float64 compute and keep z in
// their own type.  bfloat16 loads vals, diag, r and x as bfloat16 and widens
// them; the products, the row's sum, the division by the diagonal and z
// itself are float32 on both routes (z in shared memory and in the L2
// scratch, its ready flag a float32's bits), so no level set rounds what
// the next one reads; y = x + w * z is rounded once, at its store.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "bulk_copy.cuh"
#include "value_types.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
// lanes a row with one right-hand side (the level-0 strict triangle of a
// 27-point stencil has 13 entries; 8 and 16 measured slower on both routes)
constexpr int LANES = 32;
constexpr int BLOCK_THREADS = 1024;            // a block-route block at most
// slots of a row a lane fetches ahead (at least 16 a group); the rest load
// as the row is solved
template <int G>
constexpr int SLOTS = G < 16 ? 16 / G : 1;
constexpr int L2_THREADS = 256;
// the L2 route's resident blocks an SM at most: fewer waiting lanes leave
// the L2 to the loads that find their value
constexpr int L2_BLOCKS_PER_SM = 2;
constexpr long long TRAP_CYCLES = 2000000000ll; // about a second of waiting
// the staged route (smoother.py reads these four): rows a stage (a multiple
// of 4, so every stage stays 16-byte aligned), the threads that solve rows,
// and the ring's stages, at least (a pass of one row a consumer must fit
// the ring) and at most
constexpr int STAGED_ROWS = 128;
constexpr int STAGED_CONSUMERS = 256;
constexpr int STAGED_MIN_STAGES = 3;
constexpr int STAGED_MAX_STAGES = 8;
// a pass of one row a consumer spans this many stages at most
static_assert(STAGED_MIN_STAGES >= STAGED_CONSUMERS / STAGED_ROWS + 1, "the ring");
constexpr int STAGED_THREADS = STAGED_CONSUMERS + 32;   // and one producer warp
constexpr int STAGED_BARRIER = 1;                       // the consumers' named barrier

template <typename T> struct Bits;
template <> struct Bits<float> {
  using U = unsigned;
  static constexpr U EMPTY = 0xffffffffu;
  static constexpr U CANONICAL_NAN = 0x7fc00000u;
  __device__ static U of(float v) { return __float_as_uint(v); }
  __device__ static float value(U u) { return __uint_as_float(u); }
};
template <> struct Bits<double> {
  using U = unsigned long long;
  static constexpr U EMPTY = 0xffffffffffffffffull;
  static constexpr U CANONICAL_NAN = 0x7ff8000000000000ull;
  __device__ static U of(double v) {
    return static_cast<U>(__double_as_longlong(v));
  }
  __device__ static double value(U u) {
    return __longlong_as_double(static_cast<long long>(u));
  }
};

// the L2 route's one load of a dependency's z and the store that publishes
// a row's z: the value is all a producer publishes, so relaxed (single-copy
// atomic at .gpu scope) suffices; acquire / release cost 20-30%
__device__ __forceinline__ unsigned ld_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ unsigned long long ld_gpu(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_gpu(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ void st_gpu(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned ld_smem(uint32_t a, unsigned) {
  unsigned v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ unsigned long long ld_smem(uint32_t a, unsigned long long) {
  unsigned long long v;
  asm volatile("ld.shared.b64 %0, [%1];" : "=l"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void st_smem(uint32_t a, unsigned v) {
  asm volatile("st.shared.b32 [%0], %1;" :: "r"(a), "r"(v));
}
__device__ __forceinline__ void st_smem(uint32_t a, unsigned long long v) {
  asm volatile("st.shared.b64 [%0], %1;" :: "r"(a), "l"(v));
}

// z of one rank in the block's shared memory, written and read in different
// level sets, a barrier apart: plain accesses
template <typename T>
struct BlockZ {
  using U = typename Bits<T>::U;
  static constexpr bool WAITS = false;
  uint32_t base;   // the block's z (shared::cta address)
  uint32_t k;
  __device__ uint32_t at(int, int c, int j) const {
    return base + (static_cast<uint32_t>(c) * k + static_cast<uint32_t>(j)) *
                      static_cast<uint32_t>(sizeof(T));
  }
  __device__ U load(uint32_t a) const { return ld_smem(a, U()); }
  __device__ void store(uint32_t a, U v) const { st_smem(a, v); }
};

// z of every rank in device memory, each value its own ready flag
template <typename T>
struct GlobalZ {
  using U = typename Bits<T>::U;
  static constexpr bool WAITS = true;
  U* z;
  int64_t m, k;
  __device__ U* at(int d, int c, int j) const { return z + (d * m + c) * k + j; }
  __device__ U load(const U* a) const { return ld_gpu(a); }
  __device__ void store(U* a, U v) const { st_gpu(a, v); }
};

// z at a, whose first load gave v; where z waits, loads it again while it
// is empty
template <typename T, class Z, class A>
__device__ __forceinline__ T settle(const Z& z, A a, typename Bits<T>::U v) {
  if constexpr (Z::WAITS) {
    if (v == Bits<T>::EMPTY) {
      const long long t0 = clock64();
      do {
        v = z.load(a);
        if (clock64() - t0 > TRAP_CYCLES) __trap();
      } while (v == Bits<T>::EMPTY);
    }
  }
  return Bits<T>::value(v);
}

// z as stored: never the empty pattern
template <typename T>
__device__ __forceinline__ typename Bits<T>::U publish_bits(T v) {
  const auto u = Bits<T>::of(v);
  return u == Bits<T>::EMPTY ? Bits<T>::CANONICAL_NAN : u;
}

// the operands in the value type T; z, the sums and w in A = Acc<T>::type
template <typename T>
struct Args {
  using A = typename Acc<T>::type;
  const int* __restrict__ cols;
  const T* __restrict__ vals;
  const T* __restrict__ diag;
  const T* __restrict__ r;
  const T* __restrict__ x;
  T* __restrict__ y;
  int64_t m;
  int K;
  int64_t k;
  A w;
};

struct Pos {
  int d, i;   // rank, row of the rank
};

template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (G == 32) {
    return FULL;
  } else {
    const unsigned lane = threadIdx.x & 31u;
    return ((1u << G) - 1u) << (lane & ~static_cast<unsigned>(G - 1));
  }
}

// ---------------------------------------------------- one right-hand side
// a row's operands, widened to A
template <typename A, int S>
struct RowK1 {
  Pos at;
  int c[S];
  A v[S];
  A ri, xi, dg;
};

template <typename T, int G, int S, typename A = typename Acc<T>::type>
__device__ __forceinline__ void fetch_k1(const Args<T>& a, Pos at, int g,
                                         RowK1<A, S>& row) {
  row.at = at;
  const int64_t flat = at.d * a.m + at.i;
  const int* rc = a.cols + flat * a.K;
  const T* rv = a.vals + flat * a.K;
#pragma unroll
  for (int t = 0; t < S; ++t) {
    const int e = g + t * G;
    row.c[t] = e < a.K ? __ldg(rc + e) : -1;
    row.v[t] = e < a.K ? widen(__ldg(rv + e)) : A(0);
  }
  if (g == 0) {
    row.ri = widen(__ldg(a.r + flat));
    row.xi = widen(__ldg(a.x + flat));
    row.dg = widen(__ldg(a.diag + flat));
  }
}

template <typename T, int G, int S, class Z, typename A = typename Acc<T>::type>
__device__ __forceinline__ void solve_k1(const Args<T>& a, const Z& z,
                                         const RowK1<A, S>& row, int g,
                                         unsigned mask) {
  using U = typename Bits<A>::U;
  const int d = row.at.d;
  // every slot's load in flight at once, then each summed in turn
  decltype(z.at(0, 0, 0)) at[S];
  U bits[S];
#pragma unroll
  for (int t = 0; t < S; ++t) {
    if (row.c[t] >= 0) {
      at[t] = z.at(d, row.c[t], 0);
      bits[t] = z.load(at[t]);
    }
  }
  A acc = A(0);
#pragma unroll
  for (int t = 0; t < S; ++t)
    if (row.c[t] >= 0) acc += row.v[t] * settle<A>(z, at[t], bits[t]);
  if (a.K > S * G) {   // rows longer than the fetched slots
    const int64_t flat = d * a.m + row.at.i;
    for (int e = S * G + g; e < a.K; e += G) {
      const int c = __ldg(a.cols + flat * a.K + e);
      if (c >= 0) {
        const auto ce = z.at(d, c, 0);
        acc += widen(__ldg(a.vals + flat * a.K + e)) * settle<A>(z, ce, z.load(ce));
      }
    }
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(mask, acc, o);
  if (g == 0) {
    const auto bits = publish_bits<A>((row.ri - acc) / row.dg);
    z.store(z.at(d, row.at.i, 0), bits);
    store(a.y + d * a.m + row.at.i, row.xi + a.w * Bits<A>::value(bits));
  }
}

// ------------------------------------------------ k right-hand sides, k > 1
// lane g takes columns g, g + G, ...; the group loads G slots at a time and
// broadcasts each slot's column id and value by shuffles; W slots' loads of
// z in flight at once
template <typename T, int G, class Z>
__device__ void solve_multi(const Args<T>& a, const Z& z, Pos at, int g,
                            unsigned mask) {
  using A = typename Acc<T>::type;
  using U = typename Bits<A>::U;
  constexpr int W = G < 8 ? G : 8;
  const int64_t flat = at.d * a.m + at.i;
  const int* rc = a.cols + flat * a.K;
  const T* rv = a.vals + flat * a.K;
  const A dg = widen(__ldg(a.diag + flat));
  for (int64_t j0 = 0; j0 < a.k; j0 += G) {
    const int j = static_cast<int>(j0) + g;
    const bool live = j < a.k;
    const A rj = live ? widen(__ldg(a.r + flat * a.k + j)) : A(0);
    const A xj = live ? widen(__ldg(a.x + flat * a.k + j)) : A(0);
    A acc = A(0);
    for (int e0 = 0; e0 < a.K; e0 += G) {
      const bool has = e0 + g < a.K;
      const int cl = has ? __ldg(rc + e0 + g) : -1;
      const A vl = has ? widen(__ldg(rv + e0 + g)) : A(0);
      const int n = a.K - e0 < G ? a.K - e0 : G;
      for (int e = 0; e < n; e += W) {
        decltype(z.at(0, 0, 0)) ad[W];
        U bits[W];
        A ve[W];
        bool use[W];
#pragma unroll
        for (int u = 0; u < W; ++u) {
          const int src = (e + u) & (G - 1);
          const int ce = __shfl_sync(mask, cl, src, G);
          ve[u] = __shfl_sync(mask, vl, src, G);
          use[u] = live && e + u < n && ce >= 0;
          if (use[u]) {
            ad[u] = z.at(at.d, ce, j);
            bits[u] = z.load(ad[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < W; ++u)
          if (use[u]) acc += ve[u] * settle<A>(z, ad[u], bits[u]);
      }
    }
    if (live) {
      const auto bits = publish_bits<A>((rj - acc) / dg);
      z.store(z.at(at.d, at.i, j), bits);
      store(a.y + flat * a.k + j, xj + a.w * Bits<A>::value(bits));
    }
  }
}

// --------------------------------------------------------------- L2 route
// the group's rows: positions p, p + stride, ... < end, pos(p) their rows;
// with one right-hand side row p + stride is fetched, and position
// p + 2 stride read, while row p waits on its dependencies
template <typename T, int G, bool MULTI, class P>
__device__ void run_l2(const Args<T>& a, const GlobalZ<typename Acc<T>::type>& z,
                       P pos, int64_t p, int64_t stride, int64_t end) {
  const int g = static_cast<int>(threadIdx.x % G);
  const unsigned mask = group_mask<G>();
  if constexpr (MULTI) {
    for (; p < end; p += stride) solve_multi<T, G>(a, z, pos(p), g, mask);
  } else {
    constexpr int S = SLOTS<G>;
    if (p >= end) return;
    RowK1<typename Acc<T>::type, S> cur, nxt;
    fetch_k1<T, G, S>(a, pos(p), g, nxt);
    Pos ahead = p + stride < end ? pos(p + stride) : Pos{0, 0};
    for (; p < end; p += stride) {
      cur = nxt;
      if (p + stride < end) fetch_k1<T, G, S>(a, ahead, g, nxt);
      if (p + 2 * stride < end) ahead = pos(p + 2 * stride);
      solve_k1<T, G, S>(a, z, cur, g, mask);
    }
  }
}

// a persistent grid over every rank, z in device memory
template <typename T, int G, bool MULTI>
__global__ void __launch_bounds__(L2_THREADS)
tri_solve_l2_kernel(Args<T> a, const int* __restrict__ order,
                    typename Bits<typename Acc<T>::type>::U* z, int64_t D) {
  const GlobalZ<typename Acc<T>::type> zg{z, a.m, a.k};
  const int64_t groups = static_cast<int64_t>(gridDim.x) * (blockDim.x / G);
  const int64_t q = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  const int64_t m = a.m;
  auto pos = [order, D, m](int64_t p) {
    const int d = static_cast<int>(p % D);
    return Pos{d, __ldg(order + d * m + p / D)};
  };
  run_l2<T, G, MULTI>(a, zg, pos, q, groups, D * m);
}

// ------------------------------------------------------------ block route
// a group's place in its rank's rows, level set by level set: set L holds
// positions [st[L], st[L + 1]), the group positions st[L] + q, + groups, ...
struct Walk {
  const int* st;
  int nlev, q, groups;
  int L;
  int p;
  __device__ bool live() const { return L < nlev; }
  // onto the group's first row at or after (L, p)
  __device__ void settle() {
    while (L < nlev && p >= __ldg(st + L + 1)) {
      ++L;
      if (L < nlev) p = __ldg(st + L) + q;
    }
  }
  __device__ void next() {
    p += groups;
    settle();
  }
};

// one block a rank (blockIdx.x), solving the rank's rows level set by level
// set, z in its shared memory
template <typename T, int G, bool MULTI>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
tri_solve_block_kernel(Args<T> a, const int* __restrict__ order,
                       const int* __restrict__ starts, int nlev) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = static_cast<int>(blockIdx.x);
  const BlockZ<typename Acc<T>::type> z{
      static_cast<uint32_t>(__cvta_generic_to_shared(smem)),
      static_cast<uint32_t>(a.k)};
  const int* ord = order + d * a.m;
  const int* st = starts + static_cast<int64_t>(d) * (nlev + 1);
  const int g = static_cast<int>(threadIdx.x % G);
  const int q = static_cast<int>(threadIdx.x / G);
  const int groups = static_cast<int>(blockDim.x / G);
  const unsigned mask = group_mask<G>();
  if constexpr (MULTI) {
    for (int L = 0; L < nlev; ++L) {
      const int hi = __ldg(st + L + 1);
      for (int p = __ldg(st + L) + q; p < hi; p += groups)
        solve_multi<T, G>(a, z, Pos{d, __ldg(ord + p)}, g, mask);
      __syncthreads();
    }
  } else {
    constexpr int S = SLOTS<G>;
    // `ahead`: the row after the one fetched, its index read a row early
    Walk ahead{st, nlev, q, groups, 0, q};
    ahead.settle();
    RowK1<typename Acc<T>::type, S> cur, nxt;
    int idx = ahead.live() ? __ldg(ord + ahead.p) : 0;
    if (ahead.live()) {
      fetch_k1<T, G, S>(a, Pos{d, idx}, g, nxt);
      ahead.next();
      idx = ahead.live() ? __ldg(ord + ahead.p) : 0;
    }
    int hi = __ldg(st + 1);
    int p = q;
    for (int L = 0; L < nlev; ++L) {
      for (; p < hi; p += groups) {
        cur = nxt;
        const bool more = ahead.live();
        if (more) fetch_k1<T, G, S>(a, Pos{d, idx}, g, nxt);
        solve_k1<T, G, S>(a, z, cur, g, mask);
        if (more) {   // off the row's path: the walk to the row after
          ahead.next();
          idx = ahead.live() ? __ldg(ord + ahead.p) : 0;
        }
      }
      if (L + 1 < nlev) {   // the next set's bounds read before the barrier
        p = hi + q;
        hi = __ldg(st + L + 2);
      }
      __syncthreads();   // the set's z written before the next set reads
    }
  }
}

// ----------------------------------------------------------- staged route
// the slots a row takes in the slab for rows of K slots: K up to 32 (an
// instance each), past 32 K rounded up to 32 (the extra slots padding)
__host__ __device__ constexpr int64_t staged_slots(int64_t K) {
  return K <= 32 ? K : (K + 31) / 32 * 32;
}
// a stage's bytes, and the shared memory before the ring (z with its zero
// slot z[m], then the level-set starts, each rounded up to 16 bytes)
__host__ __device__ constexpr int64_t staged_stage_bytes(int64_t K) {
  return 4 * STAGED_ROWS * (1 + staged_slots(K));
}
__host__ __device__ constexpr int64_t round16(int64_t bytes) {
  return (bytes + 15) / 16 * 16;
}
__host__ __device__ constexpr int64_t staged_fixed_bytes(int64_t m, int64_t nlev) {
  return round16(4 * (m + 1)) + round16(4 * (nlev + 1));
}

// mbar_wait that traps after about a second rather than hang the card on
// a copy that never lands
__device__ __forceinline__ void staged_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long t0 = 0;
  for (int n = 0; !done; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done) {
      if (n == 0) t0 = clock64();
      else if (clock64() - t0 > TRAP_CYCLES) __trap();
    }
  }
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(STAGED_BARRIER), "n"(STAGED_CONSUMERS) : "memory");
}

// leaf[j] += leaf[j + N / 2], ..., down to leaf[0] (constant indices: the
// leaves stay in registers)
template <int N>
__device__ __forceinline__ void fold(float* leaf) {
  if constexpr (N > 1) {
#pragma unroll
    for (int j = 0; j < N / 2; ++j) leaf[j] += leaf[j + N / 2];
    fold<N / 2>(leaf);
  }
}

// one row's sum at stage offset `off` (KP slots a row, 1 to 32; 0: none,
// or past 32 `kp` of them in chunks of 32): every slot word of the
// row and its z gather at once, each slot a fused multiply-add into leaf
// e mod 32, then the leaves folded as the butterfly's lane 0 folds them
// (NL leaves, the least power of two holding the slots; past NL the
// butterfly adds zeros)
template <int KP>
__device__ __forceinline__ float staged_sum(const uint32_t* slots, int off, int kp,
                                            const float* z) {
  constexpr int NL = KP == 0 ? 32 : (KP <= 1 ? 1 : (KP <= 2 ? 2 : (KP <= 4 ? 4
                     : (KP <= 8 ? 8 : (KP <= 16 ? 16 : 32)))));
  constexpr int CH = KP == 0 ? 32 : KP;       // slots a chunk
  float leaf[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) leaf[j] = 0.f;
  const int n = KP == 0 ? kp : KP;
  for (int e0 = 0; e0 < n; e0 += CH) {
    uint32_t w[CH];
    float zc[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) w[j] = slots[(e0 + j) * STAGED_ROWS + off];
#pragma unroll
    for (int j = 0; j < CH; ++j) zc[j] = z[w[j] & 0xffffu];
#pragma unroll
    for (int j = 0; j < CH; ++j)
      leaf[j % NL] = fmaf(__uint_as_float(w[j] & 0xffff0000u), zc[j], leaf[j % NL]);
  }
  fold<NL>(leaf);
  return leaf[0];
}

// one block a rank (blockIdx.x): the producer warp's first thread streams
// the rank's stages; STAGED_CONSUMERS threads solve the level sets
template <int KP>
__global__ void __launch_bounds__(STAGED_THREADS, 1)
tri_solve_staged_kernel(const unsigned char* __restrict__ slab,
                        const __nv_bfloat16* __restrict__ r,
                        const __nv_bfloat16* __restrict__ x,
                        __nv_bfloat16* __restrict__ y,
                        const int* __restrict__ starts, int m, int K, int nlev,
                        int stages, float w) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int d = static_cast<int>(blockIdx.x);
  const int nst = (m + STAGED_ROWS - 1) / STAGED_ROWS;
  const int kp = static_cast<int>(staged_slots(K));
  const int64_t sb = staged_stage_bytes(K);
  float* z = reinterpret_cast<float*>(smem);
  int* st = reinterpret_cast<int*>(smem + round16(4 * (static_cast<int64_t>(m) + 1)));
  unsigned char* ring = smem + staged_fixed_bytes(m, nlev);
  const uint32_t bars = smem_u32(ring + stages * sb);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (stages + s); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= STAGED_CONSUMERS) {
    // the producer: stage q into ring slot q % stages, once its rows of
    // round q / stages - 1 are released
    if (threadIdx.x == STAGED_CONSUMERS) {
      const unsigned char* src = slab + static_cast<int64_t>(d) * nst * sb;
      int s = 0;
      uint32_t round = 0;
      for (int q = 0; q < nst; ++q) {
        if (round > 0) staged_wait(empty(s), (round - 1) & 1);
        mbar_expect_tx(full(s), static_cast<uint32_t>(sb));
        bulk_load(smem_u32(ring + s * sb), src + q * sb, static_cast<uint32_t>(sb), full(s));
        if (++s == stages) {
          s = 0;
          ++round;
        }
      }
    }
    return;
  }

  // the consumers: z <- r widened (z[m] = 0, the padding slots' column),
  // the starts, then the level sets
  const int t = static_cast<int>(threadIdx.x);
  const __nv_bfloat16* rd = r + static_cast<int64_t>(d) * m;
  for (int i = t; i <= m; i += STAGED_CONSUMERS) z[i] = i < m ? __bfloat162float(rd[i]) : 0.f;
  const int* sd = starts + static_cast<int64_t>(d) * (nlev + 1);
  for (int L = t; L <= nlev; L += STAGED_CONSUMERS) st[L] = sd[L];
  consumers_sync();
  // this thread's stage (q, its ring slot and round), advanced as its rows
  // move on; thread 0's next stage to release and its slot
  int q = -1, slot = -1;
  uint32_t round = 0;
  const uint32_t* stage = nullptr;
  int released = 0, rslot = 0;
  int lo = st[0];
  for (int L = 0; L < nlev; ++L) {
    const int hi = st[L + 1];
    // the set in passes of one row a consumer; a pass touches at most
    // STAGED_MIN_STAGES stages, and the stages before it are released, so
    // a set wider than the ring cannot wait on stages the producer holds
    for (int a = lo;; a += STAGED_CONSUMERS) {
      const int b = a + STAGED_CONSUMERS < hi ? a + STAGED_CONSUMERS : hi;
      const int p = a + t;
      if (p < b) {
        const int pq = static_cast<int>(static_cast<unsigned>(p) / STAGED_ROWS);
        if (pq != q) {
          while (q < pq) {
            ++q;
            if (++slot == stages) {
              slot = 0;
              ++round;
            }
          }
          staged_wait(full(slot), round & 1);
          stage = reinterpret_cast<const uint32_t*>(ring + slot * sb);
        }
        const int off = p - pq * STAGED_ROWS;
        const uint32_t h = stage[off];             // row index | diag's bf16 bits
        const int i = static_cast<int>(h & 0xffffu);
        const float s = staged_sum<KP>(stage + STAGED_ROWS, off, kp, z);
        z[i] = (z[i] - s) / __uint_as_float(h & 0xffff0000u);
      }
      consumers_sync();   // the pass's z written before the next set reads
      if (t == 0) {
        // every stage whose rows all lie before b is free for the producer
        while (released < nst &&
               (released + 1 < nst ? (released + 1) * STAGED_ROWS : m) <= b) {
          mbar_arrive(empty(rslot));
          ++released;
          if (++rslot == stages) rslot = 0;
        }
      }
      if (b >= hi) break;
    }
    lo = hi;
  }
  const __nv_bfloat16* xd = x + static_cast<int64_t>(d) * m;
  __nv_bfloat16* yd = y + static_cast<int64_t>(d) * m;
  for (int i = t; i < m; i += STAGED_CONSUMERS)
    yd[i] = __float2bfloat16_rn(fmaf(w, z[i], __bfloat162float(xd[i])));
}

// ------------------------------------------------------------------ launch
constexpr int MAX_DEVICES = 32;

int device_index() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev;
}

int smem_optin() {
  static int cached[MAX_DEVICES] = {0};
  const int dev = device_index();
  if (dev < MAX_DEVICES && cached[dev] > 0) return cached[dev];
  int bytes = 0;
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (dev < MAX_DEVICES) cached[dev] = bytes;
  return bytes;
}

template <typename T, int G, bool MULTI>
int launch_block(const Args<T>& a, const int* order, const int* starts,
                 int64_t nlev, int64_t D, cudaStream_t stream) {
  static bool ready[MAX_DEVICES] = {false};   // the opt-in set, a device
  const int dev = device_index();
  if (dev >= MAX_DEVICES || !ready[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        tri_solve_block_kernel<T, G, MULTI>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin());
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < MAX_DEVICES) ready[dev] = true;
  }
  const int64_t lanes = ((a.m * G + 31) / 32) * 32;
  const unsigned threads =
      static_cast<unsigned>(lanes < BLOCK_THREADS ? lanes : BLOCK_THREADS);
  tri_solve_block_kernel<T, G, MULTI>
      <<<static_cast<unsigned>(D), threads,
         static_cast<size_t>(a.m * a.k) * sizeof(typename Acc<T>::type), stream>>>(
          a, order, starts, static_cast<int>(nlev));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G, bool MULTI>
int resident_l2_blocks() {
  static int cached[MAX_DEVICES] = {0};
  const int dev = device_index();
  if (dev < MAX_DEVICES && cached[dev] > 0) return cached[dev];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, tri_solve_l2_kernel<T, G, MULTI>, L2_THREADS, 0);
  if (per_sm > L2_BLOCKS_PER_SM) per_sm = L2_BLOCKS_PER_SM;
  const int n = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (dev < MAX_DEVICES) cached[dev] = n;
  return n;
}

template <typename T, int G, bool MULTI>
int launch_l2(const Args<T>& a, const int* order, void* z, int64_t D,
              cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const size_t bytes = static_cast<size_t>(D * a.m * a.k) * sizeof(A);
  cudaError_t err = cudaMemsetAsync(z, 0xff, bytes, stream);   // all empty
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t blocks = (D * a.m * G + L2_THREADS - 1) / L2_THREADS;
  const int resident = resident_l2_blocks<T, G, MULTI>();
  if (blocks > resident) blocks = resident;
  tri_solve_l2_kernel<T, G, MULTI><<<static_cast<unsigned>(blocks), L2_THREADS, 0, stream>>>(
      a, order, static_cast<typename Bits<A>::U*>(z), D);
  return static_cast<int>(cudaGetLastError());
}

template <int KP>
int launch_staged_kp(const unsigned char* slab, const __nv_bfloat16* r,
                     const __nv_bfloat16* x, __nv_bfloat16* y, const int* starts,
                     int64_t D, int64_t m, int64_t K, int64_t nlev, int64_t stages,
                     size_t bytes, float w, cudaStream_t stream) {
  static bool ready[MAX_DEVICES] = {false};   // the opt-in set, a device
  const int dev = device_index();
  if (dev >= MAX_DEVICES || !ready[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        tri_solve_staged_kernel<KP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_optin());
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < MAX_DEVICES) ready[dev] = true;
  }
  tri_solve_staged_kernel<KP><<<static_cast<unsigned>(D), STAGED_THREADS, bytes, stream>>>(
      slab, r, x, y, starts, static_cast<int>(m), static_cast<int>(K),
      static_cast<int>(nlev), static_cast<int>(stages), w);
  return static_cast<int>(cudaGetLastError());
}

// the ring takes as many stages as the opt-in leaves beside z and the starts,
// STAGED_MIN_STAGES at least and STAGED_MAX_STAGES at most; rows and
// columns fit 16 bits (m < 65536); else cudaErrorInvalidValue
// (smoother.tri_plan never plans the route there).  An instance a slot
// count up to 32 (every slot's load unrolled), one for longer rows (and
// for none).
int launch_staged(const void* slab, const __nv_bfloat16* r, const __nv_bfloat16* x,
                  __nv_bfloat16* y, const int* starts, int64_t D, int64_t m,
                  int64_t K, int64_t nlev, double w, cudaStream_t stream) {
  const int64_t fixed = staged_fixed_bytes(m, nlev);
  const int64_t sb = staged_stage_bytes(K);
  int64_t stages = (smem_optin() - fixed - 16 * STAGED_MAX_STAGES) / sb;
  if (stages > STAGED_MAX_STAGES) stages = STAGED_MAX_STAGES;
  if (stages < STAGED_MIN_STAGES || m >= 65536)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>(fixed + stages * (sb + 16));
  const auto* s = static_cast<const unsigned char*>(slab);
  const float wf = static_cast<float>(w);
#define STAGED_CASE(KP) \
  case KP:              \
    return launch_staged_kp<KP>(s, r, x, y, starts, D, m, K, nlev, stages, bytes, wf, stream);
  switch (K > 32 ? 0 : K) {
    STAGED_CASE(0) STAGED_CASE(1) STAGED_CASE(2) STAGED_CASE(3) STAGED_CASE(4)
    STAGED_CASE(5) STAGED_CASE(6) STAGED_CASE(7) STAGED_CASE(8) STAGED_CASE(9)
    STAGED_CASE(10) STAGED_CASE(11) STAGED_CASE(12) STAGED_CASE(13) STAGED_CASE(14)
    STAGED_CASE(15) STAGED_CASE(16) STAGED_CASE(17) STAGED_CASE(18) STAGED_CASE(19)
    STAGED_CASE(20) STAGED_CASE(21) STAGED_CASE(22) STAGED_CASE(23) STAGED_CASE(24)
    STAGED_CASE(25) STAGED_CASE(26) STAGED_CASE(27) STAGED_CASE(28) STAGED_CASE(29)
    STAGED_CASE(30) STAGED_CASE(31) STAGED_CASE(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef STAGED_CASE
}

// the routes' codes (smoother.TRI_ROUTE_CODES)
constexpr int ROUTE_L2 = 0, ROUTE_BLOCK = 1, ROUTE_STAGED = 2;

template <typename T, int G, bool MULTI>
int launch_route(const Args<T>& a, const int* order, const int* starts,
                 int64_t nlev, void* z, int64_t D, int route, cudaStream_t stream) {
  if (route == ROUTE_BLOCK)
    return launch_block<T, G, MULTI>(a, order, starts, nlev, D, stream);
  return launch_l2<T, G, MULTI>(a, order, z, D, stream);
}

template <typename T>
int launch(const int* cols, const T* vals, const T* diag, const T* r, const T* x,
           const int* order, const int* starts, void* z, T* y, int64_t D,
           int64_t m, int64_t K, int64_t k, int64_t nlev, double w, int route,
           cudaStream_t stream) {
  if (route == ROUTE_STAGED) {
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      if (k == 1) return launch_staged(z, r, x, y, starts, D, m, K, nlev, w, stream);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route != ROUTE_L2 && route != ROUTE_BLOCK)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args<T> a{cols, vals, diag, r, x, y, m, static_cast<int>(K), k,
                  static_cast<typename Acc<T>::type>(w)};
  if (k == 1)
    return launch_route<T, LANES, false>(a, order, starts, nlev, z, D, route, stream);
  if (k <= 8) return launch_route<T, 8, true>(a, order, starts, nlev, z, D, route, stream);
  if (k <= 16) return launch_route<T, 16, true>(a, order, starts, nlev, z, D, route, stream);
  return launch_route<T, 32, true>(a, order, starts, nlev, z, D, route, stream);
}

}  // namespace

// y = x + w * T^-1 r.  `order` [D, m] lists each rank's rows by level set
// (ref.rank_level_order), `starts` [D, nlev + 1] where each of the nlev level
// sets begins in it (ref.rank_level_starts; nlev the most level sets of any
// rank).  dtype: 0 float32, 1 float64, 2 bfloat16 (z in float32).  `route`:
// 0 the L2 route (z: scratch of D*m*k elements of z's type, 8-byte aligned;
// starts and nlev unused), 1 the block route (m*k*sizeof(z) bytes of shared
// memory at most the card's opt-in limit, tri_solve_smem; z unused), 2 the
// staged route, bfloat16 and k = 1 only (z: the slab, smoother.TriSlab's
// bytes for this order, 16-byte aligned; cols, vals, diag and order unused;
// z, the starts and STAGED_MIN_STAGES stages within the opt-in).  Returns
// the memset's error, else the launch's, else cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for an unknown dtype or route code or
// a case the route cannot take.  The caller guarantees D, m, k > 0, K >= 0,
// contiguous operands on one device, D * m < 2^31, cols != -1 only for
// columns of the row's rank that it depends on, and y apart from every
// input.
extern "C" int tri_solve_launch(const void* cols, const void* vals,
                                const void* diag, const void* r, const void* x,
                                const void* order, const void* starts, void* z,
                                void* y, int64_t D, int64_t m, int64_t K,
                                int64_t k, int64_t nlev, double w, int dtype,
                                int route, void* stream) {
  const auto* c = static_cast<const int*>(cols);
  const auto* o = static_cast<const int*>(order);
  const auto* st = static_cast<const int*>(starts);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(c, static_cast<const float*>(vals),
                           static_cast<const float*>(diag),
                           static_cast<const float*>(r), static_cast<const float*>(x),
                           o, st, z, static_cast<float*>(y), D, m, K, k, nlev, w,
                           route, s);
    case 1:
      return launch<double>(c, static_cast<const double*>(vals),
                            static_cast<const double*>(diag),
                            static_cast<const double*>(r),
                            static_cast<const double*>(x), o, st, z,
                            static_cast<double*>(y), D, m, K, k, nlev, w, route, s);
    case 2:
      return launch<__nv_bfloat16>(c, static_cast<const __nv_bfloat16*>(vals),
                                   static_cast<const __nv_bfloat16*>(diag),
                                   static_cast<const __nv_bfloat16*>(r),
                                   static_cast<const __nv_bfloat16*>(x), o, st, z,
                                   static_cast<__nv_bfloat16*>(y), D, m, K, k,
                                   nlev, w, route, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The opt-in shared memory a block may have on the current device (bytes):
// the block route's limit on m*k*sizeof(z).  Returns a CUDA error (0 on
// success).
extern "C" int tri_solve_smem(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(err);
}
