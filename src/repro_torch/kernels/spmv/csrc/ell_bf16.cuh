// The bfloat16 instances of ell_spmv (ell_spmv.cu, k = 1) and ell_spmm
// (ell_spmm.cu): Y[d, i, :] = sum_s vals[d, i, s] * X[d, cols[d, i, s], :]
// with cols/vals [D, n, K] (cols == -1 is padding), X [D, m, k] (x [D, m]
// is k = 1), bfloat16 values, float32 products and sums, each output
// rounded once (__float2bfloat16_rn).
//
// Bound on an H100 SXM (3.35 TB/s): every slot's int32 column id, the
// stored entries' bfloat16 values, X and Y once,
//   t >= (D*n*K*4 + nnz*2 + D*(m + n)*k*2) / 3.35e12 s;
// at the AMG path's level-0 A_on (K = 27) the ids are 57-67% of it.
//
// What held the float32/float64 designs back in bfloat16 was not device
// memory but the work a slot costs on the SM and the latency of dependent
// trips: values waited on their ids, products went through shared memory
// and back, and one thread per row summed them after a barrier.  Here:
//   - A persistent grid: SMs x resident blocks (capped at the work), each
//     block a contiguous run of units.  A unit is R consecutive rows, R*K
//     contiguous slots in the row-major layout (R a multiple of 8, so a
//     unit starts 16-byte aligned for both ids and values).
//   - A's stream by 1-D bulk copies (cp.async.bulk, no tensor map; the
//     PTX in kernels/csrc/bulk_copy.cuh): one
//     producer thread copies each unit's ids and values, in chunks of at
//     most STAGE_SLOTS slots (a multiple of 8), into a ring of STAGES
//     shared-memory stages, each guarded by a full and an empty mbarrier.
//     No register or load instruction of the summing threads goes to the
//     stream and a value never waits on its id.  One stage measured
//     fastest on an H100 (PERF.md): the shared memory more stages take
//     from L1 costs the gathers more than overlap inside a block gains;
//     the 8 blocks resident on an SM overlap one another's copies and
//     gathers.  A chunk's last len % 8 slots (only the last unit can have
//     them) the producer stores itself.  The copy also moves padded slots'
//     values, which the bound does not count.
//     Operands whose ids or values are not 16-byte aligned take the same
//     kernel without the copies (BULK false): the summing threads load
//     from device memory in the same order, so the results are the same.
//   - Sums in registers, in a fixed order: G lanes a row split its slots
//     (slot s to lane s % G, in increasing s), V lanes a row split its
//     columns (W each: one 16-, 8-, 4- or 2-byte X piece a slot); a lane's
//     partial sums carry from chunk to chunk, and the G lanes' sums meet in
//     a shuffle tree (xor G/2, ..., 1).  G is 1 (one lane a row: the
//     level-0 operands of the AMG path) and doubles while a unit of R*K
//     slots would not fit a stage (rows of hundreds of slots and more) and
//     while the operand then still has at most TARGET_UNITS units (the
//     coarser levels: more blocks, shorter chains a lane).  No atomics:
//     results repeat bit for bit.
//   - X is gathered through the read-only path (__ldg): at the solve's
//     sizes x (512 KB) and X (4 MB at k = 8) stay in the 50 MB L2.
// Measured at level-0 A_on (PERF.md): the stream alone runs at the byte
// bound; what is left is the gathers' wait on L2 (a unit's ±1-plane
// neighbours miss L1) and, at k = 8, their 16 bytes a slot of L2 traffic.
// kernels/spmv/bf16_order.py emulates this order of sums on the CPU.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "bulk_copy.cuh"
#include "value_types.cuh"

// internal linkage: both kernel libraries hold this code, and a function-
// local static of a template with external linkage would be one object
// across the libraries loaded into a process (each library's kernels need
// their own shared-memory opt-in)
namespace {
namespace ell_bf16 {

using bf16 = __nv_bfloat16;

constexpr int CONSUMERS = 128;           // threads that sum rows
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int STAGES = 1;                // the ring of shared-memory stages
constexpr int STAGE_SLOTS = 3456;        // slots a stage holds (a multiple of 8)
constexpr int MAX_LANES = 16;            // lanes a row at most (so R >= 8)
constexpr int TARGET_UNITS = 512;        // units of more lanes a row, at most (one wave)
constexpr int MAX_BLOCKS_PER_SM = 10;    // resident blocks the grid counts at most
constexpr int UNROLL_NARROW = 16;        // slots a lane's loads run ahead, W <= 2
constexpr int UNROLL_WIDE = 4;           // the same for W = 4 and 8
constexpr int MAX_DEVICES = 32;
constexpr int SMEM_BYTES = STAGES * STAGE_SLOTS * 6 + 2 * STAGES * 8;

// slots a lane's loads run ahead of its sums: fewer for the 8- and 16-byte
// X pieces, whose widened values take 4 or 8 registers a slot
template <int W>
__host__ __device__ constexpr int unroll() { return W >= 4 ? UNROLL_WIDE : UNROLL_NARROW; }

struct Args {
  const int* cols;
  const bf16* vals;
  const bf16* X;
  bf16* Y;
  int64_t rows;    // D * n
  int64_t n, m, k, K;
  int R, V, G, KT;
  int64_t tiles;   // column tiles of KT columns
  int64_t works;   // units x column tiles
};

template <bool BULK>
__device__ __forceinline__ int load_id(const int* p) {
  if constexpr (BULK) return *p;
  else return __ldg(p);
}

template <bool BULK>
__device__ __forceinline__ float load_val(const bf16* p) {
  if constexpr (BULK) return __bfloat162float(*p);
  else return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ float2 bf2(unsigned u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// the W entries of X's row c from xd (zeros for padding, c < 0)
template <int W>
__device__ __forceinline__ void load_x(const bf16* xd, int c, int64_t k, float* o) {
  if (c < 0) {
#pragma unroll
    for (int w = 0; w < W; ++w) o[w] = 0.f;
    return;
  }
  const bf16* p = xd + static_cast<int64_t>(c) * k;
  if constexpr (W == 1) {
    o[0] = __bfloat162float(__ldg(p));
  } else if constexpr (W == 2) {
    const float2 a = bf2(__ldg(reinterpret_cast<const unsigned*>(p)));
    o[0] = a.x; o[1] = a.y;
  } else if constexpr (W == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = bf2(t.x), b = bf2(t.y);
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  } else {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = bf2(u[i]);
      o[2 * i] = a.x; o[2 * i + 1] = a.y;
    }
  }
}

__device__ __forceinline__ unsigned bf2_bits(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// the W sums to p, each rounded once
template <int W>
__device__ __forceinline__ void store_y(bf16* p, const float* v) {
  if constexpr (W == 1) {
    *p = __float2bfloat16_rn(v[0]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<unsigned*>(p) = bf2_bits(v[0], v[1]);
  } else if constexpr (W == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(bf2_bits(v[0], v[1]), bf2_bits(v[2], v[3]));
  } else {
    *reinterpret_cast<uint4*>(p) = make_uint4(bf2_bits(v[0], v[1]), bf2_bits(v[2], v[3]),
                                              bf2_bits(v[4], v[5]), bf2_bits(v[6], v[7]));
  }
}

// One lane's slots j, j + G, ... < je of a chunk (ci, vi: the chunk's ids
// and values), in increasing order, unroll<W>() at a time: their ids and
// values, then their gathers, then their products into acc (the last group
// predicated, so no slot waits on the one before it).
template <int W, bool BULK>
__device__ __forceinline__ void lane_slots(const int* ci, const bf16* vi, int j, int je, int G,
                                           const bf16* xd, int64_t k, float* acc) {
  constexpr int UNROLL = unroll<W>();
  for (; j < je; j += UNROLL * G) {
    int c[UNROLL];
    float v[UNROLL], xv[UNROLL][W];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const bool in = j + u * G < je;
      c[u] = in ? load_id<BULK>(ci + j + u * G) : -1;
      v[u] = in ? load_val<BULK>(vi + j + u * G) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) load_x<W>(xd, c[u], k, xv[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (c[u] >= 0) {                    // never 0 x a padded NaN
#pragma unroll
        for (int w = 0; w < W; ++w) acc[w] = fmaf(v[u], xv[u][w], acc[w]);
      }
    }
  }
}

// Shared memory (BULK): ids int[STAGES][STAGE_SLOTS], values
// bf16[STAGES][STAGE_SLOTS], then the mbarriers full[STAGES], empty[STAGES].
template <int W, bool BULK>
__global__ void __launch_bounds__(THREADS) ell_bf16_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  int* sid = reinterpret_cast<int*>(smem);
  bf16* sval = reinterpret_cast<bf16*>(smem + STAGES * STAGE_SLOTS * 4);
  const uint32_t bars = smem_u32(smem + STAGES * STAGE_SLOTS * 6);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  // this block's works (unit x column tile), a contiguous run
  const int64_t w0 = a.works * blockIdx.x / gridDim.x;
  const int64_t w1 = a.works * (blockIdx.x + 1) / gridDim.x;

  if constexpr (BULK) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(full(s), 1);
        mbar_init(empty(s), CONSUMERS / 32);
      }
      mbar_init_fence();
    }
    __syncthreads();
  }

  if (threadIdx.x < 32) {
    // the producer: one thread issues every copy, in the consumers' order
    if constexpr (BULK) {
      if (threadIdx.x == 0) {
        // the stage of the next chunk, its round of the ring, and whether
        // the stage has been filled before (then wait for its release)
        int s = 0;
        uint32_t round = 0;
        for (int64_t w = w0; w < w1; ++w) {
          const int64_t row0 = (a.tiles == 1 ? w : w / a.tiles) * a.R;
          const int64_t nr = a.rows - row0 < a.R ? a.rows - row0 : a.R;
          const int64_t ns = nr * a.K, s0 = row0 * a.K;
          for (int64_t c0 = 0; c0 < ns; c0 += STAGE_SLOTS) {
            if (round > 0) mbar_wait(empty(s), (round - 1) & 1);
            const int len = static_cast<int>(ns - c0 < STAGE_SLOTS ? ns - c0 : STAGE_SLOTS);
            const int bulk = len & ~7;
            int* ds = sid + s * STAGE_SLOTS;
            bf16* dv = sval + s * STAGE_SLOTS;
            for (int q = bulk; q < len; ++q) {
              ds[q] = __ldg(a.cols + s0 + c0 + q);
              dv[q] = __ldg(a.vals + s0 + c0 + q);
            }
            if (bulk < len) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            mbar_expect_tx(full(s), static_cast<uint32_t>(bulk) * 6);
            if (bulk > 0) {
              bulk_load(smem_u32(ds), a.cols + s0 + c0, bulk * 4, full(s));
              bulk_load(smem_u32(dv), a.vals + s0 + c0, bulk * 2, full(s));
            }
            if (++s == STAGES) {
              s = 0;
              ++round;
            }
          }
        }
      }
    }
    return;
  }

  // the consumers: thread t takes row r of a unit, slot lane g, column
  // vector v (W columns) of the column tile
  const int t = static_cast<int>(threadIdx.x) - 32;
  const int L = a.V * a.G;
  const int r = t / L, l = t - r * L;
  const int g = l / a.V, v = l - g * a.V;
  const int lane = t & 31;
  // row ids fit 32 bits wherever a card's memory could hold the operand;
  // a 32-bit division is a few instructions, a 64-bit one a long call
  const bool narrow = a.rows <= 0x7fffffff;
  int s = 0;                              // the next chunk's stage and round
  uint32_t round = 0;
  for (int64_t w = w0; w < w1; ++w) {
    const int64_t u = a.tiles == 1 ? w : w / a.tiles;
    const int64_t ct = w - u * a.tiles;
    const int64_t row0 = u * a.R;
    const int64_t nr = a.rows - row0 < a.R ? a.rows - row0 : a.R;
    const int64_t ns = nr * a.K, s0 = row0 * a.K;
    const int64_t col0 = ct * a.KT + static_cast<int64_t>(v) * W;
    const bool active = r < nr && col0 < a.k;
    const int64_t row = row0 + r;
    const int64_t d = !active ? 0
                      : narrow ? static_cast<int64_t>(static_cast<unsigned>(row) /
                                                      static_cast<unsigned>(a.n))
                               : row / a.n;
    const bf16* xd = a.X + d * a.m * a.k + col0;
    const int64_t ra = static_cast<int64_t>(r) * a.K;   // the row's first slot
    float acc[W];
#pragma unroll
    for (int q = 0; q < W; ++q) acc[q] = 0.f;
    for (int64_t c0 = 0; c0 < ns; c0 += STAGE_SLOTS) {
      const int len = static_cast<int>(ns - c0 < STAGE_SLOTS ? ns - c0 : STAGE_SLOTS);
      const int* ci;
      const bf16* vi;
      if constexpr (BULK) {
        mbar_wait(full(s), round & 1);
        ci = sid + s * STAGE_SLOTS;
        vi = sval + s * STAGE_SLOTS;
      } else {
        ci = a.cols + s0 + c0;
        vi = a.vals + s0 + c0;
      }
      if (active) {
        // the row's slots in this chunk, [sa, se) of the unit; this lane's
        // first is the one at a row offset = g (mod G)
        const int64_t sa = ra > c0 ? ra : c0;
        const int64_t se = ra + a.K < c0 + len ? ra + a.K : c0 + len;
        if (sa < se) {
          const int off = static_cast<int>((sa - ra) % a.G);
          const int first = static_cast<int>(sa - c0) + (g - off + a.G) % a.G;
          lane_slots<W, BULK>(ci, vi, first, static_cast<int>(se - c0), a.G, xd, a.k, acc);
        }
      }
      if constexpr (BULK) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));
        if (++s == STAGES) {
          s = 0;
          ++round;
        }
      }
    }
    // the row's G lanes (V * G consecutive threads, V * G dividing 32
    // where G > 1) meet in a fixed tree: xor G/2, ..., 1
    for (int h = a.G / 2; h >= 1; h /= 2) {
#pragma unroll
      for (int q = 0; q < W; ++q) acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], h * a.V);
    }
    if (active && g == 0) store_y<W>(a.Y + row * a.k + col0, acc);
  }
}

struct Plan {
  int V, G, R, KT;
  int64_t tiles;
};

// V lanes of W columns a row (up to MAX_LANES); G lanes a row over its
// slots: 1, doubled while a unit of R rows would not fit a stage, then
// while 2G <= K and the operand cut for 2G lanes still has at most
// TARGET_UNITS units (small operands: more, shorter units in one wave of
// blocks, each lane's chain of gathers shorter); at most MAX_LANES / V,
// and 1 where V is no power of two (so the G lanes of a row lie in one
// warp); R = CONSUMERS / (V G) rounded down to a multiple of 8.
// kernels/spmv/bf16_order.py:plan is this rule.
inline Plan plan(int64_t rows, int64_t K, int64_t k, int W) {
  Plan p{};
  const int64_t vecs = (k + W - 1) / W;
  p.V = static_cast<int>(vecs < MAX_LANES ? vecs : MAX_LANES);
  p.KT = p.V * W;
  const int gmax = (p.V & (p.V - 1)) == 0 ? MAX_LANES / p.V : 1;
  p.G = 1;
  auto rows_of = [&](int G) { return CONSUMERS / (p.V * G) / 8 * 8; };
  auto units = [&](int G) { return (rows + rows_of(G) - 1) / rows_of(G); };
  while (p.G < gmax && rows_of(p.G) * K > STAGE_SLOTS) p.G *= 2;
  while (p.G < gmax && 2 * p.G <= K && units(2 * p.G) <= TARGET_UNITS) p.G *= 2;
  p.R = rows_of(p.G);
  p.tiles = (k + p.KT - 1) / p.KT;
  return p;
}

// blocks of instance <W, BULK> resident on the card at once (SMs x blocks
// an SM, at most MAX_BLOCKS_PER_SM); the opt-in to its shared memory is set
// on first use, once a device (safe under stream capture)
template <int W, bool BULK>
int resident_blocks(int* out) {
  static int cached[MAX_DEVICES] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < MAX_DEVICES && cached[dev] > 0) {
    *out = cached[dev];
    return 0;
  }
  const auto kern = ell_bf16_kernel<W, BULK>;
  const int smem = BULK ? SMEM_BYTES : 0;
  if (BULK) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm > MAX_BLOCKS_PER_SM) per_sm = MAX_BLOCKS_PER_SM;
  *out = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (dev < MAX_DEVICES) cached[dev] = *out;
  return 0;
}

template <int W>
int launch_w(Args a, cudaStream_t stream) {
  const Plan p = plan(a.rows, a.K, a.k, W);
  a.R = p.R;
  a.V = p.V;
  a.G = p.G;
  a.KT = p.KT;
  a.tiles = p.tiles;
  a.works = (a.rows + p.R - 1) / p.R * p.tiles;
  const bool bulk =
      (reinterpret_cast<uintptr_t>(a.cols) | reinterpret_cast<uintptr_t>(a.vals)) % 16 == 0;
  int blocks = 0;
  const int rc = bulk ? resident_blocks<W, true>(&blocks) : resident_blocks<W, false>(&blocks);
  if (rc != 0) return rc;
  const unsigned grid = static_cast<unsigned>(a.works < blocks ? a.works : blocks);
  if (bulk)
    ell_bf16_kernel<W, true><<<grid, THREADS, SMEM_BYTES, stream>>>(a);
  else
    ell_bf16_kernel<W, false><<<grid, THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

inline Args args(const int* cols, const bf16* vals, const bf16* X, bf16* Y, int64_t D,
                 int64_t n, int64_t K, int64_t m, int64_t k) {
  Args a{};
  a.cols = cols;
  a.vals = vals;
  a.X = X;
  a.Y = Y;
  a.rows = D * n;
  a.n = n;
  a.m = m;
  a.k = k;
  a.K = K;
  return a;
}

// Y [D, n, k] = A X for bfloat16 operands; W (columns a lane) is the widest
// of 8, 4, 2 that divides k and keeps X's and Y's pieces aligned, else 1.
// (ell_spmv.cu, whose x is X of one column, calls launch_w<1> itself.)
inline int launch(const int* cols, const bf16* vals, const bf16* X, bf16* Y, int64_t D,
                  int64_t n, int64_t K, int64_t m, int64_t k, cudaStream_t stream) {
  const Args a = args(cols, vals, X, Y, D, n, K, m, k);
  const uintptr_t at = reinterpret_cast<uintptr_t>(X) | reinterpret_cast<uintptr_t>(Y);
  if (k % 8 == 0 && at % 16 == 0) return launch_w<8>(a, stream);
  if (k % 4 == 0 && at % 8 == 0) return launch_w<4>(a, stream);
  if (k % 2 == 0 && at % 4 == 0) return launch_w<2>(a, stream);
  return launch_w<1>(a, stream);
}

}  // namespace ell_bf16
}  // namespace
