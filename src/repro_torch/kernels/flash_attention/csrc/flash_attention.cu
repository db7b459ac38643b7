// flash_attention: o[b, h, i, :] = softmax_j(q[b, h, i, :] . k[b, h/G, j, :] / sqrt(D)) v[b, h/G, j, :]
// over the keys j visible to query i (causal and/or sliding window), G = Hq/Hkv.
//
// Replaces the Pallas kernel in repro/kernels/flash_attention/flash_attention.py,
// function flash_attention (_attn_kernel): causal GQA attention with an online
// softmax, an optional sliding window, and queries right-aligned at Skv
// (query i sits at position i + Skv - Sq).  q [B, Hq, Sq, D], k/v
// [B, Hkv, Skv, D], any (b, h, s) strides with the D dim contiguous, float32
// or bfloat16 in, float32 accumulation, output in the input type.
//
// Bound on an H100 SXM: with P = the number of visible (query, key) pairs,
// the function needs 4*B*Hq*D*P flops (2 for q.k, 2 for p.v per pair and
// dim) and has to read q, k, v once and write o once:
//   t >= max(4*B*Hq*D*P / peak, (|q| + |k| + |v| + |o|) * sizeof(T) / 3.35e12) s,
// peak = 67 TFLOP/s in float32 (no tensor cores) and 989 TFLOP/s in bfloat16
// (dense tensor cores, data sheet).  At the prefill shapes (S in the
// thousands, D = 128) the flops bound it by two orders of magnitude.
//
// Both instances: one block per (b, h_q, query tile: 64 rows in float32,
// 128 in bfloat16); a loop over 64-key tiles takes the place of the Pallas grid's sequential ("arbitrary") axis,
// and key tiles that the causal / window test makes invisible to the whole
// query tile are skipped, as pl.when(run) does, so the flops follow P.
// Running max, sum and the output accumulator stay in float32 registers.
// K/V are never repeated in memory: query head h reads KV head h / G.
// Ragged edges are masked in the kernel (rows past Sq are not stored, keys
// past Skv are zero and masked), so no padding copy exists.
//
// float32 (no tensor-core path keeps float32's accuracy without splitting
// the operands): plain FMAs, kept fed from shared memory.  256 threads; Q
// (once) and each K tile are staged transposed ([D][64]) and each V tile as
// is, so that a thread's 4x4 block of scores and 4 x D/16 block of outputs
// are built from 16-byte shared loads that are broadcasts or conflict-free
// (two loads per 16 or 32 FMAs).  The probabilities go through shared
// memory in an XOR swizzle that keeps their stores conflict-free; a row's
// max and sum meet through shuffles among the 16 threads that share it.
// 112 KB of shared memory at D = 128 lets two blocks share an SM.
//
// bfloat16: the FlashAttention-2 shape on the tensor cores.  128 query
// rows a block, 4 warps, each owning 32 of them (two m16 tiles); S = Q K^T
// and O += P V are mma.sync m16n8k16 (bf16 in, float32 accumulate) fed by
// ldmatrix, and every K and V fragment a warp reads serves both of its
// m-tiles (half the shared reads per flop, and half the L2 reads of K/V
// per query, of 16 rows a warp).  Q is read from shared memory at each
// k-step (a fifth of the fragment traffic), which leaves the registers to
// the 32 x D accumulator.  K and V tiles stay bf16 in shared memory, rows
// padded by 16 bytes so that ldmatrix has no bank conflicts and every
// fragment address is a lane's base plus a constant, and double-buffered
// by cp.async: tile j + 1 is in flight while tile j is in the tensor
// cores.  The softmax runs on the score accumulators in registers (a row's
// 64 keys lie in one quad of lanes, so its max and sum take two shuffles);
// the exps are ex2.approx with the scale into log2 units folded into their
// FFMA.  The probabilities are rounded to bf16 and used straight from those
// registers as the A operand of P V (the m16n8 accumulator layout is the
// m16k16 operand layout), so P never goes through shared memory; V comes
// in by ldmatrix.trans.  That rounding is where this instance's error
// enters.  102 KB of shared memory at D = 128, two blocks an SM.  At the
// prefill shape it reaches 18% of the 989 TFLOP/s bound on an H100
// (PERF.md).  What we take to hold it there is latency (neither more warps
// nor fewer shared reads made it faster): with two warps a scheduler, a
// warp's ldmatrix -> mma -> softmax chain is not covered, and the two
// accumulators take 192 of the D = 128 instance's 255 registers, so the
// next fragments cannot be loaded ahead.  wgmma, TMA and warp
// specialisation are later work.
//
// The float32 instance masks with -1e30, as the reference does: a tile in
// which every key is masked for a row then adds a bogus term that the next
// visible tile's alpha = exp(-1e30 - m) = 0 wipes out, where -inf would
// give NaN.  The bfloat16 instance gets the same results another way (see
// its softmax).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // 16 x 16: ty owns rows 4ty.., tx keys 4tx..
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

struct Strides {
  int64_t b, h, s;
};

// Position of the 4-row chunk `chunk` of key row k in the swizzled P tile.
__device__ __forceinline__ int p_index(int k, int chunk) {
  return k * BQ + ((chunk ^ ((k >> 2) & 15)) << 2);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int Hq,
                       int group, int Sq, int Skv, Strides qs, Strides ks,
                       Strides vs, Strides os, int causal, int64_t window,
                       float scale) {
  constexpr int J = D / 64;                  // output float4 groups per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // [D][BQ]
  float* Kt = Qt + D * BQ;                       // [D][BK]
  float* Vs = Kt + D * BK;                       // [BK][D]
  float* Pt = Vs + BK * D;                       // [BK][BQ], swizzled

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);   // longest first
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq, hk = h / group;
  const int q0 = qt * BQ;
  const int64_t q_offset = static_cast<int64_t>(Skv) - Sq;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;

  // Q tile, transposed; consecutive threads take consecutive rows, so the
  // shared stores are conflict-free.  Rows past Sq are zero.
  for (int idx = tid; idx < BQ * (D / 4); idx += THREADS) {
    const int r = idx % BQ, d4 = (idx / BQ) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq) x = load4(qb + (q0 + r) * qs.s + d4);
    Qt[(d4 + 0) * BQ + r] = x.x;
    Qt[(d4 + 1) * BQ + r] = x.y;
    Qt[(d4 + 2) * BQ + r] = x.z;
    Qt[(d4 + 3) * BQ + r] = x.w;
  }

  float m[4], l[4], acc[4][4 * J];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * J; ++c) acc[i][c] = 0.f;
  }

  // absolute positions of the tile's first query row
  const int64_t q_base = q0 + q_offset;
  const int n_kt = (Skv + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int64_t k_base = static_cast<int64_t>(kt) * BK;
    // skip key tiles invisible to every row of the query tile
    bool run = true;
    if (causal) run = k_base <= q_base + BQ - 1;
    if (window >= 0) run = run && (k_base + BK > q_base - window + 1);
    if (!run) continue;                            // uniform over the block

    __syncthreads();   // the previous tile's Kt/Vs/Pt are no longer read
    for (int idx = tid; idx < BK * (D / 4); idx += THREADS) {
      const int r = idx % BK, d4 = (idx / BK) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k_base + r < Skv) x = load4(kb + (k_base + r) * ks.s + d4);
      Kt[(d4 + 0) * BK + r] = x.x;
      Kt[(d4 + 1) * BK + r] = x.y;
      Kt[(d4 + 2) * BK + r] = x.z;
      Kt[(d4 + 3) * BK + r] = x.w;
    }
    for (int idx = tid; idx < BK * (D / 4); idx += THREADS) {
      const int r = idx / (D / 4), d4 = (idx % (D / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k_base + r < Skv) x = load4(vb + (k_base + r) * vs.s + d4);
      *reinterpret_cast<float4*>(Vs + r * D + d4) = x;
    }
    __syncthreads();

    // scores for rows 4ty+i, keys 4tx+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * BQ + 4 * ty);
      const float4 c = *reinterpret_cast<const float4*>(Kt + d * BK + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // mask, then the online-softmax update of each row
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qpos = q_base + 4 * ty + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t kpos = k_base + 4 * tx + j;
        bool ok = kpos < Skv;
        if (causal) ok = ok && qpos >= kpos;
        if (window >= 0) ok = ok && (qpos - kpos) < window;
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = expf(s[i][j] - m_new);
        sum += p[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * J; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Pt + p_index(4 * tx + j, ty)) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

    // acc[i][:] += sum_k P[4ty+i, k] V[k, cols]; cols 64jj + 4tx + c
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 pp = *reinterpret_cast<const float4*>(Pt + p_index(kk, ty));
      const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int jj = 0; jj < J; ++jj) {
        const float4 vv =
            *reinterpret_cast<const float4*>(Vs + kk * D + 64 * jj + 4 * tx);
        const float vw[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[i][4 * jj + c] = fmaf(pv[i], vw[c], acc[i][4 * jj + c]);
      }
    }
  }

  // o = acc / l, with l == 0 -> 1 (a row that saw no tile stays 0)
  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= Sq) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int jj = 0; jj < J; ++jj)
      store4(ob + r * os.s + 64 * jj + 4 * tx,
                     make_float4(acc[i][4 * jj] * inv, acc[i][4 * jj + 1] * inv,
                                 acc[i][4 * jj + 2] * inv,
                                 acc[i][4 * jj + 3] * inv));
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the FlashAttention-2 shape on the tensor cores
// ---------------------------------------------------------------------------
namespace tc {

constexpr int WARPS = 4;
constexpr int MT = 2;           // m16 tiles of query rows a warp owns
constexpr int BQ = 16 * MT * WARPS;   // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Row stride of a [rows][D] bf16 tile in shared memory: one 16-byte chunk
// of padding a row puts the 8 rows that one ldmatrix phase reads at one
// chunk in 8 different bank groups (D * 2 is a multiple of 128 bytes), and
// keeps every fragment's address a lane's base plus a constant.
template <int D>
constexpr int LD = D + 8;

// 16-byte global -> shared copy that bypasses the registers; !valid fills
// the 16 bytes with zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c[16x8] += a[16x16] b[16x8], bf16 in, float32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU op (2 ulp; -1e30 gives 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// Rows [r0, r0 + ROWS) of a [S][D] operand (row stride ss) into a swizzled
// tile by cp.async; rows past S are zero.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* g, int64_t r0,
                                          int64_t S, int64_t ss) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < S;
    cp_async16(tile + r * LD<D> + c * 8, ok ? g + (r0 + r) * ss + c * 8 : g, ok);
  }
}

// Positions are 32-bit: the launch takes Sq, Skv < 2^30, and a window of
// Skv or more hides nothing, so it comes in as -1 (none).
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o, int Hq,
                          int group, int Sq, int Skv, Strides qs, Strides ks,
                          Strides vs, Strides os, int causal, int window,
                          float scale_log2) {
  constexpr int KC = D / 16;   // k-steps of Q.K^T over the head dim
  constexpr int NT = BK / 8;   // score n-tiles of a key tile
  constexpr int DT = D / 8;    // output n-tiles
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LD]
  bf16* Ks = Qs + BQ * LD<D>;                      // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD<D>;                  // [2][BK][LD]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;    // fragment row / column pair
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);   // longest first
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq, hk = h / group;
  const int q0 = qt * BQ;
  const int q_base = q0 + Skv - Sq;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;

  // the key tiles visible to some row of the query tile: one run [lo, hi]
  const int n_kt = (Skv + BK - 1) / BK;
  int hi = n_kt - 1, lo = 0;
  if (causal && (q_base + BQ - 1) / BK < hi) hi = (q_base + BQ - 1) / BK;
  if (window >= 0 && q_base - window + 1 > 0) lo = (q_base - window + 1) / BK;

  // this warp's rows: m-tile mt, fragment rows g and g + 8 (index 2 mt + i)
  float m_i[2 * MT], l_i[2 * MT];
  float acc[MT][DT][4];
#pragma unroll
  for (int i = 0; i < 2 * MT; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < DT; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;

  if (lo <= hi) {
    load_tile<D, BQ>(Qs, qb, q0, Sq, qs.s);
    load_tile<D, BK>(Ks, kb, static_cast<int64_t>(lo) * BK, Skv, ks.s);
    load_tile<D, BK>(Vs, vb, static_cast<int64_t>(lo) * BK, Skv, vs.s);
    cp_async_commit();
  }
  const int row_w = warp * 16 * MT;                // the warp's first row
  for (int kt = lo; kt <= hi; ++kt) {
    const int buf = (kt - lo) & 1;
    // tile kt has landed, and every warp is done with tile kt - 1, whose
    // buffer the next copy fills
    cp_async_wait_all();
    __syncthreads();
    if (kt < hi) {
      const int64_t nb = static_cast<int64_t>(kt + 1) * BK;
      load_tile<D, BK>(Ks + (buf ^ 1) * BK * LD<D>, kb, nb, Skv, ks.s);
      load_tile<D, BK>(Vs + (buf ^ 1) * BK * LD<D>, vb, nb, Skv, vs.s);
      cp_async_commit();
    }
    // each lane's fragment rows: Q and K as ldmatrix takes them, V for .trans
    const bf16* Qf = Qs + (row_w + (lane & 15)) * LD<D> + (lane >> 4) * 8;
    const bf16* Kf = Ks + buf * BK * LD<D> +
                     ((lane & 7) + ((lane >> 4) << 3)) * LD<D> + ((lane >> 3) & 1) * 8;
    const bf16* Vf = Vs + buf * BK * LD<D> +
                     ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD<D> + (lane >> 4) * 8;

    // S = Q K^T: this warp's 16 MT rows x 64 keys; each K fragment serves
    // the MT m-tiles
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t qa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(qa[mt], Qf + 16 * mt * LD<D> + 16 * kc);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Kf + 16 * np * LD<D> + 16 * kc);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(s[mt][2 * np], qa[mt], kf[0], kf[1]);
          mma(s[mt][2 * np + 1], qa[mt], kf[2], kf[3]);
        }
      }
    }

    // mask, online softmax; the max is taken on the raw scores (the scale is
    // positive) and the scale into log2 units rides in the exp's FFMA; a
    // tile visible to every pair of the block skips the mask.  A masked
    // score is -inf while the running max starts at -1e30, so its term is
    // exactly 0 and no inf - inf arises; -1e30 masking would add bogus terms
    // that the next visible key's alpha = 0 wipes, so every row that sees a
    // key (every stored row: Sq <= Skv) gets the same result either way
    const int k_base = kt * BK;
    const bool full = k_base + BK <= Skv && (!causal || k_base + BK - 1 <= q_base) &&
                      (window < 0 || q_base + BQ - 1 - k_base < window);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[mt][j][e];
          if (!full) {
            const int qpos = q_base + row_w + 16 * mt + g + 8 * (e >> 1);
            const int kpos = k_base + 8 * j + 2 * t + (e & 1);
            bool ok = kpos < Skv;
            if (causal) ok = ok && qpos >= kpos;
            if (window >= 0) ok = ok && (qpos - kpos) < window;
            if (!ok) x = -INFINITY;
          }
          s[mt][j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {   // a row's 64 keys lie in one quad
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        mx[i] = fmaxf(m_i[2 * mt + i], mx[i] * scale_log2);   // log2 units
        alpha[i] = exp2_approx(m_i[2 * mt + i] - mx[i]);
        m_i[2 * mt + i] = mx[i];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][j][e] = exp2_approx(fmaf(s[mt][j][e], scale_log2, -mx[e >> 1]));
          rs[e >> 1] += s[mt][j][e];
        }
      }
      // l stays a per-thread partial sum; the quad adds it up at the end
#pragma unroll
      for (int i = 0; i < 2; ++i) l_i[2 * mt + i] = l_i[2 * mt + i] * alpha[i] + rs[i];
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        acc[mt][j][0] *= alpha[0];
        acc[mt][j][1] *= alpha[0];
        acc[mt][j][2] *= alpha[1];
        acc[mt][j][3] *= alpha[1];
      }
    }

    // O += P V: P, rounded to bf16, is the A operand straight from the
    // score registers; V comes in by ldmatrix.trans, each fragment serving
    // the MT m-tiles
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vf + 16 * kk * LD<D> + 16 * dp);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(acc[mt][2 * dp], pa[mt], vf[0], vf[1]);
          mma(acc[mt][2 * dp + 1], pa[mt], vf[2], vf[3]);
        }
      }
    }
  }

  // o = acc / l in float32, written as bf16 (l == 0 -> 1: a row that saw no
  // tile stays 0)
  bf16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_i[2 * mt + i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / (l == 0.f ? 1.f : l);
      const int r = q0 + row_w + 16 * mt + g + 8 * i;
      if (r >= Sq) continue;
#pragma unroll
      for (int j = 0; j < DT; ++j)
        *reinterpret_cast<uint32_t*>(ob + r * os.s + 8 * j + 2 * t) =
            pack_bf16(acc[mt][j][2 * i] * inv, acc[mt][j][2 * i + 1] * inv);
    }
  }
}

}  // namespace tc

struct Launch {
  const void *q, *k, *v;
  void* o;
  int64_t B, Hq, Hkv, Sq, Skv;
  Strides qs, ks, vs, os;
  int causal;
  int64_t window;
  cudaStream_t stream;
};

template <typename T, typename W, typename Kern>
int run(Kern kern, int threads, int bq, size_t smem, float scale, W window,
        const Launch& a) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((a.Sq + bq - 1) / bq),
                  static_cast<unsigned>(a.B * a.Hq));
  kern<<<grid, threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), static_cast<int>(a.Hq),
      static_cast<int>(a.Hq / a.Hkv), static_cast<int>(a.Sq),
      static_cast<int>(a.Skv), a.qs, a.ks, a.vs, a.os, a.causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const Launch& a, bool bf16) {
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  if (bf16)
    return run<tc::bf16>(tc::flash_attention_tc_kernel<D>, tc::THREADS, tc::BQ,
                         sizeof(tc::bf16) * (tc::BQ + 4 * tc::BK) * tc::LD<D>,
                         scale * tc::LOG2E,
                         a.window < 0 || a.window >= a.Skv ? -1 : static_cast<int>(a.window),
                         a);
  return run<float>(flash_attention_kernel<D>, THREADS, BQ,
                    sizeof(float) * (D * BQ + D * BK + BK * D + BK * BQ), scale,
                    a.window, a);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a head dim other than 64 or 128 or a grid the
// card cannot take.  The caller checks everything else (types, shapes,
// alignment, Sq <= Skv, Hq % Hkv == 0) before calling.  window < 0: none.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int64_t B,
    int64_t Hq, int64_t Hkv, int64_t Sq, int64_t Skv, int64_t D, int64_t qsb,
    int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh, int64_t kss,
    int64_t vsb, int64_t vsh, int64_t vss, int64_t osb, int64_t osh,
    int64_t oss, int causal, int64_t window, int bf16, void* stream) {
  if (B * Hq > 65535 || Sq > (int64_t{1} << 30) || Skv > (int64_t{1} << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch a{q, k, v, o, B, Hq, Hkv, Sq, Skv,
                 {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss}, {osb, osh, oss},
                 causal, window, static_cast<cudaStream_t>(stream)};
  if (D == 64) return launch<64>(a, bf16 != 0);
  if (D == 128) return launch<128>(a, bf16 != 0);
  return static_cast<int>(cudaErrorInvalidValue);
}
