// flash_attention: o[b, h, i, :] = softmax_j(q[b, h, i, :] . k[b, h/G, j, :] / sqrt(D)) v[b, h/G, j, :]
// over the keys j visible to query i (causal and/or sliding window), G = Hq/Hkv.
//
// Replaces the Pallas kernel in repro/kernels/flash_attention/flash_attention.py,
// function flash_attention (_attn_kernel): causal GQA attention with an online
// softmax, an optional sliding window, and queries right-aligned at Skv
// (query i sits at position i + Skv - Sq).  q [B, Hq, Sq, D], k/v
// [B, Hkv, Skv, D], any (b, h, s) strides with the D dim contiguous, float32
// in and out.  bfloat16 runs flash_attention_wgmma.cu, the Hopper design
// (wgmma fed by TMA), which replaced this file's mma.sync m16n8k16
// instances at every head dim, 1.7-2.5x faster on an H100 (PERF.md).
//
// Bound on an H100 SXM: with P = the number of visible (query, key) pairs,
// the function needs 4*B*Hq*D*P flops (2 for q.k, 2 for p.v per pair and
// dim) and has to read q, k, v once and write o once:
//   t >= max(flops * passes / peak, (|q| + |k| + |v| + |o|) * sizeof(T) / 3.35e12) s,
// three TF32 passes at the dense tensor cores' 495 TFLOP/s (below), i.e.
// 165 TFLOP/s of float32-accurate product, 2.5x the FMA units' 67 TFLOP/s
// (data sheet).
// At the prefill shapes (S in the thousands, D = 128) the flops bound it by
// two orders of magnitude.
//
// The kernel template (over T = float and D): one block per (b, h_q, query
// tile of 16 * MT * WARPS rows); each warp owns MT m16 tiles of rows; a loop over
// the one run of key tiles [lo, hi] visible to some row of the query tile
// takes the place of the Pallas grid's sequential ("arbitrary") axis, as
// pl.when(run) skips invisible blocks, so the flops follow P; the longest
// query tiles start first.  Q is copied into shared memory once; K and V
// tiles are double-buffered by cp.async (tile j + 1 is in flight while tile
// j is in the tensor cores), rows padded so that every fragment read is
// free of bank conflicts.  S = Q K^T and O += P V run on mma.sync; the
// softmax runs on the score accumulators in registers (a row's keys lie in
// one quad of lanes: its max and sum take two shuffles), with the exps as
// ex2.approx and the scale into log2 units folded into their FFMA, the
// running max, sum and output accumulator in float32 registers.  K/V are
// never repeated in memory: query head h reads KV head h / G.  Ragged edges
// are masked in the kernel (rows past Sq are not stored, keys past Skv are
// zero and masked), so no padding copy exists.  The products and the
// store (scores / accumulate_pv / store_row):
//
// float32: 3xTF32 on m16n8k8 (tf32 in, float32 accumulate).  Every operand
// element x is split at fragment load into hi = rna(x) and lo = rna(x -
// hi), rna the rounding of cvt.rna.tf32.f32 (to 10 mantissa bits, ties
// away from zero), which rebuild x to 2^-22; each fragment product is
// a_lo b_hi + a_hi b_lo + a_hi b_hi (a_lo b_lo, at most 2^-22 of a b, is
// dropped).  rna is written as an integer add and mask: the same result
// for every finite x in two instructions, where ptxas makes the cvt four
// (a NaN test and a select besides) and spilled at D = 128.  The softmax
// scale stays out of the split (it rides in the exp's FFMA), so hi/lo see
// raw q and k.  The tensor cores' float32 sums seem to round toward zero
// (their error on the card is the emulation's with that rounding), so no
// chain is long and the small products go first: each 16-dim chunk of S
// is six mma from zero, the four small products before the two large
// ones, chunks are added in pairs and the pairs to S by Fast2Sum with the
// rounding errors kept aside; each key tile's P V is 3 BK / 8 mma from
// zero a product tile, folded in by the FFMA o = o * alpha + (P V)_tile
// that also does the online softmax's rescale.  With keys far from zero
// (k + 50) the scores are hundreds while their differences between keys
// are units, and these roundings are most of the error: 1.4e-5 of the
// float64 truth, where plain float32 attention is at 5.7e-5 (PERF.md).
// mma.sync and not wgmma: the split then happens in registers at fragment
// load and costs no shared memory; TF32 wgmma wants both operands K-major
// in shared memory, so V would have to be stored transposed and hi/lo
// planes would double every tile (later work, with this design's numbers
// in hand).  Fragments come from shared memory as 16-byte loads, which the
// contraction's order makes possible: a sum may take its terms in any
// order, so
//  - in S, the 16 dims of a chunk that a lane reads as one float4 (dims
//    4t..4t+3, t = lane % 4) are its A columns t and t + 4 in two k-steps
//    (A col t <- dim 4t + 2h, col t + 4 <- dim 4t + 2h + 1 in k-step h), and
//    K's B fragment the same dims of key row g (= lane / 4);
//  - in P V, the probabilities are used straight from the score registers:
//    the m16n8 C layout is (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1) and
//    the m16k8 A layout (g, t), (g+8, t), (g, t+4), (g+8, t+4), so within
//    each 8-key step A col t is key 2t and col t + 4 key 2t + 1, a = {c0,
//    c2, c1, c3}, and the lane reads V rows 2t and 2t + 1 (no shuffle, no
//    shared memory); V's B fragment column g of output n-tile 4p + jj is
//    dim 32p + 4g + jj, so one float4 of a V row serves four n-tiles and
//    a row's output goes out as float4s (dims 32p + 8t + 4h + jj).
// ldmatrix does not help here (its .trans moves 16-bit halves).  Row
// strides of 16 mod 32 words (Q, K: D + 16) and 4 mod 32 (V: D + 4) make
// those float4 reads conflict-free, and keep cp.async's 16-byte
// destinations aligned.  Per tile a warp splits every K and V element it
// reads, which is most of its non-mma instructions; splitting into shared
// memory once a block instead would double the fragment reads and make
// shared memory the bound.  Tile shape (PERF.md has each one tried): 64
// query rows a block, 4 warps of 16 (MT = 1), 32-key tiles, 105 KB of
// shared memory at D = 128, two blocks an SM, and __launch_bounds__(128,
// 2), under which ptxas takes 255 registers without a spill and schedules
// the unrolled products deeply (on an H100 at the prefill shape, 1.75 ->
// 1.34 ms).
// Two warps a scheduler still leave it latency-bound, at about a quarter
// of the 3xTF32 bound: each TF32 pass costs about as much as the softmax,
// loads and barriers together.
//
// Head dims 64 and 128.  Head dims 96 (phi-3-vision-4.2b) and 256
// (recurrentgemma-9b) run flash_attention_tf32.cu, the Hopper design (3xTF32
// on wgmma fed by TMA), which replaced this file's instances there (PERF.md
// keeps their times: 2.0255 and 3.7144 ms at the served prefills on an
// H100).
//
// Masking: a masked score is -inf while the running max starts at -1e30,
// so its term is exactly 0 and no inf - inf arises; every row that sees a
// key (every stored row: Sq <= Skv) gets what masking with -1e30, as the
// reference does, gives.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  int64_t b, h, s;
};

// Tile shape of an instance: WARPS warps, each owning MT m16 tiles of query
// rows; BK keys a tile; the row strides (elements) of the Q, K and V tiles
// in shared memory; BLOCKS, the blocks an SM is to hold
// (__launch_bounds__).
template <typename T, int D>
struct Cfg;

// float32: see the note above for the strides and the shape.
template <int D>
struct Cfg<float, D> {
  static constexpr int WARPS = 4, MT = 1, BK = 32, BLOCKS = 2;
  static constexpr int LDQ = D + 16, LDK = D + 16, LDV = D + 4;
};

template <typename T, int D>
constexpr int BQ = 16 * Cfg<T, D>::MT * Cfg<T, D>::WARPS;   // query rows a block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// 2^x in one MUFU op (2 ulp; -1e30 and -inf give 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Rows [r0, r0 + ROWS) of a [S][D] operand (row stride ss) into a tile of
// row stride LD by cp.async, 16 bytes a copy; rows past S are zero.
template <typename T, int D, int ROWS, int LD, int THREADS>
__device__ __forceinline__ void load_tile(T* tile, const T* g, int64_t r0, int64_t S,
                                          int64_t ss) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));   // elements a copy
  constexpr int CH = D / E;
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < S;
    cp_async16(tile + r * LD + c * E, ok ? g + (r0 + r) * ss + c * E : g, ok);
  }
}

// ---------------------------------------------------------------------------
// float32 products: 3xTF32 on m16n8k8
// ---------------------------------------------------------------------------

__device__ __forceinline__ float4 lds128(const float* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(smem_u32(p)));
  return v;
}

// x rounded to a TF32 value (10 mantissa bits), to nearest with ties away
// from zero: what cvt.rna.tf32.f32 does for every finite x (half a TF32 ulp
// added to the magnitude bits, the 13 low bits cleared), in two integer
// instructions where ptxas makes that cvt four, with a NaN test
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to 2^-22 of |x|, each a TF32 value: hi = rna(x), lo =
// rna(x - hi) (x - hi is exact)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c[16x8] += a[16x8] b[8x8], tf32 in, float32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32, small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// s + x as s + e, e accumulated (Fast2Sum: the rounding error exactly
// where |s| >= |x|, closely otherwise; three adds)
__device__ __forceinline__ void fast_two_sum(float& s, float& e, float x) {
  const float t = s + x;
  e += x - (t - s);
  s = t;
}

// S = Q K^T over the warp's 16 MT rows (Qw: its first row) and the tile's
// keys, one 16-dim chunk at a time: the lane's float4 of row g (g + 8) at
// dims 4t.. is A col t / t + 4 of two k-steps, its float4 of key row g the
// matching B rows.  Each chunk's six mma start from zero, the four small
// products first and the two large ones last, so only those round at the
// chunk's full magnitude; chunks are added in pairs, and the pairs to s by
// Fast2Sum with the rounding errors kept aside, so s rounds about once.
// Where q.k is large against its differences between keys (keys far from
// zero) these roundings are most of the error.
template <int D, typename C, int MT, int NT>
__device__ __forceinline__ void scores(float (&s)[MT][NT][4], const float* Qw,
                                       const float* Kt, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* Qf = Qw + g * C::LDQ + 4 * t;
  const float* Kf = Kt + g * C::LDK + 4 * t;
  float err[MT][NT][4];    // the rounding errors of s
  float even[MT][NT][4];   // an even chunk's sum, waiting for the odd one
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][j][e] = err[mt][j][e] = 0.f;
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    uint32_t qh[MT][2][4], ql[MT][2][4];   // [m-tile][k-step][A register]
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float4 x0 = lds128(Qf + 16 * mt * C::LDQ + 16 * c);
      const float4 x1 = lds128(Qf + (16 * mt + 8) * C::LDQ + 16 * c);
      split(x0.x, qh[mt][0][0], ql[mt][0][0]);
      split(x1.x, qh[mt][0][1], ql[mt][0][1]);
      split(x0.y, qh[mt][0][2], ql[mt][0][2]);
      split(x1.y, qh[mt][0][3], ql[mt][0][3]);
      split(x0.z, qh[mt][1][0], ql[mt][1][0]);
      split(x1.z, qh[mt][1][1], ql[mt][1][1]);
      split(x0.w, qh[mt][1][2], ql[mt][1][2]);
      split(x1.w, qh[mt][1][3], ql[mt][1][3]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float4 y = lds128(Kf + 8 * j * C::LDK + 16 * c);
      uint32_t kh[4], kl[4];
      split(y.x, kh[0], kl[0]);
      split(y.y, kh[1], kl[1]);
      split(y.z, kh[2], kl[2]);
      split(y.w, kh[3], kl[3]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(part, ql[mt][0], kh[0], kh[1]);
        mma_tf32(part, qh[mt][0], kl[0], kl[1]);
        mma_tf32(part, ql[mt][1], kh[2], kh[3]);
        mma_tf32(part, qh[mt][1], kl[2], kl[3]);
        mma_tf32(part, qh[mt][0], kh[0], kh[1]);
        mma_tf32(part, qh[mt][1], kh[2], kh[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (c % 2 == 0)
            even[mt][j][e] = part[e];
          else
            fast_two_sum(s[mt][j][e], err[mt][j][e], even[mt][j][e] + part[e]);
        }
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][j][e] += err[mt][j][e];
}

// O = O * alpha + P V, the tile's P V summed from zero in the tensor cores
// one group of four output n-tiles at a time.  Within each 8-key step A
// col t is key 2t and col t + 4 key 2t + 1, so the A fragment is the score
// registers {c0, c2, c1, c3}; the lane reads V rows 2t and 2t + 1 as
// float4s at dims 32p + 4g.., one value for each n-tile 4p + jj.
template <int D, typename C, int MT, int NT>
__device__ __forceinline__ void accumulate_pv(float (&acc)[MT][D / 8][4],
                                              const float (&p)[MT][NT][4],
                                              const float (&alpha)[MT][2],
                                              const float* Vt, int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t ph[MT][NT][4], pl[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      split(p[mt][kk][0], ph[mt][kk][0], pl[mt][kk][0]);
      split(p[mt][kk][2], ph[mt][kk][1], pl[mt][kk][1]);
      split(p[mt][kk][1], ph[mt][kk][2], pl[mt][kk][2]);
      split(p[mt][kk][3], ph[mt][kk][3], pl[mt][kk][3]);
    }
  const float* Vf = Vt + 2 * t * C::LDV + 4 * g;
#pragma unroll
  for (int dp = 0; dp < D / 32; ++dp) {
    float part[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        part[mt][jj][0] = part[mt][jj][1] = part[mt][jj][2] = part[mt][jj][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const float4 v0 = lds128(Vf + 8 * kk * C::LDV + 32 * dp);
      const float4 v1 = lds128(Vf + (8 * kk + 1) * C::LDV + 32 * dp);
      const float b0[4] = {v0.x, v0.y, v0.z, v0.w};
      const float b1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t bh0, bl0, bh1, bl1;
        split(b0[jj], bh0, bl0);
        split(b1[jj], bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma3(part[mt][jj], ph[mt][kk], pl[mt][kk], bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mt][4 * dp + jj][e] =
              fmaf(acc[mt][4 * dp + jj][e], alpha[mt][e >> 1], part[mt][jj][e]);
  }
}

// Row g + 8 i of one m-tile's output (acc: its n-tiles), times inv: n-tile
// 4p + jj's column 2t + h is dim 32p + 8t + 4h + jj, so each (p, h) is one
// float4.
template <int D>
__device__ __forceinline__ void store_row(float* orow, const float (&acc)[D / 8][4], int i,
                                          float inv, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int dp = 0; dp < D / 32; ++dp)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(orow + 32 * dp + 8 * t + 4 * h) = make_float4(
          acc[4 * dp][2 * i + h] * inv, acc[4 * dp + 1][2 * i + h] * inv,
          acc[4 * dp + 2][2 * i + h] * inv, acc[4 * dp + 3][2 * i + h] * inv);
}

// ---------------------------------------------------------------------------
// the shared skeleton
// ---------------------------------------------------------------------------

// Mask and online softmax of one key tile's scores, in place: s[mt][j][e]
// is row 16 mt + g + 8 (e >> 1) of the warp's (first at position q_row),
// key k_base + 8 j + 2 t + (e & 1).  The max is taken on the raw scores (the
// scale is positive) and the scale into log2 units rides in the exp's
// FFMA; a tile visible to every pair of the block (full) skips the mask.
// Updates the running max m_i (log2 units) and l_i (a per-thread partial
// sum; the quad adds it up at the end) and returns each row's rescale of
// the output accumulator in alpha (accumulate_pv folds it into its FFMA).
template <typename C, int MT, int NT>
__device__ __forceinline__ void online_softmax(float (&s)[MT][NT][4], float (&m_i)[2 * MT],
                                               float (&l_i)[2 * MT], float (&alpha)[MT][2],
                                               bool full, int q_row, int k_base, int Skv,
                                               int causal, int window, float scale_log2, int g,
                                               int t) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[mt][j][e];
        if (!full) {
          const int qpos = q_row + 16 * mt + g + 8 * (e >> 1);
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
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {   // a row's keys lie in one quad
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      mx[i] = fmaxf(m_i[2 * mt + i], mx[i] * scale_log2);   // log2 units
      alpha[mt][i] = exp2_approx(m_i[2 * mt + i] - mx[i]);
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
#pragma unroll
    for (int i = 0; i < 2; ++i) l_i[2 * mt + i] = l_i[2 * mt + i] * alpha[mt][i] + rs[i];
  }
}

// Positions are 32-bit: the launch takes Sq, Skv < 2^30, and a window of
// Skv or more hides nothing, so it comes in as -1 (none).
template <typename T, int D>
__global__ void __launch_bounds__(32 * Cfg<T, D>::WARPS, Cfg<T, D>::BLOCKS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Hq, int group,
                       int Sq, int Skv, Strides qs, Strides ks, Strides vs, Strides os,
                       int causal, int window, float scale_log2) {
  using C = Cfg<T, D>;
  constexpr int MT = C::MT, BK = C::BK, NT = BK / 8, DT = D / 8;
  constexpr int ROWS = BQ<T, D>, THREADS = 32 * C::WARPS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [ROWS][LDQ]
  T* Ks = Qs + ROWS * C::LDQ;               // [2][BK][LDK]
  T* Vs = Ks + 2 * BK * C::LDK;             // [2][BK][LDV]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;    // fragment row / column
  const int n_qt = (Sq + ROWS - 1) / ROWS;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);   // longest first
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq, hk = h / group;
  const int q0 = qt * ROWS;
  const int q_base = q0 + Skv - Sq;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  // the key tiles visible to some row of the query tile: one run [lo, hi]
  const int n_kt = (Skv + BK - 1) / BK;
  int hi = n_kt - 1, lo = 0;
  if (causal && (q_base + ROWS - 1) / BK < hi) hi = (q_base + ROWS - 1) / BK;
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
    load_tile<T, D, ROWS, C::LDQ, THREADS>(Qs, qb, q0, Sq, qs.s);
    load_tile<T, D, BK, C::LDK, THREADS>(Ks, kb, static_cast<int64_t>(lo) * BK, Skv, ks.s);
    load_tile<T, D, BK, C::LDV, THREADS>(Vs, vb, static_cast<int64_t>(lo) * BK, Skv, vs.s);
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
      load_tile<T, D, BK, C::LDK, THREADS>(Ks + (buf ^ 1) * BK * C::LDK, kb, nb, Skv, ks.s);
      load_tile<T, D, BK, C::LDV, THREADS>(Vs + (buf ^ 1) * BK * C::LDV, vb, nb, Skv, vs.s);
      cp_async_commit();
    }
    float s[MT][NT][4];
    scores<D, C>(s, Qs + row_w * C::LDQ, Ks + buf * BK * C::LDK, lane);

    const int k_base = kt * BK;
    const bool full = k_base + BK <= Skv && (!causal || k_base + BK - 1 <= q_base) &&
                      (window < 0 || q_base + ROWS - 1 - k_base < window);
    float alpha[MT][2];
    online_softmax<C>(s, m_i, l_i, alpha, full, q_base + row_w, k_base, Skv, causal, window,
                      scale_log2, g, t);
    accumulate_pv<D, C>(acc, s, alpha, Vs + buf * BK * C::LDV, lane);
  }

  // o = acc / l in float32, written in T (l == 0 -> 1: a row that saw no
  // tile stays 0)
  T* ob = o + b * os.b + h * os.h;
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
      store_row<D>(ob + r * os.s, acc[mt], i, inv, lane);
    }
  }
}

struct Launch {
  const void *q, *k, *v;
  void* o;
  int64_t B, Hq, Hkv, Sq, Skv;
  Strides qs, ks, vs, os;
  int causal;
  int64_t window;
  cudaStream_t stream;
};

template <typename T, int D>
int launch(const Launch& a) {
  using C = Cfg<T, D>;
  const auto kern = flash_attention_kernel<T, D>;
  const int smem = static_cast<int>(sizeof(T)) *
                   (BQ<T, D> * C::LDQ + 2 * C::BK * (C::LDK + C::LDV));
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const int window = a.window < 0 || a.window >= a.Skv ? -1 : static_cast<int>(a.window);
  const dim3 grid(static_cast<unsigned>((a.Sq + BQ<T, D> - 1) / BQ<T, D>),
                  static_cast<unsigned>(a.B * a.Hq));
  kern<<<grid, 32 * C::WARPS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), static_cast<int>(a.Hq), static_cast<int>(a.Hq / a.Hkv),
      static_cast<int>(a.Sq), static_cast<int>(a.Skv), a.qs, a.ks, a.vs, a.os, a.causal,
      window, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for bfloat16 operands (flash_attention_wgmma.cu
// takes those), a head dim other than 64 or 128 (flash_attention_tf32.cu
// takes 96 and 256) or a grid the card cannot take.  The caller checks
// everything else (types, shapes, alignment, Sq <= Skv, Hq % Hkv == 0)
// before calling.  window < 0: none.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int64_t B,
    int64_t Hq, int64_t Hkv, int64_t Sq, int64_t Skv, int64_t D, int64_t qsb,
    int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh, int64_t kss,
    int64_t vsb, int64_t vsh, int64_t vss, int64_t osb, int64_t osh,
    int64_t oss, int causal, int64_t window, int is_bf16, void* stream) {
  if (is_bf16 || B * Hq > 65535 || Sq > (int64_t{1} << 30) || Skv > (int64_t{1} << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch a{q, k, v, o, B, Hq, Hkv, Sq, Skv,
                 {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss}, {osb, osh, oss},
                 causal, window, static_cast<cudaStream_t>(stream)};
  if (D == 64) return launch<float, 64>(a);
  if (D == 128) return launch<float, 128>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}
