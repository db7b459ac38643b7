// flash_attention (float32, Hopper design): o[b, h, i, :] = softmax_j(q[b, h, i, :] .
// k[b, h/G, j, :] / sqrt(D)) v[b, h/G, j, :] over the keys j visible to query i (causal
// and/or sliding window), G = Hq/Hkv.
//
// Replaces the Pallas kernel in repro/kernels/flash_attention/flash_attention.py:86,
// function flash_attention (_attn_kernel, pallas_call at l.107), for float32
// operands at head dims 96 (phi-3-vision-4.2b) and 256 (recurrentgemma-9b); the
// route table in flash_attention.py says which source serves a (dtype, head
// dim).  Same function as flash_attention.cu: causal GQA with an optional
// sliding window, queries right-aligned at Skv (query i sits at position i + Skv
// - Sq), q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] with any (b, h, s) strides and the
// D dim contiguous, float32 in and out; a masked score is -inf against a running
// max that starts at -1e30 (its term is exactly 0, no inf - inf arises), and an
// empty row gives l == 0 -> 1.
//
// Bound on an H100 SXM, as in flash_attention.cu: with P the visible (query,
// key) pairs, 4*B*Hq*D*P flops, three TF32 passes at the dense tensor cores'
// 495 TFLOP/s (165 TFLOP/s of float32-accurate product), or reading q, k, v
// and writing o once at 3.35 TB/s, whichever is longer; at the prefill shapes
// the flops.
//
// Arithmetic (kernels/flash_attention/tf32_order.py emulates it; the CPU tests
// hold the emulation to the Pallas kernel and to a float64 truth at 2e-5 a
// row): every operand element x is split into hi = rna(x) and lo = rna(x -
// hi), both TF32 values (13 low bits zero), so the tensor cores read them
// whole whatever they do with a float32 word's low bits; a b is a_lo b_hi +
// a_hi b_lo + a_hi b_hi.  The tensor cores' float32 sums seem to round toward
// zero (flash_attention.cu), so chains are short and the small products go
// first:
//  - S = Q K^T: the two consumer warpgroups split the head dim, each summing
//    its DH = D / 2 dims in CHAINS chains from zero (every Q_lo K_hi k-step,
//    then every Q_hi K_lo, then every Q_hi K_hi), the chains added by
//    Fast2Sum with the error kept aside; the halves meet through shared
//    memory in one float32 add (a + b = b + a: both consumers hold the same
//    scores, run the same softmax and keep the same running max and sum);
//  - each key tile's P V is a chain from zero over the tile's k-steps (P_lo
//    V_hi, P_hi V_lo, P_hi V_hi), folded in by o = o * alpha + (P V) in one
//    rounding: one chain over a whole row of keys would lose up to an ulp of
//    o a k-step, always toward zero (4.6e-5 of o at 2048 keys).
//
// Design (what wgmma needs that mma.sync did not: TF32 wgmma takes A and B
// only K-major, and B only from shared memory):
//  - tiles of BQ = 64 query rows of one (b, h_q), each with the run of key
//    tiles [lo, hi] visible to some row of it; a persistent grid of one block
//    an SM walks them longest first, in sections of heads whose K and V fit
//    the L2 together (the order of flash_attention_wgmma.cu);
//  - three warpgroups: warpgroup 0 the producer, one thread of which issues
//    every TMA copy (setmaxnreg gives the rest's registers away), and two
//    consumers, consumer c owning dims [c DH, (c + 1) DH) of the tile's 64
//    rows: its Q fragments, its chains of S, its part of O, and the split
//    of its dims of every K and V tile;
//  - Q, K and V come in by TMA through 4-D tensor maps over [B, H, S, D] with
//    the caller's strides (encoded on the host per call, __grid_constant__),
//    boxes of 32 dims (128 bytes) x rows with the 128-byte swizzle; rows past S
//    and dims past D read as zeros, so ragged edges need no masked copy;
//  - Q: each consumer reads its dims of the landed tile once as the m64nNk8
//    A fragments (a lane holds (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
//    of each 16-row, 8-dim block), keeps hi in registers and writes lo back
//    in place, where the Q_lo K_hi products read it as A from shared memory;
//  - K: a consumer splits its dims of a landed tile in place (hi over the
//    copy, lo in a plane beside it, 16-byte pieces); V: it transposes its
//    dims of a landed tile into V^T's hi and lo planes, stored [dims][keys]
//    in wgmma's K-major layout without swizzle (8 x 16-byte core matrices:
//    dim n, key position p at (n / 8) SBO + (p / 4) 128 + (n % 8) 16 + (p %
//    4) 4 bytes, SBO = BK * 32), each 8-key group in the order 0, 2, 4, 6, 1,
//    3, 5, 7; a warp's 32 loads of the swizzled landing and its 32 stores of
//    one (dim group, key pair) each hit 32 banks;
//  - P is wgmma's register A operand: within each 8-key step A column t is
//    key 2t and column t + 4 key 2t + 1 (V^T's order above), so the fragment
//    is the score registers {c0, c2, c1, c3} (flash_attention.cu);
//  - a key tile: S is issued, and while it runs the consumer splits this
//    tile's V and the next tile's K; it waits for S, exchanges the halves (a
//    double-buffered exchange behind named barrier 1, which also hands the
//    split planes over to the tensor cores), runs the softmax, then issues
//    each part of P V, waits for it and folds it in (tile i - 1's P V issued
//    behind tile i's S ran slower on an H100: ptxas serialized the products;
//    PERF.md);
//  - K stages and V landings are rings of mbarrier'd stages (the TMA's
//    "full", the consumers' "empty"), V^T one stage (written after the last
//    tile's P V has read it); the output is stored from registers, rows
//    past Sq never.
//
// Shared memory (bytes; KP = D * BK * 4, a K plane, a V landing or a V^T
// plane) and consumer registers (a thread: Q_hi DH / 2, O DH / 2, S chains
// CHAINS * BK / 2, P hi and lo BK, one P V part DH / 2 / PV_PARTS):
//   D = 96 (BK 32, 1 chain, O in 1 part):   Q 24,576 + K 2 x 2 x 12,288 + V
//     landings 2 x 12,288 + V^T 2 x 12,288 + exchange 32,768 = 155,648;
//     registers 24 + 24 + 16 + 32 + 24 = 120 of 240.
//   D = 256 (BK 16, 2 chains, O in 2 parts): Q 65,536 + K 2 x 2 x 16,384 + V
//     landings 2 x 16,384 + V^T 2 x 16,384 + exchange 16,384 = 212,992;
//     registers 64 + 64 + 16 + 16 + 32 = 192 of 240 (O and the whole P V
//     part together, 64 + 64, would not fit beside Q_hi: hence two parts).
// At D = 256 the Q_lo K_hi products read 2 KB of A for 512 bytes of B a
// k-step, the price of keeping Q_hi and O in registers.
#include <cuda.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 64;                      // query rows a tile (both consumers)
constexpr int THREADS = 384;                // producer + two consumer warpgroups
constexpr int CONSUMER_THREADS = 256;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;   // 24 * 128 + 240 * 256 <= 65,536
// sections of the tile order, as in flash_attention_wgmma.cu (bytes of K and
// V of the heads a section)
constexpr int64_t L2_FIT_BYTES = 40 << 20, L2_SECTION_BYTES = 8 << 20;

struct Strides {
  int64_t b, h, s;
};

// Tile shape of a head dim: BK keys a K/V tile, CHAINS chains of S a consumer,
// O in PV_PARTS parts, K_STAGES / VL_STAGES stages of the rings (the
// arithmetic in the note above).
template <int D>
struct Cfg;

template <>
struct Cfg<96> {
  static constexpr int BK = 32, CHAINS = 1, PV_PARTS = 1, K_STAGES = 2, VL_STAGES = 2;
};

template <>
struct Cfg<256> {
  static constexpr int BK = 16, CHAINS = 2, PV_PARTS = 2, K_STAGES = 2, VL_STAGES = 2;
};

template <int D>
struct Plan {
  using C = Cfg<D>;
  static constexpr int BK = C::BK, KS = C::K_STAGES, VLS = C::VL_STAGES;
  static constexpr int DH = D / 2;                    // dims a consumer
  static constexpr int CD = DH / C::CHAINS;           // dims a chain of S
  static constexpr int NP = DH / C::PV_PARTS;         // output dims a P V part
  static constexpr int QB = D * BQ * 4;               // Q: D / 32 chunks of [BQ][128 B]
  static constexpr int KP = D * BK * 4;               // a K plane, a V landing, a V^T plane
  static constexpr int XB = 2 * 2 * BQ * BK * 4;      // the exchange: 2 parities x 2 consumers
  static constexpr int NBARS = 2 + 2 * KS + 2 * VLS;
  static constexpr int SMEM = 1024 /* alignment slack */ + QB + 2 * KS * KP + VLS * KP +
                              2 * KP + XB + 8 * NBARS;
  static_assert(D % 32 == 0 && DH % 8 == 0 && CD % 8 == 0 && NP % 8 == 0 && BK % 8 == 0,
                "whole k-steps, 32-dim boxes and 8-row groups");
  static_assert(QB % 1024 == 0 && KP % 1024 == 0, "swizzled regions stay 1024-byte aligned");
};
static_assert(Plan<96>::SMEM <= 232448 && Plan<256>::SMEM <= 232448, "shared memory");
static_assert(128 * PRODUCER_REGS + CONSUMER_THREADS * CONSUMER_REGS <= 65536, "registers");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers, TMA, named barriers, proxy fence
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// arrive (one of the count) and add `bytes` to the transactions the phase awaits
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// box {32 dims, rows} at (dim c0, row c1, head c2, batch c3) of a 4-D map
// into shared memory at dst; completion is reported to bar
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// this thread's writes to shared memory made visible to the async proxy
// (wgmma's operand reads), before the barrier that hands them over
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float lds(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ void sts(uint32_t a, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}

__device__ __forceinline__ float4 lds128(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts128f(uint32_t a, const float (&v)[4]) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "f"(v[0]), "f"(v[1]),
               "f"(v[2]), "f"(v[3])
               : "memory");
}

// ---------------------------------------------------------------------------
// the TF32 split
// ---------------------------------------------------------------------------

// x rounded to a TF32 value (10 mantissa bits), to nearest with ties away
// from zero: what cvt.rna.tf32.f32 does for every finite x, in two integer
// instructions (flash_attention.cu)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to 2^-22 of |x|, each a TF32 value
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// ---------------------------------------------------------------------------
// wgmma (TF32: k-steps of 8, both operands K-major)
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), layout mode (1: the 128-byte swizzle; 0: none).
// K-major, 128-byte swizzle (Q, K as TMA lands them: a row's 32 dims in one
// 128-byte line, 8-row atoms 1024 bytes apart: SBO 1024, LBO unused); K-major
// without swizzle (V^T: 8-row x 16-byte core matrices, the one beside in K
// LBO = 128 bytes on, the next 8 rows SBO on).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (static_cast<uint64_t>(mode) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of registers across an
// asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d[64 x N] (+)= a[64 x 8] b[8 x N], tf32 in, float32 accumulate; scale_d = 0
// overwrites d.  SS: a and b from shared memory (descriptors); RS: a from
// registers (a[0] = row g, column t; a[1] row g + 8; a[2] row g, column t + 4;
// a[3] row g + 8), b from shared memory.  Accumulator layout: d[4 j + e] of
// lane (g = lane / 4, t = lane % 4) of warp w is row 16 w + g + 8 (e >> 1),
// column 8 j + 2 t + (e & 1).
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n48(float (&d)[24], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  static_assert(N == 16 || N == 32, "no SS m64nNk8 instance for this key tile");
  if constexpr (N == 16) wgmma_ss_n16(d, da, db, scale_d);
  else wgmma_ss_n32(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  static_assert(N == 16 || N == 32 || N == 48 || N == 64, "no RS m64nNk8 instance for this width");
  if constexpr (N == 16) wgmma_rs_n16(d, a, db, scale_d);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db, scale_d);
  else if constexpr (N == 48) wgmma_rs_n48(d, a, db, scale_d);
  else wgmma_rs_n64(d, a, db, scale_d);
}

// 2^x in one MUFU op (2 ulp; -1e30 and -inf give 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// shared-memory addresses
// ---------------------------------------------------------------------------

// element (row r, dim d) of a TMA-landed [D / 32 chunks][rows][32] tile with
// the 128-byte swizzle (the 16-byte piece index xor the row's index in its
// 8-row atom; every chunk starts 1024-byte aligned)
__device__ __forceinline__ uint32_t swz(uint32_t base, int rows, int r, int d) {
  return base + (d >> 5) * rows * 128 + r * 128 + ((((d & 31) >> 2) ^ (r & 7)) << 4) + (d & 3) * 4;
}

// element (dim n, key position p) of a V^T plane (K-major core matrices, no
// swizzle; see the note at the top)
template <int BK>
__device__ __forceinline__ uint32_t vt_addr(uint32_t plane, int n, int p) {
  return plane + (n >> 3) * (BK * 32) + (p >> 2) * 128 + (n & 7) * 16 + (p & 3) * 4;
}

// ---------------------------------------------------------------------------
// the consumers' steps
// ---------------------------------------------------------------------------

// Mask and online softmax of one key tile's scores in place (s[4 j + e]: row
// q_row + 8 (e >> 1), key k_base + 8 j + 2 t + (e & 1)), as in
// flash_attention_wgmma.cu: the max on the raw scores, the scale into log2
// units in the exp's FFMA, m_i / l_i the running max (log2 units) and this
// thread's partial sum of rows g and g + 8; returns each row's rescale of the
// output in alpha.
template <int BK>
__device__ __forceinline__ void online_softmax(float (&s)[BK / 2], float (&m_i)[2],
                                               float (&l_i)[2], float (&alpha)[2], bool full,
                                               int q_row, int k_base, int Skv, int causal,
                                               int window, float scale_log2, int t) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e];
      if (!full) {
        const int qpos = q_row + 8 * (e >> 1);
        const int kpos = k_base + 8 * j + 2 * t + (e & 1);
        bool ok = kpos < Skv;
        if (causal) ok = ok && qpos >= kpos;
        if (window >= 0) ok = ok && (qpos - kpos) < window;
        if (!ok) x = -INFINITY;
      }
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {   // a row's keys lie in one quad
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    mx[i] = fmaxf(m_i[i], mx[i] * scale_log2);   // log2 units
    alpha[i] = exp2_approx(m_i[i] - mx[i]);
    m_i[i] = mx[i];
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = exp2_approx(fmaf(s[4 * j + e], scale_log2, -mx[e >> 1]));
      rs[e >> 1] += s[4 * j + e];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l_i[i] = l_i[i] * alpha[i] + rs[i];
}

// S over this consumer's dims: CHAINS chains of CD dims, each from zero,
// small products first (Q_lo K_hi from shared memory, Q_hi K_lo, Q_hi K_hi
// with Q_hi from registers); issued, not waited for.  qh[kk]: the A fragment
// of this consumer's k-step kk; q_lo: the Q tile (Q_lo in place); k_hi, k_lo:
// the stage's planes.
template <int D>
__device__ __forceinline__ void issue_scores(float (&sc)[Cfg<D>::CHAINS][Cfg<D>::BK / 2],
                                             const uint32_t (&qh)[D / 16][4], uint32_t q_lo,
                                             uint32_t k_hi, uint32_t k_lo, int cw) {
  using P = Plan<D>;
  constexpr int BK = P::BK, STEPS = P::CD / 8;
#pragma unroll
  for (int ch = 0; ch < Cfg<D>::CHAINS; ++ch) {
#pragma unroll
    for (int kk = 0; kk < STEPS; ++kk) {     // Q_lo K_hi
      const int d0 = cw * P::DH + ch * P::CD + 8 * kk;
      const uint32_t off_q = (d0 >> 5) * BQ * 128 + (d0 & 31) * 4;
      const uint32_t off_k = (d0 >> 5) * BK * 128 + (d0 & 31) * 4;
      wgmma_ss<BK>(sc[ch], smem_desc(q_lo + off_q, 16, 1024, 1),
                   smem_desc(k_hi + off_k, 16, 1024, 1), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < STEPS; ++kk) {     // Q_hi K_lo
      const int d0 = cw * P::DH + ch * P::CD + 8 * kk;
      const uint32_t off_k = (d0 >> 5) * BK * 128 + (d0 & 31) * 4;
      wgmma_rs<BK>(sc[ch], qh[ch * STEPS + kk], smem_desc(k_lo + off_k, 16, 1024, 1), 1);
    }
#pragma unroll
    for (int kk = 0; kk < STEPS; ++kk) {     // Q_hi K_hi
      const int d0 = cw * P::DH + ch * P::CD + 8 * kk;
      const uint32_t off_k = (d0 >> 5) * BK * 128 + (d0 & 31) * 4;
      wgmma_rs<BK>(sc[ch], qh[ch * STEPS + kk], smem_desc(k_hi + off_k, 16, 1024, 1), 1);
    }
  }
}

// One part of P V (output dims n0 .. n0 + NP - 1) from zero: P_lo V_hi, P_hi
// V_lo, P_hi V_hi over the tile's k-steps; issued, not waited for.  ph / pl:
// P's A fragments (k-step kk: score n-tile kk, {c0, c2, c1, c3}); v_hi / v_lo:
// the V^T stage's planes.
template <int D>
__device__ __forceinline__ void issue_pv(float (&pv)[Plan<D>::NP / 2],
                                         const uint32_t (&ph)[Cfg<D>::BK / 8][4],
                                         const uint32_t (&pl)[Cfg<D>::BK / 8][4], uint32_t v_hi,
                                         uint32_t v_lo, int n0) {
  using P = Plan<D>;
  constexpr int BK = P::BK;
  const uint32_t off = (n0 >> 3) * (BK * 32);
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk)
    wgmma_rs<P::NP>(pv, pl[kk], smem_desc(v_hi + off + kk * 256, 128, BK * 32, 0), kk > 0);
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk)
    wgmma_rs<P::NP>(pv, ph[kk], smem_desc(v_lo + off + kk * 256, 128, BK * 32, 0), 1);
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk)
    wgmma_rs<P::NP>(pv, ph[kk], smem_desc(v_hi + off + kk * 256, 128, BK * 32, 0), 1);
}

// o += the first part of a tile's P V (pv, output dims cw DH .. cw DH + NP -
// 1), rescaled: o = o * alpha + pv in one rounding; then the other parts, each
// from zero and waited for (the registers hold one part in flight at D 256).
template <int D>
__device__ __forceinline__ void fold_pv(float (&acc)[Cfg<D>::PV_PARTS][Plan<D>::NP / 2],
                                        float (&pv)[Plan<D>::NP / 2],
                                        const uint32_t (&ph)[Cfg<D>::BK / 8][4],
                                        const uint32_t (&pl)[Cfg<D>::BK / 8][4],
                                        const float (&alpha)[2], uint32_t v_hi, int cw) {
  using P = Plan<D>;
#pragma unroll
  for (int pp = 0; pp < Cfg<D>::PV_PARTS; ++pp) {
    if (pp > 0) {
      wgmma_fence();
      issue_pv<D>(pv, ph, pl, v_hi, v_hi + P::KP, cw * P::DH + pp * P::NP);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(pv);
    }
#pragma unroll
    for (int i = 0; i < P::NP / 2; ++i) acc[pp][i] = fmaf(acc[pp][i], alpha[(i & 3) >> 1], pv[i]);
  }
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// Shared memory (1024-byte aligned): Q [D / 32][BQ][32]; K stages [K_STAGES]
// [hi, lo][D / 32][BK][32]; V landings [VL_STAGES][D / 32][BK][32]; V^T [hi,
// lo] (core matrices); the exchange [2 parities][2 consumers][BK / 8][128
// threads][4]; the mbarriers: q_full, q_empty, k_full[K_STAGES],
// k_empty[K_STAGES], vl_full[VL_STAGES], vl_empty[VL_STAGES].
// The grid is persistent, the tiles dealt out in rounds as in
// flash_attention_wgmma.cu (sections of sec_heads heads, longest first,
// `snake` where every head is in one section); every role walks the same
// tiles, and the rings' stages and phases run on across a block's tiles.
// Positions are 32-bit: the launch takes Sq, Skv < 2^30, and a window of Skv
// or more hides nothing, so it comes in as -1 (none).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_tf32_kernel(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
                  const __grid_constant__ CUtensorMap tmv, float* __restrict__ o, int n_bh,
                  int sec_heads, int snake, int Hq, int group, int Sq, int Skv, Strides os,
                  int causal, int window, float scale_log2) {
  using P = Plan<D>;
  constexpr int BK = P::BK, KS = P::KS, VLS = P::VLS, KP = P::KP, NC = D / 32, DH = P::DH;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t qs = (raw + 1023) & ~1023u;     // Q
  const uint32_t ks = qs + P::QB;                // K stages: hi, lo planes
  const uint32_t vl = ks + 2 * KS * KP;          // V landings
  const uint32_t vt = vl + VLS * KP;             // V^T: hi, lo planes
  const uint32_t xs = vt + 2 * KP;               // the score exchange
  const uint32_t bars = xs + P::XB;
  // shared address -> pointer, for the plain loads and stores of the splits
  // (the compiler batches them; the barriers' memory clobbers order them)
  unsigned char* const base = smem_raw + (qs - raw);
  auto at = [&](uint32_t a) { return base + (a - qs); };
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto k_full = [&](int st) { return bars + 8 * (2 + st); };
  auto k_empty = [&](int st) { return bars + 8 * (2 + KS + st); };
  auto vl_full = [&](int st) { return bars + 8 * (2 + 2 * KS + st); };
  auto vl_empty = [&](int st) { return bars + 8 * (2 + 2 * KS + VLS + st); };

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int n_tiles = n_qt * n_bh;
  // this block's tile in round r, or -1 past the last
  auto tile_of = [&](int r) {
    const int base_r = r * static_cast<int>(gridDim.x);
    const int x = snake && (r & 1) ? static_cast<int>(gridDim.x - 1 - blockIdx.x)
                                   : static_cast<int>(blockIdx.x);
    return base_r + x < n_tiles ? base_r + x : -1;
  };
  const int n_kt = (Skv + BK - 1) / BK;
  struct Tile {
    int b, h, q0, q_base, lo, hi;
  };
  auto tile_at = [&](int tile) {
    Tile x;
    const int sec = tile / (sec_heads * n_qt), i = tile - sec * sec_heads * n_qt;
    const int rest = n_bh - sec * sec_heads;
    const int hs = rest < sec_heads ? rest : sec_heads;      // the section's heads
    const int qt = n_qt - 1 - i / hs, bh = sec * sec_heads + i % hs;
    x.b = bh / Hq;
    x.h = bh % Hq;
    x.q0 = qt * BQ;
    x.q_base = x.q0 + Skv - Sq;
    x.hi = n_kt - 1;
    x.lo = 0;
    if (causal && (x.q_base + BQ - 1) / BK < x.hi) x.hi = (x.q_base + BQ - 1) / BK;
    if (window >= 0 && x.q_base - window + 1 > 0) x.lo = (x.q_base - window + 1) / BK;
    return x;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMER_THREADS);
    for (int st = 0; st < KS; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(k_empty(st), CONSUMER_THREADS);
    }
    for (int st = 0; st < VLS; ++st) {
      mbar_init(vl_full(st), 1);
      mbar_init(vl_empty(st), CONSUMER_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread issues every copy, the rest leave
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      prefetch_map(&tmq);
      prefetch_map(&tmk);
      prefetch_map(&tmv);
      int it = 0, qi = 0;      // K/V tiles and Q tiles copied so far
      for (int r = 0, tile; (tile = tile_of(r)) >= 0; ++r) {
        const Tile x = tile_at(tile);
        if (x.lo > x.hi) continue;
        const int hk = x.h / group;
        mbar_wait(q_empty, (qi++ & 1) ^ 1);       // the first round passes
        mbar_expect_tx(q_full, P::QB);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load_4d(qs + c * BQ * 128, &tmq, q_full, 32 * c, x.q0, x.h, x.b);
        for (int kt = x.lo; kt <= x.hi; ++kt, ++it) {
          const int st = it % KS, sl = it % VLS;
          mbar_wait(k_empty(st), (static_cast<uint32_t>(it / KS) & 1) ^ 1);
          mbar_expect_tx(k_full(st), KP);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            tma_load_4d(ks + st * 2 * KP + c * BK * 128, &tmk, k_full(st), 32 * c, kt * BK, hk,
                        x.b);
          mbar_wait(vl_empty(sl), (static_cast<uint32_t>(it / VLS) & 1) ^ 1);
          mbar_expect_tx(vl_full(sl), KP);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            tma_load_4d(vl + sl * KP + c * BK * 128, &tmv, vl_full(sl), 32 * c, kt * BK, hk,
                        x.b);
        }
      }
    }
  } else {
    // consumers: warpgroup cw owns dims cw DH .. cw DH + DH - 1 of a tile's 64
    // rows, and splits those dims of every K and V tile itself
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int row_w = 16 * warp + g;               // this thread's first row in a tile

    // this consumer's dims of K stage st in place: hi over the copy, lo in
    // the plane beside it; 16-byte pieces, loaded first and then split
    auto split_k = [&](int st) {
      constexpr int PIECES = BK * DH / 4 / 128;    // a thread's
      const uint32_t kh = ks + st * 2 * KP;
      float4 a[PIECES];
      uint32_t addr[PIECES];
#pragma unroll
      for (int i = 0; i < PIECES; ++i) {
        const int pc = tid + 128 * i, rr = pc / (DH / 4), j = pc % (DH / 4);
        addr[i] = swz(kh, BK, rr, cw * DH + 4 * j);
        a[i] = *reinterpret_cast<const float4*>(at(addr[i]));
      }
#pragma unroll
      for (int i = 0; i < PIECES; ++i) {
        uint4 h, l;
        split(a[i].x, h.x, l.x);
        split(a[i].y, h.y, l.y);
        split(a[i].z, h.z, l.z);
        split(a[i].w, h.w, l.w);
        *reinterpret_cast<uint4*>(at(addr[i])) = h;
        *reinterpret_cast<uint4*>(at(addr[i] + KP)) = l;
      }
    };
    // this consumer's dims of V landing sl into V^T's planes: a warp step is
    // dim group nb, keys 8 kb + 2 pq + kp at positions 8 kb + 4 kp + pq (the
    // order 0, 2, 4, 6, 1, 3, 5, 7), dims 8 nb + nq; 32 banks on both sides
    auto split_v = [&](int sl) {
      constexpr int STEPS = (DH / 8) * (BK / 8) * 2 / 4;   // a warp's
      const int nq = lane >> 2, pq = lane & 3;
      const uint32_t src = vl + sl * KP;
      float v[STEPS];
      uint32_t dst[STEPS];
#pragma unroll
      for (int i = 0; i < STEPS; ++i) {
        const int gi = warp + 4 * i;
        const int nb = cw * (DH / 8) + gi / (BK / 4), kb = (gi % (BK / 4)) >> 1, kp = gi & 1;
        const int n = 8 * nb + nq, key = 8 * kb + 2 * pq + kp, p = 8 * kb + 4 * kp + pq;
        v[i] = *reinterpret_cast<const float*>(at(swz(src, BK, key, n)));
        dst[i] = vt_addr<BK>(vt, n, p);
      }
#pragma unroll
      for (int i = 0; i < STEPS; ++i) {
        uint32_t hi, lo;
        split(v[i], hi, lo);
        *reinterpret_cast<uint32_t*>(at(dst[i])) = hi;
        *reinterpret_cast<uint32_t*>(at(dst[i] + KP)) = lo;
      }
    };

    int it = 0, qi = 0, xp = 0;    // K/V tiles, Q tiles, exchange parity
    for (int r = 0, tile; (tile = tile_of(r)) >= 0; ++r) {
      const Tile x = tile_at(tile);
      const int q_first = x.q_base, q_last = x.q_base + BQ - 1;
      // a tile visible to every pair of the tile's rows skips the mask
      auto full = [&](int k_base) {
        return k_base + BK <= Skv && (!causal || k_base + BK - 1 <= q_first) &&
               (window < 0 || q_last - k_base < window);
      };
      float acc[Cfg<D>::PV_PARTS][P::NP / 2];
#pragma unroll
      for (int pp = 0; pp < Cfg<D>::PV_PARTS; ++pp)
#pragma unroll
        for (int i = 0; i < P::NP / 2; ++i) acc[pp][i] = 0.f;
      float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f};

      if (x.lo <= x.hi) {
        mbar_wait(q_full, qi++ & 1);
        // this consumer's A fragments of Q: hi kept, lo written back in place
        uint32_t qh[D / 16][4];
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t a =
                swz(qs, BQ, row_w + 8 * (e & 1), cw * DH + 8 * kk + t + 4 * (e >> 1));
            uint32_t lo;
            split(lds(a), qh[kk][e], lo);
            sts(a, lo);
          }
        // and the tile's first K
        mbar_wait(k_full(it % KS), static_cast<uint32_t>(it / KS) & 1);
        split_k(it % KS);
        fence_proxy_async();
        named_sync(2 + cw, 128);

        for (int kt = x.lo; kt <= x.hi; ++kt, ++it) {
          const int st = it % KS, sl = it % VLS;
          const uint32_t kh = ks + st * 2 * KP;
          float sc[Cfg<D>::CHAINS][BK / 2];
          wgmma_fence();
          issue_scores<D>(sc, qh, qs, kh, kh + KP, cw);
          wgmma_commit();
          // while S is in the tensor cores: V^T of this tile, the next K
          mbar_wait(vl_full(sl), static_cast<uint32_t>(it / VLS) & 1);
          split_v(sl);
          mbar_arrive(vl_empty(sl));
          if (kt < x.hi) {
            mbar_wait(k_full((it + 1) % KS), static_cast<uint32_t>((it + 1) / KS) & 1);
            split_k((it + 1) % KS);
          }
          fence_proxy_async();     // made visible by the exchange's barrier
          wgmma_wait_all();
#pragma unroll
          for (int ch = 0; ch < Cfg<D>::CHAINS; ++ch) fence_regs(sc[ch]);
          mbar_arrive(k_empty(st));

          // the chains by Fast2Sum, the rounding errors kept aside
          float s[BK / 2];
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) {
            float hs = sc[0][i], he = 0.f;
#pragma unroll
            for (int ch = 1; ch < Cfg<D>::CHAINS; ++ch) {
              const float tt = hs + sc[ch][i];
              he += sc[ch][i] - (tt - hs);
              hs = tt;
            }
            s[i] = hs + he;
          }
          // the other consumer's half through shared memory; the barrier
          // also hands this warpgroup's V^T and K writes over to its wgmma
          {
            const uint32_t mine = xs + ((xp * 2 + cw) * (BK / 8) * 128 + tid) * 16;
            const uint32_t theirs = xs + ((xp * 2 + (1 - cw)) * (BK / 8) * 128 + tid) * 16;
#pragma unroll
            for (int j = 0; j < BK / 8; ++j) {
              const float v4[4] = {s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]};
              sts128f(mine + j * 128 * 16, v4);
            }
            named_sync(1, CONSUMER_THREADS);
#pragma unroll
            for (int j = 0; j < BK / 8; ++j) {
              const float4 y = lds128(theirs + j * 128 * 16);
              s[4 * j] += y.x;
              s[4 * j + 1] += y.y;
              s[4 * j + 2] += y.z;
              s[4 * j + 3] += y.w;
            }
            xp ^= 1;
          }
          float alpha[2];
          online_softmax<BK>(s, m_i, l_i, alpha, full(kt * BK), x.q_base + row_w, kt * BK, Skv,
                             causal, window, scale_log2, t);
          // P's A fragments: k-step kk is score n-tile kk, {c0, c2, c1, c3}
          uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
          for (int kk = 0; kk < BK / 8; ++kk) {
            split(s[4 * kk + 0], ph[kk][0], pl[kk][0]);
            split(s[4 * kk + 2], ph[kk][1], pl[kk][1]);
            split(s[4 * kk + 1], ph[kk][2], pl[kk][2]);
            split(s[4 * kk + 3], ph[kk][3], pl[kk][3]);
          }
#pragma unroll
          for (int pp = 0; pp < Cfg<D>::PV_PARTS; ++pp) {
            float pv[P::NP / 2];
            wgmma_fence();
            issue_pv<D>(pv, ph, pl, vt, vt + KP, cw * DH + pp * P::NP);
            wgmma_commit();
            wgmma_wait_all();
            fence_regs(pv);
#pragma unroll
            for (int i = 0; i < P::NP / 2; ++i)
              acc[pp][i] = fmaf(acc[pp][i], alpha[(i & 3) >> 1], pv[i]);
          }
        }
        // every score of the tile is in: Q may be refilled
        mbar_arrive(q_empty);
      }

      // o = acc / l (l == 0 -> 1: a row that saw no tile stays 0); rows past
      // Sq are not stored; column 8 j + 2 t (+1) of part pp is dim cw DH +
      // pp NP + 8 j + 2 t
      float* ob = o + x.b * os.b + x.h * os.h;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float l = l_i[i];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = 1.f / (l == 0.f ? 1.f : l);
        const int rr = x.q0 + row_w + 8 * i;
        if (rr >= Sq) continue;
        float* orow = ob + static_cast<int64_t>(rr) * os.s + cw * DH;
#pragma unroll
        for (int pp = 0; pp < Cfg<D>::PV_PARTS; ++pp)
#pragma unroll
          for (int j = 0; j < P::NP / 8; ++j)
            *reinterpret_cast<float2*>(orow + pp * P::NP + 8 * j + 2 * t) =
                make_float2(acc[pp][4 * j + 2 * i] * inv, acc[pp][4 * j + 2 * i + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side (as flash_attention_wgmma.cu's, for float32 maps and the tile
// shape above)
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point so
// that the library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &status) != cudaSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status) !=
        cudaSuccess)
      p = nullptr;
#endif
    return status == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A 4-D map over [B, H, S, D] float32 (dims innermost first: D, S, H, B) with
// the caller's element strides, boxes of 32 dims x `rows` rows, 128-byte
// swizzle, out-of-range elements read as zeros.  A dimension of size 1 is
// never stepped, so its stride is replaced by a legal one (TMA wants
// multiples of 16 bytes, and a broadcast stride may be 0).  0 on success.
int encode_map(CUtensorMap* map, const void* ptr, int64_t B, int64_t H, int64_t S, int64_t D,
               const Strides& st, int rows) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  auto bytes = [&](int64_t n, int64_t s) {
    return static_cast<cuuint64_t>(n == 1 ? 4 * D : 4 * s);
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {bytes(S, st.s), bytes(H, st.h), bytes(B, st.b)};
  const cuuint32_t box[4] = {32, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(r);
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

template <int D>
int launch(const Launch& a) {
  const auto kern = flash_tf32_kernel<D>;
  CUtensorMap tmq, tmk, tmv;
  int rc = encode_map(&tmq, a.q, a.B, a.Hq, a.Sq, D, a.qs, BQ);
  if (rc == 0) rc = encode_map(&tmk, a.k, a.B, a.Hkv, a.Skv, D, a.ks, Cfg<D>::BK);
  if (rc == 0) rc = encode_map(&tmv, a.v, a.B, a.Hkv, a.Skv, D, a.vs, Cfg<D>::BK);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Plan<D>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  const int window = a.window < 0 || a.window >= a.Skv ? -1 : static_cast<int>(a.window);
  // one block an SM, each walking its share of the tiles
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_tiles = (a.Sq + BQ - 1) / BQ * a.B * a.Hq;
  const dim3 grid(static_cast<unsigned>(n_tiles < sms ? n_tiles : sms));
  // heads a section: all where every head's K and V (a KV head's, shared by
  // Hq / Hkv query heads) fit L2_FIT_BYTES, else those within L2_SECTION_BYTES
  const int64_t kv_bytes = 2 * a.Skv * D * 4 * a.Hkv / a.Hq + 1;
  int64_t sec_heads = a.B * a.Hq * kv_bytes <= L2_FIT_BYTES ? a.B * a.Hq
                                                             : L2_SECTION_BYTES / kv_bytes;
  sec_heads = sec_heads < 1 ? 1 : sec_heads > a.B * a.Hq ? a.B * a.Hq : sec_heads;
  kern<<<grid, THREADS, Plan<D>::SMEM, a.stream>>>(
      tmq, tmk, tmv, static_cast<float*>(a.o), static_cast<int>(a.B * a.Hq),
      static_cast<int>(sec_heads), static_cast<int>(sec_heads == a.B * a.Hq),
      static_cast<int>(a.Hq), static_cast<int>(a.Hq / a.Hkv), static_cast<int>(a.Sq),
      static_cast<int>(a.Skv), a.os, a.causal, window, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The C signature of flash_attention_launch (flash_attention.cu), so either
// source serves the same wrapper and scripts/tune_kernel.py can hold them
// against each other.  Returns cudaGetLastError() after the launch (0 on
// success), cudaErrorInvalidValue for bfloat16 operands, a head dim other than
// 96 or 256 or more query tiles than an int counts (B Hq is held to 65,535, as
// in the other sources), and 10000 + the driver's CUresult for a tensor map it
// refuses (strides TMA cannot take).  The caller checks everything else
// (shapes, 16-byte strides and alignment, Sq <= Skv, Hq % Hkv == 0) before
// calling.  window < 0: none.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int64_t B,
    int64_t Hq, int64_t Hkv, int64_t Sq, int64_t Skv, int64_t D, int64_t qsb,
    int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh, int64_t kss,
    int64_t vsb, int64_t vsh, int64_t vss, int64_t osb, int64_t osh,
    int64_t oss, int causal, int64_t window, int is_bf16, void* stream) {
  if (is_bf16 || B * Hq > 65535 || Sq > (int64_t{1} << 30) || Skv > (int64_t{1} << 30) ||
      (Sq + BQ - 1) / BQ * B * Hq > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch a{q, k, v, o, B, Hq, Hkv, Sq, Skv,
                 {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss}, {osb, osh, oss},
                 causal, window, static_cast<cudaStream_t>(stream)};
  if (D == 96) return launch<96>(a);
  if (D == 256) return launch<256>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}
