// flash_attention (bfloat16, Hopper design): o[b, h, i, :] = softmax_j(q[b, h, i, :] .
// k[b, h/G, j, :] / sqrt(D)) v[b, h/G, j, :] over the keys j visible to query i (causal
// and/or sliding window), G = Hq/Hkv.
//
// Replaces the Pallas kernel in repro/kernels/flash_attention/flash_attention.py,
// function flash_attention (_attn_kernel), for bfloat16 operands, as the
// mma.sync instances of flash_attention.cu do; the route table in
// flash_attention.py says which of the two serves a head dim.  Same function
// and numerics as those: causal GQA with an optional sliding window, queries
// right-aligned at Skv (query i sits at position i + Skv - Sq), q [B, Hq, Sq,
// D], k/v [B, Hkv, Skv, D] with any (b, h, s) strides and the D dim
// contiguous; scores, the running max, sum and output in float32; P rounded to
// bfloat16 once before P V, the output rounded to bfloat16 once; a masked
// score is -inf against a running max that starts at -1e30, so its term is
// exactly 0.  Head dims 64, 96, 128 and 256.
//
// Bound on an H100 SXM: 4*B*Hq*D*P flops for P visible (query, key) pairs at
// the dense bf16 tensor cores' 989 TFLOP/s, or reading q, k, v and writing o
// once at 3.35 TB/s, whichever is longer; at the prefill shapes the flops.
//
// Design (what Hopper adds over the mma.sync instances, whose two warps a
// scheduler ran the ldmatrix -> mma -> softmax chain in order):
//  - tiles of 128 query rows of one (b, h_q), each with the run of key tiles
//    [lo, hi] visible to some row of it, as in flash_attention.cu; a
//    persistent grid of one block an SM walks them, longest first
//    (flash_wgmma_kernel has the order);
//  - three warpgroups: warpgroup 0 is the producer (one thread issues every
//    copy, the rest leave; setmaxnreg gives its registers away), warpgroups 1
//    and 2 the consumers, each owning 64 query rows (setmaxnreg 240);
//  - every copy is a TMA load through a 4-D tensor map over [B, H, S, D]
//    with the caller's strides, encoded on the host per call and passed as a
//    __grid_constant__ parameter, boxes of 64 dims (128 bytes) x rows with the
//    128-byte swizzle; rows past S and dims past D come in as zeros (TMA's
//    fill), so ragged edges need no masked copy; D = 96 takes two boxes a
//    tile, the second half filled with zeros, and its products walk 6 k16
//    steps and 96 output columns;
//  - Q comes in once a tile; K and V go through a ring of STAGES stages,
//    each with a "full" mbarrier (arrive with expect_tx, complete_tx by the
//    copy) and an "empty" one the 256 consumer threads arrive on, for K and
//    for V apart; no __syncthreads past the barriers' set-up, and S = Q K^T
//    starts as soon as K has landed;
//  - S = Q K^T is wgmma m64n{BK}k16 with both operands in shared memory (K
//    is K-major as stored); the online softmax runs on the accumulator
//    registers (a row's keys lie in one quad of lanes, as with mma.sync);
//    P is packed to bfloat16 in registers and fed as wgmma's register A
//    operand into O += P V, m64n{D}k16 (the m64nNk16 accumulator layout is
//    the k16 A-operand layout); V stays [keys][D] in shared memory and is
//    read through the descriptor's transpose bit (MN-major);
//  - the products overlap the softmax twice over: a consumer issues key
//    tile i's S = Q K^T with tile i - 1's P V and runs tile i's softmax
//    while that P V is in the tensor cores, and the two consumers take
//    turns issuing (named barriers 1 and 2); on an H100 (PERF.md) the first
//    was worth about 10% at the prefill shapes, the turns 2-3%, the
//    persistent grid 5% and its snake rounds 4% more;
//  - the output is stored from registers, rows past Sq never.
//
// Masking as flash_attention.cu: a masked score is -inf while the running max
// starts at -1e30, so its term is exactly 0 and no inf - inf arises.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 128;                     // query rows a block: two consumers of 64
constexpr int THREADS = 384;                // producer + two consumer warpgroups
constexpr int CONSUMER_THREADS = 256;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;   // 24 * 128 + 240 * 256 <= 65,536
// the tile order's sections (flash_wgmma_kernel): every head in one section
// where all heads' K and V fit L2_FIT_BYTES of the H100's 50 MB L2, else
// sections of heads whose K and V take L2_SECTION_BYTES (an H100: at
// phi-3-vision's 90 MB of K and V, sections of 8, 20, 40 and 90 MB ran
// 0.2229, 0.2295, 0.2446 and 0.2821 ms; at qwen3-1.7b's 30 MB one section
// 0.1409 ms, two 0.1498, four 0.1723)
constexpr int64_t L2_FIT_BYTES = 40 << 20, L2_SECTION_BYTES = 8 << 20;

using bf16 = __nv_bfloat16;

struct Strides {
  int64_t b, h, s;
};

// Tile shape of a head dim: BK keys a K/V tile, STAGES tiles in flight.
// Shared memory: Q takes NCH * 128 * 128 bytes, each stage NCH * BK * 128
// for K and as much for V (NCH = the 64-dim chunks of a row):
//   D = 64:  16 KB + 2 * 2 * 16 KB =  80 KB
//   D = 96:  32 KB + 2 * 2 * 32 KB = 160 KB (chunk 1 half zeros)
//   D = 128: 32 KB + 2 * 2 * 32 KB = 160 KB
//   D = 256: 64 KB + 2 * 2 * 40 KB = 224 KB, 80-key tiles: O takes 128 of a
//            consumer thread's 240 registers, S 40 and P 20.
// On an H100 (PERF.md) 80-key tiles at D = 256 ran 4% faster than 64-key
// ones, and a third stage at D <= 128 gained nothing.
template <int D>
struct Cfg {
  static constexpr int BK = 128, STAGES = 2;
};

template <>
struct Cfg<256> {
  static constexpr int BK = 80, STAGES = 2;
};

template <int D>
constexpr int NCH = (D + 63) / 64;          // 64-dim (128-byte) chunks of a row
template <int D>
constexpr int Q_BYTES = NCH<D> * BQ * 128;
template <int D>
constexpr int KV_BYTES = NCH<D> * Cfg<D>::BK * 128;   // one K (or V) stage
template <int D>
constexpr int SMEM_BYTES = 1024 /* alignment slack */ + Q_BYTES<D> +
                           2 * Cfg<D>::STAGES * KV_BYTES<D> + 8 * (2 + 4 * Cfg<D>::STAGES);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers, TMA, named barriers
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

// box {64 dims, rows} at (dim c0, row c1, head c2, batch c3) of a 4-D map
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

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), swizzle mode 1.
// K-major (Q, K: a row's 64 dims in one 128-byte line, 8-row atoms 1024
// bytes apart: SBO 1024, LBO unused); MN-major (V: the 64 dims of a key in
// one line, 8-key atoms 1024 bytes apart: SBO 1024; the next 64 dims one
// chunk further: LBO = the chunk's bytes).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (uint64_t{1} << 62);
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

// keep the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d[64 x N] (+)= a[64 x 16] b[16 x N], both operands in shared memory (K-major),
// bf16 in, float32 accumulate; scale_d = 0 overwrites d.  Accumulator layout:
// d[4 j + e] of lane (g = lane / 4, t = lane % 4) of warp w is row 16 w + g +
// 8 (e >> 1), column 8 j + 2 t + (e & 1).
__device__ __forceinline__ void wgmma_ss_n80(float (&d)[40], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x N] += a[64 x 16] b[16 x N], a from registers (the k16 A fragment:
// a[0] = rows g, columns 2t, 2t + 1; a[1] rows g + 8; a[2] row g, columns 2t
// + 8, 2t + 9; a[3] row g + 8), b MN-major in shared memory (transposed).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  static_assert(N == 80 || N == 128, "no m64nNk16 instance for this key tile");
  if constexpr (N == 80) wgmma_ss_n80(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 64 || N == 96 || N == 128 || N == 256, "no m64nNk16 instance for this head dim");
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 96) wgmma_rs_n96(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// 2^x in one MUFU op (2 ulp; -1e30 and -inf give 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// Mask and online softmax of one key tile's scores in place (s[4 j + e]: row
// q_row + 8 (e >> 1), key k_base + 8 j + 2 t + (e & 1)), as online_softmax in
// flash_attention.cu: the max on the raw scores, the scale into log2 units in
// the exp's FFMA, m_i / l_i the running max (log2 units) and this thread's
// partial sum of rows g and g + 8; returns in alpha each row's rescale of the
// output accumulator, which `rescale` applies (after the P V product that
// still reads it, where the two overlap).
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

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j + 0] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

// P in bf16 as the A fragments of the BK / 16 k-steps of P V: k-step kk is
// the score n-tiles 2 kk and 2 kk + 1
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4], const float (&s)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int BK>
__device__ __forceinline__ void fence_p(uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(pa[kk][r])::"memory");
}

// S = Q K^T for one warpgroup's 64 rows (qa: their chunk-0 address) and the
// key tile at ka: D / 16 k-steps, each 32 bytes further along a 128-byte
// line, the next chunk after four; issued, not waited for
template <int D, int BK>
__device__ __forceinline__ void issue_scores(float (&s)[BK / 2], uint32_t qa, uint32_t ka) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<BK>(s, smem_desc(qa + (kk / 4) * BQ * 128 + (kk % 4) * 32, 16, 1024),
                 smem_desc(ka + (kk / 4) * BK * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
}

// O += P V for the value tile at va: k-step kk reads keys 16 kk .. 16 kk + 15
// (two 8-key atoms, 2048 bytes), all D dims (the chunks BK * 128 bytes
// apart); issued, not waited for
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[BK / 16][4],
                                         uint32_t va) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<D>(o, pa[kk], smem_desc(va + kk * 16 * 128, BK * 128, 1024));
}

// Shared memory (1024-byte aligned, as the 128-byte swizzle's 8-row atoms
// need): Q [NCH][128 rows][64], K and V [STAGES][NCH][BK rows][64], then the
// mbarriers: q_full, q_empty, k_full[STAGES], v_full[STAGES],
// k_empty[STAGES], v_empty[STAGES].  K and V stages are released apart (a K
// tile once its scores are in, a V tile once its P V is), so the next K copy
// starts while the last P V still runs; Q is released once a tile's last
// scores are in, so the next tile's Q comes in during its last P V and its
// store.
// The grid is persistent: the n_qt * B * Hq query tiles are dealt out in
// rounds of gridDim.x, block x taking tile x of a round, or with `snake`
// tile gridDim.x - 1 - x of an odd round (so the block with a round's
// longest tile takes the next round's shortest); the K/V ring's stages and
// phases run on across a block's tiles.  Tiles are numbered in sections of
// sec_heads (b, h) heads whose K and V the host sized to fit the L2
// together, and within a section longest first: tile i of a section of hs
// heads is query tile n_qt - 1 - i / hs of its head i % hs.  Blocks running
// at once then read the K and V of few heads (at phi-3-vision's 128 heads of
// 96 without GQA, all heads' K and V are 90 MB at S 1819: one section of
// every head, longest first, missed the 50 MB L2 and ran 26% slower on an
// H100).  The host asks for `snake` where every head is in one section: on an
// H100 it took 5-9% off the causal prefills whose K and V fit the L2 and cost
// 24% at phi-3-vision's sections, whose blocks it spread over more heads.
// Positions are 32-bit: the launch takes Sq, Skv < 2^30, and a window of
// Skv or more hides nothing, so it comes in as -1 (none).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
                   const __grid_constant__ CUtensorMap tmv, bf16* __restrict__ o, int n_bh,
                   int sec_heads, int snake, int Hq, int group, int Sq, int Skv, Strides os,
                   int causal, int window, float scale_log2) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, STAGES = C::STAGES, NC = NCH<D>;
  constexpr int QB = Q_BYTES<D>, KVB = KV_BYTES<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t qs = (raw + 1023) & ~1023u;     // Q
  const uint32_t ks = qs + QB;                   // K stages
  const uint32_t vs = ks + STAGES * KVB;         // V stages
  const uint32_t bars = vs + STAGES * KVB;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto k_full = [&](int st) { return bars + 8 * (2 + st); };
  auto v_full = [&](int st) { return bars + 8 * (2 + STAGES + st); };
  auto k_empty = [&](int st) { return bars + 8 * (2 + 2 * STAGES + st); };
  auto v_empty = [&](int st) { return bars + 8 * (2 + 3 * STAGES + st); };

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int n_tiles = n_qt * n_bh;
  // this block's tile in round r, or -1 past the last
  auto tile_of = [&](int r) {
    const int base = r * static_cast<int>(gridDim.x);
    const int x = snake && (r & 1) ? static_cast<int>(gridDim.x - 1 - blockIdx.x)
                                   : static_cast<int>(blockIdx.x);
    return base + x < n_tiles ? base + x : -1;
  };
  const int n_kt = (Skv + BK - 1) / BK;
  // tile `tile`: its head, first query row and the one run [lo, hi] of key
  // tiles visible to some row of it
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
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), CONSUMER_THREADS);
      mbar_init(v_empty(st), CONSUMER_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread issues every copy
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
        mbar_expect_tx(q_full, QB);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tma_load_4d(qs + c * BQ * 128, &tmq, q_full, 64 * c, x.q0, x.h, x.b);
        for (int kt = x.lo; kt <= x.hi; ++kt, ++it) {
          const int st = it % STAGES;
          const uint32_t parity = (static_cast<uint32_t>(it / STAGES) & 1) ^ 1;
          mbar_wait(k_empty(st), parity);
          mbar_expect_tx(k_full(st), KVB);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            tma_load_4d(ks + st * KVB + c * BK * 128, &tmk, k_full(st), 64 * c, kt * BK, hk, x.b);
          mbar_wait(v_empty(st), parity);
          mbar_expect_tx(v_full(st), KVB);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            tma_load_4d(vs + st * KVB + c * BK * 128, &tmv, v_full(st), 64 * c, kt * BK, hk, x.b);
        }
      }
    }
  } else {
    // consumers: warpgroup cw owns query rows 64 cw .. 64 cw + 63 of a tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int row_w = 64 * cw + 16 * warp + g;     // this thread's first row in a tile
    const uint32_t qa = qs + cw * 64 * 128;        // this warpgroup's 64 rows of chunk 0
    // a warpgroup issues its products only in its turn (named barrier 1 +
    // cw), then hands the turn over; consumer 0 takes the first turn, and
    // consumer 1's last hand-over is left out, so every barrier sees as many
    // arrivals as syncs
    auto turn = [&]() { named_sync(1 + cw, CONSUMER_THREADS); };
    auto hand_over = [&](bool last) {
      if (!(cw == 1 && last)) named_arrive(2 - cw, CONSUMER_THREADS);
    };
    if (cw == 1) named_arrive(1, CONSUMER_THREADS);
    int it = 0, qi = 0;        // K/V tiles and Q tiles consumed so far
    for (int r = 0, tile; (tile = tile_of(r)) >= 0; ++r) {
      const Tile x = tile_at(tile);
      const bool last_tile = tile_of(r + 1) < 0;
      const int q_first = x.q_base + 64 * cw, q_last = q_first + 63;
      // a tile visible to every pair of this warpgroup's rows skips the mask
      auto full = [&](int k_base) {
        return k_base + BK <= Skv && (!causal || k_base + BK - 1 <= q_first) &&
               (window < 0 || q_last - k_base < window);
      };
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f};

      if (x.lo <= x.hi) {
        mbar_wait(q_full, qi++ & 1);
        // tile i's scores are in the tensor cores while tile i - 1's P V
        // is, and tile i's softmax runs while that P V finishes
        uint32_t pa[BK / 16][4];
        float alpha[2];
        {
          const int st = it % STAGES;
          float s[BK / 2];
          mbar_wait(k_full(st), static_cast<uint32_t>(it / STAGES) & 1);
          turn();
          wgmma_fence();
          issue_scores<D, BK>(s, qa, ks + st * KVB);
          wgmma_commit();
          hand_over(false);
          wgmma_wait_all();
          fence_regs(s);
          mbar_arrive(k_empty(st));
          online_softmax<BK>(s, m_i, l_i, alpha, full(x.lo * BK), x.q_base + row_w,
                             x.lo * BK, Skv, causal, window, scale_log2, t);
          pack_p<BK>(pa, s);
        }
        for (int kt = x.lo + 1; kt <= x.hi; ++kt) {
          const int st = (it + 1) % STAGES, prev = it % STAGES;
          const uint32_t parity = static_cast<uint32_t>((it + 1) / STAGES) & 1;
          const uint32_t prev_parity = static_cast<uint32_t>(it / STAGES) & 1;
          float s[BK / 2];
          mbar_wait(k_full(st), parity);
          mbar_wait(v_full(prev), prev_parity);
          turn();
          fence_regs(acc);
          wgmma_fence();
          issue_scores<D, BK>(s, qa, ks + st * KVB);
          wgmma_commit();
          issue_pv<D, BK>(acc, pa, vs + prev * KVB);
          wgmma_commit();
          hand_over(false);
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");   // the scores
          fence_regs(s);
          mbar_arrive(k_empty(st));
          online_softmax<BK>(s, m_i, l_i, alpha, full(kt * BK), x.q_base + row_w, kt * BK,
                             Skv, causal, window, scale_log2, t);
          wgmma_wait_all();                                                  // P V
          fence_regs(acc);
          fence_p<BK>(pa);
          mbar_arrive(v_empty(prev));
          rescale<D>(acc, alpha);
          pack_p<BK>(pa, s);
          ++it;
        }
        // every score of the tile is in: Q may be refilled
        mbar_arrive(q_empty);
        const int last = it % STAGES;
        mbar_wait(v_full(last), static_cast<uint32_t>(it / STAGES) & 1);
        turn();
        fence_regs(acc);
        wgmma_fence();
        issue_pv<D, BK>(acc, pa, vs + last * KVB);
        wgmma_commit();
        hand_over(last_tile);
        wgmma_wait_all();
        fence_regs(acc);
        mbar_arrive(v_empty(last));
        ++it;
      }

      // o = acc / l in float32, written in bf16 (l == 0 -> 1: a row that
      // saw no tile stays 0); rows past Sq are not stored
      bf16* ob = o + x.b * os.b + x.h * os.h;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float l = l_i[i];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const float inv = 1.f / (l == 0.f ? 1.f : l);
        const int r = x.q0 + row_w + 8 * i;
        if (r >= Sq) continue;
        bf16* orow = ob + static_cast<int64_t>(r) * os.s;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
              pack_bf16(acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
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

// A 4-D map over [B, H, S, D] bf16 (dims innermost first: D, S, H, B) with the
// caller's element strides, boxes of 64 dims x `rows` rows, 128-byte swizzle,
// out-of-range elements read as zeros.  A dimension of size 1 is never
// stepped, so its stride is replaced by a legal one (TMA wants multiples of
// 16 bytes, and a broadcast stride may be 0).  0 on success.
int encode_map(CUtensorMap* map, const void* ptr, int64_t B, int64_t H, int64_t S, int64_t D,
               const Strides& st, int rows) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  auto bytes = [&](int64_t n, int64_t s) {
    return static_cast<cuuint64_t>(n == 1 ? 2 * D : 2 * s);
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {bytes(S, st.s), bytes(H, st.h), bytes(B, st.b)};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
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
  const auto kern = flash_wgmma_kernel<D>;
  CUtensorMap tmq, tmk, tmv;
  int rc = encode_map(&tmq, a.q, a.B, a.Hq, a.Sq, D, a.qs, BQ);
  if (rc == 0) rc = encode_map(&tmk, a.k, a.B, a.Hkv, a.Skv, D, a.ks, Cfg<D>::BK);
  if (rc == 0) rc = encode_map(&tmv, a.v, a.B, a.Hkv, a.Skv, D, a.vs, Cfg<D>::BK);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES<D>);
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
  const int64_t kv_bytes = 2 * a.Skv * D * 2 * a.Hkv / a.Hq + 1;
  int64_t sec_heads = a.B * a.Hq * kv_bytes <= L2_FIT_BYTES ? a.B * a.Hq
                                                             : L2_SECTION_BYTES / kv_bytes;
  sec_heads = sec_heads < 1 ? 1 : sec_heads > a.B * a.Hq ? a.B * a.Hq : sec_heads;
  kern<<<grid, THREADS, SMEM_BYTES<D>, a.stream>>>(
      tmq, tmk, tmv, static_cast<bf16*>(a.o), static_cast<int>(a.B * a.Hq),
      static_cast<int>(sec_heads), static_cast<int>(sec_heads == a.B * a.Hq),
      static_cast<int>(a.Hq), static_cast<int>(a.Hq / a.Hkv), static_cast<int>(a.Sq),
      static_cast<int>(a.Skv), a.os, a.causal, window, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The C signature of flash_attention_launch (flash_attention.cu), so either
// source serves the same wrapper and scripts/tune_kernel.py can hold them
// against each other.  Returns cudaGetLastError() after the launch (0 on
// success), cudaErrorInvalidValue for float32 operands, a head dim other than
// 64, 96, 128 or 256 or more query tiles than an int counts (B Hq is held to
// 65,535, the mma.sync kernel's grid limit, here too), and 10000 + the
// driver's CUresult for a tensor map it refuses (strides TMA cannot take).
// The caller checks everything else (shapes, 16-byte strides and alignment,
// Sq <= Skv, Hq % Hkv == 0) before calling.  window < 0: none.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int64_t B,
    int64_t Hq, int64_t Hkv, int64_t Sq, int64_t Skv, int64_t D, int64_t qsb,
    int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh, int64_t kss,
    int64_t vsb, int64_t vsh, int64_t vss, int64_t osb, int64_t osh,
    int64_t oss, int causal, int64_t window, int is_bf16, void* stream) {
  if (!is_bf16 || B * Hq > 65535 || Sq > (int64_t{1} << 30) || Skv > (int64_t{1} << 30) ||
      (Sq + BQ - 1) / BQ * B * Hq > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch a{q, k, v, o, B, Hq, Hkv, Sq, Skv,
                 {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss}, {osb, osh, oss},
                 causal, window, static_cast<cudaStream_t>(stream)};
  if (D == 64) return launch<64>(a);
  if (D == 96) return launch<96>(a);
  if (D == 128) return launch<128>(a);
  if (D == 256) return launch<256>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}
