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
// Design against that bound: the work is plain float32 FMAs, so the kernel
// keeps the FMA pipes fed from shared memory.  One block of 256 threads per
// (b, h_q, 64-query tile); a loop over 64-key tiles takes the place of the
// Pallas grid's sequential ("arbitrary") axis, and key tiles that the causal /
// window test makes invisible to the whole query tile are skipped, as
// pl.when(run) does, so the flops follow P.  Q (once) and each K tile are
// staged transposed ([D][64]) and each V tile as is, all as float32, so that a
// thread's 4x4 block of scores and 4 x D/16 block of outputs are built from
// 16-byte shared loads that are broadcasts or conflict-free (two loads per
// 16 or 32 FMAs).  The probabilities go through shared memory in an XOR
// swizzle that keeps their stores conflict-free.  Running max, sum and the
// output accumulator stay in float32 registers; a row's max and sum meet
// through shuffles among the 16 threads that share the row.  K/V are never
// repeated in memory: query head h reads KV head h / G.  Ragged edges are
// masked in the kernel (rows past Sq are not stored, keys past Skv are zero
// and masked), so no padding copy exists.  112 KB of shared memory at
// D = 128 lets two blocks share an SM.  bfloat16 runs the same float32 FMA
// path, so it is far from its tensor-core bound; wgmma/TMA is later work.
//
// Masking uses -1e30, as the reference does: a tile in which every key is
// masked for a row then adds a bogus term that the next visible tile's
// alpha = exp(-1e30 - m) = 0 wipes out, where -inf would give NaN.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // 16 x 16: ty owns rows 4ty.., tx keys 4tx..
constexpr float NEG_INF = -1e30f;

template <typename T>
struct Vec4;

template <>
struct Vec4<float> {
  static __device__ __forceinline__ float4 load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

template <>
struct Vec4<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    __nv_bfloat162 a, b;
    *reinterpret_cast<uint32_t*>(&a) = u.x;
    *reinterpret_cast<uint32_t*>(&b) = u.y;
    const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
    return make_float4(fa.x, fa.y, fb.x, fb.y);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float4 v) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&a);
    u.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

struct Strides {
  int64_t b, h, s;
};

// Position of the 4-row chunk `chunk` of key row k in the swizzled P tile.
__device__ __forceinline__ int p_index(int k, int chunk) {
  return k * BQ + ((chunk ^ ((k >> 2) & 15)) << 2);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Hq,
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

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  // Q tile, transposed; consecutive threads take consecutive rows, so the
  // shared stores are conflict-free.  Rows past Sq are zero.
  for (int idx = tid; idx < BQ * (D / 4); idx += THREADS) {
    const int r = idx % BQ, d4 = (idx / BQ) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq) x = Vec4<T>::load(qb + (q0 + r) * qs.s + d4);
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
      if (k_base + r < Skv) x = Vec4<T>::load(kb + (k_base + r) * ks.s + d4);
      Kt[(d4 + 0) * BK + r] = x.x;
      Kt[(d4 + 1) * BK + r] = x.y;
      Kt[(d4 + 2) * BK + r] = x.z;
      Kt[(d4 + 3) * BK + r] = x.w;
    }
    for (int idx = tid; idx < BK * (D / 4); idx += THREADS) {
      const int r = idx / (D / 4), d4 = (idx % (D / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k_base + r < Skv) x = Vec4<T>::load(vb + (k_base + r) * vs.s + d4);
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
  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= Sq) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int jj = 0; jj < J; ++jj)
      Vec4<T>::store(ob + r * os.s + 64 * jj + 4 * tx,
                     make_float4(acc[i][4 * jj] * inv, acc[i][4 * jj + 1] * inv,
                                 acc[i][4 * jj + 2] * inv,
                                 acc[i][4 * jj + 3] * inv));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B,
           int64_t Hq, int64_t Hkv, int64_t Sq, int64_t Skv, Strides qs,
           Strides ks, Strides vs, Strides os, int causal, int64_t window,
           cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * (D * BQ + D * BK + BK * D + BK * BQ);
  auto kern = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((Sq + BQ - 1) / BQ),
                  static_cast<unsigned>(B * Hq));
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<int>(Hq),
      static_cast<int>(Hq / Hkv), static_cast<int>(Sq), static_cast<int>(Skv),
      qs, ks, vs, os, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int64_t B,
             int64_t Hq, int64_t Hkv, int64_t Sq, int64_t Skv, int64_t D,
             Strides qs, Strides ks, Strides vs, Strides os, int causal,
             int64_t window, cudaStream_t stream) {
  if (D == 64)
    return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os,
                         causal, window, stream);
  if (D == 128)
    return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, qs, ks, vs, os,
                          causal, window, stream);
  return static_cast<int>(cudaErrorInvalidValue);
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
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, qs, ks,
                                   vs, os, causal, window, st);
  return launch_d<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, qs, ks, vs, os,
                         causal, window, st);
}
