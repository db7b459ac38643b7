// The value types of the sparse kernels (spmv/csrc: ell_spmv.cu,
// ell_spmm.cu, bcsr_spmm.cu) and the block smoothers' (smoother/csrc:
// block_diag_apply.cu, tri_solve.cu): float32, float64 and bfloat16.
// Products and sums are
// taken in Acc<T>::type, T itself for float32 and float64 and float32 for
// bfloat16, whose loads are widened by the bf16 intrinsics and whose
// results are rounded once, at the store (__float2bfloat16_rn).
#pragma once

#include <cuda_bf16.h>

template <typename T> struct Acc { using type = T; };
template <> struct Acc<__nv_bfloat16> { using type = float; };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
