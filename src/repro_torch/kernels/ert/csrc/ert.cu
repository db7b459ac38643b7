// ERT micro-kernels (Empirical Roofline Toolkit style) for the roofline's
// measured ceilings: repro_torch/launch/roofline.py:ert_sweep.
//
// They replace no TPU kernel: the reference measures the same two loops
// with jitted jnp code (repro/launch/roofline.py:_ert_stream_fn and
// _ert_gather_fn), which XLA fuses into one pass.  PyTorch runs eagerly, so
// the t-step chain of ert_stream would be t kernels and t round trips to
// device memory there; the intensity axis would mean nothing.  Written by
// hand, the chain stays in a register.
//
//   ert_stream: y[i] = (((x[i] a + c) a + c) ...) t times: one read, one
//               write and 2t FLOPs an element (t fused multiply-adds).  At
//               t = 1 it is bound by bytes (HBM past the 50 MB L2, the L2
//               inside it); as t grows it reaches the FMA pipes' rate.
//   ert_gather: y[i] = x[idx[i]]: one random read, one streamed write and
//               one index read an element, the access pattern of the ELL
//               SpMV.  Bound by bytes (sectors of 32 B for 4 or 8 used).
//
// Grid-stride loops over one launch of ~16 blocks an SM; no shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void ert_stream_kernel(const T* __restrict__ x, T* __restrict__ y,
                                  int64_t n, int t, T a, T c) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    T v = x[i];
    for (int j = 0; j < t; ++j) v = fma(v, a, c);
    y[i] = v;
  }
}

template <typename T>
__global__ void ert_gather_kernel(const T* __restrict__ x,
                                  const int32_t* __restrict__ idx,
                                  T* __restrict__ y, int64_t n) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step)
    y[i] = __ldg(x + __ldg(idx + i));
}

constexpr int THREADS = 256;

int blocks_for(int64_t n) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t want = (n + THREADS - 1) / THREADS;
  int64_t cap = (int64_t)sms * 16;
  return (int)(want < cap ? (want > 0 ? want : 1) : cap);
}

}  // namespace

extern "C" int ert_stream_launch(const void* x, void* y, int64_t n, int t,
                                 double a, double c, int f64, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return 0;
  if (f64)
    ert_stream_kernel<double><<<blocks_for(n), THREADS, 0, s>>>(
        (const double*)x, (double*)y, n, t, a, c);
  else
    ert_stream_kernel<float><<<blocks_for(n), THREADS, 0, s>>>(
        (const float*)x, (float*)y, n, t, (float)a, (float)c);
  return (int)cudaGetLastError();
}

extern "C" int ert_gather_launch(const void* x, const void* idx, void* y,
                                 int64_t n, int f64, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return 0;
  if (f64)
    ert_gather_kernel<double><<<blocks_for(n), THREADS, 0, s>>>(
        (const double*)x, (const int32_t*)idx, (double*)y, n);
  else
    ert_gather_kernel<float><<<blocks_for(n), THREADS, 0, s>>>(
        (const float*)x, (const int32_t*)idx, (float*)y, n);
  return (int)cudaGetLastError();
}
