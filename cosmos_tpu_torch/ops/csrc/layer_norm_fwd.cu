// Single-pass LayerNorm forward for Hopper (sm_90a).
//
// Replaces cosmos_tpu/ops/experimental/layer_norm.py::_fwd_kernel
// (launched by _ln_fwd).  For every row r of x [R, D] in the compute dtype
// T (the [B, L, D] input flattened), with float32 scale s and bias b [D]:
//     mean = sum(x) / D,  var = max(sum(x^2) / D - mean^2, 0)  (float32)
//     rstd = rsqrt(var + eps)
//     y    = T(((x - mean) * rstd) * s + b)
// and the float32 mean and rstd go to [R] side outputs for the backward
// (K4, layer_norm_bwd.cu).
//
// What bounds it.  Memory: each element of x is read once and each of y
// written once, against about 8 operations; the bound is
// (2 * R * D * itemsize + 8 * R) bytes over the HBM rate.
//
// Design.  One warp per row (8 rows per block of 256 threads), 16-byte
// loads and stores.  The warp sums x and x^2 in float32 and reduces them
// with shuffles; the second sweep over the row (an L1 hit) writes y.  The
// rounding order is the JAX kernel's: each step rounded, no contraction
// into FMAs, so y equals the plain PyTorch version given equal statistics.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ y,
                      float* __restrict__ mean_out, float* __restrict__ rstd_out, int64_t R,
                      int D, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  const int64_t row = (int64_t)blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= R) return;
  const T* xr = x + row * D;
  float s = 0.f, ss = 0.f;
  for (int c = lane * VEC; c < D; c += 32 * VEC) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float v = to_f32(e[k]);
      s += v;
      ss += __fmul_rn(v, v);
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mean = __fdiv_rn(s, (float)D);
  const float var = fmaxf(__fsub_rn(__fdiv_rn(ss, (float)D), __fmul_rn(mean, mean)), 0.f);
  const float rstd = rsqrtf(var + eps);

  T* yr = y + row * D;
  for (int c = lane * VEC; c < D; c += 32 * VEC) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
    const T* e = reinterpret_cast<const T*>(&raw);
    alignas(16) T out[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float xh = __fmul_rn(__fsub_rn(to_f32(e[k]), mean), rstd);
      out[k] = from_f32<T>(__fadd_rn(__fmul_rn(xh, scale[c + k]), bias[c + k]));
    }
    *reinterpret_cast<uint4*>(yr + c) = *reinterpret_cast<const uint4*>(out);
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, const float* bias, void* y,
                   float* mean, float* rstd, int64_t R, int D, float eps,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)((R + WARPS - 1) / WARPS));
  layer_norm_fwd_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(y), mean, rstd, R, D, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
// The caller checks D % 8 == 0, dtypes, contiguity and 16-byte alignment.
extern "C" int cosmos_layer_norm_fwd(const void* x, const void* scale, const void* bias,
                                     void* y, void* mean, void* rstd, int64_t R, int D,
                                     float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  if (dtype == 0) return launch<float>(x, sc, bi, y, m, r, R, D, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, sc, bi, y, m, r, R, D, eps, s);
  return (int)cudaErrorInvalidValue;
}
