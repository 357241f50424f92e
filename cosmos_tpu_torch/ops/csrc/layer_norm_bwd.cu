// LayerNorm backward for Hopper (sm_90a).
//
// Replaces cosmos_tpu/ops/experimental/layer_norm.py::_bwd_kernel
// (launched by _ln_bwd, and through it by hybrid_layer_norm's backward).
// From the saved x [R, D] (compute dtype T), the float32 per-row mean and
// rstd [R], the float32 scale s [D] and the output gradient g [R, D] (T):
//     xh = (x - mean) * rstd,  gs = g * s
//     dx = T(rstd * (gs - mean(gs) - xh * mean(gs * xh)))     per row
//     dscale = sum over rows of g * xh,  dbias = sum over rows of g  (float32)
//
// What bounds it.  Memory: x and g read once, dx written once, plus the
// per-row statistics; the bound is (3 * R * D * itemsize + 8 * R + 8 * D)
// bytes over the HBM rate.
//
// Design.
//   * Pass 1 (rows kernel): a block of 4 warps owns a contiguous range of
//     rows; each warp takes every 4th row of it.  Per row the warp sweeps
//     the row twice (the second sweep hits L1): first the two row means,
//     then dx, while adding g * xh and g into the warp's own float32
//     column sums in shared memory (each lane owns fixed columns, so no
//     two threads touch one sum).  At the end the block adds its 4 warps'
//     sums in a fixed order and writes one partial row per block to a
//     float32 workspace [2][nblocks][D].
//   * Pass 2 (reduce kernel): each column's nblocks partials are summed in
//     a fixed order (8 strided partial sums, then those 8 in order).
//   * No float atomics anywhere: the result does not depend on the order in
//     which blocks run, so a training step repeats to the last bit.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int RED_COLS = 32;    // reduce kernel: columns per block
constexpr int RED_SPLIT = 8;    // reduce kernel: partial sums per column

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
layer_norm_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ g,
                           const float* __restrict__ scale, const float* __restrict__ mean,
                           const float* __restrict__ rstd, T* __restrict__ dx,
                           float* __restrict__ partial, int64_t R, int D,
                           int rows_per_block) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ float sacc[];   // [WARPS][2][D]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < WARPS * 2 * D; i += THREADS) sacc[i] = 0.f;
  __syncthreads();
  float* ds_w = sacc + warp * 2 * D;
  float* db_w = ds_w + D;
  const float inv_d = 1.f / (float)D;

  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t r1 = min(R, r0 + rows_per_block);
  for (int64_t row = r0 + warp; row < r1; row += WARPS) {
    const float mu = mean[row];
    const float rs = rstd[row];
    const T* xr = x + row * D;
    const T* gr = g + row * D;
    float m1 = 0.f, m2 = 0.f;
    for (int c = lane * VEC; c < D; c += 32 * VEC) {
      const uint4 xraw = *reinterpret_cast<const uint4*>(xr + c);
      const uint4 graw = *reinterpret_cast<const uint4*>(gr + c);
      const T* xe = reinterpret_cast<const T*>(&xraw);
      const T* ge = reinterpret_cast<const T*>(&graw);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float xh = __fmul_rn(__fsub_rn(to_f32(xe[k]), mu), rs);
        const float gs = __fmul_rn(to_f32(ge[k]), scale[c + k]);
        m1 += gs;
        m2 += __fmul_rn(gs, xh);
      }
    }
    m1 = warp_sum(m1) * inv_d;
    m2 = warp_sum(m2) * inv_d;
    T* dxr = dx + row * D;
    for (int c = lane * VEC; c < D; c += 32 * VEC) {
      const uint4 xraw = *reinterpret_cast<const uint4*>(xr + c);
      const uint4 graw = *reinterpret_cast<const uint4*>(gr + c);
      const T* xe = reinterpret_cast<const T*>(&xraw);
      const T* ge = reinterpret_cast<const T*>(&graw);
      alignas(16) T out[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float xh = __fmul_rn(__fsub_rn(to_f32(xe[k]), mu), rs);
        const float gv = to_f32(ge[k]);
        const float gs = __fmul_rn(gv, scale[c + k]);
        out[k] = from_f32<T>(
            __fmul_rn(rs, __fsub_rn(__fsub_rn(gs, m1), __fmul_rn(xh, m2))));
        ds_w[c + k] += __fmul_rn(gv, xh);
        db_w[c + k] += gv;
      }
      *reinterpret_cast<uint4*>(dxr + c) = *reinterpret_cast<const uint4*>(out);
    }
  }
  __syncthreads();
  const int nblocks = gridDim.x;
  for (int c = threadIdx.x; c < D; c += THREADS) {
    float ds = 0.f, db = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      ds += sacc[w * 2 * D + c];
      db += sacc[w * 2 * D + D + c];
    }
    partial[(int64_t)blockIdx.x * D + c] = ds;
    partial[((int64_t)nblocks + blockIdx.x) * D + c] = db;
  }
}

// partial [2][nblocks][D] -> out [2][D] (dscale, then dbias).  Block: 32
// columns x 8 partial sums; blockIdx.x walks the 2*D columns.
__global__ void __launch_bounds__(RED_COLS * RED_SPLIT)
layer_norm_bwd_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                             int nblocks, int D) {
  __shared__ float sums[RED_SPLIT][RED_COLS];
  const int col = blockIdx.x * RED_COLS + threadIdx.x;   // in [0, 2*D)
  const bool valid = col < 2 * D;
  const int which = valid ? col / D : 0;
  const int c = valid ? col % D : 0;
  const float* p = partial + (int64_t)which * nblocks * D + c;
  float s = 0.f;
  if (valid)
    for (int i = threadIdx.y; i < nblocks; i += RED_SPLIT) s += p[(int64_t)i * D];
  sums[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && valid) {
    float total = 0.f;
#pragma unroll
    for (int j = 0; j < RED_SPLIT; ++j) total += sums[j][threadIdx.x];
    out[col] = total;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* g, const float* scale, const float* mean,
                   const float* rstd, void* dx, float* partial, float* dsb, int64_t R,
                   int D, int rows_per_block, int nblocks, cudaStream_t stream) {
  const int smem = WARPS * 2 * D * (int)sizeof(float);
  auto rows = layer_norm_bwd_rows_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  rows<<<nblocks, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), scale, mean, rstd,
      static_cast<T*>(dx), partial, R, D, rows_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 block(RED_COLS, RED_SPLIT);
  layer_norm_bwd_reduce_kernel<<<(2 * D + RED_COLS - 1) / RED_COLS, block, 0, stream>>>(
      partial, dsb, nblocks, D);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  partial: float32 [2][nblocks][D]
// workspace with nblocks = ceil(R / rows_per_block); dsb: float32 [2][D]
// (dscale, dbias).  Returns a cudaError_t (0 = launched).  The caller
// checks D % 8 == 0, D <= 4096, dtypes, contiguity and 16-byte alignment.
extern "C" int cosmos_layer_norm_bwd(const void* x, const void* g, const void* scale,
                                     const void* mean, const void* rstd, void* dx,
                                     void* partial, void* dsb, int64_t R, int D,
                                     int rows_per_block, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblocks = (int)((R + rows_per_block - 1) / rows_per_block);
  const float* sc = static_cast<const float*>(scale);
  const float* mu = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(dsb);
  if (dtype == 0)
    return launch<float>(x, g, sc, mu, rs, dx, p, o, R, D, rows_per_block, nblocks, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, g, sc, mu, rs, dx, p, o, R, D, rows_per_block,
                                 nblocks, s);
  return (int)cudaErrorInvalidValue;
}
