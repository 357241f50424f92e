// Fused LayerNorm -> matmul forward for Hopper (sm_90a).
//
// Replaces cosmos_tpu/ops/experimental/ln_matmul.py::_kernel (launched by
// _ln_matmul_fwd_impl).  It computes
//     out[r, :] = round(LN(x[r]; g, b)) @ W^T + bias
// for x [R, D] in the compute dtype T, W in torch's [O, D] layout (read as
// it is: no transpose), float32 g, b [D] and bias [O] (the caller has
// already rounded the bias to T where the JAX attention path does), with
// the normalised row rounded to T before the product (ln_matmul.py:70),
// the product accumulated in float32, the bias added in float32, and the
// result cast to T.  The normalised [R, D] tensor never reaches device
// memory.
//
// What bounds it.  At the QKV projection of ViT-B (D = 768, O = 2304) the
// work is 2*R*D*O operations against (R*D + O*D + R*O) * itemsize bytes:
// about 670 operations per byte in bfloat16, above the ~295 at which the
// H100 stops being memory bound, so the tensor cores bound it.
//
// Design.
//   * One block of 256 threads (8 warps) per (tile of 32 rows, tile of 256
//     output columns); any R and O (ragged edges masked; O even).
//   * Each block recomputes its 32 rows' statistics (float32 single pass,
//     as the JAX kernel) and stages the rounded normalised rows, [32][D],
//     in shared memory: a row tile is read from L2 once per column tile.
//   * Warp w owns output columns [w*32, w*32 + 32) of the block's tile:
//     2 x 4 mma.sync m16n8k16 tiles in bfloat16 with float32 accumulators,
//     W's fragments read straight from device memory (L2-resident); FMA
//     loops with the same ownership in float32.
//   * Plain: no TMA, no wgmma, no software pipelining.  Those are later
//     work; the time is in PERF.md.

#include "ln_tile.cuh"

namespace {

using namespace ln_tile;

constexpr int BN = WARPS * 32;   // output columns per block

template <typename T>
__global__ void __launch_bounds__(THREADS)
ln_matmul_kernel(const T* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ b, const T* __restrict__ w,
                 const float* __restrict__ bias, T* __restrict__ out, int64_t R, int D,
                 int O, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sY = reinterpret_cast<T*>(smem_raw);
  const int ldy = D + PAD;
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  stage_ln_rows<T>(sY, ldy, x, row0, R, D, g, b, eps);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n0 = blockIdx.y * BN + warp * 32;
  if (n0 >= O) return;
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  warp_tile_product<T, 2, 4>(acc, sY, ldy, w, D, n0, O, D, 4);

  const int gr = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + nt * 8 + 2 * t;
      if (n >= O) continue;
      const float b0 = bias[n], b1 = bias[n + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t r = row0 + mt * 16 + gr + 8 * h;
        if (r < R)
          store_pair<T>(out + r * O + n, acc[mt][nt][2 * h] + b0, acc[mt][nt][2 * h + 1] + b1);
      }
    }
}

template <typename T>
cudaError_t launch(const void* x, const float* g, const float* b, const void* w,
                   const float* bias, void* out, int64_t R, int D, int O, float eps,
                   cudaStream_t stream) {
  const int smem = BM * (D + PAD) * (int)sizeof(T);
  auto kernel = ln_matmul_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((R + BM - 1) / BM), (O + BN - 1) / BN);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), g, b, static_cast<const T*>(w), bias, static_cast<T*>(out),
      R, D, O, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
// The caller checks shapes (D % 16 == 0, O % 2 == 0, D small enough for
// the [32][D] shared tile), dtypes, contiguity and 16-byte alignment.
extern "C" int cosmos_ln_matmul_fwd(const void* x, const void* g, const void* b,
                                    const void* w, const void* bias, void* out, int64_t R,
                                    int D, int O, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* bf = static_cast<const float*>(b);
  const float* biasf = static_cast<const float*>(bias);
  if (dtype == 0) return launch<float>(x, gf, bf, w, biasf, out, R, D, O, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, gf, bf, w, biasf, out, R, D, O, eps, s);
  return (int)cudaErrorInvalidValue;
}
