// Fused transformer-MLP block forward for Hopper (sm_90a).
//
// Replaces cosmos_tpu/ops/experimental/mlp_block.py::_kernel (launched by
// _fwd_impl).  It computes
//     out[r, :] = round(act(round(LN(x[r]; g, b)) @ W1^T + b1)) @ W2^T + b2
// for x [R, D] in the compute dtype T, W1 [HD, D] and W2 [D, HD] in torch's
// [out, in] layout (read as they are), float32 g, b [D], b1 [HD], b2 [D]
// (kept float32, as the fused JAX kernel keeps them, unlike the unfused
// Linear which rounds its bias), with the normalised row and the activated
// hidden rounded to T before their products (mlp_block.py:73-75), every
// product accumulated in float32 and the result cast to T.  The [R, HD]
// hidden never reaches device memory.
//
// What bounds it.  At ViT-B's MLP (D = 768, HD = 3072) the work is
// 4*R*D*HD operations against (2*R*D + 2*D*HD) * itemsize bytes: about 1500
// operations per byte in bfloat16 at R = 25216, so the tensor cores bound
// it.
//
// Design.
//   * One block of 256 threads (8 warps) per tile of 32 rows; any R.
//   * The block normalises its rows into shared memory ([32][D], T), then
//     walks the hidden axis in chunks of 64:
//       - warp w computes h[:, w*8 .. w*8 + 8) of the chunk (32 x 8, K = D)
//         from the shared rows and W1's rows, adds b1 and applies the
//         activation in float32, rounds to T and writes it to a shared
//         [32][64] chunk;
//       - warp w then accumulates its D/8 output columns,
//         o[:, w*D/8 .. (w+1)*D/8) += h_chunk @ W2[those columns, chunk]^T,
//         in float32 registers (2 x D/64 mma tiles, at most 16 for D <= 1024).
//   * bfloat16 runs mma.sync m16n8k16 with float32 accumulators, W1's and
//     W2's fragments read straight from device memory (L2-resident);
//     float32 runs FMA loops with the same ownership.
//   * Plain: no TMA, no wgmma, no software pipelining; 32 rows per block
//     means every weight element is read from L2 once per 32 rows.  Those
//     are later work; the time is in PERF.md.

#include "ln_tile.cuh"

namespace {

using namespace ln_tile;

constexpr int HC = 64;          // hidden columns per chunk (8 per warp)
constexpr int MAX_NT = 16;      // output n8 tiles per warp: D <= 1024
constexpr int LDH = HC + PAD;

enum Act { GELU = 0, GELU_TANH = 1, QUICK_GELU = 2 };

template <int ACT>
__device__ __forceinline__ float activate(float x) {
  if constexpr (ACT == GELU) {
    // jax.nn.gelu(approximate=False): x * (erf(x / sqrt(2)) + 1) / 2
    return x * (erff(x * 0.70710678118654752f) + 1.f) * 0.5f;
  } else if constexpr (ACT == GELU_TANH) {
    // jax.nn.gelu(approximate=True)
    const float u = 0.79788456080286536f * (x + 0.044715f * (x * x * x));
    return x * (0.5f * (1.f + tanhf(u)));
  } else {
    // x * sigmoid(1.702 x)
    return x / (1.f + expf(-1.702f * x));
  }
}

template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS)
mlp_block_kernel(const T* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ b, const T* __restrict__ w1,
                 const float* __restrict__ b1, const T* __restrict__ w2,
                 const float* __restrict__ b2, T* __restrict__ out, int64_t R, int D,
                 int HD, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldy = D + PAD;
  T* sY = reinterpret_cast<T*>(smem_raw);   // [BM][ldy]
  T* sH = sY + BM * ldy;                    // [BM][LDH]
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  stage_ln_rows<T>(sY, ldy, x, row0, R, D, g, b, eps);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4;
  const int t = lane % 4;
  const int nt_o = D / 64;               // n8 tiles of output per warp
  const int o0 = warp * (D / WARPS);     // first output column of the warp

  float acc[2][MAX_NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  for (int hc = 0; hc < HD; hc += HC) {
    __syncthreads();   // sY staged; the previous chunk's sH reads are done
    float hacc[2][1][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) hacc[mt][0][i] = 0.f;
    const int hn0 = hc + warp * 8;
    warp_tile_product<T, 2, 1>(hacc, sY, ldy, w1, D, hn0, HD, D, 1);
    const int hn = hn0 + 2 * t;
    const float bb0 = b1[hn], bb1 = b1[hn + 1];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store_pair<T>(sH + (mt * 16 + gr + 8 * h) * LDH + warp * 8 + 2 * t,
                      activate<ACT>(hacc[mt][0][2 * h] + bb0),
                      activate<ACT>(hacc[mt][0][2 * h + 1] + bb1));
    __syncthreads();
    warp_tile_product<T, 2, MAX_NT>(acc, sH, LDH, w2 + hc, HD, o0, D, HC, nt_o);
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt) {
      if (nt >= nt_o) continue;
      const int n = o0 + nt * 8 + 2 * t;
      const float c0 = b2[n], c1 = b2[n + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t r = row0 + mt * 16 + gr + 8 * h;
        if (r < R)
          store_pair<T>(out + r * D + n, acc[mt][nt][2 * h] + c0, acc[mt][nt][2 * h + 1] + c1);
      }
    }
}

template <typename T, int ACT>
cudaError_t launch(const void* x, const float* g, const float* b, const void* w1,
                   const float* b1, const void* w2, const float* b2, void* out, int64_t R,
                   int D, int HD, float eps, cudaStream_t stream) {
  const int smem = BM * (D + PAD + LDH) * (int)sizeof(T);
  auto kernel = mlp_block_kernel<T, ACT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((R + BM - 1) / BM));
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), g, b, static_cast<const T*>(w1), b1,
      static_cast<const T*>(w2), b2, static_cast<T*>(out), R, D, HD, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_act(int act, const void* x, const float* g, const float* b,
                       const void* w1, const float* b1, const void* w2, const float* b2,
                       void* out, int64_t R, int D, int HD, float eps, cudaStream_t s) {
  if (act == GELU) return launch<T, GELU>(x, g, b, w1, b1, w2, b2, out, R, D, HD, eps, s);
  if (act == GELU_TANH)
    return launch<T, GELU_TANH>(x, g, b, w1, b1, w2, b2, out, R, D, HD, eps, s);
  if (act == QUICK_GELU)
    return launch<T, QUICK_GELU>(x, g, b, w1, b1, w2, b2, out, R, D, HD, eps, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; act: 0 = gelu, 1 = gelu_tanh,
// 2 = quick_gelu.  Returns a cudaError_t (0 = launched).  The caller checks
// shapes (D % 64 == 0, D <= 1024, HD % 64 == 0), dtypes, contiguity and
// 16-byte alignment.
extern "C" int cosmos_mlp_block_fwd(const void* x, const void* g, const void* b,
                                    const void* w1, const void* b1, const void* w2,
                                    const void* b2, void* out, int64_t R, int D, int HD,
                                    float eps, int dtype, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* bf = static_cast<const float*>(b);
  const float* b1f = static_cast<const float*>(b1);
  const float* b2f = static_cast<const float*>(b2);
  if (dtype == 0)
    return launch_act<float>(act, x, gf, bf, w1, b1f, w2, b2f, out, R, D, HD, eps, s);
  if (dtype == 1)
    return launch_act<__nv_bfloat16>(act, x, gf, bf, w1, b1f, w2, b2f, out, R, D, HD, eps, s);
  return (int)cudaErrorInvalidValue;
}
