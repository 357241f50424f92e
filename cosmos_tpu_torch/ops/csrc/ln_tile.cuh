// Shared device code of the fused LayerNorm -> matmul kernels (K5,
// ln_matmul.cu) and the fused MLP block (K6, mlp_block.cu).
//
// row_stats (finish_stats) and ln_value give the JAX kernels'
// normalisation: float32 single-pass statistics (E[x^2] - E[x]^2, clamped
// at 0), then y = ((x - mean) * rstd) * g + b in float32 with every step
// rounded (no FMA contraction), rounded to the compute dtype before the
// product.  Every kernel sums a row in the same order (each lane its
// columns lane * 16 / sizeof(T) + 512 / sizeof(T) * i in increasing order,
// then the warp's butterfly), so the normalised rows are the same bits
// whatever the kernel.
//
// The float32 kernels stage BM rows at a time with stage_ln_rows (a block
// of THREADS threads) and multiply them by rows of a weight matrix read
// from device memory (torch's [out, in] layout: the reduction axis is
// contiguous) with warp_tile_product: FMA loops, float32 accumulation, no
// TF32.  The bfloat16 kernels run on Hopper's wgmma (hopper.cuh).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace ln_tile {

constexpr int THREADS = 256;   // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int BM = 32;         // rows per block: two m16 tiles
constexpr int PAD = 8;         // row padding of shared tiles, in elements

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }


__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (mean, rstd) from one warp's lane sums of x and x^2 over a row of D
__device__ __forceinline__ float2 finish_stats(float s, float ss, int D, float eps) {
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mean = __fdiv_rn(s, (float)D);
  const float var = fmaxf(__fsub_rn(__fdiv_rn(ss, (float)D), __fmul_rn(mean, mean)), 0.f);
  return make_float2(mean, rsqrtf(var + eps));
}

// (mean, rstd) of row xr (D elements, 16-byte aligned, D % (16 /
// sizeof(T)) == 0) by one warp: lane-strided 16-byte loads, up to 4 of
// them in flight, float32 single pass (each lane sums its columns in
// increasing order; padding adds exact zeros)
template <typename T>
__device__ __forceinline__ float2 row_stats(const T* __restrict__ xr, int D, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int STEP = 32 * VEC;
  constexpr int U = 4;
  const int lane = threadIdx.x % 32;
  float s = 0.f, ss = 0.f;
  for (int c0 = lane * VEC; c0 < D; c0 += U * STEP) {
    uint4 raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      raw[u] = c0 + u * STEP < D ? *reinterpret_cast<const uint4*>(xr + c0 + u * STEP)
                                 : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const T* e = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float v = to_f32(e[k]);
        s += v;
        ss += __fmul_rn(v, v);
      }
    }
  }
  return finish_stats(s, ss, D, eps);
}

// ((x - mean) * rstd) * g + b, every step rounded
__device__ __forceinline__ float ln_value(float x, float2 st, float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, st.x), st.y), g), b);
}

// Rows [row0, row0 + BM) of x ([R, D], float32) normalised with scale g
// and shift b (float32 [D]) into sY ([BM][ldy]).  Rows past R are zeros.
// D % 4 == 0; every pointer 16-byte aligned.
__device__ __forceinline__ void stage_ln_rows(float* sY, int ldy, const float* __restrict__ x,
                                              int64_t row0, int64_t R, int D,
                                              const float* __restrict__ g,
                                              const float* __restrict__ b, float eps) {
  constexpr int VEC = 4;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += WARPS) {
    float* dst = sY + r * ldy;
    const int64_t row = row0 + r;
    if (row >= R) {
      for (int c = lane * VEC; c < D; c += 32 * VEC)
        *reinterpret_cast<uint4*>(dst + c) = make_uint4(0, 0, 0, 0);
      continue;
    }
    const float* xr = x + row * D;
    const float2 st = row_stats(xr, D, eps);
    for (int c = lane * VEC; c < D; c += 32 * VEC) {
      const float4 v = *reinterpret_cast<const float4*>(xr + c);
      *reinterpret_cast<float4*>(dst + c) =
          make_float4(ln_value(v.x, st, g[c], b[c]), ln_value(v.y, st, g[c + 1], b[c + 1]),
                      ln_value(v.z, st, g[c + 2], b[c + 2]), ln_value(v.w, st, g[c + 3], b[c + 3]));
    }
  }
}

// acc[mt][nt] += A[mt*16 .. +16, 0..K) * B[n0 + nt*8 .. +8, 0..K)^T for
// mt < MT and nt < nt_used (<= NT), float32 FMAs.  A: shared, row stride
// lda; B: device memory, row stride ldb, rows at or past N read as zeros.
// Thread (g = lane / 4, t = lane % 4) owns, in each 16x8 tile, rows g and
// g + 8 and columns 2t and 2t + 1 (the mma.sync accumulator layout):
// acc[..][0..1] row g, acc[..][2..3] row g + 8.
template <int MT, int NT>
__device__ __forceinline__ void warp_tile_product(float (&acc)[MT][NT][4], const float* sA,
                                                  int lda, const float* __restrict__ B,
                                                  int ldb, int n0, int N, int K,
                                                  int nt_used) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  for (int k = 0; k < K; ++k) {
    float a0[MT], a1[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      a0[mt] = sA[(mt * 16 + g) * lda + k];
      a1[mt] = sA[(mt * 16 + g + 8) * lda + k];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt < nt_used) {
        const int n = n0 + nt * 8 + 2 * t;
        const float b0 = n < N ? __ldg(B + (int64_t)n * ldb + k) : 0.f;
        const float b1 = n + 1 < N ? __ldg(B + (int64_t)(n + 1) * ldb + k) : 0.f;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          acc[mt][nt][0] = fmaf(a0[mt], b0, acc[mt][nt][0]);
          acc[mt][nt][1] = fmaf(a0[mt], b1, acc[mt][nt][1]);
          acc[mt][nt][2] = fmaf(a1[mt], b0, acc[mt][nt][2]);
          acc[mt][nt][3] = fmaf(a1[mt], b1, acc[mt][nt][3]);
        }
      }
    }
  }
}

// Store two neighbouring values at p (p 8-byte aligned).
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

}  // namespace ln_tile
