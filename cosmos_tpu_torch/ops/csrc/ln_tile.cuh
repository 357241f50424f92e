// Shared device code of the fused LayerNorm -> matmul kernels (K5,
// ln_matmul.cu) and the fused MLP block (K6, mlp_block.cu).
//
// A block of THREADS threads owns a tile of BM rows.  stage_ln_rows
// normalises those rows into shared memory in the compute dtype, exactly as
// the JAX kernels do before their dots: float32 single-pass statistics
// (E[x^2] - E[x]^2, clamped at 0), y = ((x - mean) * rstd) * g + b in
// float32, then rounded to the compute dtype.  warp_tile_product then
// multiplies a warp's rows of such a tile by rows of a weight matrix read
// from device memory (torch's [out, in] layout: the reduction axis is
// contiguous), accumulating in float32:
//   * bfloat16: mma.sync m16n8k16 on the tensor cores; A fragments from
//     shared memory, B fragments straight from device memory (the weights
//     of ViT-B fit in the 50 MB L2, and one k16 step of an output column
//     is exactly one 32-byte sector);
//   * float32: the same per-thread ownership of the 16x8 output tiles,
//     computed with FMAs (no TF32: float32 stays float32).

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

// Rows [row0, row0 + BM) of x ([R, D], compute dtype T) normalised with
// scale g and shift b (float32 [D]) into sY ([BM][ldy], T).  Rows past R
// are zeros.  D % (16 / sizeof(T)) == 0; every pointer 16-byte aligned.
template <typename T>
__device__ __forceinline__ void stage_ln_rows(T* sY, int ldy, const T* __restrict__ x,
                                              int64_t row0, int64_t R, int D,
                                              const float* __restrict__ g,
                                              const float* __restrict__ b, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += WARPS) {
    T* dst = sY + r * ldy;
    const int64_t row = row0 + r;
    if (row >= R) {
      for (int c = lane * VEC; c < D; c += 32 * VEC)
        *reinterpret_cast<uint4*>(dst + c) = make_uint4(0, 0, 0, 0);
      continue;
    }
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
    for (int c = lane * VEC; c < D; c += 32 * VEC) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
      const T* e = reinterpret_cast<const T*>(&raw);
      alignas(16) T out[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float xh = __fmul_rn(__fsub_rn(to_f32(e[k]), mean), rstd);
        out[k] = from_f32<T>(__fadd_rn(__fmul_rn(xh, g[c + k]), b[c + k]));
      }
      *reinterpret_cast<uint4*>(dst + c) = *reinterpret_cast<const uint4*>(out);
    }
  }
}

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc[mt][nt] += A[mt*16 .. +16, 0..K) * B[n0 + nt*8 .. +8, 0..K)^T for
// mt < MT and nt < nt_used (<= NT).  A: shared, row stride lda; B: device
// memory, row stride ldb, rows at or past N read as zeros.  K % 16 == 0.
// Thread (g = lane / 4, t = lane % 4) owns, in each 16x8 tile, rows g and
// g + 8 and columns 2t and 2t + 1 (the mma.sync accumulator layout):
// acc[..][0..1] row g, acc[..][2..3] row g + 8.
template <typename T, int MT, int NT>
__device__ __forceinline__ void warp_tile_product(float (&acc)[MT][NT][4], const T* sA,
                                                  int lda, const T* __restrict__ B,
                                                  int ldb, int n0, int N, int K,
                                                  int nt_used) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  if constexpr (sizeof(T) == 2) {
    for (int k = 0; k < K; k += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const T* ar = sA + (mt * 16 + g) * lda + k + 2 * t;
        a[mt][0] = ld_pair(ar);
        a[mt][1] = ld_pair(ar + 8 * lda);
        a[mt][2] = ld_pair(ar + 8);
        a[mt][3] = ld_pair(ar + 8 * lda + 8);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt < nt_used) {
          const int n = n0 + nt * 8 + g;
          uint32_t bf[2] = {0u, 0u};
          if (n < N) {
            const T* br = B + (int64_t)n * ldb + k + 2 * t;
            bf[0] = __ldg(reinterpret_cast<const unsigned int*>(br));
            bf[1] = __ldg(reinterpret_cast<const unsigned int*>(br + 8));
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16_16816(acc[mt][nt], a[mt], bf);
        }
      }
    }
  } else {
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
}

// Store two neighbouring float values as T at p (p even-aligned).
template <typename T>
__device__ __forceinline__ void store_pair(T* p, float v0, float v1) {
  if constexpr (sizeof(T) == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  }
}

}  // namespace ln_tile
