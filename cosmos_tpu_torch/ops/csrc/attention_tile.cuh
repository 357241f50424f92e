// Shared device code of the bf16 tensor-core paths of the packed-QKV
// attention forward (K1, fused_attention_fwd.cu) and backward (K2,
// fused_attention_bwd.cu).
//
// Tiles are bf16 in shared memory, ROWS rows of DH elements with a row
// stride of DH + PAD elements.  The pad of 16 bytes puts the 8 rows that one
// ldmatrix phase reads into 8 different 16-byte bank groups, so fragment
// loads have no bank conflicts.  Tiles arrive by cp.async (16 bytes a
// thread, rows past the sequence zero-filled) and leave through the
// tensor cores' mma.sync m16n8k16 (bf16 inputs, float32 accumulation).
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 g + t.
//   A (16 x 16, row-major) a[0]: row g, cols 2t, 2t+1; a[1]: row g+8;
//     a[2]: row g, cols 2t+8, 2t+9; a[3]: row g+8, cols 2t+8, 2t+9.
//   B (16 x 8) b[0]: k rows 2t, 2t+1 of col g; b[1]: k rows 2t+8, 2t+9.
//   C (16 x 8, float32) c[0], c[1]: row g, cols 2t, 2t+1; c[2], c[3]: row g+8.
// Two neighbouring C tiles of 8 columns therefore hold exactly the A
// fragment of a 16-deep product over those 16 columns (pack_a): softmax
// probabilities and gradients go from one product into the next without
// leaving registers.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace attn_tile {

using bf16 = __nv_bfloat16;

constexpr int ROWS = 64;       // rows of a query or key tile
constexpr int WARPS = 4;       // 16 rows each
constexpr int THREADS = 32 * WARPS;
constexpr int PAD = 8;         // row padding of shared tiles, in elements

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (src
// must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// 4 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until every cp.async group this thread committed has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy `valid` rows (<= ROWS) of DH bf16 from g (row stride ld elements)
// into the shared tile s (row stride DH + PAD); rows past `valid` become
// zeros.  valid >= 1.  Every thread of the block takes part.
template <int DH>
__device__ __forceinline__ void cp_async_tile(bf16* s, const bf16* g, int64_t ld, int valid) {
  constexpr int VPR = DH / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < ROWS * VPR; i += THREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * 8;
    const bool ok = r < valid;
    cp_async16(s + r * (DH + PAD) + c, g + (ok ? r : 0) * ld + c, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// A fragment of the 16 x 16 block at column kk of a row-major tile whose
// first row is s (row stride ld)
__device__ __forceinline__ void lds_a(uint32_t (&a)[4], const bf16* s, int ld, int kk) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(a, s + (lane % 16) * ld + kk + (lane / 16) * 8);
}

// B fragments of two 8-column tiles (b[0..1]: columns n0..n0+7, b[2..3]:
// n0+8..n0+15) of the product X Y^T at depth kk..kk+15, from Y stored
// row-major as [n][k] (a K tile for Q K^T): no transpose needed
__device__ __forceinline__ void lds_b(uint32_t (&b)[4], const bf16* s, int ld, int n0, int kk) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(b, s + (n0 + lane % 8 + (lane / 16) * 8) * ld + kk + ((lane / 8) % 2) * 8);
}

// B fragments of two 8-column tiles (as lds_b) of the product X Y at depth
// k0..k0+15, from Y stored row-major as [k][n] (a V tile for P V):
// ldmatrix.trans
__device__ __forceinline__ void lds_b_trans(uint32_t (&b)[4], const bf16* s, int ld, int k0,
                                            int n0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_trans(b, s + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * ld + n0 + (lane / 16) * 8);
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// C tiles 2j and 2j+1 (16 x 8 each) -> the A fragment j of a product whose
// depth runs over their 16 columns, rounded to bf16
template <int NT>
__device__ __forceinline__ void pack_a(uint32_t (&a)[NT / 2][4], const float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    a[j][0] = pack_bf16(c[2 * j][0], c[2 * j][1]);
    a[j][1] = pack_bf16(c[2 * j][2], c[2 * j][3]);
    a[j][2] = pack_bf16(c[2 * j + 1][0], c[2 * j + 1][1]);
    a[j][3] = pack_bf16(c[2 * j + 1][2], c[2 * j + 1][3]);
  }
}

// Row reductions over the four lanes (t = 0..3) that share a C row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The A operand of a warp's 16 rows x DH, resident in shared memory.  With
// HOLD its fragments are loaded once and kept in registers (4 * DH / 16 of
// them); without, each product reloads them by ldmatrix, which leaves the
// registers to the accumulators (used at DH = 128).
template <int DH, bool HOLD>
struct WarpRows {
  uint32_t frag[HOLD ? DH / 16 : 1][4];
  const bf16* rows;

  __device__ __forceinline__ void init(const bf16* s) {
    rows = s;
    if constexpr (HOLD) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) lds_a(frag[kk], rows, DH + PAD, kk * 16);
    }
  }

  __device__ __forceinline__ void get(int kk, uint32_t (&a)[4]) const {
    if constexpr (HOLD) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = frag[kk][i];
    } else {
      lds_a(a, rows, DH + PAD, kk * 16);
    }
  }
};

// acc[nt] += X Y^T over depth DH for the warp's 16 rows of X (x) and the
// NT * 8 rows of Y stored row-major [n][DH] at sY: Q K^T, dO V^T, K Q^T, V dO^T
template <int DH, int NT, bool HOLD>
__device__ __forceinline__ void product_xyt(float (&acc)[NT][4], const WarpRows<DH, HOLD>& x,
                                            const bf16* sY) {
  static_assert(NT % 2 == 0, "B fragments come in pairs of 8-column tiles");
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t a[4];
    x.get(kk, a);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      lds_b(b, sY, DH + PAD, np * 16, kk * 16);
      mma_16816(acc[2 * np], a, b[0], b[1]);
      mma_16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc[dt] += P Y over depth 16 * KC, P given as A fragments (pack_a) and Y
// stored row-major [k][DH] at sY (its first KC * 16 rows): P V, dS K, P^T dO,
// dS^T Q
template <int DH, int KC>
__device__ __forceinline__ void product_py(float (&acc)[DH / 8][4], const uint32_t (&p)[KC][4],
                                           const bf16* sY) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      uint32_t b[4];
      lds_b_trans(b, sY, DH + PAD, kc * 16, dp * 16);
      mma_16816(acc[2 * dp], p[kc], b[0], b[1]);
      mma_16816(acc[2 * dp + 1], p[kc], b[2], b[3]);
    }
  }
}

// Write a warp's 16 x DH float32 accumulator, rounded to bf16, into its own
// rows of the shared tile s (row stride DH + PAD), then store the rows that
// lie before `valid` to g (row stride ld elements) with 16-byte writes.
// Only the calling warp reads or writes these rows.
template <int DH>
__device__ __forceinline__ void store_warp_rows(bf16* g, int64_t ld, bf16* s,
                                                const float (&acc)[DH / 8][4], float scale0,
                                                float scale1, int valid) {
  constexpr int LD = DH + PAD;
  constexpr int VPR = DH / 8;
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4;
  const int t = lane % 4;
  __syncwarp();
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt) {
    bf16* p = s + gr * LD + dt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(acc[dt][0] * scale0, acc[dt][1] * scale0);
    *reinterpret_cast<uint32_t*>(p + 8 * LD) =
        pack_bf16(acc[dt][2] * scale1, acc[dt][3] * scale1);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * VPR; i += 32) {
    const int r = i / VPR;
    const int c = (i % VPR) * 8;
    if (r < valid)
      *reinterpret_cast<uint4*>(g + r * ld + c) =
          *reinterpret_cast<const uint4*>(s + r * LD + c);
  }
}

}  // namespace attn_tile
