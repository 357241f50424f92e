// Packed-QKV fused attention backward for Hopper (sm_90a).
//
// Replaces cosmos_tpu/ops/fused_attention.py::_bwd_kernel (launched by
// _bwd_pallas) and ::_bwd_kernel_hg (launched by _bwd_pallas_hg behind
// BWD_HEAD_GRID), which compute the same function on two TPU schedules.
// Given the packed [B, L, 3D] projection output qkv (q | k | v thirds, head
// h at columns [h*Dh, (h+1)*Dh) of each third) and the gradient dout of the
// [B, L, D] attention output, it writes the packed d(qkv) [B, L, 3D] with
// dq, dk and dv in their thirds.  Per head, with the TPU kernel's rounding
// points (T is the input dtype, every product accumulates in float32):
//     s  = q k^T * scale                  (scale = Dh^-1/2, causal: col > row masked)
//     P  = softmax(s)                     (float32, recomputed)
//     dv = T(P)^T dout
//     dP = dout v^T
//     ds = T(P * (dP - rowsum(dP * P)) * scale)
//     dq = ds k,   dk = ds^T q
//
// What bounds it.  The work is 10*B*L^2*D operations against
// 7*B*L*D*itemsize bytes (qkv and dout read once, d(qkv) written once; the
// TPU kernel's _cost, fused_attention.py:287-301; causal counts the lower
// triangle).  At the CLIP lengths (L = 32..197) that is about 1.4*L/itemsize
// operations per byte: 140 at L = 197 in bf16, under the ~295 at which an
// H100 stops being memory bound.  So the design keeps P, dP and ds out of
// device memory altogether (they are recomputed per tile in registers) and
// writes only d(qkv) plus three float32 numbers per row.
//
// Schedule (two launches, deterministic, no atomics).  Blocks run in no
// order, so the TPU kernel's sequential whole-row schedule becomes two
// passes, each a loop inside one block:
//   * Pass A, one block per (query tile of 64, head, batch row).  Loop 1
//     over the key tiles computes, online, the row max m, the row sum l and
//     delta = sum_j P_ij dP_ij from float32 P (the TPU kernel's form,
//     fused_attention.py:211, not dout . o from the rounded output).  Loop
//     2 recomputes s and dP per key tile, forms ds, rounds it to T and
//     accumulates dq = ds k in float32.  dq is written, and so are m, l and
//     delta to a float32 workspace [3, B, H, L].
//   * Pass B, one block per (key tile of 64, head, batch row).  It keeps the
//     K and V tile, streams the query tiles (causal: only the tiles at or
//     below the diagonal), recomputes P from the saved m and l and ds from
//     the saved delta, and accumulates dv = T(P)^T dout and dk = ds^T q in
//     float32.
//   * Every element of d(qkv) is written exactly once, by one block, in a
//     fixed order of sums: two launches on the same inputs give the same
//     bits.  Rows past L are zero-filled and masked (P = 0), so any L >= 1
//     works and nothing bounds L.
//
// bfloat16 (the training path): tensor cores, 4 warps of 16 rows per block.
//   * Pass A: the Q and dO tiles are copied once with cp.async; their A
//     fragments stay in registers at Dh 64 (at Dh 128 they are reloaded
//     from shared memory per product, which leaves the registers to the
//     accumulators).  K and V tiles are bf16, double-buffered with cp.async
//     through both loops (the copy of the next tile, or of loop 2's first,
//     is in flight while a tile is computed).  S = Q K^T and dP = dO V^T run
//     on mma.sync m16n8k16 with float32 accumulation.  Loop 2 rounds ds to
//     bf16 straight into A fragments (attention_tile.cuh, pack_a) and
//     accumulates dq += ds K with K's B fragments from ldmatrix.trans.
//     exp(scale * (s - m)) is one FMA and one exp2 on the unscaled logits
//     (scale and log2(e) folded into the FMA; the workspace keeps m in
//     those units), and only the tiles that hold masked keys mask.
//   * Pass B: keys are the rows.  Per 16 queries of a streamed tile it
//     computes S^T = K Q^T and dP^T = V dO^T, so P^T and ds^T land in the
//     accumulator layout, which is the A-fragment layout of dV += T(P^T) dO
//     and dK += T(ds^T) Q: neither goes through shared memory.  Q, dO and
//     the row statistics of the next query tile are in flight (cp.async)
//     while a tile is computed.
//   * P in pass B is S^T on the tensor cores, not pass A's S: the two sums
//     run over the same products in the same order of 16-deep steps, but
//     the hardware need not add them in the same order inside a step, so P
//     and ds may differ between the passes in the last float32 bit.  Each
//     pass is deterministic on its own, and the result is within the same
//     tolerance of the plain version.
// float32: FMA loops on the CUDA cores (float32 stays float32, no TF32),
// 128 threads per block in pass A, 128 (Dh 64) or 256 (Dh 128) in pass B;
// tiles staged as float32 in shared memory.  Both passes compute s and dP
// with the same sequential FMA order over the head dim and round s * scale
// on its own (__fmul_rn, never contracted into the exp's argument), so P
// and ds are bit-identical in the two passes.
//
// Softmax difference.  As in the forward (fused_attention_fwd.cu): P here is
// max-subtracted, the TPU kernel's _softmax_rows is max-free with a clamp at
// 80; the two agree except for rows whose every unmasked logit is below
// about -88 or above 80.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int TX = 8;         // threads sharing one row of a 64 x 64 tile (float32)
constexpr int LDP = BK + 1;   // padded row stride of the P and ds tiles (float32)
constexpr int ROWS_THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(BQ == attn_tile::ROWS && BK == attn_tile::ROWS, "tile rows");

__device__ __forceinline__ bool masked(int row, int col, int L, int causal) {
  return col >= L || (causal && col > row);
}

// ---------------------------------------------------------------- bfloat16

template <int DH>
constexpr int tc_rows_smem_bytes() {
  // Q and dO tiles, then two stages of (K tile, V tile)
  return 6 * BQ * (DH + attn_tile::PAD) * (int)sizeof(__nv_bfloat16);
}

template <int DH>
constexpr int tc_cols_smem_bytes() {
  // K and V tiles, two stages of (Q tile, dO tile), two stages of (m, l, delta)
  return 6 * BQ * (DH + attn_tile::PAD) * (int)sizeof(__nv_bfloat16) +
         2 * 3 * BQ * (int)sizeof(float);
}

// Pass A: dq, and the row statistics (m, l, delta) for pass B.
template <int DH>
__global__ void __launch_bounds__(attn_tile::THREADS)
attention_bwd_rows_kernel_tc(const __nv_bfloat16* __restrict__ qkv,
                             const __nv_bfloat16* __restrict__ dout,
                             __nv_bfloat16* __restrict__ dqkv, float* __restrict__ ws, int L,
                             int H, float scale, int causal) {
  using attn_tile::bf16;
  constexpr int LD = DH + attn_tile::PAD;
  constexpr int TILE = BQ * LD;
  constexpr int NT = BK / 8;               // 8-key column tiles of S and dP
  constexpr bool HOLD = DH == 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]; stages dq
  bf16* sDO = sQ + TILE;                         // [BQ][LD]
  bf16* sKV = sDO + TILE;                        // [2][K, V][BK][LD]

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = H * DH;
  const int64_t ld = 3 * (int64_t)D;
  const bf16* base = qkv + (int64_t)b * L * ld + (int64_t)h * DH;
  const bf16* dbase = dout + (int64_t)b * L * D + (int64_t)h * DH;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = q0 + warp * 16 + g;  // query row of c[0..1]; row0 + 8 of c[2..3]
  // exp(scale * (s - m)) = exp2(s * scale_log2 - m * scale_log2): one FMA
  // and one exp2 per element on the unscaled logits
  const float scale_log2 = scale * LOG2E;

  const int nkt = causal ? qt + 1 : (L + BK - 1) / BK;
  // loop 1 then loop 2 walk the key tiles 0..nkt-1 each; tile `it` of the
  // 2 * nkt in that walk lives in stage it % 2
  auto load_kv = [&](int it) {
    const int k0 = (it % nkt) * BK;
    bf16* sK = sKV + (it % 2) * 2 * TILE;
    attn_tile::cp_async_tile<DH>(sK, base + D + k0 * ld, ld, min(BK, L - k0));
    attn_tile::cp_async_tile<DH>(sK + TILE, base + 2 * D + k0 * ld, ld, min(BK, L - k0));
  };

  attn_tile::cp_async_tile<DH>(sQ, base + q0 * ld, ld, min(BQ, L - q0));
  attn_tile::cp_async_tile<DH>(sDO, dbase + q0 * D, D, min(BQ, L - q0));
  load_kv(0);
  attn_tile::cp_async_commit();

  attn_tile::WarpRows<DH, HOLD> q, dO;
  float m[2] = {-INFINITY, -INFINITY};  // row max of the unscaled logits
  float l[2] = {0.f, 0.f};      // this lane's share of the row sums
  float acc[2] = {0.f, 0.f};    // this lane's share of sum_j exp(s - m) dP

  // a warp whose rows all lie past L (in the last query tile) skips its
  // products: its rows are never stored
  const bool active = q0 + warp * 16 < L;

  // S (unscaled, masked) and dP of key tile `it` for the warp's 16 rows
  auto tile_products = [&](int it, float (&s)[NT][4], float (&dp)[NT][4]) {
    attn_tile::cp_async_wait_all();
    __syncthreads();  // tile `it` has landed; every warp is done with tile it - 1
    if (it + 1 < 2 * nkt) {
      load_kv(it + 1);
      attn_tile::cp_async_commit();
    }
    if (it == 0) {
      q.init(sQ + warp * 16 * LD);
      dO.init(sDO + warp * 16 * LD);
    }
    const bf16* sK = sKV + (it % 2) * 2 * TILE;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    if (active) {
      attn_tile::product_xyt<DH, NT>(s, q, sK);
      attn_tile::product_xyt<DH, NT>(dp, dO, sK + TILE);
    }
    // only the tiles that hold masked keys (the ragged last one, the
    // causal diagonal) mask
    const int k0 = (it % nkt) * BK;
    if (k0 + BK > L || (causal && k0 == q0)) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (masked(row0 + (e / 2) * 8, k0 + nt * 8 + 2 * t + (e % 2), L, causal))
            s[nt][e] = -INFINITY;
    }
  };

  // loop 1: row max, row sum and sum_j exp(s - m) dP, online
  for (int it = 0; it < nkt; ++it) {
    float s[NT][4], dp[NT][4];
    tile_products(it, s, dp);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
    float ms[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], attn_tile::quad_max(mx[i]));
      // key 0 is unmasked for every row, so m_new is finite from the first
      // tile on; the guard keeps exp(-inf - -inf) out all the same
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f((m[i] - m_use) * scale_log2);
      l[i] *= alpha;
      acc[i] *= alpha;
      ms[i] = m_use * scale_log2;
      m[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[nt][e], scale_log2, -ms[e / 2]));
        l[e / 2] += p;
        acc[e / 2] = fmaf(p, dp[nt][e], acc[e / 2]);
      }
  }
  // ms: the row max in exp2's units, as pass A's loop 2 and pass B use it
  float delta[2], ms[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = attn_tile::quad_sum(l[i]);
    delta[i] = attn_tile::quad_sum(acc[i]) / l[i];
    ms[i] = m[i] * scale_log2;
  }

  // loop 2: ds per key tile, dq = ds k
  float dq[DH / 8][4];
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[dt][e] = 0.f;
  for (int it = nkt; it < 2 * nkt; ++it) {
    float s[NT][4], dp[NT][4];
    tile_products(it, s, dp);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        // masked logits are -inf: p == 0, ds == 0
        const float p = exp2f(fmaf(s[nt][e], scale_log2, -ms[i])) / l[i];
        s[nt][e] = p * (dp[nt][e] - delta[i]) * scale;
      }
    // keys past L have ds == 0 and zero rows of K
    uint32_t ds[NT / 2][4];
    attn_tile::pack_a<NT>(ds, s);
    if (active) attn_tile::product_py<DH, NT / 2>(dq, ds, sKV + (it % 2) * 2 * TILE);
  }

  attn_tile::store_warp_rows<DH>(
      dqkv + ((int64_t)b * L + q0 + warp * 16) * ld + (int64_t)h * DH, ld,
      sQ + warp * 16 * LD, dq, 1.f, 1.f, L - q0 - warp * 16);

  if (t == 0) {
    const int64_t plane = (int64_t)gridDim.z * H * L;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row < L) {
        const int64_t idx = ((int64_t)b * H + h) * L + row;
        ws[idx] = ms[i];
        ws[plane + idx] = l[i];
        ws[2 * plane + idx] = delta[i];
      }
    }
  }
}

// Pass B: dk and dv of one key tile, from pass A's row statistics (the row
// max in exp2's units, the row sum, delta).
template <int DH>
__global__ void __launch_bounds__(attn_tile::THREADS)
attention_bwd_cols_kernel_tc(const __nv_bfloat16* __restrict__ qkv,
                             const __nv_bfloat16* __restrict__ dout,
                             __nv_bfloat16* __restrict__ dqkv, const float* __restrict__ ws,
                             int L, int H, float scale, int causal) {
  using attn_tile::bf16;
  constexpr int LD = DH + attn_tile::PAD;
  constexpr int TILE = BQ * LD;
  constexpr bool HOLD = DH == 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [BK][LD]; stages dk
  bf16* sV = sK + TILE;                          // [BK][LD]; stages dv
  bf16* sQD = sV + TILE;                         // [2][Q, dO][BQ][LD]
  float* sStat = reinterpret_cast<float*>(sQD + 4 * TILE);  // [2][m, l, delta][BQ]

  const int kt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = H * DH;
  const int64_t ld = 3 * (int64_t)D;
  const bf16* base = qkv + (int64_t)b * L * ld + (int64_t)h * DH;
  const bf16* dbase = dout + (int64_t)b * L * D + (int64_t)h * DH;
  const int k0 = kt * BK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int key0 = k0 + warp * 16 + g;  // key row of c[0..1]; key0 + 8 of c[2..3]
  const int64_t plane = (int64_t)gridDim.z * H * L;
  const float* wsRow = ws + ((int64_t)b * H + h) * L;
  const float scale_log2 = scale * LOG2E;

  auto load_q = [&](int qt, int stage) {
    const int q0 = qt * BQ;
    const int valid = min(BQ, L - q0);
    bf16* sQt = sQD + stage * 2 * TILE;
    attn_tile::cp_async_tile<DH>(sQt, base + q0 * ld, ld, valid);
    attn_tile::cp_async_tile<DH>(sQt + TILE, dbase + q0 * D, D, valid);
    float* st = sStat + stage * 3 * BQ;
    for (int i = threadIdx.x; i < 3 * BQ; i += attn_tile::THREADS) {
      const int r = i % BQ;
      const bool ok = r < valid;
      attn_tile::cp_async4(st + i, wsRow + (i / BQ) * plane + q0 + (ok ? r : 0), ok);
    }
  };

  const int nqt = (L + BQ - 1) / BQ;
  const int qt0 = causal ? kt : 0;
  attn_tile::cp_async_tile<DH>(sK, base + D + k0 * ld, ld, min(BK, L - k0));
  attn_tile::cp_async_tile<DH>(sV, base + 2 * D + k0 * ld, ld, min(BK, L - k0));
  load_q(qt0, 0);
  attn_tile::cp_async_commit();

  attn_tile::WarpRows<DH, HOLD> k, v;
  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;

  for (int qt = qt0; qt < nqt; ++qt) {
    const int stage = (qt - qt0) % 2;
    attn_tile::cp_async_wait_all();
    __syncthreads();  // tile qt has landed; every warp is done with tile qt - 1
    if (qt + 1 < nqt) {
      load_q(qt + 1, 1 - stage);
      attn_tile::cp_async_commit();
    }
    if (qt == qt0) {
      k.init(sK + warp * 16 * LD);
      v.init(sV + warp * 16 * LD);
    }
    const bf16* sQt = sQD + stage * 2 * TILE;
    const bf16* sDOt = sQt + TILE;
    const float* sM = sStat + stage * 3 * BQ;
    const float* sL = sM + BQ;
    const float* sD = sL + BQ;
    const int q0 = qt * BQ;

    // 16 queries at a time: S^T and dP^T are 16 keys x 16 queries
#pragma unroll 1
    for (int c = 0; c < BQ / 16; ++c) {
      const int qc = q0 + c * 16;
      // warp-uniform: no key of the warp or no query of this chunk is
      // valid, or (causal) every query of it lies before every key of the
      // warp
      if (k0 + warp * 16 >= L || qc >= L || (causal && qc + 15 < k0 + warp * 16)) continue;
      float s[2][4], dp[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
      attn_tile::product_xyt<DH, 2>(s, k, sQt + c * 16 * LD);
      attn_tile::product_xyt<DH, 2>(dp, v, sDOt + c * 16 * LD);
      float p[2][4], ds[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = c * 16 + nt * 8 + 2 * t + (e % 2);  // query within the tile
          const int key = key0 + (e / 2) * 8;
          const bool off = q0 + r >= L || masked(q0 + r, key, L, causal);
          p[nt][e] = off ? 0.f : exp2f(fmaf(s[nt][e], scale_log2, -sM[r])) / sL[r];
          ds[nt][e] = p[nt][e] * (dp[nt][e] - sD[r]) * scale;
        }
      uint32_t pa[1][4], dsa[1][4];
      attn_tile::pack_a<2>(pa, p);
      attn_tile::pack_a<2>(dsa, ds);
      attn_tile::product_py<DH, 1>(dv, pa, sDOt + c * 16 * LD);
      attn_tile::product_py<DH, 1>(dk, dsa, sQt + c * 16 * LD);
    }
  }

  bf16* out = dqkv + ((int64_t)b * L + k0 + warp * 16) * ld + (int64_t)h * DH;
  attn_tile::store_warp_rows<DH>(out + D, ld, sK + warp * 16 * LD, dk, 1.f, 1.f,
                                 L - k0 - warp * 16);
  attn_tile::store_warp_rows<DH>(out + 2 * D, ld, sV + warp * 16 * LD, dv, 1.f, 1.f,
                                 L - k0 - warp * 16);
}

// ------------------------------------------------------------------ float32

// Load `valid` rows (of 64) of DH floats, row stride `ld` elements, into a
// shared tile with row stride DH + 1; rows past `valid` become 0.
template <int DH, int THREADS>
__device__ __forceinline__ void load_tile(float* s, const float* g, int64_t ld, int valid) {
  constexpr int LDS = DH + 1;
  constexpr int VPR = DH / 4;
  for (int i = threadIdx.x; i < BQ * VPR; i += THREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) v = *reinterpret_cast<const float4*>(g + r * ld + c);
    float* dst = s + r * LDS + c;
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
}

// Store `valid` rows of a shared tile to global memory.
template <int DH, int THREADS>
__device__ __forceinline__ void store_tile(float* g, int64_t ld, const float* s, int valid) {
  constexpr int LDS = DH + 1;
  constexpr int VPR = DH / 4;
  for (int i = threadIdx.x; i < BQ * VPR; i += THREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * 4;
    if (r < valid) {
      const float* src = s + r * LDS + c;
      *reinterpret_cast<float4*>(g + r * ld + c) = make_float4(src[0], src[1], src[2], src[3]);
    }
  }
}

__device__ __forceinline__ float row_max8(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}

__device__ __forceinline__ float row_sum8(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

// acc[i][j] = sum_d a[r0 + i][d] * b[tx + TX*j][d], d ascending from 0, for
// R rows of a and 8 rows of b (both float32 tiles with row stride DH + 1).
// Both passes call this for s and dP, so the sums are bit-identical.
template <int DH, int R>
__device__ __forceinline__ void tile_dot(float (&acc)[R][TX], const float* a,
                                         const float* b, int r0, int tx) {
  constexpr int LDS = DH + 1;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < TX; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float av[R], bv[TX];
#pragma unroll
    for (int i = 0; i < R; ++i) av[i] = a[(r0 + i) * LDS + d];
#pragma unroll
    for (int j = 0; j < TX; ++j) bv[j] = b[(tx + TX * j) * LDS + d];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < TX; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int DH>
constexpr int rows_smem_bytes() {
  return (4 * BQ * (DH + 1) + BQ * LDP) * (int)sizeof(float);
}

template <int DH>
constexpr int cols_smem_bytes() {
  return (4 * BQ * (DH + 1) + 2 * BQ * LDP) * (int)sizeof(float);
}

// Pass A: dq, and the row statistics (m, l, delta) for pass B.
template <int DH>
__global__ void __launch_bounds__(ROWS_THREADS)
attention_bwd_rows_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                          float* __restrict__ dqkv, float* __restrict__ ws, int L, int H,
                          float scale, int causal) {
  constexpr int R = BQ * TX / ROWS_THREADS;  // query rows per thread (4)
  constexpr int LDS = DH + 1;
  constexpr int CPT = DH / TX;               // dq columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                // [BQ][LDS]; reused to stage dq
  float* sDO = sQ + BQ * LDS;      // [BQ][LDS]
  float* sK = sDO + BQ * LDS;      // [BK][LDS]
  float* sV = sK + BK * LDS;       // [BK][LDS]
  float* sDS = sV + BK * LDS;      // [BQ][LDP]

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = H * DH;
  const int64_t ld = 3 * (int64_t)D;
  const float* base = qkv + (int64_t)b * L * ld + (int64_t)h * DH;
  const float* dbase = dout + (int64_t)b * L * D + (int64_t)h * DH;
  const int q0 = qt * BQ;
  const int qvalid = min(BQ, L - q0);
  const int ty = threadIdx.x / TX;
  const int tx = threadIdx.x % TX;

  load_tile<DH, ROWS_THREADS>(sQ, base + q0 * ld, ld, qvalid);
  load_tile<DH, ROWS_THREADS>(sDO, dbase + q0 * D, D, qvalid);

  float m[R], l[R], acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    acc[i] = 0.f;
  }

  // loop 1: row max, row sum and sum_j exp(s - m) dP, online
  const int nkt = causal ? qt + 1 : (L + BK - 1) / BK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    const int kvalid = min(BK, L - k0);
    __syncthreads();  // the previous tile's reads are done
    load_tile<DH, ROWS_THREADS>(sK, base + D + k0 * ld, ld, kvalid);
    load_tile<DH, ROWS_THREADS>(sV, base + 2 * D + k0 * ld, ld, kvalid);
    __syncthreads();

    float s[R][TX], dp[R][TX];
    tile_dot<DH, R>(s, sQ, sK, ty * R, tx);
    tile_dot<DH, R>(dp, sDO, sV, ty * R, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty * R + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < TX; ++j) {
        float v = __fmul_rn(s[i][j], scale);
        if (masked(row, k0 + tx + TX * j, L, causal)) v = -INFINITY;
        s[i][j] = v;
        mx = fmaxf(mx, v);
      }
      const float m_new = fmaxf(m[i], row_max8(mx));
      // key 0 is unmasked for every row, so m_new is finite from the first
      // tile on; the guard keeps exp(-inf - -inf) out all the same
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float rs = 0.f, ra = 0.f;
#pragma unroll
      for (int j = 0; j < TX; ++j) {
        const float e = expf(s[i][j] - m_use);
        rs += e;
        ra = fmaf(e, dp[i][j], ra);
      }
      l[i] = l[i] * alpha + row_sum8(rs);
      acc[i] = acc[i] * alpha + row_sum8(ra);
      m[i] = m_new;
    }
  }
  float delta[R];
#pragma unroll
  for (int i = 0; i < R; ++i) delta[i] = acc[i] / l[i];

  // loop 2: ds per key tile, dq = ds k
  float dq[R][CPT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dq[i][c] = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    const int kvalid = min(BK, L - k0);
    __syncthreads();  // the previous tile's reads of sK and sDS are done
    load_tile<DH, ROWS_THREADS>(sK, base + D + k0 * ld, ld, kvalid);
    load_tile<DH, ROWS_THREADS>(sV, base + 2 * D + k0 * ld, ld, kvalid);
    __syncthreads();

    float s[R][TX], dp[R][TX];
    tile_dot<DH, R>(s, sQ, sK, ty * R, tx);
    tile_dot<DH, R>(dp, sDO, sV, ty * R, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty * R + i;
#pragma unroll
      for (int j = 0; j < TX; ++j) {
        const float p = masked(row, k0 + tx + TX * j, L, causal)
                            ? 0.f : expf(__fmul_rn(s[i][j], scale) - m[i]) / l[i];
        sDS[(ty * R + i) * LDP + tx + TX * j] = p * (dp[i][j] - delta[i]) * scale;
      }
    }
    __syncthreads();

    // keys past L have ds == 0 and zero rows of K
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float dsv[R], kv[CPT];
#pragma unroll
      for (int i = 0; i < R; ++i) dsv[i] = sDS[(ty * R + i) * LDP + k];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = sK[k * LDS + tx + TX * c];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) dq[i][c] = fmaf(dsv[i], kv[c], dq[i][c]);
    }
  }

  __syncthreads();  // every read of sQ is done
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) sQ[(ty * R + i) * LDS + tx + TX * c] = dq[i][c];
  __syncthreads();
  store_tile<DH, ROWS_THREADS>(dqkv + ((int64_t)b * L + q0) * ld + (int64_t)h * DH, ld,
                               sQ, qvalid);

  if (tx == 0) {
    const int64_t plane = (int64_t)gridDim.z * H * L;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty * R + i;
      if (row < L) {
        const int64_t idx = ((int64_t)b * H + h) * L + row;
        ws[idx] = m[i];
        ws[plane + idx] = l[i];
        ws[2 * plane + idx] = delta[i];
      }
    }
  }
}

// Pass B: dk and dv of one key tile, from pass A's row statistics.
template <int DH, int R>
__global__ void __launch_bounds__(BK * TX / R)
attention_bwd_cols_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                          float* __restrict__ dqkv, const float* __restrict__ ws, int L,
                          int H, float scale, int causal) {
  constexpr int THREADS = BK * TX / R;
  constexpr int LDS = DH + 1;
  constexpr int CPT = DH / TX;     // dk / dv columns per thread
  extern __shared__ float smem[];
  float* sK = smem;                // [BK][LDS]; reused to stage dk
  float* sV = sK + BK * LDS;       // [BK][LDS]; reused to stage dv
  float* sQ = sV + BK * LDS;       // [BQ][LDS]
  float* sDO = sQ + BQ * LDS;      // [BQ][LDS]
  float* sP = sDO + BQ * LDS;      // [BQ][LDP]: P
  float* sDS = sP + BQ * LDP;      // [BQ][LDP]: ds

  const int kt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = H * DH;
  const int64_t ld = 3 * (int64_t)D;
  const float* base = qkv + (int64_t)b * L * ld + (int64_t)h * DH;
  const float* dbase = dout + (int64_t)b * L * D + (int64_t)h * DH;
  const int k0 = kt * BK;
  const int kvalid = min(BK, L - k0);
  const int ty = threadIdx.x / TX;
  const int tx = threadIdx.x % TX;
  const int64_t plane = (int64_t)gridDim.z * H * L;
  const float* wsM = ws + ((int64_t)b * H + h) * L;
  const float* wsL = wsM + plane;
  const float* wsD = wsM + 2 * plane;

  load_tile<DH, THREADS>(sK, base + D + k0 * ld, ld, kvalid);
  load_tile<DH, THREADS>(sV, base + 2 * D + k0 * ld, ld, kvalid);

  // key rows ty*R + jj, head columns tx + TX*c
  float dk[R][CPT], dv[R][CPT];
#pragma unroll
  for (int jj = 0; jj < R; ++jj)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      dk[jj][c] = 0.f;
      dv[jj][c] = 0.f;
    }

  const int nqt = (L + BQ - 1) / BQ;
  for (int qt = causal ? kt : 0; qt < nqt; ++qt) {
    const int q0 = qt * BQ;
    const int qvalid = min(BQ, L - q0);
    __syncthreads();  // the previous tile's reads are done
    load_tile<DH, THREADS>(sQ, base + q0 * ld, ld, qvalid);
    load_tile<DH, THREADS>(sDO, dbase + q0 * D, D, qvalid);
    __syncthreads();

    // s and dP for query rows ty*R + i and key columns tx + TX*j
    float s[R][TX], dp[R][TX];
    tile_dot<DH, R>(s, sQ, sK, ty * R, tx);
    tile_dot<DH, R>(dp, sDO, sV, ty * R, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty * R + i;
      const int row = q0 + r;
      const bool rvalid = row < L;
      const float mi = rvalid ? wsM[row] : 0.f;
      const float li = rvalid ? wsL[row] : 1.f;
      const float di = rvalid ? wsD[row] : 0.f;
#pragma unroll
      for (int j = 0; j < TX; ++j) {
        const float p = (!rvalid || masked(row, k0 + tx + TX * j, L, causal))
                            ? 0.f : expf(__fmul_rn(s[i][j], scale) - mi) / li;
        sP[r * LDP + tx + TX * j] = p;
        sDS[r * LDP + tx + TX * j] = p * (dp[i][j] - di) * scale;
      }
    }
    __syncthreads();

    // dv += P^T dout, dk += ds^T q over the tile's query rows; rows past
    // L have P == ds == 0 and zero rows of q and dout
#pragma unroll 4
    for (int i = 0; i < BQ; ++i) {
      float pv[R], dsv[R], ov[CPT], qv[CPT];
#pragma unroll
      for (int jj = 0; jj < R; ++jj) {
        pv[jj] = sP[i * LDP + ty * R + jj];
        dsv[jj] = sDS[i * LDP + ty * R + jj];
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        ov[c] = sDO[i * LDS + tx + TX * c];
        qv[c] = sQ[i * LDS + tx + TX * c];
      }
#pragma unroll
      for (int jj = 0; jj < R; ++jj)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          dv[jj][c] = fmaf(pv[jj], ov[c], dv[jj][c]);
          dk[jj][c] = fmaf(dsv[jj], qv[c], dk[jj][c]);
        }
    }
  }

  __syncthreads();  // every read of sK and sV is done
#pragma unroll
  for (int jj = 0; jj < R; ++jj)
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      sK[(ty * R + jj) * LDS + tx + TX * c] = dk[jj][c];
      sV[(ty * R + jj) * LDS + tx + TX * c] = dv[jj][c];
    }
  __syncthreads();
  float* out = dqkv + ((int64_t)b * L + k0) * ld + (int64_t)h * DH;
  store_tile<DH, THREADS>(out + D, ld, sK, kvalid);
  store_tile<DH, THREADS>(out + 2 * D, ld, sV, kvalid);
}

// Both passes of one dtype and head dim: pass A (`rows`, 128 threads) then
// pass B (`cols`, cols_threads threads) on the same grid.
template <typename T>
cudaError_t launch(void (*rows)(const T*, const T*, T*, float*, int, int, float, int),
                   int smem_a,
                   void (*cols)(const T*, const T*, T*, const float*, int, int, float, int),
                   int smem_b, int cols_threads, const void* qkv, const void* dout,
                   void* dqkv, void* ws, int B, int L, int H, int Dh, int causal,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rows, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(cols, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_b);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)Dh);
  const dim3 grid((L + BQ - 1) / BQ, H, B);
  rows<<<grid, ROWS_THREADS, smem_a, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), static_cast<T*>(dqkv),
      static_cast<float*>(ws), L, H, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cols<<<grid, cols_threads, smem_b, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), static_cast<T*>(dqkv),
      static_cast<const float*>(ws), L, H, scale, causal);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_f32(const void* qkv, const void* dout, void* dqkv, void* ws, int B, int L,
                       int H, int causal, cudaStream_t stream) {
  // 4 query rows per thread in pass B at Dh 64 (128 threads), 2 at Dh 128
  // (256 threads): 2 * R * Dh / 8 float32 accumulators per thread either way
  constexpr int RB = DH == 64 ? 4 : 2;
  return launch<float>(attention_bwd_rows_kernel<DH>, rows_smem_bytes<DH>(),
                       attention_bwd_cols_kernel<DH, RB>, cols_smem_bytes<DH>(),
                       BK * TX / RB, qkv, dout, dqkv, ws, B, L, H, DH, causal, stream);
}

template <int DH>
cudaError_t launch_bf16(const void* qkv, const void* dout, void* dqkv, void* ws, int B, int L,
                        int H, int causal, cudaStream_t stream) {
  return launch<__nv_bfloat16>(attention_bwd_rows_kernel_tc<DH>, tc_rows_smem_bytes<DH>(),
                               attention_bwd_cols_kernel_tc<DH>, tc_cols_smem_bytes<DH>(),
                               attn_tile::THREADS, qkv, dout, dqkv, ws, B, L, H, DH, causal,
                               stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  ws is a float32 workspace of 3*B*H*L
// elements.  Returns a cudaError_t (0 = both passes launched).  The caller
// checks shapes, dtype, contiguity and 16-byte alignment.
extern "C" int cosmos_fused_attention_bwd(const void* qkv, const void* dout, void* dqkv,
                                          void* ws, int B, int L, int H, int Dh, int dtype,
                                          int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && Dh == 64) return launch_f32<64>(qkv, dout, dqkv, ws, B, L, H, causal, s);
  if (dtype == 0 && Dh == 128) return launch_f32<128>(qkv, dout, dqkv, ws, B, L, H, causal, s);
  if (dtype == 1 && Dh == 64) return launch_bf16<64>(qkv, dout, dqkv, ws, B, L, H, causal, s);
  if (dtype == 1 && Dh == 128) return launch_bf16<128>(qkv, dout, dqkv, ws, B, L, H, causal, s);
  return (int)cudaErrorInvalidValue;
}
