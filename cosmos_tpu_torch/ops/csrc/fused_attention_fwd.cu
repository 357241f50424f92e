// Packed-QKV fused attention forward for Hopper (sm_90a).
//
// Replaces cosmos_tpu/ops/fused_attention.py::_fwd_kernel (launched by
// _fwd_pallas).  It computes, per batch row b and head h,
//     out[b, :, h*Dh:(h+1)*Dh] = softmax(q k^T * Dh^-1/2 [+ causal]) v
// where q, k and v are read by stride from the packed [B, L, 3D] projection
// output (q | k | v thirds, head h at columns [h*Dh, (h+1)*Dh) of each
// third) and the output is the row-major [B, L, D] tensor the out
// projection consumes.  No head split, no transpose copy.
//
// What bounds it.  At the CLIP lengths (L = 16..197) the work is
// 4*B*L^2*D operations against 4*B*L*D*itemsize bytes (qkv read once,
// out written once; the TPU kernel's _cost, fused_attention.py:287-301), so
// roughly L/itemsize operations per byte: 100 at L = 197 in bf16, far below
// the ~295 operations per byte at which an H100 stops being memory bound.
// The design therefore keeps everything but the packed input and the
// output out of device memory: the logits, the probabilities and the
// running softmax state live in registers (shared memory in float32), and
// each element of q, k, v is read from device memory once per query tile
// (K/V re-reads across the <= 4 query tiles of a row hit L2).
//
// bfloat16 (the serving and training path): tensor cores.
//   * One block of 4 warps per (query tile of 64, head, batch row); each
//     warp owns 16 query rows.
//   * The Q tile is copied once with cp.async into shared memory and its
//     A fragments (ldmatrix) stay in registers for the whole key loop.
//   * K and V tiles of 64 keys are bf16 in shared memory, double-buffered:
//     the cp.async of tile t+1 is in flight while tile t is computed.  Rows
//     are padded by 16 bytes, so ldmatrix has no bank conflicts; rows past
//     L are zero-filled by the copy.
//   * S = Q K^T on mma.sync m16n8k16 with float32 accumulation, which is
//     the TPU kernel's dot_general(..., preferred_element_type=f32) on bf16
//     operands.  The online softmax (running row max and row sum, float32)
//     works on the accumulator layout, reducing over the 4 lanes of a row;
//     exp(scale * (s - m)) is one FMA and one exp2 (the scale and log2(e)
//     folded into the FMA), and only the tiles that hold masked keys (the
//     ragged last one, the causal diagonal) are masked.
//   * P = exp(s - m) is rounded to bf16 and repacked from the S
//     accumulators straight into A fragments (attention_tile.cuh, pack_a),
//     and O += P V runs on mma.sync with V's B fragments from
//     ldmatrix.trans.  Nothing of S or P goes through shared memory.
//   * The epilogue divides by the row sum, rounds, stages the warp's rows
//     in the Q tile's shared memory and stores them with 16-byte writes.
// float32: FMA loops on the CUDA cores (float32 stays float32, no TF32).
//   * One thread block per (query tile of 64, head, batch row); 128
//     threads.  Thread (ty, tx) owns query rows ty*4 .. ty*4+3 and, in a
//     64-key tile, key columns tx, tx+8, ..., tx+56; in the output, head
//     columns tx, tx+8, ... .
//   * Q, then each K and V tile, is staged into shared memory as float32
//     with 16-byte loads (rows past L read as zeros).  K and V of one key
//     tile share one buffer.  P goes through shared memory.
// Both:
//   * Softmax is online: running row max and row sum in float32; P is
//     rounded to the input dtype before P.V (as
//     `_softmax_rows(s).astype(v.dtype)` at fused_attention.py:122), the
//     P.V accumulator is float32, and the output is divided by the float32
//     row sum of the unrounded P at the end.
//   * Causal: key tiles past the query tile are skipped; inside the
//     diagonal tile, key col > query row is masked.  Any L >= 1; the ragged
//     edges of the last query and key tiles are masked.
//   * Dh in {64, 128} is a template parameter.
//
// Softmax difference.  The TPU kernel's _softmax_rows
// (fused_attention.py:73-98) skips the row max and clamps logits at 80.
// The online softmax here subtracts the running row max, which equals it
// wherever that formulation is exact; the two differ only for rows whose
// every unmasked logit is below about -88 (the TPU kernel returns a zero
// row there, this kernel the exact softmax) or above 80 (the TPU kernel
// clamps).  Rounding also differs slightly: the TPU kernel rounds the
// normalised P to the input dtype, this kernel the unnormalised exp(s - m)
// and divides by the float32 row sum at the end.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;
constexpr int RPT = 4;        // query rows per thread (float32 kernel)
constexpr int TX = 8;         // threads sharing one query row (float32 kernel)
constexpr int LDP = BK + 1;   // padded row stride of the P tile (float32 kernel)
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------- bfloat16

template <int DH>
constexpr int tc_smem_bytes() {
  // the Q tile, then two stages of (K tile, V tile)
  return 5 * BQ * (DH + attn_tile::PAD) * (int)sizeof(__nv_bfloat16);
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
fused_attention_fwd_kernel_tc(const __nv_bfloat16* __restrict__ qkv,
                              __nv_bfloat16* __restrict__ out, int L, int H, float scale,
                              int causal) {
  using namespace attn_tile;
  constexpr int LD = DH + PAD;
  constexpr int TILE = BQ * LD;
  constexpr int NT = BK / 8;     // 8-key column tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]; stages the output
  bf16* sKV = sQ + TILE;                         // [2][K, V][BK][LD]

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = H * DH;
  const int64_t ld = 3 * (int64_t)D;
  const bf16* base = qkv + (int64_t)b * L * ld + (int64_t)h * DH;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = q0 + warp * 16 + g;  // query row of c[0..1]; row0 + 8 of c[2..3]
  const float scale_log2 = scale * LOG2E;

  auto load_kv = [&](int kt, int stage) {
    const int k0 = kt * BK;
    bf16* sK = sKV + stage * 2 * TILE;
    cp_async_tile<DH>(sK, base + D + k0 * ld, ld, min(BK, L - k0));
    cp_async_tile<DH>(sK + TILE, base + 2 * D + k0 * ld, ld, min(BK, L - k0));
  };

  cp_async_tile<DH>(sQ, base + q0 * ld, ld, min(BQ, L - q0));
  load_kv(0, 0);
  cp_async_commit();

  WarpRows<DH, true> q;
  float o[DH / 8][4];
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  // running max of the unscaled logits and this lane's share of the row
  // sum, rows g and g + 8
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  // a warp whose rows all lie past L (in the last query tile) skips its
  // products: its rows are never stored
  const bool active = q0 + warp * 16 < L;
  const int nkt = causal ? qt + 1 : (L + BK - 1) / BK;
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // tile kt has landed; every warp is done with tile kt - 1
    if (kt + 1 < nkt) {
      load_kv(kt + 1, (kt + 1) % 2);
      cp_async_commit();
    }
    if (kt == 0) q.init(sQ + warp * 16 * LD);
    const bf16* sK = sKV + (kt % 2) * 2 * TILE;
    const bf16* sV = sK + TILE;
    const int k0 = kt * BK;

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    if (active) product_xyt<DH, NT>(s, q, sK);

    // the logits stay unscaled: the row max is taken on them, and
    // exp(scale * (s - m)) = exp2(s * scale_log2 - m * scale_log2) costs one
    // FMA and one ex2 per element; only tiles that hold masked keys mask
    if (k0 + BK > L || (causal && kt == qt)) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + nt * 8 + 2 * t + (e % 2);
          if (col >= L || (causal && col > row0 + (e / 2) * 8)) s[nt][e] = -INFINITY;
        }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
    float ms[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      // key 0 is unmasked for every row, so m_new is finite from the first
      // tile on; the guard keeps exp(-inf - -inf) out all the same
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = exp2f((m[i] - m_use) * scale_log2);
      ms[i] = m_use * scale_log2;
      m[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[nt][e], scale_log2, -ms[e / 2]));
        s[nt][e] = p;
        rs[e / 2] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // keys past L have p == 0 and zero rows of V
    uint32_t pa[NT / 2][4];
    pack_a<NT>(pa, s);
    if (active) product_py<DH, NT / 2>(o, pa, sV);
  }

  const float inv0 = 1.f / quad_sum(l[0]);
  const float inv1 = 1.f / quad_sum(l[1]);
  store_warp_rows<DH>(out + ((int64_t)b * L + q0 + warp * 16) * D + (int64_t)h * DH, D,
                      sQ + warp * 16 * LD, o, inv0, inv1, L - q0 - warp * 16);
}

// ------------------------------------------------------------------ float32

// Load `valid` rows (of BQ) of DH floats, row stride `ld` elements, into a
// shared tile with row stride LDS; rows past `valid` become 0.
template <int DH, int LDS>
__device__ __forceinline__ void load_tile(float* s, const float* g, int64_t ld, int valid) {
  constexpr int VEC = 4;
  constexpr int VPR = DH / VEC;
  for (int i = threadIdx.x; i < BQ * VPR; i += THREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * VEC;
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
template <int DH, int LDS>
__device__ __forceinline__ void store_tile(float* g, int64_t ld, const float* s, int valid) {
  constexpr int VEC = 4;
  constexpr int VPR = DH / VEC;
  for (int i = threadIdx.x; i < BQ * VPR; i += THREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * VEC;
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

template <int DH>
constexpr int f32_smem_bytes() {
  return (BQ * (DH + 1) + BK * (DH + 1) + BQ * LDP) * (int)sizeof(float);
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
fused_attention_fwd_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                           int L, int H, float scale, int causal) {
  constexpr int LDS = DH + 1;    // padded row stride of the Q and K/V tiles
  constexpr int CPT = DH / TX;   // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;              // [BQ][LDS]; reused to stage the output
  float* sKV = sQ + BQ * LDS;    // [BK][LDS]: K, then V, of one key tile
  float* sP = sKV + BK * LDS;    // [BQ][LDP]

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = H * DH;
  const int64_t ld = 3 * (int64_t)D;
  const float* base = qkv + (int64_t)b * L * ld + (int64_t)h * DH;
  const int q0 = qt * BQ;
  const int ty = threadIdx.x / TX;
  const int tx = threadIdx.x % TX;

  load_tile<DH, LDS>(sQ, base + q0 * ld, ld, min(BQ, L - q0));

  float m[RPT], l[RPT], acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  const int nkt = causal ? qt + 1 : (L + BK - 1) / BK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    const int kvalid = min(BK, L - k0);
    __syncthreads();  // the previous tile's V reads are done
    load_tile<DH, LDS>(sKV, base + D + k0 * ld, ld, kvalid);
    __syncthreads();

    float s[RPT][TX];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < TX; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[RPT], kv[TX];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = sQ[(ty * RPT + i) * LDS + d];
#pragma unroll
      for (int j = 0; j < TX; ++j) kv[j] = sKV[(tx + TX * j) * LDS + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < TX; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty * RPT + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < TX; ++j) {
        const int col = k0 + tx + TX * j;
        float v = s[i][j] * scale;
        if (col >= L || (causal && col > row)) v = -INFINITY;
        s[i][j] = v;
        mx = fmaxf(mx, v);
      }
      const float m_new = fmaxf(m[i], row_max8(mx));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TX; ++j) {
        const float p = expf(s[i][j] - m_use);
        rs += p;
        sP[(ty * RPT + i) * LDP + tx + TX * j] = p;
      }
      l[i] = l[i] * alpha + row_sum8(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // K reads done, P written
    load_tile<DH, LDS>(sKV, base + 2 * D + k0 * ld, ld, kvalid);
    __syncthreads();

    // keys past L have p == 0 and zero rows of V
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float pv[RPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = sP[(ty * RPT + i) * LDP + k];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = sKV[k * LDS + tx + TX * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  __syncthreads();  // every read of sQ is done
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < CPT; ++c) sQ[(ty * RPT + i) * LDS + tx + TX * c] = acc[i][c] * inv;
  }
  __syncthreads();
  store_tile<DH, LDS>(out + ((int64_t)b * L + q0) * D + (int64_t)h * DH, D, sQ,
                      min(BQ, L - q0));
}

template <typename T>
cudaError_t launch(void (*kernel)(const T*, T*, int, int, float, int), int smem, int Dh,
                   const void* qkv, void* out, int B, int L, int H, int causal,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), L, H,
      1.0f / sqrtf((float)Dh), causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
// The caller checks shapes, dtype, contiguity and 16-byte alignment.
extern "C" int cosmos_fused_attention_fwd(const void* qkv, void* out, int B, int L,
                                          int H, int Dh, int dtype, int causal,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && Dh == 64)
    return launch<float>(fused_attention_fwd_kernel<64>, f32_smem_bytes<64>(), Dh, qkv, out,
                         B, L, H, causal, s);
  if (dtype == 0 && Dh == 128)
    return launch<float>(fused_attention_fwd_kernel<128>, f32_smem_bytes<128>(), Dh, qkv, out,
                         B, L, H, causal, s);
  if (dtype == 1 && Dh == 64)
    return launch<__nv_bfloat16>(fused_attention_fwd_kernel_tc<64>, tc_smem_bytes<64>(), Dh,
                                 qkv, out, B, L, H, causal, s);
  if (dtype == 1 && Dh == 128)
    return launch<__nv_bfloat16>(fused_attention_fwd_kernel_tc<128>, tc_smem_bytes<128>(), Dh,
                                 qkv, out, B, L, H, causal, s);
  return (int)cudaErrorInvalidValue;
}
