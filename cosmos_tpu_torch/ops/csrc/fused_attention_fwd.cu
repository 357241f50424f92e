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
// running softmax state live in shared memory and registers, and each
// element of q, k, v is read from device memory once per query tile (K/V
// re-reads across the <= 4 query tiles of a row hit L2).
//
// Design.
//   * One thread block per (query tile of 64, head, batch row); 128
//     threads.  Thread (ty, tx) owns query rows ty*4 .. ty*4+3 and, in a
//     64-key tile, key columns tx, tx+8, ..., tx+56; in the output, head
//     columns tx, tx+8, ... .
//   * Q, then each K and V tile, is staged into shared memory as float32
//     with 16-byte loads (rows past L read as zeros).  K and V of one key
//     tile share one buffer.
//   * Logits are float32 FMAs.  Softmax is online: a running row max and
//     row sum in float32, reduced across the 8 threads of a row with warp
//     shuffles.  P is rounded to the input dtype before P.V (as
//     `_softmax_rows(s).astype(v.dtype)` at fused_attention.py:122), the
//     P.V accumulator is float32, and the output is divided by the row sum
//     at the end, staged through shared memory and written with 16-byte
//     stores in the input dtype.
//   * Causal: key tiles past the query tile are skipped; inside the
//     diagonal tile, key col > query row is masked.  Any L >= 1; the ragged
//     edges of the last query and key tiles are masked.
//   * Dh in {64, 128} and the dtype (float32, bfloat16) are template
//     parameters.  Plain FMA loops, no tensor cores: wgmma and TMA are
//     later work.
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

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;
constexpr int RPT = 4;        // query rows per thread
constexpr int TX = 8;         // threads sharing one query row
constexpr int LDP = BK + 1;   // padded row stride of the P tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Load `valid` rows (of BQ) of DH elements, row stride `ld` elements, into
// a float32 shared tile with row stride LDS; rows past `valid` become 0.
template <typename T, int DH, int LDS>
__device__ __forceinline__ void load_tile(float* s, const T* g, int64_t ld, int valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = DH / VEC;
  for (int i = threadIdx.x; i < BQ * VPR; i += THREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * VEC;
    float* dst = s + r * LDS + c;
    if (r < valid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(g + r * ld + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < VEC; ++k) dst[k] = to_f32(e[k]);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) dst[k] = 0.f;
    }
  }
}

// Store `valid` rows of a float32 shared tile to global memory in T.
template <typename T, int DH, int LDS>
__device__ __forceinline__ void store_tile(T* g, int64_t ld, const float* s, int valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = DH / VEC;
  for (int i = threadIdx.x; i < BQ * VPR; i += THREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * VEC;
    if (r < valid) {
      alignas(16) T e[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) e[k] = from_f32<T>(s[r * LDS + c + k]);
      *reinterpret_cast<uint4*>(g + r * ld + c) = *reinterpret_cast<const uint4*>(e);
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
constexpr int smem_bytes() {
  return (BQ * (DH + 1) + BK * (DH + 1) + BQ * LDP) * (int)sizeof(float);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
fused_attention_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
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
  const T* base = qkv + (int64_t)b * L * ld + (int64_t)h * DH;
  const int q0 = qt * BQ;
  const int ty = threadIdx.x / TX;
  const int tx = threadIdx.x % TX;

  load_tile<T, DH, LDS>(sQ, base + q0 * ld, ld, min(BQ, L - q0));

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
    load_tile<T, DH, LDS>(sKV, base + D + k0 * ld, ld, kvalid);
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
      // key 0 is unmasked for every row, so m_new is finite from the first
      // tile on; the guard keeps exp(-inf - -inf) out all the same
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TX; ++j) {
        const float p = expf(s[i][j] - m_use);
        rs += p;
        sP[(ty * RPT + i) * LDP + tx + TX * j] = to_f32(from_f32<T>(p));
      }
      l[i] = l[i] * alpha + row_sum8(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // K reads done, P written
    load_tile<T, DH, LDS>(sKV, base + 2 * D + k0 * ld, ld, kvalid);
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
  store_tile<T, DH, LDS>(out + ((int64_t)b * L + q0) * D + (int64_t)h * DH, D, sQ,
                         min(BQ, L - q0));
}

template <typename T, int DH>
cudaError_t launch(const void* qkv, void* out, int B, int L, int H, int causal,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes<DH>();
  auto kernel = fused_attention_fwd_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), L, H,
      1.0f / sqrtf((float)DH), causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
// The caller checks shapes, dtype, contiguity and 16-byte alignment.
extern "C" int cosmos_fused_attention_fwd(const void* qkv, void* out, int B, int L,
                                          int H, int Dh, int dtype, int causal,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && Dh == 64) return launch<float, 64>(qkv, out, B, L, H, causal, s);
  if (dtype == 0 && Dh == 128) return launch<float, 128>(qkv, out, B, L, H, causal, s);
  if (dtype == 1 && Dh == 64) return launch<__nv_bfloat16, 64>(qkv, out, B, L, H, causal, s);
  if (dtype == 1 && Dh == 128) return launch<__nv_bfloat16, 128>(qkv, out, B, L, H, causal, s);
  return (int)cudaErrorInvalidValue;
}
