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
// device memory altogether (they are recomputed per tile in registers and
// shared memory) and writes only d(qkv) plus three float32 numbers per row.
//
// Design (two launches, deterministic, no atomics).  Blocks run in no
// order, so the TPU kernel's sequential whole-row schedule becomes two
// passes, each a loop inside one block:
//   * Pass A, one block per (query tile of 64, head, batch row), 128
//     threads.  Loop 1 over the key tiles computes, online, the row max m,
//     the row sum l and delta = sum_j P_ij dP_ij from float32 P (the TPU
//     kernel's form, fused_attention.py:211, not dout . o from the rounded
//     output).  Loop 2 recomputes s and dP per key tile, forms ds, rounds it
//     to T and accumulates dq = ds k in float32 registers.  dq is written,
//     and so are m, l and delta to a float32 workspace [3, B, H, L].
//   * Pass B, one block per (key tile of 64, head, batch row), 128 threads
//     at Dh 64 and 256 at Dh 128 (so the dk and dv accumulators stay in
//     registers).  It keeps the K and V tile in shared memory, streams the
//     query tiles (causal: only the tiles at or below the diagonal),
//     recomputes P from the saved m and l and ds from the saved delta, and
//     accumulates dv = T(P)^T dout and dk = ds^T q in float32 registers.
//   * Both passes compute s and dP with the same sequential float32 FMA
//     order over the head dim and round s * scale on its own (__fmul_rn,
//     never contracted into the exp's argument), so P and ds are
//     bit-identical in the two passes.  Tiles are staged in shared memory
//     as float32 with 16-byte loads; rows past L read as zeros and are
//     masked (P = 0), so any L >= 1 works and nothing bounds L.  Every
//     element of d(qkv) is written exactly once.
//   * Dh in {64, 128} and the dtype (float32, bfloat16) are template
//     parameters.  Plain FMA loops, no tensor cores: mma.sync / wgmma and
//     TMA are later work, as for the forward.
//
// Softmax difference.  As in the forward (fused_attention_fwd.cu): P here is
// max-subtracted, the TPU kernel's _softmax_rows is max-free with a clamp at
// 80; the two agree except for rows whose every unmasked logit is below
// about -88 or above 80.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int TX = 8;         // threads sharing one row of a 64 x 64 tile
constexpr int LDP = BK + 1;   // padded row stride of the P and ds tiles
constexpr int ROWS_THREADS = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: the TPU kernel's .astype(dtype) before a product
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Load `valid` rows (of 64) of DH elements, row stride `ld` elements, into a
// float32 shared tile with row stride DH + 1; rows past `valid` become 0.
template <typename T, int DH, int THREADS>
__device__ __forceinline__ void load_tile(float* s, const T* g, int64_t ld, int valid) {
  constexpr int LDS = DH + 1;
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
template <typename T, int DH, int THREADS>
__device__ __forceinline__ void store_tile(T* g, int64_t ld, const float* s, int valid) {
  constexpr int LDS = DH + 1;
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

__device__ __forceinline__ bool masked(int row, int col, int L, int causal) {
  return col >= L || (causal && col > row);
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
template <typename T, int DH>
__global__ void __launch_bounds__(ROWS_THREADS)
attention_bwd_rows_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                          T* __restrict__ dqkv, float* __restrict__ ws, int L, int H,
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
  const T* base = qkv + (int64_t)b * L * ld + (int64_t)h * DH;
  const T* dbase = dout + (int64_t)b * L * D + (int64_t)h * DH;
  const int q0 = qt * BQ;
  const int qvalid = min(BQ, L - q0);
  const int ty = threadIdx.x / TX;
  const int tx = threadIdx.x % TX;

  load_tile<T, DH, ROWS_THREADS>(sQ, base + q0 * ld, ld, qvalid);
  load_tile<T, DH, ROWS_THREADS>(sDO, dbase + q0 * D, D, qvalid);

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
    load_tile<T, DH, ROWS_THREADS>(sK, base + D + k0 * ld, ld, kvalid);
    load_tile<T, DH, ROWS_THREADS>(sV, base + 2 * D + k0 * ld, ld, kvalid);
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
    load_tile<T, DH, ROWS_THREADS>(sK, base + D + k0 * ld, ld, kvalid);
    load_tile<T, DH, ROWS_THREADS>(sV, base + 2 * D + k0 * ld, ld, kvalid);
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
        const float ds = p * (dp[i][j] - delta[i]) * scale;
        sDS[(ty * R + i) * LDP + tx + TX * j] = round_to<T>(ds);
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
  store_tile<T, DH, ROWS_THREADS>(dqkv + ((int64_t)b * L + q0) * ld + (int64_t)h * DH, ld,
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
template <typename T, int DH, int R>
__global__ void __launch_bounds__(BK * TX / R)
attention_bwd_cols_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                          T* __restrict__ dqkv, const float* __restrict__ ws, int L,
                          int H, float scale, int causal) {
  constexpr int THREADS = BK * TX / R;
  constexpr int LDS = DH + 1;
  constexpr int CPT = DH / TX;     // dk / dv columns per thread
  extern __shared__ float smem[];
  float* sK = smem;                // [BK][LDS]; reused to stage dk
  float* sV = sK + BK * LDS;       // [BK][LDS]; reused to stage dv
  float* sQ = sV + BK * LDS;       // [BQ][LDS]
  float* sDO = sQ + BQ * LDS;      // [BQ][LDS]
  float* sP = sDO + BQ * LDS;      // [BQ][LDP]: T(P)
  float* sDS = sP + BQ * LDP;      // [BQ][LDP]: T(ds)

  const int kt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D = H * DH;
  const int64_t ld = 3 * (int64_t)D;
  const T* base = qkv + (int64_t)b * L * ld + (int64_t)h * DH;
  const T* dbase = dout + (int64_t)b * L * D + (int64_t)h * DH;
  const int k0 = kt * BK;
  const int kvalid = min(BK, L - k0);
  const int ty = threadIdx.x / TX;
  const int tx = threadIdx.x % TX;
  const int64_t plane = (int64_t)gridDim.z * H * L;
  const float* wsM = ws + ((int64_t)b * H + h) * L;
  const float* wsL = wsM + plane;
  const float* wsD = wsM + 2 * plane;

  load_tile<T, DH, THREADS>(sK, base + D + k0 * ld, ld, kvalid);
  load_tile<T, DH, THREADS>(sV, base + 2 * D + k0 * ld, ld, kvalid);

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
    load_tile<T, DH, THREADS>(sQ, base + q0 * ld, ld, qvalid);
    load_tile<T, DH, THREADS>(sDO, dbase + q0 * D, D, qvalid);
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
        const float ds = p * (dp[i][j] - di) * scale;
        sP[r * LDP + tx + TX * j] = round_to<T>(p);
        sDS[r * LDP + tx + TX * j] = round_to<T>(ds);
      }
    }
    __syncthreads();

    // dv += T(P)^T dout, dk += ds^T q over the tile's query rows; rows past
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
  T* out = dqkv + ((int64_t)b * L + k0) * ld + (int64_t)h * DH;
  store_tile<T, DH, THREADS>(out + D, ld, sK, kvalid);
  store_tile<T, DH, THREADS>(out + 2 * D, ld, sV, kvalid);
}

template <typename T, int DH>
cudaError_t launch(const void* qkv, const void* dout, void* dqkv, void* ws, int B, int L,
                   int H, int causal, cudaStream_t stream) {
  // 4 query rows per thread in pass B at Dh 64 (128 threads), 2 at Dh 128
  // (256 threads): 2 * R * Dh / 8 float32 accumulators per thread either way
  constexpr int RB = DH == 64 ? 4 : 2;
  constexpr int smem_a = rows_smem_bytes<DH>();
  constexpr int smem_b = cols_smem_bytes<DH>();
  auto rows = attention_bwd_rows_kernel<T, DH>;
  auto cols = attention_bwd_cols_kernel<T, DH, RB>;
  cudaError_t err = cudaFuncSetAttribute(
      rows, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(cols, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_b);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)DH);
  const dim3 grid((L + BQ - 1) / BQ, H, B);
  rows<<<grid, ROWS_THREADS, smem_a, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), static_cast<T*>(dqkv),
      static_cast<float*>(ws), L, H, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cols<<<grid, BK * TX / RB, smem_b, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), static_cast<T*>(dqkv),
      static_cast<const float*>(ws), L, H, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  ws is a float32 workspace of 3*B*H*L
// elements.  Returns a cudaError_t (0 = both passes launched).  The caller
// checks shapes, dtype, contiguity and 16-byte alignment.
extern "C" int cosmos_fused_attention_bwd(const void* qkv, const void* dout, void* dqkv,
                                          void* ws, int B, int L, int H, int Dh, int dtype,
                                          int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && Dh == 64)
    return launch<float, 64>(qkv, dout, dqkv, ws, B, L, H, causal, s);
  if (dtype == 0 && Dh == 128)
    return launch<float, 128>(qkv, dout, dqkv, ws, B, L, H, causal, s);
  if (dtype == 1 && Dh == 64)
    return launch<__nv_bfloat16, 64>(qkv, dout, dqkv, ws, B, L, H, causal, s);
  if (dtype == 1 && Dh == 128)
    return launch<__nv_bfloat16, 128>(qkv, dout, dqkv, ws, B, L, H, causal, s);
  return (int)cudaErrorInvalidValue;
}
