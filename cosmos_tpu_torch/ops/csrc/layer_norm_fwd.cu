// Single-pass LayerNorm forward for Hopper (sm_90a).
//
// Replaces cosmos_tpu/ops/experimental/layer_norm.py::_fwd_kernel
// (launched by _ln_fwd).  For every row r of x [R, D] in the compute dtype
// T (the [B, L, D] input flattened), with float32 scale s and bias b [D]:
//     mean = sum(x) / D,  var = max(sum(x^2) / D - mean^2, 0)  (float32)
//     rstd = rsqrt(var + eps)
//     y    = T(((x - mean) * rstd) * s + b)
// and the float32 mean and rstd go to [R] side outputs for the backward
// (K4, layer_norm_bwd.cu).
//
// What bounds it.  Memory: each element of x is read once and each of y
// written once, against about 8 operations; the bound is
// (2 * R * D * itemsize + 8 * D + 8 * R) bytes over the HBM rate.  So the
// card must keep enough bytes of x in flight to cover device-memory
// latency while a warp reduces a row, and lose no bandwidth to scalar
// loads of s and b or to a second read of the row.
//
// Design (D <= MAX_D).  A block of 8 warps owns a fixed run of rows
// (rows_per_block, whole tiles of TILE_ROWS rows, set by the wrapper from R
// and D alone: ops/experimental/layer_norm.py launch_geometry); warp w
// takes rows w, w + 8, ... of it.  A lane holds its fixed 16-byte chunks of
// the row in registers (columns lane * VEC + 32 * VEC * j), and issues the
// loads of the warp's next row before it reduces the current one, so two
// rows a warp are in flight and the row is read from device memory once.
// The sums run in the lane-strided increasing-column order of
// ln_tile::add_stats, then the butterfly of ln_tile::finish_stats: the
// order of K5's and K6's row_stats, so K3's statistics are K5's bits.  y
// is ln_tile::ln_value of the registers (each step rounded, no FMA
// contraction, so y equals the plain version given equal statistics),
// stored with 16-byte coalesced stores; lane 0 stores the row's mean and
// rstd.  s and b are read once per block, each lane holding its columns in
// registers.  float32 runs the same design (4 values per 16 bytes).
//
// Why this and not a shared-memory ring fed by 1-D bulk copies (tiles of 8
// rows, 2-4 stages, a producer warp on mbarriers): that version was
// measured on the card against this one in the same call and was slower
// at every phase-9 geometry, in both dtypes.  With nothing to keep between
// rows but s and b, registers hold the next row's bytes in flight without
// a round trip through shared memory and two mbarriers a tile.  K4
// (layer_norm_bwd.cu) has the same design for the same reason.
//
// General path (D > MAX_D).  One warp per row, ln_tile::row_stats from
// device memory, then a second sweep (an L1 or L2 hit) that writes y; the
// same arithmetic in the same order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "ln_tile.cuh"

namespace {

constexpr int WARPS = 8;             // warps a block
constexpr int THREADS = 32 * WARPS;
constexpr int TILE_ROWS = 8;         // rows a block takes at a time: one per warp
constexpr int MAX_D = 1024;          // rows in registers up to this width
static_assert(TILE_ROWS == WARPS, "a tile is one row for each warp of a block");

using ln_tile::to_f32;

// normalises the 16 bytes `raw` of columns c .. c + VEC of a row with
// statistics st and stores them at out (16-byte aligned)
template <typename T>
__device__ __forceinline__ void normalise_store(T* out, const uint4& raw, float2 st,
                                                const float* sc, const float* bi) {
  constexpr int VEC = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&raw);
  float s[VEC], b[VEC], o[VEC];
  ln_tile::load_cols<T>(s, sc);
  ln_tile::load_cols<T>(b, bi);
#pragma unroll
  for (int k = 0; k < VEC; ++k) o[k] = ln_tile::ln_value(to_f32(e[k]), st, s[k], b[k]);
  *reinterpret_cast<uint4*>(out) = ln_tile::pack16<T>(o);
}

// NCH = ceil(D / (32 * VEC)) 16-byte chunks a lane owns in a row
template <typename T, int NCH>
__global__ void __launch_bounds__(THREADS)
layer_norm_fwd_regs_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                           const float* __restrict__ bias, T* __restrict__ y,
                           float* __restrict__ mean_out, float* __restrict__ rstd_out,
                           int64_t R, int D, float eps, int rows_per_block) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int STEP = 32 * VEC;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t row1 = min(R, row0 + rows_per_block);

  // this lane's columns of s and b, for every row the warp takes
  float sc[NCH][VEC], bi[NCH][VEC];
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int c = lane * VEC + j * STEP;
    if (c < D) {
      ln_tile::load_cols<T>(sc[j], scale + c);
      ln_tile::load_cols<T>(bi[j], bias + c);
    }
  }
  // this row's 16-byte chunks, and the next row's, loaded before this
  // row is reduced
  uint4 cur[NCH], nxt[NCH];
  auto load_row = [&](uint4 (&v)[NCH], int64_t row) {
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int c = lane * VEC + j * STEP;
      v[j] = row < row1 && c < D ? *reinterpret_cast<const uint4*>(x + row * D + c)
                                 : make_uint4(0, 0, 0, 0);
    }
  };
  int64_t row = row0 + warp;
  load_row(cur, row);
  for (; row < row1; row += WARPS) {
    load_row(nxt, row + WARPS);
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int j = 0; j < NCH; ++j)
      if (lane * VEC + j * STEP < D) ln_tile::add_stats<T>(cur[j], sum, sq);
    const float2 st = ln_tile::finish_stats(sum, sq, D, eps);
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int c = lane * VEC + j * STEP;
      if (c < D) {
        const T* e = reinterpret_cast<const T*>(&cur[j]);
        float o[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) o[k] = ln_tile::ln_value(to_f32(e[k]), st, sc[j][k], bi[j][k]);
        *reinterpret_cast<uint4*>(y + row * D + c) = ln_tile::pack16<T>(o);
      }
    }
    if (lane == 0) {
      mean_out[row] = st.x;
      rstd_out[row] = st.y;
    }
#pragma unroll
    for (int j = 0; j < NCH; ++j) cur[j] = nxt[j];
  }
}

// general path: one warp per row, read from device memory
template <typename T>
__global__ void __launch_bounds__(THREADS)
layer_norm_fwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                           const float* __restrict__ bias, T* __restrict__ y,
                           float* __restrict__ mean_out, float* __restrict__ rstd_out,
                           int64_t R, int D, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int STEP = 32 * VEC;
  const int lane = threadIdx.x % 32;
  const int64_t row = (int64_t)blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= R) return;
  const T* xr = x + row * D;
  const float2 st = ln_tile::row_stats(xr, D, eps);
  T* yr = y + row * D;
  for (int c = lane * VEC; c < D; c += STEP)
    normalise_store<T>(yr + c, *reinterpret_cast<const uint4*>(xr + c), st, scale + c, bias + c);
  if (lane == 0) {
    mean_out[row] = st.x;
    rstd_out[row] = st.y;
  }
}

// the register kernel for NCH = nch chunks a lane, nch in [N, MAX_D / STEP]
template <typename T, int N>
cudaError_t launch_regs(int nch, const T* x, const float* scale, const float* bias, T* y,
                        float* mean, float* rstd, int64_t R, int D, float eps,
                        int rows_per_block, int blocks, cudaStream_t stream) {
  if constexpr (N * 32 * 16 / (int)sizeof(T) > MAX_D) {
    return cudaErrorInvalidValue;
  } else {
    if (nch != N)
      return launch_regs<T, N + 1>(nch, x, scale, bias, y, mean, rstd, R, D, eps,
                                   rows_per_block, blocks, stream);
    layer_norm_fwd_regs_kernel<T, N><<<blocks, THREADS, 0, stream>>>(
        x, scale, bias, y, mean, rstd, R, D, eps, rows_per_block);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t launch(const void* xv, const float* scale, const float* bias, void* yv,
                   float* mean, float* rstd, int64_t R, int D, float eps, int rows_per_block,
                   int blocks, cudaStream_t stream) {
  constexpr int STEP = 32 * 16 / (int)sizeof(T);
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  if (D <= MAX_D)
    return launch_regs<T, 1>((D + STEP - 1) / STEP, x, scale, bias, y, mean, rstd, R, D, eps,
                             rows_per_block, blocks, stream);
  layer_norm_fwd_rows_kernel<T><<<blocks, THREADS, 0, stream>>>(x, scale, bias, y, mean, rstd,
                                                                R, D, eps);
  return cudaGetLastError();
}

}  // namespace

// The launch's arguments, packed by the wrapper into one buffer
// (ops/experimental/layer_norm.py _FWD_ARGS): one pointer crosses ctypes
// instead of thirteen converted values.  dtype: 0 = float32, 1 = bfloat16.
// rows_per_block and blocks come from launch_geometry; D > MAX_D takes the
// general path (one warp per row, blocks of 8 rows).  The caller checks
// D % 8 == 0, dtypes, contiguity and 16-byte alignment of x, y, scale and
// bias.
struct LnFwdArgs {
  const void* x;
  const void* scale;
  const void* bias;
  void* y;
  void* mean;
  void* rstd;
  int64_t R;
  int D;
  float eps;
  int dtype;
  int rows_per_block;
  int blocks;
  void* stream;
};
static_assert(sizeof(LnFwdArgs) == 88, "layer_norm.py packs 88 bytes");

// Returns a cudaError_t (0 = launched).
extern "C" int cosmos_layer_norm_fwd(const LnFwdArgs* a) {
  cudaStream_t s = static_cast<cudaStream_t>(a->stream);
  const float* sc = static_cast<const float*>(a->scale);
  const float* bi = static_cast<const float*>(a->bias);
  float* m = static_cast<float*>(a->mean);
  float* r = static_cast<float*>(a->rstd);
  if (a->dtype == 0)
    return launch<float>(a->x, sc, bi, a->y, m, r, a->R, a->D, a->eps, a->rows_per_block,
                         a->blocks, s);
  if (a->dtype == 1)
    return launch<__nv_bfloat16>(a->x, sc, bi, a->y, m, r, a->R, a->D, a->eps,
                                 a->rows_per_block, a->blocks, s);
  return (int)cudaErrorInvalidValue;
}
