// LayerNorm backward for Hopper (sm_90a).
//
// Replaces cosmos_tpu/ops/experimental/layer_norm.py::_bwd_kernel
// (launched by _ln_bwd, and through it by hybrid_layer_norm's backward).
// From the saved x [R, D] (compute dtype T), the float32 per-row mean and
// rstd [R], the float32 scale s [D] and the output gradient g [R, D] (T):
//     xh = (x - mean) * rstd,  gs = g * s
//     dx = T(rstd * (gs - mean(gs) - xh * mean(gs * xh)))     per row
//     dscale = sum over rows of g * xh,  dbias = sum over rows of g  (float32)
//
// What bounds it.  Memory: x and g read once, dx written once, plus the
// per-row statistics; the bound is (3 * R * D * itemsize + 8 * R + 12 * D)
// bytes over the HBM rate.  The TPU kernel carries dscale and dbias from
// one grid step to the next; here blocks run in parallel, in no order, so
// the column sums need a reduction across blocks that must not cost a
// second pass over the rows, nor float atomics (whose order changes from
// run to run).
//
// Design (D <= MAX_D).
//   * Partition.  A block of 8 warps owns a fixed run of rows_per_block
//     rows (whole tiles of TILE_ROWS rows, at most 264 blocks, set by the
//     wrapper from R and D alone, never from the SM count, so the bits
//     repeat on any H100 and every launch: ops/experimental/layer_norm.py
//     launch_geometry); warp w takes rows w, w + 8, ... of it.
//   * Row sums.  A lane holds its fixed 16-byte chunks of the row's x and g
//     (columns lane * VEC + 32 * VEC * j) and the row's mean and rstd in
//     registers, and issues the loads of the warp's next row before it
//     reduces this one, so each row is read from device memory once.  From
//     the registers: m1 = mean(gs) and m2 = mean(gs * xh) (lane sums in
//     increasing column order, then the warp's butterfly), then dx, stored
//     with 16-byte coalesced stores.
//   * Column sums.  Each lane adds g * xh and g for its columns into
//     float32 registers over the rows its warp takes, in increasing row
//     order: no shared-memory read-modify-write and nothing to zero.  At
//     the end the block adds its 8 warps' sums in warp order (through 64 *
//     D bytes of shared memory) into one partial row per block of a
//     float32 workspace [2][blocks][D].
//   * A second kernel sums each column's partial rows in a fixed order (8
//     strided partial sums, then those 8 in order) into dscale and dbias; it
//     writes every column, so the output needs no zeroing.  No float atomics
//     anywhere: a training step repeats to the last bit.
//   * s is read once per block, each lane holding its columns in
//     registers.  float32 runs the same design.
//   * Why not a shared-memory ring fed by 1-D bulk copies (x and g tiles of
//     8 rows, 2-4 stages, a producer warp on mbarriers): that version was
//     measured on the card against this one in the same call, with the same
//     partition and the same bits, and was slower at every phase-9
//     geometry, as was the ring version of K3 (layer_norm_fwd.cu).
//
// General path (1024 < D <= 7168): 4 warps per block over a contiguous
// range of rows, each warp every 4th row, straight from device memory (the
// second sweep an L1 hit), the column sums in each warp's own float32 row
// of shared memory (32 * D bytes a block), then the same fixed-order
// reductions.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "ln_tile.cuh"

namespace {

constexpr int WARPS = 8;                   // warps a block
constexpr int THREADS = 32 * WARPS;
constexpr int TILE_ROWS = 8;               // rows a block takes at a time: one per warp
constexpr int MAX_D = 1024;                // column sums in registers up to this width
static_assert(TILE_ROWS == WARPS, "a tile is one row for each warp of a block");
constexpr int GEN_WARPS = 4;               // general path: warps per block
constexpr int RED_COLS = 32;               // reduce kernel: columns per block
constexpr int RED_SPLIT = 8;               // reduce kernel: partial sums per column

using ln_tile::to_f32;
using ln_tile::warp_sum;

// adds one lane's 16 bytes of x and g (columns c .. c + VEC) to the row
// sums m1 (of gs) and m2 (of gs * xh)
template <typename T>
__device__ __forceinline__ void add_row_sums(const uint4& xraw, const uint4& graw,
                                             const float (&s)[16 / sizeof(T)], float mu,
                                             float rs, float& m1, float& m2) {
  constexpr int VEC = 16 / sizeof(T);
  const T* xe = reinterpret_cast<const T*>(&xraw);
  const T* ge = reinterpret_cast<const T*>(&graw);
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float xh = __fmul_rn(__fsub_rn(to_f32(xe[k]), mu), rs);
    const float gs = __fmul_rn(to_f32(ge[k]), s[k]);
    m1 += gs;
    m2 += __fmul_rn(gs, xh);
  }
}

// dx of columns c .. c + VEC into out (16-byte aligned); g * xh and g into
// the column sums ds and db (a lane's registers, or shared memory)
template <typename T, typename Acc>
__device__ __forceinline__ void dx_and_columns(T* out, const uint4& xraw, const uint4& graw,
                                               const float (&s)[16 / sizeof(T)], float mu,
                                               float rs, float m1, float m2, Acc&& ds,
                                               Acc&& db) {
  constexpr int VEC = 16 / sizeof(T);
  const T* xe = reinterpret_cast<const T*>(&xraw);
  const T* ge = reinterpret_cast<const T*>(&graw);
  float o[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float xh = __fmul_rn(__fsub_rn(to_f32(xe[k]), mu), rs);
    const float gv = to_f32(ge[k]);
    const float gs = __fmul_rn(gv, s[k]);
    o[k] = __fmul_rn(rs, __fsub_rn(__fsub_rn(gs, m1), __fmul_rn(xh, m2)));
    ds[k] += __fmul_rn(gv, xh);
    db[k] += gv;
  }
  *reinterpret_cast<uint4*>(out) = ln_tile::pack16<T>(o);
}

// NCH = ceil(D / (32 * VEC)) 16-byte chunks a lane owns in a row
template <typename T, int NCH>
__global__ void __launch_bounds__(THREADS)
layer_norm_bwd_regs_kernel(const T* __restrict__ x, const T* __restrict__ g,
                           const float* __restrict__ scale, const float* __restrict__ mean,
                           const float* __restrict__ rstd, T* __restrict__ dx,
                           float* __restrict__ partial, int64_t R, int D, int rows_per_block) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int STEP = 32 * VEC;
  extern __shared__ __align__(16) float red[];   // [WARPS][2][D]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t row1 = min(R, row0 + rows_per_block);

  // this lane's columns of s, and its column sums of g * xh and g
  float sc[NCH][VEC], ds[NCH][VEC], db[NCH][VEC];
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int c = lane * VEC + j * STEP;
    if (c < D) ln_tile::load_cols<T>(sc[j], scale + c);
#pragma unroll
    for (int k = 0; k < VEC; ++k) ds[j][k] = db[j][k] = 0.f;
  }
  // this row's chunks of x and g and its statistics, and the next row's,
  // loaded before this row is reduced
  uint4 cx[NCH], cg[NCH], nx[NCH], ng[NCH];
  float cmu, crs, nmu, nrs;
  auto load_row = [&](uint4 (&vx)[NCH], uint4 (&vg)[NCH], float& mu, float& rs, int64_t row) {
    const bool live = row < row1;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int c = lane * VEC + j * STEP;
      const bool in = live && c < D;
      vx[j] = in ? *reinterpret_cast<const uint4*>(x + row * D + c) : make_uint4(0, 0, 0, 0);
      vg[j] = in ? *reinterpret_cast<const uint4*>(g + row * D + c) : make_uint4(0, 0, 0, 0);
    }
    mu = live ? mean[row] : 0.f;
    rs = live ? rstd[row] : 0.f;
  };
  int64_t row = row0 + warp;
  load_row(cx, cg, cmu, crs, row);
  for (; row < row1; row += WARPS) {
    load_row(nx, ng, nmu, nrs, row + WARPS);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < NCH; ++j)
      if (lane * VEC + j * STEP < D) add_row_sums<T>(cx[j], cg[j], sc[j], cmu, crs, m1, m2);
    m1 = __fdiv_rn(warp_sum(m1), (float)D);
    m2 = __fdiv_rn(warp_sum(m2), (float)D);
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int c = lane * VEC + j * STEP;
      if (c < D)
        dx_and_columns<T>(dx + row * D + c, cx[j], cg[j], sc[j], cmu, crs, m1, m2, ds[j], db[j]);
    }
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      cx[j] = nx[j];
      cg[j] = ng[j];
    }
    cmu = nmu;
    crs = nrs;
  }

  // the block's warps in order: one partial row per block
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int c = lane * VEC + j * STEP;
    if (c < D) {
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q) {
        reinterpret_cast<float4*>(red + (2 * warp) * D + c)[q] =
            make_float4(ds[j][4 * q], ds[j][4 * q + 1], ds[j][4 * q + 2], ds[j][4 * q + 3]);
        reinterpret_cast<float4*>(red + (2 * warp + 1) * D + c)[q] =
            make_float4(db[j][4 * q], db[j][4 * q + 1], db[j][4 * q + 2], db[j][4 * q + 3]);
      }
    }
  }
  __syncthreads();
  for (int col = threadIdx.x; col < 2 * D; col += THREADS) {
    const int which = col / D;
    const int c = col % D;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += red[(2 * w + which) * D + c];
    partial[((int64_t)which * gridDim.x + blockIdx.x) * D + c] = sum;
  }
}

// general path: column sums in shared memory, rows from device memory
template <typename T>
__global__ void __launch_bounds__(GEN_WARPS * 32)
layer_norm_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ g,
                           const float* __restrict__ scale, const float* __restrict__ mean,
                           const float* __restrict__ rstd, T* __restrict__ dx,
                           float* __restrict__ partial, int64_t R, int D,
                           int rows_per_block) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int STEP = 32 * VEC;
  extern __shared__ float sacc[];   // [GEN_WARPS][2][D]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < GEN_WARPS * 2 * D; i += GEN_WARPS * 32) sacc[i] = 0.f;
  __syncthreads();
  float* ds_w = sacc + warp * 2 * D;
  float* db_w = ds_w + D;

  const int64_t r0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t r1 = min(R, r0 + rows_per_block);
  for (int64_t row = r0 + warp; row < r1; row += GEN_WARPS) {
    const float mu = mean[row];
    const float rs = rstd[row];
    const T* xr = x + row * D;
    const T* gr = g + row * D;
    float m1 = 0.f, m2 = 0.f;
    float s[VEC];
    for (int c = lane * VEC; c < D; c += STEP) {
      ln_tile::load_cols<T>(s, scale + c);
      add_row_sums<T>(*reinterpret_cast<const uint4*>(xr + c),
                      *reinterpret_cast<const uint4*>(gr + c), s, mu, rs, m1, m2);
    }
    m1 = __fdiv_rn(warp_sum(m1), (float)D);
    m2 = __fdiv_rn(warp_sum(m2), (float)D);
    T* dxr = dx + row * D;
    for (int c = lane * VEC; c < D; c += STEP) {
      ln_tile::load_cols<T>(s, scale + c);
      dx_and_columns<T>(dxr + c, *reinterpret_cast<const uint4*>(xr + c),
                        *reinterpret_cast<const uint4*>(gr + c), s, mu, rs, m1, m2, ds_w + c,
                        db_w + c);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += GEN_WARPS * 32) {
    float ds = 0.f, db = 0.f;
#pragma unroll
    for (int w = 0; w < GEN_WARPS; ++w) {
      ds += sacc[w * 2 * D + c];
      db += sacc[w * 2 * D + D + c];
    }
    partial[(int64_t)blockIdx.x * D + c] = ds;
    partial[((int64_t)gridDim.x + blockIdx.x) * D + c] = db;
  }
}

// partial [2][nblocks][D] -> out [2][D] (dscale, then dbias).  Block: 32
// columns x 8 partial sums; blockIdx.x walks the 2*D columns.
__global__ void __launch_bounds__(RED_COLS * RED_SPLIT)
layer_norm_bwd_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                             int nblocks, int D) {
  __shared__ float sums[RED_SPLIT][RED_COLS];
  const int col = blockIdx.x * RED_COLS + threadIdx.x;   // in [0, 2*D)
  const bool valid = col < 2 * D;
  const int which = valid ? col / D : 0;
  const int c = valid ? col % D : 0;
  const float* p = partial + (int64_t)which * nblocks * D + c;
  float s = 0.f;
  if (valid)
    for (int i = threadIdx.y; i < nblocks; i += RED_SPLIT) s += p[(int64_t)i * D];
  sums[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && valid) {
    float total = 0.f;
#pragma unroll
    for (int j = 0; j < RED_SPLIT; ++j) total += sums[j][threadIdx.x];
    out[col] = total;
  }
}

// sets a kernel's dynamic shared-memory limit once per device and size
template <typename K>
cudaError_t allow_smem(K kernel, int smem, int* smem_set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = smem;
  }
  return cudaSuccess;
}

// the register kernel for NCH = nch chunks a lane, nch in [N, MAX_D / STEP]
template <typename T, int N>
cudaError_t launch_regs(int nch, const T* x, const T* g, const float* scale,
                        const float* mean, const float* rstd, T* dx, float* partial, int64_t R,
                        int D, int rows_per_block, int blocks, int smem, cudaStream_t stream) {
  if constexpr (N * 32 * 16 / (int)sizeof(T) > MAX_D) {
    return cudaErrorInvalidValue;
  } else {
    if (nch != N)
      return launch_regs<T, N + 1>(nch, x, g, scale, mean, rstd, dx, partial, R, D,
                                   rows_per_block, blocks, smem, stream);
    static int smem_set[64] = {0};
    auto kernel = layer_norm_bwd_regs_kernel<T, N>;
    cudaError_t err = allow_smem(kernel, smem, smem_set);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, THREADS, smem, stream>>>(x, g, scale, mean, rstd, dx, partial, R, D,
                                              rows_per_block);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t launch(const void* xv, const void* gv, const float* scale, const float* mean,
                   const float* rstd, void* dxv, float* partial, float* dsb, int64_t R,
                   int D, int rows_per_block, int blocks, int smem, cudaStream_t stream) {
  constexpr int STEP = 32 * 16 / (int)sizeof(T);
  const T* x = static_cast<const T*>(xv);
  const T* g = static_cast<const T*>(gv);
  T* dx = static_cast<T*>(dxv);
  cudaError_t err;
  if (D <= MAX_D) {
    err = launch_regs<T, 1>((D + STEP - 1) / STEP, x, g, scale, mean, rstd, dx, partial, R, D,
                            rows_per_block, blocks, smem, stream);
  } else {
    static int smem_set[64] = {0};
    auto kernel = layer_norm_bwd_rows_kernel<T>;
    err = allow_smem(kernel, smem, smem_set);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, GEN_WARPS * 32, smem, stream>>>(x, g, scale, mean, rstd, dx, partial, R,
                                                     D, rows_per_block);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  const dim3 block(RED_COLS, RED_SPLIT);
  layer_norm_bwd_reduce_kernel<<<(2 * D + RED_COLS - 1) / RED_COLS, block, 0, stream>>>(
      partial, dsb, blocks, D);
  return cudaGetLastError();
}

}  // namespace

// The launch's arguments, packed by the wrapper into one buffer
// (ops/experimental/layer_norm.py _BWD_ARGS).  dtype: 0 = float32, 1 =
// bfloat16.  rows_per_block, blocks and smem (the dynamic shared memory of
// the rows kernel) come from launch_geometry(R, D, dtype, backward=True);
// D > MAX_D takes the general path.  partial: float32 [2][blocks][D]
// workspace; dsb: float32 [2][D] (dscale, dbias), every element written.
// The caller checks D % 8 == 0, D <= 7168, dtypes, contiguity and the
// 16-byte alignment of x, g, dx, scale and the workspace.
struct LnBwdArgs {
  const void* x;
  const void* g;
  const void* scale;
  const void* mean;
  const void* rstd;
  void* dx;
  void* partial;
  void* dsb;
  int64_t R;
  int D;
  int dtype;
  int rows_per_block;
  int blocks;
  int smem;
  void* stream;
};
static_assert(sizeof(LnBwdArgs) == 104, "layer_norm.py packs 104 bytes");

// Returns a cudaError_t (0 = launched).
extern "C" int cosmos_layer_norm_bwd(const LnBwdArgs* a) {
  cudaStream_t s = static_cast<cudaStream_t>(a->stream);
  const float* sc = static_cast<const float*>(a->scale);
  const float* mu = static_cast<const float*>(a->mean);
  const float* rs = static_cast<const float*>(a->rstd);
  float* p = static_cast<float*>(a->partial);
  float* o = static_cast<float*>(a->dsb);
  if (a->dtype == 0)
    return launch<float>(a->x, a->g, sc, mu, rs, a->dx, p, o, a->R, a->D, a->rows_per_block,
                         a->blocks, a->smem, s);
  if (a->dtype == 1)
    return launch<__nv_bfloat16>(a->x, a->g, sc, mu, rs, a->dx, p, o, a->R, a->D,
                                 a->rows_per_block, a->blocks, a->smem, s);
  return (int)cudaErrorInvalidValue;
}
