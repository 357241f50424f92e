// Fused LayerNorm -> matmul forward for Hopper (sm_90a).
//
// Replaces cosmos_tpu/ops/experimental/ln_matmul.py::_kernel (launched by
// _ln_matmul_fwd_impl).  It computes
//     out[r, :] = round(LN(x[r]; g, b)) @ W^T + bias
// for x [R, D] in the compute dtype T, W in torch's [O, D] layout (read as
// it is: no transpose), float32 g, b [D] and bias [O] (the caller has
// already rounded the bias to T where the JAX attention path does), with
// the normalised row rounded to T before the product (ln_matmul.py:70),
// the product accumulated in float32, the bias added in float32, and the
// result cast to T.  The normalised [R, D] tensor never reaches device
// memory.
//
// What bounds it.  At the QKV projection of ViT-B (D = 768, O = 2304) the
// work is 2*R*D*O operations against (R*D + O*D + R*O) * itemsize bytes:
// about 670 operations per byte in bfloat16, above the ~295 at which the
// H100 stops being memory bound, so the tensor cores bound it.
//
// bfloat16 design (ln_matmul_kernel_sm90, D % 64 == 0, O % 256 == 0): a
// wgmma GEMM with the LayerNorm applied to its A operand.
//   * One block per tile of BM = 128 rows x BN = 256 output columns: two
//     consumer warpgroups, each owning 64 rows x 256 columns (128 float32
//     accumulators a thread), and one producer warp that keeps a ring of
//     STAGES stages full by TMA, each stage x [128][64] and W [256][64]
//     (128-byte swizzle; rows of x past R read as zeros).
//   * The two blocks of a cluster take neighbouring row tiles of the same
//     columns: each loads half of every W slice and multicasts it to both,
//     so W is read from L2 once per 256 rows.  A stage is refilled once
//     the consumers of both blocks have released it.
//   * Statistics: a first kernel (ln_matmul_kernel_stats, a warp per row,
//     float32 single pass, ln_tile::row_stats) writes every row's mean and
//     rstd to a float32 [R, 2] scratch, so x is read for them once and not
//     once per column tile; the block stages its rows' statistics and g, b
//     in shared memory.
//   * Main loop: per k-slice of 64, each warp reads its rows of the x
//     slice by ldmatrix, normalises them into bf16 A fragments in
//     registers (ln_tile::ln_value: the same rounded steps as the JAX
//     kernel) and issues wgmma m64n256k16 with A from registers and B the
//     W slice in shared memory.  The next slice is normalised while the
//     current products run.
//   * Epilogue: + bias in float32, rounded to bf16 into shared memory
//     (the ring, now free, in 128-byte swizzled boxes of 64 x 64) and
//     stored by TMA, which drops rows past R.  No atomics; the same bits
//     on every launch.
// x is read once for the statistics and once per column tile by TMA, W
// once per 256 rows, and no load latency sits in front of a product.
//
// float32 design (ln_matmul_kernel, FMA loops, no TF32; only the card-vs-
// CPU checks run it): one block of 256 threads per (32 rows, 256 columns),
// the rows staged by stage_ln_rows, W read from device memory.

#include "hopper.cuh"
#include "ln_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bfloat16: wgmma, TMA

namespace sm90 {

constexpr int BM = 128;          // rows per block
constexpr int BN = 256;          // output columns per block
constexpr int BK = 64;           // k-slice: 128-byte rows
constexpr int STAGES = 4;        // ring stages
constexpr int CLUSTER = 2;       // blocks sharing each W slice
constexpr int CONSUMERS = 256;   // two warpgroups
constexpr int THREADS = CONSUMERS + 32;   // and one producer warp

// shared memory, in bytes from a 1024-byte aligned base
constexpr int X_STAGE = BM * BK * 2;
constexpr int W_STAGE = BN * BK * 2;
constexpr int STAGE = X_STAGE + W_STAGE;
constexpr int STATS = STAGES * STAGE;     // float2 [BM]: mean, rstd
constexpr int GB = STATS + BM * 8;        // float2 [D]: g, b
__host__ __device__ constexpr int bars_offset(int D) { return GB + D * 8; }
__host__ __device__ constexpr int smem_bytes(int D) {
  return bars_offset(D) + 2 * STAGES * 8 + 1024;   // + alignment slack
}

// a bf16 pair of x normalised with its row's statistics and the columns'
// g and b
__device__ __forceinline__ uint32_t ln_pair(uint32_t v, float2 st, float2 gg, float2 bb) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&v);
  const __nv_bfloat162 y = __floats2bfloat162_rn(
      ln_tile::ln_value(__low2float(h), st, gg.x, bb.x),
      ln_tile::ln_value(__high2float(h), st, gg.y, bb.y));
  return *reinterpret_cast<const uint32_t*>(&y);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The warp's A fragments of one k-slice: rows wrow .. wrow + 15 of the x
// stage (row stats st0 for row g, st1 for row g + 8), columns k0 .. k0 + 63
// of x, normalised
__device__ __forceinline__ void load_a(uint32_t (&a)[BK / 16][4], const unsigned char* xs,
                                       int wrow, int k0, float2 st0, float2 st1,
                                       const float2* sg, const float2* sb) {
  const int lane = threadIdx.x % 32;
  const int r = wrow + lane % 16;
  const int tq = lane % 4;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    // ldmatrix x4: lanes 0-15 address rows at chunk 2 kk, lanes 16-31 at
    // chunk 2 kk + 1 (128-byte swizzle)
    const int chunk = (2 * kk + lane / 16) ^ (r & 7);
    ldsm_x4(a[kk], hopper::smem_u32(xs + r * 128 + chunk * 16));
    const int k = k0 + kk * 16 + 2 * tq;
    const float2 ga = sg[k / 2], ba = sb[k / 2];            // columns k, k + 1
    const float2 gc = sg[k / 2 + 4], bc = sb[k / 2 + 4];    // k + 8, k + 9
    a[kk][0] = ln_pair(a[kk][0], st0, ga, ba);
    a[kk][1] = ln_pair(a[kk][1], st1, ga, ba);
    a[kk][2] = ln_pair(a[kk][2], st0, gc, bc);
    a[kk][3] = ln_pair(a[kk][3], st1, gc, bc);
  }
}

// mean and rstd of every row of x, a warp per row
__global__ void __launch_bounds__(256)
ln_matmul_kernel_stats(const bf16* __restrict__ x, float2* __restrict__ stats, int64_t R,
                       int D, float eps) {
  const int64_t row = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= R) return;
  const float2 st = ln_tile::row_stats(x + row * D, D, eps);
  if (threadIdx.x % 32 == 0) stats[row] = st;
}

__global__ void __cluster_dims__(1, CLUSTER, 1) __launch_bounds__(THREADS, 1)
ln_matmul_kernel_sm90(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_w,
                      const __grid_constant__ CUtensorMap map_out,
                      const float2* __restrict__ stats, const float* __restrict__ g,
                      const float* __restrict__ b, const float* __restrict__ bias,
                      int64_t R, int D, int O) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float2* s_stats = reinterpret_cast<float2*>(smem + STATS);
  float2* s_gb = reinterpret_cast<float2*>(smem + GB);   // [D/2] g pairs, [D/2] b pairs
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + bars_offset(D));
  uint64_t* empty = full + STAGES;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * BN;
  const int64_t row0 = (int64_t)blockIdx.y * BM;
  const int nk = D / BK;
  const uint32_t rank = hopper::cluster_rank();

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      // every consumer warp of both blocks releases a stage
      hopper::mbar_init(&empty[s], CLUSTER * CONSUMERS / 32);
    }
    hopper::fence_barrier_init();
  }
  hopper::cluster_sync();   // the peer's barriers exist before any multicast

  if (warp == CONSUMERS / 32) {
    // ---- producer: this block's x slice, and its half of the W slice for
    // both blocks
    if (lane == 0) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % STAGES;
        hopper::mbar_wait(&empty[s], ((kb / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], STAGE);
        unsigned char* st = smem + s * STAGE;
        hopper::tma_load_2d(st, &map_x, &full[s], kb * BK, (int)row0);
        hopper::tma_load_2d_multicast(st + X_STAGE + rank * (W_STAGE / CLUSTER), &map_w,
                                      &full[s], kb * BK, n0 + (int)rank * (BN / CLUSTER),
                                      (1 << CLUSTER) - 1);
      }
    }
    hopper::cluster_sync();
    return;
  }

  // ---- consumers
  // the warp's first row in the tile: warpgroup w takes rows 64 w .. 64 w + 63
  const int wrow = warp * 16;
  // g and b as float2 pairs: s_gb[j] = (g[2j], g[2j+1]), s_gb[D/2 + j] = b's
  for (int i = threadIdx.x; i < D / 2; i += CONSUMERS) {
    s_gb[i] = make_float2(g[2 * i], g[2 * i + 1]);
    s_gb[D / 2 + i] = make_float2(b[2 * i], b[2 * i + 1]);
  }
  for (int i = threadIdx.x; i < BM; i += CONSUMERS)
    s_stats[i] = row0 + i < R ? stats[row0 + i] : make_float2(0.f, 0.f);
  hopper::named_sync(1, CONSUMERS);
  const int gq = lane / 4, tq = lane % 4;
  const float2 st0 = s_stats[wrow + gq], st1 = s_stats[wrow + gq + 8];
  const float2* sg = s_gb;
  const float2* sb = s_gb + D / 2;

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  uint32_t a_cur[BK / 16][4], a_next[BK / 16][4];
  hopper::mbar_wait(&full[0], 0);
  load_a(a_cur, smem, wrow, 0, st0, st1, sg, sb);
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % STAGES;
    const unsigned char* ws = smem + s * STAGE + X_STAGE;
    hopper::reg_fence(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hopper::wgmma_m64n256k16_rs(acc, a_cur[kk], hopper::desc_kmajor<128>(ws + kk * 32));
    hopper::wgmma_commit();
    hopper::reg_fence(acc);
    if (kb + 1 < nk) {
      const int sn = (kb + 1) % STAGES;
      hopper::mbar_wait(&full[sn], ((kb + 1) / STAGES) & 1);
      load_a(a_next, smem + sn * STAGE, wrow, (kb + 1) * BK, st0, st1, sg, sb);
    }
    hopper::wgmma_wait<0>();
    hopper::reg_fence(acc);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) hopper::reg_fence(a_cur[kk]);
    if (lane == 0) {
      hopper::mbar_arrive(&empty[s]);
      hopper::mbar_arrive_remote(hopper::peer_addr(&empty[s], rank ^ 1));
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) a_cur[kk][i] = a_next[kk][i];
  }

  // epilogue: + bias, bf16 into this warpgroup's 64 x 256 of the ring,
  // then TMA
  hopper::named_sync(1, CONSUMERS);   // both warpgroups are done with the ring
  unsigned char* tile = smem + (warp / 4) * (64 * BN * 2);
  const int r_in = (warp % 4) * 16 + gq;   // row in the warpgroup's 64
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = j * 8 + 2 * tq;
    const float c0 = bias[n0 + col], c1 = bias[n0 + col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(tile + (col / 64) * (64 * 128) +
                                         hopper::sw128(r_in + 8 * h, col % 64)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] + c0, acc[4 * j + 2 * h + 1] + c1);
  }
  hopper::fence_proxy_async();
  hopper::named_sync(2 + warp / 4, 128);
  if (threadIdx.x % 128 == 0) {
    for (int c = 0; c < BN / 64; ++c)
      hopper::tma_store_2d(&map_out, tile + c * (64 * 128), n0 + 64 * c,
                           (int)row0 + (warp / 4) * 64);
    hopper::tma_store_wait();
  }
  // no block leaves while its peer may still multicast into it or release
  // its stages
  hopper::cluster_sync();
}

cudaError_t launch(const void* x, const float* g, const float* b, const void* w,
                   const float* bias, void* out, float2* stats, int64_t R, int D, int O,
                   float eps, cudaStream_t stream) {
  CUtensorMap map_x, map_w, map_out;
  cudaError_t err =
      hopper::make_map_2d(&map_x, x, R, D, BM, BK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = hopper::make_map_2d(&map_w, w, O, D, BN / CLUSTER, BK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = hopper::make_map_2d(&map_out, out, R, O, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  ln_matmul_kernel_stats<<<(unsigned)((R + 7) / 8), 256, 0, stream>>>(
      static_cast<const bf16*>(x), stats, R, D, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = smem_bytes(D);
  err = cudaFuncSetAttribute(ln_matmul_kernel_sm90,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int64_t row_tiles = (R + BM - 1) / BM;
  const dim3 grid(O / BN, (unsigned)((row_tiles + CLUSTER - 1) / CLUSTER * CLUSTER));
  ln_matmul_kernel_sm90<<<grid, THREADS, smem, stream>>>(
      map_x, map_w, map_out, stats, g, b, bias, R, D, O);
  return cudaGetLastError();
}

}  // namespace sm90

// ---------------------------------------------------------------------------
// float32: FMA loops

using namespace ln_tile;

constexpr int BN = WARPS * 32;   // output columns per block

__global__ void __launch_bounds__(THREADS)
ln_matmul_kernel(const float* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ b, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ out, int64_t R, int D,
                 int O, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sY = reinterpret_cast<float*>(smem_raw);
  const int ldy = D + PAD;
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  stage_ln_rows(sY, ldy, x, row0, R, D, g, b, eps);
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n0 = blockIdx.y * BN + warp * 32;
  if (n0 >= O) return;
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  warp_tile_product<2, 4>(acc, sY, ldy, w, D, n0, O, D, 4);

  const int gr = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + nt * 8 + 2 * t;
      if (n >= O) continue;
      const float b0 = bias[n], b1 = bias[n + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t r = row0 + mt * 16 + gr + 8 * h;
        if (r < R)
          store_pair(out + r * O + n, acc[mt][nt][2 * h] + b0,
                            acc[mt][nt][2 * h + 1] + b1);
      }
    }
}

cudaError_t launch_f32(const void* x, const float* g, const float* b, const void* w,
                       const float* bias, void* out, int64_t R, int D, int O, float eps,
                       cudaStream_t stream) {
  const int smem = BM * (D + PAD) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ln_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((R + BM - 1) / BM), (O + BN - 1) / BN);
  ln_matmul_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(x), g, b, static_cast<const float*>(w), bias,
      static_cast<float*>(out), R, D, O, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  stats: float32 [R, 2] scratch of the
// bfloat16 path (unused in float32).  Returns a cudaError_t (0 =
// launched).  The caller checks shapes (D % 64 == 0, 64 <= D <= 1024,
// O % 256 == 0), dtypes, contiguity and 16-byte alignment.
extern "C" int cosmos_ln_matmul_fwd(const void* x, const void* g, const void* b,
                                    const void* w, const void* bias, void* out, void* stats,
                                    int64_t R, int D, int O, float eps, int dtype,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* bf = static_cast<const float*>(b);
  const float* biasf = static_cast<const float*>(bias);
  if (D % sm90::BK || D > 1024 || O % sm90::BN) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_f32(x, gf, bf, w, biasf, out, R, D, O, eps, s);
  if (dtype == 1)
    return sm90::launch(x, gf, bf, w, biasf, out, static_cast<float2*>(stats), R, D, O, eps,
                        s);
  return (int)cudaErrorInvalidValue;
}
