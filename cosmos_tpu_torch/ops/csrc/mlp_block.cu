// Fused transformer-MLP block forward for Hopper (sm_90a).
//
// Replaces cosmos_tpu/ops/experimental/mlp_block.py::_kernel (launched by
// _fwd_impl).  It computes
//     out[r, :] = round(act(round(LN(x[r]; g, b)) @ W1^T + b1)) @ W2^T + b2
// for x [R, D] in the compute dtype T, W1 [HD, D] and W2 [D, HD] in torch's
// [out, in] layout (read as they are), float32 g, b [D], b1 [HD], b2 [D]
// (kept float32, as the fused JAX kernel keeps them, unlike the unfused
// Linear which rounds its bias), with the normalised row and the activated
// hidden rounded to T before their products (mlp_block.py:73-75), every
// product accumulated in float32 and the result cast to T.  The [R, HD]
// hidden never reaches device memory.
//
// What bounds it.  At ViT-B's MLP (D = 768, HD = 3072) the work is
// 4*R*D*HD operations against (2*R*D + 2*D*HD) * itemsize bytes: about 1500
// operations per byte in bfloat16 at R = 25216, so the tensor cores bound
// it.
//
// bfloat16 design (mlp_block_kernel_sm90, D = 512 or 768, HD % 128 == 0),
// the shape of a flash-attention forward with the hidden axis as the keys:
//   * A cluster of two blocks owns a tile of BM = 64 rows; block `rank`
//     owns output columns [rank * D/2, (rank + 1) * D/2).  Each block has
//     two consumer warpgroups, warpgroup w owning D/4 of those columns
//     (96 float32 accumulators a thread at D = 768, in registers for the
//     whole kernel), and two producer warps that drive TMA, one for W1 and
//     one for W2, so that neither stream waits behind the other.
//   * Both blocks normalise the 64 rows into shared memory (sY, 128-byte
//     swizzled, the wgmma A operand for every chunk), each row read once
//     into registers, four rows of a warp in flight.
//   * The hidden axis is walked in chunks of HC = 128.  For chunk c each
//     warpgroup computes 32 hidden columns (block `rank`, warpgroup w:
//     c*HC + 64 rank + 32 w ..+32) as sY @ W1[those rows]^T by wgmma
//     m64n32k16, with W1's k-slices streamed by TMA through a ring of S1
//     stages; adds b1, applies the activation in float32 and rounds to
//     bf16 into its 4 KB block of the chunk's h buffer (64-byte swizzle),
//     then copies that block into the peer block's h buffer by a bulk copy
//     over distributed shared memory.  h is double-buffered: per buffer
//     one mbarrier counts the local writes and the peer's bytes (full),
//     another the warps of both blocks that have finished reading it
//     (empty).
//   * out += h_chunk @ W2[my columns, chunk]^T by wgmma m64n(D/4)k16, with
//     W2's 32-wide k-slices streamed by TMA through a ring of S2 stages.
//   * The chunks are pipelined by one: a warpgroup computes and sends
//     chunk c+1's h before it waits for chunk c's, so the exchange between
//     the blocks overlaps a first product.
//   * The epilogue adds b2, rounds to bf16 into shared memory (sY, now
//     free, in 128-byte swizzled boxes of 64 x 64) and stores by TMA, which
//     drops rows past R (read as zeros).  No atomics, one fixed order of
//     sums: two launches give the same bits.
// Every weight tile reaches shared memory by TMA, so no load latency sits
// in front of a product, and W1 and W2 are read from L2 once per 64 rows.
//
// float32 design (mlp_block_kernel, FMA loops, no TF32; only the card-vs-
// CPU checks run it): one block of 256 threads per 32 rows, the rows
// staged by stage_ln_rows, then per chunk of 64 hidden columns warp w
// computes 8 of them (W1 read from device memory), writes them to shared
// memory, and accumulates its D/8 output columns.

#include "hopper.cuh"
#include "ln_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

enum Act { GELU = 0, GELU_TANH = 1, QUICK_GELU = 2 };

template <int ACT>
__device__ __forceinline__ float activate(float x) {
  if constexpr (ACT == GELU) {
    // jax.nn.gelu(approximate=False): x * (erf(x / sqrt(2)) + 1) / 2
    return x * (erff(x * 0.70710678118654752f) + 1.f) * 0.5f;
  } else if constexpr (ACT == GELU_TANH) {
    // jax.nn.gelu(approximate=True)
    const float u = 0.79788456080286536f * (x + 0.044715f * (x * x * x));
    return x * (0.5f * (1.f + tanhf(u)));
  } else {
    // x * sigmoid(1.702 x)
    return x / (1.f + expf(-1.702f * x));
  }
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma, TMA, a cluster of two blocks per 64 rows

namespace sm90 {

constexpr int BM = 64;           // rows per cluster
constexpr int HC = 128;          // hidden columns per chunk (the cluster's)
constexpr int HCW = 32;          // hidden columns per warpgroup per chunk
constexpr int BK1 = 64;          // W1 k-slice: 128-byte rows
constexpr int BK2 = 32;          // W2 k-slice: 64-byte rows
constexpr int S1 = 6;            // W1 ring stages
constexpr int S2 = 2;            // W2 ring stages
constexpr int CONSUMERS = 256;   // two warpgroups
constexpr int THREADS = CONSUMERS + 64;   // and two producer warps
constexpr int H_BLOCK = BM * HCW;         // elements of one warpgroup's h block

// shared memory, in bytes from a 1024-byte aligned base
template <int D>
struct Layout {
  static constexpr int Y = 0;                              // [D/64][64][64]
  static constexpr int H = Y + BM * D * 2;                 // [2][4][64][32]
  static constexpr int W1 = H + 2 * 4 * H_BLOCK * 2;       // [S1][64][64]
  static constexpr int W1_STAGE = HCW * 2 * BK1 * 2;       // this block's 64 rows
  static constexpr int W2 = W1 + S1 * W1_STAGE;            // [S2][D/2][32]
  static constexpr int W2_STAGE = (D / 2) * BK2 * 2;
  static constexpr int BARS = W2 + S2 * W2_STAGE;
  static constexpr int N_BARS = 2 * S1 + 2 * S2 + 4;
  static constexpr int BYTES = BARS + N_BARS * 8 + 1024;   // + alignment slack
};

using hopper::sw128;
using hopper::sw64;

template <int D> struct OutMma;
template <> struct OutMma<512> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b) {
    hopper::wgmma_m64n128k16_ss(d, a, b);
  }
};
template <> struct OutMma<768> {
  static __device__ __forceinline__ void run(float (&d)[96], uint64_t a, uint64_t b) {
    hopper::wgmma_m64n192k16_ss(d, a, b);
  }
};

template <int D, int ACT>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS, 1)
mlp_block_kernel_sm90(const __grid_constant__ CUtensorMap map_w1,
                      const __grid_constant__ CUtensorMap map_w2,
                      const __grid_constant__ CUtensorMap map_out,
                      const bf16* __restrict__ x, const float* __restrict__ g,
                      const float* __restrict__ b, const float* __restrict__ b1,
                      const float* __restrict__ b2, int64_t R, int HD, float eps) {
  using L = Layout<D>;
  constexpr int NOUT = D / 4;           // output columns per warpgroup
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* w1_full = bars;
  uint64_t* w1_empty = w1_full + S1;
  uint64_t* w2_full = w1_empty + S1;
  uint64_t* w2_empty = w2_full + S2;
  uint64_t* h_full = w2_empty + S2;     // [2]
  uint64_t* h_empty = h_full + 2;       // [2]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const uint32_t rank = hopper::cluster_rank();
  const int64_t row0 = (int64_t)(blockIdx.x / 2) * BM;
  const int chunks = HD / HC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S1; ++s) {
      hopper::mbar_init(&w1_full[s], 1);
      hopper::mbar_init(&w1_empty[s], CONSUMERS / 32);
    }
    for (int s = 0; s < S2; ++s) {
      hopper::mbar_init(&w2_full[s], 1);
      hopper::mbar_init(&w2_empty[s], CONSUMERS / 32);
    }
    // every consumer thread of this block arrives; the peer's 8 KB come as
    // bytes of its bulk copies
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&h_full[s], CONSUMERS);
      hopper::mbar_init(&h_empty[s], 2 * CONSUMERS / 32);   // both blocks' warps
    }
    hopper::fence_barrier_init();
  }
  hopper::cluster_sync();   // the peer's barriers exist before any copy

  if (warp == CONSUMERS / 32) {
    // ---- W1 producer: this block's 64 rows of each chunk, k-slice by
    // k-slice
    if (lane == 0) {
      int s1 = 0;
      uint32_t p1 = 0;
      for (int c = 0; c < chunks; ++c) {
        const int h0 = c * HC + (int)rank * 2 * HCW;
        for (int k = 0; k < D; k += BK1) {
          hopper::mbar_wait(&w1_empty[s1], p1 ^ 1);
          hopper::mbar_arrive_expect_tx(&w1_full[s1], L::W1_STAGE);
          hopper::tma_load_2d(smem + L::W1 + s1 * L::W1_STAGE, &map_w1, &w1_full[s1], k, h0);
          if (++s1 == S1) { s1 = 0; p1 ^= 1; }
        }
      }
    }
  } else if (warp == CONSUMERS / 32 + 1) {
    // ---- W2 producer: this block's D/2 rows, 32 columns of a chunk at a
    // time
    if (lane == 0) {
      int s2 = 0;
      uint32_t p2 = 0;
      for (int c = 0; c < chunks; ++c) {
        for (int k = 0; k < HC; k += BK2) {
          hopper::mbar_wait(&w2_empty[s2], p2 ^ 1);
          hopper::mbar_arrive_expect_tx(&w2_full[s2], L::W2_STAGE);
          for (int w = 0; w < 2; ++w)
            hopper::tma_load_2d(smem + L::W2 + s2 * L::W2_STAGE + w * (L::W2_STAGE / 2),
                                &map_w2, &w2_full[s2], c * HC + k,
                                (int)rank * (D / 2) + w * NOUT);
          if (++s2 == S2) { s2 = 0; p2 ^= 1; }
        }
      }
    }
  } else {
    // ---- consumers
    const int wg = warp / 4;            // warpgroup
    const int wr = (warp % 4) * 16;     // the warp's first row in the tile
    const int gq = lane / 4, tq = lane % 4;

    // LayerNorm prologue: the warp's 8 rows, 4 at a time with all their
    // loads in flight, each row read once into registers (its statistics
    // as ln_tile::row_stats sums them, then its normalised values), into
    // sY in 128-byte swizzled blocks of 64 columns; rows past R are zeros
    constexpr int U = D / 256;                   // 16-byte loads per lane and row
    constexpr int NR = 4;                        // rows in flight
    constexpr int WARPS_C = CONSUMERS / 32;
    for (int r = warp; r < BM; r += NR * WARPS_C) {
      uint4 raw[NR][U];
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int64_t row = row0 + r + i * WARPS_C;
          raw[i][u] = row < R ? *reinterpret_cast<const uint4*>(x + row * D + lane * 8 + u * 256)
                              : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int rr = r + i * WARPS_C;
        float s = 0.f, ss = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const bf16* e = reinterpret_cast<const bf16*>(&raw[i][u]);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float v = __bfloat162float(e[k]);
            s += v;
            ss += __fmul_rn(v, v);
          }
        }
        const float2 st = ln_tile::finish_stats(s, ss, D, eps);
        const bool valid = row0 + rr < R;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = lane * 8 + u * 256;
          const bf16* e = reinterpret_cast<const bf16*>(&raw[i][u]);
          alignas(16) bf16 y[8];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            y[k] = valid ? __float2bfloat16(ln_tile::ln_value(__bfloat162float(e[k]), st,
                                                              g[c + k], b[c + k]))
                         : __float2bfloat16(0.f);
          *reinterpret_cast<uint4*>(smem + L::Y + (c / 64) * (BM * 128) + sw128(rr, c % 64)) =
              *reinterpret_cast<const uint4*>(y);
        }
      }
    }
    hopper::fence_proxy_async();
    hopper::named_sync(1, CONSUMERS);

    float acc[NOUT / 2];
#pragma unroll
    for (int i = 0; i < NOUT / 2; ++i) acc[i] = 0.f;
    int s1 = 0, s2 = 0;
    uint32_t p1 = 0, p2 = 0;
    const uint32_t peer = rank ^ 1;

    // h[:, my 32 columns of chunk c] = sY @ W1[those rows]^T
    auto fc = [&](float (&hacc)[HCW / 2]) {
#pragma unroll
      for (int i = 0; i < HCW / 2; ++i) hacc[i] = 0.f;
      int prev = -1;
      for (int k = 0; k < D; k += BK1) {
        hopper::mbar_wait(&w1_full[s1], p1);
        const unsigned char* a = smem + L::Y + (k / 64) * (BM * 128);
        const unsigned char* bw = smem + L::W1 + s1 * L::W1_STAGE + wg * HCW * 128;
        hopper::reg_fence(hacc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK1 / 16; ++kk)
          hopper::wgmma_m64n32k16_ss(hacc, hopper::desc_kmajor<128>(a + kk * 32),
                                     hopper::desc_kmajor<128>(bw + kk * 32));
        hopper::wgmma_commit();
        hopper::reg_fence(hacc);
        if (prev >= 0) {
          hopper::wgmma_wait<1>();
          if (lane == 0) hopper::mbar_arrive(&w1_empty[prev]);
        }
        prev = s1;
        if (++s1 == S1) { s1 = 0; p1 ^= 1; }
      }
      hopper::wgmma_wait<0>();
      hopper::reg_fence(hacc);
      if (lane == 0) hopper::mbar_arrive(&w1_empty[prev]);
    };

    // b1, activation, bf16 into this warpgroup's block of h[c % 2], then
    // the block to the peer
    auto send = [&](int c, const float (&hacc)[HCW / 2]) {
      const int hb = c & 1;
      if (c >= 2)   // every warp of the pair has read chunk c - 2 from this buffer
        hopper::mbar_wait(&h_empty[hb], ((c - 2) >> 1) & 1);
      unsigned char* hbuf = smem + L::H + hb * (4 * H_BLOCK * 2);
      const int blk = (int)rank * 2 + wg;
      unsigned char* mine = hbuf + blk * (H_BLOCK * 2);
      const int hcol0 = c * HC + blk * HCW;
#pragma unroll
      for (int j = 0; j < HCW / 8; ++j) {
        const int col = j * 8 + 2 * tq;
        const float c0 = b1[hcol0 + col], c1 = b1[hcol0 + col + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wr + gq + 8 * h;
          *reinterpret_cast<__nv_bfloat162*>(mine + sw64(r, col)) =
              __floats2bfloat162_rn(activate<ACT>(hacc[4 * j + 2 * h] + c0),
                                    activate<ACT>(hacc[4 * j + 2 * h + 1] + c1));
        }
      }
      hopper::fence_proxy_async();
      hopper::named_sync(2 + wg, 128);
      if (threadIdx.x % 128 == 0)
        hopper::bulk_copy_to_peer(hopper::peer_addr(mine, peer), mine, H_BLOCK * 2,
                                  hopper::peer_addr(&h_full[hb], peer));
      if (threadIdx.x == 0)
        hopper::mbar_arrive_expect_tx(&h_full[hb], 2 * H_BLOCK * 2);
      else
        hopper::mbar_arrive(&h_full[hb]);
    };

    // out[:, my columns] += h[c % 2] @ W2[my columns, chunk c]^T
    auto proj = [&](int c) {
      const int hb = c & 1;
      hopper::mbar_wait(&h_full[hb], (c >> 1) & 1);
      const unsigned char* hbuf = smem + L::H + hb * (4 * H_BLOCK * 2);
      int prev = -1;
      for (int k = 0; k < HC; k += BK2) {
        hopper::mbar_wait(&w2_full[s2], p2);
        const unsigned char* a = hbuf + (k / BK2) * (H_BLOCK * 2);
        const unsigned char* bw = smem + L::W2 + s2 * L::W2_STAGE + wg * (L::W2_STAGE / 2);
        hopper::reg_fence(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK2 / 16; ++kk)
          OutMma<D>::run(acc, hopper::desc_kmajor<64>(a + kk * 32),
                         hopper::desc_kmajor<64>(bw + kk * 32));
        hopper::wgmma_commit();
        hopper::reg_fence(acc);
        if (prev >= 0) {
          hopper::wgmma_wait<1>();
          if (lane == 0) hopper::mbar_arrive(&w2_empty[prev]);
        }
        prev = s2;
        if (++s2 == S2) { s2 = 0; p2 ^= 1; }
      }
      hopper::wgmma_wait<0>();
      hopper::reg_fence(acc);
      if (lane == 0) {
        hopper::mbar_arrive(&w2_empty[prev]);
        // this warp has read h[c % 2]: tell both blocks
        hopper::mbar_arrive(&h_empty[hb]);
        hopper::mbar_arrive_remote(hopper::peer_addr(&h_empty[hb], peer));
      }
    };

    float hacc[HCW / 2];
    fc(hacc);
    send(0, hacc);
    for (int c = 0; c < chunks; ++c) {
      if (c + 1 < chunks) {
        fc(hacc);
        send(c + 1, hacc);
      }
      proj(c);
    }

    // epilogue: + b2, bf16 into this warpgroup's part of sY (no longer
    // read: every fc of this block is done), then TMA
    const int ocol0 = (int)rank * (D / 2) + wg * NOUT;
    unsigned char* tile = smem + L::Y + wg * (BM * NOUT * 2);
#pragma unroll
    for (int j = 0; j < NOUT / 8; ++j) {
      const int col = j * 8 + 2 * tq;
      const float c0 = b2[ocol0 + col], c1 = b2[ocol0 + col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(tile + (col / 64) * (BM * 128) +
                                           sw128(wr + gq + 8 * h, col % 64)) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h] + c0, acc[4 * j + 2 * h + 1] + c1);
    }
    hopper::fence_proxy_async();
    hopper::named_sync(2 + wg, 128);
    if (threadIdx.x % 128 == 0) {
      for (int c = 0; c < NOUT / 64; ++c)
        hopper::tma_store_2d(&map_out, tile + c * (BM * 128), ocol0 + 64 * c, (int)row0);
      hopper::tma_store_wait();
    }
  }
  // no block leaves while its peer may still copy into it or read from it
  hopper::cluster_sync();
}

template <int D, int ACT>
cudaError_t launch(const void* x, const float* g, const float* b, const void* w1,
                   const float* b1, const void* w2, const float* b2, void* out, int64_t R,
                   int HD, float eps, cudaStream_t stream) {
  CUtensorMap map_w1, map_w2, map_out;
  cudaError_t err = hopper::make_map_2d(&map_w1, w1, HD, D, 2 * HCW, BK1,
                                        CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = hopper::make_map_2d(&map_w2, w2, D, HD, D / 4, BK2, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != cudaSuccess) return err;
  err = hopper::make_map_2d(&map_out, out, R, D, BM, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  auto kernel = mlp_block_kernel_sm90<D, ACT>;
  constexpr int smem = Layout<D>::BYTES;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(2 * ((R + BM - 1) / BM)));
  kernel<<<grid, THREADS, smem, stream>>>(
      map_w1, map_w2, map_out, static_cast<const bf16*>(x), g, b, b1, b2, R, HD, eps);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_act(int act, const void* x, const float* g, const float* b,
                       const void* w1, const float* b1, const void* w2, const float* b2,
                       void* out, int64_t R, int HD, float eps, cudaStream_t s) {
  if (act == GELU) return launch<D, GELU>(x, g, b, w1, b1, w2, b2, out, R, HD, eps, s);
  if (act == GELU_TANH)
    return launch<D, GELU_TANH>(x, g, b, w1, b1, w2, b2, out, R, HD, eps, s);
  if (act == QUICK_GELU)
    return launch<D, QUICK_GELU>(x, g, b, w1, b1, w2, b2, out, R, HD, eps, s);
  return cudaErrorInvalidValue;
}

}  // namespace sm90

// ---------------------------------------------------------------------------
// float32: FMA loops

using namespace ln_tile;

constexpr int HC = 64;          // hidden columns per chunk (8 per warp)
constexpr int MAX_NT = 16;      // output n8 tiles per warp: D <= 1024
constexpr int LDH = HC + PAD;

template <int ACT>
__global__ void __launch_bounds__(THREADS)
mlp_block_kernel(const float* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ b, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ b2, float* __restrict__ out, int64_t R, int D,
                 int HD, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldy = D + PAD;
  float* sY = reinterpret_cast<float*>(smem_raw);   // [BM][ldy]
  float* sH = sY + BM * ldy;                        // [BM][LDH]
  const int64_t row0 = (int64_t)blockIdx.x * BM;
  stage_ln_rows(sY, ldy, x, row0, R, D, g, b, eps);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4;
  const int t = lane % 4;
  const int nt_o = D / 64;               // n8 tiles of output per warp
  const int o0 = warp * (D / WARPS);     // first output column of the warp

  float acc[2][MAX_NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  for (int hc = 0; hc < HD; hc += HC) {
    __syncthreads();   // sY staged; the previous chunk's sH reads are done
    float hacc[2][1][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) hacc[mt][0][i] = 0.f;
    const int hn0 = hc + warp * 8;
    warp_tile_product<2, 1>(hacc, sY, ldy, w1, D, hn0, HD, D, 1);
    const int hn = hn0 + 2 * t;
    const float bb0 = b1[hn], bb1 = b1[hn + 1];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store_pair(sH + (mt * 16 + gr + 8 * h) * LDH + warp * 8 + 2 * t,
                          activate<ACT>(hacc[mt][0][2 * h] + bb0),
                          activate<ACT>(hacc[mt][0][2 * h + 1] + bb1));
    __syncthreads();
    warp_tile_product<2, MAX_NT>(acc, sH, LDH, w2 + hc, HD, o0, D, HC, nt_o);
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < MAX_NT; ++nt) {
      if (nt >= nt_o) continue;
      const int n = o0 + nt * 8 + 2 * t;
      const float c0 = b2[n], c1 = b2[n + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t r = row0 + mt * 16 + gr + 8 * h;
        if (r < R)
          store_pair(out + r * D + n, acc[mt][nt][2 * h] + c0,
                            acc[mt][nt][2 * h + 1] + c1);
      }
    }
}

template <int ACT>
cudaError_t launch_f32(const void* x, const float* g, const float* b, const void* w1,
                       const float* b1, const void* w2, const float* b2, void* out, int64_t R,
                       int D, int HD, float eps, cudaStream_t stream) {
  const int smem = BM * (D + PAD + LDH) * (int)sizeof(float);
  auto kernel = mlp_block_kernel<ACT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((R + BM - 1) / BM));
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(x), g, b, static_cast<const float*>(w1), b1,
      static_cast<const float*>(w2), b2, static_cast<float*>(out), R, D, HD, eps);
  return cudaGetLastError();
}

cudaError_t launch_f32_act(int act, const void* x, const float* g, const float* b,
                           const void* w1, const float* b1, const void* w2, const float* b2,
                           void* out, int64_t R, int D, int HD, float eps, cudaStream_t s) {
  if (act == GELU) return launch_f32<GELU>(x, g, b, w1, b1, w2, b2, out, R, D, HD, eps, s);
  if (act == GELU_TANH)
    return launch_f32<GELU_TANH>(x, g, b, w1, b1, w2, b2, out, R, D, HD, eps, s);
  if (act == QUICK_GELU)
    return launch_f32<QUICK_GELU>(x, g, b, w1, b1, w2, b2, out, R, D, HD, eps, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; act: 0 = gelu, 1 = gelu_tanh,
// 2 = quick_gelu.  Returns a cudaError_t (0 = launched).  The caller checks
// shapes (D = 512 or 768, HD % 128 == 0), dtypes, contiguity and 16-byte
// alignment.
extern "C" int cosmos_mlp_block_fwd(const void* x, const void* g, const void* b,
                                    const void* w1, const void* b1, const void* w2,
                                    const void* b2, void* out, int64_t R, int D, int HD,
                                    float eps, int dtype, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* bf = static_cast<const float*>(b);
  const float* b1f = static_cast<const float*>(b1);
  const float* b2f = static_cast<const float*>(b2);
  if (D != 512 && D != 768) return (int)cudaErrorInvalidValue;
  if (HD % sm90::HC) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_f32_act(act, x, gf, bf, w1, b1f, w2, b2f, out, R, D, HD, eps, s);
  if (dtype == 1) {
    if (D == 512)
      return sm90::launch_act<512>(act, x, gf, bf, w1, b1f, w2, b2f, out, R, HD, eps, s);
    return sm90::launch_act<768>(act, x, gf, bf, w1, b1f, w2, b2f, out, R, HD, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}
