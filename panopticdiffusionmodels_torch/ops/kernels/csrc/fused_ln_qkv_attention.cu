// LayerNorm -> qkv GEMM, the first half of the fused LN + qkv + attention
// boundary, for Hopper (sm_90a).
//
// Replaces, with the packed-qkv attention kernel of fused_qkv_attention.cu
// launched right after it by the same wrapper (ops/kernels/
// fused_ln_qkv_attention.py), the Pallas TPU kernel
// panopticdiffusionmodels_tpu/ops/pallas/fused_ln_qkv_attention.py::
// fused_ln_qkv_attention (body `_kernel`).
//
// Inputs  x (M, C) bf16 row-major, M = B*L tokens of the pre-norm residual
//         stream; gamma, beta (C,) f32, the LayerNorm affine; w (C, 3C) bf16
//         row-major, the qkv weight packed head-major [q | k | v], no bias.
// Output  qkv (M, 3C) bf16: round_bf16(round_bf16(LN(x)) @ w), f32
//         accumulation, which the attention kernel reads as packed qkv.
// LN(x) = ((x - mean) * rsqrt(var + eps)) * gamma + beta per row, mean and
// (biased) var over C in f32, two passes (the mean, then the mean of
// (x - mean)^2), eps inside the rsqrt (flax LayerNorm).  The rounding points
// are the TPU kernel's: statistics and the affine map in f32, xn rounded to
// bf16 before the product, the product rounded to bf16.
//
// What bounds it on an H100: the product is 2*M*C*3C flops against
// 2*(M*C + 3C*C + M*3C) bytes, so at the chain's shapes (M = 32*258, C =
// 1024) it is far above the ~295 flop/byte ridge: the tensor cores bound it
// (52 GFLOP, 53 us at 989 TFLOP/s).  The TPU kernel keeps the whole (L, 3C)
// qkv and the 6 MB weight in VMEM and never writes qkv to HBM; a Hopper
// block has 227 KB of shared memory, so the boundary is two launches with
// one HBM round trip of qkv (101 MB at B = 32) between them.
//
// Normalising x in place needs a CTA's rows of x whole in shared memory,
// which caps the tile at 64 rows at C = 1024, so every CTA would stream a
// whole 512 KB w panel from L2 (812 MB a call at B = 32).  This design:
//   - `ln_row_stats_kernel`, a launch of its own, writes each row's f32 mean
//     and rstd, (M, 2), one warp per row; it reads x once (17 MB at B = 32);
//   - `ln_qkv_gemm_kernel` then takes x in 64-wide k tiles, so the tile is
//     128 rows x 256 columns (w's L2 traffic halves, x's is 12 reads of
//     each row): one thread of a producer warpgroup fills a 4-stage ring of
//     (x 128 x 64, w 64 x 256) k tiles with TMA, each stage signalled by a
//     `full` mbarrier and released by an `empty` one; two consumer
//     warpgroups own 64 rows each and take the producer warpgroup's spare
//     registers (setmaxnreg);
//   - a consumer reads its A fragments from the x tile with ldmatrix (the
//     addresses follow the 128-byte TMA swizzle), applies the LayerNorm in
//     f32 ((x - mean) * rstd * gamma + beta, gamma and beta from L1) and
//     rounds to bf16 in registers, and issues wgmma m64n256k16 with A in
//     registers and w from shared memory as an MN-major B (w is N-contiguous;
//     transpose bit); the fragments of k tile t + 1 are built while the
//     products of tile t run, and tile t + 1's products are queued before
//     tile t's are waited for;
//   - the epilogue rounds the f32 accumulator to bf16 and stores it;
//   - the kernel is persistent: one CTA an SM walks the output tiles, row
//     block major, and the producer runs on into the next tile's k tiles
//     while the consumers store this one (a few per cent faster than one
//     CTA a tile at the A/B chain's B = 32 and 64 on an H100).
//   Ragged M: TMA zero-fills x rows past M and stores past M are masked;
//   ragged N (3C not a multiple of 256) likewise through w's zero fill and
//   masked stores.
//
// Shapes: any M >= 1; C a multiple of 64 (the k tile and the 128-byte TMA
// row), no upper bound: x no longer sits whole in shared memory.

#include <math.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kBM = 128;  // output rows per CTA, 64 per consumer warpgroup
constexpr int kBN = 256;  // output columns per CTA
constexpr int kBK = 64;   // depth of one k tile (one 128-byte row of x)
constexpr int kStages = 4;
constexpr int kConsumers = 2;
constexpr int kThreads = (kConsumers + 1) * 128;  // + a producer warpgroup
// Registers a thread: 168 at launch (384 threads); the producer warpgroup
// gives all but 40 back and the consumers take 232, for the 64 x 256 f32
// accumulator (128 registers) and two sets of A fragments (32).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kXTile = kBM * kBK;               // elements of a stage's x tile (16 KB)
constexpr int kWBox = kBK * 64;                 // elements of one 64-column w box (8 KB)
constexpr int kWTile = kBN / 64 * kWBox;        // elements of a stage's w tile (32 KB)
constexpr int kStageBytes = (kXTile + kWTile) * 2;
constexpr int kSmem = kStages * kStageBytes + 1024 + 128;
constexpr int kStatRows = 8;  // rows per CTA of the statistics pass, one per warp

__global__ void __launch_bounds__(kStatRows * 32)
    ln_row_stats_kernel(const __nv_bfloat16* __restrict__ x, float2* __restrict__ stats, int M,
                        int C, float eps) {
  const int row = blockIdx.x * kStatRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (long)row * C);
  const int chunks = C / 8;
  float sum = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    const uint4 v = __ldg(xr + c);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(p[i]);
      sum += f.x + f.y;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float mean = sum / (float)C;
  float sq = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    const uint4 v = __ldg(xr + c);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(p[i]);
      sq += (f.x - mean) * (f.x - mean) + (f.y - mean) * (f.y - mean);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  if (lane == 0) stats[row] = make_float2(mean, rsqrtf(sq / (float)C + eps));
}

// Two bf16 of x (one 32-bit A-fragment register) through the LayerNorm of
// their row (st = mean, rstd) at columns with affine g, b; back to bf16.
__device__ __forceinline__ uint32_t ln_pair(uint32_t v, float2 st, float2 g, float2 b) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return pack_bf16((f.x - st.x) * st.y * g.x + b.x, (f.y - st.x) * st.y * g.y + b.y);
}

// The four k16 A fragments of one warp's 16 rows in the x tile at shared
// address `tile`, normalised.  `row` is this lane's ldmatrix row in the
// 128-row tile, `half` its 8-column half of each k16 step, `k0` the tile's
// first column of x and `kc` this thread's column pair in a k16 step.
__device__ __forceinline__ void load_a(uint32_t (&fa)[4][4], uint32_t tile, int row, int half,
                                       int k0, int kc, float2 st_lo, float2 st_hi,
                                       const float2* __restrict__ gamma2,
                                       const float2* __restrict__ beta2) {
  const uint32_t row_addr = tile + row * 128;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int chunk = (2 * kk + half) ^ (row & 7);  // the 128-byte swizzle of TMA
    ldmatrix_x4(fa[kk], row_addr + chunk * 16);
    const int k = (k0 + kk * 16 + kc) >> 1;  // float2 index of columns (k, k + 1)
    const float2 g0 = __ldg(gamma2 + k), g1 = __ldg(gamma2 + k + 4);
    const float2 b0 = __ldg(beta2 + k), b1 = __ldg(beta2 + k + 4);
    fa[kk][0] = ln_pair(fa[kk][0], st_lo, g0, b0);
    fa[kk][1] = ln_pair(fa[kk][1], st_hi, g0, b0);
    fa[kk][2] = ln_pair(fa[kk][2], st_lo, g1, b1);
    fa[kk][3] = ln_pair(fa[kk][3], st_hi, g1, b1);
  }
}

// acc += A W for one k tile: four k16 steps of 16 w rows (2 KB) each.
__device__ __forceinline__ void mma_tile(float (&acc)[128], const uint32_t (&fa)[4][4],
                                         uint64_t desc_w) {
  reg_fence(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_m64n256k16_rs_tnsp_b(acc, fa[kk], desc_w + ((kk * 16 * 128) >> 4));
  }
  wgmma_commit();
}

__global__ void __launch_bounds__(kThreads, 1)
    ln_qkv_gemm_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_w,
                       const float2* __restrict__ stats, const float* __restrict__ gamma,
                       const float* __restrict__ beta, __nv_bfloat16* __restrict__ qkv, int M,
                       int C) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* sW = sX + kStages * kXTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(sW + kStages * kWTile);
  uint64_t* empty = full + kStages;

  const int N = 3 * C;
  const int n_blocks = (N + kBN - 1) / kBN;
  const int n_tiles = (M + kBM - 1) / kBM * n_blocks;
  const int k_tiles = C / kBK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Persistent: the CTA walks output tiles blockIdx.x, + gridDim.x, ...,
  // row-block major (the CTAs in flight share x panels and all of w in L2).
  // `it` counts the k tiles this CTA has gone through, over all its output
  // tiles, and sets the ring stage and parity, so the producer runs into the
  // next output tile while the consumers store this one.
  if (wg == kConsumers) {  // the producer warpgroup: one thread issues every load
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 4 * kConsumers && lane == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = tile / n_blocks * kBM;
        const int n0 = tile % n_blocks * kBN;
        for (int kt = 0; kt < k_tiles; ++kt, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);  // round 0 passes at once
          mbar_expect_tx(&full[s], kStageBytes);
          tma_load_2d(sX + s * kXTile, &map_x, &full[s], kt * kBK, m0);
#pragma unroll
          for (int i = 0; i < kBN / 64; ++i) {
            tma_load_2d(sW + s * kWTile + i * kWBox, &map_w, &full[s], n0 + 64 * i, kt * kBK);
          }
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();

  const int wl = warp & 3;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int a_row = wg * 64 + wl * 16 + (lane & 15);
  const int a_half = lane >> 4;
  const float2* gamma2 = reinterpret_cast<const float2*>(gamma);
  const float2* beta2 = reinterpret_cast<const float2*>(beta);
  const uint32_t sx0 = smem_u32(sX);
  const uint32_t sw0 = smem_u32(sW);
  float acc[128];
  uint32_t fa[2][4][4];

  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, it += k_tiles) {
    const int m0 = tile / n_blocks * kBM;
    const int n0 = tile % n_blocks * kBN;
    const int row_lo = m0 + wg * 64 + wl * 16 + gid;  // this thread's accumulator rows
    const int row_hi = row_lo + 8;
    // Rows past M read zeros from TMA; (0, 0) statistics keep them finite.
    const float2 st_lo = row_lo < M ? stats[row_lo] : make_float2(0.f, 0.f);
    const float2 st_hi = row_hi < M ? stats[row_hi] : make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;

    // k tiles go in pairs so that each fragment buffer has a fixed name.
    // The products of k tile t + 1 are issued before those of tile t are
    // waited for, and the fragments of tile t + 1 are built while tile t's
    // run, so the tensor cores always hold a queued group.
    const int s0 = it % kStages;
    mbar_wait(&full[s0], (it / kStages) & 1);
    load_a(fa[0], sx0 + s0 * kXTile * 2, a_row, a_half, 0, 2 * tig, st_lo, st_hi, gamma2, beta2);
    // w: four 64-column boxes 8 KB apart (lbo), 8-row k groups 1 KB apart
    mma_tile(acc, fa[0], sw128_desc(sw0 + s0 * kWTile * 2, kWBox * 2, 1024));
    for (int kt = 0; kt < k_tiles; kt += 2) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = kt + u;
        if (t < k_tiles) {
          if (t + 1 < k_tiles) {
            const int next = it + t + 1;
            const int s1 = next % kStages;
            mbar_wait(&full[s1], (next / kStages) & 1);
            load_a(fa[u ^ 1], sx0 + s1 * kXTile * 2, a_row, a_half, (t + 1) * kBK, 2 * tig,
                   st_lo, st_hi, gamma2, beta2);
            mma_tile(acc, fa[u ^ 1], sw128_desc(sw0 + s1 * kWTile * 2, kWBox * 2, 1024));
            wgmma_wait<1>();  // k tile t is done, t + 1 may run on
          } else {
            wgmma_wait<0>();
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[(it + t) % kStages]);  // warp done with tile t
        }
      }
    }
    reg_fence(acc);

#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = n0 + j * 8 + tig * 2;  // N % 8 == 0: col < N implies col + 1 < N
      if (col >= N) continue;
      if (row_lo < M) {
        *reinterpret_cast<uint32_t*>(qkv + (long)row_lo * N + col) =
            pack_bf16(acc[4 * j], acc[4 * j + 1]);
      }
      if (row_hi < M) {
        *reinterpret_cast<uint32_t*>(qkv + (long)row_hi * N + col) =
            pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

}  // namespace

// Each row's f32 (mean, rstd) of x (M, C) into stats (M, 2), allocated by
// the caller.  Returns the CUDA error code of the launch (0 on success);
// launches on `stream` and does not synchronise.  x is 16-byte aligned.
extern "C" int pdm_ln_row_stats(const void* x, void* stats, int M, int C, float eps, int device,
                                void* stream) {
  if (M < 1 || C < 64 || C % 64 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ln_row_stats_kernel<<<(M + kStatRows - 1) / kStatRows, kStatRows * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<float2*>(stats), M, C, eps);
  return (int)cudaGetLastError();
}

// qkv (M, 3C) = LN(x) @ w from x (M, C), the row statistics of
// pdm_ln_row_stats, gamma and beta (C,) f32 (8-byte aligned) and w (C, 3C);
// qkv allocated by the caller, x and w 16-byte aligned.  Returns the CUDA
// error code of the launch (0 on success); launches on `stream` and does not
// synchronise.
extern "C" int pdm_ln_qkv_gemm(const void* x, const void* stats, const float* gamma,
                               const float* beta, const void* w, void* qkv, int M, int C,
                               int device, void* stream) {
  if (M < 1 || C < 64 || C % 64 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cuuint64_t n = 3ull * C;
  CUtensorMap map_x, map_w;
  const cuuint64_t x_dims[2] = {(cuuint64_t)C, (cuuint64_t)M};
  const cuuint64_t x_strides[1] = {(cuuint64_t)C * 2};
  const cuuint32_t x_box[2] = {kBK, kBM};
  const cuuint64_t w_dims[2] = {n, (cuuint64_t)C};
  const cuuint64_t w_strides[1] = {n * 2};
  const cuuint32_t w_box[2] = {64, kBK};
  if ((err = encode_bf16_map(&map_x, 2, x, x_dims, x_strides, x_box)) != cudaSuccess ||
      (err = encode_bf16_map(&map_w, 2, w, w_dims, w_strides, w_box)) != cudaSuccess) {
    return (int)err;
  }
  err = cudaFuncSetAttribute(ln_qkv_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long tiles = (long)((n + kBN - 1) / kBN) * ((M + kBM - 1) / kBM);
  const dim3 grid((unsigned)(tiles < sms ? tiles : sms));  // one persistent CTA an SM
  ln_qkv_gemm_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      map_x, map_w, static_cast<const float2*>(stats), gamma, beta,
      static_cast<__nv_bfloat16*>(qkv), M, C);
  return (int)cudaGetLastError();
}

// The GEMM's dynamic shared memory per CTA, in bytes.
extern "C" int pdm_ln_qkv_gemm_smem_bytes() { return kSmem; }
