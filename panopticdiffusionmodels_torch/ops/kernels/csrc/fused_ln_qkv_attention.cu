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
// (biased) var over C in f32, eps inside the rsqrt (flax LayerNorm).  The
// rounding points are the TPU kernel's: statistics and the affine map in
// f32, xn rounded to bf16 before the product, the product rounded to bf16.
//
// What bounds it on an H100: the product is 2*M*C*3C flops against
// 2*(M*C + 3C*C + M*3C) bytes, so at the chain's shapes (M = 32*258, C =
// 1024) it is far above the ~295 flop/byte ridge: the tensor cores bound it
// (52 GFLOP, 53 us at 989 TFLOP/s).  The TPU kernel keeps the whole (L, 3C)
// qkv and the 6 MB weight in VMEM and never writes qkv to HBM; a Hopper
// block has 227 KB of shared memory, so this design splits the boundary in
// two launches and keeps one HBM round trip of qkv (101 MB at B = 32).
// What it does keep out of device memory is the normalised x: one CTA owns
// a 64-row x 256-column output tile and copies its 64 rows of x whole into
// shared memory (132 KB at C = 1024) with cp.async; each warp then takes the
// statistics of its rows and normalises them in place to bf16, while the
// first w tiles are already in flight.  w streams through a four-stage
// cp.async ring of 32 x 256 tiles, and sixteen warps (enough to hide the
// shared-memory latency of one CTA per SM) run mma.sync m16n8k16 (bf16 in,
// f32 accumulate) on 32 x 32 warp tiles; w's k-major tiles reach
// the B fragments through ldmatrix.trans.  No wgmma, TMA or persistent
// scheduling yet; x's rows are re-read from L2 by each of the 3C/256
// column tiles.
//
// Shapes: any M >= 1 (rows past M are zero-filled and not stored), C a
// multiple of 32 up to 1280 (the x block and the w ring must fit in shared
// memory), N = 3C columns masked in multiples of 8.

#include <math.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kBM = 64;   // output rows per CTA
constexpr int kBN = 256;  // output columns per CTA
constexpr int kBK = 32;   // depth of one w tile
constexpr int kStages = 4;  // w tiles in the cp.async ring
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kWStride = kBN + 8;  // shared row stride of a w tile, in elements
constexpr int kWarpN = 32;         // warp tile: 32 rows x 32 columns (2 x 8 warps)
constexpr int kMaxC = 1280;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes = 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 bf16 matrices of a row-major [k][n] tile, transposed into the
// B fragments of two 8-column mma tiles: r[0], r[1] for columns n0..n0+7,
// r[2], r[3] for n0+8..n0+15 (k rows k0..k0+15).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The kBK x kBN w tile at (k0, n0) into one stage; columns past N zero-fill.
__device__ __forceinline__ void load_w_tile(__nv_bfloat16* dst, const __nv_bfloat16* w, int k0,
                                            int n0, int N) {
  constexpr int kChunks = kBN / 8;
  for (int i = threadIdx.x; i < kBK * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int col = (i % kChunks) * 8;
    const bool ok = n0 + col < N;
    cp_async16(dst + r * kWStride + col, w + (long)(k0 + r) * N + (ok ? n0 + col : 0),
               ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(kThreads)
    ln_qkv_gemm_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                       const float* __restrict__ beta, const __nv_bfloat16* __restrict__ w,
                       __nv_bfloat16* __restrict__ qkv, int M, int C, float eps) {
  const int N = 3 * C;
  const int a_stride = C + 8;  // shared row stride of the x block, padded against bank conflicts
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sW = sA + kBM * a_stride;  // kStages stages of kBK x kWStride

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int k_tiles = C / kBK;

  // cp.async group 0: x rows m0..m0+63, whole (rows past M zero-fill).
  const int chunks = C / 8;
  for (int i = threadIdx.x; i < kBM * chunks; i += kThreads) {
    const int r = i / chunks;
    const int col = (i % chunks) * 8;
    const bool ok = m0 + r < M;
    cp_async16(sA + r * a_stride + col, x + (ok ? (long)(m0 + r) * C + col : 0), ok ? 16 : 0);
  }
  cp_async_commit();
  // groups 1..kStages-1: the first w tiles (empty groups keep the count).
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_w_tile(sW + s * kBK * kWStride, w, s * kBK, n0, N);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();  // x has landed; the w tiles may still fly
  __syncthreads();

  // LayerNorm of the block, one warp per row: f32 statistics in two passes
  // (mean, then the mean square of x - mean), then
  // xn = ((x - mean) * rstd) * gamma + beta rounded to bf16, in place.
  const int pairs = C / 2;
  const float2* gamma2 = reinterpret_cast<const float2*>(gamma);
  const float2* beta2 = reinterpret_cast<const float2*>(beta);
  for (int r = warp; r < kBM; r += kWarps) {
    __nv_bfloat162* row = reinterpret_cast<__nv_bfloat162*>(sA + r * a_stride);
    float sum = 0.f;
    for (int c = lane; c < pairs; c += 32) {
      const float2 v = __bfloat1622float2(row[c]);
      sum += v.x + v.y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum / (float)C;
    float sq = 0.f;
    for (int c = lane; c < pairs; c += 32) {
      const float2 v = __bfloat1622float2(row[c]);
      sq += (v.x - mean) * (v.x - mean) + (v.y - mean) * (v.y - mean);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float rstd = rsqrtf(sq / (float)C + eps);
    for (int c = lane; c < pairs; c += 32) {
      const float2 v = __bfloat1622float2(row[c]);
      const float2 g = gamma2[c], b = beta2[c];
      row[c] = __floats2bfloat162_rn((v.x - mean) * rstd * g.x + b.x,
                                     (v.y - mean) * rstd * g.y + b.y);
    }
  }
  // (the __syncthreads of the first k step orders these stores before the
  // A-fragment loads)

  const int wm = (warp >> 3) * 32;      // warp tile: rows wm..wm+31
  const int wn = (warp & 7) * kWarpN;   //            columns wn..wn+31
  constexpr int kTilesN = kWarpN / 8;
  float acc[2][kTilesN][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kTilesN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();  // w tile kt has landed
    __syncthreads();  // ... for every thread, and every warp is done with tile kt - 1
    const int next = kt + kStages - 1;  // refill the stage tile kt - 1 used
    if (next < k_tiles) load_w_tile(sW + (next % kStages) * kBK * kWStride, w, next * kBK, n0, N);
    cp_async_commit();
    const __nv_bfloat16* tile = sW + (kt % kStages) * kBK * kWStride;
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      const int ka = kt * kBK + kc * 16;  // column in x's block
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* p0 = sA + (wm + mt * 16 + gid) * a_stride + ka + tig * 2;
        const __nv_bfloat16* p1 = p0 + 8 * a_stride;
        af[mt][0] = ld_pair(p0);
        af[mt][1] = ld_pair(p1);
        af[mt][2] = ld_pair(p0 + 8);
        af[mt][3] = ld_pair(p1 + 8);
      }
#pragma unroll
      for (int np = 0; np < kTilesN / 2; ++np) {  // pairs of 8-column tiles
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, tile + (kc * 16 + (lane & 15)) * kWStride + wn + np * 16 +
                                   (lane >> 4) * 8);
        const uint32_t b0[2] = {bfr[0], bfr[1]};
        const uint32_t b1[2] = {bfr[2], bfr[3]};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_16816(acc[mt][2 * np], af[mt], b0);
          mma_16816(acc[mt][2 * np + 1], af[mt], b1);
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy may outlive the block

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int row0 = m0 + wm + mt * 16 + gid;
    const int row1 = row0 + 8;
#pragma unroll
    for (int nt = 0; nt < kTilesN; ++nt) {
      const int col = n0 + wn + nt * 8 + tig * 2;  // N % 8 == 0: col < N implies col + 1 < N
      if (col >= N) continue;
      if (row0 < M) {
        *reinterpret_cast<uint32_t*>(qkv + (long)row0 * N + col) =
            pack_bf16(acc[mt][nt][0], acc[mt][nt][1]);
      }
      if (row1 < M) {
        *reinterpret_cast<uint32_t*>(qkv + (long)row1 * N + col) =
            pack_bf16(acc[mt][nt][2], acc[mt][nt][3]);
      }
    }
  }
}

}  // namespace

// Returns the CUDA error code of the launch (0 on success).  Launches on
// `stream` and does not synchronise; `qkv` (M, 3C) is allocated by the caller;
// gamma and beta are 8-byte aligned.
extern "C" int pdm_ln_qkv_gemm(const void* x, const float* gamma, const float* beta,
                               const void* w, void* qkv, int M, int C, float eps, int device,
                               void* stream) {
  if (M < 1 || C < kBK || C % kBK != 0 || C > kMaxC) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int smem = (kBM * (C + 8) + kStages * kBK * kWStride) * (int)sizeof(__nv_bfloat16);
  err = cudaFuncSetAttribute(ln_qkv_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((3 * C + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  ln_qkv_gemm_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), gamma, beta, static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(qkv), M, C, eps);
  return (int)cudaGetLastError();
}
