// Backward of attention from the packed qkv layout, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// panopticdiffusionmodels_tpu/ops/pallas/fused_qkv_attention.py::fused_attention_qkv_vjp
// (bodies `_kernel_bwd`, `_kernel_bwd_long`, `_attend_bwd`).
//
// Inputs  qkv  (B, L, 3C) bf16, columns [q heads | k heads | v heads];
//         out  (B, L, C)  bf16, the forward's output;
//         dout (B, L, C)  bf16, its cotangent;
//         lse  (B, H, L)  f32, the forward's natural-log log-sum-exp of the
//                         scaled scores (fused_qkv_attention.cu writes it).
// Output  dqkv (B, L, 3C) bf16, [dq | dk | dv] in qkv's own layout, so the
//         qkv projection's backward takes it without a relayout.
// Scratch delta (B, H, L) f32: delta_i = sum_d dout_id * out_id.
//
// Per head, with P = softmax(Q K^T * scale):
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - delta) * scale,
//   dQ = dS K,    dK = dS^T Q.
// P is rebuilt as exp(S * scale - lse) from the saved lse, so no (L, L)
// tensor reaches device memory and no row max or row sum is recomputed.
//
// What bounds it on an H100: the five products are 10*B*L^2*C flops against
// 14*B*L*C bytes (qkv and dout read, dqkv written), i.e. 5L/7 flops per
// byte: under the bf16 ridge (~295) at L = 334, over it at L = 590.  The
// design is two deterministic kernels with no atomics:
//   * dq_kernel: one CTA per (batch, head, 64-query tile), 4 warps of 16
//     rows.  It first computes delta for its rows (from out and dout, written
//     to the scratch for the next kernel), keeps its Q and dO fragments in
//     registers, streams 64-key K/V tiles through shared memory and
//     accumulates dQ = dS K in registers.
//   * dkv_kernel: one CTA per (batch, head, 64-key tile), 4 warps of 16 keys.
//     It keeps its K and V fragments in registers, streams 64-query Q/dO
//     tiles (with their lse and delta) through shared memory, works on the
//     transposed scores S^T = K Q^T, and accumulates dV = P^T dO and
//     dK = dS^T Q in registers.
// Both are launched back to back on one stream (dq first: it writes delta).
// Products run on the tensor cores through mma.sync m16n8k16 (bf16 in, f32
// accumulate); softmax math is f32.
//
// Numerics: as in `_attend_bwd`, P is rounded to bf16 for P^T dO and dS is
// rounded to bf16 for dS K and dS^T Q; dP, delta and the accumulators are
// f32.  The TPU kernel recomputes the normalised P from a fresh row max and
// row sum and takes rowsum(dP o P); this kernel takes P from the forward's
// lse and delta = rowsum(dO o out), which is the same quantity computed from
// the bf16-rounded out (flash-attention style).  The two differ by bf16
// rounding only.
//
// Shapes: any L >= 1 (ragged tiles: keys >= L get P = 0, query rows >= L have
// zero Q and dO rows and lse = +inf, so they add nothing; rows >= L are not
// stored) and any head dim D that is a multiple of 8 up to 128, padded with
// zeros to the next multiple of 16 in shared memory.
//
// This first version is simple on purpose, like the forward: single-buffered
// tiles, plain 16-byte loads, B fragments that need a transpose gathered with
// scalar shared-memory loads.  TMA, wgmma and pipelining are later work.

#include <math.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kBlock = 64;  // rows per CTA and per streamed tile, 16 per warp
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBlock == kWarps * 16, "one 16-row mma slice per warp");

// A fragments (m16 x k16 chunks over the head dim) of rows wr..wr+15 of a
// shared-memory tile.
template <int DP>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[DP / 16][4], const __nv_bfloat16* s,
                                             int wr, int gid, int tig) {
  constexpr int kStride = DP + 8;
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc) {
    const __nv_bfloat16* p0 = s + (wr + gid) * kStride + kc * 16 + tig * 2;
    const __nv_bfloat16* p1 = p0 + 8 * kStride;
    f[kc][0] = ld_pair(p0);
    f[kc][1] = ld_pair(p1);
    f[kc][2] = ld_pair(p0 + 8);
    f[kc][3] = ld_pair(p1 + 8);
  }
}

// acc[nt] (16 x 8 tile nt of a 16 x 64 product) = A (16 x DP, fragments) times
// the transpose of the shared-memory tile t (64 rows x DP): B[k][n] = t[n][k].
template <int DP>
__device__ __forceinline__ void mma_abt(float (&acc)[kBlock / 8][4],
                                        const uint32_t (&a)[DP / 16][4],
                                        const __nv_bfloat16* t, int gid, int tig) {
  constexpr int kStride = DP + 8;
#pragma unroll
  for (int nt = 0; nt < kBlock / 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    const __nv_bfloat16* tp = t + (nt * 8 + gid) * kStride + tig * 2;
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc) {
      const uint32_t bf[2] = {ld_pair(tp + kc * 16), ld_pair(tp + kc * 16 + 8)};
      mma_16816(acc[nt], a[kc], bf);
    }
  }
}

// acc (16 x DP) += X (16 x 64, f32 in the accumulator layout of mma_abt,
// rounded to bf16) times the shared-memory tile t (64 rows x DP).  The
// accumulator layout of column tiles (2j, 2j+1) is the A-fragment layout of
// the 16-wide chunk j; t's B fragments are gathered with scalar loads.
template <int DP>
__device__ __forceinline__ void mma_xt(float (&acc)[DP / 8][4], const float (&x)[kBlock / 8][4],
                                       const __nv_bfloat16* t, int gid, int tig) {
  constexpr int kStride = DP + 8;
  const unsigned short* t16 = reinterpret_cast<const unsigned short*>(t);
#pragma unroll
  for (int j = 0; j < kBlock / 16; ++j) {
    const uint32_t pa[4] = {pack_bf16(x[2 * j][0], x[2 * j][1]),
                            pack_bf16(x[2 * j][2], x[2 * j][3]),
                            pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]),
                            pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3])};
    const int kr = j * 16 + tig * 2;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      const int col = dt * 8 + gid;
      const uint32_t bf[2] = {
          (uint32_t)t16[kr * kStride + col] | ((uint32_t)t16[(kr + 1) * kStride + col] << 16),
          (uint32_t)t16[(kr + 8) * kStride + col] |
              ((uint32_t)t16[(kr + 9) * kStride + col] << 16)};
      mma_16816(acc[dt], pa, bf);
    }
  }
}

// Rows row0 and row0 + 8 of a 16 x DP accumulator into a bf16 (L, ld) matrix
// at column offset `base`; rows >= L and columns >= D are not stored.
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long ld, const float (&acc)[DP / 8][4],
                                           int row0, int L, int D, int tig) {
  const int row1 = row0 + 8;
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt) {
    const int col = dt * 8 + tig * 2;  // D % 8 == 0, so col < D implies col + 1 < D
    if (col < D) {
      if (row0 < L) {
        *reinterpret_cast<uint32_t*>(dst + (long)row0 * ld + col) =
            pack_bf16(acc[dt][0], acc[dt][1]);
      }
      if (row1 < L) {
        *reinterpret_cast<uint32_t*>(dst + (long)row1 * ld + col) =
            pack_bf16(acc[dt][2], acc[dt][3]);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ out,
              const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ delta, __nv_bfloat16* __restrict__ dqkv, int L, int H,
              int D, float scale) {
  constexpr int kStride = DP + 8;
  constexpr int kChunksD = DP / 16;
  constexpr int kTilesN = kBlock / 8;
  constexpr int kTilesD = DP / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // Q, then K
  __nv_bfloat16* sB = sA + kBlock * kStride;                       // dO, then V
  float* sRow = reinterpret_cast<float*>(sB + kBlock * kStride);   // lse*log2e, delta

  const int q0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C = H * D;
  const long row_stride = 3L * C;
  const __nv_bfloat16* base = qkv + (long)b * L * row_stride;
  const __nv_bfloat16* obase = out + (long)b * L * C + h * D;
  const __nv_bfloat16* gbase = dout + (long)b * L * C + h * D;
  const long hrow = ((long)b * H + h) * L;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wr = warp * 16;

  // delta_i = sum_d dout_id * out_id for this CTA's rows, kept for dkv_kernel.
  if (threadIdx.x < kBlock) {
    const int row = q0 + threadIdx.x;
    float acc = 0.f, l2 = INFINITY;
    if (row < L) {
      for (int c = 0; c < D; c += 8) {
        const uint4 ov = __ldg(reinterpret_cast<const uint4*>(obase + (long)row * C + c));
        const uint4 gv = __ldg(reinterpret_cast<const uint4*>(gbase + (long)row * C + c));
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 of = __bfloat1622float2(o2[i]);
          const float2 gf = __bfloat1622float2(g2[i]);
          acc += of.x * gf.x + of.y * gf.y;
        }
      }
      delta[hrow + row] = acc;
      l2 = lse[hrow + row] * kLog2e;
    }
    sRow[threadIdx.x] = l2;
    sRow[kBlock + threadIdx.x] = acc;
  }
  load_tile<DP, kBlock, kThreads>(sA, base + h * D, row_stride, q0, L, D);
  load_tile<DP, kBlock, kThreads>(sB, gbase, C, q0, L, D);
  __syncthreads();

  uint32_t qf[kChunksD][4], gf[kChunksD][4];
  load_a_frags<DP>(qf, sA, wr, gid, tig);
  load_a_frags<DP>(gf, sB, wr, gid, tig);
  const float lse2[2] = {sRow[wr + gid], sRow[wr + gid + 8]};
  const float dl[2] = {sRow[kBlock + wr + gid], sRow[kBlock + wr + gid + 8]};
  const float scale_log2 = scale * kLog2e;

  float dq[kTilesD][4];
#pragma unroll
  for (int dt = 0; dt < kTilesD; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;

  for (int k0 = 0; k0 < L; k0 += kBlock) {
    __syncthreads();  // every warp is done with the previous tiles (and with Q / dO)
    load_tile<DP, kBlock, kThreads>(sA, base + C + h * D, row_stride, k0, L, D);
    load_tile<DP, kBlock, kThreads>(sB, base + 2 * C + h * D, row_stride, k0, L, D);
    __syncthreads();

    float s[kTilesN][4], dp[kTilesN][4];
    mma_abt<DP>(s, qf, sA, gid, tig);   // S = Q K^T
    mma_abt<DP>(dp, gf, sB, gid, tig);  // dP = dO V^T
#pragma unroll
    for (int nt = 0; nt < kTilesN; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + tig * 2 + (e & 1);
        const float p = key < L ? exp2f(s[nt][e] * scale_log2 - lse2[e >> 1]) : 0.f;
        dp[nt][e] = p * (dp[nt][e] - dl[e >> 1]) * scale;  // dS
      }
    }
    mma_xt<DP>(dq, dp, sA, gid, tig);  // dQ += dS K
  }
  store_rows<DP>(dqkv + (long)b * L * row_stride + h * D, row_stride, dq, q0 + wr + gid, L, D,
                 tig);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dqkv, int L, int H, int D, float scale) {
  constexpr int kStride = DP + 8;
  constexpr int kChunksD = DP / 16;
  constexpr int kTilesN = kBlock / 8;
  constexpr int kTilesD = DP / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // K, then Q
  __nv_bfloat16* sB = sA + kBlock * kStride;                       // V, then dO
  float* sRow = reinterpret_cast<float*>(sB + kBlock * kStride);   // lse*log2e, delta

  const int k0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C = H * D;
  const long row_stride = 3L * C;
  const __nv_bfloat16* base = qkv + (long)b * L * row_stride;
  const __nv_bfloat16* gbase = dout + (long)b * L * C + h * D;
  const long hrow = ((long)b * H + h) * L;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wr = warp * 16;

  load_tile<DP, kBlock, kThreads>(sA, base + C + h * D, row_stride, k0, L, D);
  load_tile<DP, kBlock, kThreads>(sB, base + 2 * C + h * D, row_stride, k0, L, D);
  __syncthreads();
  uint32_t kf[kChunksD][4], vf[kChunksD][4];
  load_a_frags<DP>(kf, sA, wr, gid, tig);
  load_a_frags<DP>(vf, sB, wr, gid, tig);
  const float scale_log2 = scale * kLog2e;

  float dk[kTilesD][4], dv[kTilesD][4];
#pragma unroll
  for (int dt = 0; dt < kTilesD; ++dt) {
    dk[dt][0] = dk[dt][1] = dk[dt][2] = dk[dt][3] = 0.f;
    dv[dt][0] = dv[dt][1] = dv[dt][2] = dv[dt][3] = 0.f;
  }

  for (int q0 = 0; q0 < L; q0 += kBlock) {
    __syncthreads();  // every warp is done with the previous tiles (and with K / V)
    load_tile<DP, kBlock, kThreads>(sA, base + h * D, row_stride, q0, L, D);
    load_tile<DP, kBlock, kThreads>(sB, gbase, C, q0, L, D);
    if (threadIdx.x < kBlock) {
      const int row = q0 + threadIdx.x;
      const bool in = row < L;
      sRow[threadIdx.x] = in ? lse[hrow + row] * kLog2e : INFINITY;
      sRow[kBlock + threadIdx.x] = in ? delta[hrow + row] : 0.f;
    }
    __syncthreads();

    // Transposed scores: rows are this warp's keys, columns the tile's queries.
    float st[kTilesN][4], dpt[kTilesN][4];
    mma_abt<DP>(st, kf, sA, gid, tig);  // S^T = K Q^T
#pragma unroll
    for (int nt = 0; nt < kTilesN; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nt * 8 + tig * 2 + (e & 1);
        st[nt][e] = exp2f(st[nt][e] * scale_log2 - sRow[qc]);  // P^T
      }
    }
    mma_xt<DP>(dv, st, sB, gid, tig);    // dV += P^T dO
    mma_abt<DP>(dpt, vf, sB, gid, tig);  // dP^T = V dO^T
#pragma unroll
    for (int nt = 0; nt < kTilesN; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nt * 8 + tig * 2 + (e & 1);
        dpt[nt][e] = st[nt][e] * (dpt[nt][e] - sRow[kBlock + qc]) * scale;  // dS^T
      }
    }
    mma_xt<DP>(dk, dpt, sA, gid, tig);  // dK += dS^T Q
  }
  __nv_bfloat16* dst = dqkv + (long)b * L * row_stride;
  store_rows<DP>(dst + C + h * D, row_stride, dk, k0 + wr + gid, L, D, tig);
  store_rows<DP>(dst + 2 * C + h * D, row_stride, dv, k0 + wr + gid, L, D, tig);
}

template <int DP>
cudaError_t launch(const void* qkv, const void* out, const void* dout, const float* lse,
                   float* delta, void* dqkv, int B, int L, int H, int D, float scale,
                   cudaStream_t stream) {
  const int smem = 2 * kBlock * (DP + 8) * (int)sizeof(__nv_bfloat16) +
                   2 * kBlock * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(dq_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkv_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kBlock - 1) / kBlock, H, B);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(qkv);
  const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(dout);
  __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(dqkv);
  dq_kernel<DP><<<grid, kThreads, smem, stream>>>(
      q, static_cast<const __nv_bfloat16*>(out), g, lse, delta, dq, L, H, D, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<DP><<<grid, kThreads, smem, stream>>>(q, g, lse, delta, dq, L, H, D, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error code of the launches (0 on success).  Launches on
// `stream` and does not synchronise; `dqkv` and the `delta` scratch (B, H, L)
// f32 are allocated by the caller.
extern "C" int pdm_fused_qkv_attention_bwd(const void* qkv, const void* out, const void* dout,
                                           const float* lse, float* delta, void* dqkv, int B,
                                           int L, int H, int D, float scale, int device,
                                           void* stream) {
  if (B < 1 || L < 1 || H < 1 || D < 8 || D > 128 || D % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16) {
    case 1: return (int)launch<16>(qkv, out, dout, lse, delta, dqkv, B, L, H, D, scale, s);
    case 2: return (int)launch<32>(qkv, out, dout, lse, delta, dqkv, B, L, H, D, scale, s);
    case 3: return (int)launch<48>(qkv, out, dout, lse, delta, dqkv, B, L, H, D, scale, s);
    case 4: return (int)launch<64>(qkv, out, dout, lse, delta, dqkv, B, L, H, D, scale, s);
    case 5: return (int)launch<80>(qkv, out, dout, lse, delta, dqkv, B, L, H, D, scale, s);
    case 6: return (int)launch<96>(qkv, out, dout, lse, delta, dqkv, B, L, H, D, scale, s);
    case 7: return (int)launch<112>(qkv, out, dout, lse, delta, dqkv, B, L, H, D, scale, s);
    default: return (int)launch<128>(qkv, out, dout, lse, delta, dqkv, B, L, H, D, scale, s);
  }
}
