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
// Scratch rows, 2 * B * H * Lpad f32 (Lpad = L rounded up to 64): per
//         (batch, head) each row's lse in log2 units (+inf past L), then
//         delta_i = sum_d dout_id * out_id (0 past L); the mma.sync kernels
//         use its first B * H * L floats for delta alone.
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
// design is two deterministic kernels with no atomics, so dqkv is
// bit-reproducible, as the JAX kernel's is; the split recomputes S and dP in
// both, 7 products instead of 5 (at L = 590 the operations floor goes from
// 115 to ~161 us at B = 64, H = 8):
//   * the dq kernel: per (batch, head) block of query rows; it first computes
//     delta for its rows (written with lse to the scratch for the next
//     kernel), keeps Q and dO, streams K/V tiles and accumulates dQ = dS K;
//   * the dkv kernel: per (batch, head) block of keys; it keeps K and V,
//     streams Q/dO tiles with their lse and delta, works on the transposed
//     scores S^T = K Q^T and accumulates dV = P^T dO and dK = dS^T Q.
// Both are launched back to back on one stream (dq first: it writes delta).
//
// Head dims 64 and 72 (every path of the port, U-ViT-H among them): the
// wgmma kernels, on the structure of attention_fwd.cuh's forward loop:
//   - a CTA owns rows of one (batch, head): 64 a consumer warpgroup, three
//     warpgroups (192 query rows) in the dq kernel, two (128 keys) in the
//     dkv kernel; a producer loads the CTA's resident tiles once (Q and dO,
//     or K and V) and then streams the other operand pair's 64-row tiles
//     through a 3-stage TMA ring, each stage signalled by a `full` mbarrier
//     (TMA byte count) and released by an `empty` one (an arrival per
//     consumer warp); the dkv kernel's stage also carries the tile's 64 lse
//     and 64 delta values (two 256-byte bulk copies from the scratch);
//   - tiles are 64 x 64 boxes in the 128-byte swizzle out of a 3-D
//     (3C, L, B) map of the packed qkv (kernel 1's) and a (C, L, B) map of
//     dout, so rows past L zero-fill per batch;
//   - S = Q K^T, dP = dO V^T, S^T = K Q^T and dP^T = V dO^T are wgmma
//     m64n64k16 with both operands K-major in shared memory; dQ += dS K,
//     dV += P^T dO and dK += dS^T Q take the product rounded to bf16 as the
//     register A operand (the accumulator layout is the A-fragment layout,
//     as P in the forward) and the tile as an MN-major B through the
//     transpose bit, as the forward reads V; each product's first k step
//     overwrites its accumulator (scale-d 0), S and dP (S^T and dP^T) are
//     queued together, and dV's product runs on while dS^T is computed;
//   - both run one CTA an SM.  The dq kernel (a producer warp, 416
//     threads) needs ~126 registers a thread: at two CTAs an SM ptxas
//     capped it below that, spilled and serialized the wgmma pipeline (the
//     backward 1.5-1.6x slower on an H100).  The dkv kernel holds dK, dV, S^T, dP^T and the
//     packed P^T and dS^T (~170 registers), so its producer is a whole
//     warpgroup that gives its registers to the consumers (setmaxnreg
//     40 / 232, kernel 5's remedy).  Queuing tile j + 1's first products
//     behind tile j's last made ptxas serialize every wgmma (C7514 / C7515)
//     and was slower, so each tile's products drain before the next tile's;
//   - ragged L: keys >= L give P = 0 in the dq kernel; query rows >= L carry
//     lse = +inf in the dkv kernel (the scratch's padding), so they add
//     nothing; rows >= L are not stored; a warpgroup whose rows all lie past
//     L exits and the `empty` barriers count only the live ones.
// Head dim 72 takes the forward's two-box tiles (attention_fwd.cuh): columns
// 0-63 in the 128-byte swizzle and columns 64-71 as an unswizzled 1 KB box
// in a 2 KB slot whose second kilobyte is zeroed once a CTA:
//   - the depth-72 products (S = Q K^T and dP = dO V^T in the dq kernel,
//     S^T = K Q^T and dP^T = V dO^T in the dkv kernel) get a fifth k16 step
//     on the slots, columns 64-71 then zeros for 72-79, in both operands
//     (the resident Q and dO, or K and V, and the streamed tiles), so the pad
//     adds nothing; no column of another head is read (in the packed qkv and
//     in dout's (C, L, B) map columns 72-79 of a head are the next head's);
//   - the products with N = 72 (dQ += dS K, dK += dS^T Q, dV += P^T dO) add
//     four m64n8k16 steps on the streamed tile's remainder box read MN-major
//     into 4 more accumulators, queued in the same group as the m64n64
//     steps; only columns < 72 exist, so all are stored;
//   - shared memory: dq 124 KB, dkv 105 KB (10 KB a tile), one CTA an SM as
//     at 64; registers: dq 128 (126 at 64), dkv 168 under setmaxnreg's 232,
//     no spills.  A 16-column box in the 32-byte swizzle with m64n16 steps
//     left the dq kernel at 124 registers with 80 bytes of spills and a
//     serialized wgmma pipeline (C7512).
// Two calls stay bit-identical: no atomics, and each thread sums its rows of
// delta in a fixed order.
// Every other head dim keeps the first design, the mma.sync kernels below:
// 64-row CTAs of 4 warps of mma.sync m16n8k16, single-buffered tiles loaded
// through registers, transposed B fragments gathered with scalar loads, D
// zero-padded to a multiple of 16.  pdm_attention_bwd_path(D) reports the
// choice (a static dispatch on D).
//
// Numerics: as in `_attend_bwd`, P is rounded to bf16 for P^T dO and dS is
// rounded to bf16 for dS K and dS^T Q; dP, delta and the accumulators are
// f32.  The TPU kernel recomputes the normalised P from a fresh row max and
// row sum and takes rowsum(dP o P); this kernel takes P from the forward's
// lse and delta = rowsum(dO o out), which is the same quantity computed from
// the bf16-rounded out (flash-attention style).  The two differ by bf16
// rounding only.
//
// Shapes: any L >= 1 and any head dim D that is a multiple of 8 up to 128.

#include <math.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

// ---- the mma.sync kernels: every head dim but 64 ----

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

// ---- the wgmma kernels: head dims 64 and 72 ----

constexpr int kRows = 64;       // rows of a consumer warpgroup and of a streamed tile
constexpr int kStages = 3;      // ring depth
constexpr int kTile = kRows * 64;  // elements of one 64 x 64 box (8 KB)
constexpr int kTileBytes = kTile * 2;
constexpr int kRemSlot = kRemSlotBytes / 2;  // elements of a remainder slot (hopper.cuh)
// Consumer warpgroups a CTA: 64 rows each.
constexpr int kDqConsumers = 3;
constexpr int kDkvConsumers = 2;
constexpr int kDqThreads = kDqConsumers * 128 + 32;     // + one producer warp
constexpr int kDkvThreads = (kDkvConsumers + 1) * 128;  // + a producer warpgroup
constexpr int kDkvProducerRegs = 40;
constexpr int kDkvConsumerRegs = 232;

// TMA bytes of one tile of a head dim: the 64-column box, plus the remainder
// box (columns 64-71) at 72.  A CTA's dynamic shared memory: resident, a tile
// of each of two tensors a consumer; ring, 2 tiles a stage (at 72 each tile
// with its remainder slot; + the dkv kernel's 64 lse and 64 delta a stage);
// the 1024-byte alignment slack and the barriers.
template <int kD>
__host__ __device__ constexpr int tile_bytes() {
  return kTileBytes + (kD > 64 ? kRemBoxBytes : 0);
}
template <int kD>
__host__ __device__ constexpr int slot_bytes() {
  return kTileBytes + (kD > 64 ? kRemSlotBytes : 0);
}
template <int kD>
__host__ __device__ constexpr int dq_smem() {
  return (2 * kDqConsumers + 2 * kStages) * slot_bytes<kD>() + 1024 + 128;
}
template <int kD>
__host__ __device__ constexpr int dkv_smem() {
  return (2 * kDkvConsumers + 2 * kStages) * slot_bytes<kD>() + kStages * 2 * kRows * 4 + 1024 +
         128;
}

inline bool attention_bwd_uses_tma(int D) { return D == 64 || D == 72; }

__device__ __forceinline__ unsigned char* align_1024(unsigned char* smem_raw) {
  const uint32_t raw = smem_u32(smem_raw);
  return smem_raw + (((raw + 1023u) & ~1023u) - raw);
}

// Rows row .. row + 63 of the columns of one head from `col`: the 64-column
// box, and at kD 72 the remainder box (columns col + 64 .. col + 71) into
// `dst_rem`, on the same barrier.
template <int kD>
__device__ __forceinline__ void tma_head_tile(void* dst, void* dst_rem, const CUtensorMap* map,
                                              const CUtensorMap* map_rem, uint64_t* bar, int col,
                                              int row, int b) {
  tma_load_3d(dst, map, bar, col, row, b);
  if constexpr (kD > 64) tma_load_3d(dst_rem, map_rem, bar, col + 64, row, b);
}

// acc = A B^T for 64-row tiles, both K-major over the head dim (four k16
// steps, 32 bytes apart in each 128-byte row; at kD 72 a fifth over the
// remainder slots: columns 64-71, then zeros), queued as one group; the
// first step overwrites acc (scale-d 0).
template <bool kRem>
__device__ __forceinline__ void mma_abt_tiles(float (&acc)[32], uint64_t desc_a, uint64_t desc_b,
                                              uint64_t desc_a_rem, uint64_t desc_b_rem) {
  wgmma_fence();
  wgmma_m64n64k16_ss(acc, desc_a, desc_b, 0);
#pragma unroll
  for (int kk = 1; kk < 4; ++kk) wgmma_m64n64k16_ss(acc, desc_a + 2 * kk, desc_b + 2 * kk);
  if constexpr (kRem) wgmma_m64n64k16_ss(acc, desc_a_rem, desc_b_rem);
  wgmma_commit();
}

// acc += X T for X the bf16 A fragments of a 64 x 64 product (fragment kk:
// columns 16 kk .. 16 kk + 15) and T a 64-row tile read MN-major (16 rows of
// 128 bytes a k step); at kD 72 also acc_rem += X T_rem over the remainder
// box (columns 64-71, 16 rows of 16 bytes a k step); queued as one group.
template <bool kRem>
__device__ __forceinline__ void mma_xt_tile(float (&acc)[32], float (&acc_rem)[4],
                                            const uint32_t (&x)[4][4], uint64_t desc_t,
                                            uint64_t desc_t_rem) {
  reg_fence(acc);
  if constexpr (kRem) reg_fence(acc_rem);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_m64n64k16_rs_tnsp_b(acc, x[kk], desc_t + ((kk * 16 * 128) >> 4));
  }
  if constexpr (kRem) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_m64n8k16_rs_tnsp_b(acc_rem, x[kk], desc_t_rem + ((kk * 16 * 16) >> 4));
    }
  }
  wgmma_commit();
}

// Rows row0 and row0 + 8 of an accumulator (columns 0-63, and at kD 72
// columns 64-71 from acc_rem) into the packed (B, L, 3C) dqkv at `dst`
// (batch row 0, this head's column 0); rows >= L not stored.
template <bool kRem>
__device__ __forceinline__ void store_acc(__nv_bfloat16* dst, long row_stride,
                                          const float (&acc)[32], const float (&acc_rem)[4],
                                          int row0, int L, int tig) {
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int col = dt * 8 + tig * 2;
    if (row0 < L) {
      *reinterpret_cast<uint32_t*>(dst + row0 * row_stride + col) =
          pack_bf16(acc[4 * dt], acc[4 * dt + 1]);
    }
    if (row0 + 8 < L) {
      *reinterpret_cast<uint32_t*>(dst + (row0 + 8) * row_stride + col) =
          pack_bf16(acc[4 * dt + 2], acc[4 * dt + 3]);
    }
  }
  if constexpr (kRem) {
    const int col = 64 + tig * 2;
    if (row0 < L) {
      *reinterpret_cast<uint32_t*>(dst + row0 * row_stride + col) =
          pack_bf16(acc_rem[0], acc_rem[1]);
    }
    if (row0 + 8 < L) {
      *reinterpret_cast<uint32_t*>(dst + (row0 + 8) * row_stride + col) =
          pack_bf16(acc_rem[2], acc_rem[3]);
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kDqThreads, 1)
    dq_tma_kernel(const __grid_constant__ CUtensorMap map_qkv,
                  const __grid_constant__ CUtensorMap map_do,
                  const __grid_constant__ CUtensorMap map_qkv_rem,
                  const __grid_constant__ CUtensorMap map_do_rem,
                  const __nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ rows,
                  __nv_bfloat16* __restrict__ dqkv, int L, int H, float scale) {
  static_assert(kD == 64 || kD == 72, "the wgmma kernels take head dims 64 and 72");
  constexpr bool kRem = kD > 64;
  extern __shared__ unsigned char smem_raw[];
  // The 64-column boxes, then the remainder slots.
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(align_1024(smem_raw));
  __nv_bfloat16* sDO = sQ + kDqConsumers * kTile;
  __nv_bfloat16* sK = sDO + kDqConsumers * kTile;
  __nv_bfloat16* sV = sK + kStages * kTile;
  __nv_bfloat16* sQr = sV + kStages * kTile;
  __nv_bfloat16* sDOr = sQr + kDqConsumers * kRemSlot;
  __nv_bfloat16* sKr = sDOr + kDqConsumers * kRemSlot;
  __nv_bfloat16* sVr = sKr + kStages * kRemSlot;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kRem ? sVr + kStages * kRemSlot : sQr);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int q0 = blockIdx.x * (kDqConsumers * kRows);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C = H * kD;
  const int live = min(kDqConsumers, (L - q0 + kRows - 1) / kRows);
  const int n_tiles = (L + kRows - 1) / kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * live);
    }
    mbar_fence_init();
  }
  if constexpr (kRem) zero_rem_slots(sQr, 2 * kDqConsumers + 2 * kStages);
  __syncthreads();

  if (wg == kDqConsumers) {  // the producer warp
    if (lane == 0) {
      mbar_expect_tx(q_full, 2 * live * tile_bytes<kD>());
      for (int w = 0; w < live; ++w) {
        tma_head_tile<kD>(sQ + w * kTile, sQr + w * kRemSlot, &map_qkv, &map_qkv_rem, q_full,
                          h * kD, q0 + w * kRows, b);
        tma_head_tile<kD>(sDO + w * kTile, sDOr + w * kRemSlot, &map_do, &map_do_rem, q_full,
                          h * kD, q0 + w * kRows, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);  // round 0 passes at once
        mbar_expect_tx(&full[s], 2 * tile_bytes<kD>());
        tma_head_tile<kD>(sK + s * kTile, sKr + s * kRemSlot, &map_qkv, &map_qkv_rem, &full[s],
                          C + h * kD, j * kRows, b);
        tma_head_tile<kD>(sV + s * kTile, sVr + s * kRemSlot, &map_qkv, &map_qkv_rem, &full[s],
                          2 * C + h * kD, j * kRows, b);
      }
    }
    return;
  }
  if (wg >= live) return;  // every row of this warpgroup is >= L

  const int wl = warp & 3;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int row0 = q0 + wg * kRows + wl * 16 + gid;  // this thread's rows: row0, row0 + 8
  const long bh = (long)b * H + h;
  const long lpad = (long)n_tiles * kRows;

  // delta of rows row0 and row0 + 8: the four threads of a row group sum
  // the row's 16-byte chunks tig, tig + 4, ...; then both rows' lse (log2
  // units) and delta go to the scratch for the dkv kernel (rows of a live
  // warpgroup are < lpad).
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    float acc = 0.f;
    if (row < L) {
      const long off = ((long)b * L + row) * C + h * kD;
      const uint4* op = reinterpret_cast<const uint4*>(out + off);
      const uint4* gp = reinterpret_cast<const uint4*>(dout + off);
#pragma unroll
      for (int i = 0; i < (kD / 8 + 3) / 4; ++i) {
        const int c = tig + 4 * i;
        if (c < kD / 8) {
          const uint4 ov = __ldg(op + c);
          const uint4 gv = __ldg(gp + c);
          const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 of = __bfloat1622float2(o2[e]);
            const float2 gf = __bfloat1622float2(g2[e]);
            acc += of.x * gf.x + of.y * gf.y;
          }
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dl[r] = acc;
    lse2[r] = row < L ? lse[bh * L + row] * kLog2e : INFINITY;
    if (tig == 0) {
      rows[bh * 2 * lpad + row] = lse2[r];
      rows[(bh * 2 + 1) * lpad + row] = acc;
    }
  }
  const float scale_log2 = scale * kLog2e;

  float dq[32], dq_rem[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  const uint64_t desc_q = sw128_desc(smem_u32(sQ + wg * kTile), 16, 1024);
  const uint64_t desc_do = sw128_desc(smem_u32(sDO + wg * kTile), 16, 1024);
  const uint64_t desc_q_rem = rem_desc_k(smem_u32(sQr + wg * kRemSlot));
  const uint64_t desc_do_rem = rem_desc_k(smem_u32(sDOr + wg * kRemSlot));
  mbar_wait(q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const uint64_t desc_k = sw128_desc(smem_u32(sK + s * kTile), 16, 1024);
    const uint64_t desc_v = sw128_desc(smem_u32(sV + s * kTile), 16, 1024);
    const uint32_t k_rem = smem_u32(sKr + s * kRemSlot);
    const uint64_t desc_k_rem = rem_desc_k(k_rem);
    const uint64_t desc_v_rem = rem_desc_k(smem_u32(sVr + s * kRemSlot));
    mbar_wait(&full[s], (j / kStages) & 1);
    float sc[32], dp[32];
    mma_abt_tiles<kRem>(sc, desc_q, desc_k, desc_q_rem, desc_k_rem);     // S = Q K^T
    mma_abt_tiles<kRem>(dp, desc_do, desc_v, desc_do_rem, desc_v_rem);  // dP = dO V^T, queued
    wgmma_wait<1>();
    reg_fence(sc);
    // P from the forward's lse; keys >= L (zero-filled K rows) give 0.
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = j * kRows + (i >> 2) * 8 + tig * 2 + (i & 1);
      sc[i] = key < L ? exp2f(sc[i] * scale_log2 - lse2[(i >> 1) & 1]) : 0.f;
    }
    wgmma_wait<0>();
    reg_fence(dp);
    // dS = P o (dP - delta) * scale, rounded to bf16: register i of the
    // accumulator is row (i >> 1) & 1, and fragment kk takes registers
    // 8 kk .. 8 kk + 7 (pairs 2 e, 2 e + 1 of row e & 1).
    uint32_t ds[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * kk + 2 * e;
        ds[kk][e] = pack_bf16(sc[i] * (dp[i] - dl[e & 1]) * scale,
                              sc[i + 1] * (dp[i + 1] - dl[e & 1]) * scale);
      }
    }
    mma_xt_tile<kRem>(dq, dq_rem, ds, desc_k, rem_desc_mn(k_rem));  // dQ += dS K
    wgmma_wait<0>();
    reg_fence(dq);
    if constexpr (kRem) reg_fence(dq_rem);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
  }
  const long row_stride = 3L * C;
  store_acc<kRem>(dqkv + (long)b * L * row_stride + h * kD, row_stride, dq, dq_rem, row0, L,
                  tig);
}

template <int kD>
__global__ void __launch_bounds__(kDkvThreads, 1)
    dkv_tma_kernel(const __grid_constant__ CUtensorMap map_qkv,
                   const __grid_constant__ CUtensorMap map_do,
                   const __grid_constant__ CUtensorMap map_qkv_rem,
                   const __grid_constant__ CUtensorMap map_do_rem, const float* __restrict__ rows,
                   __nv_bfloat16* __restrict__ dqkv, int L, int H, float scale) {
  static_assert(kD == 64 || kD == 72, "the wgmma kernels take head dims 64 and 72");
  constexpr bool kRem = kD > 64;
  extern __shared__ unsigned char smem_raw[];
  // The 64-column boxes, the remainder slots, then the lse / delta stages.
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(align_1024(smem_raw));
  __nv_bfloat16* sV = sK + kDkvConsumers * kTile;
  __nv_bfloat16* sQ = sV + kDkvConsumers * kTile;
  __nv_bfloat16* sDO = sQ + kStages * kTile;
  __nv_bfloat16* sKr = sDO + kStages * kTile;
  __nv_bfloat16* sVr = sKr + kDkvConsumers * kRemSlot;
  __nv_bfloat16* sQr = sVr + kDkvConsumers * kRemSlot;
  __nv_bfloat16* sDOr = sQr + kStages * kRemSlot;
  // a stage: 64 lse, 64 delta
  float* sRow = reinterpret_cast<float*>(kRem ? sDOr + kStages * kRemSlot : sKr);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sRow + kStages * 2 * kRows);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int k0 = blockIdx.x * (kDkvConsumers * kRows);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C = H * kD;
  const int live = min(kDkvConsumers, (L - k0 + kRows - 1) / kRows);
  const int n_tiles = (L + kRows - 1) / kRows;
  const long bh = (long)b * H + h;
  const long lpad = (long)n_tiles * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * live);
    }
    mbar_fence_init();
  }
  if constexpr (kRem) zero_rem_slots(sKr, 2 * kDkvConsumers + 2 * kStages);
  __syncthreads();

  if (wg == kDkvConsumers) {  // the producer warpgroup: one thread issues every load
    setmaxnreg_dec<kDkvProducerRegs>();
    if (warp == 4 * kDkvConsumers && lane == 0) {
      mbar_expect_tx(kv_full, 2 * live * tile_bytes<kD>());
      for (int w = 0; w < live; ++w) {
        tma_head_tile<kD>(sK + w * kTile, sKr + w * kRemSlot, &map_qkv, &map_qkv_rem, kv_full,
                          C + h * kD, k0 + w * kRows, b);
        tma_head_tile<kD>(sV + w * kTile, sVr + w * kRemSlot, &map_qkv, &map_qkv_rem, kv_full,
                          2 * C + h * kD, k0 + w * kRows, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);  // round 0 passes at once
        mbar_expect_tx(&full[s], 2 * tile_bytes<kD>() + 2 * kRows * 4);
        tma_head_tile<kD>(sQ + s * kTile, sQr + s * kRemSlot, &map_qkv, &map_qkv_rem, &full[s],
                          h * kD, j * kRows, b);
        tma_head_tile<kD>(sDO + s * kTile, sDOr + s * kRemSlot, &map_do, &map_do_rem, &full[s],
                          h * kD, j * kRows, b);
        bulk_load(sRow + s * 2 * kRows, rows + bh * 2 * lpad + j * kRows, kRows * 4, &full[s]);
        bulk_load(sRow + s * 2 * kRows + kRows, rows + (bh * 2 + 1) * lpad + j * kRows, kRows * 4,
                  &full[s]);
      }
    }
    return;
  }
  setmaxnreg_inc<kDkvConsumerRegs>();
  if (wg >= live) return;  // every key of this warpgroup is >= L

  const int wl = warp & 3;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const float scale_log2 = scale * kLog2e;
  float dk[32], dv[32], dk_rem[4] = {0.f, 0.f, 0.f, 0.f}, dv_rem[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  const uint64_t desc_k = sw128_desc(smem_u32(sK + wg * kTile), 16, 1024);
  const uint64_t desc_v = sw128_desc(smem_u32(sV + wg * kTile), 16, 1024);
  const uint64_t desc_k_rem = rem_desc_k(smem_u32(sKr + wg * kRemSlot));
  const uint64_t desc_v_rem = rem_desc_k(smem_u32(sVr + wg * kRemSlot));
  mbar_wait(kv_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const uint64_t desc_q = sw128_desc(smem_u32(sQ + s * kTile), 16, 1024);
    const uint64_t desc_do = sw128_desc(smem_u32(sDO + s * kTile), 16, 1024);
    const uint32_t q_rem = smem_u32(sQr + s * kRemSlot);
    const uint32_t do_rem = smem_u32(sDOr + s * kRemSlot);
    const uint64_t desc_q_rem = rem_desc_k(q_rem);
    const uint64_t desc_do_rem = rem_desc_k(do_rem);
    const float* sl = sRow + s * 2 * kRows;  // the tile's lse (log2 units), then delta
    mbar_wait(&full[s], (j / kStages) & 1);

    // Transposed scores: rows are this warpgroup's keys, columns the tile's
    // queries; register i is column (i >> 2) * 8 + 2 tig + (i & 1).
    float st[32], dpt[32];
    mma_abt_tiles<kRem>(st, desc_k, desc_q, desc_k_rem, desc_q_rem);     // S^T = K Q^T
    mma_abt_tiles<kRem>(dpt, desc_v, desc_do, desc_v_rem, desc_do_rem);  // dP^T = V dO^T
    wgmma_wait<1>();
    reg_fence(st);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float2 l2 = *reinterpret_cast<const float2*>(sl + c * 8 + tig * 2);
      st[4 * c] = exp2f(st[4 * c] * scale_log2 - l2.x);  // P^T; query rows >= L: 0
      st[4 * c + 1] = exp2f(st[4 * c + 1] * scale_log2 - l2.y);
      st[4 * c + 2] = exp2f(st[4 * c + 2] * scale_log2 - l2.x);
      st[4 * c + 3] = exp2f(st[4 * c + 3] * scale_log2 - l2.y);
    }
    uint32_t pt[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) pt[kk][e] = pack_bf16(st[8 * kk + 2 * e], st[8 * kk + 2 * e + 1]);
    }
    mma_xt_tile<kRem>(dv, dv_rem, pt, desc_do, rem_desc_mn(do_rem));  // dV += P^T dO
    wgmma_wait<1>();  // dP^T is done; dV, queued behind it, may run on
    reg_fence(dpt);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float2 d2 = *reinterpret_cast<const float2*>(sl + kRows + c * 8 + tig * 2);
      dpt[4 * c] = st[4 * c] * (dpt[4 * c] - d2.x) * scale;  // dS^T
      dpt[4 * c + 1] = st[4 * c + 1] * (dpt[4 * c + 1] - d2.y) * scale;
      dpt[4 * c + 2] = st[4 * c + 2] * (dpt[4 * c + 2] - d2.x) * scale;
      dpt[4 * c + 3] = st[4 * c + 3] * (dpt[4 * c + 3] - d2.y) * scale;
    }
    uint32_t dst[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dst[kk][e] = pack_bf16(dpt[8 * kk + 2 * e], dpt[8 * kk + 2 * e + 1]);
      }
    }
    mma_xt_tile<kRem>(dk, dk_rem, dst, desc_q, rem_desc_mn(q_rem));  // dK += dS^T Q
    wgmma_wait<0>();
    reg_fence(dv);
    reg_fence(dk);
    if constexpr (kRem) {
      reg_fence(dv_rem);
      reg_fence(dk_rem);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
  }
  const long row_stride = 3L * C;
  const int row0 = k0 + wg * kRows + wl * 16 + gid;
  __nv_bfloat16* dst0 = dqkv + (long)b * L * row_stride + h * kD;
  store_acc<kRem>(dst0 + C, row_stride, dk, dk_rem, row0, L, tig);
  store_acc<kRem>(dst0 + 2 * C, row_stride, dv, dv_rem, row0, L, tig);
}

template <int kD>
cudaError_t launch_tma(const void* qkv, const void* out, const void* dout, const float* lse,
                       float* rows, void* dqkv, int B, int L, int H, float scale,
                       cudaStream_t stream) {
  CUtensorMap map_qkv, map_do, map_qkv_rem, map_do_rem;
  cudaError_t err;
  const int C = H * kD;
  if ((err = encode_rows_map(&map_qkv, qkv, 3LL * L * C, 3 * C, 3 * C, L, B)) != cudaSuccess ||
      (err = encode_rows_map(&map_do, dout, (long long)L * C, C, C, L, B)) != cudaSuccess) {
    return err;
  }
  map_qkv_rem = map_qkv;  // never read at head dim 64
  map_do_rem = map_do;
  if (kD > 64 &&
      ((err = encode_rows_map(&map_qkv_rem, qkv, 3LL * L * C, 3 * C, 3 * C, L, B, 8)) !=
           cudaSuccess ||
       (err = encode_rows_map(&map_do_rem, dout, (long long)L * C, C, C, L, B, 8)) !=
           cudaSuccess)) {
    return err;
  }
  if ((err = cudaFuncSetAttribute(dq_tma_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  dq_smem<kD>())) != cudaSuccess ||
      (err = cudaFuncSetAttribute(dkv_tma_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  dkv_smem<kD>())) != cudaSuccess) {
    return err;
  }
  const dim3 dq_grid((L + kDqConsumers * kRows - 1) / (kDqConsumers * kRows), H, B);
  const dim3 dkv_grid((L + kDkvConsumers * kRows - 1) / (kDkvConsumers * kRows), H, B);
  auto* dq = static_cast<__nv_bfloat16*>(dqkv);
  dq_tma_kernel<kD><<<dq_grid, kDqThreads, dq_smem<kD>(), stream>>>(
      map_qkv, map_do, map_qkv_rem, map_do_rem, static_cast<const __nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(dout), lse, rows, dq, L, H, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkv_tma_kernel<kD><<<dkv_grid, kDkvThreads, dkv_smem<kD>(), stream>>>(
      map_qkv, map_do, map_qkv_rem, map_do_rem, rows, dq, L, H, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error code of the launches (0 on success).  Launches on
// `stream` and does not synchronise; `dqkv` and the `rows` scratch (at least
// 2 * B * H * Lpad f32, Lpad = L rounded up to 64) are allocated by the
// caller; every pointer is 16-byte aligned.
extern "C" int pdm_fused_qkv_attention_bwd(const void* qkv, const void* out, const void* dout,
                                           const float* lse, float* rows, void* dqkv, int B,
                                           int L, int H, int D, float scale, int device,
                                           void* stream) {
  if (B < 1 || L < 1 || H < 1 || D < 8 || D > 128 || D % 8 != 0 || B > 65535 || H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (attention_bwd_uses_tma(D)) {
    return (int)(D == 64 ? launch_tma<64>(qkv, out, dout, lse, rows, dqkv, B, L, H, scale, s)
                         : launch_tma<72>(qkv, out, dout, lse, rows, dqkv, B, L, H, scale, s));
  }
  float* delta = rows;
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

// 1 if head dim D takes the wgmma + TMA kernels, 0 if the mma.sync ones.
extern "C" int pdm_attention_bwd_path(int D) { return attention_bwd_uses_tma(D) ? 1 : 0; }

// Dynamic shared memory a CTA of the wgmma dq kernel (dkv = 0) or dkv kernel
// (dkv = 1) takes at head dim D, in bytes (0 if D does not take them).
extern "C" int pdm_attention_bwd_tma_smem_bytes(int dkv, int D) {
  if (D == 64) return dkv ? dkv_smem<64>() : dq_smem<64>();
  if (D == 72) return dkv ? dkv_smem<72>() : dq_smem<72>();
  return 0;
}
