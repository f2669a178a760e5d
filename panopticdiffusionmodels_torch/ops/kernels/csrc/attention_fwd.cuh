// The attention forward tile loop shared by the packed-qkv kernel
// (fused_qkv_attention.cu) and the (B, H, L, D) kernel (fused_attention.cu).
// The two differ only in where q, k, v and out live, which each source
// states as (batch, head, row) strides; see those sources for what bounds
// the kernel and what its design does about it.
//
// Per (batch, head): out = softmax(q k^T * scale) v, with q, k, v and out
// bf16 and unit stride along the head dim D; lse (B, H, L) f32, contiguous,
// optional (null skips it): each row's natural-log log-sum-exp of the scaled
// scores, ln(sum_j exp(q.k_j * scale)).
//
// One CTA owns a 64-row query tile of one (batch, head), keeps its Q
// fragments in registers, streams 64-key K/V tiles through shared memory and
// keeps the running max, the running sum and the (64, D) accumulator in
// registers (online softmax), so the (L, L) scores never reach device
// memory.  Products run on the tensor cores through mma.sync m16n8k16 (bf16
// in, f32 accumulate).
//
// Numerics: scores, running max/sum and accumulation are f32; P is rounded to
// bf16 for the PV product, before its normalisation, which is deferred to the
// epilogue (the division by the row sum, flash style).
//
// Shapes: any L >= 1 (keys >= L score -inf, query rows >= L are not stored)
// and any D that is a multiple of 8 up to 128; D is padded with zeros to the
// next multiple of 16 in shared memory, and padded output columns are not
// stored.
//
// Simple on purpose: single-buffered tiles loaded with plain 16-byte loads,
// V fragments gathered with scalar shared-memory loads.  TMA, wgmma and a
// multi-stage pipeline are later work.

#pragma once

#include <math.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kBlockM = 64;  // query rows per CTA, 16 per warp
constexpr int kBlockN = 64;  // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
static_assert(kBlockM == kBlockN, "Q tiles are loaded as kBlockN-row tiles");
static_assert(kBlockM == kWarps * 16, "one 16-row mma slice per warp");

struct Strides {
  long b, h, l;  // (batch, head, row) strides in elements
};

template <int DP>
__global__ void __launch_bounds__(kThreads)
    attention_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                         float* __restrict__ lse, Strides qs, Strides ks, Strides vs,
                         Strides os, int L, int H, int D, float scale_log2) {
  constexpr int kStride = DP + 8;       // shared-memory row stride, padded against bank conflicts
  constexpr int kChunksD = DP / 16;     // k-steps of Q K^T over the head dim
  constexpr int kTilesN = kBlockN / 8;  // 8-key column tiles of S
  constexpr int kTilesD = DP / 8;       // 8-wide column tiles of O

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBlockM * kStride;
  __nv_bfloat16* sV = sK + kBlockN * kStride;
  const unsigned short* sV16 = reinterpret_cast<const unsigned short*>(sV);

  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;  // fragment row group
  const int tig = lane & 3;   // thread in group
  const int wr = warp * 16;   // this warp's first row in the tile

  load_tile<DP, kBlockM, kThreads>(sQ, qb, qs.l, q0, L, D);
  __syncthreads();
  uint32_t qf[kChunksD][4];
#pragma unroll
  for (int kc = 0; kc < kChunksD; ++kc) {
    const __nv_bfloat16* p0 = sQ + (wr + gid) * kStride + kc * 16 + tig * 2;
    const __nv_bfloat16* p1 = p0 + 8 * kStride;
    qf[kc][0] = ld_pair(p0);
    qf[kc][1] = ld_pair(p1);
    qf[kc][2] = ld_pair(p0 + 8);
    qf[kc][3] = ld_pair(p1 + 8);
  }

  float o[kTilesD][4];
#pragma unroll
  for (int dt = 0; dt < kTilesD; ++dt) {
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  }
  // Rows gid and gid + 8 of the warp's slice: running max (log2 domain) and
  // this thread's share of the running sum.
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < L; k0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<DP, kBlockN, kThreads>(sK, kb, ks.l, k0, L, D);
    load_tile<DP, kBlockN, kThreads>(sV, vb, vs.l, k0, L, D);
    __syncthreads();

    float s[kTilesN][4];
#pragma unroll
    for (int nt = 0; nt < kTilesN; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kp = sK + (nt * 8 + gid) * kStride + tig * 2;
#pragma unroll
      for (int kc = 0; kc < kChunksD; ++kc) {
        const uint32_t bf[2] = {ld_pair(kp + kc * 16), ld_pair(kp + kc * 16 + 8)};
        mma_16816(s[nt], qf[kc], bf);
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kTilesN; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + tig * 2 + (e & 1);
        const float sv = key < L ? s[nt][e] * scale_log2 : -INFINITY;
        s[nt][e] = sv;
        mx[e >> 1] = fmaxf(mx[e >> 1], sv);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // key k0 < L is valid in every tile, so the new max is finite.
      const float m_new = fmaxf(m_run[r], mx[r]);
      corr[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kTilesN; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m_run[e >> 1]);
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
    }
    l_run[0] = l_run[0] * corr[0] + rs[0];
    l_run[1] = l_run[1] * corr[1] + rs[1];
#pragma unroll
    for (int dt = 0; dt < kTilesD; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }

    // O += P V: the S accumulator layout of key tiles (2j, 2j+1) is exactly
    // the A-fragment layout of the 16-key chunk j.
#pragma unroll
    for (int j = 0; j < kBlockN / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      const int kr = j * 16 + tig * 2;
#pragma unroll
      for (int dt = 0; dt < kTilesD; ++dt) {
        const int col = dt * 8 + gid;
        const uint32_t bf[2] = {
            (uint32_t)sV16[kr * kStride + col] | ((uint32_t)sV16[(kr + 1) * kStride + col] << 16),
            (uint32_t)sV16[(kr + 8) * kStride + col] |
                ((uint32_t)sV16[(kr + 9) * kStride + col] << 16)};
        mma_16816(o[dt], pa, bf);
      }
    }
  }

  const int row0 = q0 + wr + gid;
  const int row1 = row0 + 8;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / l;
    // m_run is in log2 units of the scaled score; back to natural log.
    const int row = r ? row1 : row0;
    if (lse != nullptr && tig == 0 && row < L) {
      lse[((long)b * H + h) * L + row] = (m_run[r] + log2f(l)) * 0.6931471805599453f;
    }
  }
  __nv_bfloat16* obase = out + b * os.b + h * os.h;
#pragma unroll
  for (int dt = 0; dt < kTilesD; ++dt) {
    const int col = dt * 8 + tig * 2;  // D % 8 == 0, so col < D implies col + 1 < D
    if (col < D) {
      if (row0 < L) {
        *reinterpret_cast<uint32_t*>(obase + row0 * os.l + col) =
            pack_bf16(o[dt][0] * inv[0], o[dt][1] * inv[0]);
      }
      if (row1 < L) {
        *reinterpret_cast<uint32_t*>(obase + row1 * os.l + col) =
            pack_bf16(o[dt][2] * inv[1], o[dt][3] * inv[1]);
      }
    }
  }
}

template <int DP>
cudaError_t launch_attention_fwd_dp(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, __nv_bfloat16* out, float* lse,
                                    Strides qs, Strides ks, Strides vs, Strides os, int B, int H,
                                    int L, int D, float scale, cudaStream_t stream) {
  const int smem = (kBlockM + 2 * kBlockN) * (DP + 8) * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kBlockM - 1) / kBlockM, H, B);
  attention_fwd_kernel<DP><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, lse, qs, ks, vs, os, L, H, D, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// Launches on `device`'s `stream` and does not synchronise; returns the CUDA
// error code of the launch (0 on success).  Every stride and base pointer
// must keep rows 16-byte aligned (out's 4-byte aligned).
inline int launch_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                float* lse, Strides qs, Strides ks, Strides vs, Strides os,
                                int B, int H, int L, int D, float scale, int device,
                                void* stream) {
  if (B < 1 || H < 1 || L < 1 || D < 8 || D > 128 || D % 8 != 0 || B > 65535 || H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  cudaError_t (*fn)(const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*,
                    __nv_bfloat16*, float*, Strides, Strides, Strides, Strides, int, int, int,
                    int, float, cudaStream_t);
  switch ((D + 15) / 16) {
    case 1: fn = launch_attention_fwd_dp<16>; break;
    case 2: fn = launch_attention_fwd_dp<32>; break;
    case 3: fn = launch_attention_fwd_dp<48>; break;
    case 4: fn = launch_attention_fwd_dp<64>; break;
    case 5: fn = launch_attention_fwd_dp<80>; break;
    case 6: fn = launch_attention_fwd_dp<96>; break;
    case 7: fn = launch_attention_fwd_dp<112>; break;
    default: fn = launch_attention_fwd_dp<128>; break;
  }
  return (int)fn(qp, kp, vp, op, lse, qs, ks, vs, os, B, H, L, D, scale,
                 static_cast<cudaStream_t>(stream));
}

}  // namespace
