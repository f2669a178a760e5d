// One ring-attention hop's unnormalised partials, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// panopticdiffusionmodels_tpu/ops/pallas/ring_hop.py::attention_hop
// (body `_hop_kernel`).
//
// Inputs  q  (B, Lq, C) bf16, read with strides (batch q_bs, row q_rs,
//            column 1): a view of the local packed qkv (row stride 3C) or a
//            contiguous tensor;
//         kv (B, Lk, 2C) bf16, packed [k heads | v heads], read with strides
//            (batch kv_bs, row kv_rs, column 1): K at column h*D, V at C + h*D;
//         nvalid (B,) int32 on the device: keys >= nvalid[b] of batch row b
//            are padding (one launch covers every sp shard of a hop when the
//            shards are folded into the batch, each row with its own source).
// Outputs o   (B, Lq, C) bf16, heads concatenated: sum_j exp(s_j - m) v_j,
//             NOT divided by the row sum;
//         m   (B, Lq, H) f32: the rowmax of the scaled scores s = q.k * scale,
//             in natural units (JAX's `m_hop`);
//         den (B, Lq, H) f32: sum_j exp(s_j - m) in natural units.
// Padding keys (nvalid <= j < Lk) score the finite -1e30, as `_hop_xla` does:
// a hop whose keys are all padding gives m = -1e30, p = 1 on every column and
// den = Lk, with no NaN, and the cross-hop combine cancels it through
// exp(-1e30 - m) = 0.  Tile columns past Lk score -inf (p = 0).
//
// What bounds it on an H100: 4*B*Lq*Lk*C flops against (2*Lq*C + 2*Lk*C)*2
// bytes in and out per batch row, i.e. about Lq/2 flops per byte at Lq = Lk:
// at the 512-res mask-stream shard (Lq = Lk = 1063) that is above the card's
// ~295 flop/byte bf16 ridge, so the floor is the tensor cores' rate; at the
// image-stream shard (551) the two floors meet.  The (Lq, Lk) scores never
// reach device memory (online softmax).  The TPU kernel's lane-aligned head
// groups, 128-lane stats blocks and Q_CHUNK do not carry over.
//
// Head dims 64 and 72 (every path of the port: 64 for the U-ViT-S and
// U-ViT-L rings, 72 for U-ViT-H's 16 heads of 1152 / 16) run the wgmma loop
// of attention_fwd.cuh in its hop mode, kernel 1's loop with the nvalid
// mask, two lengths and the unnormalised epilogue: per (128 query rows,
// head, batch row) a producer warp loads the Q tiles once and streams 64-key
// K/V tiles through a 3-stage TMA ring (full / empty mbarriers), two
// consumer warpgroups run S = Q K^T and O += P V as wgmma m64n64k16.  The
// tensor maps cover the views the ring passes: q as 3-D (C, Lq, B) with the
// view's row and batch strides (row stride 3C for qkv[..., :C] of the local
// packed shard), kv as (2C, Lk, B) (the rotated contiguous shard, row stride
// 2C, or qkv[..., C:] at hop 0, row stride 3C), 64 x 64 boxes in the
// 128-byte swizzle, K of head h at column D h and V at C + D h; TMA
// zero-fills rows past Lq and Lk per batch row.  At head dim 72 two more
// maps over the same views, q's and kv's (K and V share it), read columns
// 64-71 of each head in unswizzled 8 x 64 boxes from D h + 64 (V's from
// C + D h + 64) into slots whose second kilobyte is zeros, as kernel 1 does
// (attention_fwd.cuh): no column of another head is read.  So a call
// encodes two maps at 64 and four at 72, on the host, every call
// (pdm_ring_hop_encode_us times it).
//
// Every other head dim keeps the first design, the mma.sync kernel below:
// one CTA per (64-row query tile, head, batch row), 4 warps of mma.sync
// m16n8k16, single-buffered 64-key K/V tiles loaded through registers, V
// fragments gathered with scalar shared-memory loads.  No path of the port
// runs a hop at such a head dim; the hop keeps its own predicate,
// hop_uses_tma (the same head dims as kernels 1 and 4), and
// pdm_ring_hop_path(D) reports it.
//
// Numerics: scores and the running statistics are f32, in the log2 domain
// (s * scale * log2 e, exp2); m is converted back to natural units on the
// way out (-1e30 exactly for an all-padding row).  P is rounded to bf16 for
// the PV product, after the online rescaling; `_hop_xla` rounds exp(s - m)
// with the hop's final m.  The two differ by bf16 rounding only.

#include <math.h>

#include <chrono>

#include "attention_fwd.cuh"

namespace {

// The mma.sync kernel takes attention_fwd.cuh's tile constants (kBlockM
// query rows of 4 warps, kBlockN-key tiles) and its kLn2 / kNegBig.
constexpr float kLog2e = 1.4426950408889634f;

// The hop's choice of loop: the wgmma loop at head dims 64 and 72, as in
// kernels 1 and 4 (attention_uses_tma).
inline bool hop_uses_tma(int D) { return D == 64 || D == 72; }

// The wgmma loop's tensor maps over the views the ring passes (see the note
// above): q over (C, Lq, B), k and v sharing one over (2C, Lk, B), and at
// head dim 72 the 8-column remainder boxes over the same views.
cudaError_t encode_hop_maps(TmaMaps* maps, const void* q, long long q_bs, long long q_rs,
                            const void* kv, long long kv_bs, long long kv_rs, int B, int Lq,
                            int Lk, int C, int D) {
  cudaError_t err;
  if ((err = encode_rows_map(&maps->q, q, q_bs, q_rs, C, Lq, B)) != cudaSuccess ||
      (err = encode_rows_map(&maps->k, kv, kv_bs, kv_rs, 2 * C, Lk, B)) != cudaSuccess) {
    return err;
  }
  maps->q_rem = maps->q, maps->k_rem = maps->k;  // never read at head dim 64
  if (D > 64 &&
      ((err = encode_rows_map(&maps->q_rem, q, q_bs, q_rs, C, Lq, B, 8)) != cudaSuccess ||
       (err = encode_rows_map(&maps->k_rem, kv, kv_bs, kv_rs, 2 * C, Lk, B, 8)) != cudaSuccess)) {
    return err;
  }
  maps->v = maps->k, maps->v_rem = maps->k_rem;
  return cudaSuccess;
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    ring_hop_kernel(const __nv_bfloat16* __restrict__ q, long q_bs, long q_rs,
                    const __nv_bfloat16* __restrict__ kv, long kv_bs, long kv_rs,
                    const int* __restrict__ nvalid, __nv_bfloat16* __restrict__ out,
                    float* __restrict__ m_out, float* __restrict__ den_out, int Lq, int Lk,
                    int H, int D, float scale_log2) {
  constexpr int kStride = DP + 8;     // shared-memory row stride, padded against bank conflicts
  constexpr int kChunksD = DP / 16;   // k-steps of Q K^T over the head dim
  constexpr int kTilesN = kBlockN / 8;  // 8-key column tiles of S
  constexpr int kTilesD = DP / 8;     // 8-wide column tiles of O

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBlockM * kStride;
  __nv_bfloat16* sV = sK + kBlockN * kStride;
  const unsigned short* sV16 = reinterpret_cast<const unsigned short*>(sV);

  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int C = H * D;
  const __nv_bfloat16* kbase = kv + (long)b * kv_bs + h * D;
  const __nv_bfloat16* vbase = kbase + C;
  const int nv = min(max(nvalid[b], 0), Lk);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;  // fragment row group
  const int tig = lane & 3;   // thread in group
  const int wr = warp * 16;   // this warp's first row in the tile

  load_tile<DP, kBlockM, kThreads>(sQ, q + (long)b * q_bs + h * D, q_rs, q0, Lq, D);
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

  for (int k0 = 0; k0 < Lk; k0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<DP, kBlockN, kThreads>(sK, kbase, kv_rs, k0, Lk, D);
    load_tile<DP, kBlockN, kThreads>(sV, vbase, kv_rs, k0, Lk, D);
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
        const float v = key < nv ? s[nt][e] * scale_log2
                                 : (key < Lk ? kNegBigLog2 : -INFINITY);
        s[nt][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // key k0 < Lk scores a finite value (real or -1e30) in every tile, so
      // the new max is finite.
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
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = r ? row1 : row0;
    if (tig == 0 && row < Lq) {
      const long idx = ((long)b * Lq + row) * H + h;
      // An all-padding row's max is -1e30 * log2 e; write JAX's -1e30 exactly.
      m_out[idx] = m_run[r] <= 0.5f * kNegBigLog2 ? kNegBig : m_run[r] * kLn2;
      den_out[idx] = l;
    }
  }
  __nv_bfloat16* obase = out + (long)b * Lq * C + h * D;
#pragma unroll
  for (int dt = 0; dt < kTilesD; ++dt) {
    const int col = dt * 8 + tig * 2;  // D % 8 == 0, so col < D implies col + 1 < D
    if (col < D) {
      if (row0 < Lq) {
        *reinterpret_cast<uint32_t*>(obase + (long)row0 * C + col) =
            pack_bf16(o[dt][0], o[dt][1]);
      }
      if (row1 < Lq) {
        *reinterpret_cast<uint32_t*>(obase + (long)row1 * C + col) =
            pack_bf16(o[dt][2], o[dt][3]);
      }
    }
  }
}

template <int DP>
cudaError_t launch(const void* q, long q_bs, long q_rs, const void* kv, long kv_bs, long kv_rs,
                   const int* nvalid, void* out, float* m, float* den, int B, int Lq, int Lk,
                   int H, int D, float scale, cudaStream_t stream) {
  const int smem = (kBlockM + 2 * kBlockN) * (DP + 8) * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(ring_hop_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + kBlockM - 1) / kBlockM, H, B);
  ring_hop_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), q_bs, q_rs, static_cast<const __nv_bfloat16*>(kv),
      kv_bs, kv_rs, nvalid, static_cast<__nv_bfloat16*>(out), m, den, Lq, Lk, H, D,
      scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error code of the launch (0 on success).  Launches on
// `stream` and does not synchronise; `out`, `m` and `den` are allocated by
// the caller, `nvalid` is a device array of B int32.  Strides are in
// elements; every row and batch stride and every base must be 16-byte
// aligned (multiples of 8 elements; TMA's rule for head dims 64 and 72, the
// 16-byte loads' for the others).
extern "C" int pdm_ring_hop(const void* q, long long q_bs, long long q_rs, const void* kv,
                            long long kv_bs, long long kv_rs, const int* nvalid, void* out,
                            float* m, float* den, int B, int Lq, int Lk, int H, int D,
                            float scale, int device, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || H < 1 || D < 8 || D > 128 || D % 8 != 0 || B > 65535 ||
      H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int C = H * D;
  if (hop_uses_tma(D)) {
    TmaMaps maps;
    err = encode_hop_maps(&maps, q, q_bs, q_rs, kv, kv_bs, kv_rs, B, Lq, Lk, C, D);
    if (err != cudaSuccess) return (int)err;
    const Strides os{(long)Lq * C, D, C};  // out is contiguous (B, Lq, C)
    const HopArgs hop{nvalid, m, den, Lk};
    return D == 64 ? launch_attention_tma<3, true, 64>(maps, make_int3(0, 0, C), out, nullptr,
                                                       os, B, H, Lq, scale, stream, hop)
                   : launch_attention_tma<3, true, 72>(maps, make_int3(0, 0, C), out, nullptr,
                                                       os, B, H, Lq, scale, stream, hop);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PDM_HOP_LAUNCH(DP)                                                                  \
  return (int)launch<DP>(q, (long)q_bs, (long)q_rs, kv, (long)kv_bs, (long)kv_rs, nvalid, \
                         out, m, den, B, Lq, Lk, H, D, scale, s)
  switch ((D + 15) / 16) {
    case 1: PDM_HOP_LAUNCH(16);
    case 2: PDM_HOP_LAUNCH(32);
    case 3: PDM_HOP_LAUNCH(48);
    case 4: PDM_HOP_LAUNCH(64);
    case 5: PDM_HOP_LAUNCH(80);
    case 6: PDM_HOP_LAUNCH(96);
    case 7: PDM_HOP_LAUNCH(112);
    default: PDM_HOP_LAUNCH(128);
  }
#undef PDM_HOP_LAUNCH
}

// 1 if head dim D takes the wgmma + TMA loop in the hop, 0 if the mma.sync
// kernel.
extern "C" int pdm_ring_hop_path(int D) { return hop_uses_tma(D) ? 1 : 0; }

// Host microseconds of one encode of the hop's tensor maps at these views
// (the per-call host cost the wgmma loop adds: two maps at head dim 64, four
// at 72), averaged over `iters` encodes; negative if an encode fails or D
// does not take the wgmma loop.
extern "C" double pdm_ring_hop_encode_us(const void* q, long long q_bs, long long q_rs,
                                         const void* kv, long long kv_bs, long long kv_rs, int B,
                                         int Lq, int Lk, int H, int D, int iters) {
  if (!hop_uses_tma(D)) return -1.0;
  TmaMaps maps;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i) {
    if (encode_hop_maps(&maps, q, q_bs, q_rs, kv, kv_bs, kv_rs, B, Lq, Lk, H * D, D) !=
        cudaSuccess) {
      return -1.0;
    }
  }
  const std::chrono::duration<double, std::micro> dt = std::chrono::steady_clock::now() - t0;
  return dt.count() / iters;
}
