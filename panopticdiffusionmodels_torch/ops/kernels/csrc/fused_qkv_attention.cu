// Attention straight from the qkv GEMM's packed output, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// panopticdiffusionmodels_tpu/ops/pallas/fused_qkv_attention.py::fused_attention_qkv
// (bodies `_kernel`, `_kernel_long`, `_attend`).
//
// Input  qkv (B, L, 3C) bf16, row-major, columns [q heads | k heads | v heads].
// Output out (B, L, C)  bf16, heads concatenated at columns h*D;
//        lse (B, H, L) f32, optional (null skips it): each row's natural-log
//        log-sum-exp of the scaled scores, ln(sum_j exp(q.k_j * scale)), which
//        the backward kernel (fused_qkv_attention_bwd.cu) reads to rebuild P.
// Per head: softmax(q k^T * scale) v.  q, k and v are read with strides from
// the packed tensor (row stride 3C, column offsets h*D, C + h*D, 2C + h*D), so
// neither side needs a transpose.
//
// What bounds it on an H100: at the U-ViT shapes (L = 334 / 590, D = 64) the
// two products are 4*B*L^2*C flops against 8*B*L*C bytes in and out, i.e.
// L/2 flops per byte: below the card's ~295 flop/byte ridge for L < 590, so
// the floor is the memory traffic of reading qkv once and writing out once,
// and at L = 590 both floors meet.  The design therefore never writes the
// (L, L) scores to device memory: one CTA owns a 64-row query tile of one
// (batch, head), keeps its Q fragments in registers, streams 64-key K/V
// tiles through shared memory, and keeps the running max, running sum and
// the (64, D) accumulator in registers (online softmax).  Products run on the
// tensor cores through mma.sync m16n8k16 (bf16 in, f32 accumulate).
//
// Numerics: scores, running max/sum and accumulation are f32; P is rounded to
// bf16 for the PV product.  The TPU kernel normalises P by its row sum BEFORE
// the PV product (`_attend`); here the division by the row sum is deferred to
// the epilogue, as flash attention does, so P is rounded to bf16 before
// normalisation.  The two differ by bf16 rounding only.
//
// Shapes: any L >= 1 (the ragged last tile is masked: keys >= L get -inf,
// query rows >= L are not stored) and any head dim D that is a multiple of 8
// up to 128; D is padded with zeros to the next multiple of 16 in shared
// memory, and padded output columns are not stored.  The TPU kernel's
// MAX_FULL_SEQ / Q_CHUNK split, head groups and VMEM budget do not apply.
//
// This first version is simple on purpose: single-buffered tiles loaded with
// plain 16-byte loads, V fragments gathered with scalar shared-memory loads.
// TMA, wgmma and a multi-stage pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;  // query rows per CTA, 16 per warp
constexpr int kBlockN = 64;  // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
static_assert(kBlockM == kBlockN, "load_tile fills kBlockN rows for Q tiles too");
static_assert(kBlockM == kWarps * 16, "one 16-row mma slice per warp");

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two consecutive bf16 at p (p 4-byte aligned) as one 32-bit register; the
// lower-indexed element sits in the low half, as mma fragments expect.
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows x DP tile of one head's q, k or v columns into shared memory; rows past
// L and columns past D are zero-filled.
template <int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long row_stride, int row0, int L, int D) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks per row
  constexpr int kStride = DP + 8;
  for (int i = threadIdx.x; i < kBlockN * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int col = (i % kChunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < L && col < D) {
      v = __ldg(reinterpret_cast<const uint4*>(src + (long)(row0 + r) * row_stride + col));
    }
    *reinterpret_cast<uint4*>(dst + r * kStride + col) = v;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    fused_qkv_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                               __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                               int L, int H, int D, float scale_log2) {
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
  const long row_stride = 3L * C;
  const __nv_bfloat16* base = qkv + (long)b * L * row_stride;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;  // fragment row group
  const int tig = lane & 3;   // thread in group
  const int wr = warp * 16;   // this warp's first row in the tile

  load_tile<DP>(sQ, base + h * D, row_stride, q0, L, D);
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
    load_tile<DP>(sK, base + C + h * D, row_stride, k0, L, D);
    load_tile<DP>(sV, base + 2 * C + h * D, row_stride, k0, L, D);
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
        const float v = key < L ? s[nt][e] * scale_log2 : -INFINITY;
        s[nt][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
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
  __nv_bfloat16* obase = out + (long)b * L * C + h * D;
#pragma unroll
  for (int dt = 0; dt < kTilesD; ++dt) {
    const int col = dt * 8 + tig * 2;  // D % 8 == 0, so col < D implies col + 1 < D
    if (col < D) {
      if (row0 < L) {
        *reinterpret_cast<uint32_t*>(obase + (long)row0 * C + col) =
            pack_bf16(o[dt][0] * inv[0], o[dt][1] * inv[0]);
      }
      if (row1 < L) {
        *reinterpret_cast<uint32_t*>(obase + (long)row1 * C + col) =
            pack_bf16(o[dt][2] * inv[1], o[dt][3] * inv[1]);
      }
    }
  }
}

template <int DP>
cudaError_t launch(const void* qkv, void* out, float* lse, int B, int L, int H, int D,
                   float scale, cudaStream_t stream) {
  const int smem = (kBlockM + 2 * kBlockN) * (DP + 8) * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(fused_qkv_attention_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kBlockM - 1) / kBlockM, H, B);
  fused_qkv_attention_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), lse, L, H, D,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error code of the launch (0 on success).  Launches on
// `stream` and does not synchronise; `out` (and `lse`, unless null) are
// allocated by the caller.
extern "C" int pdm_fused_qkv_attention(const void* qkv, void* out, float* lse, int B, int L,
                                       int H, int D, float scale, int device, void* stream) {
  if (B < 1 || L < 1 || H < 1 || D < 8 || D > 128 || D % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16) {
    case 1: return (int)launch<16>(qkv, out, lse, B, L, H, D, scale, s);
    case 2: return (int)launch<32>(qkv, out, lse, B, L, H, D, scale, s);
    case 3: return (int)launch<48>(qkv, out, lse, B, L, H, D, scale, s);
    case 4: return (int)launch<64>(qkv, out, lse, B, L, H, D, scale, s);
    case 5: return (int)launch<80>(qkv, out, lse, B, L, H, D, scale, s);
    case 6: return (int)launch<96>(qkv, out, lse, B, L, H, D, scale, s);
    case 7: return (int)launch<112>(qkv, out, lse, B, L, H, D, scale, s);
    default: return (int)launch<128>(qkv, out, lse, B, L, H, D, scale, s);
  }
}
