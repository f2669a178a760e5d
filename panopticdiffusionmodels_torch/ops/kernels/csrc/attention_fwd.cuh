// The attention forward shared by the packed-qkv kernel
// (fused_qkv_attention.cu, kernel 1) and the (B, H, L, D) kernel
// (fused_attention.cu, kernel 4).  The two differ only in where q, k, v and
// out live, which each source states at its C entry: as TMA tensor maps plus
// (batch, head, row) strides of out for the wgmma loop, and as (batch, head,
// row) strides of all four for the mma.sync loop.
//
// Per (batch, head): out = softmax(q k^T * scale) v, with q, k, v and out
// bf16 and unit stride along the head dim D; lse (B, H, L) f32, contiguous,
// optional (null skips it): each row's natural-log log-sum-exp of the scaled
// scores, ln(sum_j exp(q.k_j * scale)), which kernel 2 reads.
//
// What bounds it on an H100: 4*L^2*D flops against 8*L*D bytes per (batch,
// head), L/2 flops per byte, below the card's ~295 flop/byte bf16 ridge for
// every L the port runs (258, 334, 590), so the floor is reading q, k, v once
// and writing out once; the (L, L) scores never reach device memory (online
// softmax).  Reaching that floor takes overlap: a loop that copies a K/V
// tile through registers between two __syncthreads and then computes leaves
// the memory system and the tensor cores idle in turn.
//
// The wgmma loop (head dims 64 and 72: every main path of the port, U-ViT-H
// among them):
//   - one CTA owns 128 query rows of one (batch, head): two consumer
//     warpgroups of 64 rows and one producer warp;
//   - the producer loads each warpgroup's Q tile once and then fills a
//     3-stage ring of 64-key K and V tiles with TMA, each stage signalled by
//     a `full` mbarrier (TMA byte count) and released by an `empty` mbarrier
//     (one arrival per consumer warp), so the next tiles are in flight while
//     the consumers compute;
//   - S = Q K^T is wgmma m64n64k16 with both operands in shared memory
//     (K-major, 128-byte swizzle as TMA wrote them);
//   - the online softmax runs on the accumulator in registers, log2 domain;
//     keys >= L score -inf;
//   - P is rounded to bf16 in registers and is the register A operand of
//     O += P V (wgmma m64n64k16), V read from shared memory as an MN-major B
//     through the transpose bit;
//   - the division by the row sum is deferred to the epilogue, which stores
//     out (and lse) straight from the accumulator.
//   Ragged L: TMA zero-fills rows past L (per batch: the packed map is 3-D,
//   (3C, L, B), kernel 4's 4-D, (D, L, H, B)), keys >= L score -inf and rows
//   >= L are not stored.  A warpgroup whose 64 rows all lie past L exits at
//   once and the `empty` barriers count only the live ones, so L = 258 runs 3
//   CTAs of (128, 128, 64) live rows, not 384: 320 rows against 258 useful,
//   and 5 key tiles (320 keys).
//
// Head dim 72 (kD = 72).  A 144-byte row does not fit the 128-byte swizzle,
// so each tile of Q, K or V is two TMA boxes on the stage's one `full`
// barrier (byte count summed): columns 0-63 in the 128-byte swizzle as at
// 64, and columns 64-71 as an unswizzled box of 64 rows of 16 bytes (1 KB),
// whose 8-row groups are the 128-byte core matrices of wgmma's interleaved
// layout.  The box sits in a 2 KB slot whose second kilobyte is zeroed once
// a CTA, before the first load:
//   - S's depth is padded to 80: four k16 steps on the swizzled boxes and a
//     fifth on the slots, columns 64-71 then the zeros standing for 72-79
//     (K-major, sbo 128, lbo 1024), in both Q and K, so the pad adds nothing
//     and no column of another head is ever read (in kernel 1's packed map
//     columns 72-79 of head h are head h + 1's first 8, and for the last
//     head the next section's: TMA would not zero them);
//   - O += P V has N = 72: the m64n64 products on V's swizzled box and four
//     m64n8k16 products on its remainder box, read MN-major (8-key core
//     matrices 128 bytes apart), into 4 more accumulators a thread (36);
//   - 83 KB of shared memory a CTA (10 KB a tile: 2 Q tiles and 3 stages of
//     K and V), so two CTAs still fit on an SM, as at 64 (65 KB).
//   Two CTAs of 288 threads leave 112 registers a thread: ptxas gives the
//   loop 96 at 64 and 95 at 72, no spills.  A 16-column remainder box in the
//   32-byte swizzle with m64n16 products needed 115 at 72 and spilled, and
//   it read the next head's columns 72-79, which then had to be zeroed in Q
//   after every load.
//
// The hop mode (kHop, ring_hop.cu, kernel 3) is the same wgmma loop with
// three changes: queries and keys have their own lengths (Lq = L, Lk); keys
// in [nvalid[b], Lk) score the finite -1e30 (a sequence's padding, nvalid
// read per batch row from device memory) and tile columns past Lk score
// -inf; and the epilogue stores o NOT divided by the row sum, with each
// row's max m (natural units, -1e30 exactly for an all-padding row) and sum
// den as (B, Lq, H) f32 in place of lse.  Every key tile is scored, padding
// too: with nvalid = 0 the hop returns o = sum_j v_j and den = Lk.  It runs
// at head dims 64 and 72 (U-ViT-H's rings), with its own predicate
// (ring_hop.cu: hop_uses_tma) and its own tensor maps over the ring's views.
//
// Static dispatch on D: D = 64 and 72 take the wgmma loop; every other D (a
// multiple of 8 up to 128: 40 for the UNet, whose paths launch no kernel)
// keeps the mma.sync loop below (64-row CTAs of 4 warps, 64-key tiles loaded
// through registers, D zero-padded to a multiple of 16 in shared memory).
// pdm_attention_path(D) reports the choice.
//
// Numerics (both loops): scores, running max/sum and accumulation are f32; P
// is rounded to bf16 for the PV product, before its normalisation.

#pragma once

#include <math.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

struct Strides {
  long b, h, l;  // (batch, head, row) strides in elements
};


// ---- the mma.sync loop: every head dim but 64 and 72 ----

constexpr int kBlockM = 64;  // query rows per CTA, 16 per warp
constexpr int kBlockN = 64;  // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
static_assert(kBlockM == kBlockN, "Q tiles are loaded as kBlockN-row tiles");
static_assert(kBlockM == kWarps * 16, "one 16-row mma slice per warp");

template <int DP>
__global__ void __launch_bounds__(kThreads)
    attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
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
cudaError_t launch_attention_mma_dp(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, __nv_bfloat16* out, float* lse,
                                    Strides qs, Strides ks, Strides vs, Strides os, int B, int H,
                                    int L, int D, float scale, cudaStream_t stream) {
  const int smem = (kBlockM + 2 * kBlockN) * (DP + 8) * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(attention_mma_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kBlockM - 1) / kBlockM, H, B);
  attention_mma_kernel<DP><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, lse, qs, ks, vs, os, L, H, D, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// ---- the wgmma loop: head dims 64 and 72 ----

constexpr int kTmaRows = 64;       // rows of a consumer warpgroup, keys of a K/V tile
constexpr int kTmaConsumers = 2;   // consumer warpgroups: 128 query rows per CTA
constexpr int kTmaStages = 3;      // K/V ring depth
constexpr int kTmaThreads = kTmaConsumers * 128 + 32;  // + one producer warp
constexpr int kTmaTile = kTmaRows * 64;                // elements of one 64 x 64 box (8 KB)
constexpr int kTmaTileBytes = kTmaTile * 2;
constexpr int kRemSlot = kRemSlotBytes / 2;            // elements of a remainder slot

// TMA bytes of one tile of a head dim: the 64-column box, plus the
// remainder box (columns 64-71) at 72.  The CTA's dynamic shared memory: 2
// Q tiles and 3 stages of K and V tiles (at 72 each with its remainder
// slot), the 1024-byte alignment slack and the barriers.
template <int kD>
__host__ __device__ constexpr int tma_tile_bytes() {
  return kTmaTileBytes + (kD > 64 ? kRemBoxBytes : 0);
}
template <int kD>
__host__ __device__ constexpr int tma_smem() {
  return (kTmaConsumers + 2 * kTmaStages) * (kTmaTileBytes + (kD > 64 ? kRemSlotBytes : 0)) +
         1024 + 128;
}

inline bool attention_uses_tma(int D) { return D == 64 || D == 72; }

constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegBig = -1e30f;                             // JAX's NEG_BIG, natural units
constexpr float kNegBigLog2 = kNegBig * 1.4426950408889634f;  // the same score in log2 units

// What the hop mode adds (ignored by kernels 1 and 4).
struct HopArgs {
  const int* nvalid;  // (B,) int32: keys >= nvalid[b] of batch row b are padding
  float* m;           // (B, Lq, H) f32 outputs
  float* den;
  int Lk;             // keys; the query count is the kernel's L
};

// The loop's tensor maps: q, k and v in 64-column boxes (128-byte swizzle),
// and at head dim 72 the same in unswizzled 8-column remainder boxes; at head
// dim 64 the remainder maps are never read.
struct TmaMaps {
  CUtensorMap q, k, v, q_rem, k_rem, v_rem;
};

// One tile of rows row .. row + 63 of head h: kRank 3 is kernel 1's packed
// (3C, L, B) map, whose columns for head h start at col0 + kD h; kRank 4 is
// kernel 4's (D, L, H, B).  At kD 72 the remainder box (columns 64-71) lands
// in `dst_rem` on the same barrier.
template <int kRank, int kD>
__device__ __forceinline__ void tma_tile(void* dst, void* dst_rem, const CUtensorMap* map,
                                         const CUtensorMap* map_rem, uint64_t* bar, int col0,
                                         int row, int h, int b) {
  if constexpr (kRank == 3) {
    tma_load_3d(dst, map, bar, col0 + h * kD, row, b);
    if constexpr (kD > 64) tma_load_3d(dst_rem, map_rem, bar, col0 + h * kD + 64, row, b);
  } else {
    tma_load_4d(dst, map, bar, 0, row, h, b);
    if constexpr (kD > 64) tma_load_4d(dst_rem, map_rem, bar, 64, row, h, b);
  }
}

template <int kRank, bool kHop, int kD>
__global__ void __launch_bounds__(kTmaThreads, 2)
    attention_tma_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_q_rem,
                         const __grid_constant__ CUtensorMap map_k_rem,
                         const __grid_constant__ CUtensorMap map_v_rem, int3 col0,
                         __nv_bfloat16* __restrict__ out, float* __restrict__ lse, Strides os,
                         int L, int H, float scale_log2, HopArgs hop) {
  static_assert(kD == 64 || kD == 72, "the wgmma loop takes head dims 64 and 72");
  constexpr bool kRem = kD > 64;
  constexpr int kTileBytes = tma_tile_bytes<kD>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  // The 64-column boxes, then the remainder slots.
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* sK = sQ + kTmaConsumers * kTmaTile;
  __nv_bfloat16* sV = sK + kTmaStages * kTmaTile;
  __nv_bfloat16* sQr = sV + kTmaStages * kTmaTile;
  __nv_bfloat16* sKr = sQr + kTmaConsumers * kRemSlot;
  __nv_bfloat16* sVr = sKr + kTmaStages * kRemSlot;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kRem ? sVr + kTmaStages * kRemSlot : sQr);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kTmaStages;

  const int q0 = blockIdx.x * (kTmaConsumers * kTmaRows);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int Lk = kHop ? hop.Lk : L;
  const int live = min(kTmaConsumers, (L - q0 + kTmaRows - 1) / kTmaRows);
  const int n_tiles = (Lk + kTmaRows - 1) / kTmaRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kTmaStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * live);
    }
    mbar_fence_init();
  }
  if constexpr (kRem) zero_rem_slots(sQr, kTmaConsumers + 2 * kTmaStages);
  __syncthreads();

  if (wg == kTmaConsumers) {  // the producer warp
    if (lane == 0) {
      mbar_expect_tx(q_full, live * kTileBytes);
      for (int w = 0; w < live; ++w) {
        tma_tile<kRank, kD>(sQ + w * kTmaTile, sQr + w * kRemSlot, &map_q, &map_q_rem, q_full,
                            col0.x, q0 + w * kTmaRows, h, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kTmaStages;
        mbar_wait(&empty[s], ((j / kTmaStages) & 1) ^ 1);  // round 0 passes at once
        mbar_expect_tx(&full[s], 2 * kTileBytes);
        tma_tile<kRank, kD>(sK + s * kTmaTile, sKr + s * kRemSlot, &map_k, &map_k_rem,
                            &full[s], col0.y, j * kTmaRows, h, b);
        tma_tile<kRank, kD>(sV + s * kTmaTile, sVr + s * kRemSlot, &map_v, &map_v_rem,
                            &full[s], col0.z, j * kTmaRows, h, b);
      }
    }
    return;
  }
  if (wg >= live) return;  // every row of this warpgroup is >= L

  const int wl = warp & 3;    // warp in the warpgroup: rows 16 wl .. 16 wl + 15
  const int gid = lane >> 2;  // accumulator row group
  const int tig = lane & 3;   // thread in group
  float o[32];
  float o_rem[4] = {0.f, 0.f, 0.f, 0.f};  // columns 64-71 at kD 72
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  // Rows gid and gid + 8 of the warp's slice: running max (log2 domain) and
  // this thread's share of the running sum.
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  const int nv = kHop ? min(max(hop.nvalid[b], 0), Lk) : Lk;
  const uint64_t desc_q = sw128_desc(smem_u32(sQ + wg * kTmaTile), 16, 1024);
  const uint64_t desc_q_rem = rem_desc_k(smem_u32(sQr + wg * kRemSlot));
  mbar_wait(q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kTmaStages;
    const uint64_t desc_k = sw128_desc(smem_u32(sK + s * kTmaTile), 16, 1024);
    const uint64_t desc_v = sw128_desc(smem_u32(sV + s * kTmaTile), 16, 1024);
    const uint64_t desc_k_rem = rem_desc_k(smem_u32(sKr + s * kRemSlot));
    const uint64_t desc_v_rem = rem_desc_mn(smem_u32(sVr + s * kRemSlot));
    mbar_wait(&full[s], (j / kTmaStages) & 1);

    // S = Q K^T over D = 64: four k16 steps, 32 bytes apart in each 128-byte
    // row; at kD 72 a fifth over the remainder slots (columns 64-71, zeros).
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    reg_fence(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_ss(sc, desc_q + 2 * kk, desc_k + 2 * kk);
    if constexpr (kRem) wgmma_m64n64k16_ss(sc, desc_q_rem, desc_k_rem);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sc);

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = j * kTmaRows + (i >> 2) * 8 + tig * 2 + (i & 1);
      float sv;
      if constexpr (kHop) {
        sv = key < nv ? sc[i] * scale_log2 : (key < Lk ? kNegBigLog2 : -INFINITY);
      } else {
        sv = key < L ? sc[i] * scale_log2 : -INFINITY;
      }
      sc[i] = sv;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sv);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // key j * 64 < Lk scores a finite value (real, or -1e30 in the hop)
      // in every tile, so the new max is finite.
      const float m_new = fmaxf(m_run[r], mx[r]);
      corr[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float p = exp2f(sc[i] - m_run[r]);
      sc[i] = p;
      rs[r] += p;
    }
    l_run[0] = l_run[0] * corr[0] + rs[0];
    l_run[1] = l_run[1] * corr[1] + rs[1];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= corr[(i >> 1) & 1];
    if constexpr (kRem) {
#pragma unroll
      for (int i = 0; i < 4; ++i) o_rem[i] *= corr[i >> 1];
    }

    // O += P V: the accumulator of keys 16 kk .. 16 kk + 15 (registers
    // 8 kk .. 8 kk + 7) is exactly the register A fragment of k step kk.
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
    }
    reg_fence(o);
    if constexpr (kRem) reg_fence(o_rem);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // 16 keys = 16 rows of 128 bytes further into the V tile
      wgmma_m64n64k16_rs_tnsp_b(o, pa[kk], desc_v + ((kk * 16 * 128) >> 4));
    }
    if constexpr (kRem) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // columns 64-71: 16 rows of 16 bytes further into the remainder box
        wgmma_m64n8k16_rs_tnsp_b(o_rem, pa[kk], desc_v_rem + ((kk * 16 * 16) >> 4));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);
    if constexpr (kRem) reg_fence(o_rem);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
  }

  const int row0 = q0 + wg * kTmaRows + wl * 16 + gid;
  const int row1 = row0 + 8;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = r ? row1 : row0;
    if constexpr (kHop) {
      inv[r] = 1.f;  // o stays unnormalised
      if (tig == 0 && row < L) {
        const long idx = ((long)b * L + row) * H + h;
        // An all-padding row's max is -1e30 * log2 e; write JAX's -1e30 exactly.
        hop.m[idx] = m_run[r] <= 0.5f * kNegBigLog2 ? kNegBig : m_run[r] * kLn2;
        hop.den[idx] = l;
      }
    } else {
      inv[r] = 1.f / l;
      if (lse != nullptr && tig == 0 && row < L) {
        lse[((long)b * H + h) * L + row] = (m_run[r] + log2f(l)) * kLn2;
      }
    }
  }
  __nv_bfloat16* obase = out + b * os.b + h * os.h;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int col = dt * 8 + tig * 2;
    if (row0 < L) {
      *reinterpret_cast<uint32_t*>(obase + row0 * os.l + col) =
          pack_bf16(o[4 * dt] * inv[0], o[4 * dt + 1] * inv[0]);
    }
    if (row1 < L) {
      *reinterpret_cast<uint32_t*>(obase + row1 * os.l + col) =
          pack_bf16(o[4 * dt + 2] * inv[1], o[4 * dt + 3] * inv[1]);
    }
  }
  if constexpr (kRem) {  // columns 64-71
    const int col = 64 + tig * 2;
    if (row0 < L) {
      *reinterpret_cast<uint32_t*>(obase + row0 * os.l + col) =
          pack_bf16(o_rem[0] * inv[0], o_rem[1] * inv[0]);
    }
    if (row1 < L) {
      *reinterpret_cast<uint32_t*>(obase + row1 * os.l + col) =
          pack_bf16(o_rem[2] * inv[1], o_rem[3] * inv[1]);
    }
  }
}

// ---- launches (on `stream`, no synchronisation; CUDA error code, 0 on success) ----

// The arguments both loops take; sets the device.
inline cudaError_t check_attention_args(int B, int H, int L, int D, int device) {
  if (B < 1 || H < 1 || L < 1 || D < 8 || D > 128 || D % 8 != 0 || B > 65535 || H > 65535) {
    return cudaErrorInvalidValue;
  }
  return cudaSetDevice(device);
}

// The wgmma loop over `maps` (kRank 3: col0 holds the column offsets of q, k
// and v in the packed map) at head dim kD; L query rows.  kHop: the hop mode,
// `hop` its mask, key count and outputs (lse unused).
template <int kRank, bool kHop = false, int kD = 64>
int launch_attention_tma(const TmaMaps& maps, int3 col0, void* out, float* lse, Strides os,
                         int B, int H, int L, float scale, void* stream, HopArgs hop = {}) {
  constexpr int smem = tma_smem<kD>();
  cudaError_t err = cudaFuncSetAttribute(attention_tma_kernel<kRank, kHop, kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = kTmaConsumers * kTmaRows;
  const dim3 grid((L + rows - 1) / rows, H, B);
  attention_tma_kernel<kRank, kHop, kD>
      <<<grid, kTmaThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          maps.q, maps.k, maps.v, maps.q_rem, maps.k_rem, maps.v_rem, col0,
          static_cast<__nv_bfloat16*>(out), lse, os, L, H, scale * 1.4426950408889634f, hop);
  return (int)cudaGetLastError();
}

// The mma.sync loop.  Every stride and base pointer must keep rows 16-byte
// aligned (out's 4-byte aligned).
inline int launch_attention_mma(const void* q, const void* k, const void* v, void* out,
                                float* lse, Strides qs, Strides ks, Strides vs, Strides os,
                                int B, int H, int L, int D, float scale, void* stream) {
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  cudaError_t (*fn)(const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*,
                    __nv_bfloat16*, float*, Strides, Strides, Strides, Strides, int, int, int,
                    int, float, cudaStream_t);
  switch ((D + 15) / 16) {
    case 1: fn = launch_attention_mma_dp<16>; break;
    case 2: fn = launch_attention_mma_dp<32>; break;
    case 3: fn = launch_attention_mma_dp<48>; break;
    case 4: fn = launch_attention_mma_dp<64>; break;
    case 5: fn = launch_attention_mma_dp<80>; break;
    case 6: fn = launch_attention_mma_dp<96>; break;
    case 7: fn = launch_attention_mma_dp<112>; break;
    default: fn = launch_attention_mma_dp<128>; break;
  }
  return (int)fn(qp, kp, vp, op, lse, qs, ks, vs, os, B, H, L, D, scale,
                 static_cast<cudaStream_t>(stream));
}

}  // namespace

// 1 if head dim D takes the wgmma + TMA loop in kernels 1 and 4, 0 if the
// mma.sync loop; the wgmma loop's dynamic shared memory per CTA in bytes at
// head dim D (0 if D does not take it).  Exported by every source that
// includes this header.
extern "C" int pdm_attention_path(int D) { return attention_uses_tma(D) ? 1 : 0; }
extern "C" int pdm_attention_tma_smem_bytes(int D) {
  return D == 64 ? tma_smem<64>() : D == 72 ? tma_smem<72>() : 0;
}
