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
// What bounds it on an H100: at the U-ViT shapes (L = 258 / 334 / 590,
// D = 64) the two products are 4*B*L^2*C flops against 8*B*L*C bytes in and
// out, i.e. L/2 flops per byte: below the card's ~295 flop/byte ridge for
// L < 590, so the floor is the memory traffic of reading qkv once and writing
// out once, and at L = 590 both floors meet.  The (L, L) scores never reach
// device memory (online softmax).
//
// The loop is attention_fwd.cuh's, shared with the (B, H, L, D) kernel of
// fused_attention.cu; see it for the design.  Layout at this entry:
//   - head dims 64 and 72 (the wgmma loop): one TMA tensor map over the
//     packed qkv, 3-D (3C, L, B) with byte strides (3C * 2, L * 3C * 2) and
//     64 x 64 boxes in the 128-byte swizzle, so rows past L zero-fill per
//     batch and are never read from the next batch; q, k and v of head h are
//     the boxes at columns h*D, C + h*D and 2C + h*D.  At head dim 72 a
//     second map of unswizzled 8 x 64 boxes reads columns 64-71 of each
//     head from h*D + 64, so no column of another head is read.  The maps
//     are encoded on the host at every call
//     (pdm_fused_qkv_attention_encode_us times it).
//   - other head dims (the mma.sync loop): q, k and v as (batch, head, row)
//     strides (L*3C, D, 3C) from the same base offset by 0, C and 2C.
//   - out (B, L, C) as strides (L*C, D, C) in both.
//
// Numerics: scores, running max/sum and accumulation are f32; P is rounded to
// bf16 for the PV product.  The TPU kernel normalises P by its row sum BEFORE
// the PV product (`_attend`); here the division by the row sum is deferred to
// the epilogue, as flash attention does, so P is rounded to bf16 before
// normalisation.  The two differ by bf16 rounding only.
//
// Shapes: any L >= 1 and any head dim D that is a multiple of 8 up to 128.
// The TPU kernel's MAX_FULL_SEQ / Q_CHUNK split, head groups and VMEM budget
// do not apply.

#include <chrono>

#include "attention_fwd.cuh"

namespace {

// The packed-qkv maps of the wgmma loop (see the note above): 64-column
// boxes, and at head dim 72 the 8-column remainder boxes; q, k and v share
// each map.
cudaError_t encode_packed_qkv(TmaMaps* maps, const void* qkv, int B, int L, int H, int D) {
  const int c3 = 3 * H * D;
  cudaError_t err = encode_rows_map(&maps->q, qkv, (long long)L * c3, c3, c3, L, B);
  if (err == cudaSuccess) {
    maps->q_rem = maps->q;
    if (D > 64) err = encode_rows_map(&maps->q_rem, qkv, (long long)L * c3, c3, c3, L, B, 8);
  }
  maps->k = maps->v = maps->q;
  maps->k_rem = maps->v_rem = maps->q_rem;
  return err;
}

}  // namespace

// Returns the CUDA error code of the launch (0 on success).  Launches on
// `stream` and does not synchronise; `out` (and `lse`, unless null) are
// allocated by the caller; qkv's base is 16-byte aligned.
extern "C" int pdm_fused_qkv_attention(const void* qkv, void* out, float* lse, int B, int L,
                                       int H, int D, float scale, int device, void* stream) {
  cudaError_t err = check_attention_args(B, H, L, D, device);
  if (err != cudaSuccess) return (int)err;
  const long C = (long)H * D;
  const Strides os{L * C, D, C};
  if (attention_uses_tma(D)) {
    TmaMaps maps;
    err = encode_packed_qkv(&maps, qkv, B, L, H, D);
    if (err != cudaSuccess) return (int)err;
    const int3 col0 = make_int3(0, (int)C, (int)(2 * C));
    return D == 64 ? launch_attention_tma<3, false, 64>(maps, col0, out, lse, os, B, H, L, scale,
                                                        stream)
                   : launch_attention_tma<3, false, 72>(maps, col0, out, lse, os, B, H, L, scale,
                                                        stream);
  }
  const Strides in{L * 3 * C, D, 3 * C};  // q, k and v: one head's columns of the packed rows
  const auto* base = static_cast<const __nv_bfloat16*>(qkv);
  return launch_attention_mma(base, base + C, base + 2 * C, out, lse, in, in, in, os, B, H, L, D,
                              scale, stream);
}

// Host microseconds of one encode of the packed-qkv tensor maps (the per-call
// host cost the wgmma path adds: one map at head dim 64, two at 72),
// averaged over `iters` encodes; negative if an encode fails.
extern "C" double pdm_fused_qkv_attention_encode_us(const void* qkv, int B, int L, int H, int D,
                                                    int iters) {
  TmaMaps maps;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i) {
    if (encode_packed_qkv(&maps, qkv, B, L, H, D) != cudaSuccess) return -1.0;
  }
  const std::chrono::duration<double, std::micro> dt = std::chrono::steady_clock::now() - t0;
  return dt.count() / iters;
}
