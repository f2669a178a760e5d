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
// The tile loop is attention_fwd.cuh's, shared with the (B, H, L, D) kernel
// of fused_attention.cu; this source states the packed layout as strides.

#include "attention_fwd.cuh"

// Returns the CUDA error code of the launch (0 on success).  Launches on
// `stream` and does not synchronise; `out` (and `lse`, unless null) are
// allocated by the caller.
extern "C" int pdm_fused_qkv_attention(const void* qkv, void* out, float* lse, int B, int L,
                                       int H, int D, float scale, int device, void* stream) {
  const long C = (long)H * D;
  const Strides in{L * 3 * C, D, 3 * C};  // q, k and v: one head's columns of the packed rows
  const Strides os{L * C, D, C};
  const auto* base = static_cast<const __nv_bfloat16*>(qkv);
  return launch_attention_fwd(base, base + C, base + 2 * C, out, lse, in, in, in, os, B, H, L,
                              D, scale, device, stream);
}
