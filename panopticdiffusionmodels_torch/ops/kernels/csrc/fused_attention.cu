// Multi-head attention over (B, H, L, D) tensors, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// panopticdiffusionmodels_tpu/ops/pallas/fused_attention.py::fused_attention
// (body `_attention_kernel`, pallas_call in `_fused_attention_fwd_impl`).
//
// Inputs  q, k, v (B, H, L, D) bf16, each with its own (batch, head, row)
//         strides in elements and unit stride along D, so a transposed view
//         of a (B, L, H, D) projection is read in place.
// Output  out (B, H, L, D) bf16, contiguous.
// Per (batch, head): softmax(q k^T * scale) v.
//
// What bounds it on an H100: 4*B*H*L^2*D flops against 8*B*H*L*D bytes (q,
// k, v read once, out written once), L/2 flops per byte.  At U-ViT-L/2
// (L = 258) that is far below the card's ~295 flop/byte bf16 ridge, so the
// floor is the traffic of the four tensors (20 us at (32, 16, 258, 64)).
// The TPU kernel holds a whole (L, L) f32 score block per (batch, head) in
// VMEM; a Hopper block has 227 KB of shared memory and must leave room for
// several blocks per SM, so this design streams instead: one CTA owns a
// 64-row query tile of one (batch, head), keeps its Q fragments in
// registers, walks 64-key K/V tiles through shared memory and keeps the
// running max, the running sum and the (64, D) accumulator in registers
// (online softmax).  The (L, L) scores never reach device memory, and one
// path serves every L: the TPU function's switch to XLA past MAX_FULL_SEQ
// = 1024 is not needed.  Products run on the tensor cores through mma.sync
// m16n8k16 (bf16 in, f32 accumulate).
//
// Numerics: the TPU kernel casts q, k and v up to f32 and keeps P in f32 for
// the PV product.  Here the scores, the running max and sum and the
// accumulator are f32, but P is rounded to bf16 for the tensor-core PV
// product, before its normalisation, which is deferred to the epilogue (the
// division by the row sum, flash style).  The two differ by that rounding
// (a few 1e-3 relative on the output).
//
// Shapes: any L >= 1 (keys >= L score -inf, query rows >= L are not stored)
// and any head dim D that is a multiple of 8 up to 128; D is padded with
// zeros to the next multiple of 16 in shared memory (the TPU pads to 128
// lanes), and padded output columns are not stored.
//
// The tile loop is attention_fwd.cuh's, shared with the packed-qkv kernel of
// fused_qkv_attention.cu: single-buffered tiles loaded with plain 16-byte
// loads, V fragments gathered with scalar shared-memory loads.

#include "attention_fwd.cuh"

// Returns the CUDA error code of the launch (0 on success).  Launches on
// `stream` and does not synchronise; `out` is allocated by the caller.
// Strides are in elements, (batch, head, row) for each of q, k and v; every
// stride and every base pointer must keep rows 16-byte aligned.
extern "C" int pdm_fused_attention(const void* q, const void* k, const void* v, void* out,
                                   long long q_sb, long long q_sh, long long q_sl,
                                   long long k_sb, long long k_sh, long long k_sl,
                                   long long v_sb, long long v_sh, long long v_sl, int B, int H,
                                   int L, int D, float scale, int device, void* stream) {
  const Strides qs{(long)q_sb, (long)q_sh, (long)q_sl};
  const Strides ks{(long)k_sb, (long)k_sh, (long)k_sl};
  const Strides vs{(long)v_sb, (long)v_sh, (long)v_sl};
  const Strides os{(long)H * L * D, (long)L * D, D};  // out is contiguous (B, H, L, D)
  return launch_attention_fwd(q, k, v, out, nullptr, qs, ks, vs, os, B, H, L, D, scale, device,
                              stream);
}
