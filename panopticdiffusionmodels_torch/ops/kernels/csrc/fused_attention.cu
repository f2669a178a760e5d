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
// VMEM; a Hopper block has 227 KB of shared memory, so this design streams
// K/V tiles with an online softmax (attention_fwd.cuh, the loop shared with
// kernel 1; see it for the design).  One path serves every L: the TPU
// function's switch to XLA past MAX_FULL_SEQ = 1024 is not needed.
//
// Layout at this entry:
//   - head dims 64 and 72 (the wgmma loop): one TMA tensor map per input,
//     4-D (D, L, H, B) with the view's own byte strides (row, head, batch)
//     and 64 x 64 x 1 x 1 boxes in the 128-byte swizzle, so rows past L
//     zero-fill per (batch, head); at head dim 72 a second map per input of
//     unswizzled 8 x 64 x 1 x 1 boxes at column 64; TMA needs the base and
//     every stride 16-byte
//     aligned and unit stride along D, which the wrapper checks
//     (tensor_map.py).
//   - other head dims (the mma.sync loop): q, k and v as (batch, head, row)
//     strides in elements.
//   - out (B, H, L, D) contiguous, as strides (H*L*D, L*D, D) in both.
//
// Numerics: the TPU kernel casts q, k and v up to f32 and keeps P in f32 for
// the PV product.  Here the scores, the running max and sum and the
// accumulator are f32, but P is rounded to bf16 for the tensor-core PV
// product, before its normalisation, which is deferred to the epilogue (the
// division by the row sum, flash style).  The two differ by that rounding
// (a few 1e-3 relative on the output).
//
// Shapes: any L >= 1 and any head dim D that is a multiple of 8 up to 128
// (the TPU pads to 128 lanes).

#include "attention_fwd.cuh"

namespace {

// The (D, L, H, B) maps of one input with (batch, head, row) strides in
// elements: 64 x 64 boxes in the 128-byte swizzle and, at head dim 72, 8 x
// 64 unswizzled remainder boxes at column 64.
cudaError_t encode_bhld(CUtensorMap* map, CUtensorMap* map_rem, const void* t, long long sb,
                        long long sh, long long sl, int B, int H, int L, int D) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sl * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  cudaError_t err = encode_bf16_map(map, 4, t, dims, strides, box);
  *map_rem = *map;
  if (err == cudaSuccess && D > 64) {
    const cuuint32_t box_rem[4] = {8, 64, 1, 1};
    err = encode_bf16_map(map_rem, 4, t, dims, strides, box_rem, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  return err;
}

}  // namespace

// Returns the CUDA error code of the launch (0 on success).  Launches on
// `stream` and does not synchronise; `out` is allocated by the caller.
// Strides are in elements, (batch, head, row) for each of q, k and v; every
// stride and every base pointer must keep rows 16-byte aligned.
extern "C" int pdm_fused_attention(const void* q, const void* k, const void* v, void* out,
                                   long long q_sb, long long q_sh, long long q_sl,
                                   long long k_sb, long long k_sh, long long k_sl,
                                   long long v_sb, long long v_sh, long long v_sl, int B, int H,
                                   int L, int D, float scale, int device, void* stream) {
  cudaError_t err = check_attention_args(B, H, L, D, device);
  if (err != cudaSuccess) return (int)err;
  const Strides os{(long)H * L * D, (long)L * D, D};  // out is contiguous (B, H, L, D)
  if (attention_uses_tma(D)) {
    TmaMaps m;
    if ((err = encode_bhld(&m.q, &m.q_rem, q, q_sb, q_sh, q_sl, B, H, L, D)) != cudaSuccess ||
        (err = encode_bhld(&m.k, &m.k_rem, k, k_sb, k_sh, k_sl, B, H, L, D)) != cudaSuccess ||
        (err = encode_bhld(&m.v, &m.v_rem, v, v_sb, v_sh, v_sl, B, H, L, D)) != cudaSuccess) {
      return (int)err;
    }
    const int3 col0 = make_int3(0, 0, 0);
    return D == 64 ? launch_attention_tma<4, false, 64>(m, col0, out, nullptr, os, B, H, L, scale,
                                                        stream)
                   : launch_attention_tma<4, false, 72>(m, col0, out, nullptr, os, B, H, L, scale,
                                                        stream);
  }
  const Strides qs{(long)q_sb, (long)q_sh, (long)q_sl};
  const Strides ks{(long)k_sb, (long)k_sh, (long)k_sl};
  const Strides vs{(long)v_sb, (long)v_sh, (long)v_sl};
  return launch_attention_mma(q, k, v, out, nullptr, qs, ks, vs, os, B, H, L, D, scale, stream);
}
