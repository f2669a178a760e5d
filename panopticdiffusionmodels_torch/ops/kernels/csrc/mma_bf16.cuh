// Helpers shared by the port's Hopper kernels: the bf16 tensor-core product
// (mma.sync m16n8k16, f32 accumulate), fragment packing, and the plain
// 16-byte tile load into shared memory.  Included by every source under
// csrc/ (build.py rebuilds a library when a header changes).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// c += a b for one 16x8 tile: a the 16x16 row-major A fragment, b the 16x8
// column-major B fragment, both bf16; c f32.
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

// kRows x DP tile of one head's rows into shared memory (row stride DP + 8,
// padded against bank conflicts), by the CTA's kThreads threads with plain
// 16-byte loads; rows past L and columns past D are zero-filled.  src is
// the head's row 0 and row_stride its row stride in elements; both keep rows
// 16-byte aligned.
template <int DP, int kRows, int kThreads>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long row_stride, int row0, int L, int D) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks per row
  constexpr int kStride = DP + 8;
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int col = (i % kChunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < L && col < D) {
      v = __ldg(reinterpret_cast<const uint4*>(src + (long)(row0 + r) * row_stride + col));
    }
    *reinterpret_cast<uint4*>(dst + r * kStride + col) = v;
  }
}

}  // namespace
