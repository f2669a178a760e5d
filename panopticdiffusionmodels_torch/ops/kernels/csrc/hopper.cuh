// Hopper (sm_90a) building blocks shared by the redesigned kernels (the
// attention loop of attention_fwd.cuh, the attention backward of
// fused_qkv_attention_bwd.cu and the LayerNorm-prologue GEMM of
// fused_ln_qkv_attention.cu): mbarriers, TMA tile loads, wgmma shared-memory
// descriptors and products, all as inline PTX, and the host-side encode of a
// TMA tensor map (cuTensorMapEncodeTiled, looked up at run time through the
// CUDA runtime, so the libraries need no -lcuda).
//
// Layout convention: every tile that TMA writes and wgmma reads is a stack of
// 128-byte rows (64 bf16) in the 128-byte swizzle (CU_TENSOR_MAP_SWIZZLE_128B:
// the 16-byte chunk c of row r sits at chunk c ^ (r % 8)), and starts on a
// 1024-byte boundary, the period of that swizzle.  Head dim 72 adds a
// remainder slot per tile for columns 64-71 (rem_desc_k, rem_desc_mn).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers (shared::cta) ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the other threads and to TMA;
// follow it with __syncthreads().
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic for this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Spins until the phase of parity `parity` has completed (the barrier's
// current phase parity differs from it).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA tile loads, global -> shared, completing on an mbarrier ----
// `map` is the address of a __grid_constant__ CUtensorMap kernel parameter;
// coordinates are in elements, innermost first.

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// `bytes` contiguous bytes global -> shared (no tensor map), completing on
// an mbarrier; both addresses and `bytes` multiples of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- register reallocation between warpgroups (all 128 threads of a
// warpgroup execute it; the counts are multiples of 8 in [24, 256]) ----

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// ---- wgmma ----

// Shared-memory matrix descriptor of a 128-byte-swizzled operand at shared
// address `addr` (1024-byte aligned, or offset from such a base by a k step
// inside a 128-byte row).  K-major operands (rows of 64 k values): sbo = 1024,
// the stride of 8-row groups; lbo is unused.  MN-major operands (rows of 64
// m or n values, one row per k): sbo = 1024, the stride of 8-k groups; lbo the
// stride between 64-wide column blocks.  Offsets in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(sbo_bytes >> 4) << 32) | (1ull << 62);
}

// Orders this thread's earlier shared-memory stores before later reads by
// the async proxy (wgmma operands, TMA); follow it with a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Remainder slots (head dim 72): 2 KB each, the TMA box of columns 64-71 (64
// rows of 16 bytes, 1 KB), then 1 KB of zeros that stands for columns 72-79
// in the k16 step over columns 64-79, so columns 72-79 are never loaded.
// The box is unswizzled: each 8 rows are one 128-byte core matrix of wgmma's
// interleaved layout (layout type 0).
constexpr int kRemBoxBytes = 1024;
constexpr int kRemSlotBytes = 2048;

// Descriptor of the slot at shared address `addr` as a K-major operand of a
// k16 step: 8-row groups 128 bytes apart (sbo), columns 72-79 the slot's
// zeros 1 KB on (lbo).
__device__ __forceinline__ uint64_t rem_desc_k(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kRemBoxBytes >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// The slot's box as an MN-major B of 8 columns (transpose bit): 8-k groups
// 128 bytes apart (lbo); one column block, so sbo is unused (128).
__device__ __forceinline__ uint64_t rem_desc_mn(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// Zeroes the second kilobyte of `n` consecutive remainder slots, by all the
// CTA's threads, then orders the stores before the async proxy; call before
// the __syncthreads that precedes the first TMA load and wgmma.
__device__ __forceinline__ void zero_rem_slots(void* slots, int n) {
  constexpr int kChunks = kRemBoxBytes / 16;  // 16-byte stores a slot
  unsigned char* p = static_cast<unsigned char*>(slots);
  for (int i = threadIdx.x; i < n * kChunks; i += blockDim.x) {
    *reinterpret_cast<uint4*>(p + (i / kChunks) * kRemSlotBytes + kRemBoxBytes +
                              (i % kChunks) * 16) = make_uint4(0u, 0u, 0u, 0u);
  }
  fence_proxy_async();
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products (placed before wgmma_fence and after wgmma_wait).
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The accumulator of an m64nN product: register 4*j + e of a thread holds row
// 16*w + lane/4 (+ 8 for e >= 2) and column 8*j + 2*(lane%4) + (e & 1) of the
// warpgroup's 64 x N tile, w the warp within the warpgroup (the mma.sync C
// layout, per 8-column block).  A register A operand takes, per warp, the
// mma.sync m16n8k16 A-fragment layout of its 16 rows.

// d += A B for a 64x64 tile, k16: A (64 x 16) and B (64 keys x 16) both
// K-major in shared memory (descriptors).  scale_d = 0: d = A B, the
// accumulator's old values unread (a product's first k step, so that no
// ordinary instruction has to zero an accumulator while other products run).
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d += A B for a 64x64 tile, k16: A (64 x 16) from registers in the mma.sync
// A-fragment layout, B (16 x 64) MN-major in shared memory (transpose bit).
__device__ __forceinline__ void wgmma_m64n64k16_rs_tnsp_b(float (&d)[32], const uint32_t (&a)[4],
                                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d += A B for a 64x8 tile, k16: A (64 x 16) from registers, B (16 x 8)
// MN-major in shared memory (transpose bit).
__device__ __forceinline__ void wgmma_m64n8k16_rs_tnsp_b(float (&d)[4], const uint32_t (&a)[4],
                                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d += A B for a 64x256 tile, k16: A (64 x 16) from registers, B (16 x 256)
// MN-major in shared memory (transpose bit).
__device__ __forceinline__ void wgmma_m64n256k16_rs_tnsp_b(float (&d)[128], const uint32_t (&a)[4],
                                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, "
      "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "
      "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
      "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
      "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
      "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
      "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
      "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
      "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
      "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
      "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
      "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
      "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
      "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


// Four 8x8 b16 matrices from shared memory into the mma A-fragment order:
// lanes 0-15 give the addresses of rows 0-15 at k 0-7, lanes 16-31 those of
// rows 0-15 at k 8-15.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// ---- host: TMA tensor maps ----

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// A bf16 tensor map over `base` with zero fill past the edges: dims innermost
// first (dim 0 of unit stride), strides_bytes for dims 1..rank-1, box the
// tile in elements per dim, in the 128-byte swizzle (box[0] * 2 <= 128) or
// as `swizzle` says.
inline cudaError_t encode_bf16_map(CUtensorMap* map, int rank, const void* base,
                                   const cuuint64_t* dims, const cuuint64_t* strides_bytes,
                                   const cuuint32_t* box,
                                   CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank, const_cast<void*>(base), dims,
         strides_bytes, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The 3-D (width, rows, B) map of a (B, rows, width) bf16 view with element
// strides (batch bs, row rs, column 1) and boxes of 64 rows, so that rows
// past `rows` zero-fill per batch and are never read from the next one.
// Boxes of 64 columns in the 128-byte swizzle, or (box_cols = 8) the
// unswizzled remainder boxes of 8 columns.
inline cudaError_t encode_rows_map(CUtensorMap* map, const void* base, long long bs, long long rs,
                                   int width, int rows, int B, int box_cols = 64) {
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)rs * 2, (cuuint64_t)bs * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, 64, 1};
  return encode_bf16_map(map, 3, base, dims, strides, box,
                         box_cols == 8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace
