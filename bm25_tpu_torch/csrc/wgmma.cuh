// wgmma helpers for Hopper (sm_90a), shared by E4's product
// (matmul_schedules.cu) and B1's hot epilogue (ell_score.cu): the matrix
// descriptor of a K-major tile in the 128-byte swizzle, the fences around
// the asynchronous wgmma, the accumulator register lists of the asm
// statements, and the TMA map that writes such tiles.  Include after
// matmul_ring.cuh (smem_u32, tensor_map_encoder).

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the row of a swizzled tile: 128 bytes of K
constexpr int SWIZZLE_ROW_BYTES = 128;

// A wgmma matrix descriptor for a K-major tile that TMA wrote with the
// 128-byte swizzle (rows of 128 bytes, 8-row groups 1024 bytes apart, the
// tile 1024-byte aligned): start address >> 4, leading offset 16 bytes
// (unused by this layout), stride offset 1024 bytes, layout 1 = 128B
// swizzle.  Adding 2 advances the start by 32 bytes, one k16 (bf16) or
// k8 (TF32) slice along the row; the hardware applies the swizzle.
__device__ __forceinline__ uint64_t wgmma_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous wgmma that owns them.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define WGMMA_D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WGMMA_D64(i)                                                       \
  WGMMA_D8(i), WGMMA_D8(i + 8), WGMMA_D8(i + 16), WGMMA_D8(i + 24),        \
      WGMMA_D8(i + 32), WGMMA_D8(i + 40), WGMMA_D8(i + 48),                \
      WGMMA_D8(i + 56)
#define WGMMA_REGS64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define WGMMA_REGS128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, " \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, " \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, " \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, " \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, " \
  "%127}"

// The map of a row-major (rows, kp) operand of kp values a row (whole
// 16-byte units): boxes of 128 bytes of K by box_rows rows, swizzled 128B
// for wgmma, zeros past the edges.
inline int encode_packed(CUtensorMap* map, const void* base, int64_t rows,
                         int64_t kp, bool bf16, int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  const int64_t esize = bf16 ? 2 : 4;
  const cuuint64_t dims[2] = {(cuuint64_t)kp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(kp * esize)};
  const cuuint32_t box[2] = {(cuuint32_t)(SWIZZLE_ROW_BYTES / esize),
                             (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace
