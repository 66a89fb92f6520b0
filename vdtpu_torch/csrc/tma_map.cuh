// TMA for the kernels that take their tiles by tensor map (probe_s8mm.cu,
// flash_bwd.cu, attn_fwd_sm90.cuh): the host-side encoder, found through the
// runtime's driver entry point (no link against libcuda), the attention
// kernels' map of a strided [B, rows, H, D] tensor, and the device-side
// mbarrier and bulk-tensor copy instructions they use.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vdt {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A tiled tensor map of `rank` dims (dims[0] innermost; strides in bytes of
// dims 1 .. rank - 1), boxes of `box` elements, zero outside the tensor.
// Returns a cudaError_t code.
inline int encode_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* ptr,
                      const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                      CUtensorMapSwizzle swizzle) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t rc =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    if (rc != cudaSuccess || q != cudaDriverEntryPointSuccess || fn == nullptr)
      return int(rc != cudaSuccess ? rc : cudaErrorSymbolNotFound);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, type, cuuint32_t(rank), const_cast<void*>(ptr), dims, strides,
                            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : int(cudaErrorInvalidValue);
}

// A bf16 [B, rows, H, D] tensor read in place through its element strides
// (batch, row, head; the last axis contiguous) as a 4-D map (D, H, rows, B)
// with boxes of box_cols columns x box_rows rows, zero past D and past the
// last row. By default one 16-byte column chunk a box, so a tile lands as
// ceil(D / 8) planes of box_rows x 16 bytes: wgmma's K-major layout without
// swizzle (LBO = one plane), and with the transpose bit its MN-major one.
// Boxes of 64 columns (128 bytes a row) take the 128-byte swizzle, which
// wgmma reads through a descriptor of the same swizzle. A cudaError_t code.
inline int encode_rows_map(CUtensorMap* map, const void* ptr, int B, int rows, int H, int D,
                           long long sb, long long srow, long long sh, int box_rows,
                           int box_cols = 8,
                           CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(rows), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(sh * 2), cuuint64_t(srow * 2), cuuint64_t(sb * 2)};
  const cuuint32_t box[4] = {cuuint32_t(box_cols), 1, cuuint32_t(box_rows), 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, dims, strides, box, swizzle);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra LAB_DONE;\nbra LAB_WAIT;\nLAB_DONE:\n}\n" ::"r"(bar), "r"(parity) : "memory");
}
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
// one box at coordinates (c0 innermost ...) into shared memory at dst,
// completing on bar
__device__ __forceinline__ void tma_1d(uint32_t dst, const CUtensorMap* map, int c0, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2}], [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

}  // namespace vdt
