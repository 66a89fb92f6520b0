// Device helpers shared by the attention kernels (flash_fwd.cu,
// flash_bwd.cu, nomax_fwd.cu): cp.async copies, the bf16 mma.sync
// m16n8k16 product, and the loader of a 64-row tile of one (batch, head)
// slice of a [B, N, H, D] tensor, read in place through its strides.
// Each .cu builds into its own library, so each gets its own copy.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // four warps, 16 tile rows each
constexpr int kPad = 8;        // bf16 elements of padding per shared-memory row

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy rows [row0, row0 + 64) x cols [0, DP) of one (batch, head) slice into
// shared memory (row stride DP + kPad), zero-filling rows >= nrows and
// columns >= d. vec: 16-byte cp.async chunks (aligned rows, d % 8 == 0);
// otherwise element by element.
template <int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem, const __nv_bfloat16* base,
                                          long long row_stride, int row0, int nrows, int d,
                                          bool vec) {
  constexpr int LD = DP + kPad;
  constexpr int CHUNKS = DP / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < 64 * CHUNKS; idx += kThreads) {
    const int r = idx / CHUNKS;
    const int c = idx % CHUNKS;
    __nv_bfloat16* dst = smem + r * LD + c * 8;
    const int grow = row0 + r;
    const bool row_ok = grow < nrows;
    if (vec) {
      const bool ok = row_ok && (c * 8 < d);
      const __nv_bfloat16* src = ok ? base + grow * row_stride + c * 8 : base;
      cp_async16(dst, src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = c * 8 + e;
        dst[e] = (row_ok && col < d) ? base[grow * row_stride + col] : __float2bfloat16(0.f);
      }
    }
  }
}

}  // namespace
