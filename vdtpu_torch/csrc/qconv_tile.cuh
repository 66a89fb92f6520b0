// The s8 x s8 -> s32 implicit-GEMM tile shared by the int8 conv kernels
// (qconv3.cu, resblock_q.cu): a 128 x 64 output tile over 8 warps, each warp
// 32 rows x 32 channels of mma.sync m16n8k32, 64-deep K tiles staged in
// shared memory rows of kLD bytes (conflict-free fragment loads).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vdq {

constexpr int kBM = 128;       // output pixels per tile
constexpr int kBN = 64;        // output channels per tile
constexpr int kBK = 64;        // K (tap x channel) per staged tile
constexpr int kLD = kBK + 16;  // bytes per shared-memory row
constexpr int kThreads = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// D = A(16x32, row) * B(32x8, col) + D, s8 operands, exact s32 accumulators.
__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ void zero_acc(int (&acc)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;
}

// acc += A tile (rows of this warp) x B tile (channels of this warp) over
// one staged K tile. Warp w holds rows (w % 4) * 32 + [0, 32) and channels
// (w / 4) * 32 + [0, 32); lane (g = lane / 4, t = lane % 4) the mma.sync
// fragment entries of those.
__device__ __forceinline__ void mma_k_tile(const int8_t* A, const int8_t* Bt,
                                           int (&acc)[2][4][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 4, wn = warp / 4;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < kBK; ks += 32) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int8_t* ar = A + (wm * 32 + mt * 16 + g) * kLD + ks + 4 * t;
      a[mt][0] = *reinterpret_cast<const uint32_t*>(ar);
      a[mt][1] = *reinterpret_cast<const uint32_t*>(ar + 8 * kLD);
      a[mt][2] = *reinterpret_cast<const uint32_t*>(ar + 16);
      a[mt][3] = *reinterpret_cast<const uint32_t*>(ar + 8 * kLD + 16);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int8_t* br = Bt + (wn * 32 + nt * 8 + g) * kLD + ks + 4 * t;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(br);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(br + 16);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1);
    }
  }
}

// Stage weight rows (output channels) [n0, n0 + 64) x K [k0, k0 + 64) of a
// [N, K] int8 matrix. vec: K % 64 == 0 and a 16-byte aligned base (cp.async).
__device__ __forceinline__ void load_b(const int8_t* w, int N, int K, bool vec, int8_t* sB,
                                       int n0, int k0) {
  if (vec) {
    const int r = threadIdx.x >> 2, ch = threadIdx.x & 3;
    const bool ok = n0 + r < N;
    const int8_t* src = ok ? w + (long long)(n0 + r) * K + k0 + ch * 16 : w;
    cp_async16(sB + r * kLD + ch * 16, src, ok ? 16 : 0);
    return;
  }
  for (int idx = threadIdx.x; idx < kBN * kBK; idx += kThreads) {
    const int r = idx / kBK, kk = idx - r * kBK;
    const int k = k0 + kk;
    sB[r * kLD + kk] = (n0 + r < N && k < K) ? w[(long long)(n0 + r) * K + k] : int8_t(0);
  }
}

}  // namespace vdq
