// s8 x s8 -> s32 matrix product for Hopper (sm_90a): C[M, N] = A[M, K] B[K, N],
// both operands row-major int8, exact in s32.
//
// Replaces: scripts/mosaic_probe.py::mm_kernel (row 12 of the kernel table,
// reached through probe_int8_mm: the s8 [4096, 2880] x s8 [2880, 128]
// product in one Pallas block, timed against XLA's int8 dot). The probe's
// product is exactly an int8 3x3 conv's im2col GEMM (2880 = 9 * 320), so
// this kernel is the conv's main loop (qconv_tile.cuh) on explicit operands.
//
// Bound on this card at the probe's shape: the bytes, each input read once
// and the s32 output written once, 11.80 + 0.37 + 2.10 MB = 14.26 MB, take
// 0.0043 ms at 3.35 TB/s; the 3.02 G int8 operations 0.0015 ms at 1,979
// TOP/s. Memory sets the floor.
//
// Design: 128 x 64 output tiles over 8 warps (qconv_tile.cuh's tile), each
// warp 32 x 32 of mma.sync m16n8k32; 64-deep K tiles double-buffered in
// shared memory with cp.async. A's rows are staged as they are (K
// contiguous). B arrives K-major ([K, N] row-major) while the MMA's B
// fragment wants N-major rows (4 consecutive k of one n in a register), so
// each staged B tile is transposed in shared memory, 4 x 4 bytes per
// thread with byte permutes, before the tile's MMAs. Any M and N; K a
// multiple of 16 (16-byte cp.async chunks are wholly inside or outside K);
// N a multiple of 16 takes cp.async for B, any other N element-wise loads.
// mma.sync reaches a fraction of the int8 peak; wgmma/TMA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "qconv_tile.cuh"

namespace {

using namespace vdq;

constexpr int kLDB = kBN + 16;  // bytes per shared row of the K-major B tile

// A rows [m0, m0 + 128) x K [k0, k0 + 64), 16-byte chunks, zero outside.
__device__ __forceinline__ void load_a(const int8_t* a, int M, int K, int8_t* sA, int m0,
                                       int k0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c >> 2, ch = c & 3;
    const bool ok = m0 + r < M && k0 + ch * 16 < K;
    const int8_t* src = ok ? a + (long long)(m0 + r) * K + k0 + ch * 16 : a;
    cp_async16(sA + r * kLD + ch * 16, src, ok ? 16 : 0);
  }
}

// B rows (k) [k0, k0 + 64) x columns (n) [n0, n0 + 64), K-major, zero outside.
__device__ __forceinline__ void load_bk(const int8_t* b, int K, int N, bool vec, int8_t* sBk,
                                        int k0, int n0) {
  if (vec) {
    const int r = threadIdx.x >> 2, ch = threadIdx.x & 3;
    const bool ok = k0 + r < K && n0 + ch * 16 < N;
    const int8_t* src = ok ? b + (long long)(k0 + r) * N + n0 + ch * 16 : b;
    cp_async16(sBk + r * kLDB + ch * 16, src, ok ? 16 : 0);
    return;
  }
  for (int idx = threadIdx.x; idx < kBK * kBN; idx += kThreads) {
    const int r = idx / kBN, n = idx - r * kBN;
    sBk[r * kLDB + n] = (k0 + r < K && n0 + n < N) ? b[(long long)(k0 + r) * N + n0 + n]
                                                   : int8_t(0);
  }
}

// sBt[n][k] = sBk[k][n] over the 64 x 64 tile: thread t moves the 4 x 4
// block of k rows 4 * (t / 16) + [0, 4) and n columns 4 * (t % 16) + [0, 4).
__device__ __forceinline__ void transpose_b(const int8_t* sBk, int8_t* sBt) {
  const int kb = threadIdx.x >> 4, nb = threadIdx.x & 15;
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    w[j] = *reinterpret_cast<const uint32_t*>(sBk + (4 * kb + j) * kLDB + 4 * nb);
  // out[i] holds byte i of w[0..3]: column n = 4 nb + i, rows k = 4 kb + [0, 4)
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140), lo23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362), hi23 = __byte_perm(w[2], w[3], 0x7362);
  const uint32_t out[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                           __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<uint32_t*>(sBt + (4 * nb + i) * kLD + 4 * kb) = out[i];
}

__global__ void __launch_bounds__(kThreads) s8mm_kernel(const int8_t* __restrict__ a,
                                                        const int8_t* __restrict__ b,
                                                        int32_t* __restrict__ c, int M, int N,
                                                        int K, int vec_b) {
  __shared__ __align__(16) int8_t sA[2][kBM * kLD];
  __shared__ __align__(16) int8_t sBk[2][kBK * kLDB];
  __shared__ __align__(16) int8_t sBt[kBN * kLD];

  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 4, wn = warp / 4;
  const int g = lane >> 2, t = lane & 3;

  int acc[2][4][4];
  zero_acc(acc);
  const int nkt = (K + kBK - 1) / kBK;
  load_a(a, M, K, sA[0], m0, 0);
  load_bk(b, K, N, vec_b, sBk[0], 0, n0);
  cp_async_commit();
  for (int kt = 0; kt < nkt; ++kt) {
    const int cur = kt & 1;
    cp_async_wait_all();
    __syncthreads();  // tile kt staged; every warp is past tile kt - 1's MMAs
    transpose_b(sBk[cur], sBt);
    if (kt + 1 < nkt) {
      load_a(a, M, K, sA[cur ^ 1], m0, (kt + 1) * kBK);
      load_bk(b, K, N, vec_b, sBk[cur ^ 1], (kt + 1) * kBK, n0);
      cp_async_commit();
    }
    __syncthreads();  // sBt written
    mma_k_tile(sA[cur], sBt, acc);
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = m0 + wm * 32 + mt * 16 + g + 8 * hr;
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 32 + nt * 8 + 2 * t + e;
          if (n < N) c[(long long)m * N + n] = acc[mt][nt][2 * hr + e];
        }
    }
}

}  // namespace

// a [M, K], b [K, N] int8 row-major (16-byte aligned, K % 16 == 0), c [M, N]
// int32. vec_b: N % 16 == 0 (cp.async for B). Returns a cudaError_t code; 0
// means the launch was accepted.
extern "C" int vd_probe_s8mm(const void* a, const void* b, void* c, int M, int N, int K,
                             int vec_b, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0) return int(cudaErrorInvalidValue);
  const dim3 grid(unsigned((M + kBM - 1) / kBM), unsigned((N + kBN - 1) / kBN));
  s8mm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), static_cast<int32_t*>(c),
      M, N, K, vec_b);
  return int(cudaGetLastError());
}
