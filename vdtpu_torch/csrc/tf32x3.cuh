// Split-f32 (3xTF32) products for the f32 attention kernels (flash_fwd.cu's
// and flash_bwd.cu's tf32x3 route), on Hopper's wgmma (sm_90a).
//
// An f32 value a is split into two tf32 values, hi = tf32(a) and lo =
// tf32(a - hi) (cvt.rna: round to nearest, ties away), and a product of two
// split operands is taken as lo.hi + hi.lo + hi.hi, three wgmma passes into
// one f32 accumulator; the lo.lo term (2^-22 of the product) is dropped.
// That keeps about 21 bits of each product where one tf32 pass keeps 11.
//
// Operands in shared memory are K-major without swizzle: a tile of R rows
// lies as planes of 4 columns, plane c holding columns 4c .. 4c + 3 of every
// row as 16 bytes (the core matrices are 8 rows of a plane, 128 bytes), so a
// k8 step reads two planes: LBO = one plane (R * 16 bytes), SBO = 128.
// - RowsTile: R rows x DP columns as they lie in memory ([row][d]): the
//   operand whose K is the head (Q.K^T, dO.V^T);
// - ColsTile: the same rows transposed ([d][row]), K over the tile's rows:
//   the B operand of P.V, P^T.dO, dS^T.Q and dS.K. tf32 wgmma reads no
//   MN-major operand, so the transpose happens on the way into shared
//   memory. Its rows are permuted within each group of 8, so that the
//   f32 accumulators of a score tile are the A fragments of the next
//   product as they lie in registers (split_frags): a thread holds the
//   scores of key columns 8n + 2t and 8n + 2t + 1, while the tf32 A
//   fragment wants columns t and t + 4 of a k8 step; logical column t is
//   tile row 2t and logical column t + 4 is tile row 2t + 1, so tile row r
//   sits at logical column L(r) = 8 (r / 8) + (r odd ? 4 : 0) + (r % 8) / 2.
// Both are filled by a warpgroup: LDG (16-byte rows or 4-byte columns, rows
// past nrows read as zero), split, 16-byte stores of the hi and lo tiles
// (no bank conflicts). A kernel splits the rows it owns (Q, or K and V, or
// Q and dO) this way into shared memory once; the tiles it streams were
// split once for all blocks by split_tiles_kernel into device memory, in
// the very layout of a stage in shared memory, and come in by one bulk TMA
// copy a stage. Splitting them in every block instead cost as much as the
// products (an H100: the forward at [4, 4096, 8, 40] read 1.47 ms, 0.80
// with products alone, 0.99 with the stream alone), and a block shares
// each streamed tile among as many warpgroups (rows it owns) as shared
// memory allows.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_map.cuh"
#include "wgmma_bf16.cuh"
#include "wgmma_tf32.cuh"

namespace vdf {

constexpr int kThreads = 128;  // a warpgroup
constexpr int kMaxBwdD = 80;   // widest head of the tf32x3 backward and 128-row forward
constexpr int kMaxFwdD = 160;  // widest head of the tf32x3 forward (csrc/tf32x3_fwd_wide.cu)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}
__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
  uint32_t h, l;
  split(x.x, h, l); hi.x = __uint_as_float(h); lo.x = __uint_as_float(l);
  split(x.y, h, l); hi.y = __uint_as_float(h); lo.y = __uint_as_float(l);
  split(x.z, h, l); hi.z = __uint_as_float(h); lo.z = __uint_as_float(l);
  split(x.w, h, l); hi.w = __uint_as_float(h); lo.w = __uint_as_float(l);
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A descriptor advanced by a byte offset (the start field, in 16 bytes)
__device__ __forceinline__ uint64_t advance(uint64_t desc, int bytes) { return desc + (bytes >> 4); }
// the descriptor of a plane tile of `rows` rows at p (LBO one plane, SBO 8 rows)
__device__ __forceinline__ uint64_t plane_desc(const float* p, int rows) {
  return vdw::desc(p, uint32_t(rows) * 16, 128);
}

// R rows x DP columns of one (batch, head) slice of a strided [B, rows, H, D]
// f32 tensor, fetched as 16-byte chunks into registers and put into shared
// memory as hi and lo plane tiles by the 128 threads of a warpgroup (lt: a
// thread's index in it). Chunk idx of the tile: 8 consecutive chunks are 8
// rows of one column chunk (one 128-byte run of a plane).
template <int R, int DP>
struct RowsTile {
  static constexpr int kCh = DP / 4, kChunks = R * kCh;
  static constexpr int kPer = (kChunks + kThreads - 1) / kThreads;
  float4 x[kPer];
  static __device__ __forceinline__ int row(int idx) { return (idx >> 3) / kCh * 8 + (idx & 7); }
  static __device__ __forceinline__ int col(int idx) { return (idx >> 3) % kCh; }
  __device__ __forceinline__ void fetch(const float* base, long long stride, int row0, int nrows,
                                        int lt) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = lt + i * kThreads;
      if (kChunks % kThreads != 0 && idx >= kChunks) break;
      const int r = row0 + row(idx);
      x[i] = r < nrows ? __ldg(reinterpret_cast<const float4*>(base + r * stride) + col(idx))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  // mul: folded in before the split (the forward's softmax scale on q)
  __device__ __forceinline__ void put(float* hi, float* lo, int lt, float mul = 1.f) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = lt + i * kThreads;
      if (kChunks % kThreads != 0 && idx >= kChunks) break;
      float4 v = x[i], h, l;
      if (mul != 1.f) v = make_float4(v.x * mul, v.y * mul, v.z * mul, v.w * mul);
      split4(v, h, l);
      const int at = col(idx) * R + row(idx);
      reinterpret_cast<float4*>(hi)[at] = h;
      reinterpret_cast<float4*>(lo)[at] = l;
    }
  }
};

// The same rows transposed: item idx is head column n = idx % DP of the
// logical column group G = idx / DP (4 logical columns: tile rows 8 (G / 2)
// + 2 j + (G & 1), j = 0 .. 3), fetched as four 4-byte loads (consecutive
// threads read consecutive columns of a row) and put as one 16-byte chunk of
// plane G.
template <int R, int DP>
struct ColsTile {
  static constexpr int kItems = R / 4 * DP;
  static constexpr int kPer = (kItems + kThreads - 1) / kThreads;
  float4 x[kPer];
  __device__ __forceinline__ void fetch(const float* base, long long stride, int row0, int nrows,
                                        int lt) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = lt + i * kThreads;
      if (kItems % kThreads != 0 && idx >= kItems) break;
      const int n = idx % DP, G = idx / DP;
      const int r = row0 + 8 * (G >> 1) + (G & 1);
      const float* src = base + n;
      x[i].x = r < nrows ? __ldg(src + r * stride) : 0.f;
      x[i].y = r + 2 < nrows ? __ldg(src + (r + 2) * stride) : 0.f;
      x[i].z = r + 4 < nrows ? __ldg(src + (r + 4) * stride) : 0.f;
      x[i].w = r + 6 < nrows ? __ldg(src + (r + 6) * stride) : 0.f;
    }
  }
  __device__ __forceinline__ void put(float* hi, float* lo, int lt) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = lt + i * kThreads;
      if (kItems % kThreads != 0 && idx >= kItems) break;
      float4 h, l;
      split4(x[i], h, l);
      reinterpret_cast<float4*>(hi)[idx] = h;  // (idx / DP) * DP + idx % DP
      reinterpret_cast<float4*>(lo)[idx] = l;
    }
  }
};

// Tiles split once in device memory: split_tiles_kernel writes tile j of T
// rows of one (batch, head) slice, as a RowsTile (COLS false) or ColsTile
// (COLS true) puts it, hi then lo, at out + bh * bh_stride + j *
// tile_stride; a kernel then brings a whole stage of such tiles, one
// contiguous run of the workspace, into shared memory by one bulk TMA copy
// (stage_copy) instead of splitting it again in every block.
template <int T, int DP, bool COLS>
__global__ void __launch_bounds__(kThreads) split_tiles_kernel(
    const float* x, int H, int rows, long long sb, long long sn, long long sh, float* out,
    long long bh_stride, long long tile_stride) {
  const int bh = blockIdx.y, j = blockIdx.x;
  const float* base = x + (bh / H) * sb + (bh % H) * sh;
  float* dst = out + bh * bh_stride + j * tile_stride;
  if constexpr (COLS) {
    ColsTile<T, DP> c;
    c.fetch(base, sn, j * T, rows, threadIdx.x);
    c.put(dst, dst + T * DP, threadIdx.x);
  } else {
    RowsTile<T, DP> r;
    r.fetch(base, sn, j * T, rows, threadIdx.x);
    r.put(dst, dst + T * DP, threadIdx.x);
  }
}
template <int T, int DP, bool COLS>
int split_tiles(const float* x, int B, int H, int rows, long long sb, long long sn, long long sh,
                float* out, long long bh_stride, long long tile_stride, cudaStream_t stream) {
  split_tiles_kernel<T, DP, COLS><<<dim3((rows + T - 1) / T, B * H), kThreads, 0, stream>>>(
      x, H, rows, sb, sn, sh, out, bh_stride, tile_stride);
  return int(cudaGetLastError());
}
// bytes (a multiple of 16) from src (device memory) to dst (shared memory)
// by one bulk TMA copy issued by one thread, completing on the mbarrier bar
// (its one arrival expects the bytes); wgmma reads dst once a waiter sees
// the phase complete (copy and product are both the async proxy)
__device__ __forceinline__ void stage_copy(float* dst, const float* src, int bytes, uint32_t bar) {
  vdt::bar_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(vdt::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// acc[m64 x N] = A . B^T over K = 8 KS, A and B RowsTiles (hi and lo) of
// a_rows and b_rows rows: the lo passes first, then hi.hi. acc is
// overwritten.
template <int N, int KS>
__device__ __forceinline__ void mm3_ss(float* acc, const float* ah, const float* al, int a_rows,
                                       const float* bh, const float* bl, int b_rows) {
  const uint64_t dah = plane_desc(ah, a_rows), dal = plane_desc(al, a_rows);
  const uint64_t dbh = plane_desc(bh, b_rows), dbl = plane_desc(bl, b_rows);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int oa = 2 * kk * a_rows * 16, ob = 2 * kk * b_rows * 16;
    vdw::Tf32<N>::ss(acc, advance(dal, oa), advance(dbh, ob), kk > 0);
    vdw::Tf32<N>::ss(acc, advance(dah, oa), advance(dbl, ob), 1);
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int oa = 2 * kk * a_rows * 16, ob = 2 * kk * b_rows * 16;
    vdw::Tf32<N>::ss(acc, advance(dah, oa), advance(dbh, ob), 1);
  }
}

// acc[m64 x N] = A . B over K = 8 KS, A in registers (split_frags' hi and
// lo fragments), B a ColsTile (hi and lo) of N = b_rows head columns.
// acc is overwritten.
template <int N, int KS>
__device__ __forceinline__ void mm3_rs(float* acc, const uint32_t (&fh)[KS][4],
                                       const uint32_t (&fl)[KS][4], const float* bh,
                                       const float* bl) {
  const uint64_t dbh = plane_desc(bh, N), dbl = plane_desc(bl, N);
#pragma unroll
  for (int kc = 0; kc < KS; ++kc) {
    const int ob = 2 * kc * N * 16;
    vdw::Tf32<N>::rs(acc, fl[kc], advance(dbh, ob), kc > 0);
    vdw::Tf32<N>::rs(acc, fh[kc], advance(dbl, ob), 1);
  }
#pragma unroll
  for (int kc = 0; kc < KS; ++kc) vdw::Tf32<N>::rs(acc, fh[kc], advance(dbh, 2 * kc * N * 16), 1);
}

// The f32 accumulators of an m64 x 8 KS tile (index 4 n + e: row g + 8 (e >>
// 1), column 8 n + 2 t + (e & 1)) as the hi and lo A fragments of a product
// over its columns, in ColsTile's permuted order: step kc takes a[0] = (g,
// 8 kc + 2 t), a[1] = (g + 8, 8 kc + 2 t), a[2] = (g, 8 kc + 2 t + 1),
// a[3] = (g + 8, 8 kc + 2 t + 1).
template <int KS>
__device__ __forceinline__ void split_frags(uint32_t (&fh)[KS][4], uint32_t (&fl)[KS][4],
                                            const float* s) {
#pragma unroll
  for (int kc = 0; kc < KS; ++kc) {
    split(s[4 * kc + 0], fh[kc][0], fl[kc][0]);
    split(s[4 * kc + 2], fh[kc][1], fl[kc][1]);
    split(s[4 * kc + 1], fh[kc][2], fl[kc][2]);
    split(s[4 * kc + 3], fh[kc][3], fl[kc][3]);
  }
}

// This thread's two rows of its warpgroup's m64 x DP f32 accumulator
// (lt: its index in the warpgroup) into a strided [rows, DP] f32 slice
// (8-byte stores), rows past nrows skipped.
template <int DP>
__device__ __forceinline__ void store_acc(float* base, long long stride, const float* acc,
                                          int row0, int nrows, int lt) {
  const int lane = lt & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * (lt >> 5) + g + 8 * r;
    if (row >= nrows) continue;
    float* out = base + row * stride + 2 * t;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      *reinterpret_cast<float2*>(out + 8 * n) = make_float2(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
  }
}

// The tf32x3 route takes d % 8 == 0 in [min_d, max_d] (the backward and
// the 128-row forward 8-80, the wide forward 88-160) with every row of q,
// k, v (and dO, and the outputs) on 16 bytes: 16-byte aligned pointers,
// element strides % 4 == 0.
inline bool takes(int D, const void* const* ptrs, int nptrs, const long long* strides,
                  int nstrides, int min_d = 8, int max_d = kMaxBwdD) {
  if (D % 8 != 0 || D < min_d || D > max_d) return false;
  for (int i = 0; i < nptrs; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  for (int i = 0; i < nstrides; ++i)
    if (strides[i] % 4 != 0) return false;
  return true;
}

}  // namespace vdf
