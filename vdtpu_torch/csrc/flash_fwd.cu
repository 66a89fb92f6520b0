// Flash-attention forward for Hopper (sm_90a), bf16 in, bf16 out, f32 sums.
//
// Replaces: vdtpu/ops/pallas/flash.py::_fwd_kernel (reached through
// _fwd_impl / _flash / flash_attention), the online-softmax forward that the
// JAX package runs on the TPU at the UNet's long self-attention sites, with
// and without its log-sum-exp output (with_lse: the residual the backward
// kernels of csrc/flash_bwd.cu read). lse is f32 [B, H, N], written by one
// thread per row from the running max and sum the rows already hold; a
// null pointer skips it.
//
// Bound on this card: at the main-path shape (B*H = 32, 4096 queries and
// keys, d_head 40) the work is 32 * 4096^2 = 537 M exponentials (about
// 0.13 ms at 16 per SM per clock on 132 SMs at 1.98 GHz), about 86 GFLOP of
// bf16 tensor-core products (103 with d padded to 48; about 0.10 ms at
// 989 TFLOP/s) and about 42 MB of device memory traffic (about 0.013 ms at
// 3.35 TB/s). The exponentials set the pace, then the tensor cores; memory
// is far below both.
//
// Two kernels; the caller's plan (vdtpu_torch/ops/flash.py::attn_fwd_plan,
// mirrored by vdattn::plan_code) picks one from shape and alignment alone:
// - heads up to 160 with d % 8 == 0 and 16-byte aligned rows (every site of
//   the main path, the mcg's d-160 cross-attentions): attn_fwd_wg_kernel in
//   csrc/attn_fwd_sm90.cuh, Mode Flash or FlashLse: wgmma and TMA, a
//   producer warpgroup, one to three consumer warpgroups overlapping one's
//   exponentials with another's products (heads over 80 instantiated in
//   csrc/attn_fwd_wide.cu, which vd_attn_fwd_wide launches);
// - every other head and layout: flash_fwd_kernel below, mma.sync m16n8k16
//   from 4 warps of 16 query rows, K/V tiles double-buffered by cp.async
//   (16-byte chunks where rows are aligned, element loads otherwise), d
//   padded to a multiple of 16 in shared memory only. Its [N, M] scores
//   never leave registers either: each warp's 16 x 64 score tile becomes
//   the bf16 A operand of P.V in registers.
// q, k and v are read in place from [B, N, H, D] through strides, so the
// caller's projections need no fold copies.
//
// This source builds two libraries: flash_fwd (bf16: vd_flash_fwd,
// vd_flash_fwd_mma) and, through csrc/flash_fwd_f32.cu, flash_fwd_f32 (the
// f32 routes below: vd_flash_fwd_f32, vd_flash_fwd_tf32x3); a template
// builds only where an entry of its library calls it, so the two nvcc runs
// split the kernels and go in parallel.
//
// The f32 routes are the same function for f32 q, k and v, as _fwd_kernel
// computes it for f32 operands (_fwd_impl with f32 inputs): the scale
// folded into q in f32, f32 logits, an f32 online softmax and f32 sums. f32
// is the port's default dtype (VDSystem, the CLI without --bf16, training
// without `bf16: true`), so a default 2-image t2i request runs 500 of these
// launches. The plan picks one of two kernels:
// - tf32x3 (vd_flash_fwd_tf32x3, flash_fwd_tf32x3_kernel below): heads up
//   to 80 with d % 8 == 0 and 16-byte aligned rows, every f32 site of the
//   UNet (heads of 88-160: csrc/tf32x3_fwd_wide.cu). Bound at [4, 4096, 8, 40]: the two products are 85.9 GFLOP of f32
//   work; on the tensor cores as split-f32 products (csrc/tf32x3.cuh: each
//   operand as tf32 hi + lo, each product lo.hi + hi.lo + hi.hi, about 21
//   bits of each where one tf32 pass keeps 11) that is 3 x 85.9 GFLOP at 495
//   TFLOP/s, 0.52 ms, above the exponentials' 0.13 ms and memory's 0.01.
//   Design: K and V split once a call (split_tiles, csrc/tf32x3.cuh) into a
//   device workspace of tiles of 64 keys (32 for heads over 48, where P's
//   split fragments would not fit the registers): K as rows (B of S =
//   Q.K^T), V transposed in a permuted key order (B of O += P.V: tf32 wgmma
//   reads K-major operands only), each tile in the layout of a stage in
//   shared memory. Two warpgroups of 64 query rows a block, each with its Q
//   split once (scale folded in) into shared memory, share the K/V tiles,
//   which come in a stage at a time by one bulk TMA copy on an mbarrier,
//   double-buffered, the next tile's copy in flight during this tile's
//   products; S by three wgmma ss passes, the
//   online softmax in f32 (ex2 with log2 e folded in), P split in
//   registers straight from the accumulators (the permutation makes them A
//   fragments), O_j = P.V by three wgmma rs passes into a fresh accumulator
//   and O = O alpha + O_j in f32, so the tensor core's own sums never span
//   more than one tile. Measured on an H100 at [4, 4096, 8, 40]: splitting
//   the K/V tiles in every block cost as much as the products (1.47 ms in
//   all, 0.80 with the products alone, 0.99 with the tile stream alone,
//   one warpgroup a block); two warpgroups sharing each tile read 1.27,
//   the split workspace 1.07 by cp.async, 0.94 by bulk TMA copies; three
//   warpgroups, or a producer warpgroup splitting tiles for consumers
//   behind mbarriers, were no faster.
// - f32 (vd_flash_fwd_f32, flash_fwd_f32_kernel below): every other f32
//   head and layout (d % 8 != 0, heads over 160, unaligned views). A plain
//   SIMT kernel, 64 query rows and 256 threads a block, four threads a row;
//   each K/V tile of 64 keys lands in shared memory, a thread takes 16 of
//   the tile's scores with FMAs over the head, the row's four threads
//   reduce max and sum by shuffles, the probabilities go through shared
//   memory, and a thread keeps a quarter of its row's output columns in
//   registers. Bound: 86 GFLOP of f32 FMAs at [4, 4096, 8, 40], 1.3 ms at
//   67 TFLOP/s; one shared-memory load an FMA holds it back to ~7.7 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"
#include "attn_fwd_sm90.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kBQ = 64;      // query rows per block: 16 per warp
constexpr int kBK = 64;      // keys per K/V tile

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;  // [B, H, N] f32, or nullptr
  int B, N, M, H, D;
  long long sqb, sqn, sqh;
  long long skb, skn, skh;
  long long svb, svn, svh;
  long long sob, son, soh;
  float scale;
  int vec;  // 1: rows are 16-byte aligned and d % 8 == 0 -> cp.async path
};

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  constexpr int LD = DP + kPad;
  constexpr int KSTEPS = DP / 16;  // k-steps of the Q.K^T product
  constexpr int NT = kBK / 8;      // score n-tiles per K tile
  constexpr int DT = DP / 8;       // output n-tiles
  constexpr float kLog2e = 1.4426950408889634f;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBQ * LD;  // two buffers
  __nv_bfloat16* sV = sK + 2 * kBK * LD;  // two buffers

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.x * kBQ;
  const __nv_bfloat16* qb = p.q + b * p.sqb + h * p.sqh;
  const __nv_bfloat16* kb = p.k + b * p.skb + h * p.skh;
  const __nv_bfloat16* vb = p.v + b * p.svb + h * p.svh;
  const bool vec = p.vec != 0;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // row group of the mma fragments
  const int t = lane & 3;   // thread in group

  load_tile<DP>(sQ, qb, p.sqn, q0, p.N, p.D, vec);
  load_tile<DP>(sK, kb, p.skn, 0, p.M, p.D, vec);
  load_tile<DP>(sV, vb, p.svn, 0, p.M, p.D, vec);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  // fold the softmax scale into q, rounded to bf16 as the TPU kernel does
  for (int i = threadIdx.x; i < kBQ * DP; i += kThreads) {
    __nv_bfloat16* e = sQ + (i / DP) * LD + (i % DP);
    *e = __float2bfloat16(__bfloat162float(*e) * p.scale);
  }
  __syncthreads();

  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  const int nkt = (p.M + kBK - 1) / kBK;
  const __nv_bfloat16* qw = sQ + (warp * 16 + g) * LD + t * 2;
  for (int j = 0; j < nkt; ++j) {
    const int cur = j & 1;
    if (j + 1 < nkt) {
      load_tile<DP>(sK + (cur ^ 1) * kBK * LD, kb, p.skn, (j + 1) * kBK, p.M, p.D, vec);
      load_tile<DP>(sV + (cur ^ 1) * kBK * LD, vb, p.svn, (j + 1) * kBK, p.M, p.D, vec);
      cp_async_commit();
    }
    const __nv_bfloat16* Kt = sK + cur * kBK * LD;
    const __nv_bfloat16* Vt = sV + cur * kBK * LD;

    // S = (q * scale) . k^T for this warp's 16 rows and the tile's 64 keys
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t a[4];
      a[0] = ld32(qw + kk * 16);
      a[1] = ld32(qw + 8 * LD + kk * 16);
      a[2] = ld32(qw + kk * 16 + 8);
      a[3] = ld32(qw + 8 * LD + kk * 16 + 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* kr = Kt + (nt * 8 + g) * LD + kk * 16 + t * 2;
        mma_16816(s[nt], a, ld32(kr), ld32(kr + 8));
      }
    }
    // ragged kv tail: keys past M get no weight
    const int kbase = j * kBK;
    if (kbase + kBK > p.M) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kbase + nt * 8 + t * 2 + (e & 1) >= p.M) s[nt][e] = -INFINITY;
    }
    // online softmax; this thread holds rows g (e = 0, 1) and g + 8 (e = 2, 3)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = exp2f((m_run[r] - m_use) * kLog2e);
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float p0 = exp2f((s[nt][2 * r] - m_use) * kLog2e);
        const float p1 = exp2f((s[nt][2 * r + 1] - m_use) * kLog2e);
        s[nt][2 * r] = p0;
        s[nt][2 * r + 1] = p1;
        rs += p0 + p1;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l_run[r] = l_run[r] * alpha + rs;
      m_run[r] = m_new;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        o[dt][2 * r] *= alpha;
        o[dt][2 * r + 1] *= alpha;
      }
    }
    // O += P(bf16) . V: the score accumulators are already in A-operand order
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const unsigned short* vr =
          reinterpret_cast<const unsigned short*>(Vt + (kc * 16 + t * 2) * LD + g);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const unsigned short* vp = vr + dt * 8;
        const uint32_t b0 = uint32_t(vp[0]) | (uint32_t(vp[LD]) << 16);
        const uint32_t b1 = uint32_t(vp[8 * LD]) | (uint32_t(vp[9 * LD]) << 16);
        mma_16816(o[dt], a, b0, b1);
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= p.N) continue;
    __nv_bfloat16* orow = p.o + b * p.sob + h * p.soh + row * p.son;
    const float l = l_run[r];
    if (p.lse != nullptr && t == 0) p.lse[size_t(bh) * p.N + row] = m_run[r] + logf(l);
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = dt * 8 + t * 2 + e;
        if (col < p.D) orow[col] = __float2bfloat16(o[dt][2 * r + e] / l);
      }
  }
}

template <int DP>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = size_t(kBQ + 4 * kBK) * (DP + kPad) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((p.N + kBQ - 1) / kBQ, p.B * p.H);
  flash_fwd_kernel<DP><<<grid, kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

// ---- the f32 route ----

constexpr int kF32Rows = 64;      // query rows a block
constexpr int kF32Keys = 64;      // keys a K/V tile
constexpr int kF32Threads = 256;  // four threads a row
constexpr int kF32Cols = kF32Keys / 4;  // scores a thread takes of a tile

struct ParamsF32 {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;  // [B, H, N] f32, or nullptr
  int B, N, M, H, D;
  long long sqb, sqn, sqh;
  long long skb, skn, skh;
  long long svb, svn, svh;
  long long sob, son, soh;
  float scale;
};

// rows [row0, row0 + 64) x cols [0, DP) of one (batch, head) slice into
// shared memory (row stride ld), times mul; zeros past nrows and d
template <int DP>
__device__ __forceinline__ void load_f32(float* dst, int ld, const float* base,
                                         long long row_stride, int row0, int nrows, int d,
                                         float mul) {
  for (int idx = threadIdx.x; idx < kF32Rows * DP; idx += kF32Threads) {
    const int r = idx / DP, c = idx % DP;
    const int g = row0 + r;
    dst[r * ld + c] = (g < nrows && c < d) ? base[g * row_stride + c] * mul : 0.f;
  }
}

template <int DP>
__global__ void __launch_bounds__(kF32Threads) flash_fwd_f32_kernel(const ParamsF32 p) {
  constexpr int LD = DP + 1;      // odd row stride: the 8 rows of a warp hit 8 banks
  constexpr int LDP = kF32Keys + 1;
  constexpr int OC = DP / 4;      // output columns a thread keeps: t, t + 4, ...
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + kF32Rows * LD;
  float* sV = sK + kF32Keys * LD;
  float* sP = sV + kF32Keys * DP;

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kF32Rows;
  const int r = threadIdx.x / 4, t = threadIdx.x % 4;
  const float* kb = p.k + b * p.skb + h * p.skh;
  const float* vb = p.v + b * p.svb + h * p.svh;

  // q * scale in f32, as the TPU kernel folds the scale in the input dtype
  load_f32<DP>(sQ, LD, p.q + b * p.sqb + h * p.sqh, p.sqn, q0, p.N, p.D, p.scale);

  float o[OC];
#pragma unroll
  for (int i = 0; i < OC; ++i) o[i] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;
  const float* qr = sQ + r * LD;

  for (int k0 = 0; k0 < p.M; k0 += kF32Keys) {
    __syncthreads();  // the previous tile's readers are done
    load_f32<DP>(sK, LD, kb, p.skn, k0, p.M, p.D, 1.f);
    load_f32<DP>(sV, DP, vb, p.svn, k0, p.M, p.D, 1.f);
    __syncthreads();
    float s[kF32Cols];
#pragma unroll
    for (int j = 0; j < kF32Cols; ++j) s[j] = 0.f;
    for (int d = 0; d < DP; ++d) {
      const float qd = qr[d];
#pragma unroll
      for (int j = 0; j < kF32Cols; ++j) s[j] = fmaf(qd, sK[(t + 4 * j) * LD + d], s[j]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kF32Cols; ++j) {
      if (k0 + t + 4 * j >= p.M) s[j] = -INFINITY;  // ragged kv tail
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);  // exp(-inf) = 0 on the first tile
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < kF32Cols; ++j) {
      const float pj = expf(s[j] - m_new);
      sP[r * LDP + t + 4 * j] = pj;
      rs += pj;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l_run = l_run * alpha + rs;
    m_run = m_new;
    __syncwarp();  // a row's four threads are one warp's lanes
#pragma unroll
    for (int i = 0; i < OC; ++i) o[i] *= alpha;
    const float* pr = sP + r * LDP;
    for (int c = 0; c < kF32Keys; ++c) {
      const float pc = pr[c];
      const float* vr = sV + c * DP + t;
#pragma unroll
      for (int i = 0; i < OC; ++i) o[i] = fmaf(pc, vr[4 * i], o[i]);
    }
  }

  const int row = q0 + r;
  if (row >= p.N) return;
  float* orow = p.o + b * p.sob + h * p.soh + row * p.son;
#pragma unroll
  for (int i = 0; i < OC; ++i) {
    const int col = t + 4 * i;
    if (col < p.D) orow[col] = o[i] / l_run;
  }
  if (p.lse != nullptr && t == 0) p.lse[size_t(bh) * p.N + row] = m_run + logf(l_run);
}

template <int DP>
int launch_f32(const ParamsF32& p, cudaStream_t stream) {
  const size_t smem = size_t(kF32Rows * (DP + 1) + kF32Keys * (DP + 1) + kF32Keys * DP +
                             kF32Rows * (kF32Keys + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((p.N + kF32Rows - 1) / kF32Rows, p.B * p.H);
  flash_fwd_f32_kernel<DP><<<grid, kF32Threads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

// ---- the tf32x3 route: the f32 route on the tensor cores ----

// NC warpgroups of 64 query rows a block (two: each K/V tile in shared
// memory serves 128 query rows); tiles of kT keys: K as a RowsTile (B of
// S = Q.K^T), V as a ColsTile (B of O += P.V), split once in device memory
// by split_tiles (launch_tf32x3) and brought in a stage at a time by bulk
// TMA copies on two mbarriers, double-buffered; each warpgroup's Q split
// once (scale folded in).
template <int DP, int NC>
struct FwdTc {
  static constexpr int kT = DP <= 48 ? 64 : 32;   // keys a tile: the registers of P's fragments
  static constexpr int kThreads = 128 * NC;
  static constexpr int kQ = 64 * DP;               // floats of a warpgroup's Q hi (or lo)
  static constexpr int kPart = kT * DP;            // floats of K hi, K lo, V^T hi or V^T lo
  static constexpr int kStage = 4 * kPart;
  static constexpr int kSmem = 4 * (2 * NC * kQ + 2 * kStage) + 16;  // + two mbarriers
};

template <int DP, int NC>
__global__ void __launch_bounds__(FwdTc<DP, NC>::kThreads, 1)
    flash_fwd_tf32x3_kernel(const ParamsF32 p, const float* ws) {
  using G = FwdTc<DP, NC>;
  constexpr int T = G::kT, KS = T / 8;
  extern __shared__ __align__(128) float tc_smem[];
  auto part = [&](int st, int i) {
    return tc_smem + 2 * NC * G::kQ + st * G::kStage + i * G::kPart;
  };
  const uint32_t bars = vdt::smem_addr(part(2, 0));  // stage st's copy completes on bars + 8 st

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, wg = tid >> 7, lt = tid & 127, lane = tid & 31, t = lane & 3;
  const int q0 = (blockIdx.x * NC + wg) * 64;  // this warpgroup's first query row
  float* sQh = tc_smem + 2 * wg * G::kQ;
  float* sQl = sQh + G::kQ;
  const int nkt = (p.M + T - 1) / T;
  const float* wsb = ws + size_t(bh) * nkt * G::kStage;  // this head's split tiles
  if (tid == 0) {
    vdt::bar_init(bars, 1);
    vdt::bar_init(bars + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    vdf::stage_copy(part(0, 0), wsb, 4 * G::kStage, bars);
  }
  {
    vdf::RowsTile<64, DP> qt;  // q * scale in f32, as the TPU kernel folds it
    qt.fetch(p.q + b * p.sqb + h * p.sqh, p.sqn, q0, p.N, lt);
    qt.put(sQh, sQl, lt, p.scale);
  }
  vdw::fence_async_smem();  // Q, read next by wgmma (the async proxy)
  __syncthreads();

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
#pragma unroll 1
  for (int j = 0; j < nkt; ++j) {
    const int st = j & 1;
    if (tid == 0 && j + 1 < nkt)  // into the buffer tile j - 1 read; in flight during tile j
      vdf::stage_copy(part(st ^ 1, 0), wsb + size_t(j + 1) * G::kStage, 4 * G::kStage,
                      bars + 8 * (st ^ 1));
    vdt::bar_wait(bars + 8 * st, (j >> 1) & 1);  // tile j landed
    float s[T / 2];
    vdw::keep(s);
    vdw::wg_fence();
    vdf::mm3_ss<T, DP / 8>(s, sQh, sQl, 64, part(st, 0), part(st, 1), T);
    vdw::wg_commit();
    vdw::wg_wait<0>();
    vdw::keep(s);
    if (j * T + T > p.M) {  // keys past M (the last tile)
#pragma unroll
      for (int n = 0; n < T / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j * T + 8 * n + 2 * t + (e & 1) >= p.M) s[4 * n + e] = -INFINITY;
    }
    // online softmax in f32; this thread holds rows g (e = 0, 1) and g + 8
    // (e = 2, 3); l_run is its partial row sum (the quad adds them at the end)
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < T / 8; ++n) mx = fmaxf(mx, fmaxf(s[4 * n + 2 * r], s[4 * n + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      const float ms = (m_new == -INFINITY ? 0.f : m_new) * vdf::kLog2e;
      alpha[r] = vdf::ex2(m_run[r] * vdf::kLog2e - ms);  // 0 on the first tile
      m_run[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < T / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * n + 2 * r + e];
          x = vdf::ex2(__fmaf_rn(x, vdf::kLog2e, -ms));
          sum += x;
        }
      l_run[r] = l_run[r] * alpha[r] + sum;
    }
    // O_j = P.V in a fresh accumulator (the tensor core's f32 sums stay
    // within one tile), then O = O alpha + O_j in f32
    uint32_t ph[KS][4], pl[KS][4];
    vdf::split_frags<KS>(ph, pl, s);
    float ot[DP / 2];
    vdw::keep(ph);
    vdw::keep(pl);
    vdw::keep(ot);
    vdw::wg_fence();
    vdf::mm3_rs<DP, KS>(ot, ph, pl, part(st, 2), part(st, 3));
    vdw::wg_commit();
    vdw::wg_wait<0>();
    vdw::keep(ot);
    vdw::keep(ph);
    vdw::keep(pl);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = __fmaf_rn(o[i], alpha[(i >> 1) & 1], ot[i]);
    __syncthreads();  // every product of this tile done: its buffer is free
  }

  // out = O / l, lse = m + log(l)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_run[r] = l;
  }
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = o[i] / l_run[(i >> 1) & 1];
  vdf::store_acc<DP>(p.o + b * p.sob + h * p.soh, p.son, o, q0, p.N, lt);
  if (p.lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + 16 * (lt >> 5) + (lane >> 2) + 8 * r;
      if (row < p.N) p.lse[size_t(bh) * p.N + row] = m_run[r] + logf(l_run[r]);
    }
  }
}

// K and V split once into ws (f32 [B * H, ceil(M / kT) tiles, 4 kT DP]: K
// hi, K lo, V^T hi, V^T lo a tile, the layout of a stage in shared memory),
// then the attention kernel
template <int DP, int NC = 2>
int launch_tf32x3(const ParamsF32& p, float* ws, cudaStream_t stream) {
  using G = FwdTc<DP, NC>;
  constexpr int T = G::kT;
  static_assert(G::kSmem <= 232448, "the tf32x3 forward's tiles fit shared memory");
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(flash_fwd_tf32x3_kernel<DP, NC>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 G::kSmem);
    if (err != cudaSuccess) return int(err);
    ready = true;
  }
  const long long bh_stride = (long long)((p.M + T - 1) / T) * G::kStage;
  int rc = vdf::split_tiles<T, DP, false>(p.k, p.B, p.H, p.M, p.skb, p.skn, p.skh, ws,
                                          bh_stride, G::kStage, stream);
  if (rc == 0)
    rc = vdf::split_tiles<T, DP, true>(p.v, p.B, p.H, p.M, p.svb, p.svn, p.svh,
                                       ws + 2 * G::kPart, bh_stride, G::kStage, stream);
  if (rc != 0) return rc;
  const dim3 grid((p.N + 64 * NC - 1) / (64 * NC), p.B * p.H);
  flash_fwd_tf32x3_kernel<DP, NC><<<grid, G::kThreads, G::kSmem, stream>>>(p, ws);
  return int(cudaGetLastError());
}

}  // namespace

#if VD_FLASH_FWD_F32
// The f32 route: f32 q, k, v, o and lse (nullptr skips it), strides in
// elements. Returns a cudaError_t code; 0 means the launch was accepted.
extern "C" int vd_flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                void* lse, int B, int N, int M, int H, int D, long long sqb,
                                long long sqn, long long sqh, long long skb, long long skn,
                                long long skh, long long svb, long long svn, long long svh,
                                long long sob, long long son, long long soh, float scale,
                                void* stream) {
  ParamsF32 p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  p.B = B; p.N = N; p.M = M; p.H = H; p.D = D;
  p.sqb = sqb; p.sqn = sqn; p.sqh = sqh;
  p.skb = skb; p.skn = skn; p.skh = skh;
  p.svb = svb; p.svn = svn; p.svh = svh;
  p.sob = sob; p.son = son; p.soh = soh;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16) {
    case 1: return launch_f32<16>(p, st);
    case 2: return launch_f32<32>(p, st);
    case 3: return launch_f32<48>(p, st);
    case 4: return launch_f32<64>(p, st);
    case 5: return launch_f32<80>(p, st);
    case 6: return launch_f32<96>(p, st);
    case 7: return launch_f32<112>(p, st);
    case 8: return launch_f32<128>(p, st);
    case 9: return launch_f32<144>(p, st);
    case 10: return launch_f32<160>(p, st);
    case 11: return launch_f32<176>(p, st);
    case 12: return launch_f32<192>(p, st);
    case 13: return launch_f32<208>(p, st);
    case 14: return launch_f32<224>(p, st);
    case 15: return launch_f32<240>(p, st);
    case 16: return launch_f32<256>(p, st);
    default: return int(cudaErrorInvalidValue);
  }
}

// The tf32x3 route: vd_flash_fwd_f32's arguments and ws, the split K/V
// tiles' workspace (f32, B * H * ceil(M / kT) * 4 * kT * D, kT =
// FwdTc::kT), for d % 8 == 0 up to 80 with 16-byte aligned rows
// (vdf::takes; cudaErrorInvalidValue otherwise). Three launches: K's split,
// V's split, the attention.
extern "C" int vd_flash_fwd_tf32x3(const void* q, const void* k, const void* v, void* o,
                                   void* lse, void* ws, int B, int N, int M, int H, int D,
                                   long long sqb, long long sqn, long long sqh, long long skb,
                                   long long skn, long long skh, long long svb, long long svn,
                                   long long svh, long long sob, long long son, long long soh,
                                   float scale, void* stream) {
  const void* ptrs[5] = {q, k, v, o, ws};
  const long long strides[12] = {sqb, sqn, sqh, skb, skn, skh, svb, svn, svh, sob, son, soh};
  if (!vdf::takes(D, ptrs, 5, strides, 12)) return int(cudaErrorInvalidValue);
  ParamsF32 p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  p.B = B; p.N = N; p.M = M; p.H = H; p.D = D;
  p.sqb = sqb; p.sqn = sqn; p.sqh = sqh;
  p.skb = skb; p.skn = skn; p.skh = skh;
  p.svb = svb; p.svn = svn; p.svh = svh;
  p.sob = sob; p.son = son; p.soh = soh;
  p.scale = scale;
  float* w = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D / 8) {
    case 1: return launch_tf32x3<8>(p, w, st);
    case 2: return launch_tf32x3<16>(p, w, st);
    case 3: return launch_tf32x3<24>(p, w, st);
    case 4: return launch_tf32x3<32>(p, w, st);
    case 5: return launch_tf32x3<40>(p, w, st);
    case 6: return launch_tf32x3<48>(p, w, st);
    case 7: return launch_tf32x3<56>(p, w, st);
    case 8: return launch_tf32x3<64>(p, w, st);
    case 9: return launch_tf32x3<72>(p, w, st);
    case 10: return launch_tf32x3<80>(p, w, st);
    default: return int(cudaErrorInvalidValue);
  }
}
#else

namespace {

int launch_mma(const Params& p, cudaStream_t st) {
  switch ((p.D + 15) / 16) {
    case 1: return launch<16>(p, st);
    case 2: return launch<32>(p, st);
    case 3: return launch<48>(p, st);
    case 4: return launch<64>(p, st);
    case 5: return launch<80>(p, st);
    case 6: return launch<96>(p, st);
    case 7: return launch<112>(p, st);
    case 8: return launch<128>(p, st);
    case 9: return launch<144>(p, st);
    case 10: return launch<160>(p, st);
    case 11: return launch<176>(p, st);
    case 12: return launch<192>(p, st);
    case 13: return launch<208>(p, st);
    case 14: return launch<224>(p, st);
    case 15: return launch<240>(p, st);
    case 16: return launch<256>(p, st);
    default: return int(cudaErrorInvalidValue);
  }
}

Params mma_params(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                  int N, int M, int H, int D, long long sqb, long long sqn, long long sqh,
                  long long skb, long long skn, long long skh, long long svb, long long svn,
                  long long svh, long long sob, long long son, long long soh, float scale,
                  int vec) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.B = B; p.N = N; p.M = M; p.H = H; p.D = D;
  p.sqb = sqb; p.sqn = sqn; p.sqh = sqh;
  p.skb = skb; p.skn = skn; p.skh = skh;
  p.svb = svb; p.svn = svn; p.svh = svh;
  p.sob = sob; p.son = son; p.soh = soh;
  p.scale = scale;
  p.vec = vec;
  return p;
}

}  // namespace

// The mma.sync kernel at any head the plan may send elsewhere (heads of
// 88-160 with aligned rows take the wgmma kernel since csrc/attn_fwd_wide.cu):
// vd_flash_fwd's arguments with vec (1: 16-byte cp.async loads, which need
// d % 8 == 0 and aligned rows; 0: element loads) in place of the plan. No
// wrapper calls it; chip_smoke.py times the kernel the wide heads left
// beside the one that replaced it. Returns a cudaError_t code.
extern "C" int vd_flash_fwd_mma(const void* q, const void* k, const void* v, void* o, void* lse,
                                int B, int N, int M, int H, int D, long long sqb, long long sqn,
                                long long sqh, long long skb, long long skn, long long skh,
                                long long svb, long long svn, long long svh, long long sob,
                                long long son, long long soh, float scale, int vec,
                                void* stream) {
  const long long strides[9] = {sqb, sqn, sqh, skb, skn, skh, svb, svn, svh};
  if (vec != 0 && (D % 8 != 0 || !vdattn::aligned16(q, k, v, strides)))
    return int(cudaErrorInvalidValue);
  return launch_mma(mma_params(q, k, v, o, lse, B, N, M, H, D, sqb, sqn, sqh, skb, skn, skh,
                               svb, svn, svh, sob, son, soh, scale, vec != 0),
                    static_cast<cudaStream_t>(stream));
}

// Returns a cudaError_t code; 0 means the launch was accepted. plan: the
// caller's AttnFwdPlan.code, which must be the one vdattn::plan_code gives
// these arguments (cudaErrorInvalidValue otherwise).
extern "C" int vd_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int B, int N, int M, int H, int D, long long sqb, long long sqn,
                            long long sqh, long long skb, long long skn, long long skh,
                            long long svb, long long svn, long long svh, long long sob,
                            long long son, long long soh, float scale, int plan, void* stream) {
  const long long strides[9] = {sqb, sqn, sqh, skb, skn, skh, svb, svn, svh};
  if (plan != vdattn::plan_code(D, N, q, k, v, strides)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vdattn::is_wg(plan)) {
    vdattn::Args a = {};
    a.q = static_cast<const __nv_bfloat16*>(q);
    a.k = static_cast<const __nv_bfloat16*>(k);
    a.v = static_cast<const __nv_bfloat16*>(v);
    a.o = static_cast<__nv_bfloat16*>(o);
    a.lse = static_cast<float*>(lse);
    a.B = B; a.N = N; a.M = M; a.H = H; a.D = D;
    a.sqb = sqb; a.sqn = sqn; a.sqh = sqh;
    a.skb = skb; a.skn = skn; a.skh = skh;
    a.svb = svb; a.svn = svn; a.svh = svh;
    a.sob = sob; a.son = son; a.soh = soh;
    a.qscale = scale;
    return lse != nullptr ? vdattn::dispatch_wg<vdattn::Mode::FlashLse>(a, st)
                          : vdattn::dispatch_wg<vdattn::Mode::Flash>(a, st);
  }
  return launch_mma(mma_params(q, k, v, o, lse, B, N, M, H, D, sqb, sqn, sqh, skb, skn, skh,
                               svb, svn, svh, sob, son, soh, scale, plan),
                    st);
}
#endif  // VD_FLASH_FWD_F32
