// Flash-attention backward for Hopper (sm_90a): bf16 q, k, v, dO in, f32
// lse and delta in, bf16 dQ, dK, dV out, every product accumulated in f32.
//
// Replaces: vdtpu/ops/pallas/flash.py::_bwd_impl, that is its two TPU
// kernels _bwd_dq_kernel (dQ over query blocks) and _bwd_dkv_kernel (dK and
// dV over key blocks), reached through the custom_vjp of _flash. Same
// function; the numerics of one pass over key blocks
// (vdtpu_torch/ops/flash.py::flash_attention_bwd_blocked_plain):
//   s  = q . k^T                    f32 (q unscaled, as the TPU backward)
//   p  = exp2(s * (scale log2 e) - lse log2 e)   f32; lse from the forward
//   dV = bf16(p)^T . dO
//   dS = bf16(p * (dO . V^T - delta) * scale), delta = rowsum(dO * O) in f32
//   dQ = dS . K (f32 partials of the key blocks added in device memory),
//   dK = dS^T . Q
// delta is one elementwise pass outside the kernel (the wrapper), as the
// JAX package computes it outside Pallas.
//
// Bound on this card at the main-path shape [4, 4096, 8, 40] (B*H = 32):
// one q.k^T-sized product is 2 * 32 * 4096^2 * 40 = 42.9 GFLOP; the 5
// products take 0.217 ms at 989 TFLOP/s, the 537 M exponentials 0.129 ms
// at 16 per SM per clock, memory (q, k, v, o, dO, dQ, dK, dV in bf16 and
// two f32 rows) about 0.025 ms. The tensor cores set the floor.
//
// The earlier design ran the TPU's split, a dQ kernel and a dK/dV kernel:
// 7 products and 2 exponentials a score, 69 SASS instructions a score in
// their two main loops at d 40 (vdtpu_torch/utils/sass.py), most of them
// scalar shared-memory loads of transposed operands and address arithmetic.
// Here one kernel walks the query tiles once per key block, 5 products and
// one exp2 a score (log2 e folded into the scale and lse, ex2.approx.ftz),
// P^T and dS^T kept in registers as the bf16 A operand of dV and dK, dK and
// dV accumulated in registers across the whole query loop, and dQ's f32
// partials added into the workspace dq_acc [B*H, N padded to 64, DP] by
// bulk reduce-adds (cp.reduce.async.bulk .add.f32: the copy unit adds whole
// lines in L2), which the wrapper zeroes and a second small kernel converts
// to bf16 into the strided dQ. The f32 adds land in any order, so dQ's last
// bits vary from run to run (dK and dV do not); the card tests hold each
// run to the plain version, and two runs to each other, within the same
// bf16 tolerance. Padded rows are masked: keys past M get p = 0 (their S is
// 0, and exp2(-lse) could overflow); queries past N add nothing (zero q and
// dO, and p = 0).
//
// Two kernels. flash_bwd_wg_kernel (heads up to 80 with 16-byte aligned rows:
// the main path's 40 and 80) is all wgmma with TMA tiles; see its comment.
// flash_bwd_kernel takes every other head width and layout: 8 warps of
// mma.sync m16n8k16 over a 128-key block, operands by ldmatrix from padded
// shared-memory rows, the 64-query tiles double-buffered by cp.async, dQ
// through shared memory and one bulk reduce-add a tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"
#include "tma_map.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int kKeys = 128;        // keys a block owns: 16 per warp
constexpr int kWarps = kKeys / 16;
constexpr int kBwdThreads = 32 * kWarps;
constexpr int kQT = 64;           // queries a streamed tile
constexpr int kLDS = kQT + kPad;  // bf16 row of the dS^T tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;    // [B, H, N]
  const float* delta;  // [B, H, N]
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* dq_acc;       // [B * H, n_pad, DP], zeroed
  int B, N, M, H, D, n_pad;
  long long sqb, sqn, sqh;
  long long skb, skn, skh;
  long long svb, svn, svh;
  long long sdob, sdon, sdoh;
  long long sdqb, sdqn, sdqh;
  long long sdkb, sdkn, sdkh;
  long long sdvb, sdvn, sdvh;
  float scale;
  int vec;  // 1: rows are 16-byte aligned and d % 8 == 0 -> cp.async path
};

// shared memory: the f32 dQ staging tiles (two), K and V, the Q / dO ring,
// dS^T, the lse / delta ring
template <int DP>
__host__ __device__ constexpr int smem_bytes(int stages) {
  return 2 * kQT * DP * 4 + 2 * kKeys * (DP + kPad) * 2 + stages * 2 * kQT * (DP + kPad) * 2 +
         kKeys * kLDS * 2 + stages * 2 * kQT * 4;
}
template <int DP>
__host__ __device__ constexpr int q_stages() {
  return smem_bytes<DP>(3) <= kMaxSmem ? 3 : 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)), "l"(gmem),
               "r"(src_bytes));
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// bytes of shared memory added into global memory, f32 element-wise, by the
// bulk-copy unit; completes in this thread's bulk group
__device__ __forceinline__ void bulk_reduce_add(float* gdst, const float* ssrc, int bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(
                   gdst),
               "r"(smem_u32(ssrc)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// rows [row0, row0 + ROWS) x cols [0, DP) of one (batch, head) slice into
// shared memory (row stride DP + kPad), zero past nrows and d; vec: 16-byte
// cp.async chunks, otherwise element by element
template <int DP, int ROWS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* smem, const __nv_bfloat16* base,
                                          long long row_stride, int row0, int nrows, int d,
                                          bool vec) {
  constexpr int LD = DP + kPad, CHUNKS = DP / 8;
  for (int idx = threadIdx.x; idx < ROWS * CHUNKS; idx += kBwdThreads) {
    const int r = idx / CHUNKS, c = idx % CHUNKS;
    __nv_bfloat16* dst = smem + r * LD + c * 8;
    const int grow = row0 + r;
    if (vec) {
      const bool ok = grow < nrows && c * 8 < d;
      cp_async16(dst, ok ? base + grow * row_stride + c * 8 : base, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = c * 8 + e;
        dst[e] = grow < nrows && col < d ? base[grow * row_stride + col] : __float2bfloat16(0.f);
      }
    }
  }
}

// This warp's 16 rows x DP f32 accumulators as bf16 rows of one slice.
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long row_stride,
                                           const float (*acc)[4], int row0, int nrows, int d,
                                           int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= nrows) continue;
    __nv_bfloat16* orow = base + row * row_stride;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = dt * 8 + t * 2 + e;
        if (col < d) orow[col] = __float2bfloat16(acc[dt][2 * r + e]);
      }
  }
}

// The mma.sync kernel, for the heads and layouts the wgmma kernel does not
// take (see the file comment): warp w owns keys 16 w + [0, 16) of the block.
template <int DP>
__global__ void __launch_bounds__(kBwdThreads, 1) flash_bwd_kernel(const Params p) {
  constexpr int LD = DP + kPad;
  constexpr int NT = kQT / 8;   // n8 tiles of a 64-query row
  constexpr int DT = DP / 8;    // n8 tiles of the head
  constexpr int KT = DP / 16;   // k16 steps over the head
  constexpr int DH = DP / 2;    // dQ columns a warp
  constexpr int DHT = DH / 8;
  constexpr int NQS = q_stages<DP>();

  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* s_stage = reinterpret_cast<float*>(smem_raw);  // [2][kQT][DP]
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(s_stage + 2 * kQT * DP);
  __nv_bfloat16* sV = sK + kKeys * LD;
  __nv_bfloat16* sQ = sV + kKeys * LD;       // [NQS][kQT][LD]
  __nv_bfloat16* sDO = sQ + NQS * kQT * LD;  // [NQS][kQT][LD]
  __nv_bfloat16* sdS = sDO + NQS * kQT * LD;  // [kKeys][kLDS], dS^T
  float* sL = reinterpret_cast<float*>(sdS + kKeys * kLDS);  // [NQS][kQT]
  float* sDl = sL + NQS * kQT;                               // [NQS][kQT]

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * kKeys;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const bool vec = p.vec != 0;
  const __nv_bfloat16* qb = p.q + b * p.sqb + h * p.sqh;
  const __nv_bfloat16* dob = p.dout + b * p.sdob + h * p.sdoh;
  const float* lseb = p.lse + size_t(bh) * p.N;
  const float* deltab = p.delta + size_t(bh) * p.N;
  float* dq_acc = p.dq_acc + size_t(bh) * p.n_pad * DP;
  const int nqt = (p.N + kQT - 1) / kQT;

  // tile i (queries [64 i, 64 i + 64)) into ring slot i % NQS; rows past N
  // read as zeros (lse and delta included)
  auto load_tile = [&](int i) {
    const int slot = i % NQS, q0 = i * kQT;
    load_rows<DP, kQT>(sQ + slot * kQT * LD, qb, p.sqn, q0, p.N, p.D, vec);
    load_rows<DP, kQT>(sDO + slot * kQT * LD, dob, p.sdon, q0, p.N, p.D, vec);
    if (tid < 2 * kQT) {
      const int r = tid % kQT, row = q0 + r;
      const float* src = (tid < kQT ? lseb : deltab) + (row < p.N ? row : 0);
      cp_async4((tid < kQT ? sL : sDl) + slot * kQT + r, src, row < p.N ? 4 : 0);
    }
  };
  load_rows<DP, kKeys>(sK, p.k + b * p.skb + h * p.skh, p.skn, k0, p.M, p.D, vec);
  load_rows<DP, kKeys>(sV, p.v + b * p.svb + h * p.svh, p.svn, k0, p.M, p.D, vec);
#pragma unroll
  for (int s = 0; s < NQS - 1; ++s) {
    if (s < nqt) load_tile(s);
    cp_async_commit();  // group 0 also carries K and V
  }

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }
  // this thread's key rows g and g + 8 of its warp's 16
  const bool key_ok[2] = {k0 + warp * 16 + g < p.M, k0 + warp * 16 + g + 8 < p.M};
  const float scale_log2 = p.scale * kLog2e;
  // ldmatrix lane offsets: x4 of a 16 x 16 block whose matrices 1 and 3 are
  // the second 8 rows (row_a, col_a) or the second 8 columns (row_b, col_b)
  const int row_a = (lane & 7) + ((lane >> 3) & 1) * 8, col_a = (lane >> 4) * 8;
  const int row_b = (lane & 7) + (lane >> 4) * 8, col_b = ((lane >> 3) & 1) * 8;
  const int qr = 16 * (warp & 3), dc = DH * (warp >> 2);  // this warp's dQ block

  for (int i = 0; i < nqt; ++i) {
    const int slot = i % NQS;
    cp_async_wait<NQS - 2>();  // tile i landed (and K, V)
    __syncthreads();           // (A) tile i visible; every warp is done with tile i - 1
    if (tid == 0 && i >= 1)    // tile i - 1's dQ partial, staged before (A)
      bulk_reduce_add(dq_acc + size_t(i - 1) * kQT * DP, s_stage + ((i - 1) & 1) * kQT * DP,
                      kQT * DP * 4);
    if (i + NQS - 1 < nqt) load_tile(i + NQS - 1);  // into tile i - 1's slot
    cp_async_commit();

    const __nv_bfloat16* Qt = sQ + slot * kQT * LD;
    const __nv_bfloat16* DOt = sDO + slot * kQT * LD;
    const float* Lt = sL + slot * kQT;
    const float* Dt = sDl + slot * kQT;

    // S^T = K . Q^T and dP^T = V . dO^T for this warp's 16 keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t ak[4], av[4];
      ldsm_x4(ak, sK + (warp * 16 + row_a) * LD + kk * 16 + col_a);
      ldsm_x4(av, sV + (warp * 16 + row_a) * LD + kk * 16 + col_a);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bq[4], bo[4];
        ldsm_x4(bq, Qt + (np * 16 + row_b) * LD + kk * 16 + col_b);
        ldsm_x4(bo, DOt + (np * 16 + row_b) * LD + kk * 16 + col_b);
        mma_16816(s[2 * np], ak, bq[0], bq[1]);
        mma_16816(s[2 * np + 1], ak, bq[2], bq[3]);
        mma_16816(dp[2 * np], av, bo[0], bo[1]);
        mma_16816(dp[2 * np + 1], av, bo[2], bo[3]);
      }
    }
    // P^T and dS^T in place: query column 8 n + 2 t + (e & 1), key row e >> 1
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(Lt + n * 8 + 2 * t);
      const float2 dl = *reinterpret_cast<const float2*>(Dt + n * 8 + 2 * t);
      const float lq[2] = {l2.x * kLog2e, l2.y * kLog2e}, dq2[2] = {dl.x, dl.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = key_ok[e >> 1] ? ex2(__fmaf_rn(s[n][e], scale_log2, -lq[e & 1])) : 0.f;
        s[n][e] = pr;
        dp[n][e] = pr * (dp[n][e] - dq2[e & 1]) * p.scale;
      }
    }
    // dV += bf16(P^T) . dO, dK += bf16(dS^T) . Q over the tile's queries;
    // dS^T goes to shared memory for the dQ product
#pragma unroll
    for (int kc = 0; kc < kQT / 16; ++kc) {
      const uint32_t ap[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      const uint32_t as[4] = {pack_bf16(dp[2 * kc][0], dp[2 * kc][1]),
                              pack_bf16(dp[2 * kc][2], dp[2 * kc][3]),
                              pack_bf16(dp[2 * kc + 1][0], dp[2 * kc + 1][1]),
                              pack_bf16(dp[2 * kc + 1][2], dp[2 * kc + 1][3])};
      __nv_bfloat16* ds_row = sdS + (warp * 16 + g) * kLDS + kc * 16 + 2 * t;
      *reinterpret_cast<uint32_t*>(ds_row) = as[0];
      *reinterpret_cast<uint32_t*>(ds_row + 8 * kLDS) = as[1];
      *reinterpret_cast<uint32_t*>(ds_row + 8) = as[2];
      *reinterpret_cast<uint32_t*>(ds_row + 8 * kLDS + 8) = as[3];
#pragma unroll
      for (int dp2 = 0; dp2 < DT / 2; ++dp2) {
        uint32_t bo[4], bq[4];
        ldsm_x4_t(bo, DOt + (kc * 16 + row_a) * LD + dp2 * 16 + col_a);
        ldsm_x4_t(bq, Qt + (kc * 16 + row_a) * LD + dp2 * 16 + col_a);
        mma_16816(dv[2 * dp2], ap, bo[0], bo[1]);
        mma_16816(dv[2 * dp2 + 1], ap, bo[2], bo[3]);
        mma_16816(dk[2 * dp2], as, bq[0], bq[1]);
        mma_16816(dk[2 * dp2 + 1], as, bq[2], bq[3]);
      }
    }
    // the staging tile of this parity was last read by tile i - 2's reduce
    if (tid == 0) bulk_wait_read<1>();
    __syncthreads();  // (B) every warp's dS^T stored

    // dQ (queries qr + [0, 16), columns dc + [0, DH)) = dS . K over the
    // block's 128 keys, staged as f32 rows of DP
    float dqa[DHT][4];
#pragma unroll
    for (int j = 0; j < DHT; ++j) dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kKeys / 16; ++kc) {
      uint32_t a[4];
      ldsm_x4_t(a, sdS + (kc * 16 + row_b) * kLDS + qr + col_b);
#pragma unroll
      for (int jp = 0; jp < DHT / 2; ++jp) {
        uint32_t bk[4];
        ldsm_x4_t(bk, sK + (kc * 16 + row_a) * LD + dc + jp * 16 + col_a);
        mma_16816(dqa[2 * jp], a, bk[0], bk[1]);
        mma_16816(dqa[2 * jp + 1], a, bk[2], bk[3]);
      }
      if constexpr (DHT % 2 == 1) {
        uint32_t bk[2];
        ldsm_x2_t(bk, sK + (kc * 16 + row_a) * LD + dc + (DHT - 1) * 8);
        mma_16816(dqa[DHT - 1], a, bk[0], bk[1]);
      }
    }
    float* stg = s_stage + (i & 1) * kQT * DP;
#pragma unroll
    for (int j = 0; j < DHT; ++j) {
      float* r0 = stg + (qr + g) * DP + dc + j * 8 + 2 * t;
      *reinterpret_cast<float2*>(r0) = make_float2(dqa[j][0], dqa[j][1]);
      *reinterpret_cast<float2*>(r0 + 8 * DP) = make_float2(dqa[j][2], dqa[j][3]);
    }
    // the staged values are read by the bulk-copy unit (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    bulk_reduce_add(dq_acc + size_t(nqt - 1) * kQT * DP, s_stage + ((nqt - 1) & 1) * kQT * DP,
                    kQT * DP * 4);
    bulk_wait_all();
  }
  store_rows<DP>(p.dk + b * p.sdkb + h * p.sdkh, p.sdkn, dk, k0 + warp * 16, p.M, p.D, g, t);
  store_rows<DP>(p.dv + b * p.sdvb + h * p.sdvh, p.sdvn, dv, k0 + warp * 16, p.M, p.D, g, t);
}

// ---- the wgmma kernel (DP <= 80, aligned rows): two warpgroups of 64 keys ----

// Tensor maps of the wgmma kernel: q, dO and k, v as 4-D (D, H, rows, B)
// with boxes of one 16-byte column chunk (8 elements) x 64 or 128 rows, so
// a tile lands as DP / 8 planes of rows x 16 bytes; lse and delta as the
// flat f32 [B * H * N] with boxes of kRowBox elements from the 16-byte
// boundary at or below a tile's first row (a box must start on one).
struct Maps {
  CUtensorMap q, dout, k, v, lse, delta;
};

// A wgmma descriptor (no swizzle): start, LBO and SBO in bytes. K-major:
// LBO steps 8 elements along K, SBO 8 rows along M / N. MN-major (the
// transpose bit): SBO steps 8 elements along M / N, LBO 8 rows along K.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = smem_u32(p);
  return uint64_t((a & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) | (uint64_t(sbo >> 4) << 32);
}
__device__ __forceinline__ void stsm_x4_t(const __nv_bfloat16* p, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1,%2,%3,%4};\n" ::"r"(
                   smem_u32(p)),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving a wgmma operand's accesses across the
// asynchronous product that reads or writes it
template <int N>
__device__ __forceinline__ void keep(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
constexpr int kRowBox = kQT + 4;  // lse / delta elements a tile's box holds
constexpr int kRowSlot = 96;      // f32 a slot of them takes: 384 bytes, 128-byte aligned

template <int DP>
__host__ __device__ constexpr int wg_smem_bytes(int stages) {
  return 4 * kQT * DP * 4 + 2 * kKeys * DP * 2 + stages * 2 * kQT * DP * 2 + 2 * kQT * 64 * 2 +
         stages * 2 * kRowSlot * 4 + 8 * (1 + 2 * stages);
}
template <int DP>
__host__ __device__ constexpr int wg_stages() {
  return wg_smem_bytes<DP>(3) <= kMaxSmem ? 3 : 2;
}
// two wgmma warpgroups and a producer warpgroup (its first warp issues the
// TMA copies); from DP 64 on the producers hand registers to the wgmma
// warpgroups (setmaxnreg): 256 x 232 + 128 x 40 = 384 x 168, the most
// __launch_bounds__(384, 1) leaves a thread
constexpr int kWgThreads = kBwdThreads + 128;
constexpr int kWgRegs = 168, kMmaRegs = 232, kTmaRegs = 40;
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(128) : "memory");
}
// element (r, c) of a warpgroup's dS tile, 64 queries x 64 keys, K-major
// core matrices (8 of them a row group)
__device__ __forceinline__ int ds64_at(int r, int c) {
  return ((r >> 3) * 8 + (c >> 3)) * 64 + (r & 7) * 8 + (c & 7);
}

// One block owns 128 keys; warpgroup wg the keys 64 wg + [0, 64), warp w of
// the block the 16 keys 16 w + [0, 16) as rows of its accumulators. Every
// product is a wgmma, its shared-memory operands read by the tensor cores
// once per warpgroup rather than once per warp:
//   S^T  = K . Q^T      A = K rows (K-major), B = Q tile (K-major)     m64 n64
//   dP^T = V . dO^T     A = V rows, B = dO tile                         m64 n64
//   dV  += P^T . dO     A = bf16(P^T) registers, B = dO tile (MN-major) m64 nDP
//   dK  += dS^T . Q     A = bf16(dS^T) registers, B = Q tile (MN-major) m64 nDP
//   dQ_wg = dS . K      A = the warpgroup's dS (K-major), B = its 64 K
//                       rows (MN-major)                                 m64 nDP
// The two warpgroups share only the tile ring: the producer warpgroup's
// first warp fills it by TMA, one lane a copy, and each wgmma warpgroup
// releases a slot on its empty mbarrier when its products no longer read
// it; there is no block-wide barrier, so one warpgroup's exponentials
// overlap the other's products (two warpgroups in lockstep, sharing one dQ
// product over the 128 keys, were slower at d 40 on an H100).
// Each warpgroup stages its dQ partial in f32 and one of its threads adds
// it into dq_acc with a bulk reduce-add. Tiles arrive by TMA as planes of
// 16-byte rows (one plane per 8 columns): the K-major layout with LBO =
// one plane, and, read with the transpose bit, the MN-major one, so nothing
// is transposed in shared memory. dS is stored by stmatrix.trans from the
// dS^T registers.
template <int DP>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_wg_kernel(const Params p, const __grid_constant__ Maps maps) {
  constexpr int NQS = wg_stages<DP>();
  constexpr int KT = DP / 16;
  constexpr int kTileBytes = 2 * kQT * DP * 2 + 2 * kRowBox * 4;  // q, dO, lse, delta of a tile
  constexpr uint32_t kQPlane = kQT * 16, kKPlane = kKeys * 16;  // bytes of a column plane

  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* s_stage = reinterpret_cast<float*>(smem_raw);  // [wg][2][kQT][DP] f32
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(s_stage + 4 * kQT * DP);  // [DP/8][128][8]
  __nv_bfloat16* sV = sK + kKeys * DP;
  __nv_bfloat16* sQ = sV + kKeys * DP;        // [NQS][DP/8][64][8]
  __nv_bfloat16* sDO = sQ + NQS * kQT * DP;   // [NQS][DP/8][64][8]
  __nv_bfloat16* sdS = sDO + NQS * kQT * DP;  // [wg] 64 x 64, ds64_at
  float* sL = reinterpret_cast<float*>(sdS + 2 * kQT * 64);  // [NQS][kRowSlot]
  float* sDl = sL + NQS * kRowSlot;                          // [NQS][kRowSlot]
  const uint32_t bars = smem_u32(sDl + NQS * kRowSlot);      // kv, full[NQS], empty[NQS]
  auto full = [&](int slot) { return bars + 8 * (1 + slot); };
  auto empty = [&](int slot) { return bars + 8 * (1 + NQS + slot); };

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * kKeys;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nqt = (p.N + kQT - 1) / kQT;

  if (tid == 0) {
    vdt::bar_init(bars, 1);
    for (int s = 0; s < NQS; ++s) {
      vdt::bar_init(full(s), 1);
      vdt::bar_init(empty(s), 2);  // one arrival a warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kBwdThreads / 32) {
    if constexpr (DP >= 64) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kTmaRegs));
    if (warp > kBwdThreads / 32) return;
    // the TMA warp: K and V, then tile j into slot j % NQS once both
    // warpgroups released its previous tile; lane c copies Q's column plane
    // c, DP / 8 + c dO's, then lse, delta
    if (lane == 0) vdt::bar_expect_tx(bars, 2 * kKeys * DP * 2);
    __syncwarp();
    if (lane < DP / 4) {
      const int c = lane % (DP / 8);
      const bool is_k = lane < DP / 8;
      vdt::tma_4d(smem_u32((is_k ? sK : sV) + c * kKeys * 8), is_k ? &maps.k : &maps.v, 8 * c, h,
                  k0, b, bars);
    }
    for (int j = 0; j < nqt; ++j) {
      const int slot = j % NQS, q0 = j * kQT;
      if (j >= NQS) vdt::bar_wait(empty(slot), ((j / NQS) - 1) & 1);
      if (lane == 0) vdt::bar_expect_tx(full(slot), kTileBytes);
      __syncwarp();
      if (lane < DP / 4) {
        const int c = lane % (DP / 8);
        const bool is_q = lane < DP / 8;
        vdt::tma_4d(smem_u32((is_q ? sQ : sDO) + (slot * DP / 8 + c) * kQT * 8),
                    is_q ? &maps.q : &maps.dout, 8 * c, h, q0, b, full(slot));
      } else if (lane < DP / 4 + 2) {
        const int r0 = (bh * p.N + q0) & ~3;
        const bool is_l = lane == DP / 4;
        vdt::tma_1d(smem_u32((is_l ? sL : sDl) + slot * kRowSlot), is_l ? &maps.lse : &maps.delta,
                    r0, full(slot));
      }
    }
    return;
  }

  if constexpr (DP >= 64) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kMmaRegs));
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const bool reducer = wl == 0 && lane == 0;
  float* dq_acc = p.dq_acc + size_t(bh) * p.n_pad * DP;
  float* stage_wg = s_stage + wg * 2 * kQT * DP;
  __nv_bfloat16* ds_wg = sdS + wg * kQT * 64;
  float dk[DP / 2], dv[DP / 2];  // m64 nDP accumulators: DP / 2 a thread
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
  const bool key_ok[2] = {k0 + warp * 16 + g < p.M, k0 + warp * 16 + g + 8 < p.M};
  const float scale_log2 = p.scale * kLog2e;
  const __nv_bfloat16* kw = sK + 64 * wg * 8;  // row 64 wg of plane 0: this warpgroup's keys
  const __nv_bfloat16* vw = sV + 64 * wg * 8;
  vdt::bar_wait(bars, 0);  // K and V

  for (int i = 0; i < nqt; ++i) {
    const int slot = i % NQS, q0 = i * kQT;
    vdt::bar_wait(full(slot), (i / NQS) & 1);
    const __nv_bfloat16* Qt = sQ + slot * kQT * DP;
    const __nv_bfloat16* DOt = sDO + slot * kQT * DP;

    // S^T and dP^T for this warpgroup's 64 keys x the tile's 64 queries
    float s[32], dp[32];
    keep(s);
    keep(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      vdw::Wgmma<64>::ss(s, desc(kw + 2 * kk * kKeys * 8, kKPlane, 128),
                         desc(Qt + 2 * kk * kQT * 8, kQPlane, 128), kk);
      vdw::Wgmma<64>::ss(dp, desc(vw + 2 * kk * kKeys * 8, kKPlane, 128),
                         desc(DOt + 2 * kk * kQT * 8, kQPlane, 128), kk);
    }
    wg_commit();
    wg_wait0();
    keep(s);
    keep(dp);

    // P^T and dS^T in place: query column 8 n + 2 t + (e & 1), key row e >> 1;
    // queries past N (the flat lse / delta boxes run into the next head)
    // take lse = +inf, so p = 0
    const int lead = (bh * p.N + q0) & 3;  // the box starts this many rows early
    const float* Lt = sL + slot * kRowSlot + lead;
    const float* Dt = sDl + slot * kRowSlot + lead;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int qc = q0 + n * 8 + 2 * t;
      const float lq[2] = {qc < p.N ? Lt[n * 8 + 2 * t] * kLog2e : INFINITY,
                           qc + 1 < p.N ? Lt[n * 8 + 2 * t + 1] * kLog2e : INFINITY};
      const float dq2[2] = {Dt[n * 8 + 2 * t], Dt[n * 8 + 2 * t + 1]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr =
            key_ok[e >> 1] ? ex2(__fmaf_rn(s[4 * n + e], scale_log2, -lq[e & 1])) : 0.f;
        s[4 * n + e] = pr;
        dp[4 * n + e] = pr * (dp[4 * n + e] - dq2[e & 1]) * p.scale;
      }
    }
    uint32_t ap[4][4], as[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const int n0 = 8 * kc;  // accumulators of query columns 16 kc + [0, 16)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        ap[kc][r] = pack_bf16(s[n0 + 2 * r], s[n0 + 2 * r + 1]);
        as[kc][r] = pack_bf16(dp[n0 + 2 * r], dp[n0 + 2 * r + 1]);
      }
    }
    // dV += P^T . dO and dK += dS^T . Q over the tile's queries
    keep(ap);
    keep(as);
    keep(dv);
    keep(dk);
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      vdw::Wgmma<DP>::rs_tb(dv, ap[kc], desc(DOt + 16 * kc * 8, 128, kQPlane), 1);
      vdw::Wgmma<DP>::rs_tb(dk, as[kc], desc(Qt + 16 * kc * 8, 128, kQPlane), 1);
    }
    wg_commit();
    // this warpgroup's dS (queries x its keys): each 8 x 8 block of dS^T
    // stored transposed
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const int mi = lane >> 3;  // block as[kc][mi]: keys + 8 (mi & 1), queries + 8 (mi >> 1)
      stsm_x4_t(ds_wg + ds64_at(16 * kc + 8 * (mi >> 1) + (lane & 7), 16 * wl + 8 * (mi & 1)),
                as[kc]);
    }
    wg_wait0();
    keep(ap);
    keep(as);
    keep(dv);
    keep(dk);
    fence_async_smem();                    // dS, read by wgmma
    if (reducer) bulk_wait_read<1>();      // tile i - 2's reduce has read this staging tile
    wg_sync(wg);                           // the warpgroup's dS stored, its slot reads done
    if (wl == 0 && lane == 0) vdt::bar_arrive(empty(slot));

    // dQ of the tile from this warpgroup's 64 keys
    float dq[DP / 2];
    keep(dq);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      vdw::Wgmma<DP>::ss_tb(dq, desc(ds_wg + 2 * kk * 64, 128, 8 * 128),
                            desc(kw + 16 * kk * 8, 128, kKPlane), kk);
    wg_commit();
    wg_wait0();
    keep(dq);
    float* stg = stage_wg + (i & 1) * kQT * DP;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      float* r0 = stg + (16 * wl + g) * DP + j * 8 + 2 * t;
      *reinterpret_cast<float2*>(r0) = make_float2(dq[4 * j], dq[4 * j + 1]);
      *reinterpret_cast<float2*>(r0 + 8 * DP) = make_float2(dq[4 * j + 2], dq[4 * j + 3]);
    }
    fence_async_smem();  // read by the bulk-copy unit
    wg_sync(wg);         // the staging tile complete
    if (reducer) bulk_reduce_add(dq_acc + size_t(i) * kQT * DP, stg, kQT * DP * 4);
  }
  if (reducer) bulk_wait_all();
  store_rows<DP>(p.dk + b * p.sdkb + h * p.sdkh, p.sdkn,
                 reinterpret_cast<const float(*)[4]>(dk), k0 + warp * 16, p.M, p.D, g, t);
  store_rows<DP>(p.dv + b * p.sdvb + h * p.sdvh, p.sdvn,
                 reinterpret_cast<const float(*)[4]>(dv), k0 + warp * 16, p.M, p.D, g, t);
}

// the wgmma kernel's tensor maps; a cudaError_t code
inline int make_maps(Maps* m, const Params& p) {
  const cuuint64_t qd[4] = {cuuint64_t(p.D), cuuint64_t(p.H), cuuint64_t(p.N), cuuint64_t(p.B)};
  const cuuint64_t kd[4] = {cuuint64_t(p.D), cuuint64_t(p.H), cuuint64_t(p.M), cuuint64_t(p.B)};
  const cuuint64_t qs[3] = {cuuint64_t(p.sqh * 2), cuuint64_t(p.sqn * 2), cuuint64_t(p.sqb * 2)};
  const cuuint64_t os[3] = {cuuint64_t(p.sdoh * 2), cuuint64_t(p.sdon * 2),
                            cuuint64_t(p.sdob * 2)};
  const cuuint64_t ks[3] = {cuuint64_t(p.skh * 2), cuuint64_t(p.skn * 2), cuuint64_t(p.skb * 2)};
  const cuuint64_t vs[3] = {cuuint64_t(p.svh * 2), cuuint64_t(p.svn * 2), cuuint64_t(p.svb * 2)};
  const cuuint32_t qbox[4] = {8, 1, kQT, 1}, kbox[4] = {8, 1, kKeys, 1};
  const cuuint64_t rows[1] = {cuuint64_t(p.B) * p.H * p.N}, no_strides[1] = {0};
  const cuuint32_t rbox[1] = {kRowBox};
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const auto none = CU_TENSOR_MAP_SWIZZLE_NONE;
  int rc;
  if ((rc = vdt::encode_map(&m->q, bf, 4, p.q, qd, qs, qbox, none))) return rc;
  if ((rc = vdt::encode_map(&m->dout, bf, 4, p.dout, qd, os, qbox, none))) return rc;
  if ((rc = vdt::encode_map(&m->k, bf, 4, p.k, kd, ks, kbox, none))) return rc;
  if ((rc = vdt::encode_map(&m->v, bf, 4, p.v, kd, vs, kbox, none))) return rc;
  if ((rc = vdt::encode_map(&m->lse, f32, 1, p.lse, rows, no_strides, rbox, none))) return rc;
  return vdt::encode_map(&m->delta, f32, 1, p.delta, rows, no_strides, rbox, none);
}

// dQ = bf16(dq_acc) into the strided [B, N, H, D] output (the workspace row
// of a query is dp f32): eight columns a thread, one 16-byte store where D %
// 8 == 0 and the rows are 16-byte aligned (vec), else one column a thread
__global__ void dq_convert_kernel(const Params p, int dp) {
  const int per = p.vec ? 8 : 1;
  const int groups = (p.D + per - 1) / per;
  const long long total = (long long)p.B * p.H * p.N * groups;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const int c = int(idx % groups) * per;
    const long long r = idx / groups;
    const int n = int(r % p.N);
    const int bh = int(r / p.N), b = bh / p.H, h = bh % p.H;
    const float* src = p.dq_acc + (size_t(bh) * p.n_pad + n) * dp + c;
    __nv_bfloat16* dst = p.dq + b * p.sdqb + n * p.sdqn + h * p.sdqh + c;
    if (p.vec) {
      const float4 lo = *reinterpret_cast<const float4*>(src);
      const float4 hi = *reinterpret_cast<const float4*>(src + 4);
      uint4 v;
      v.x = pack_bf16(lo.x, lo.y);
      v.y = pack_bf16(lo.z, lo.w);
      v.z = pack_bf16(hi.x, hi.y);
      v.w = pack_bf16(hi.z, hi.w);
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      *dst = __float2bfloat16(*src);
    }
  }
}

template <typename Kernel>
int allow_smem(Kernel kernel, int smem, bool& done) {
  if (done) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  done = err == cudaSuccess;
  return int(err);
}

// The wgmma kernel takes heads up to DP 80 (the main path's 40 and 80) with
// 16-byte aligned rows (its tiles come by TMA); other heads and layouts take
// the mma.sync kernel.
template <int DP>
int launch(const Params& p, cudaStream_t stream) {
  if (p.n_pad % kQT != 0 || p.n_pad < p.N) return int(cudaErrorInvalidValue);
  const dim3 grid((p.M + kKeys - 1) / kKeys, p.B * p.H);
  bool wg = false;
  if constexpr (DP <= 80) {
    wg = p.vec != 0;
    if (wg) {
      constexpr int smem = wg_smem_bytes<DP>(wg_stages<DP>());
      static_assert(smem <= kMaxSmem, "the wgmma kernel's tiles fit shared memory");
      static bool done = false;
      if (const int rc = allow_smem(flash_bwd_wg_kernel<DP>, smem, done)) return rc;
      if constexpr (DP >= 64) {
        // setmaxnreg.inc takes registers the dec freed: a kernel compiled to
        // fewer than kWgRegs a thread would wait forever
        static int regs = -1;
        if (regs < 0) {
          cudaFuncAttributes attr;
          if (const cudaError_t e = cudaFuncGetAttributes(&attr, flash_bwd_wg_kernel<DP>))
            return int(e);
          regs = attr.numRegs;
        }
        if (regs != kWgRegs) return int(cudaErrorInvalidConfiguration);
      }
      Maps maps;
      if (const int rc = make_maps(&maps, p)) return rc;
      flash_bwd_wg_kernel<DP><<<grid, kWgThreads, smem, stream>>>(p, maps);
    }
  }
  if (!wg) {
    constexpr int smem = smem_bytes<DP>(q_stages<DP>());
    static_assert(smem <= kMaxSmem, "the backward's tiles fit shared memory");
    static bool done = false;
    if (const int rc = allow_smem(flash_bwd_kernel<DP>, smem, done)) return rc;
    flash_bwd_kernel<DP><<<grid, kBwdThreads, smem, stream>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const long long total = (long long)p.B * p.H * p.N * (p.vec ? p.D / 8 : p.D);
  const int blocks = int((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  dq_convert_kernel<<<blocks, 256, 0, stream>>>(p, DP);
  return int(cudaGetLastError());
}

}  // namespace

// Launches the backward kernel, then the dQ conversion, on `stream`.
// dq_acc: f32 [B * H, n_pad, 16 * ceil(D / 16)] zeroed, n_pad a multiple of
// 64 and at least N. Returns a cudaError_t code; 0 means both launches were
// accepted. d <= 128.
extern "C" int vd_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, void* dk, void* dv,
                            void* dq_acc, int B, int N, int M, int H, int D, int n_pad,
                            long long sqb, long long sqn, long long sqh, long long skb,
                            long long skn, long long skh, long long svb, long long svn,
                            long long svh, long long sdob, long long sdon, long long sdoh,
                            long long sdqb, long long sdqn, long long sdqh, long long sdkb,
                            long long sdkn, long long sdkh, long long sdvb, long long sdvn,
                            long long sdvh, float scale, int vec, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.dq_acc = static_cast<float*>(dq_acc);
  p.B = B; p.N = N; p.M = M; p.H = H; p.D = D; p.n_pad = n_pad;
  p.sqb = sqb; p.sqn = sqn; p.sqh = sqh;
  p.skb = skb; p.skn = skn; p.skh = skh;
  p.svb = svb; p.svn = svn; p.svh = svh;
  p.sdob = sdob; p.sdon = sdon; p.sdoh = sdoh;
  p.sdqb = sdqb; p.sdqn = sdqn; p.sdqh = sdqh;
  p.sdkb = sdkb; p.sdkn = sdkn; p.sdkh = sdkh;
  p.sdvb = sdvb; p.sdvn = sdvn; p.sdvh = sdvh;
  p.scale = scale;
  p.vec = vec;
  if (reinterpret_cast<uintptr_t>(dq_acc) % 16 != 0) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16) {
    case 1: return launch<16>(p, st);
    case 2: return launch<32>(p, st);
    case 3: return launch<48>(p, st);
    case 4: return launch<64>(p, st);
    case 5: return launch<80>(p, st);
    case 6: return launch<96>(p, st);
    case 7: return launch<112>(p, st);
    case 8: return launch<128>(p, st);
    default: return int(cudaErrorInvalidValue);
  }
}
