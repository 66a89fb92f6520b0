// Flash-attention backward for Hopper (sm_90a): bf16 q, k, v, dO in, f32
// lse and delta in, bf16 dQ, dK, dV out, every product accumulated in f32.
//
// Replaces: vdtpu/ops/pallas/flash.py::_bwd_impl, that is its two TPU
// kernels _bwd_dq_kernel (dQ over query blocks) and _bwd_dkv_kernel (dK and
// dV over key blocks), reached through the custom_vjp of _flash. Same
// function and numerics:
//   s  = (q . k^T) * scale          f32 (q unscaled, as the TPU backward)
//   p  = exp(s - lse)               f32; lse from the forward (csrc/flash_fwd.cu)
//   dV = bf16(p)^T . dO
//   dS = bf16(p * (dO . V^T - delta) * scale), delta = rowsum(dO * O) in f32
//   dQ = dS . K,  dK = dS^T . Q
// delta is one elementwise pass outside the kernels (the wrapper), as the
// JAX package computes it outside Pallas.
//
// Two kernels, as the TPU split it, and not one kernel with an atomic dQ:
// each output tile is owned by one block, so there is no f32 dQ scratch in
// device memory, no conversion pass and no atomics, and the result does
// not depend on the order blocks run in. The price is that both kernels
// recompute S and exp(S - lse), and the dQ kernel recomputes dO . V^T: 7
// products and 2 exponentials per score instead of 5 and 1.
//
// Bound on this card at the main-path shape [4, 4096, 8, 40] (B*H = 32):
// one q.k^T-sized product is 2 * 32 * 4096^2 * 40 = 42.9 GFLOP, so the 7
// products are 0.304 ms at 989 TFLOP/s (d padded to 48 in shared memory:
// 0.365 ms of issued MMA); the 2 * 537 M exponentials are 0.257 ms at 16 per
// SM per clock; memory (q, k, v, o, dO, dQ, dK, dV in bf16 and two f32 rows)
// is about 84 MB, 0.025 ms. The least work (5 products, 1 exponential) is
// 0.217 ms. Exponentials and tensor cores, not memory, set the pace.
//
// What the design does about it:
// - the [N, M] score, probability and dS tiles never leave registers: each
//   warp owns 16 rows (queries in the dQ kernel, keys in the dK/dV kernel),
//   holds its 16 x 64 tiles in mma.sync accumulators and re-packs them in
//   registers as the bf16 A operand of the next product;
// - q, k, v, dO and the outputs are read and written in place through the
//   strides of [B, N, H, D] views; d is padded to a multiple of 16 in shared
//   memory only (40 -> 48);
// - the streamed tiles (K/V in the dQ kernel, Q/dO and their lse/delta rows
//   in the dK/dV kernel) are double-buffered with cp.async, so the next
//   tile's loads overlap the current tile's math;
// - padded rows and columns are masked, not padded in memory: keys past M
//   get p = 0 in the dQ kernel; queries past N carry lse = +inf (p = 0) and
//   zero-filled dO in the dK/dV kernel.
// mma.sync m16n8k16 and cp.async, as the forward; wgmma/TMA are left for a
// later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

constexpr int kRows = 64;    // rows a block owns: 16 per warp
constexpr int kTile = 64;    // rows of each streamed tile
constexpr float kLog2e = 1.4426950408889634f;

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
  int B, N, M, H, D;
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

// The A operand (16 rows x 16 of the contraction) of k-step kk, from a
// row-major shared-memory tile whose row g of this warp starts at `w`.
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* w, int ld, int kk) {
  a[0] = ld32(w + kk * 16);
  a[1] = ld32(w + 8 * ld + kk * 16);
  a[2] = ld32(w + kk * 16 + 8);
  a[3] = ld32(w + 8 * ld + kk * 16 + 8);
}

// acc[NT][4] = A(16 x DP, this warp's rows of `rows`) . B^T where B is the
// 64 x DP tile `cols` (row-major): a 16 x 64 product over the head dim.
template <int DP>
__device__ __forceinline__ void rows_by_cols(float (*acc)[4], const __nv_bfloat16* rows,
                                             const __nv_bfloat16* cols, int warp, int g,
                                             int t) {
  constexpr int LD = DP + kPad;
  constexpr int NT = kTile / 8;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const __nv_bfloat16* w = rows + (warp * 16 + g) * LD + t * 2;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4];
    load_a(a, w, LD, kk);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const __nv_bfloat16* c = cols + (nt * 8 + g) * LD + kk * 16 + t * 2;
      mma_16816(acc[nt], a, ld32(c), ld32(c + 8));
    }
  }
}

// out[DT][4] += bf16(X)(16 x 64, in accumulator layout) . T where T is the
// 64 x DP tile `tile` (row-major): the accumulators of one 16 x 64 product
// are already in A-operand order, so X never leaves registers.
template <int DP>
__device__ __forceinline__ void acc_times_tile(float (*out)[4], const float (*x)[4],
                                               const __nv_bfloat16* tile, int g, int t) {
  constexpr int LD = DP + kPad;
#pragma unroll
  for (int kc = 0; kc < kTile / 16; ++kc) {
    uint32_t a[4];
    a[0] = pack_bf16(x[2 * kc][0], x[2 * kc][1]);
    a[1] = pack_bf16(x[2 * kc][2], x[2 * kc][3]);
    a[2] = pack_bf16(x[2 * kc + 1][0], x[2 * kc + 1][1]);
    a[3] = pack_bf16(x[2 * kc + 1][2], x[2 * kc + 1][3]);
    const unsigned short* tr =
        reinterpret_cast<const unsigned short*>(tile + (kc * 16 + t * 2) * LD + g);
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      const unsigned short* tp = tr + dt * 8;
      const uint32_t b0 = uint32_t(tp[0]) | (uint32_t(tp[LD]) << 16);
      const uint32_t b1 = uint32_t(tp[8 * LD]) | (uint32_t(tp[9 * LD]) << 16);
      mma_16816(out[dt], a, b0, b1);
    }
  }
}

// Store this warp's 16 x DP f32 accumulators as bf16 rows of one slice.
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

// dQ over query blocks: the block owns 64 queries and streams K/V tiles.
template <int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Params p) {
  constexpr int LD = DP + kPad;
  constexpr int NT = kTile / 8;
  constexpr int DT = DP / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sDO = sQ + kRows * LD;
  __nv_bfloat16* sK = sDO + kRows * LD;   // two buffers
  __nv_bfloat16* sV = sK + 2 * kTile * LD;  // two buffers

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.x * kRows;
  const __nv_bfloat16* kb = p.k + b * p.skb + h * p.skh;
  const __nv_bfloat16* vb = p.v + b * p.svb + h * p.svh;
  const bool vec = p.vec != 0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  load_tile<DP>(sQ, p.q + b * p.sqb + h * p.sqh, p.sqn, q0, p.N, p.D, vec);
  load_tile<DP>(sDO, p.dout + b * p.sdob + h * p.sdoh, p.sdon, q0, p.N, p.D, vec);
  load_tile<DP>(sK, kb, p.skn, 0, p.M, p.D, vec);
  load_tile<DP>(sV, vb, p.svn, 0, p.M, p.D, vec);
  cp_async_commit();

  // this thread's rows: g and g + 8 of its warp's 16
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    lse[r] = row < p.N ? p.lse[size_t(bh) * p.N + row] : INFINITY;
    delta[r] = row < p.N ? p.delta[size_t(bh) * p.N + row] : 0.f;
  }
  float dq[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
  cp_async_wait_all();
  __syncthreads();

  const int nkt = (p.M + kTile - 1) / kTile;
  for (int j = 0; j < nkt; ++j) {
    const int cur = j & 1;
    if (j + 1 < nkt) {
      load_tile<DP>(sK + (cur ^ 1) * kTile * LD, kb, p.skn, (j + 1) * kTile, p.M, p.D, vec);
      load_tile<DP>(sV + (cur ^ 1) * kTile * LD, vb, p.svn, (j + 1) * kTile, p.M, p.D, vec);
      cp_async_commit();
    }
    const __nv_bfloat16* Kt = sK + cur * kTile * LD;
    const __nv_bfloat16* Vt = sV + cur * kTile * LD;
    float s[NT][4], dp[NT][4];
    rows_by_cols<DP>(s, sQ, Kt, warp, g, t);   // q . k^T
    rows_by_cols<DP>(dp, sDO, Vt, warp, g, t);  // dO . v^T
    const int kbase = j * kTile;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool key_ok = kbase + nt * 8 + t * 2 + (e & 1) < p.M;
        const float pr = key_ok ? exp2f((s[nt][e] * p.scale - lse[r]) * kLog2e) : 0.f;
        s[nt][e] = pr * (dp[nt][e] - delta[r]) * p.scale;  // dS
      }
    acc_times_tile<DP>(dq, s, Kt, g, t);  // dQ += bf16(dS) . k
    cp_async_wait_all();
    __syncthreads();
  }
  store_rows<DP>(p.dq + b * p.sdqb + h * p.sdqh, p.sdqn, dq, q0 + warp * 16, p.N, p.D, g, t);
}

// dK and dV over key blocks: the block owns 64 keys and streams Q/dO tiles
// with their lse and delta rows.
template <int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const Params p) {
  constexpr int LD = DP + kPad;
  constexpr int NT = kTile / 8;
  constexpr int DT = DP / 8;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kRows * LD;
  __nv_bfloat16* sQ = sV + kRows * LD;      // two buffers
  __nv_bfloat16* sDO = sQ + 2 * kTile * LD;  // two buffers
  float* sL = reinterpret_cast<float*>(sDO + 2 * kTile * LD);  // two buffers of lse
  float* sD = sL + 2 * kTile;                                  // two buffers of delta

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int k0 = blockIdx.x * kRows;
  const __nv_bfloat16* qb = p.q + b * p.sqb + h * p.sqh;
  const __nv_bfloat16* dob = p.dout + b * p.sdob + h * p.sdoh;
  const float* lseb = p.lse + size_t(bh) * p.N;
  const float* deltab = p.delta + size_t(bh) * p.N;
  const bool vec = p.vec != 0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  // queries past N: lse = +inf gives p = 0, so they add nothing
  auto load_rows = [&](int buf, int row0) {
    const int i = threadIdx.x % kTile;
    const int row = row0 + i;
    if (threadIdx.x < kTile)
      sL[buf * kTile + i] = row < p.N ? lseb[row] : INFINITY;
    else
      sD[buf * kTile + i] = row < p.N ? deltab[row] : 0.f;
  };
  load_tile<DP>(sK, p.k + b * p.skb + h * p.skh, p.skn, k0, p.M, p.D, vec);
  load_tile<DP>(sV, p.v + b * p.svb + h * p.svh, p.svn, k0, p.M, p.D, vec);
  load_tile<DP>(sQ, qb, p.sqn, 0, p.N, p.D, vec);
  load_tile<DP>(sDO, dob, p.sdon, 0, p.N, p.D, vec);
  load_rows(0, 0);
  cp_async_commit();

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  const int nqt = (p.N + kTile - 1) / kTile;
  for (int i = 0; i < nqt; ++i) {
    const int cur = i & 1;
    if (i + 1 < nqt) {
      load_tile<DP>(sQ + (cur ^ 1) * kTile * LD, qb, p.sqn, (i + 1) * kTile, p.N, p.D, vec);
      load_tile<DP>(sDO + (cur ^ 1) * kTile * LD, dob, p.sdon, (i + 1) * kTile, p.N, p.D, vec);
      load_rows(cur ^ 1, (i + 1) * kTile);
      cp_async_commit();
    }
    const __nv_bfloat16* Qt = sQ + cur * kTile * LD;
    const __nv_bfloat16* DOt = sDO + cur * kTile * LD;
    const float* Lt = sL + cur * kTile;
    const float* Dt = sD + cur * kTile;
    float st[NT][4], dpt[NT][4];
    rows_by_cols<DP>(st, sK, Qt, warp, g, t);    // (q . k^T)^T for this warp's keys
    rows_by_cols<DP>(dpt, sV, DOt, warp, g, t);  // (dO . v^T)^T
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nt * 8 + t * 2 + (e & 1);
        const float pr = exp2f((st[nt][e] * p.scale - Lt[qi]) * kLog2e);
        st[nt][e] = pr;
        dpt[nt][e] = pr * (dpt[nt][e] - Dt[qi]) * p.scale;  // dS^T
      }
    acc_times_tile<DP>(dv, st, DOt, g, t);   // dV += bf16(p)^T . dO
    acc_times_tile<DP>(dk, dpt, Qt, g, t);   // dK += bf16(dS)^T . q
    cp_async_wait_all();
    __syncthreads();
  }
  store_rows<DP>(p.dk + b * p.sdkb + h * p.sdkh, p.sdkn, dk, k0 + warp * 16, p.M, p.D, g, t);
  store_rows<DP>(p.dv + b * p.sdvb + h * p.sdvh, p.sdvn, dv, k0 + warp * 16, p.M, p.D, g, t);
}

template <int DP>
int launch(const Params& p, cudaStream_t stream) {
  const size_t tiles = size_t(2 * kRows + 4 * kTile) * (DP + kPad) * sizeof(__nv_bfloat16);
  const size_t smem_dq = tiles;
  const size_t smem_dkv = tiles + 4 * kTile * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem_dq));
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_dkv));
  if (err != cudaSuccess) return int(err);
  flash_bwd_dq_kernel<DP><<<dim3((p.N + kRows - 1) / kRows, p.B * p.H), kThreads, smem_dq,
                            stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  flash_bwd_dkv_kernel<DP><<<dim3((p.M + kRows - 1) / kRows, p.B * p.H), kThreads, smem_dkv,
                             stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

// Launches the dQ kernel, then the dK/dV kernel, on `stream`. Returns a
// cudaError_t code; 0 means both launches were accepted. d <= 128.
extern "C" int vd_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, void* dk, void* dv,
                            int B, int N, int M, int H, int D, long long sqb, long long sqn,
                            long long sqh, long long skb, long long skn, long long skh,
                            long long svb, long long svn, long long svh, long long sdob,
                            long long sdon, long long sdoh, long long sdqb, long long sdqn,
                            long long sdqh, long long sdkb, long long sdkn, long long sdkh,
                            long long sdvb, long long sdvn, long long sdvh, float scale,
                            int vec, void* stream) {
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
  p.B = B; p.N = N; p.M = M; p.H = H; p.D = D;
  p.sqb = sqb; p.sqn = sqn; p.sqh = sqh;
  p.skb = skb; p.skn = skn; p.skh = skh;
  p.svb = svb; p.svn = svn; p.svh = svh;
  p.sdob = sdob; p.sdon = sdon; p.sdoh = sdoh;
  p.sdqb = sdqb; p.sdqn = sdqn; p.sdqh = sdqh;
  p.sdkb = sdkb; p.sdkn = sdkn; p.sdkh = sdkh;
  p.sdvb = sdvb; p.sdvn = sdvn; p.sdvh = sdvh;
  p.scale = scale;
  p.vec = vec;
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
