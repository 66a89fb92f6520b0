// The whole int8 ResBlock in one cooperative launch, for Hopper (sm_90a).
//
// Replaces: vdtpu/ops/pallas/qconv.py::_resblock_kernel (row 11 of the
// kernel table, reached through resblock_flat; vdtpu runs it under
// VDTPU_QCONV=fused2, vdtpu/models/blocks.py::_fused_flat(whole=True)).
//
// Function, per sample b (groups of C / G channels, G = 32):
//   q1  = clip(rint(SiLU(GN1(x)) / sx1), -127, 127)   (divide, half to even)
//   mid = T(conv3(q1, w1) * (sx1 * sw1[n]) + b1[n] + film[b, n])
//   q2  = clip(rint(SiLU(GN2(mid)) / sx2), -127, 127)
//   out = T(conv3(q2, w2) * (sx2 * sw2[n]) + b2[n] + skip[b, n, y, x])
// with skip = x for an identity skip (C == N), conv3 the 3x3 padding-1
// stride-1 convolution in exact s32 (codes are 0 outside the image, never
// quantize(GN(0))), GN statistics E[v^2] - E[v]^2 in f32 with the variance
// clipped at 0, and T the output dtype (bf16 or f32), in which the mid is
// rounded where vdtpu's mid scratch rounds it.
//
// Bound on this card: the two convolutions' int8 products,
// 2 * B * H * W * 9 * (C * N + N * N) operations at 1,979 TOP/s: at
// [4, 320, 64, 64] -> 320, 60.4 G, 0.0305 ms; at 960 -> 320, 0.0611 ms. The
// bytes (x, skip, out, weights) take less (about 56 MB, 0.017 ms, at
// 960 -> 320). The tensor cores set the pace.
//
// Design. The TPU kernel holds one sample's mid in VMEM; on the H100 the mid
// of a 64^2 x 320 sample (2.6 MB) is far above one SM's shared memory, and
// GN2 needs the statistics of the whole mid before conv2 can start. So the
// kernel is one cooperative launch (every block resident; grid = blocks per
// SM x SMs), its phases grid-stride loops separated by grid barriers:
//   1. GN1 partial sums of x: items (b, g, 256-pixel chunk), one block each,
//      a fixed-order block reduction, one slot per item;
//   2. each (b, g) sums its slots in order -> (mean, rstd);
//   3. GN1 + SiLU + quantize of x into an s8 channels-last scratch
//      [B, H*W, C], 64 x 64 tiles transposed through shared memory;
//   4. conv1: the implicit GEMM of qconv_tile.cuh (mma.sync m16n8k32 s8,
//      128 x 64 tiles of one sample, K tiles double-buffered by cp.async);
//      the epilogue writes the rounded mid channels-last [B, H*W, N];
//   5. GN2 partial sums of the mid, 6. its (mean, rstd);
//   7. GN2 + SiLU + quantize of the mid into the same s8 scratch (x's codes
//      are dead by then);
//   8. conv2 with the bias and skip epilogue, into out.
// The GN2 statistics are a pass over the mid (10.5 MB at the widest site,
// mostly in the 50 MB L2) rather than partial sums in conv1's epilogue: one
// statistics routine for both GroupNorms, and a conv epilogue that only
// rounds and stores. Every sum runs in a fixed order (no float atomics), so
// the result is deterministic. Data that other blocks wrote earlier in the
// launch (partials, statistics, the mid, the codes) is read through L2
// (ld.global.cg, or cp.async.cg), never from a block's own L1. Scratch
// (mid, s8, partials, statistics) comes from the wrapper. The launch is
// refused, never replaced, if the grid cannot be resident.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "qconv_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace vdq;

constexpr int kPChunk = 256;  // pixels per GN statistics item (ops/qconv.py)
constexpr int kQT = 64;       // pixels and channels per quantize tile
constexpr int kQLD = kQT + 4;

struct Params {
  const void* x;     // [B, C, H, W] logical, strides (sxb, sxp per pixel, sxc)
  const void* skip;  // [B, N, H, W] logical or null (identity: x)
  void* out;         // [B, N, H, W] logical
  const int8_t* w1;  // [N, 9, C]
  const float* sw1;
  const float* b1;
  const float* g1;   // GN1 affine [C]
  const float* be1;
  const float* sx1;
  const int8_t* w2;  // [N, 9, N]
  const float* sw2;
  const float* b2;
  const float* g2;   // GN2 affine [N]
  const float* be2;
  const float* sx2;
  const void* film;  // [B, N]
  void* mid;         // [B, H*W, N] of T
  int8_t* s8;        // [B, H*W, max(C, N)]
  float* part;       // [B * G * S * 2]
  float* stats;      // [2][B * G][2]
  int B, H, W, C, N, G;
  float eps;
  long long sxb, sxp, sxc, skb, skp, skc, sob, sop, soc, film_sb;
};

// Sum of (a, b) over the block in a fixed order; every thread gets it.
// Loads of data written earlier in this launch by other blocks: through L2.
__device__ __forceinline__ float ld_l2(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_l2(const __nv_bfloat16* p) {
  return __bfloat162float(__ldcg(p));
}
__device__ __forceinline__ int ld_l2(const int8_t* p) {
  return __ldcg(reinterpret_cast<const signed char*>(p));
}

__device__ __forceinline__ float2 block_sum2(float a, float b, float2* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  __syncthreads();  // red is free: every thread read the previous sum
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = make_float2(a, b);
  __syncthreads();
  float2 r = make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) {
    r.x += red[i].x;
    r.y += red[i].y;
  }
  return r;
}

// Phases 1 and 5: GN partial sums of v[b, c, p] (strides sb, sc, sp).
template <typename T>
__device__ void gn_partials(const T* v, long long sb, long long sp, long long sc, int B, int Cv,
                            int HW, int G, float* part, float2* red) {
  const int cpg = Cv / G;
  const int S = (HW + kPChunk - 1) / kPChunk;
  const int items = B * G * S;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int s = it % S, bg = it / S;
    const int g = bg % G, b = bg / G;
    const int p0 = s * kPChunk;
    const int np = min(kPChunk, HW - p0);
    const T* base = v + b * sb + (long long)g * cpg * sc + (long long)p0 * sp;
    float a = 0.f, q = 0.f;
    for (int i = threadIdx.x; i < np * cpg; i += kThreads) {
      int p, c;
      if (sp == 1) {  // pixels contiguous (NCHW): neighbouring threads, neighbouring pixels
        c = i / np;
        p = i - c * np;
      } else {
        p = i / cpg;
        c = i - p * cpg;
      }
      const float x = ld_l2(base + p * sp + c * sc);
      a += x;
      q += x * x;
    }
    const float2 r = block_sum2(a, q, red);
    if (threadIdx.x == 0) {
      part[2 * it] = r.x;
      part[2 * it + 1] = r.y;
    }
  }
}

// Phases 2 and 6: (mean, rstd) of each (b, g) from its S slots, in order.
__device__ void gn_finalize(const float* part, int BG, int S, float count, float eps,
                            float* stats) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < BG; i += gridDim.x * kThreads) {
    float a = 0.f, q = 0.f;
    for (int s = 0; s < S; ++s) {
      a = __fadd_rn(a, ld_l2(part + 2 * (i * S + s)));
      q = __fadd_rn(q, ld_l2(part + 2 * (i * S + s) + 1));
    }
    const float mean = __fdiv_rn(a, count);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(q, count), __fmul_rn(mean, mean)), 0.f);
    stats[2 * i] = mean;
    stats[2 * i + 1] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  }
}

// Phases 3 and 7: GN + SiLU + static-scale quantize of v into s8 [B, HW, Cv].
// chan: shared [4][kQT] floats for the tile's channels (mean, rstd, gamma, beta).
template <typename T>
__device__ void gn_quantize(const T* v, long long sb, long long sp, long long sc, int B, int Cv,
                            int HW, int G, const float* stats, const float* gamma,
                            const float* beta, float sx, int8_t* s8, int8_t* tile,
                            float (*chan)[kQT]) {
  const int cpg = Cv / G;
  const int npt = (HW + kQT - 1) / kQT, nct = (Cv + kQT - 1) / kQT;
  const int items = B * npt * nct;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int ct = it % nct, rest = it / nct;
    const int pt = rest % npt, b = rest / npt;
    const int p0 = pt * kQT, c0 = ct * kQT;
    __syncthreads();  // the previous tile's stores have read `tile` and `chan`
    if (threadIdx.x < kQT && c0 + threadIdx.x < Cv) {
      const int c = c0 + threadIdx.x;
      const float* st = stats + 2 * (b * G + c / cpg);
      chan[0][threadIdx.x] = ld_l2(st);
      chan[1][threadIdx.x] = ld_l2(st + 1);
      chan[2][threadIdx.x] = gamma[c];
      chan[3][threadIdx.x] = beta[c];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kQT * kQT; i += kThreads) {
      int pl, cl;
      if (sp == 1) {
        cl = i / kQT;
        pl = i - cl * kQT;
      } else {
        pl = i / kQT;
        cl = i - pl * kQT;
      }
      const int p = p0 + pl, c = c0 + cl;
      int q = 0;
      if (p < HW && c < Cv) {
        float y = __fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(ld_l2(v + b * sb + p * sp + c * sc), chan[0][cl]),
                                chan[1][cl]),
                      chan[2][cl]),
            chan[3][cl]);
        y = __fmul_rn(y, __frcp_rn(__fadd_rn(1.f, expf(-y))));
        q = int(fminf(fmaxf(rintf(__fdiv_rn(y, sx)), -127.f), 127.f));
      }
      tile[pl * kQLD + cl] = int8_t(q);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kQT * kQT; i += kThreads) {
      const int pl = i / kQT, cl = i - (i / kQT) * kQT;
      const int p = p0 + pl, c = c0 + cl;
      if (p < HW && c < Cv) s8[((long long)b * HW + p) * Cv + c] = tile[pl * kQLD + cl];
    }
  }
}

// Stage the A tile: output pixels [m0, m0 + 128) of sample b x K [k0, k0 + 64)
// of the s8 codes [B, HW, Cin] (K = tap x Cin; zero outside the image).
__device__ __forceinline__ void load_a(const int8_t* s8, int b, int H, int W, int Cin, bool vec,
                                       int8_t* sA, int m0, int k0) {
  const int HW = H * W;
  const int8_t* xb = s8 + (long long)b * HW * Cin;
  if (vec) {  // Cin % 64 == 0: the K tile is one tap, 64 contiguous channels a row
    const int tap = k0 / Cin;
    const int c0 = k0 - tap * Cin;
    const int dy = tap / 3, dx = tap - 3 * (tap / 3);
    for (int idx = threadIdx.x; idx < kBM * 4; idx += kThreads) {
      const int r = idx >> 2, ch = idx & 3;
      const int m = m0 + r;
      const int y = m / W, x = m - (m / W) * W;
      const int yi = y + dy - 1, xi = x + dx - 1;
      const bool inb = m < HW && yi >= 0 && yi < H && xi >= 0 && xi < W;
      const int8_t* src = inb ? xb + ((long long)yi * W + xi) * Cin + c0 + ch * 16 : xb;
      cp_async16(sA + r * kLD + ch * 16, src, inb ? 16 : 0);
    }
    return;
  }
  const int K = 9 * Cin;
  const int r = threadIdx.x % kBM, half = threadIdx.x / kBM;
  const int m = m0 + r;
  const int y = m / W, x = m - (m / W) * W;
  uint32_t* dst = reinterpret_cast<uint32_t*>(sA + r * kLD + half * 32);
  for (int w4 = 0; w4 < 8; ++w4) {
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + half * 32 + w4 * 4 + e;
      int q = 0;
      if (m < HW && k < K) {
        const int tap = k / Cin, c = k - (k / Cin) * Cin;
        const int yi = y + tap / 3 - 1, xi = x + tap % 3 - 1;
        if (yi >= 0 && yi < H && xi >= 0 && xi < W)
          q = ld_l2(xb + ((long long)yi * W + xi) * Cin + c);
      }
      word |= (uint32_t(q) & 0xffu) << (8 * e);
    }
    dst[w4] = word;
  }
}

// Phases 4 and 8: the 3x3 conv of the s8 scratch and its epilogue.
template <typename T, bool SECOND>
__device__ void conv_phase(const Params& p, int Cin, int8_t (*sA)[kBM * kLD],
                           int8_t (*sB)[kBN * kLD]) {
  const int HW = p.H * p.W;
  const int8_t* w = SECOND ? p.w2 : p.w1;
  const float* sw = SECOND ? p.sw2 : p.sw1;
  const float* bias = SECOND ? p.b2 : p.b1;
  const float sx = SECOND ? *p.sx2 : *p.sx1;
  const int K = 9 * Cin;
  const bool vec = Cin % kBK == 0;
  const int nkt = (K + kBK - 1) / kBK;
  const int mtiles = (HW + kBM - 1) / kBM, ntiles = (p.N + kBN - 1) / kBN;
  const int items = p.B * mtiles * ntiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 4, wn = warp / 4;
  const int g = lane >> 2, t = lane & 3;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int nt_ = it % ntiles, rest = it / ntiles;
    const int mt_ = rest % mtiles, b = rest / mtiles;
    const int m0 = mt_ * kBM, n0 = nt_ * kBN;
    int acc[2][4][4];
    zero_acc(acc);
    __syncthreads();  // shared memory is free (previous tile or phase)
    load_a(p.s8, b, p.H, p.W, Cin, vec, sA[0], m0, 0);
    load_b(w, p.N, K, vec, sB[0], n0, 0);
    cp_async_commit();
    for (int kt = 0; kt < nkt; ++kt) {
      const int cur = kt & 1;
      cp_async_wait_all();
      __syncthreads();
      if (kt + 1 < nkt) {  // the other buffer was last read before the barrier
        load_a(p.s8, b, p.H, p.W, Cin, vec, sA[cur ^ 1], m0, (kt + 1) * kBK);
        load_b(w, p.N, K, vec, sB[cur ^ 1], n0, (kt + 1) * kBK);
        cp_async_commit();
      }
      mma_k_tile(sA[cur], sB[cur], acc);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = m0 + wm * 32 + mt * 16 + g + 8 * hr;
        if (m >= HW) continue;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + wn * 32 + nt * 8 + 2 * t + e;
            if (n >= p.N) continue;
            float y = __fadd_rn(__fmul_rn(float(acc[mt][nt][2 * hr + e]),
                                          __fmul_rn(sx, sw[n])), bias[n]);
            if (!SECOND) {
              y = __fadd_rn(y, to_f(static_cast<const T*>(p.film)[b * p.film_sb + n]));
              static_cast<T*>(p.mid)[((long long)b * HW + m) * p.N + n] = from_f<T>(y);
            } else {
              const T* sk = static_cast<const T*>(p.skip ? p.skip : p.x);
              y = __fadd_rn(y, to_f(sk[b * p.skb + m * p.skp + n * p.skc]));
              static_cast<T*>(p.out)[b * p.sob + m * p.sop + n * p.soc] = from_f<T>(y);
            }
          }
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 3) resblock_kernel(const Params p) {
  __shared__ __align__(16) int8_t sA[2][kBM * kLD];
  __shared__ __align__(16) int8_t sB[2][kBN * kLD];
  __shared__ float2 red[kThreads / 32];
  __shared__ float chan[4][kQT];
  cg::grid_group grid = cg::this_grid();
  const int HW = p.H * p.W, BG = p.B * p.G;
  const int S = (HW + kPChunk - 1) / kPChunk;
  float* st1 = p.stats;
  float* st2 = p.stats + 2 * BG;
  const T* x = static_cast<const T*>(p.x);
  const T* mid = static_cast<const T*>(p.mid);

  gn_partials<T>(x, p.sxb, p.sxp, p.sxc, p.B, p.C, HW, p.G, p.part, red);
  grid.sync();
  gn_finalize(p.part, BG, S, float(HW) * float(p.C / p.G), p.eps, st1);
  grid.sync();
  gn_quantize<T>(x, p.sxb, p.sxp, p.sxc, p.B, p.C, HW, p.G, st1, p.g1, p.be1, *p.sx1, p.s8,
                 sA[0], chan);
  grid.sync();
  conv_phase<T, false>(p, p.C, sA, sB);
  grid.sync();
  gn_partials<T>(mid, (long long)HW * p.N, p.N, 1, p.B, p.N, HW, p.G, p.part, red);
  grid.sync();
  gn_finalize(p.part, BG, S, float(HW) * float(p.N / p.G), p.eps, st2);
  grid.sync();
  gn_quantize<T>(mid, (long long)HW * p.N, p.N, 1, p.B, p.N, HW, p.G, st2, p.g2, p.be2, *p.sx2,
                 p.s8, sA[0], chan);
  grid.sync();
  conv_phase<T, true>(p, p.N, sA, sB);
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  static int grid_size[64];  // per device: blocks per SM x SMs, found once
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  if (dev >= 64) return int(cudaErrorInvalidDevice);
  if (grid_size[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return int(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, resblock_kernel<T>, kThreads, 0);
    if (e != cudaSuccess) return int(e);
    if (per_sm < 1) return int(cudaErrorCooperativeLaunchTooLarge);
    grid_size[dev] = per_sm * sms;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(grid_size[dev]));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, resblock_kernel<T>, p);
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 bf16, 1 f32 (x, skip, film, mid and out share it). Returns a
// cudaError_t code; 0 means the launch was accepted.
extern "C" int vd_resblock_q(const void* x, const void* skip, void* out, const void* w1,
                             const void* sw1, const void* b1, const void* g1, const void* be1,
                             const void* sx1, const void* w2, const void* sw2, const void* b2,
                             const void* g2, const void* be2, const void* sx2, const void* film,
                             void* mid, void* s8, void* part, void* stats, int B, int H, int W,
                             int C, int N, int G, float eps, long long sxb, long long sxp,
                             long long sxc, long long skb, long long skp, long long skc,
                             long long sob, long long sop, long long soc, long long film_sb,
                             int dtype, void* stream) {
  Params p;
  p.x = x;
  p.skip = skip;
  p.out = out;
  p.w1 = static_cast<const int8_t*>(w1);
  p.sw1 = static_cast<const float*>(sw1);
  p.b1 = static_cast<const float*>(b1);
  p.g1 = static_cast<const float*>(g1);
  p.be1 = static_cast<const float*>(be1);
  p.sx1 = static_cast<const float*>(sx1);
  p.w2 = static_cast<const int8_t*>(w2);
  p.sw2 = static_cast<const float*>(sw2);
  p.b2 = static_cast<const float*>(b2);
  p.g2 = static_cast<const float*>(g2);
  p.be2 = static_cast<const float*>(be2);
  p.sx2 = static_cast<const float*>(sx2);
  p.film = film;
  p.mid = mid;
  p.s8 = static_cast<int8_t*>(s8);
  p.part = static_cast<float*>(part);
  p.stats = static_cast<float*>(stats);
  p.B = B; p.H = H; p.W = W; p.C = C; p.N = N; p.G = G;
  p.eps = eps;
  p.sxb = sxb; p.sxp = sxp; p.sxc = sxc;
  p.skb = skip ? skb : sxb; p.skp = skip ? skp : sxp; p.skc = skip ? skc : sxc;
  p.sob = sob; p.sop = sop; p.soc = soc;
  p.film_sb = film_sb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<__nv_bfloat16>(p, st);
  if (dtype == 1) return launch<float>(p, st);
  return int(cudaErrorInvalidValue);
}
