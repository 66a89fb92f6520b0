// int8 3x3 convolution (padding 1, stride 1 or 2) for Hopper (sm_90a), with
// an optional fused GroupNorm(+SiLU)+quantize prologue.
//
// Replaces: vdtpu/ops/pallas/qconv.py::_kernel (row 10 of the kernel table,
// reached through qconv3_flat: _gn_quant_slab, then _conv_taps, then the
// dequant epilogue), and the s8 x s8 -> s32 lax.conv_general_dilated that
// vdtpu/ops/quant.py::QConv runs at every int8 conv site.
//
// Function: out[b, y, x, n] = T(acc * (s_x * s_w[n]) + bias[n]
//                               + film[b, n] + res[b, y, x, n]),
// acc = sum over the 9 taps and C input channels of q[b, y', x', c] *
// w[n, tap, c] in exact s32, q = 0 outside the image. The input q is either
//   in_kind 0: s8 codes already (the per-site path), or
//   in_kind 1: the compute-dtype activation x with per-(b, c) GroupNorm
//     statistics (mean, rstd), to which the prologue applies
//     y = (x - mean) * rstd * gamma + beta, SiLU, and the static-scale
//     quantize q = clip(rint(y / s_x), -127, 127) (division, round half to
//     even, as vdtpu/ops/quant.py::_quantize_act) while staging a tile;
//     padding stays 0 after quantization, never quantize(GN(0)).
// Any C and N: K = 9 * C is padded to the MMA depth in shared memory only.
// Every tensor is addressed through strides, so NCHW and NHWC (the flat
// [B, H*W, C] layout of the TPU kernel) both work.
//
// Bound on this card: at [4, 320, 64, 64] -> 320 the work is
// 2 * 4 * 4096 * 320 * 320 * 9 = 30.2 G int8 operations, about 0.015 ms at
// 1,979 TOP/s; the 960 -> 320 decoder sites 0.046 ms. The bytes (s8 input
// once, weights once, bf16 output once) take less: 5.2 + 0.9 + 10.5 MB,
// 0.005 ms. The tensor cores set the pace.
//
// What the design does about it: an implicit GEMM (M = output pixels, N =
// output channels, K = tap x C) on mma.sync m16n8k32 s8 x s8 -> s32, 128 x
// 64 output tiles over 8 warps (the tile of qconv_tile.cuh), 64-deep K
// tiles double-buffered in shared memory with cp.async when C % 64 == 0
// (each K tile is then one tap: a row of 64 contiguous channels, i.e. the
// one-row halo of the tap read straight from device memory), element-wise
// staging otherwise. The im2col matrix never exists in device memory.
// mma.sync reaches a fraction of the int8 peak; wgmma/TMA and a persistent
// schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "qconv_tile.cuh"

namespace {

using namespace vdq;

struct Params {
  const void* x;
  const int8_t* w;       // [N, 9, C]
  const float* w_scale;  // [N]
  const float* bias;     // [N]
  const float* s_x;      // scalar
  const float* stats;    // [B, 2, C] (mean, rstd), in_kind 1
  const float* gamma;    // [C]
  const float* beta;     // [C]
  const void* film;      // [B, N] or null
  const void* res;       // or null
  void* out;
  int B, H, W, C, N, stride, Ho, Wo, with_silu;
  int vec_a;  // s8 input, C % 64 == 0, channels contiguous, 16-byte rows
  int vec_b;  // C % 64 == 0 and a 16-byte aligned weight
  long long sxb, sxh, sxw, sxc;
  long long srb, srh, srw, src;
  long long sob, soh, sow, soc;
  long long film_sb;
};

// One output row m = (b, yo, xo) of the implicit GEMM.
struct Row {
  int b, y0, x0;  // input coordinates of tap (0, 0)
  bool ok;
};

__device__ __forceinline__ Row decode(const Params& p, int m) {
  Row r;
  const int hw = p.Ho * p.Wo;
  r.ok = m < p.B * hw;
  const int mm = r.ok ? m : 0;
  r.b = mm / hw;
  const int rem = mm - r.b * hw;
  const int yo = rem / p.Wo;
  const int xo = rem - yo * p.Wo;
  r.y0 = yo * p.stride - 1;
  r.x0 = xo * p.stride - 1;
  return r;
}

// GroupNorm(+SiLU) and quantize one element of the input (in_kind 1).
template <typename T>
__device__ __forceinline__ int gn_quant(const Params& p, float sx, int b, int c, T xv) {
  const float mean = p.stats[(long long)b * 2 * p.C + c];
  const float rstd = p.stats[(long long)b * 2 * p.C + p.C + c];
  float y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(to_f(xv), mean), rstd), p.gamma[c]),
                      p.beta[c]);
  if (p.with_silu) y = __fmul_rn(y, __frcp_rn(__fadd_rn(1.f, expf(-y))));
  const float q = fminf(fmaxf(rintf(__fdiv_rn(y, sx)), -127.f), 127.f);
  return int(q);
}

// Stage A tile rows [m0, m0 + 128) x K [k0, k0 + 64) into shared memory.
template <typename T, int IN_KIND>
__device__ __forceinline__ void load_a(const Params& p, int8_t* sA, int m0, int k0, float sx) {
  const int K = 9 * p.C;
  if (IN_KIND == 0 && p.vec_a) {
    // C % 64 == 0: the tile is one tap; each row is 64 contiguous channels
    const int tap = k0 / p.C;
    const int c0 = k0 - tap * p.C;
    const int dy = tap / 3, dx = tap - 3 * (tap / 3);
    const int8_t* x = static_cast<const int8_t*>(p.x);
    for (int idx = threadIdx.x; idx < kBM * 4; idx += kThreads) {
      const int r = idx >> 2, ch = idx & 3;
      const Row row = decode(p, m0 + r);
      const int yi = row.y0 + dy, xi = row.x0 + dx;
      const bool inb = row.ok && yi >= 0 && yi < p.H && xi >= 0 && xi < p.W;
      const int8_t* src =
          inb ? x + row.b * p.sxb + yi * p.sxh + xi * p.sxw + c0 + ch * 16 : x;
      cp_async16(sA + r * kLD + ch * 16, src, inb ? 16 : 0);
    }
    return;
  }
  // element-wise: thread -> (row, 32-wide half of the K tile); consecutive
  // threads take consecutive rows, i.e. neighbouring pixels of one channel
  const int r = threadIdx.x % kBM;
  const int half = threadIdx.x / kBM;
  const Row row = decode(p, m0 + r);
  uint32_t* dst = reinterpret_cast<uint32_t*>(sA + r * kLD + half * 32);
  const bool one_tap = p.C % kBK == 0;  // the whole tile lies in one tap
  const int tap0 = k0 / p.C;
  const int yi0 = row.y0 + tap0 / 3, xi0 = row.x0 + tap0 % 3;
  const bool inb0 = row.ok && yi0 >= 0 && yi0 < p.H && xi0 >= 0 && xi0 < p.W;
  const long long base0 = inb0 ? row.b * p.sxb + yi0 * p.sxh + xi0 * p.sxw : 0;
  const int c00 = k0 - tap0 * p.C + half * 32;
  for (int w4 = 0; w4 < 8; ++w4) {
    uint32_t word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int c = c00 + w4 * 4 + e;
      bool inb = inb0;
      long long base = base0;
      if (!one_tap) {
        const int k = k0 + half * 32 + w4 * 4 + e;
        const int tap = k / p.C;
        c = k - tap * p.C;
        const int yi = row.y0 + tap / 3, xi = row.x0 + tap % 3;
        inb = row.ok && k < K && yi >= 0 && yi < p.H && xi >= 0 && xi < p.W;
        base = inb ? row.b * p.sxb + yi * p.sxh + xi * p.sxw : 0;
      }
      int q = 0;
      if (inb) {
        const long long off = base + c * p.sxc;
        if (IN_KIND == 0) {
          q = static_cast<const int8_t*>(p.x)[off];
        } else {
          q = gn_quant<T>(p, sx, row.b, c, static_cast<const T*>(p.x)[off]);
        }
      }
      word |= (uint32_t(q) & 0xffu) << (8 * e);
    }
    dst[w4] = word;
  }
}

template <typename T, int IN_KIND>
__global__ void __launch_bounds__(kThreads) qconv3_kernel(const Params p) {
  __shared__ __align__(16) int8_t sA[2][kBM * kLD];
  __shared__ __align__(16) int8_t sB[2][kBN * kLD];

  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 4, wn = warp / 4;  // warp tile: 32 rows x 32 channels
  const int g = lane >> 2, t = lane & 3;
  const float sx = *p.s_x;
  const bool async = p.vec_a || p.vec_b;

  int acc[2][4][4];
  zero_acc(acc);

  const int K = 9 * p.C;
  const int nkt = (K + kBK - 1) / kBK;
  load_a<T, IN_KIND>(p, sA[0], m0, 0, sx);
  load_b(p.w, p.N, K, p.vec_b, sB[0], n0, 0);
  if (async) cp_async_commit();
  for (int kt = 0; kt < nkt; ++kt) {
    const int cur = kt & 1;
    if (async) cp_async_wait_all();
    __syncthreads();
    if (kt + 1 < nkt) {  // the other buffer was last read before the barrier
      load_a<T, IN_KIND>(p, sA[cur ^ 1], m0, (kt + 1) * kBK, sx);
      load_b(p.w, p.N, K, p.vec_b, sB[cur ^ 1], n0, (kt + 1) * kBK);
      if (async) cp_async_commit();
    }
    mma_k_tile(sA[cur], sB[cur], acc);
  }

  // epilogue: acc * (s_x * s_w[n]) + bias[n] (+ film[b, n]) (+ res), in f32
  const T* film = static_cast<const T*>(p.film);
  const T* res = static_cast<const T*>(p.res);
  T* out = static_cast<T*>(p.out);
  const int hw = p.Ho * p.Wo;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = m0 + wm * 32 + mt * 16 + g + 8 * hr;
      if (m >= p.B * hw) continue;
      const int b = m / hw;
      const int rem = m - b * hw;
      const int yo = rem / p.Wo, xo = rem - (rem / p.Wo) * p.Wo;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 32 + nt * 8 + 2 * t + e;
          if (n >= p.N) continue;
          float y = __fadd_rn(__fmul_rn(float(acc[mt][nt][2 * hr + e]),
                                        __fmul_rn(sx, p.w_scale[n])), p.bias[n]);
          if (film) y = __fadd_rn(y, to_f(film[b * p.film_sb + n]));
          if (res) y = __fadd_rn(y, to_f(res[b * p.srb + yo * p.srh + xo * p.srw + n * p.src]));
          out[b * p.sob + yo * p.soh + xo * p.sow + n * p.soc] = from_f<T>(y);
        }
    }
}

template <typename T, int IN_KIND>
int launch(const Params& p, cudaStream_t stream) {
  const long long m = (long long)p.B * p.Ho * p.Wo;
  const dim3 grid(unsigned((m + kBM - 1) / kBM), unsigned((p.N + kBN - 1) / kBN));
  qconv3_kernel<T, IN_KIND><<<grid, kThreads, 0, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

// in_kind: 0 s8 input codes, 1 GroupNorm prologue on an input of the output
// dtype; out_kind: 0 bf16, 1 f32 (film and res share the output dtype).
// Returns a cudaError_t code; 0 means the launch was accepted.
extern "C" int vd_qconv3(const void* x, const void* w, const void* w_scale, const void* bias,
                         const void* s_x, const void* stats, const void* gamma, const void* beta,
                         const void* film, const void* res, void* out, int B, int H, int W, int C,
                         int N, int stride, int with_silu, int vec_a, int vec_b, long long sxb, long long sxh,
                         long long sxw, long long sxc, long long srb, long long srh,
                         long long srw, long long src, long long sob, long long soh,
                         long long sow, long long soc, long long film_sb, int in_kind,
                         int out_kind, void* stream) {
  Params p;
  p.x = x;
  p.w = static_cast<const int8_t*>(w);
  p.w_scale = static_cast<const float*>(w_scale);
  p.bias = static_cast<const float*>(bias);
  p.s_x = static_cast<const float*>(s_x);
  p.stats = static_cast<const float*>(stats);
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.film = film;
  p.res = res;
  p.out = out;
  p.B = B; p.H = H; p.W = W; p.C = C; p.N = N; p.stride = stride;
  p.Ho = (H - 1) / stride + 1;
  p.Wo = (W - 1) / stride + 1;
  p.with_silu = with_silu;
  p.vec_a = vec_a;
  p.vec_b = vec_b;
  p.sxb = sxb; p.sxh = sxh; p.sxw = sxw; p.sxc = sxc;
  p.srb = srb; p.srh = srh; p.srw = srw; p.src = src;
  p.sob = sob; p.soh = soh; p.sow = sow; p.soc = soc;
  p.film_sb = film_sb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_kind == 0 && out_kind == 0) return launch<__nv_bfloat16, 0>(p, st);
  if (in_kind == 0 && out_kind == 1) return launch<float, 0>(p, st);
  if (in_kind == 1 && out_kind == 0) return launch<__nv_bfloat16, 1>(p, st);
  if (in_kind == 1 && out_kind == 1) return launch<float, 1>(p, st);
  return int(cudaErrorInvalidValue);
}
