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
// What paced the first version (PR 4, 0.4713 ms at 64^2 320 -> 320): both
// convs ran the general implicit GEMM of qconv_tile.cuh (mma.sync, the A
// tile gathered from L2 again for every tap, K tiles double-buffered),
// 0.16 ms a conv; eight phases behind seven grid barriers (the GN2
// statistics a pass of their own over the mid, each GroupNorm a separate
// finalize phase); and 640 conv tiles on 396 resident blocks, the second
// wave 60% empty.
//
// Design. The mid of a 64^2 x 320 sample (2.6 MB) is far above one SM's
// shared memory, and GN2 needs the statistics of the whole mid before conv2
// can start, so the kernel stays one cooperative launch (every block
// resident; grid = blocks per SM x SMs), each phase a loop of the
// persistent blocks over its work items, phases separated by grid barriers:
//   1. GN1 partial sums of x: one item and one slot per (b, g), a
//      fixed-order block reduction;
//   2. GN1 + SiLU + quantize of x into an s8 channels-last scratch
//      [B, H*W, C], 64-channel x 128-pixel tiles transposed through shared
//      memory, each block a contiguous run of tiles, the next tile's loads
//      in flight while one is stored; where a run enters another
//      (sample, channel tile) it sums the slots of the groups it touches,
//      in order (the GN finalize, with no phase of its own);
//   3. conv1 on the halo main loop of row 10 (qconv_sm90.cuh::halo_tile_s8:
//      the input halo of a tile of whole output rows staged once per
//      channel chunk, the nine taps as ldmatrix address shifts, wgmma
//      m64nNk32 s8 with A from registers, weights through a 4-stage ring).
//      The epilogue stages the tile, rounded to T, in shared memory, writes
//      the mid channels-last [B, H*W, N] 16 bytes a thread, and sums each
//      GroupNorm group of the tile (the plan keeps every group inside one
//      N tile) into its own slot: the GN2 statistics without a pass over
//      the mid;
//   4. GN2 + SiLU + quantize of the mid into the same s8 scratch (x's codes
//      are dead by then), the statistics summed from conv1's slots in order,
//      each thread the same 8 channels of every few pixels;
//   5. conv2 on the same main loop, with row 10's epilogue (bias and skip)
//      in passes of 80 (or BN) channels.
// Four grid barriers. The phases other than the convs are calls (noinline,
// reading the parameters in place: __grid_constant__), so their registers
// do not crowd the conv main loop's 80 accumulators a thread (with them
// inlined, ptxas spilled inside the BN = 160 loop). The tile geometry
// comes from vdtpu_torch/ops/qconv.py::resblock_plan (rows, 128- or
// 256-pixel tiles, 160, 80 or 64 output channels a tile holding whole
// GroupNorm groups, chosen so the conv tiles fill a wave of the grid at
// the UNet's sites), which the launch checks against its own derivation
// and refuses on a mismatch. A shape the halo loop does not take (C or N
// % 32 != 0, no such N tile, W > 256, shared memory) runs the general
// route in the same launch: the mma.sync implicit GEMM of qconv_tile.cuh
// for both convs and a statistics pass over the mid (five barriers).
// Measured against the first version (PERF.md row 11): 0.4713 -> 0.1865 ms
// at [4, 320, 64, 64] -> 320, still 1.19x the port's per-site int8 chain
// there (the conv phases trail row 10's own kernel); under that chain at
// the 32^2 sites.
// Every sum runs in a fixed order (no float atomics), so the result is
// deterministic. Data that other blocks wrote earlier in the launch
// (partials, the mid, the codes) is read through L2 (ld.global.cg or
// cp.async.cg), never from a block's own L1. Scratch comes from the
// wrapper. The launch is refused, never replaced, if the grid cannot be
// resident. Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3.

#include <algorithm>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "qconv_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace vdq;

constexpr int kQC = 64;        // channels a quantize tile of x
constexpr int kQP = 128;       // pixels a quantize tile of x
constexpr int kQLD = kQC + 4;  // bytes per staged pixel of a quantize tile
constexpr int kMidPix = 64;    // pixels a step of the mid's quantize
constexpr int kMaxGroups = 64;
// the non-conv phases' shared memory, from the start of the dynamic region
// (each phase is a call: taken there, its accesses stay shared-memory ones)
constexpr int kTileBytes = kQP * kQLD;                  // quantize_x's tile
constexpr int kChanOff = kTileBytes;                    // quantize_x's chan[4][kQC]
constexpr int kGstOff = kChanOff + 4 * kQC * 4;         // gst[kMaxGroups] (float2)
constexpr int kRedOff = kGstOff + kMaxGroups * 8;       // red[16] (float2)
constexpr int kPhaseSmem = kRedOff + 16 * 8;
constexpr int kHalo = 1, kGeneral = 0;  // routes

struct Params {
  QConvParams c1, c2;  // the convs: s8 input, weights, epilogue operands, halo geometry
  const void* x;       // [B, C, H, W] logical, strides (sxb, sxp per pixel, sxc)
  const float* g1;     // GN1 affine [C]
  const float* be1;
  const float* g2;     // GN2 affine [N]
  const float* be2;
  void* mid;           // [B, H*W, N] of T
  int8_t* s8;          // [B, H*W, max(C, N)]
  float* part1;        // [B * G][2]: one slot a group
  float* part2;        // [B * G][S2][2]
  int B, H, W, C, N, G, S2, route;
  float eps;
  long long sxb, sxp, sxc;
};

// Loads of data written earlier in this launch by other blocks: through L2.
__device__ __forceinline__ float ld_l2(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_l2(const __nv_bfloat16* p) {
  return __bfloat162float(__ldcg(p));
}

// Sum of (a, b) over the block's NT threads in a fixed order; every thread
// gets it.
template <int NT>
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, o));
    b = __fadd_rn(b, __shfl_xor_sync(0xffffffffu, b, o));
  }
  __syncthreads();  // red is free: every thread read the previous sum
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = make_float2(a, b);
  __syncthreads();
  float2 r = make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) {
    r.x = __fadd_rn(r.x, red[i].x);
    r.y = __fadd_rn(r.y, red[i].y);
  }
  return r;
}

// (mean, rstd) of group bg from its S slots, summed in order
__device__ __forceinline__ float2 group_stats(const float* part, int bg, int S, float count,
                                              float eps) {
  float a = 0.f, q = 0.f;
  const float2* slot = reinterpret_cast<const float2*>(part) + (long long)bg * S;
#pragma unroll 4
  for (int s = 0; s < S; ++s) {
    const float2 v = __ldcg(slot + s);
    a = __fadd_rn(a, v.x);
    q = __fadd_rn(q, v.y);
  }
  const float mean = __fdiv_rn(a, count);
  const float var = fmaxf(__fsub_rn(__fdiv_rn(q, count), __fmul_rn(mean, mean)), 0.f);
  return make_float2(mean, __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps))));
}

// GN partial sums of v[b, c, p] (strides sb, sp, sc): one item, and one
// slot, per (sample, group), a fixed-order block reduction. 16-byte loads,
// eight in flight a thread, where a channel's pixels are contiguous and
// aligned.
template <typename T, int NT>
__device__ __noinline__ void gn_partials(const T* v, long long sb, long long sp, long long sc,
                                         int B, int Cv, int HW, int G, float* part) {
  extern __shared__ __align__(128) int8_t smem[];
  float2* red = reinterpret_cast<float2*>(smem + kRedOff);
  constexpr int E = 16 / sizeof(T), U = 8;
  const int cpg = Cv / G;
  const bool vec = sp == 1 && HW % E == 0 && sb % E == 0 && sc % E == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  for (int bg = blockIdx.x; bg < B * G; bg += gridDim.x) {
    const int g = bg % G, b = bg / G;
    const T* base = v + b * sb + (long long)g * cpg * sc;
    float a = 0.f, q = 0.f;
    if (vec) {
      const int units = HW / E, n = units * cpg;
      for (int i0 = threadIdx.x; i0 < n; i0 += U * NT) {
        uint4 raw[U];
#pragma unroll
        for (int k = 0; k < U; ++k) {
          const int i = i0 + k * NT;
          const int c = i / units, u = i - (i / units) * units;
          raw[k] = i < n ? __ldcg(reinterpret_cast<const uint4*>(base + c * sc + u * E))
                         : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int k = 0; k < U; ++k) {
          const T* e = reinterpret_cast<const T*>(&raw[k]);
#pragma unroll
          for (int j = 0; j < E; ++j) {
            const float x = to_f(e[j]);
            a = __fadd_rn(a, x);
            q = __fmaf_rn(x, x, q);
          }
        }
      }
    } else {
      for (int i = threadIdx.x; i < HW * cpg; i += NT) {
        int px, c;
        if (sp == 1) {  // neighbouring threads, neighbouring pixels
          c = i / HW;
          px = i - c * HW;
        } else {
          px = i / cpg;
          c = i - px * cpg;
        }
        const float x = ld_l2(base + px * sp + c * sc);
        a = __fadd_rn(a, x);
        q = __fmaf_rn(x, x, q);
      }
    }
    const float2 r = block_sum2<NT>(a, q, red);
    if (threadIdx.x == 0) reinterpret_cast<float2*>(part)[bg] = r;
  }
}

// Phase 2: GN1 + SiLU + quantize of x into s8 [B, HW, C], in tiles of one
// sample's 64 channels x 128 pixels, each block a contiguous run of them
// (pixel tiles fastest). Where a run enters another (sample, channel tile),
// the statistics of its groups come first, from their slots; each tile is
// coded into shared memory [pixel][channel] and stored 16 channels (bytes)
// of a pixel a thread. Where a channel's pixels are contiguous and aligned
// (NCHW), each thread loads 16 bytes of one channel's pixels at a time,
// the next tile's while this one is stored.
template <typename T, int NT>
__device__ __noinline__ void quantize_x(const Params& p) {
  extern __shared__ __align__(128) int8_t smem[];
  int8_t* tile = smem;
  float (*chan)[kQC] = reinterpret_cast<float (*)[kQC]>(smem + kChanOff);
  float2* gst = reinterpret_cast<float2*>(smem + kGstOff);
  constexpr int E = 16 / sizeof(T), UPC = kQP / E;  // pixels a load, loads a channel row
  constexpr int L = kQC * UPC / NT;                  // loads a thread a tile
  // the parameters this phase reads, once (through the reference the
  // compiler could not keep them across the stores below)
  const T* v = static_cast<const T*>(p.x);
  const int HW = p.H * p.W, C = p.C, G = p.G, cpg = C / G;
  const long long sxb = p.sxb, sxp = p.sxp, sxc = p.sxc;
  const float* part1 = p.part1;
  const float* g1 = p.g1;
  const float* be1 = p.be1;
  int8_t* s8 = p.s8;
  const float eps = p.eps;
  const int npt = (HW + kQP - 1) / kQP, nct = (C + kQC - 1) / kQC;
  const long long total = (long long)p.B * nct * npt;
  const int lo = int(total * blockIdx.x / gridDim.x);
  const int hi = int(total * (blockIdx.x + 1) / gridDim.x);
  const float sx = *p.c1.s_x, rs = rcp_scale(sx);
  const float count = float(HW) * float(cpg);
  const bool vec = sxp == 1 && HW % E == 0 && sxb % E == 0 && sxc % E == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const int tid = threadIdx.x;
  uint4 raw[L];
  auto fetch = [&](int t) {  // tile t's loads of this thread (zero past the edges)
    const int pt = t % npt, bc = t / npt;
    const int ct = bc % nct, b = bc / nct;
    const int c0 = ct * kQC, p0 = pt * kQP;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int i = tid + j * NT, cl = i / UPC, px = p0 + (i - cl * UPC) * E;
      raw[j] = c0 + cl < C && px < HW
                   ? *reinterpret_cast<const uint4*>(v + b * sxb + (c0 + cl) * sxc + px)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  if (vec && lo < hi) fetch(lo);
  int cur = -1;  // the (sample, channel tile) whose statistics are in chan
  for (int t = lo; t < hi; ++t) {
    const int pt = t % npt, bc = t / npt;
    const int ct = bc % nct, b = bc / nct;
    const int c0 = ct * kQC, nc = min(kQC, C - c0), p0 = pt * kQP;
    if (bc != cur) {
      const int g_lo = c0 / cpg, ng = (c0 + nc - 1) / cpg - g_lo + 1;
      __syncthreads();  // every read of gst and chan is done
      if (tid < ng) gst[tid] = group_stats(part1, b * G + g_lo + tid, 1, count, eps);
      __syncthreads();
      if (tid < nc) {
        const int c = c0 + tid;
        const float2 st = gst[c / cpg - g_lo];
        chan[0][tid] = st.x;
        chan[1][tid] = st.y;
        chan[2][tid] = g1[c];
        chan[3][tid] = be1[c];
      }
      cur = bc;
    }
    __syncthreads();  // chan is written; the previous tile's stores have read `tile`
    if (vec) {
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const int i = tid + j * NT, cl = i / UPC, u = i - cl * UPC;
        if (cl >= nc || p0 + u * E >= HW) continue;
        const T* e = reinterpret_cast<const T*>(&raw[j]);
        const float mean = chan[0][cl], rstd = chan[1][cl], gam = chan[2][cl], bet = chan[3][cl];
#pragma unroll
        for (int k = 0; k < E; ++k)
          tile[(u * E + k) * kQLD + cl] = int8_t(gn_code(to_f(e[k]), mean, rstd, gam, bet, sx, rs, 1));
      }
      if (t + 1 < hi) fetch(t + 1);
    } else {
      const T* xb = v + b * sxb;
      for (int i = tid; i < kQC * kQP; i += NT) {
        int pl, cl;
        if (sxp == 1) {
          cl = i / kQP;
          pl = i - cl * kQP;
        } else {
          pl = i / kQC;
          cl = i - pl * kQC;
        }
        const int px = p0 + pl;
        if (cl >= nc || px >= HW) continue;
        tile[pl * kQLD + cl] = int8_t(gn_code(to_f(xb[px * sxp + (c0 + cl) * sxc]),
                                              chan[0][cl], chan[1][cl], chan[2][cl],
                                              chan[3][cl], sx, rs, 1));
      }
    }
    __syncthreads();
    int8_t* dst = s8 + ((long long)b * HW + p0) * C + c0;
    if (C % 16 == 0) {
      for (int i = tid; i < kQP * (kQC / 16); i += NT) {
        const int pl = i / (kQC / 16), u = i - pl * (kQC / 16);
        if (p0 + pl >= HW || u * 16 >= nc) continue;
        const uint32_t* src = reinterpret_cast<const uint32_t*>(tile + pl * kQLD + u * 16);
        *reinterpret_cast<uint4*>(dst + (long long)pl * C + u * 16) =
            make_uint4(src[0], src[1], src[2], src[3]);
      }
    } else {
      for (int i = tid; i < kQP * kQC; i += NT) {
        const int pl = i / kQC, cl = i - pl * kQC;
        if (p0 + pl < HW && cl < nc) dst[(long long)pl * C + cl] = tile[pl * kQLD + cl];
      }
    }
  }
}

// Phase 4: GN2 + SiLU + quantize of the mid [B, HW, N] into s8 [B, HW, N],
// in steps of one sample's 64 pixels, each block a contiguous run of them.
// Where a run enters another sample, its G groups' statistics come first,
// from the S slots of `part`. Where N % 8 == 0 and N / 8 <= NT, thread t
// owns channels 8 (t % (N / 8)) + [0, 8) of every (NT / (N / 8))-th pixel,
// their constants in registers, four 16-byte loads in flight; otherwise
// channel by channel.
template <typename T, int NT>
__device__ __noinline__ void quantize_mid(const Params& p, const float* part, int S) {
  extern __shared__ __align__(128) int8_t smem[];
  float2* gst = reinterpret_cast<float2*>(smem + kGstOff);
  constexpr int U = 4;
  // the parameters this phase reads, once (as in quantize_x)
  const T* mid = static_cast<const T*>(p.mid);
  const int HW = p.H * p.W, N = p.N, G = p.G, cpg = N / G;
  const float* g2 = p.g2;
  const float* be2 = p.be2;
  int8_t* s8 = p.s8;
  const float eps = p.eps;
  const int npt = (HW + kMidPix - 1) / kMidPix;
  const long long total = (long long)p.B * npt;
  const int lo = int(total * blockIdx.x / gridDim.x);
  const int hi = int(total * (blockIdx.x + 1) / gridDim.x);
  const float sx = *p.c2.s_x, rs = rcp_scale(sx);
  const float count = float(HW) * float(cpg);
  const int tid = threadIdx.x;
  const int units = N / 8;
  const bool vec = N % 8 == 0 && units <= NT;
  const int ppi = vec ? NT / units : 0;           // pixels an iteration
  const int u = vec ? tid % units : 0, pl = vec ? tid / units : 0;
  float mean[8], rstd[8], gam[8], bet[8];
  int cur = -1;  // the sample whose statistics are loaded
  for (int t = lo; t < hi;) {
    const int b = t / npt;
    const int t1 = min(hi, (b + 1) * npt);  // this run's steps of sample b
    if (b != cur) {
      __syncthreads();  // every read of gst is done
      if (tid < G) gst[tid] = group_stats(part, b * G + tid, S, count, eps);
      __syncthreads();
      if (vec) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int c = 8 * u + k;
          const float2 st = gst[c / cpg];
          mean[k] = st.x;
          rstd[k] = st.y;
          gam[k] = g2[c];
          bet[k] = be2[c];
        }
      }
      cur = b;
    }
    const int p0 = (t - b * npt) * kMidPix, p1 = min(HW, (t1 - b * npt) * kMidPix);
    t = t1;
    const long long row0 = (long long)b * HW;
    if (vec) {
      if (pl >= ppi) continue;
      for (int px0 = p0 + pl; px0 < p1; px0 += U * ppi) {
        uint4 raw[U][sizeof(T) / 2];  // 8 values: one 16-byte load (bf16) or two (f32)
#pragma unroll
        for (int j = 0; j < U; ++j) {
          const long long off = (row0 + min(px0 + j * ppi, p1 - 1)) * N + 8 * u;
#pragma unroll
          for (int k = 0; k < int(sizeof(T) / 2); ++k)
            raw[j][k] = __ldcg(reinterpret_cast<const uint4*>(mid + off) + k);
        }
#pragma unroll
        for (int j = 0; j < U; ++j) {
          if (px0 + j * ppi >= p1) break;
          const T* e = reinterpret_cast<const T*>(raw[j]);
          uint32_t w[2] = {0u, 0u};
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int q = gn_code(to_f(e[k]), mean[k], rstd[k], gam[k], bet[k], sx, rs, 1);
            w[k / 4] |= (uint32_t(q) & 0xffu) << (8 * (k % 4));
          }
          *reinterpret_cast<uint2*>(s8 + (row0 + px0 + j * ppi) * N + 8 * u) =
              make_uint2(w[0], w[1]);
        }
      }
    } else {
      for (int i = p0 * N + tid; i < p1 * N; i += NT) {
        const int c = i % N;
        const float2 st = gst[c / cpg];
        s8[row0 * N + i] = int8_t(gn_code(ld_l2(mid + row0 * N + i), st.x, st.y, __ldg(g2 + c),
                                          __ldg(be2 + c), sx, rs, 1));
      }
    }
  }
}

// conv1's epilogue on the halo route: acc * (sx1 * sw1[n]) + b1[n] +
// film[b, n], rounded to T, staged [pixel][channel] in shared memory P
// channels at a time; then the mid, 8 channels of one pixel a thread, and
// the (sum, sum of squares) of each GroupNorm group of the pass over the
// tile's pixels, one warp a group (lane-strided pixels, then a fixed
// shuffle tree), into slot (b * G + group) * S2 + row tile.
template <typename T, int BN, int BM>
__device__ __forceinline__ void mid_epilogue(const Params& p, const Tile& tl, const int* acc,
                                             int8_t* smem, float sx) {
  constexpr int NT = 2 * BM, P = BN == 160 ? 80 : BN, LDS = P + 1;  // odd: conflict-free
  const QConvParams& q = p.c1;
  const T* film = static_cast<const T*>(q.film);
  T* mid = static_cast<T*>(p.mid);
  float* stage = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int cpg = q.N / p.G, mt = tl.r0 / q.rows;
  const long long pix0 = (long long)tl.b * q.H * q.W + tl.r0 * q.W;
  __syncthreads();  // every thread is past its last read of the halo and the ring
#pragma unroll
  for (int c0 = 0; c0 < BN; c0 += P) {
    // accumulator block i of this thread: pixels warp * 16 + g (+ 8),
    // channels 8 i + 2 t (+ 1)
#pragma unroll
    for (int i = c0 / 8; i < (c0 + P) / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = tl.n0 + 8 * i + 2 * t + e;
        const float scale = __fmul_rn(sx, q.w_scale[n]);
        const float add = q.bias[n];
        const float fv = to_f(film[tl.b * q.film_sb + n]);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float y =
              __fadd_rn(__fadd_rn(__fmul_rn(float(acc[4 * i + 2 * hr + e]), scale), add), fv);
          stage[(warp * 16 + g + 8 * hr) * LDS + 8 * i + 2 * t + e - c0] = to_f(from_f<T>(y));
        }
      }
    __syncthreads();
    for (int item = tid; item < BM * (P / 8); item += NT) {
      const int m = item / (P / 8), u = item - m * (P / 8);
      if (m >= tl.valid) break;
      float y[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) y[k] = stage[m * LDS + 8 * u + k];
      store8(mid + (pix0 + m) * q.N + tl.n0 + c0 + 8 * u, y);
    }
    for (int gl = warp; gl < P / cpg; gl += NT / 32) {
      float a = 0.f, s2 = 0.f;
      for (int m = lane; m < tl.valid; m += 32) {
        const float* row = stage + m * LDS + gl * cpg;
        for (int c = 0; c < cpg; ++c) {
          a = __fadd_rn(a, row[c]);
          s2 = __fmaf_rn(row[c], row[c], s2);
        }
      }
#pragma unroll
      for (int o = 16; o; o >>= 1) {
        a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, o));
        s2 = __fadd_rn(s2, __shfl_xor_sync(0xffffffffu, s2, o));
      }
      if (lane == 0) {
        const int group = (tl.n0 + c0) / cpg + gl;
        reinterpret_cast<float2*>(p.part2)[(long long)(tl.b * p.G + group) * p.S2 + mt] =
            make_float2(a, s2);
      }
    }
    __syncthreads();  // the stage is read before the next pass (or tile) writes it
  }
}

// Phases 3 and 5 on the halo route: every (row tile, N tile) of the conv,
// N tiles of one row tile on consecutive blocks.
template <typename T, int KC, int BN, int BM, bool SECOND>
__device__ void conv_halo(const Params& p, int8_t* smem) {
  const QConvParams& q = SECOND ? p.c2 : p.c1;
  const int ntn = q.N / BN, items = q.B * q.tiles * ntn;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const Tile tl = make_tile(q, it / ntn, it - (it / ntn) * ntn, BN);
    int acc[BN / 2];
    halo_tile_s8<KC, BN, BM>(q, tl, smem, 0, q.C / KC, acc);
    const float sx = *q.s_x;  // loaded here: nothing lives across the main loop that need not
    if constexpr (SECOND) {  // row 10's epilogue, in passes of conv1's width
      auto sync = [] { __syncthreads(); };
      halo_epilogue<T, BN, BM, decltype(sync), BN == 160 ? 80 : BN>(q, tl, acc, smem, sx, tid,
                                                                      warp, lane, sync);
    } else {
      mid_epilogue<T, BN, BM>(p, tl, acc, smem, sx);
    }
  }
}

// The general route's A tile: output pixels [m0, m0 + 128) of sample b x K
// [k0, k0 + 64) of the s8 codes [B, HW, Cin] (K = tap x Cin; zero outside
// the image).
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
          q = __ldcg(reinterpret_cast<const signed char*>(xb + ((long long)yi * W + xi) * Cin + c));
      }
      word |= (uint32_t(q) & 0xffu) << (8 * e);
    }
    dst[w4] = word;
  }
}

// Phases 3 and 5 on the general route (256 threads): the implicit GEMM of
// qconv_tile.cuh (mma.sync m16n8k32 s8, 128 x 64 tiles of one sample, K
// tiles double-buffered by cp.async); conv1 writes the mid [B, HW, N],
// conv2 adds the bias and skip into out.
template <typename T, bool SECOND>
__device__ __noinline__ void conv_general(const Params& p, int8_t* smem) {
  const QConvParams& q = SECOND ? p.c2 : p.c1;
  int8_t (*sA)[kBM * kLD] = reinterpret_cast<int8_t (*)[kBM * kLD]>(smem);
  int8_t (*sB)[kBN * kLD] = reinterpret_cast<int8_t (*)[kBN * kLD]>(smem + 2 * kBM * kLD);
  const int HW = q.H * q.W, Cin = q.C;
  const float sx = *q.s_x;
  const int K = 9 * Cin;
  const bool vec = Cin % kBK == 0;
  const int nkt = (K + kBK - 1) / kBK;
  const int mtiles = (HW + kBM - 1) / kBM, ntiles = (q.N + kBN - 1) / kBN;
  const int items = q.B * mtiles * ntiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 4, wn = warp / 4;
  const int g = lane >> 2, t = lane & 3;
  const int8_t* s8 = static_cast<const int8_t*>(q.x);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int nt_ = it % ntiles, rest = it / ntiles;
    const int mt_ = rest % mtiles, b = rest / mtiles;
    const int m0 = mt_ * kBM, n0 = nt_ * kBN;
    int acc[2][4][4];
    zero_acc(acc);
    __syncthreads();  // shared memory is free (previous tile or phase)
    load_a(s8, b, q.H, q.W, Cin, vec, sA[0], m0, 0);
    load_b(q.w, q.N, K, vec, sB[0], n0, 0);
    cp_async_commit();
    for (int kt = 0; kt < nkt; ++kt) {
      const int cur = kt & 1;
      cp_async_wait_all();
      __syncthreads();
      if (kt + 1 < nkt) {  // the other buffer was last read before the barrier
        load_a(s8, b, q.H, q.W, Cin, vec, sA[cur ^ 1], m0, (kt + 1) * kBK);
        load_b(q.w, q.N, K, vec, sB[cur ^ 1], n0, (kt + 1) * kBK);
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
        const int y = m / q.W, x = m - (m / q.W) * q.W;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + wn * 32 + nt * 8 + 2 * t + e;
            if (n >= q.N) continue;
            float v = __fadd_rn(__fmul_rn(float(acc[mt][nt][2 * hr + e]),
                                          __fmul_rn(sx, q.w_scale[n])), q.bias[n]);
            if (!SECOND) {
              v = __fadd_rn(v, to_f(static_cast<const T*>(q.film)[b * q.film_sb + n]));
              static_cast<T*>(p.mid)[((long long)b * HW + m) * q.N + n] = from_f<T>(v);
            } else {
              const T* res = static_cast<const T*>(q.res);
              v = __fadd_rn(v, to_f(res[b * q.srb + y * q.srh + x * q.srw + n * q.src]));
              static_cast<T*>(q.out)[b * q.sob + y * q.soh + x * q.sow + n * q.soc] =
                  from_f<T>(v);
            }
          }
      }
  }
}

template <typename T, int KC, int BN, int BM>
__global__ void __launch_bounds__(2 * BM, BM == 128 ? 2 : 1)
    resblock_kernel(const __grid_constant__ Params p) {
  constexpr int NT = 2 * BM;
  extern __shared__ __align__(128) int8_t smem[];
  cg::grid_group grid = cg::this_grid();
  const int HW = p.H * p.W;
  const T* mid = static_cast<const T*>(p.mid);

  gn_partials<T, NT>(static_cast<const T*>(p.x), p.sxb, p.sxp, p.sxc, p.B, p.C, HW, p.G,
                     p.part1);
  grid.sync();
  quantize_x<T, NT>(p);
  grid.sync();
  if constexpr (BM == 128) {
    if (p.route == kGeneral) {
      conv_general<T, false>(p, smem);
      grid.sync();
      gn_partials<T, NT>(mid, (long long)HW * p.N, p.N, 1, p.B, p.N, HW, p.G, p.part2);
      grid.sync();
      quantize_mid<T, NT>(p, p.part2, 1);
      grid.sync();
      conv_general<T, true>(p, smem);
      return;
    }
  }
  conv_halo<T, KC, BN, BM, false>(p, smem);
  grid.sync();
  quantize_mid<T, NT>(p, p.part2, p.S2);
  grid.sync();
  conv_halo<T, KC, BN, BM, true>(p, smem);
}

// Shared-memory bytes of the dynamic region (ops/qconv.py::resblock_plan):
// the halo slots and weight ring, the epilogues' staging (halo route), the
// general route's double-buffered A and B tiles; the other phases' tile,
// per-channel constants and reduction slots.
int plan_smem(int route, int kc, int bn, int bm, int halo_pixels) {
  const int quant = kPhaseSmem;
  if (route == kGeneral) return std::max(2 * (kBM + kBN) * kLD, quant);
  const int pass = bn == 160 ? 80 : bn;  // the epilogues' channels a pass
  return std::max({2 * halo_pixels * (kc + 16) + kStages * bn * kc, pass * (bm + 4) * 4,
                   bm * (pass + 1) * 4, quant});
}

template <typename K>
int allow_smem(K kernel, int smem, int& smem_set) {
  if (smem > smem_set) {
    const cudaError_t rc =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return int(rc);
    smem_set = smem;
  }
  return 0;
}

// grid = min(cap, resident blocks an SM) x SMs (cap: 2 at 128-pixel tiles,
// 1 at 256), as the plan derived it; refused otherwise
template <typename T, int KC, int BN, int BM>
int launch(const Params& p, int smem, int grid_plan, cudaStream_t stream) {
  auto kernel = resblock_kernel<T, KC, BN, BM>;
  static int smem_set = 0;
  if (const int rc = allow_smem(kernel, smem, smem_set)) return rc;
  static int last_dev = -1, last_smem = -1, last_grid = 0;  // the last occupancy asked
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  if (dev != last_dev || smem != last_smem) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return int(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 2 * BM, smem);
    if (e != cudaSuccess) return int(e);
    if (per_sm < 1) return int(cudaErrorCooperativeLaunchTooLarge);
    last_dev = dev;
    last_smem = smem;
    last_grid = std::min(per_sm, BM == 128 ? 2 : 1) * sms;
  }
  if (grid_plan != last_grid) return int(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(grid_plan));
  cfg.blockDim = dim3(2 * BM);
  cfg.dynamicSmemBytes = size_t(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& p, int kc, int bn, int bm, int smem, int grid, cudaStream_t st) {
  if (kc == 64) {
    if (bm == 256 && bn == 160) return launch<T, 64, 160, 256>(p, smem, grid, st);
    if (bm == 256 && bn == 80) return launch<T, 64, 80, 256>(p, smem, grid, st);
    if (bm == 128 && bn == 160) return launch<T, 64, 160, 128>(p, smem, grid, st);
    if (bm == 128 && bn == 80) return launch<T, 64, 80, 128>(p, smem, grid, st);
    if (bm == 128 && bn == 64) return launch<T, 64, 64, 128>(p, smem, grid, st);
  } else if (kc == 32 && bm == 128) {
    if (bn == 160) return launch<T, 32, 160, 128>(p, smem, grid, st);
    if (bn == 80) return launch<T, 32, 80, 128>(p, smem, grid, st);
    if (bn == 64) return launch<T, 32, 64, 128>(p, smem, grid, st);
  }
  return int(cudaErrorInvalidValue);
}

// The conv's QConvParams: s8 input [B, HW, Cin] channels-last, halo geometry
// of `rows` output rows a tile.
QConvParams conv_params(const int8_t* s8, const void* w, const void* sw, const void* bias,
                        const void* sx, int B, int H, int W, int Cin, int N, int rows) {
  QConvParams q = {};
  q.x = s8;
  q.w = static_cast<const int8_t*>(w);
  q.w_scale = static_cast<const float*>(sw);
  q.bias = static_cast<const float*>(bias);
  q.s_x = static_cast<const float*>(sx);
  q.B = B; q.H = H; q.W = W; q.C = Cin; q.N = N; q.stride = 1; q.Ho = H; q.Wo = W;
  q.with_silu = 1;
  q.rows = rows;
  q.tiles = rows > 0 ? (H + rows - 1) / rows : 0;
  q.halo_h = rows + 2;
  q.halo_w = W + 2;
  q.halo_we = (q.halo_w + 1) / 2;
  q.hp_magic = div_magic(unsigned(q.halo_h * q.halo_w));
  q.hw_magic = div_magic(unsigned(q.halo_w));
  q.cluster = 1;
  q.splitk = 1;
  q.sxb = (long long)H * W * Cin; q.sxh = (long long)W * Cin; q.sxw = Cin; q.sxc = 1;
  return q;
}

}  // namespace

// dtype: 0 bf16, 1 f32 (x, skip, film, mid and out share it); this
// library takes bf16 and csrc/resblock_q_f32.cu's the f32 (each dtype's
// eight kernels a translation unit of its own: one nvcc of all sixteen set
// the whole build's time). The plan
// (ops/qconv.py::resblock_plan): route 1 halo with `rows` output rows a
// tile of at most `bm` pixels, `kc` input channels a staged halo, `bn`
// output channels a tile; 0 general (bm 128); `smem` bytes of dynamic
// shared memory, `grid` blocks, `s2` GN2 slots a group. The launch derives
// each of them again and returns cudaErrorInvalidValue on a mismatch.
// Returns a cudaError_t code; 0 means the launch was accepted.
extern "C" int vd_resblock_q(const void* x, const void* skip, void* out, const void* w1,
                             const void* sw1, const void* b1, const void* g1, const void* be1,
                             const void* sx1, const void* w2, const void* sw2, const void* b2,
                             const void* g2, const void* be2, const void* sx2, const void* film,
                             void* mid, void* s8, void* part1, void* part2, int B, int H, int W,
                             int C, int N, int G, float eps, long long sxb, long long sxp,
                             long long sxc, long long skb, long long skp, long long skc,
                             long long sob, long long sop, long long soc, long long film_sb,
                             int dtype, int route, int rows, int kc, int bn, int bm, int smem,
                             int grid, int s2, void* stream) {
  const int HW = H * W;
  if (B < 1 || HW < 1 || G < 1 || G > kMaxGroups || C % G != 0 || N % G != 0 ||
      (skip == nullptr && C != N))
    return int(cudaErrorInvalidValue);
  const int cpg = N / G;
  if (route == kHalo) {
    const int pass = bn == 160 ? 80 : bn;
    const bool ok = C % 32 == 0 && N % 32 == 0 && kc == (C % 64 == 0 && N % 64 == 0 ? 64 : 32) &&
                    (bm == 128 || (bm == 256 && kc == 64 && bn != 64)) && W <= bm &&
                    rows == std::min(bm / W, H) && (bn == 160 || bn == 80 || bn == 64) &&
                    N % bn == 0 && pass % cpg == 0 && s2 == (H + rows - 1) / rows &&
                    (rows + 2) * (W + 2) * (kc / 4) < (1 << 16) &&
                    smem == plan_smem(kHalo, kc, bn, bm, (rows + 2) * (W + 2));
    if (!ok) return int(cudaErrorInvalidValue);
  } else if (route != kGeneral || bm != 128 || s2 != 1 ||  // one GN2 slot a group
             smem != plan_smem(kGeneral, 0, 0, 128, 0)) {
    return int(cudaErrorInvalidValue);
  }
  Params p;
  p.c1 = conv_params(static_cast<const int8_t*>(s8), w1, sw1, b1, sx1, B, H, W, C, N, rows);
  p.c1.film = film;
  p.c1.film_sb = film_sb;
  p.c2 = conv_params(static_cast<const int8_t*>(s8), w2, sw2, b2, sx2, B, H, W, N, N, rows);
  p.c2.res = skip ? skip : x;
  p.c2.srb = skip ? skb : sxb;
  p.c2.srw = skip ? skp : sxp;
  p.c2.src = skip ? skc : sxc;
  p.c2.srh = p.c2.srw * W;
  p.c2.out = out;
  p.c2.sob = sob; p.c2.sow = sop; p.c2.soh = sop * W; p.c2.soc = soc;
  p.x = x;
  p.g1 = static_cast<const float*>(g1);
  p.be1 = static_cast<const float*>(be1);
  p.g2 = static_cast<const float*>(g2);
  p.be2 = static_cast<const float*>(be2);
  p.mid = mid;
  p.s8 = static_cast<int8_t*>(s8);
  p.part1 = static_cast<float*>(part1);
  p.part2 = static_cast<float*>(part2);
  p.B = B; p.H = H; p.W = W; p.C = C; p.N = N; p.G = G;
  p.S2 = s2; p.route = route;
  p.eps = eps;
  p.sxb = sxb; p.sxp = sxp; p.sxc = sxc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kc_ = route == kHalo ? kc : 64, bn_ = route == kHalo ? bn : 64;
#if VD_RESBLOCK_F32
  if (dtype == 1) return dispatch<float>(p, kc_, bn_, bm, smem, grid, st);
#else
  if (dtype == 0) return dispatch<__nv_bfloat16>(p, kc_, bn_, bm, smem, grid, st);
#endif
  return int(cudaErrorInvalidValue);
}
