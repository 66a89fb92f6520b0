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
// bf16 tensor-core products (103 with d padded to 48; about 0.09 ms at
// 989 TFLOP/s) and about 42 MB of device memory traffic (about 0.013 ms at
// 3.35 TB/s). The exponentials set the pace, then the tensor cores; memory
// is far below both.
//
// What the design does about it:
// - the [N, M] score matrix never leaves registers: each warp owns 16 query
//   rows, holds its 16 x 64 score tile in mma.sync accumulators and turns
//   it into the bf16 A operand of the P.V product in registers;
// - one exponential per score (exp2 with log2(e) folded in) plus one per
//   row per tile for the rescale, and no second pass over the scores;
// - q, k and v are read in place from [B, N, H, D] through strides, so the
//   caller's projections need no fold copies; d is padded to a multiple of
//   16 in shared memory only (40 -> 48), never in device memory;
// - K/V tiles are double-buffered with cp.async so the next tile's loads
//   overlap the current tile's math.
// The tensor-core product uses mma.sync m16n8k16; wgmma/TMA and a
// warp-specialised pipeline are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"

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

}  // namespace

// Returns a cudaError_t code; 0 means the launch was accepted.
extern "C" int vd_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int B, int N, int M, int H, int D, long long sqb, long long sqn,
                            long long sqh, long long skb, long long skn, long long skh,
                            long long svb, long long svn, long long svh, long long sob,
                            long long son, long long soh, float scale, int vec, void* stream) {
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
