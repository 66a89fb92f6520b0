// Calibrated no-max attention forward for Hopper (sm_90a): bf16 in, bf16 out.
//
// Replaces: vdtpu/ops/pallas/flash.py::_nomax_slim_kernel (row 3 of the
// kernel table, reached through _nomax_slim_impl / flash_attention_nomax),
// the int8 serving policy's attention at the long self-attention sites.
// It also covers _nomax_kernel (row 2: d % 8 != 0, the shift carried by an
// extra K lane) and _nomax_packed_kernel (row 4: the native [B, N, H*D]
// layout): q, k, v are read in place through their strides, so [B, N, H, D]
// views of [B, N, H*D] projections are the packed layout.
//
// Function: per (b, h) a calibrated upper bound M = shift[b * shift_sb + h]
// on the scaled logits replaces the running maximum:
//   q~ = bf16(q * scale * log2(e)),  p = exp2(q~ . k^T - M * log2(e)),
//   o  = (sum_j bf16(p_j) v_j) / max(sum_j p_j, 1e-30)   (f32 sums),
// keys past the kv length get p = 0.
//
// Bound on this card: the same work as flash_fwd.cu without the rescale.
// At [4, 4096, 8, 40] that is 32 * 4096^2 = 537 M exponentials (about
// 0.128 ms at 16 per SM per clock on 132 SMs at 1.98 GHz), 86 GFLOP of
// bf16 tensor-core products (about 0.087 ms at 989 TFLOP/s) and 42 MB of
// device memory traffic (0.013 ms). At the token-merged [4, 1024, 8, 40]
// site: 33.6 M exponentials, about 0.008 ms. The exponentials set the pace.
//
// Two kernels, picked by the caller's plan (vdtpu_torch/ops/flash.py::
// attn_fwd_plan, mirrored by vdattn::plan_code) from shape and alignment:
// - heads up to 80 with d % 8 == 0 and 16-byte aligned rows (every site of
//   the int8 path): attn_fwd_wg_kernel in csrc/attn_fwd_sm90.cuh, Mode
//   NoMax: wgmma and TMA, a producer warpgroup, two or three consumer
//   warpgroups; heads of 88-160 the same kernel built in
//   csrc/attn_fwd_wide.cu (vd_attn_fwd_wide), which refuses them here;
// - every other head and layout (d % 8 != 0, heads over 160, unaligned
//   views): nomax_fwd_kernel below, mma.sync from 4 warps of 16 query rows,
//   one exp2f per score, the row sums reduced across the quad once at the
//   end, K/V tiles double-buffered by cp.async (or element loads), d padded
//   in shared memory only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tile.cuh"
#include "attn_fwd_sm90.cuh"

namespace {

constexpr int kBQ = 64;      // query rows per block: 16 per warp
constexpr int kBK = 64;      // keys per K/V tile

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  const float* shift;
  int B, N, M, H, D;
  long long sqb, sqn, sqh;
  long long skb, skn, skh;
  long long svb, svn, svh;
  long long sob, son, soh;
  long long shift_sb;  // stride of the batch index into shift (0: [H])
  float qscale;        // scale * log2(e)
  int vec;             // 1: 16-byte aligned rows and d % 8 == 0 -> cp.async
};

template <int DP>
__global__ void __launch_bounds__(kThreads) nomax_fwd_kernel(const Params p) {
  constexpr int LD = DP + kPad;
  constexpr int KSTEPS = DP / 16;
  constexpr int NT = kBK / 8;
  constexpr int DT = DP / 8;
  constexpr float kLog2e = 1.4426950408889634f;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBQ * LD;      // two buffers
  __nv_bfloat16* sV = sK + 2 * kBK * LD;  // two buffers

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.x * kBQ;
  const __nv_bfloat16* qb = p.q + b * p.sqb + h * p.sqh;
  const __nv_bfloat16* kb = p.k + b * p.skb + h * p.skh;
  const __nv_bfloat16* vb = p.v + b * p.svb + h * p.svh;
  const bool vec = p.vec != 0;
  const float m2 = p.shift[b * p.shift_sb + h] * kLog2e;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  load_tile<DP>(sQ, qb, p.sqn, q0, p.N, p.D, vec);
  load_tile<DP>(sK, kb, p.skn, 0, p.M, p.D, vec);
  load_tile<DP>(sV, vb, p.svn, 0, p.M, p.D, vec);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  // q * scale * log2(e) in f32, rounded to bf16 (the TPU kernel's q~)
  for (int i = threadIdx.x; i < kBQ * DP; i += kThreads) {
    __nv_bfloat16* e = sQ + (i / DP) * LD + (i % DP);
    *e = __float2bfloat16(__bfloat162float(*e) * p.qscale);
  }
  __syncthreads();

  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float l_part[2] = {0.f, 0.f};  // this thread's share of each row's sum

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
    // p = exp2(s - M log2 e); keys past M get p = 0
    const int kbase = j * kBK;
    const bool ragged = kbase + kBK > p.M;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool dead = ragged && (kbase + nt * 8 + t * 2 + (e & 1) >= p.M);
        const float pe = dead ? 0.f : exp2f(s[nt][e] - m2);
        s[nt][e] = pe;
        l_part[e >> 1] += pe;
      }
    // O += bf16(P) . V
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
    float l = l_part[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float den = fmaxf(l, 1e-30f);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= p.N) continue;
    __nv_bfloat16* orow = p.o + b * p.sob + h * p.soh + row * p.son;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = dt * 8 + t * 2 + e;
        if (col < p.D) orow[col] = __float2bfloat16(o[dt][2 * r + e] / den);
      }
  }
}

template <int DP>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = size_t(kBQ + 4 * kBK) * (DP + kPad) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(nomax_fwd_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((p.N + kBQ - 1) / kBQ, p.B * p.H);
  nomax_fwd_kernel<DP><<<grid, kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

// Returns a cudaError_t code; 0 means the launch was accepted. plan: the
// caller's AttnFwdPlan.code, which must be the one vdattn::plan_code gives
// these arguments (cudaErrorInvalidValue otherwise).
extern "C" int vd_nomax_fwd(const void* q, const void* k, const void* v, void* o,
                            const void* shift, long long shift_sb, int B, int N, int M, int H,
                            int D, long long sqb, long long sqn, long long sqh, long long skb,
                            long long skn, long long skh, long long svb, long long svn,
                            long long svh, long long sob, long long son, long long soh,
                            float qscale, int plan, void* stream) {
  const long long strides[9] = {sqb, sqn, sqh, skb, skn, skh, svb, svn, svh};
  if (plan != vdattn::plan_code(D, N, q, k, v, strides)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vdattn::is_wg(plan)) {
    vdattn::Args a = {};
    a.q = static_cast<const __nv_bfloat16*>(q);
    a.k = static_cast<const __nv_bfloat16*>(k);
    a.v = static_cast<const __nv_bfloat16*>(v);
    a.o = static_cast<__nv_bfloat16*>(o);
    a.shift = static_cast<const float*>(shift);
    a.shift_sb = shift_sb;
    a.B = B; a.N = N; a.M = M; a.H = H; a.D = D;
    a.sqb = sqb; a.sqn = sqn; a.sqh = sqh;
    a.skb = skb; a.skn = skn; a.skh = skh;
    a.svb = svb; a.svn = svn; a.svh = svh;
    a.sob = sob; a.son = son; a.soh = soh;
    a.qscale = qscale;
    return vdattn::dispatch_wg<vdattn::Mode::NoMax>(a, st);
  }
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.shift = static_cast<const float*>(shift);
  p.shift_sb = shift_sb;
  p.B = B; p.N = N; p.M = M; p.H = H; p.D = D;
  p.sqb = sqb; p.sqn = sqn; p.sqh = sqh;
  p.skb = skb; p.skn = skn; p.skh = skh;
  p.svb = svb; p.svn = svn; p.svh = svh;
  p.sob = sob; p.son = son; p.soh = soh;
  p.qscale = qscale;
  p.vec = plan;
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
