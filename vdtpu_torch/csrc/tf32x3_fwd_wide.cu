// The flash forward's tf32x3 route (split-f32 products on Hopper's tensor
// cores, csrc/tf32x3.cuh) at heads of 88-160 with d % 8 == 0 and 16-byte
// aligned rows: f32 q, k, v in, f32 out and lse, f32 softmax and sums.
//
// Replaces, on those heads: vdtpu/ops/pallas/flash.py::_fwd_kernel for f32
// operands (through _fwd_impl), which csrc/flash_fwd.cu's SIMT kernel
// (flash_fwd_f32_kernel) ran there before. f32 is the port's default dtype,
// so a default-dtype four-image mcg sends its 16^2 cross-attentions here:
// [4, 256, 8, 160] over 1028 keys, 250 launches a request.
//
// Bound at that site: the two products are 5.39 GFLOP; as three tf32
// passes each (lo.hi + hi.lo + hi.hi, csrc/tf32x3.cuh) 16.2 G operations,
// 0.0327 ms at 495 TFLOP/s; q, k, v read once and out written once are
// 52.6 MB, 0.0157 ms; 8.4 M exponentials, 0.002 ms. The tensor cores set
// the bound.
//
// Why not csrc/flash_fwd.cu's tf32x3 kernel: its shared memory is
// 4 (2 x 128 d + 2 x 4 x tile d) bytes, 327,680 at d 160 with 32-key
// tiles (Q's hi and lo for 64 rows alone are 80 KB), and its fresh P.V
// accumulator beside O would be 160 registers a thread. The design here:
// - one warpgroup of 64 query rows a block (128 blocks at the mcg site's
//   4 x 256 queries x 8 heads: one wave on 132 SMs);
// - Q kept once in shared memory in f32, scale folded in, at a row stride
//   of d + 4 floats (the fragment loads of a warp hit 32 banks), and split
//   into tf32 hi and lo A fragments in registers as S = Q.K^T's k8 steps
//   load them (wgmma rs), four steps a commit group, two groups in flight;
// - K and V split once a call into a device workspace of 32-key tiles
//   (vdf::split_tiles: K as rows, V transposed in the permuted key order
//   whose score accumulators are P.V's A fragments), a stage (K hi, K lo,
//   V^T hi, V^T lo: 80 KB at d 160) brought in by one bulk TMA copy on an
//   mbarrier, double-buffered, the next tile's copy in flight during this
//   tile's products: 2 x 80 + 41 KB (Q) = 201 KB;
// - the online softmax in f32 as flash_fwd.cu's tf32x3 kernel (ex2 with
//   log2 e folded in), P split in registers straight from the accumulators;
// - O_j = P.V in two halves of the head (n <= 80 each: 80 + 80 at d 160),
//   each a fresh accumulator of at most 40 registers, both in flight, then
//   O = O alpha + O_j in f32, so the tensor core's own sums never span more
//   than one tile (as the 128-row kernel).
// Its order of work and rounding in plain PyTorch is
// vdtpu_torch/ops/flash.py::flash_attention_fwd_tf32x3_blocked_plain (32-key
// tiles at these heads); the launch geometry mirrors
// vdtpu_torch/ops/flash.py::attn_fwd_plan.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

struct Params {
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

// Shared memory, in floats: two stages of (K hi, K lo, V^T hi, V^T lo), each
// part kT x DP; Q [64][kLdq]; two mbarriers.
template <int DP>
struct Wide {
  static constexpr int kT = 32;                   // keys a tile
  static constexpr int kLdq = DP + 4;             // Q's row stride: DP % 8 == 0, so 4 mod 8
  static constexpr int kQ = 64 * kLdq;
  static constexpr int kPart = kT * DP;
  static constexpr int kStage = 4 * kPart;
  static constexpr int kSmem = 4 * (2 * kStage + kQ) + 16;
  static constexpr int kN1 = (DP + 15) / 16 * 8;  // P.V's first half of the head
  static constexpr int kN2 = DP - kN1;            // and its second (both n8 multiples <= 80)
  static constexpr int kGroup = 4;                // k8 steps of S = Q.K^T a commit group
  static constexpr int kGroups = (DP / 8 + kGroup - 1) / kGroup;
};

// S = (q scale).K_j^T for this warpgroup's 64 rows over a kT-key tile. A:
// Q's f32 rows in shared memory (qa: this thread's row g of its warp, column
// t), split into tf32 hi and lo fragments as each k8 step loads them
// (a[0] row g col t, a[1] row g + 8, a[2] / a[3] column t + 4); B: K_j's hi
// and lo RowsTile planes. Per k8 step lo.hi, hi.lo, hi.hi into one f32
// accumulator; kGroup steps a commit group, at most two groups in flight.
template <int DP>
__device__ __forceinline__ void qk3(float (&s)[Wide<DP>::kT / 2], const float* qa,
                                    const float* kh, const float* kl) {
  using G = Wide<DP>;
  const uint64_t dh = vdf::plane_desc(kh, G::kT), dl = vdf::plane_desc(kl, G::kT);
#pragma unroll
  for (int gi = 0; gi < G::kGroups; ++gi) {
    uint32_t fh[G::kGroup][4], fl[G::kGroup][4];
#pragma unroll
    for (int x = 0; x < G::kGroup; ++x) {
      const int kk = gi * G::kGroup + x;
      if (kk >= DP / 8) break;
      const float a[4] = {qa[8 * kk], qa[8 * G::kLdq + 8 * kk], qa[8 * kk + 4],
                          qa[8 * G::kLdq + 8 * kk + 4]};
#pragma unroll
      for (int e = 0; e < 4; ++e) vdf::split(a[e], fh[x][e], fl[x][e]);
    }
    vdw::keep(fh);
    vdw::keep(fl);
    vdw::wg_fence();
#pragma unroll
    for (int x = 0; x < G::kGroup; ++x) {
      const int kk = gi * G::kGroup + x;
      if (kk >= DP / 8) break;
      const int ob = 2 * kk * G::kT * 16;
      vdw::Tf32<G::kT>::rs(s, fl[x], vdf::advance(dh, ob), kk > 0);
      vdw::Tf32<G::kT>::rs(s, fh[x], vdf::advance(dl, ob), 1);
      vdw::Tf32<G::kT>::rs(s, fh[x], vdf::advance(dh, ob), 1);
    }
    vdw::wg_commit();
    vdw::wg_wait<1>();  // the group before has read its fragments
  }
  vdw::wg_wait<0>();
}

// acc[m64 x N] = P.V_j[:, c0 : c0 + N] over the tile's kT keys: A = P's hi
// and lo fragments (vdf::split_frags), B = V_j^T's hi and lo ColsTile planes
// of DP head columns (LBO one plane, DP x 16 bytes; column c0 at 16 c0
// bytes into each): lo.hi and hi.lo, then hi.hi. acc is overwritten.
template <int N, int KS, int DP>
__device__ __forceinline__ void pv3(float* acc, const uint32_t (&fh)[KS][4],
                                    const uint32_t (&fl)[KS][4], const float* vh, const float* vl,
                                    int c0) {
  const uint64_t dh = vdw::desc(vh + 4 * c0, DP * 16, 128);
  const uint64_t dl = vdw::desc(vl + 4 * c0, DP * 16, 128);
#pragma unroll
  for (int kc = 0; kc < KS; ++kc) {
    const int ob = 2 * kc * DP * 16;
    vdw::Tf32<N>::rs(acc, fl[kc], vdf::advance(dh, ob), kc > 0);
    vdw::Tf32<N>::rs(acc, fh[kc], vdf::advance(dl, ob), 1);
  }
#pragma unroll
  for (int kc = 0; kc < KS; ++kc)
    vdw::Tf32<N>::rs(acc, fh[kc], vdf::advance(dh, 2 * kc * DP * 16), 1);
}

template <int DP>
__global__ void __launch_bounds__(128, 1)
    flash_fwd_tf32x3_wide_kernel(const Params p, const float* ws) {
  using G = Wide<DP>;
  constexpr int T = G::kT, KS = T / 8;
  extern __shared__ __align__(128) float smem[];
  auto part = [&](int st, int i) { return smem + st * G::kStage + i * G::kPart; };
  float* sQ = smem + 2 * G::kStage;
  const uint32_t bars = vdt::smem_addr(sQ + G::kQ);  // stage st's copy completes on bars + 8 st

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * 64;
  const int nkt = (p.M + T - 1) / T;
  const float* wsb = ws + size_t(bh) * nkt * G::kStage;  // this head's split tiles
  if (tid == 0) {
    vdt::bar_init(bars, 1);
    vdt::bar_init(bars + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    vdf::stage_copy(part(0, 0), wsb, 4 * G::kStage, bars);
  }
  {  // q * scale in f32, as the TPU kernel folds it; rows past N zero
    const float* qb = p.q + b * p.sqb + h * p.sqh;
    for (int i = tid; i < 64 * (DP / 4); i += 128) {
      const int r = i / (DP / 4), c = i % (DP / 4);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < p.N) {
        x = __ldg(reinterpret_cast<const float4*>(qb + (q0 + r) * p.sqn) + c);
        x = make_float4(x.x * p.scale, x.y * p.scale, x.z * p.scale, x.w * p.scale);
      }
      *reinterpret_cast<float4*>(sQ + r * G::kLdq + 4 * c) = x;
    }
  }
  __syncthreads();
  const float* qa = sQ + (16 * warp + g) * G::kLdq + t;

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
    qk3<DP>(s, qa, part(st, 0), part(st, 1));
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
    // O_j = P.V in two fresh accumulators (halves of the head), then
    // O = O alpha + O_j in f32
    uint32_t ph[KS][4], pl[KS][4];
    vdf::split_frags<KS>(ph, pl, s);
    float o1[G::kN1 / 2], o2[G::kN2 / 2];
    vdw::keep(ph);
    vdw::keep(pl);
    vdw::keep(o1);
    vdw::keep(o2);
    vdw::wg_fence();
    pv3<G::kN1, KS, DP>(o1, ph, pl, part(st, 2), part(st, 3), 0);
    pv3<G::kN2, KS, DP>(o2, ph, pl, part(st, 2), part(st, 3), G::kN1);
    vdw::wg_commit();
    vdw::wg_wait<0>();
    vdw::keep(o1);
    vdw::keep(o2);
    vdw::keep(ph);
    vdw::keep(pl);
#pragma unroll
    for (int i = 0; i < G::kN1 / 2; ++i) o[i] = __fmaf_rn(o[i], alpha[(i >> 1) & 1], o1[i]);
#pragma unroll
    for (int i = 0; i < G::kN2 / 2; ++i)
      o[G::kN1 / 2 + i] = __fmaf_rn(o[G::kN1 / 2 + i], alpha[(i >> 1) & 1], o2[i]);
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
  vdf::store_acc<DP>(p.o + b * p.sob + h * p.soh, p.son, o, q0, p.N, tid);
  if (p.lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + 16 * warp + g + 8 * r;
      if (row < p.N) p.lse[size_t(bh) * p.N + row] = m_run[r] + logf(l_run[r]);
    }
  }
}

// K and V split once into ws (f32 [B * H, ceil(M / 32) tiles, 4 x 32 DP]: K
// hi, K lo, V^T hi, V^T lo a tile, the layout of a stage in shared memory),
// then the attention kernel
template <int DP>
int launch(const Params& p, float* ws, cudaStream_t stream) {
  using G = Wide<DP>;
  constexpr int T = G::kT;
  static_assert(G::kSmem <= 232448, "the wide tf32x3 forward's tiles fit shared memory");
  static_assert(G::kN1 % 8 == 0 && G::kN2 % 8 == 0 && G::kN1 <= 80 && G::kN2 <= 80,
                "P.V's halves are wgmma widths of csrc/wgmma_tf32.cuh");
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(flash_fwd_tf32x3_wide_kernel<DP>,
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
  const dim3 grid((p.N + 63) / 64, p.B * p.H);
  flash_fwd_tf32x3_wide_kernel<DP><<<grid, 128, G::kSmem, stream>>>(p, ws);
  return int(cudaGetLastError());
}

}  // namespace

// vd_flash_fwd_tf32x3's arguments (csrc/flash_fwd.cu) for heads of 88-160:
// f32 q, k, v, o and lse (nullptr skips it), ws the split K/V tiles'
// workspace (f32, B * H * ceil(M / 32) * 4 * 32 * D), strides in elements.
// d % 8 == 0 in 88-160 with 16-byte aligned rows (vdf::takes), else
// cudaErrorInvalidValue. Three launches: K's split, V's split, the
// attention. Returns a cudaError_t code; 0 means the launches were accepted.
extern "C" int vd_flash_fwd_tf32x3_wide(const void* q, const void* k, const void* v, void* o,
                                        void* lse, void* ws, int B, int N, int M, int H, int D,
                                        long long sqb, long long sqn, long long sqh,
                                        long long skb, long long skn, long long skh,
                                        long long svb, long long svn, long long svh,
                                        long long sob, long long son, long long soh,
                                        float scale, void* stream) {
  const void* ptrs[5] = {q, k, v, o, ws};
  const long long strides[12] = {sqb, sqn, sqh, skb, skn, skh, svb, svn, svh, sob, son, soh};
  if (!vdf::takes(D, ptrs, 5, strides, 12, vdf::kMaxBwdD + 8, vdf::kMaxFwdD))
    return int(cudaErrorInvalidValue);
  Params p;
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
    case 11: return launch<88>(p, w, st);
    case 12: return launch<96>(p, w, st);
    case 13: return launch<104>(p, w, st);
    case 14: return launch<112>(p, w, st);
    case 15: return launch<120>(p, w, st);
    case 16: return launch<128>(p, w, st);
    case 17: return launch<136>(p, w, st);
    case 18: return launch<144>(p, w, st);
    case 19: return launch<152>(p, w, st);
    case 20: return launch<160>(p, w, st);
    default: return int(cudaErrorInvalidValue);
  }
}
