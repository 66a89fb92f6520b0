// GroupNorm(+SiLU) + int8 quantize, and GroupNorm statistics, for Hopper
// (sm_90a): one launch a call each.
//
// Replaces (rows 7-9 of the kernel table), all in vdtpu/ops/pallas/gn_silu.py:
// - gn_silu_q: _kernel_q (the whole-slab GN+SiLU+quantize) and
//   _gn_silu_q_blocked's _stats_kernel + _apply_q_kernel;
// - gn_stats: _stats_kernel.
// Per sample and group, in f32: mean = E[x], var = max(E[x^2] - E[x]^2, 0),
// rstd = 1 / sqrt(var + eps); y = (x - mean) rstd w + b, then SiLU as
// y / (1 + exp(-y)); codes = clip(round half to even(y * (1 / s)), -127,
// 127), the multiply by the reciprocal of _kernel_q and _apply_q_kernel.
// x is channel-first [B, C, HW]; the codes are stored channels-last
// [B, HW, C] (the int8 conv's implicit-GEMM K axis); the statistics are
// [B, 2, C] channel-broadcast (mean, rstd), as qconv3_gn and gn_apply read.
//
// Bound on this card: bytes. gn_silu_q reads x once and writes one s8 code
// an element (at [4, 320, 64, 64] bf16 10.5 + 5.2 MB, 0.0047 ms at 3.35
// TB/s); gn_stats reads x once (0.0031 ms). The Triton kernels this design
// succeeds paid two launches a call, read x twice in gn_silu_q, and re-summed
// a group's partials in every apply program. A design on row 6's cluster
// template (bands of lcm(C / G, 16) channels, so that a pixel's codes are
// whole 16-byte runs) needed clusters of 8-16 at 64^2, which fit only 120 or
// 112 of the 132 SMs.
//
// gn_silu_q: one cooperative launch (the geometry is
// vdtpu_torch/ops/gn_silu.py::gnq_plan, checked on the CPU by
// tests/test_torch_gnq_plan.py, whose blocked model gnq_blocked_plain follows
// this order of work):
// - Tiles. A CTA's tile is (sample b, a slice of Cs channels, a range of P
//   pixels): Cs rows of P contiguous pixels of x. Cs = 32 where C % 32 == 0
//   (every UNet site), else 16 where C % 16 == 0, else 8, so that a pixel's
//   codes of the slice are whole vectors of [B, HW, C]. The tile geometry is
//   free of C / G: a slice may cut a group, and groups meet in global memory.
// - Phase 1, the statistics. CTAs (one a tile where the tiles fit the card at
//   once, else persistent CTAs walking them) sum each row of a tile (x and
//   x^2, f32) from global memory by tpr = threads / Cs lanes of one warp,
//   each lane its 16-byte vectors j, j + tpr, ... in order (four loads in
//   flight, marked evict-last in L2: phase 2 reads them again), then a
//   butterfly over the tpr lanes. Lane 0 writes the channel's partial to the
//   workspace [B, C, ranges] (float2).
// - One grid barrier. The launch is cooperative (the plan keeps the grid
//   within the blocks the card holds at once; the launch is refused
//   otherwise), so every partial is in after it.
// - Phase 2. For each of its tiles (newest first: the likeliest still in L2)
//   a CTA sums, a warp a group, the cpg x ranges partials of every group its
//   slice touches in one fixed order (lane l takes items l, l + 32, ...,
//   then a butterfly), so every CTA and every run gets the same bits (no
//   atomics); the affine parameters are loaded beside the partials, the
//   scale at the start. The tile is copied into shared memory again (from
//   L2). Each lane then takes one channel's 16-byte chunk (its table entry
//   in registers), normalizes, applies the affine and SiLU, quantizes, and
//   writes the codes into a code buffer [pixel][channel] in shared memory:
//   the transpose. Row r's chunk i sits at chunk i ^ (r & 7) of the row
//   (fewer bits in shorter rows), so the eight rows a quarter warp reads at
//   one chunk fall in eight bank groups. Then each pixel's Cs codes go out
//   as 16-byte vectors (two lanes a 32-byte sector).
// - "general" route, for every other shape (rows that are not 16-byte runs,
//   an unaligned x, C % 8 != 0 for the codes): scalar loads, the tile copied
//   in element by element for phase 2, masked byte stores where a pixel's
//   codes are not a whole vector.
// - Arithmetic: SiLU as y / (1 + exp(-y)) (ex2 and rcp), not tanh.approx,
//   whose error at y ~ 1-2.5 is a visible share of a 0.02-wide code; codes
//   by __float2int_rn (half to even) then a clamp to +-127; the statistics
//   with IEEE divisions and square root. s is read on the device (a 0-d f32
//   tensor), so the launch can be captured in a CUDA graph. The apply runs
//   two special-function-unit operations a code (ex2, rcp) at 16 a clock an
//   SM; a per-CTA trace (vd_gnq_set_trace) shows where a launch's time goes.
//
// gn_stats: one CTA a (sample, group) (vd_gn_stats_group) where a group is
// whole 16-byte vectors of an aligned x: it sums the group's contiguous
// range (four 16-byte loads in flight a thread), a butterfly in each warp and
// one over the warps, and writes the group's channels; no partials in global
// memory and no wait on other CTAs. The cooperative kernel without phase 2's
// apply (the CTA of pixel range 0 of a slice writes its channels) takes the
// other shapes on its general route.
// Measured by chip_smoke.py (kernels, gnq_sweep) on an NVIDIA H100 80GB HBM3.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// The host's description of one launch (ops/gn_silu.py::_GNQArgs mirrors
// it). Outside the anonymous namespace, so that the entry points are exported.
struct GNQArgs {
  long long hw;
  int batch, c, groups, silu, dtype, wdt, bdt;
  int route;  // 0 streaming (16-byte vectors; gn_silu_q only), 1 general
  int cs, P, threads, ranges, tiles, ctas, smem_bytes;
  float eps;
};

// vd_gn_stats_group's launch (ops/gn_silu.py::_GNSArgs)
struct GNSArgs {
  long long hw;
  int batch, c, groups, dtype, threads;
  float eps;
};

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMinBlocks = 5;     // with kMaxThreads: at most 48 registers a thread
constexpr int kMaxSmem = 232448;  // dynamic shared memory a CTA can have
constexpr int kInFlight = 4;      // loads a thread keeps in flight (phase 1)
constexpr int kStreaming = 0, kGeneral = 1;

struct Params {
  const void* x;       // [B, C, HW] of T
  int8_t* q;           // gn_silu_q: codes [B, HW, C]
  float* st;           // gn_stats: [B, 2, C]
  const void* w;       // [C] GroupNorm weight (gn_silu_q)
  const void* b;       // [C] GroupNorm bias
  const float* s_act;  // 0-d activation scale
  float2* ws;          // [B, C, ranges] per-channel (sum, sum of squares)
  long long hw;
  int C, cpg, P, ranges, slices, tiles;
  int silu, wdt, bdt, vec_store;
  int cbuf_off;        // byte offsets in shared memory: the codes of the tile [P][Cs],
  int tab_off;         // the per-channel table
  float eps, count;    // count: C / G * HW
  unsigned long long* trace;  // null, or 8 stamps a CTA (vd_gnq_set_trace)
};

template <typename T> struct Elt;
template <> struct Elt<float> {
  static __device__ __forceinline__ float f(float v) { return v; }
};
template <> struct Elt<__nv_bfloat16> {
  static __device__ __forceinline__ float f(__nv_bfloat16 v) { return __bfloat162float(v); }
};
template <> struct Elt<__half> {
  static __device__ __forceinline__ float f(__half v) { return __half2float(v); }
};

__device__ __forceinline__ float load_param(const void* p, int i, int dt) {
  if (dt == 0) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (dt == 1) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}
// a 16-byte load that L2 keeps ahead of other lines (phase 2 reads it again)
__device__ __forceinline__ uint4 ld_keep(const void* src, uint64_t policy) {
  uint4 v;
  asm volatile("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(src), "l"(policy));
  return v;
}

// the butterfly sum over the n lanes of an aligned group of lanes (n a
// power of two up to 32): every lane of the group ends with the same bits
__device__ __forceinline__ float2 lanes_sum(float2 t, int n) {
  for (int o = n >> 1; o > 0; o >>= 1) {
    t.x += __shfl_xor_sync(0xffffffffu, t.x, o);
    t.y += __shfl_xor_sync(0xffffffffu, t.y, o);
  }
  return t;
}

__device__ __forceinline__ void acc_one(float f, float& s, float& ss) {
  s += f;
  ss = fmaf(f, f, ss);
}
template <typename T>
__device__ __forceinline__ void acc_vec(const uint4& u, float& s, float& ss) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int k = 0; k < 16 / int(sizeof(T)); ++k) acc_one(Elt<T>::f(e[k]), s, ss);
}
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[16 / sizeof(T)]) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int k = 0; k < 16 / int(sizeof(T)); ++k) f[k] = Elt<T>::f(e[k]);
}

// (mean, rstd) from a group's sums, IEEE operations as the plain version's
__device__ __forceinline__ float2 finish(float2 t, float count, float eps) {
  const float mean = __fdiv_rn(t.x, count);
  const float var = fmaxf(__fsub_rn(__fdiv_rn(t.y, count), __fmul_rn(mean, mean)), 0.f);
  return make_float2(mean, __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps))));
}

// one code: SiLU (ex2 + rcp), the reciprocal scale, half to even, +-127
__device__ __forceinline__ uint32_t code(float y, float inv, int silu) {
  if (silu) y = __fdividef(y, 1.0f + __expf(-y));
  const int v = min(127, max(-127, __float2int_rn(y * inv)));
  return static_cast<uint32_t>(v) & 0xffu;
}

struct Tile {
  int b, s, pr;
};
__device__ __forceinline__ Tile tile_of(int t, int ranges, int slices) {
  Tile r;
  r.pr = t % ranges;
  const int bs = t / ranges;
  r.s = bs % slices;
  r.b = bs / slices;
  return r;
}

// kCs channels a slice, kVec: 16-byte vectors of x (else scalar loads), kQ:
// gn_silu_q (else gn_stats, which takes scalar loads only: a group of whole
// vectors takes gn_stats_group_kernel)
template <typename T, int kCs, bool kVec, bool kQ>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks) gnq_kernel(const __grid_constant__ Params p) {
  static_assert(kQ || !kVec, "gn_stats' cooperative kernel takes scalar loads");
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);                         // [kCs][P] (gn_silu_q)
  uint8_t* cbuf = smem + p.cbuf_off;                            // [P][kCs] the tile's codes
  float4* tab = reinterpret_cast<float4*>(smem + p.tab_off);    // [kCs] (rstd w, mean, bias)
  float2* gst = reinterpret_cast<float2*>(tab + kCs);           // [kCs] the groups' (mean, rstd)
  // row r's 16-byte chunk i sits at chunk i ^ (r & swz) of the row, so that
  // the eight rows a quarter warp reads at one chunk hit eight bank groups
  const int swz = min(p.P / V, 8) - 1;
  auto chunk = [&](int r, int i) { return tile + r * p.P + ((i ^ (r & swz)) * V); };
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = nthr >> 5;
  const int tpr = nthr / kCs, row = tid / tpr, j = tid % tpr;  // a row's lanes, in one warp
  const long long hw = p.hw;
  const int C = p.C, P = p.P, NP = p.ranges;
  const T* x = static_cast<const T*>(p.x);
  // trace: the CTA's start, phase 1 done, the grid barrier passed, its first
  // phase-2 tile's statistics, its codes, its end (ns), and its SM
  unsigned long long* tr = p.trace ? p.trace + 8 * blockIdx.x : nullptr;
  if (tr && tid == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    tr[0] = global_ns();
    tr[7] = sm;
  }
  const float inv = kQ ? 1.f / __ldg(p.s_act) : 0.f;  // asked first: it meets phase 2
  uint64_t keep = 0;
  if constexpr (kVec)
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(keep));

  // ---- phase 1: every tile's per-channel partial sums ----
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const Tile tl = tile_of(t, NP, p.slices);
    const int c = tl.s * kCs + row;
    const long long p0 = static_cast<long long>(tl.pr) * P;
    const int np = static_cast<int>(min(static_cast<long long>(P), hw - p0));
    float sx = 0.f, sxx = 0.f;
    if (c < C) {
      const T* src = x + (static_cast<long long>(tl.b) * C + c) * hw + p0;
      const int n = kVec ? np / V : np;  // vectors, or elements
      for (int i = j; i < n;) {          // kInFlight loads, then their sums in order
        uint4 u[kInFlight];
        float f[kInFlight];
        int m = 0;
#pragma unroll
        for (int k = 0; k < kInFlight; ++k)
          if (i < n) {
            if constexpr (kVec) u[k] = ld_keep(src + i * V, keep);
            else f[k] = Elt<T>::f(src[i]);
            m = k + 1;
            i += tpr;
          }
#pragma unroll
        for (int k = 0; k < kInFlight; ++k)
          if (k < m) {
            if constexpr (kVec) acc_vec<T>(u[k], sx, sxx);
            else acc_one(f[k], sx, sxx);
          }
      }
    }
    const float2 r = lanes_sum(make_float2(sx, sxx), tpr);
    if (j == 0 && c < C) p.ws[(static_cast<long long>(tl.b) * C + c) * NP + tl.pr] = r;
  }
  if (tr && tid == 0) tr[1] = global_ns();
  cg::this_grid().sync();  // every tile's partials are in
  if (tr && tid == 0) tr[2] = global_ns();

  // ---- phase 2: this CTA's tiles, newest first ----
  const int mine = (p.tiles - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x);
  for (int t = blockIdx.x + mine * gridDim.x; t >= static_cast<int>(blockIdx.x); t -= gridDim.x) {
    const Tile tl = tile_of(t, NP, p.slices);
    if (!kQ && tl.pr != 0) continue;  // gn_stats: the CTA of pixel range 0 writes
    const int c0 = tl.s * kCs, cl = min(c0 + kCs, C) - 1;
    const int g0 = c0 / p.cpg, ng = cl / p.cpg - g0 + 1;
    float wc = 0.f, bc = 0.f;  // the affine of channel c0 + tid, loaded beside the partials
    if (kQ && tid < kCs && c0 + tid < C) {
      wc = load_param(p.w, c0 + tid, p.wdt);
      bc = load_param(p.b, c0 + tid, p.bdt);
    }
    __syncthreads();  // the last tile's table, tile and codes are read
    for (int g = warp; g < ng; g += nwarps) {  // a warp a group, in one fixed order
      const float2* part =
          p.ws + (static_cast<long long>(tl.b) * C + static_cast<long long>(g0 + g) * p.cpg) * NP;
      const int n = p.cpg * NP;
      float a = 0.f, q = 0.f;
      for (int i = lane; i < n; i += 32) {
        const float2 v = __ldcg(part + i);
        a += v.x;
        q += v.y;
      }
      const float2 tot = lanes_sum(make_float2(a, q), 32);
      if (lane == 0) gst[g] = finish(tot, p.count, p.eps);
    }
    __syncthreads();
    if (tr && tid == 0 && t == static_cast<int>(blockIdx.x) + mine * static_cast<int>(gridDim.x))
      tr[3] = global_ns();
    if constexpr (!kQ) {
      if (tid < kCs && c0 + tid < C) {
        const float2 m = gst[(c0 + tid) / p.cpg - g0];
        p.st[static_cast<long long>(tl.b) * 2 * C + c0 + tid] = m.x;
        p.st[static_cast<long long>(tl.b) * 2 * C + C + c0 + tid] = m.y;
      }
    } else {
      if (tid < kCs) {
        const float2 m = c0 + tid < C ? gst[(c0 + tid) / p.cpg - g0] : make_float2(0.f, 0.f);
        tab[tid] = make_float4(__fmul_rn(m.y, wc), m.x, bc, 0.f);
      }
      const long long p0 = static_cast<long long>(tl.pr) * P;
      const int np = static_cast<int>(min(static_cast<long long>(P), hw - p0));
      const int c = c0 + row;  // the tile again (from L2 where phase 1 kept it)
      if (c < C) {
        const T* src = x + (static_cast<long long>(tl.b) * C + c) * hw + p0;
        if constexpr (kVec) {
          for (int i = j; i < np / V; i += tpr) cp_async16(chunk(row, i), src + i * V);
        } else {
          for (int i = j; i < np; i += tpr) chunk(row, i / V)[i % V] = src[i];
        }
      }
      if constexpr (kVec) cp_async_wait_all();
      __syncthreads();  // the table, and the tile
      const int silu = p.silu;
      int8_t* qb = p.q + (static_cast<long long>(tl.b) * hw + p0) * C + c0;
      // a lane a (row, chunk): V elements of one channel, its table entry in
      // registers; the codes go to the code buffer transposed, [pixel][channel]
      // (a warp's lanes write one pixel's consecutive channels at a time)
      const int nch = (np + V - 1) / V;
      for (int k = tid; k < kCs * nch; k += nthr) {
        const int r = k % kCs, i = k / kCs;
        const float4 e = tab[r];
        float f[V];
        unpack<T>(*reinterpret_cast<const uint4*>(chunk(r, i)), f);
        uint8_t* cb = cbuf + i * V * kCs + r;
#pragma unroll
        for (int u = 0; u < V; ++u)
          cb[u * kCs] = static_cast<uint8_t>(code(fmaf(f[u] - e.y, e.x, e.z), inv, silu));
      }
      __syncthreads();  // the codes
      if (tr && tid == 0) tr[4] = global_ns();
      if (p.vec_store) {  // each pixel's run in 16-byte (Cs = 8: 8-byte) pieces
        constexpr int kPiece = kCs >= 16 ? 16 : 8, kPieces = kCs / kPiece;
        for (int k = tid; k < np * kPieces; k += nthr) {
          const int px = k / kPieces, piece = k % kPieces;
          int8_t* dst = qb + static_cast<long long>(px) * C + piece * kPiece;
          const uint8_t* src = cbuf + px * kCs + piece * kPiece;
          if constexpr (kPiece == 16)
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
          else
            *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
        }
      } else {  // a pixel's codes are not a whole vector: bytes, masked
        for (int k = tid; k < np * kCs; k += nthr) {
          const int px = k / kCs, r = k % kCs;
          if (c0 + r < C) qb[static_cast<long long>(px) * C + r] = static_cast<int8_t>(cbuf[k]);
        }
      }
    }
  }
  if (tr && tid == 0) tr[5] = global_ns();
}

// ---- gn_stats where a group is whole 16-byte vectors: a CTA a (sample, group) ----

struct SParams {
  const void* x;
  float* st;
  long long len;  // elements a group: cpg * HW
  int C, cpg, groups;
  float eps;
};

// The CTA sums its group's contiguous range (16-byte vectors t, t + threads,
// ..., four in flight), a butterfly in each warp and one over the warps, and
// writes the group's channels.
template <typename T>
__global__ void __launch_bounds__(512) gn_stats_group_kernel(const __grid_constant__ SParams p) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float2 red[16];  // the warps' partials
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int bg = static_cast<int>(blockIdx.x);
  const uint4* src = reinterpret_cast<const uint4*>(static_cast<const T*>(p.x) +
                                                    static_cast<long long>(bg) * p.len);
  const long long nv = p.len / V;
  float sx = 0.f, sxx = 0.f;
  for (long long i = tid; i < nv;) {
    uint4 u[kInFlight];
    int n = 0;
#pragma unroll
    for (int k = 0; k < kInFlight; ++k)
      if (i < nv) {
        u[k] = __ldg(src + i);
        n = k + 1;
        i += blockDim.x;
      }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k)
      if (k < n) acc_vec<T>(u[k], sx, sxx);
  }
  float2 t = lanes_sum(make_float2(sx, sxx), 32);
  if (lane == 0) red[warp] = t;
  __syncthreads();
  if (warp == 0) {
    t = lanes_sum(lane < nwarps ? red[lane] : make_float2(0.f, 0.f), 32);
    const float2 m = finish(t, static_cast<float>(p.len), p.eps);
    const int b = bg / p.groups, g = bg % p.groups;
    for (int c = g * p.cpg + lane; c < (g + 1) * p.cpg; c += 32) {
      p.st[static_cast<long long>(b) * 2 * p.C + c] = m.x;
      p.st[static_cast<long long>(b) * 2 * p.C + p.C + c] = m.y;
    }
  }
}

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The launch's shared memory: the tile and the tile's codes (gn_silu_q),
// then the per-channel table (float4) and the groups' statistics (float2),
// Cs of each. ops/gn_silu.py::gnq_smem_bytes computes the same.
int cbuf_offset(int cs, int P, int es) { return round_up(cs * P * es, 16); }
int tab_offset(int q, int cs, int P, int es) {
  return q ? cbuf_offset(cs, P, es) + round_up(cs * P, 16) : 0;
}
long long smem_bytes(int q, int cs, int P, int es) {
  return static_cast<long long>(tab_offset(q, cs, P, es)) + 24LL * cs;
}

// One instantiation of the kernel: its residency on the current device and
// its cooperative launch.
template <typename T, int kCs, bool kVec, bool kQ>
struct Kern {
  // blocks an SM holds at `threads` threads and `smem` bytes, and the SMs:
  // asked once a (device, threads, smem)
  static cudaError_t residency(int threads, int smem, int* per_sm, int* sms) {
    static int last[32][3];  // a device's last (threads, smem, blocks an SM)
    static int sm_count[32];
    int dev = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc != cudaSuccess) return rc;
    if (dev >= 32) return cudaErrorInvalidDevice;
    if (!sm_count[dev]) {
      rc = cudaFuncSetAttribute(gnq_kernel<T, kCs, kVec, kQ>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (rc == cudaSuccess)
        rc = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
      if (rc != cudaSuccess) return rc;
    }
    int* l = last[dev];
    if (l[0] != threads || l[1] != smem) {
      int n = 0;
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gnq_kernel<T, kCs, kVec, kQ>,
                                                         threads, smem);
      if (rc != cudaSuccess) return rc;
      l[0] = threads;
      l[1] = smem;
      l[2] = n;
    }
    *per_sm = l[2];
    *sms = sm_count[dev];
    return cudaSuccess;
  }

  static cudaError_t launch(const Params& p, int ctas, int threads, int smem,
                            cudaStream_t stream) {
    int per_sm = 0, sms = 0;
    cudaError_t rc = residency(threads, smem, &per_sm, &sms);
    if (rc != cudaSuccess) return rc;
    if (ctas > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;  // never a second wave
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(ctas, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    rc = cudaLaunchKernelEx(&cfg, gnq_kernel<T, kCs, kVec, kQ>, p);
    if (rc != cudaSuccess) return rc;
    return cudaGetLastError();
  }
};

template <typename T> struct Type { using type = T; };

// f(Kern<T, cs, vec, kQ>{}) for the dtype code (0 bf16, 1 f16, 2 f32); the
// statistics take cs 16 or 8 on scalar loads
template <bool kQ, typename F>
cudaError_t select(int dtype, int cs, bool vec, F f) {
  auto pick = [&](auto tag) -> cudaError_t {
    using T = typename decltype(tag)::type;
    if constexpr (kQ) {
      if (cs == 32) return vec ? f(Kern<T, 32, true, true>{}) : f(Kern<T, 32, false, true>{});
      if (cs == 16) return vec ? f(Kern<T, 16, true, true>{}) : f(Kern<T, 16, false, true>{});
      return vec ? f(Kern<T, 8, true, true>{}) : f(Kern<T, 8, false, true>{});
    } else {
      return cs == 16 ? f(Kern<T, 16, false, false>{}) : f(Kern<T, 8, false, false>{});
    }
  };
  if (dtype == 0) return pick(Type<__nv_bfloat16>{});
  if (dtype == 1) return pick(Type<__half>{});
  return pick(Type<float>{});
}

unsigned long long* g_trace = nullptr;  // vd_gnq_set_trace

// Checks a plan against this source's own derivation (gnq_plan's rules) and
// fills the kernel's parameters; false for a plan it cannot take.
bool plan_ok(const GNQArgs* a, bool q_mode, const void* x, const void* q, Params* p) {
  if (a->dtype < 0 || a->dtype > 2) return false;
  if (q_mode && (a->wdt < 0 || a->wdt > 2 || a->bdt < 0 || a->bdt > 2)) return false;
  const int es = a->dtype == 2 ? 4 : 2, V = 16 / es;
  const long long hw = a->hw;
  const int c = a->c, groups = a->groups, cs = a->cs, P = a->P, threads = a->threads;
  if (a->batch < 1 || groups < 1 || c < 1 || c % groups || hw < 1) return false;
  // gnq_plan: 32 where C % 32 == 0, else 16 where C % 16 == 0, else 8 (the
  // statistics: 16 or 8); gnq_sweep measures the others
  if (cs != 8 && cs != 16 && !(cs == 32 && q_mode)) return false;
  if (threads != 128 && threads != 256) return false;
  const int tpr = threads / cs;
  if (tpr < 4 || tpr > 32) return false;
  const int route = a->route;
  if (route != kStreaming && route != kGeneral) return false;
  const bool vec = route == kStreaming;
  if (vec && !q_mode) return false;  // a group of whole vectors takes vd_gn_stats_group
  if (P < 1) return false;
  if (P % V) return false;  // whole 16-byte chunks of a tile row
  if (vec && (reinterpret_cast<uintptr_t>(x) % 16 || (hw * es) % 16 || c % 8)) return false;
  const long long ranges = (hw + P - 1) / P;
  const int slices = (c + cs - 1) / cs;
  if (ranges != a->ranges || static_cast<long long>(a->batch) * slices * ranges != a->tiles)
    return false;
  if (a->ctas < 1 || a->ctas > a->tiles) return false;
  if (smem_bytes(q_mode, cs, P, es) != a->smem_bytes || a->smem_bytes > kMaxSmem) return false;
  p->x = x;
  p->hw = hw;
  p->C = c;
  p->cpg = c / groups;
  p->P = P;
  p->ranges = static_cast<int>(ranges);
  p->slices = slices;
  p->tiles = a->tiles;
  p->silu = a->silu;
  p->wdt = a->wdt;
  p->bdt = a->bdt;
  p->vec_store = q_mode && c % cs == 0 && reinterpret_cast<uintptr_t>(q) % cs == 0;
  p->cbuf_off = cbuf_offset(cs, P, es);
  p->tab_off = tab_offset(q_mode, cs, P, es);
  p->eps = a->eps;
  p->count = static_cast<float>(static_cast<long long>(c / groups) * hw);
  p->trace = g_trace;
  return true;
}

template <bool kQ>
int run(const Params& p, const GNQArgs* a, void* stream) {
  return select<kQ>(a->dtype, a->cs, a->route == kStreaming, [&](auto k) {
    return decltype(k)::launch(p, a->ctas, a->threads, a->smem_bytes,
                               static_cast<cudaStream_t>(stream));
  });
}

}  // namespace

// GroupNorm(+SiLU) + int8 quantize of x [batch, c, hw] (contiguous; dtype 0
// bf16, 1 f16, 2 f32; weight and bias of dtypes wdt, bdt) into codes q
// [batch, hw, c] with the scale *s_act; ws holds batch * c * ranges float2.
// Returns cudaErrorInvalidValue (1) for a plan this source does not derive,
// cudaErrorCooperativeLaunchTooLarge where the grid would not be resident at
// once, else the launch's cudaGetLastError().
extern "C" int vd_gn_silu_q(const void* x, void* q, const void* w, const void* b,
                            const float* s_act, void* ws, const GNQArgs* a, void* stream) {
  Params p = {};
  if (!plan_ok(a, true, x, q, &p)) return cudaErrorInvalidValue;
  p.q = static_cast<int8_t*>(q);
  p.w = w;
  p.b = b;
  p.s_act = s_act;
  p.ws = static_cast<float2*>(ws);
  return run<true>(p, a, stream);
}

// GroupNorm statistics of x [batch, c, hw] into st [batch, 2, c] f32
// (channel-broadcast mean, rstd) on the cooperative kernel's general route;
// the same plan rules and return codes.
extern "C" int vd_gn_stats(const void* x, float* st, void* ws, const GNQArgs* a, void* stream) {
  Params p = {};
  if (!plan_ok(a, false, x, nullptr, &p)) return cudaErrorInvalidValue;
  p.st = st;
  p.ws = static_cast<float2*>(ws);
  return run<false>(p, a, stream);
}

// Later cooperative launches stamp %globaltimer (ns) at each phase of every
// CTA into trace[8 * cta + i] (i: 0 start, 1 phase 1 done, 2 the grid
// barrier passed, 3 the first phase-2 tile's statistics, 4 its codes, 5 end,
// 7 the SM), room for every CTA of the launch; null stops it. For profiling.
extern "C" void vd_gnq_set_trace(void* trace) {
  g_trace = static_cast<unsigned long long*>(trace);
}

// Blocks an SM holds of the cooperative kernel of (q, dtype, cs, route) at
// `threads` threads and `smem` bytes (what gnq_plan assumes, for checking
// it); -1 on an error.
extern "C" int vd_gnq_blocks_per_sm(int q, int dtype, int cs, int route, int threads, int smem) {
  int per_sm = 0, sms = 0;
  auto ask = [&](auto k) { return decltype(k)::residency(threads, smem, &per_sm, &sms); };
  const bool vec = route == kStreaming;
  const cudaError_t rc =
      q ? select<true>(dtype, cs, vec, ask) : select<false>(dtype, cs, vec, ask);
  return rc == cudaSuccess ? per_sm : -1;
}

// gn_stats by one CTA a (sample, group): x 16-byte aligned, a group (C / G *
// HW elements) whole 16-byte vectors, threads 128-512 in whole warps.
// Returns cudaErrorInvalidValue otherwise, else the launch's
// cudaGetLastError().
extern "C" int vd_gn_stats_group(const void* x, float* st, const GNSArgs* a, void* stream) {
  const int es = a->dtype == 2 ? 4 : 2;
  if (a->dtype < 0 || a->dtype > 2 || a->batch < 1 || a->groups < 1 || a->c % a->groups ||
      a->hw < 1)
    return cudaErrorInvalidValue;
  const int cpg = a->c / a->groups;
  const long long len = static_cast<long long>(cpg) * a->hw;
  if (len % (16 / es) || reinterpret_cast<uintptr_t>(x) % 16 || a->threads < 128 ||
      a->threads > 512 || a->threads % 32)
    return cudaErrorInvalidValue;
  SParams p;
  p.x = x;
  p.st = st;
  p.len = len;
  p.C = a->c;
  p.cpg = cpg;
  p.groups = a->groups;
  p.eps = a->eps;
  const dim3 grid(a->batch * a->groups), block(a->threads);
  const cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  if (a->dtype == 0) gn_stats_group_kernel<__nv_bfloat16><<<grid, block, 0, stream_>>>(p);
  else if (a->dtype == 1) gn_stats_group_kernel<__half><<<grid, block, 0, stream_>>>(p);
  else gn_stats_group_kernel<float><<<grid, block, 0, stream_>>>(p);
  return cudaGetLastError();
}
