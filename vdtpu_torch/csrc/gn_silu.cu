// GroupNorm(+SiLU) for Hopper (sm_90a): one launch a call, each group
// reduced inside a thread-block cluster.
//
// Replaces: vdtpu/ops/pallas/gn_silu.py::_kernel (row 6 of the kernel table,
// reached through _fused_impl): per sample and group, f32 statistics
// E[x^2] - E[x]^2 (clipped at 0), then normalize, the per-channel affine and
// an optional SiLU, in x's dtype.
//
// Bound on this card: bytes. It reads x once and writes y once (at
// [4, 320, 64, 64] bf16 21.0 MB, 0.0063 ms at 3.35 TB/s). The TPU kernel held a whole
// sample in VMEM; an SM holds at most 227 KB, and a group of the VAE's 512^2
// maps is 2 MB in bf16. The Triton design it succeeds read x twice (a
// statistics launch, then an apply launch that re-read x) and paid two
// launches a call.
//
// Design (the geometry is vdtpu_torch/ops/gn_silu.py::gn_plan, checked on the
// CPU by tests/test_torch_gn_plan.py, whose blocked model follows this order
// of work):
// - In NCHW a run of whole groups of one sample (a band of gpb groups,
//   bandc = gpb * C / G channels) is one contiguous range of memory. A
//   cluster of k CTAs owns one band; CTA rank r takes the band's pixels
//   [r P, (r + 1) P), P = HW / k, of every channel ("rows" layout: one row
//   of P pixels a channel), or, with k = 1 and rows that are not 16-byte
//   runs (the text diffuser's [8, C, 1] and [8, C, 4] sites, odd maps), the
//   band as one flat range ("flat" layout).
// - Resident route: the CTA brings its share into shared memory with 16-byte
//   cp.async copies, each issued by the thread that will sum that vector, so
//   a thread waits for its own copies only (the flat range's ragged ends by
//   plain loads). The flat range lands at the same address modulo 16 as in
//   global memory, so 16-byte vectors line up in both. (Bulk copies on an
//   mbarrier, one a row, read slower in development runs at every UNet
//   site, the small maps most.)
// - Each group of the CTA is summed (x and x^2, f32) by a team of warps: a
//   thread's items in order, a shuffle butterfly in each warp, then one over
//   the team's warp partials. With k > 1 the CTAs' partials are combined
//   through distributed shared memory after a cluster barrier: a warp of
//   every CTA reads the k partials of a group and sums them by the same
//   butterfly, so every CTA gets the same sums and a run the same bits as
//   the last one (no atomics). The CTA then normalizes from shared memory
//   and stores 16-byte vectors: x is read once and y written once, in one
//   launch. The second cluster barrier (peers' partials read) is waited for
//   only at the end.
// - Streaming route (one launch too), where the resident CTAs would not fit
//   the card at once (the VAE's maps from 128^2 on): a second wave of
//   resident CTAs would leave memory idle while the first wave applies, and a
//   2 MB group needs 16 CTAs of 128 KB. Persistent clusters walk the bands.
//   A CTA sums its share from global memory (eight 16-byte loads in flight a
//   thread, marked evict-last in L2), the cluster combines the partials as
//   above, and a second pass normalizes (its loads and stores marked
//   streaming). Its time follows the CTAs in flight (PERF.md).
// - SiLU: y / (1 + exp(-y)) (two MUFU operations) for f32 outputs; for bf16
//   and f16 outputs y (1 + tanh(y / 2)) / 2 with tanh.approx (one), which
//   halves the apply phase at the UNet's sites; its error (2^-11 of tanh) is
//   a fraction of a 16-bit output's rounding.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>


// The host's description of one launch (ops/gn_silu.py::_GNArgs mirrors it).
// Outside the anonymous namespace, so that vd_gn_silu is exported.
struct GNArgs {
  long long hw;
  int batch, c, groups, silu, dtype, wdt, bdt, resident, k, gpb, P, rows, threads, smem_bytes;
  int clusters;  // clusters launched: the bands (resident), or fewer that walk them (streaming)
  float eps;
};

namespace {

constexpr int kMaxCluster = 16;   // CTAs a band (above 8: a non-portable cluster)
constexpr int kMaxSmem = 232448;  // dynamic shared memory a CTA can have

struct Params {
  const void* x;
  void* y;             // x's dtype [B, C, HW]
  const void* w;       // [C] GroupNorm weight
  const void* b;       // [C] GroupNorm bias
  long long hw;        // pixels a channel
  int c, cpg;          // channels, channels a group
  int gpb, bps;        // groups a band, bands a sample
  int bands;           // bands of the launch (B * G / gpb)
  int k, P;            // CTAs a band (the cluster), pixels a CTA
  int rows;            // 1: rows layout, 0: flat layout
  int silu;
  int wdt, bdt;        // weight's and bias's dtype: 0 bf16, 1 f16, 2 f32
  float eps, inv_count;  // inv_count: 1 / (C / G * HW)
  int bandc;           // channels a band
  int wpt;             // warps of a group's reduction team
  int tile_off;        // byte offset of the tile in shared memory
};

template <typename T> struct Elt;
template <> struct Elt<float> {
  static __device__ __forceinline__ float f(float v) { return v; }
  static __device__ __forceinline__ float t(float v) { return v; }
};
template <> struct Elt<__nv_bfloat16> {
  static __device__ __forceinline__ float f(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 t(float v) { return __float2bfloat16_rn(v); }
};
template <> struct Elt<__half> {
  static __device__ __forceinline__ float f(__half v) { return __half2float(v); }
  static __device__ __forceinline__ __half t(float v) { return __float2half_rn(v); }
};

__device__ __forceinline__ float load_param(const void* p, int i, int dt) {
  if (dt == 0) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (dt == 1) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the float2 at a shared::cta address in the cluster's CTA `rank`
__device__ __forceinline__ float2 ld_cluster_f2(uint32_t addr, uint32_t rank) {
  float2 v;
  asm volatile(
      "{\n.reg .b32 remote;\nmapa.shared::cluster.u32 remote, %2, %3;\n"
      "ld.shared::cluster.v2.f32 {%0, %1}, [remote];\n}\n"
      : "=f"(v.x), "=f"(v.y)
      : "r"(addr), "r"(rank)
      : "memory");
  return v;
}
// a 16-byte load that L2 keeps ahead of other lines (the streaming route's
// first pass: its second pass reads the band again)
__device__ __forceinline__ uint4 ld_keep(const void* src, uint64_t policy) {
  uint4 v;
  asm volatile("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(src), "l"(policy));
  return v;
}
// the butterfly sum over a warp's lanes: every lane ends with the same bits
__device__ __forceinline__ float2 warp_sum(float2 t) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    t.x += __shfl_xor_sync(0xffffffffu, t.x, o);
    t.y += __shfl_xor_sync(0xffffffffu, t.y, o);
  }
  return t;
}

__device__ __forceinline__ float tanh_approx(float v) {
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(v));
  return t;
}
template <bool kFast>
__device__ __forceinline__ float act(float y, int silu) {
  if (!silu) return y;
  if constexpr (kFast) return y * fmaf(tanh_approx(0.5f * y), 0.5f, 0.5f);
  return __fdividef(y, 1.0f + __expf(-y));
}
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[16 / sizeof(T)]) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int j = 0; j < 16 / int(sizeof(T)); ++j) f[j] = Elt<T>::f(e[j]);
}
template <typename T>
__device__ __forceinline__ uint4 pack(const float (&f)[16 / sizeof(T)]) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int j = 0; j < 16 / int(sizeof(T)); ++j) e[j] = Elt<T>::t(f[j]);
  return u;
}
template <typename T>
__device__ __forceinline__ void acc_vec(const uint4& u, float& s, float& ss) {
  float f[16 / sizeof(T)];
  unpack<T>(u, f);
#pragma unroll
  for (int j = 0; j < 16 / int(sizeof(T)); ++j) {
    s += f[j];
    ss = fmaf(f[j], f[j], ss);
  }
}
__device__ __forceinline__ void acc_one(float f, float& s, float& ss) {
  s += f;
  ss = fmaf(f, f, ss);
}

// A walk over items of `per` a row, from item `start` by `step`, keeping
// (row, col) without a division a step.
struct Walk {
  int row, col, drow, dcol, per;
  __device__ __forceinline__ Walk(int start, int step, int per_)
      : row(start / per_), col(start % per_), drow(step / per_), dcol(step % per_), per(per_) {}
  __device__ __forceinline__ void next() {
    row += drow;
    col += dcol;
    if (col >= per) {
      col -= per;
      ++row;
    }
  }
};

template <typename T, bool kResident>
__global__ void __launch_bounds__(512) gn_kernel(const __grid_constant__ Params p) {
  constexpr int V = 16 / sizeof(T);   // elements a 16-byte vector
  constexpr int kInFlight = kResident ? 4 : 8;  // vectors a thread loads at once
  constexpr bool kFast = sizeof(T) == 2;  // the one-MUFU SiLU for 16-bit outputs
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, nthr = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = nthr >> 5;
  const int k = p.k, rank = static_cast<int>(blockIdx.x) % k;
  const int gpb = p.gpb, cpg = p.cpg, bandc = p.bandc, P = p.P, wpt = p.wpt;
  const long long hw = p.hw;
  const long long pix0 = static_cast<long long>(rank) * P;  // the CTA's first pixel
  const T* x = static_cast<const T*>(p.x);
  T* y = static_cast<T*>(p.y);

  float2* part = reinterpret_cast<float2*>(smem);    // [gpb * wpt] the teams' warp partials
  float2* red = part + gpb * wpt;                    // [gpb] this CTA's partials
  float* tab = reinterpret_cast<float*>(red + gpb);  // [3][bandc]: w (then rstd w), mean, bias
  T* tile = reinterpret_cast<T*>(smem + p.tile_off);

  // the reduction teams: wpt warps a group
  const int teams = nwarps / wpt, team = warp / wpt;
  const int tt = (warp % wpt) * 32 + lane, tsz = wpt * 32, pv = P / V;
  bool peers_reading = false;  // a cluster arrive not yet waited for
  uint64_t keep = 0;           // streaming: the first pass's L2 policy
  if constexpr (!kResident)
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(keep));

  // a resident launch has a cluster a band; the streaming route's clusters
  // walk the bands, so that a band's two passes meet in L2
  for (int band = blockIdx.x / k; band < p.bands; band += gridDim.x / k) {
    const int c0 = (band % p.bps) * bandc;
    const long long chan0 = static_cast<long long>(band / p.bps) * p.c + c0;  // first channel
    // flat layout: the band's elements [gbase, gbase + nflat); tile element
    // i (global gbase + i) sits at tile[shift + i], the same address modulo 16
    const long long gbase = chan0 * hw;
    const int nflat = p.rows ? 0 : bandc * static_cast<int>(hw);
    const int shift =
        p.rows ? 0 : static_cast<int>((reinterpret_cast<uintptr_t>(x + gbase) & 15) / sizeof(T));
    const int head = p.rows ? 0 : min(nflat, (V - shift) % V);  // elements before the first vector
    const int nbody = p.rows ? 0 : (nflat - head) / V;          // whole vectors
    const int tail0 = head + nbody * V;                         // elements after them
    const T* xrow = x + gbase + pix0;  // rows layout: row r of the share at xrow + r * hw

    // ---- the CTA's share into shared memory (resident route) ----
    if constexpr (kResident) {
      if (p.rows) {  // each team thread copies the vectors it will sum
        if (team < teams)
          for (int g = team; g < gpb; g += teams)
            for (Walk it(tt, tsz, pv); it.row < cpg; it.next()) {
              const int r = g * cpg + it.row;
              cp_async16(tile + r * P + it.col * V, xrow + r * hw + it.col * V);
            }
      } else {
        for (int v = tid; v < nbody; v += nthr)
          cp_async16(tile + shift + head + v * V, x + gbase + head + v * V);
        for (int i = tid; i < head; i += nthr) tile[shift + i] = x[gbase + i];
        for (int i = tail0 + tid; i < nflat; i += nthr) tile[shift + i] = x[gbase + i];
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    // the affine parameters, while x arrives
    for (int c = tid; c < bandc; c += nthr) {
      tab[c] = load_param(p.w, c0 + c, p.wdt);
      tab[2 * bandc + c] = load_param(p.b, c0 + c, p.bdt);
    }
    if constexpr (kResident) {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      if (!p.rows) __syncthreads();  // the flat range is summed by other threads than copied it
    }

    // ---- per-group sums: a thread's items in order, a butterfly in the warp ----
    if (team < teams) {
      for (int g = team; g < gpb; g += teams) {
        float s = 0.f, ss = 0.f;
        if (p.rows) {
          const T* src = kResident ? tile + g * cpg * P : xrow + g * cpg * hw;
          const long long stride = kResident ? P : hw;  // elements from one row to the next
          Walk it(tt, tsz, pv);
          while (it.row < cpg) {  // kInFlight loads, then their sums in order
            uint4 u[kInFlight];
            int n = 0;
#pragma unroll
            for (int j = 0; j < kInFlight; ++j)
              if (it.row < cpg) {
                const uint4* a = reinterpret_cast<const uint4*>(src + it.row * stride + it.col * V);
                u[j] = kResident ? *a : ld_keep(a, keep);
                n = j + 1;
                it.next();
              }
#pragma unroll
            for (int j = 0; j < kInFlight; ++j)
              if (j < n) acc_vec<T>(u[j], s, ss);
          }
        } else {  // flat: the group's elements [g L, (g + 1) L) of the band
          const int L = cpg * static_cast<int>(hw), a = g * L, e = a + L;
          const int va = max(a, head) - head, ve = min(e, tail0) - head;  // whole vectors inside
          const int v0 = (va + V - 1) / V, v1 = ve > 0 ? ve / V : 0;
          for (int v = v0 + tt; v < v1; v += tsz)
            acc_vec<T>(*reinterpret_cast<const uint4*>(tile + shift + head + v * V), s, ss);
          const int lo = v1 > v0 ? head + v0 * V : e;  // elements outside those vectors
          const int hi = v1 > v0 ? head + v1 * V : e;
          for (int i = a + tt; i < lo; i += tsz) acc_one(Elt<T>::f(tile[shift + i]), s, ss);
          for (int i = hi + tt; i < e; i += tsz) acc_one(Elt<T>::f(tile[shift + i]), s, ss);
        }
        const float2 t = warp_sum(make_float2(s, ss));
        if (lane == 0) part[g * wpt + warp % wpt] = t;
      }
    }
    __syncthreads();  // the warp partials; with the rows layout also every thread's copies

    // ---- statistics: a warp a group sums its team's partials (and with k >
    // 1, after a cluster barrier, the cluster's) by a butterfly ----
    auto finish = [&](int g, float2 t) {
      const float mean = t.x * p.inv_count;
      const float rstd = rsqrtf(fmaxf(t.y * p.inv_count - mean * mean, 0.f) + p.eps);
      for (int c = g * cpg + lane; c < (g + 1) * cpg; c += 32) {
        tab[c] *= rstd;
        tab[bandc + c] = mean;
      }
    };
    if (peers_reading) cluster_wait();  // the peers have read the last band's partials
    for (int g = warp; g < gpb; g += nwarps) {
      const float2 t = warp_sum(lane < wpt ? part[g * wpt + lane] : make_float2(0.f, 0.f));
      if (k == 1)
        finish(g, t);
      else if (lane == 0)
        red[g] = t;
    }
    if (k > 1) {
      cluster_arrive();
      cluster_wait();
      for (int g = warp; g < gpb; g += nwarps)
        finish(g, warp_sum(lane < k ? ld_cluster_f2(smem_u32(red + g), lane)
                                    : make_float2(0.f, 0.f)));
      cluster_arrive();  // this CTA has read its peers' partials
      peers_reading = true;
    }
    __syncthreads();

    // ---- normalize, affine, SiLU; store y ----
    if (p.rows) {
      const T* src = kResident ? tile : xrow;
      const long long stride = kResident ? P : hw;
      Walk it(tid, nthr, pv);
      while (it.row < bandc) {  // kInFlight loads, then their applies
        uint4 u[kInFlight];
        Walk at = it;
        int n = 0;
#pragma unroll
        for (int j = 0; j < kInFlight; ++j)
          if (it.row < bandc) {
            const uint4* a = reinterpret_cast<const uint4*>(src + it.row * stride + it.col * V);
            u[j] = kResident ? *a : __ldcs(a);
            n = j + 1;
            it.next();
          }
#pragma unroll
        for (int j = 0; j < kInFlight; ++j)
          if (j < n) {
            const int c = at.row;
            float f[V];
            unpack<T>(u[j], f);
            const float sc = tab[c], mu = tab[bandc + c], bi = tab[2 * bandc + c];
#pragma unroll
            for (int e = 0; e < V; ++e) f[e] = act<kFast>(fmaf(f[e] - mu, sc, bi), p.silu);
            uint4* dst = reinterpret_cast<uint4*>(y + gbase + c * hw + pix0 + at.col * V);
            if constexpr (kResident)
              *dst = pack<T>(f);
            else
              __stcs(dst, pack<T>(f));  // streamed out: L2 keeps x's lines
            at.next();
          }
      }
    } else if constexpr (kResident) {  // flat: the channel of each element by division
      auto one = [&](int i, float v) -> float {
        const int c = i / static_cast<int>(hw);
        return act<kFast>(fmaf(v - tab[bandc + c], tab[c], tab[2 * bandc + c]), p.silu);
      };
      for (int v = tid; v < nbody; v += nthr) {
        const int i0 = head + v * V;
        float f[V];
        unpack<T>(*reinterpret_cast<const uint4*>(tile + shift + i0), f);
#pragma unroll
        for (int j = 0; j < V; ++j) f[j] = one(i0 + j, f[j]);
        *reinterpret_cast<uint4*>(y + gbase + i0) = pack<T>(f);
      }
      for (int i = tid; i < head; i += nthr) y[gbase + i] = Elt<T>::t(one(i, Elt<T>::f(tile[shift + i])));
      for (int i = tail0 + tid; i < nflat; i += nthr)
        y[gbase + i] = Elt<T>::t(one(i, Elt<T>::f(tile[shift + i])));
    }
    if (!kResident) __syncthreads();  // the table is refilled for the next band
  }
  if (peers_reading) cluster_wait();
}

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The launch's shared memory: the team partials, the CTA's partials, the
// per-channel table, then the tile of x (resident route; the flat range with
// room to keep its address modulo 16). ops/gn_silu.py::gn_smem_bytes
// computes the same.
struct Layout {
  int tile_off, bytes;
};
Layout layout(int resident, int rows, int gpb, int wpt, int bandc, int P, long long hw, int es) {
  Layout l;
  l.tile_off = round_up(8 * gpb * wpt + 8 * gpb + 12 * bandc, 128);
  long long tile = 0;
  if (resident)
    tile = rows ? static_cast<long long>(bandc) * P * es
                : round_up(static_cast<int>(bandc * hw * es) + 16, 16);
  const long long bytes = l.tile_off + tile;
  l.bytes = bytes > kMaxSmem ? kMaxSmem + 1 : static_cast<int>(bytes);
  return l;
}

template <typename T, bool kResident>
cudaError_t launch(const Params& p, int ctas, int threads, int smem, cudaStream_t stream) {
  auto kern = gn_kernel<T, kResident>;
  static unsigned ready = 0;  // devices whose attributes are set
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < 32 && !(ready & (1u << dev))) {
    rc = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (rc == cudaSuccess)
      rc = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (rc != cudaSuccess) return rc;
    ready |= 1u << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.k > 1 ? 1 : 0;  // a band of one CTA: a plain launch
  rc = cudaLaunchKernelEx(&cfg, kern, p);
  if (rc != cudaSuccess) return rc;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int resident, int ctas, int threads, int smem,
                     cudaStream_t s) {
  return resident ? launch<T, true>(p, ctas, threads, smem, s)
                  : launch<T, false>(p, ctas, threads, smem, s);
}

}  // namespace

// GroupNorm(+SiLU) of x [batch, c, hw] (contiguous; dtype 0 bf16, 1 f16, 2
// f32) into y of x's shape and dtype, at the same address modulo 16 as x.
// `a` holds the shape and the plan (gn_plan): resident 1 / 0 (streaming),
// cluster k, gpb groups a band, P pixels a CTA, rows 1 / 0 (flat), threads,
// smem_bytes, clusters launched. Returns cudaErrorInvalidValue (1) for a plan
// this launch cannot take, else the launch's cudaGetLastError().
extern "C" int vd_gn_silu(const void* x, void* y, const void* w, const void* b, const GNArgs* a,
                          void* stream) {
  const int es = a->dtype == 2 ? 4 : 2;
  const long long hw = a->hw;
  const int c = a->c, groups = a->groups, gpb = a->gpb, k = a->k, P = a->P, threads = a->threads;
  const int resident = a->resident, rows = a->rows;
  if (a->dtype < 0 || a->dtype > 2 || a->wdt < 0 || a->wdt > 2 || a->bdt < 0 || a->bdt > 2)
    return 1;
  if (a->batch < 1 || groups < 1 || c % groups || hw < 1 || gpb < 1 || groups % gpb) return 1;
  if (k < 1 || k > kMaxCluster || static_cast<long long>(P) * k != hw) return 1;
  if (threads != 128 && threads != 256 && threads != 512) return 1;
  const int cpg = c / groups, bandc = gpb * cpg, bands = a->batch * (groups / gpb);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x), ya = reinterpret_cast<uintptr_t>(y);
  if (rows) {
    if (xa % 16 || ya % 16 || (hw * es) % 16 || (static_cast<long long>(P) * es) % 16) return 1;
  } else {
    if (!resident || k != 1 || static_cast<long long>(bandc) * hw * es > kMaxSmem) return 1;
    if ((xa - ya) % 16) return 1;
  }
  if (a->clusters < 1 || a->clusters > bands || (resident && a->clusters != bands)) return 1;
  const int nwarps = threads / 32;
  const int wpt = gpb <= nwarps ? nwarps / gpb : 1;
  const Layout l = layout(resident, rows, gpb, wpt, bandc, P, hw, es);
  if (l.bytes != a->smem_bytes || l.bytes > kMaxSmem) return 1;
  Params p;
  p.x = x;
  p.y = y;
  p.w = w;
  p.b = b;
  p.hw = hw;
  p.c = c;
  p.cpg = cpg;
  p.gpb = gpb;
  p.bps = groups / gpb;
  p.bands = bands;
  p.k = k;
  p.P = P;
  p.rows = rows;
  p.silu = a->silu;
  p.wdt = a->wdt;
  p.bdt = a->bdt;
  p.eps = a->eps;
  p.inv_count = 1.0f / (static_cast<float>(cpg) * static_cast<float>(hw));
  p.bandc = bandc;
  p.wpt = wpt;
  p.tile_off = l.tile_off;
  const int ctas = a->clusters * k;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->dtype) {
    case 0: return dispatch<__nv_bfloat16>(p, resident, ctas, threads, a->smem_bytes, s);
    case 1: return dispatch<__half>(p, resident, ctas, threads, a->smem_bytes, s);
    default: return dispatch<float>(p, resident, ctas, threads, a->smem_bytes, s);
  }
}

// Clusters of k CTAs of `threads` threads and `smem_bytes` shared memory
// that the card can hold at once (cudaOccupancyMaxActiveClusters); 0 where
// such a cluster cannot run.
extern "C" int vd_gn_max_clusters(int k, int threads, int smem_bytes) {
  auto kern = gn_kernel<__nv_bfloat16, true>;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem) ||
      cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1))
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k * 132, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kern, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}
