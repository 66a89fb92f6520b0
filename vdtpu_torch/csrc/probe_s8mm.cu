// s8 x s8 -> s32 matrix product for Hopper (sm_90a): C[M, N] = A[M, K] B[K, N],
// both operands row-major int8, exact in s32.
//
// Replaces: scripts/mosaic_probe.py::mm_kernel (row 12 of the kernel table,
// reached through probe_int8_mm: the s8 [4096, 2880] x s8 [2880, 128] product
// in one Pallas block, timed against XLA's int8 dot). 2880 = 9 * 320: an int8
// 3x3 conv's im2col GEMM.
//
// Bound on this card at the probe's shape: the bytes, each input read once
// and the s32 output written once, 11.80 + 0.37 + 2.10 MB = 14.26 MB, take
// 0.0043 ms at 3.35 TB/s; the 3.02 G int8 operations 0.0015 ms at 1,979
// TOP/s. Memory sets the floor: A, 83% of the bytes, has to stream once at
// full rate into enough SMs.
//
// Design (the geometry is vdtpu_torch/ops/probes.py::s8mm_plan, checked on
// the CPU by tests/test_torch_s8mm_plan.py):
// - A CTA takes 128 rows of A against 128 columns of C (all of the probe's),
//   so A is read once. K is split over a cluster of `split` CTAs along z,
//   rank r taking k32 steps [r * nk / split, (r + 1) * nk / split), nk =
//   ceil(K / 32). The planner picks the split from the card's cluster
//   occupancy (vd_probe_s8mm_clusters): an H100 holds only 30 clusters of 4
//   of these CTAs, so the probe's 32 row tiles take clusters of 3 (one wave,
//   96 CTAs, 30 steps a rank). Each rank stores its s32 partial of every
//   quad into the quad's owner rank by distributed shared memory (remote
//   stores, nothing waits on them); after one cluster barrier each owner adds
//   its slots in rank order. Integer sums: the result is bit-equal to the
//   plain version and the same on every run.
// - Roles are swapped: C^T = B^T A^T. wgmma wants s8 operands K-major; A
//   already is, so A's tile is wgmma's B operand straight from TMA (a 2-D
//   tensor map, 64-byte swizzle, the layout of qconv_sm90.cuh's weight
//   stream), n = 128 rows of A. B arrives by TMA as [k][n] rows (128-byte
//   swizzle); a transposer warpgroup turns each stage's B tile into B^T, 64
//   k bytes a row in the 64-byte swizzle that A's tile has (four k rows of
//   four columns a 4 x 4 byte transpose, 16-byte stores, conflict-free; the
//   unswizzled core-matrix layout made wgmma's reads the bottleneck), so no
//   transposed copy of B ever leaves the SM.
// - A wgmma warpgroup issues each stage's four wgmma m64n128k32 (two k32
//   steps x the two 64-row halves of B^T) with both operands from shared
//   memory, one stage's group in flight while the next is issued. B^T's row
//   order puts a thread's four accumulator rows on four consecutive columns
//   of C, so the epilogue stores 16 bytes a row.
// - A producer warp streams stages (64 k bytes of A, 64 k rows of B) through
//   a ring of kRing on mbarriers: full (TMA landed), bt_full (B^T written),
//   empty (the stage's wgmmas retired).
// - Any M and N (tiles past M or N are zero-filled by TMA and masked on
//   store); K a multiple of 16 (TMA's 16-byte stride rule; the last k32 step
//   may be half past K, zero-filled). N % 16 != 0 cannot be a tensor map:
//   the same kernel then reads B's bytes from global memory (kTmaB false).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qconv_sm90.cuh"
#include "tma_map.cuh"

namespace {

using namespace vdq;

constexpr int kTileM = 128;   // rows of A a CTA takes
constexpr int kTileN = 128;   // columns of C a CTA takes
constexpr int kStageK = 64;   // k bytes a stage holds: two k32 steps (A's 64-byte swizzle)
constexpr int kRing = 4;      // stages in flight
constexpr int kMmaThreads = 128;  // warps 0-3: the wgmma warpgroup
constexpr int kTrThreads = 128;   // warps 4-7: the transposer warpgroup
constexpr int kThreadsMM = kMmaThreads + kTrThreads + 32;  // + the producer warp
constexpr int kStageA = kTileM * kStageK;  // A [128 rows][64 k], TMA, 64-byte swizzle
constexpr int kStageB = kStageK * kTileN;  // B [64 k][128 n], TMA, 128-byte swizzle
constexpr int kStageBt = kTileN * kStageK;  // B^T [128 n][64 k], 64-byte swizzle
constexpr int kStageBytes = kStageA + kStageB + kStageBt;
constexpr int kQuads = 32;     // int4 partials a wgmma thread holds
constexpr int kMaxSplit = 4;
// split-K buffer of an owner rank: for each quad it owns, one int4 slot per
// rank and wgmma thread; split 3 owns the most slots (11 quads x 3)
constexpr int kRedSlots = 33;
constexpr int kRedBytes = kRedSlots * kMmaThreads * 16;
constexpr int kSmemBytes = 1024 + kRing * kStageBytes + kRedBytes + 3 * kRing * 8;

__host__ __device__ constexpr int owned_quads(int split) { return (kQuads + split - 1) / split; }
static_assert(owned_quads(2) * 2 <= kRedSlots && owned_quads(3) * 3 <= kRedSlots &&
                  owned_quads(4) * 4 <= kRedSlots,
              "the split-K buffer holds every split's slots");

__device__ __forceinline__ void st_cluster4(uint32_t addr, uint32_t rank, int4 v) {
  asm volatile(
      "{\n.reg .b32 remote;\nmapa.shared::cluster.u32 remote, %0, %1;\n"
      "st.shared::cluster.v4.b32 [remote], {%2, %3, %4, %5};\n}\n" ::"r"(addr),
      "r"(rank), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_local(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// out[i] holds byte i of w[0..3] (byte j of out[i] = byte i of w[j]): the
// 4 x 4 byte transpose of four k rows into four columns' k quads
__device__ __forceinline__ void transpose4(const uint32_t* w, uint32_t (&out)[4]) {
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140), lo23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362), hi23 = __byte_perm(w[2], w[3], 0x7362);
  out[0] = __byte_perm(lo01, lo23, 0x5410);
  out[1] = __byte_perm(lo01, lo23, 0x7632);
  out[2] = __byte_perm(hi01, hi23, 0x5410);
  out[3] = __byte_perm(hi01, hi23, 0x7632);
}

struct MMParams {
  const int8_t* a;
  const int8_t* b;
  int32_t* c;
  int M, N, K;
};

// B^T row of tile column c (0..127): the wgmma A-operand row, so that
// wgmma h's rows 16 w + g and 16 w + g + 8 (warp w of the wgmma warpgroup,
// lane group g) are columns 4 (8 w + g) + 2 h and + 1, and a thread's four
// accumulator rows are four consecutive columns of C
__device__ __forceinline__ int bt_row(int c) {
  const int q = c >> 2, i = c & 3;  // q = 8 w + g, i = 2 h + hr
  return 64 * (i >> 1) + 16 * (q >> 3) + (q & 7) + 8 * (i & 1);
}

// The transposer's share of one stage: tile columns [cb, cb + 4) x k rows
// [16 kb, 16 kb + 16) of B, read from the staged tile (kTmaB: row r at r *
// 128 bytes, 16-byte chunks swizzled by r % 8) or from global memory (zero
// past K and N), written as four 16-byte rows of B^T (64-byte swizzle).
template <bool kTmaB>
__device__ __forceinline__ void transpose_b(int8_t* bt, const int8_t* sB, const MMParams& p,
                                            int k0, int n0, int cb, int kb) {
  uint32_t w[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int r = 16 * kb + j;
    if constexpr (kTmaB) {
      w[j] = *reinterpret_cast<const uint32_t*>(sB + r * kTileN +
                                                ((((cb >> 4) ^ (r & 7)) << 4) | (cb & 15)));
    } else {
      uint32_t v = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + cb + i, k = k0 + r;
        if (n < p.N && k < p.K) v |= uint32_t(uint8_t(p.b[(long long)k * p.N + n])) << (8 * i);
      }
      w[j] = v;
    }
  }
  uint32_t col[4][4];  // col[i][jj]: column cb + i at k rows 16 kb + 4 jj + [0, 4)
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    uint32_t out[4];
    transpose4(w + 4 * jj, out);
#pragma unroll
    for (int i = 0; i < 4; ++i) col[i][jj] = out[i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = bt_row(cb + i);
    *reinterpret_cast<uint4*>(bt + r * kStageK + ((kb ^ ((r >> 1) & 3)) << 4)) =
        make_uint4(col[i][0], col[i][1], col[i][2], col[i][3]);
  }
}

// the four columns [n, n + 4) of row m
__device__ __forceinline__ void store_quad(const MMParams& p, int m, int n, int4 v) {
  if (m >= p.M) return;
  int32_t* dst = p.c + (long long)m * p.N + n;
  if (p.N % 4 == 0 && n + 4 <= p.N) {
    *reinterpret_cast<int4*>(dst) = v;
    return;
  }
  const int e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (n + i < p.N) dst[i] = e[i];
}

template <bool kTmaB, int kSplit>
__global__ void __launch_bounds__(kThreadsMM, 1)
    s8mm_kernel(const MMParams p, const __grid_constant__ CUtensorMap amap,
                const __grid_constant__ CUtensorMap bmap) {
  extern __shared__ __align__(128) int8_t smem_raw[];
  // the ring from a 1024-byte boundary (the 128-byte swizzle's period), then
  // the split-K buffer and the mbarriers
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  int8_t* ring = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t ring_s = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  const uint32_t red_s = ring_s + kRing * kStageBytes;
  const int4* red = reinterpret_cast<const int4*>(ring + kRing * kStageBytes);
  const uint32_t bars = red_s + kRedBytes;
  auto full = [&](int st) { return bars + 8 * st; };                 // TMA landed
  auto bt_full = [&](int st) { return bars + 8 * (kRing + st); };    // B^T written
  auto empty = [&](int st) { return bars + 8 * (2 * kRing + st); };  // wgmmas done
  auto stage = [&](int st) { return ring + st * kStageBytes; };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * kTileM, n0 = blockIdx.y * kTileN;
  const int rank = kSplit == 1 ? 0 : int(blockIdx.z);
  const int nk = (p.K + 31) / 32;
  const int s_lo = rank * nk / kSplit, s_hi = (rank + 1) * nk / kSplit;
  const int nsteps = s_hi - s_lo, nst = (nsteps + 1) / 2;
  const int kb0 = 32 * s_lo;  // this rank's first k

  if (tid == 0) {
    for (int st = 0; st < kRing; ++st) {
      mbar_init(full(st), 1);
      mbar_init(bt_full(st), kTrThreads / 32);
      mbar_init(empty(st), kMmaThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kMmaThreads) {
    if (tid >= kMmaThreads + kTrThreads) {
      // the producer: stage i = A [m0, m0 + 128) x [kb0 + 64 i, + 64) and B
      // rows [kb0 + 64 i, + 64) x [n0, n0 + 128)
      if (lane == 0) {
        vdt::prefetch_map(&amap);
        if constexpr (kTmaB) vdt::prefetch_map(&bmap);
        for (int i = 0; i < nst; ++i) {
          const int st = i % kRing;
          if (i >= kRing) mbar_wait(empty(st), ((i / kRing) - 1) & 1);
          const uint32_t dst = ring_s + st * kStageBytes;
          mbar_expect_tx(full(st), kTmaB ? kStageA + kStageB : kStageA);
          tma_load(dst, &amap, kb0 + kStageK * i, m0, full(st));
          if constexpr (kTmaB) tma_load(dst + kStageA, &bmap, n0, kb0 + kStageK * i, full(st));
        }
      }
    } else {
      // the transposer: thread (kb, c) moves columns 4 c + [0, 4) x k rows
      // 16 kb + [0, 16) of each stage into B^T (the stage is not refilled
      // before the wgmmas of its last round, which read this B^T, are done)
      const int tt = tid - kMmaThreads, cb = 4 * (tt & 31), kb = tt >> 5;
      for (int i = 0; i < nst; ++i) {
        const int st = i % kRing;
        mbar_wait(full(st), (i / kRing) & 1);
        transpose_b<kTmaB>(stage(st) + kStageA + kStageB, stage(st) + kStageA, p,
                           kb0 + kStageK * i, n0, cb, kb);
        // generic-proxy writes, read by wgmma through the async proxy
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive_local(bt_full(st));
      }
    }
    __syncwarp();
    if constexpr (kSplit > 1) cluster_sync();  // the wgmma warpgroup's split-K exchange
    return;
  }

  // the wgmma warpgroup: each stage's k32 steps as one group, two wgmmas a
  // step (B^T rows 0-63 and 64-127 against the 128 rows of A); one group in
  // flight while the next is issued; a stage goes back to the producer when
  // its group has retired (stages it will not refill need no release)
  int acc0[64], acc1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0;
  for (int i = 0; i < nst; ++i) {
    const int st = i % kRing;
    mbar_wait(bt_full(st), (i / kRing) & 1);
#pragma unroll
    for (int r = 0; r < 64; ++r) {
      fence_operand(acc0[r]);
      fence_operand(acc1[r]);
    }
    wgmma_fence();
    const int8_t* a_tile = stage(st);
    const int8_t* bt = stage(st) + kStageA + kStageB;
#pragma unroll
    for (int sl = 0; sl < 2; ++sl) {
      if (sl == 1 && 2 * i + 1 >= nsteps) break;
      const uint64_t desc_a = wgmma_desc(a_tile + 32 * sl, 16, 8 * kStageK, 2);
      wgmma_m64n128k32_ss(acc0, wgmma_desc(bt + 32 * sl, 16, 8 * kStageK, 2), desc_a);
      wgmma_m64n128k32_ss(acc1, wgmma_desc(bt + 64 * kStageK + 32 * sl, 16, 8 * kStageK, 2),
                          desc_a);
    }
    wgmma_commit();
    wgmma_wait<1>();
#pragma unroll
    for (int r = 0; r < 64; ++r) {
      fence_operand(acc0[r]);
      fence_operand(acc1[r]);
    }
    if (i >= 1 && i - 1 + kRing < nst) {
      __syncwarp();
      if (lane == 0) mbar_arrive_local(empty((i - 1) % kRing));
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int r = 0; r < 64; ++r) {
    fence_operand(acc0[r]);
    fence_operand(acc1[r]);
  }

  // quad q = 2 j + e of a wgmma thread: row m0 + 8 j + 2 t + e, columns
  // n0 + cb + [0, 4)
  const int g = lane >> 2, t = lane & 3;
  const int cb = 4 * (8 * warp + g);
  auto quad = [&](int q) {
    const int j = q >> 1, e = q & 1;
    return make_int4(acc0[4 * j + e], acc0[4 * j + 2 + e], acc1[4 * j + e], acc1[4 * j + 2 + e]);
  };
  auto row = [&](int q) { return m0 + 8 * (q >> 1) + 2 * t + (q & 1); };
  if constexpr (kSplit == 1) {
#pragma unroll
    for (int q = 0; q < kQuads; ++q) store_quad(p, row(q), n0 + cb, quad(q));
  } else {
    // split K: quad q belongs to rank q / kOwn; every rank stores its partial
    // of it into the owner's buffer, slot ((q % kOwn) * kSplit + rank) of this
    // thread (remote stores, nothing waits on them); after the cluster
    // barrier each owner adds its slots in rank order and stores the sums
    constexpr int kOwn = owned_quads(kSplit);
#pragma unroll
    for (int q = 0; q < kQuads; ++q)
      st_cluster4(red_s + 16 * (((q % kOwn) * kSplit + rank) * kMmaThreads + tid),
                  uint32_t(q / kOwn), quad(q));
    __syncwarp();
    cluster_sync();
#pragma unroll
    for (int o = 0; o < kOwn; ++o) {
      const int q = rank * kOwn + o;
      if (q >= kQuads) break;
      int4 sum = red[(o * kSplit) * kMmaThreads + tid];
#pragma unroll
      for (int r = 1; r < kSplit; ++r) {
        const int4 v = red[(o * kSplit + r) * kMmaThreads + tid];
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      store_quad(p, row(q), n0 + cb, sum);
    }
  }
}

// a row-major s8 [rows, cols] matrix as a 2-D tensor map, boxes of box_cols
// bytes x box_rows rows, zero outside
int map_2d(CUtensorMap* map, const void* ptr, int rows, int cols, int box_cols, int box_rows,
           CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols)};
  const cuuint32_t box[2] = {cuuint32_t(box_cols), cuuint32_t(box_rows)};
  return vdt::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, ptr, dims, strides, box, swizzle);
}

template <bool kTmaB, int kSplit>
cudaError_t allow_smem() {
  static bool done = false;
  if (!done) {
    const cudaError_t rc = cudaFuncSetAttribute(
        s8mm_kernel<kTmaB, kSplit>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (rc != cudaSuccess) return rc;
    done = true;
  }
  return cudaSuccess;
}

cudaLaunchConfig_t config(dim3 grid, int split, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreadsMM);
  cfg.dynamicSmemBytes = size_t(kSmemBytes);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = unsigned(split);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kTmaB, int kSplit>
int launch(const MMParams& p, const CUtensorMap& amap, const CUtensorMap& bmap,
           cudaStream_t stream) {
  if (const cudaError_t rc = allow_smem<kTmaB, kSplit>()) return int(rc);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(
      dim3(unsigned((p.M + kTileM - 1) / kTileM), unsigned((p.N + kTileN - 1) / kTileN),
           unsigned(kSplit)),
      kSplit, stream, attr);
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, s8mm_kernel<kTmaB, kSplit>, p, amap, bmap);
  if (rc != cudaSuccess) return int(rc);
  return int(cudaGetLastError());
}

template <bool kTmaB>
int dispatch(const MMParams& p, int split, const CUtensorMap& amap, const CUtensorMap& bmap,
             cudaStream_t stream) {
  switch (split) {
    case 1: return launch<kTmaB, 1>(p, amap, bmap, stream);
    case 2: return launch<kTmaB, 2>(p, amap, bmap, stream);
    case 3: return launch<kTmaB, 3>(p, amap, bmap, stream);
    case 4: return launch<kTmaB, 4>(p, amap, bmap, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

template <int kSplit>
int max_clusters() {
  if (const cudaError_t rc = allow_smem<true, kSplit>()) return -int(rc);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(dim3(kSplit, 1, kSplit), kSplit, nullptr, attr);
  int n = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveClusters(&n, s8mm_kernel<true, kSplit>, &cfg);
  return rc == cudaSuccess ? n : -int(rc);
}

}  // namespace

// a [M, K], b [K, N] int8 row-major (16-byte aligned, K % 16 == 0), c [M, N]
// int32 (16-byte aligned). split: CTAs of a cluster splitting K (1 to 4, at
// most ceil(K / 32)). Returns a cudaError_t code; 0 means the launch was
// accepted.
extern "C" int vd_probe_s8mm(const void* a, const void* b, void* c, int M, int N, int K,
                             int split, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || split < 1 || split > kMaxSplit ||
      split > (K + 31) / 32 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0 || reinterpret_cast<uintptr_t>(c) % 16 != 0)
    return int(cudaErrorInvalidValue);
  MMParams p;
  p.a = static_cast<const int8_t*>(a);
  p.b = static_cast<const int8_t*>(b);
  p.c = static_cast<int32_t*>(c);
  p.M = M;
  p.N = N;
  p.K = K;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap amap, bmap;
  int rc = map_2d(&amap, a, M, K, kStageK, kTileM, CU_TENSOR_MAP_SWIZZLE_64B);
  if (rc != 0) return rc;
  if (N % 16 == 0) {
    rc = map_2d(&bmap, b, K, N, kTileN, kStageK, CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc != 0) return rc;
    return dispatch<true>(p, split, amap, bmap, st);
  }
  bmap = amap;  // unused by the global-memory B path
  return dispatch<false>(p, split, amap, bmap, st);
}

// Clusters of `split` CTAs (1 to 4) of the kernel this card holds at once
// (cudaOccupancyMaxActiveClusters): the planner's wave count. A negative
// value is a cudaError_t code.
extern "C" int vd_probe_s8mm_clusters(int split) {
  switch (split) {
    case 1: return max_clusters<1>();
    case 2: return max_clusters<2>();
    case 3: return max_clusters<3>();
    case 4: return max_clusters<4>();
    default: return -int(cudaErrorInvalidValue);
  }
}
