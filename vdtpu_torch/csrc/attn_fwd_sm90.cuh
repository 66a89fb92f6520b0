// The attention forward on Hopper's wgmma and TMA (sm_90a): one kernel
// template for the flash forward (csrc/flash_fwd.cu, with or without lse)
// and the calibrated no-max forward (csrc/nomax_fwd.cu). bf16 q, k, v in,
// bf16 out, f32 scores and sums.
//
// Replaces, on heads up to 160 wide with d % 8 == 0 and 16-byte aligned rows
// (the main path's 40 and 80; the four-image mcg's 160):
// vdtpu/ops/pallas/flash.py::_fwd_kernel
// (Mode Flash, FlashLse) and _nomax_slim_kernel / _nomax_packed_kernel
// (Mode NoMax). Their numerics, per key tile:
//   Flash:  q~ = bf16(q * scale); s = q~ . k^T; running row max m;
//           p = exp2(s log2 e - m log2 e); l and O rescaled by
//           alpha = exp2((m_old - m) log2 e); O += bf16(p) . v;
//           out = O / l; lse = m + log(l) (FlashLse, f32 [B, H, N]).
//   NoMax:  q~ = bf16(q * scale * log2 e); p = exp2(s - M log2 e) with M the
//           head's calibrated bound; O += bf16(p) . v;
//           out = O / max(l, 1e-30).
// Keys past M get p = 0 explicitly; queries past N are never stored. The
// plain model of this order of work is vdtpu_torch/ops/flash.py::
// flash_attention_fwd_blocked_plain; the launch geometry mirrors
// vdtpu_torch/ops/flash.py::attn_fwd_plan (plan_code below).
//
// Bound on this card at [4, 4096, 8, 40]: 537 M exponentials, 0.128 ms at
// 16 per SM per clock; the two products 103 GFLOP with d padded to 48,
// 0.104 ms at 989 TFLOP/s; memory 0.013 ms. The exponentials and the tensor
// cores are both near the floor, so the design is about overlapping them.
//
// The design (one block an SM, a producer warpgroup and two or three
// consumer warpgroups):
// - a producer warpgroup (registers given away by setmaxnreg) whose first
//   warp loads Q once and keeps a ring of K/V tiles full by TMA, behind
//   full / empty mbarriers. Q and K land as boxes of 64 columns x 128 rows
//   with 128-byte swizzle (wgmma's K-major SW128 layout), V likewise
//   (read MN-major, the transpose bit), all zero past D and past the rows.
//   A box row is 128 bytes; the column planes of 16-byte rows that the
//   backward takes (csrc/flash_bwd.cu) made the K/V loads, eight times as
//   many rows a tile, the pace of this kernel's first version;
// - consumer warpgroups of 64 query rows each (three where the head is
//   padded to 64 or less and there are 2048 queries or more, else two; see
//   consumers()), which meet nothing but the ring's mbarriers (no
//   block-wide barrier in the loop) and take turns issuing their products
//   (a ring of named barriers), so one's exponentials overlap another's
//   products;
// - per key tile, in each consumer warpgroup: S_j = Q.K_j^T by wgmma ss
//   (both K-major), then O += bf16(P_{j-1}).V_{j-1} by wgmma rs (P packed in
//   registers as the A operand), both in flight while the softmax of S_j
//   runs: the previous tile's product overlaps this tile's exponentials.
//   One FFMA and one ex2.approx a score; the row maxima and sums as four
//   partials a row (short dependency chains); the key mask only on the
//   last tile.
//
// Heads of 88-160 (d padded to 96-160; their instantiations are a
// translation unit of their own, csrc/attn_fwd_wide.cu, which builds beside
// the narrow sources in parallel). The three limits the narrow geometry hits, and the answers:
// - shared memory: d 160 takes 3 boxes of 64 columns (192 with the zero
//   fill); with 128 query rows and 128-key stages that is 1 KB + 48 KB +
//   2 x 96 KB = 241 KB, over the 227 KB a block may take. Heads padded past
//   128 take 64-key tiles (key_tile), three stages: 1 + 48 + 3 x 48 KB =
//   193 KB. Heads of 96-128 keep 128-key tiles in two boxes, three stages
//   (225 KB at 128).
// - registers: a consumer thread holds O (dp / 2 f32: 80 at 160), S (key
//   tile / 2: 32) and bf16(P)'s fragments (key tile / 16 x 4: 16) against
//   the 232 setmaxnreg gives it; the 64-key tile is what keeps d 160 at 128
//   live accumulators.
// - grid: at the mcg site's 4 x 256 queries x 8 heads, 128-row blocks are
//   64 CTAs on 132 SMs; there the block takes one consumer warpgroup (64
//   rows, 128 CTAs, consumers() below), elsewhere two.
//   O += P.V is one wgmma over the whole head (n96-n160, V MN-major across
//   its boxes, LBO one box), S = Q.K^T walks the boxes in k16 steps.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma_map.cuh"
#include "wgmma_bf16.cuh"

namespace vdattn {

enum class Mode { Flash, FlashLse, NoMax };

constexpr int kWgRows = 64;                      // query rows a consumer warpgroup
constexpr int kMaxStages = 4;
// keys a K/V tile: 128, or 64 for heads padded past 128 (shared memory)
__host__ __device__ constexpr int key_tile(int dp) { return dp <= 128 ? 128 : 64; }
constexpr int kMaxSmem = 232448;
constexpr int kNarrowD = 80;  // widest head instantiated by flash_fwd.cu / nomax_fwd.cu
// Consumer warpgroups a block: three (192 query rows) for heads padded to
// 64 or less, whose accumulators fit 160 registers, over 2048 queries or
// more; one (64 rows) for heads over kNarrowD over 256 queries or fewer
// (the mcg's 16^2 cross-attention: 128-row blocks would fill 64 of 132
// SMs; 64-row blocks read 0.0167 ms against 0.0229 on an H100 at [4, 256,
// 8, 160] over 1028 keys, and lose at 1024 queries and more: chip_smoke.py
// --phases wide_sweep); else two (128 rows: at
// 1024 queries, 192-row blocks leave a third of the last block empty and a
// second wave half full).
inline int consumers(int dp, int n) {
  return dp <= 64 && n >= 2048 ? 3 : dp > kNarrowD && n <= 256 ? 1 : 2;
}
// NC consumer warpgroups and a producer warpgroup, one block an SM: the
// registers a thread gets at launch, and the consumers' and producers'
// shares after setmaxnreg (2: 256 x 232 + 128 x 40 = 384 x 168; 3: 384 x
// 160 + 128 x 32 = 512 x 128)
// (NC = 1, one consumer warpgroup, runs without setmaxnreg or turns, at
// ptxas's own register count: 172 at d 160)
template <int NC>
struct Team {
  static constexpr int kBQ = kWgRows * NC;       // query rows a block
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr bool kSplitRegs = NC > 1;
  static constexpr int kLaunchRegs = kSplitRegs ? 65536 / kThreads / 8 * 8 : 0;
  static constexpr int kMmaRegs = NC == 2 ? 232 : 160;
  static constexpr int kTmaRegs = NC == 2 ? 40 : 32;
  static_assert(!kSplitRegs || 128 * (NC * kMmaRegs + kTmaRegs) <= kThreads * kLaunchRegs,
                "register split");
};
constexpr int kMaxD = 160;                       // widest head on this kernel
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle's
// period): Q as kBoxes boxes [kBQ][64]; a ring of stages, each K and V as
// kBoxes boxes [BK][64]; the mbarriers (Q, full[stages], empty[stages]).
// Every box is 128-byte swizzled.
template <int DP, int NC, int BK = key_tile(DP)>
struct Geo {
  using T = Team<NC>;
  static constexpr int kBK = BK;                 // keys a K/V tile
  static constexpr int kBoxes = (DP + 63) / 64;  // boxes of 64 columns a tile
  static constexpr int kQBox = T::kBQ * 128;     // bytes of a Q box
  static constexpr int kBox = BK * 128;          // bytes of a K or V box
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKBytes = kBoxes * kBox;
  static constexpr int kStage = 2 * kKBytes;
};
template <int DP, int NC, int BK = key_tile(DP)>
__host__ __device__ constexpr int smem_bytes(int stages) {
  using G = Geo<DP, NC, BK>;
  return 1024 + G::kQBytes + stages * G::kStage + 8 * (1 + 2 * stages);
}
template <int DP, int NC, int BK = key_tile(DP)>
__host__ __device__ constexpr int stages() {
  return smem_bytes<DP, NC, BK>(kMaxStages) <= kMaxSmem ? kMaxStages
         : smem_bytes<DP, NC, BK>(3) <= kMaxSmem        ? 3
                                                        : 2;
}

// The launch a call gets, as one int (vdtpu_torch/ops/flash.py::
// AttnFwdPlan.code): 0 the mma.sync kernel with element loads, 1 with
// 16-byte cp.async loads, and for this kernel 2 | stages << 4 | key tile / 64
// << 8 | query rows / 64 << 12 | shared-memory bytes / 8 << 16. This kernel
// takes d <= 160, d % 8 == 0, 16-byte aligned q, k, v and row, head and
// batch strides (TMA boxes start on 16 bytes); the mma.sync kernels
// everything else.
inline bool aligned16(const void* q, const void* k, const void* v, const long long* strides) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return false;
  for (int i = 0; i < 9; ++i)
    if (strides[i] % 8 != 0) return false;
  return true;
}
template <int NC>
inline int wg_code(int dp) {
  int st = 0, smem = 0;
  switch (dp) {
    case 16: st = stages<16, NC>(); smem = smem_bytes<16, NC>(st); break;
    case 32: st = stages<32, NC>(); smem = smem_bytes<32, NC>(st); break;
    case 48: st = stages<48, NC>(); smem = smem_bytes<48, NC>(st); break;
    case 64: st = stages<64, NC>(); smem = smem_bytes<64, NC>(st); break;
    case 80: st = stages<80, NC>(); smem = smem_bytes<80, NC>(st); break;
    case 96: st = stages<96, NC>(); smem = smem_bytes<96, NC>(st); break;
    case 112: st = stages<112, NC>(); smem = smem_bytes<112, NC>(st); break;
    case 128: st = stages<128, NC>(); smem = smem_bytes<128, NC>(st); break;
    case 144: st = stages<144, NC>(); smem = smem_bytes<144, NC>(st); break;
    case 160: st = stages<160, NC>(); smem = smem_bytes<160, NC>(st); break;
    default: return -1;
  }
  return 2 | st << 4 | (key_tile(dp) / 64) << 8 | NC << 12 | smem / 8 << 16;
}
// strides: q, k, v as (batch, row, head) in elements
inline int plan_code(int D, int N, const void* q, const void* k, const void* v,
                     const long long* strides) {
  const bool vec = D % 8 == 0 && aligned16(q, k, v, strides);
  if (!vec || D > kMaxD) return vec ? 1 : 0;
  const int dp = (D + 15) / 16 * 16;
  switch (consumers(dp, N)) {
    case 1: return wg_code<1>(dp);
    case 3: return wg_code<3>(dp);
    default: return wg_code<2>(dp);
  }
}
inline bool is_wg(int code) { return (code & 15) == 2; }
// the head padded to 16 of a call whose plan is the wgmma kernel's
inline int padded(int D) { return (D + 15) / 16 * 16; }

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;           // FlashLse: [B, H, N]
  const float* shift;   // NoMax: the bound of (b, h) at shift[b * shift_sb + h]
  long long shift_sb;
  int B, N, M, H, D;
  long long sqb, sqn, sqh;
  long long skb, skn, skh;
  long long svb, svn, svh;
  long long sob, son, soh;
  float qscale;         // folded into q: scale (Flash), scale * log2 e (NoMax)
};
struct Maps {
  CUtensorMap q, k, v;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(128) : "memory");
}
// The consumer warpgroups take turns issuing their products, in a ring:
// warpgroup wg waits on barrier 1 + NC + wg (its 128 threads syncing, the
// previous warpgroup's 128 arriving) and, once its products are issued,
// passes the turn to the next. (Barriers 1 .. NC are wg_sync's.)
// One consumer warpgroup takes no turns.
template <int NC>
__device__ __forceinline__ void turn_wait(int wg) {
  if constexpr (NC > 1) asm volatile("bar.sync %0, 256;\n" ::"r"(1 + NC + wg) : "memory");
}
template <int NC>
__device__ __forceinline__ void turn_pass(int wg) {
  if constexpr (NC > 1)
    asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + NC + (wg + 1) % NC) : "memory");
}

// The operands' descriptors are made once and advanced by adding byte
// offsets / 16 to their start field (the address stays below 256 KB, so the
// field does not carry): a tile costs one 64-bit add, not a descriptor.
__device__ __forceinline__ uint64_t advance(uint64_t desc, int bytes) { return desc + (bytes >> 4); }
// S = Q.K^T for one warpgroup's 64 rows and a BK-key tile: A = the
// warpgroup's Q rows, B = the tile's K rows, both K-major SW128 (SBO 8 rows
// of 128 bytes; k16 step kk at 32 kk bytes into box kk / 4). qd, kd: the
// descriptors of the warpgroup's first Q row and of the tile's first K row.
template <int DP, int NC, int BK>
__device__ __forceinline__ void qk(float (&s)[BK / 2], uint64_t qd, uint64_t kd) {
  using G = Geo<DP, NC, BK>;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int off = (kk % 4) * 32;
    vdw::Wgmma<BK>::ss(s, advance(qd, (kk / 4) * G::kQBox + off),
                       advance(kd, (kk / 4) * G::kBox + off), kk);
  }
}
// O += P.V over a BK-key tile: A = bf16(P) in registers (k16 step kc),
// B = V MN-major SW128 (vd: LBO one box, the next 64 columns of D; SBO 8
// key rows of 128 bytes). At d 40 the product reads 48 of a box's 64
// columns, at d 160 it reads 32 of the third box's.
template <int DP, int BK>
__device__ __forceinline__ void pv(float (&o)[DP / 2], const uint32_t (&pa)[BK / 16][4],
                                   uint64_t vd) {
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) vdw::Wgmma<DP>::rs_tb(o, pa[kc], advance(vd, 2048 * kc), 1);
}

// The softmax of one score tile in place (S -> P, f32). This thread holds
// rows g (e = 0, 1) and g + 8 (e = 2, 3) of its warp's 16 at key columns
// kbase + 8 n + 2 t + (e & 1); MASK: the tile runs past M (the last one).
// The row maxima and sums are kept as kLanes partials a row, so each
// reduction is a short dependency chain; l_run stays this thread's partial
// sums. Flash: alpha gets the rescale of O, which l_run has already taken.
constexpr int kLanes = 4;
template <bool B>
struct Flag {
  static constexpr bool value = B;
};
template <Mode MODE, bool MASK, int BK>
__device__ __forceinline__ void softmax(float (&s)[BK / 2], float (&m_run)[2],
                                        float (&l_run)[2][kLanes], float (&alpha)[2], int kbase,
                                        int M, int t, float shift2) {
  if constexpr (MASK) {
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (kbase + 8 * n + 2 * t + (e & 1) >= M) s[4 * n + e] = -INFINITY;
  }
  float ms[2] = {shift2, shift2};  // the exponent's offset a row, log2 units
  if constexpr (MODE != Mode::NoMax) {
    float mx[2][kLanes];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < kLanes; ++i) mx[r][i] = -INFINITY;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        mx[r][n % kLanes] = fmaxf(mx[r][n % kLanes], fmaxf(s[4 * n + 2 * r], s[4 * n + 2 * r + 1]));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const float m_new = fmaxf(m_run[r], m);
      ms[r] = (m_new == -INFINITY ? 0.f : m_new) * kLog2e;
      alpha[r] = ex2(m_run[r] * kLog2e - ms[r]);
      m_run[r] = m_new;
#pragma unroll
      for (int i = 0; i < kLanes; ++i) l_run[r][i] *= alpha[r];
    }
  }
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& x = s[4 * n + e];
      x = MODE == Mode::NoMax ? ex2(x - ms[e >> 1]) : ex2(__fmaf_rn(x, kLog2e, -ms[e >> 1]));
      l_run[e >> 1][n % kLanes] += x;
    }
}

// bf16(P) as the A fragments of the P.V product: k16 step kc holds key
// columns 16 kc + [0, 16), accumulators 8 kc .. 8 kc + 7
template <int BK>
__device__ __forceinline__ void pack(uint32_t (&pa)[BK / 16][4], const float (&s)[BK / 2]) {
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kc][r] = pack2(s[8 * kc + 2 * r], s[8 * kc + 2 * r + 1]);
}

template <int DP, int NC, Mode MODE, int BK = key_tile(DP)>
__global__ void __launch_bounds__(Team<NC>::kThreads, 1)
    attn_fwd_wg_kernel(const Args p, const __grid_constant__ Maps maps) {
  using G = Geo<DP, NC, BK>;
  using T = Team<NC>;
  constexpr int kBK = BK;
  constexpr int NS = stages<DP, NC, BK>();
  constexpr int kTileTx = G::kStage;  // the bytes a tile's boxes land, zero fill included

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - vdt::smem_addr(smem_raw) % 1024) % 1024);
  unsigned char* sQ = base;
  unsigned char* sKV = base + G::kQBytes;  // stage st: K at st * kStage, V kKBytes after
  const uint32_t bars = vdt::smem_addr(sKV + NS * G::kStage);  // q, full[NS], empty[NS]
  auto full = [&](int slot) { return bars + 8 * (1 + slot); };
  auto empty = [&](int slot) { return bars + 8 * (1 + NS + slot); };

  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * T::kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nkt = (p.M + kBK - 1) / kBK;

  if (tid == 0) {
    vdt::bar_init(bars, 1);
    for (int s = 0; s < NS; ++s) {
      vdt::bar_init(full(s), 1);
      vdt::bar_init(empty(s), 4 * NC);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * NC) {
    if constexpr (T::kSplitRegs)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(T::kTmaRegs));
    if (warp > 4 * NC) return;
    // the TMA warp: Q's boxes (lane c: box c), then K/V tile j into slot
    // j % NS once every consumer warp released its previous tile (lane c <
    // kBoxes: K's box c; the next kBoxes lanes V's)
    if (lane == 0) vdt::bar_expect_tx(bars, G::kQBytes);
    __syncwarp();
    if (lane < G::kBoxes)
      vdt::tma_4d(vdt::smem_addr(sQ + lane * G::kQBox), &maps.q, 64 * lane, h, q0, b, bars);
    for (int j = 0; j < nkt; ++j) {
      const int slot = j % NS;
      if (j >= NS) vdt::bar_wait(empty(slot), ((j / NS) - 1) & 1);
      if (lane == 0) vdt::bar_expect_tx(full(slot), kTileTx);
      __syncwarp();
      if (lane < 2 * G::kBoxes) {
        const int c = lane % G::kBoxes;
        const bool is_k = lane < G::kBoxes;
        vdt::tma_4d(vdt::smem_addr(sKV + slot * G::kStage + (is_k ? 0 : G::kKBytes) + c * G::kBox),
                    is_k ? &maps.k : &maps.v, 64 * c, h, j * kBK, b, full(slot));
      }
    }
    return;
  }

  if constexpr (T::kSplitRegs)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::kMmaRegs));
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* qw = sQ + wg * kWgRows * 128;  // this warpgroup's first Q row in box 0
  const uint64_t qd = vdw::desc(qw, 16, 1024, vdw::kSwizzle128);
  const uint64_t kd0 = vdw::desc(sKV, 16, 1024, vdw::kSwizzle128);
  const uint64_t vd0 = vdw::desc(sKV + G::kKBytes, kBK * 128, 1024, vdw::kSwizzle128);
  const float shift2 =
      MODE == Mode::NoMax ? p.shift[b * p.shift_sb + h] * kLog2e : 0.f;

  // the scale folded into this warpgroup's Q rows (every column of its
  // boxes: the swizzle only permutes 16-byte chunks within a row), rounded
  // to bf16 as the TPU kernels do; Q landed by TMA and is read by wgmma
  // (the async proxy)
  vdt::bar_wait(bars, 0);
  for (int i = tid & 127; i < G::kBoxes * kWgRows * 8; i += 128) {
    uint4* chunk = reinterpret_cast<uint4*>(qw + (i / (kWgRows * 8)) * G::kQBox +
                                            (i % (kWgRows * 8)) * 16);
    uint4 x = *chunk;
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float2 f = __bfloat1622float2(e[c]);
      e[c] = __floats2bfloat162_rn(f.x * p.qscale, f.y * p.qscale);
    }
    *chunk = x;
  }
  vdw::fence_async_smem();
  wg_sync(wg);

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float s[kBK / 2];
  uint32_t pa[kBK / 16][4];
  float m_run[2] = {-INFINITY, -INFINITY}, alpha[2] = {1.f, 1.f}, l_run[2][kLanes];
#pragma unroll
  for (int i = 0; i < kLanes; ++i) l_run[0][i] = l_run[1][i] = 0.f;
  auto rescale = [&]() {
    if constexpr (MODE != Mode::NoMax) {
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    }
  };

  // tile 0: its scores alone
  if (wg == NC - 1) turn_pass<NC>(wg);  // warpgroup 0 issues first
  vdt::bar_wait(full(0), 0);
  turn_wait<NC>(wg);
  vdw::keep(s);
  vdw::wg_fence();
  qk<DP, NC, BK>(s, qd, kd0);
  vdw::wg_commit();
  turn_pass<NC>(wg);
  vdw::wg_wait<0>();
  vdw::keep(s);
  if (p.M < kBK)
    softmax<MODE, true, BK>(s, m_run, l_run, alpha, 0, p.M, t, shift2);
  else
    softmax<MODE, false, BK>(s, m_run, l_run, alpha, 0, p.M, t, shift2);
  pack<BK>(pa, s);

  // tile j: S_j, then the previous tile's P.V, both in flight while this
  // tile's exponentials run
  auto step = [&](int j, auto mask) {
    const int slot = j % NS, prev = (j - 1) % NS;
    vdt::bar_wait(full(slot), (j / NS) & 1);
    turn_wait<NC>(wg);
    vdw::keep(s);
    vdw::keep(pa);
    vdw::wg_fence();
    qk<DP, NC, BK>(s, qd, advance(kd0, slot * G::kStage));
    vdw::wg_commit();
    pv<DP, BK>(o, pa, advance(vd0, prev * G::kStage));
    vdw::wg_commit();
    turn_pass<NC>(wg);
    vdw::wg_wait<1>();
    vdw::keep(s);
    softmax<MODE, decltype(mask)::value, BK>(s, m_run, l_run, alpha, j * kBK, p.M, t, shift2);
    vdw::wg_wait<0>();
    vdw::keep(o);
    vdw::keep(pa);
    if (lane == 0) vdt::bar_arrive(empty(prev));  // this warp is done with tile j - 1
    rescale();                                    // O to this tile's max
    pack<BK>(pa, s);
  };
  const int whole = p.M / kBK;  // tiles with no key past M
#pragma unroll 1
  for (int j = 1; j < whole; ++j) step(j, Flag<false>());
  if (whole < nkt && nkt > 1) step(nkt - 1, Flag<true>());

  turn_wait<NC>(wg);
  vdw::keep(pa);
  vdw::keep(o);
  vdw::wg_fence();
  pv<DP, BK>(o, pa, advance(vd0, ((nkt - 1) % NS) * G::kStage));
  vdw::wg_commit();
  if (wg != NC - 1) turn_pass<NC>(wg);  // the turns balance: the last passes to no one
  vdw::wg_wait<0>();
  vdw::keep(o);

  // out = O / l (bf16), 4-byte stores (d % 8 == 0 on this kernel); lse
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = (l_run[r][0] + l_run[r][1]) + (l_run[r][2] + l_run[r][3]);
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if constexpr (MODE == Mode::NoMax) l = fmaxf(l, 1e-30f);
    const int row = q0 + wg * kWgRows + 16 * wl + g + 8 * r;
    if (row >= p.N) continue;
    if constexpr (MODE == Mode::FlashLse)
      if (t == 0) p.lse[size_t(bh) * p.N + row] = m_run[r] + logf(l);
    const float inv = 1.f / l;
    __nv_bfloat16* orow = p.o + b * p.sob + h * p.soh + row * p.son;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      if (8 * n < p.D)
        *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * t) =
            pack2(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
  }
}

// Launches the kernel for heads padded to DP with NC consumer warpgroups
// and BK-key tiles; a cudaError_t code.
template <int DP, int NC, Mode MODE, int BK = key_tile(DP)>
int launch_wg(const Args& p, cudaStream_t stream) {
  using T = Team<NC>;
  constexpr int smem = smem_bytes<DP, NC, BK>(stages<DP, NC, BK>());
  static_assert(smem <= kMaxSmem, "the forward's tiles fit shared memory");
  static bool ready = false;
  if (!ready) {
    const auto kernel = attn_fwd_wg_kernel<DP, NC, MODE, BK>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return int(e);
    // setmaxnreg.inc takes registers the dec freed: a kernel compiled to
    // another count than kLaunchRegs a thread would wait forever or overrun
    cudaFuncAttributes attr;
    if ((e = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return int(e);
    if (T::kSplitRegs && attr.numRegs != T::kLaunchRegs)
      return int(cudaErrorInvalidConfiguration);
    ready = true;
  }
  constexpr auto sw128 = CU_TENSOR_MAP_SWIZZLE_128B;
  Maps maps;
  int rc;
  if ((rc = vdt::encode_rows_map(&maps.q, p.q, p.B, p.N, p.H, p.D, p.sqb, p.sqn, p.sqh, T::kBQ,
                                 64, sw128)))
    return rc;
  if ((rc = vdt::encode_rows_map(&maps.k, p.k, p.B, p.M, p.H, p.D, p.skb, p.skn, p.skh, BK,
                                 64, sw128)))
    return rc;
  if ((rc = vdt::encode_rows_map(&maps.v, p.v, p.B, p.M, p.H, p.D, p.svb, p.svn, p.svh, BK,
                                 64, sw128)))
    return rc;
  const dim3 grid((p.N + T::kBQ - 1) / T::kBQ, p.B * p.H);
  attn_fwd_wg_kernel<DP, NC, MODE, BK><<<grid, T::kThreads, smem, stream>>>(p, maps);
  return int(cudaGetLastError());
}

// Heads up to kNarrowD (csrc/flash_fwd.cu, csrc/nomax_fwd.cu); a wider
// head is not instantiated there (cudaErrorInvalidValue)
template <Mode MODE>
int dispatch_wg(const Args& p, cudaStream_t stream) {
  const int dp = padded(p.D);
  const bool three = consumers(dp, p.N) == 3;
  switch (dp) {
    case 16: return three ? launch_wg<16, 3, MODE>(p, stream) : launch_wg<16, 2, MODE>(p, stream);
    case 32: return three ? launch_wg<32, 3, MODE>(p, stream) : launch_wg<32, 2, MODE>(p, stream);
    case 48: return three ? launch_wg<48, 3, MODE>(p, stream) : launch_wg<48, 2, MODE>(p, stream);
    case 64: return three ? launch_wg<64, 3, MODE>(p, stream) : launch_wg<64, 2, MODE>(p, stream);
    case 80: return launch_wg<80, 2, MODE>(p, stream);
    default: return int(cudaErrorInvalidValue);
  }
}
// Heads of 88-160 (csrc/attn_fwd_wide.cu): one or two consumer warpgroups
template <Mode MODE>
int dispatch_wg_wide(const Args& p, cudaStream_t stream) {
  const int dp = padded(p.D);
  const bool one = consumers(dp, p.N) == 1;
  switch (dp) {
    case 96: return one ? launch_wg<96, 1, MODE>(p, stream) : launch_wg<96, 2, MODE>(p, stream);
    case 112:
      return one ? launch_wg<112, 1, MODE>(p, stream) : launch_wg<112, 2, MODE>(p, stream);
    case 128:
      return one ? launch_wg<128, 1, MODE>(p, stream) : launch_wg<128, 2, MODE>(p, stream);
    case 144:
      return one ? launch_wg<144, 1, MODE>(p, stream) : launch_wg<144, 2, MODE>(p, stream);
    case 160:
      return one ? launch_wg<160, 1, MODE>(p, stream) : launch_wg<160, 2, MODE>(p, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace vdattn
