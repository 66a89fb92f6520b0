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
//     even, as vdtpu/ops/quant.py::_quantize_act) while staging the input;
//     padding stays 0 after quantization, never quantize(GN(0)).
// Every tensor is addressed through strides, so NCHW and NHWC (the flat
// [B, H*W, C] layout of the TPU kernel) both work.
//
// Bound on this card (1,979 TOP/s int8, 3.35 TB/s): the tensor cores at
// every int8 site of the full-width UNet except conv_in. At B = 4:
// 64^2 320 -> 320, 2 * 16384 * 320 * 2880 = 30.2 G operations, 0.0153 ms
// (640 -> 320 0.0305, 960 -> 320 0.0458); 32^2 640 -> 640 0.0153; 16^2
// 1280 -> 1280 0.0153; the stride-2 convs a quarter of their stride-1 work.
// The bytes (s8 input once, weights once, bf16 output once) take 0.005 ms
// at 64^2 320 -> 320; conv_in (C = 4) is bound by its 10.5 MB output,
// 0.0031 ms.
//
// What the design does about it. Two paths, chosen by
// vdtpu_torch/ops/qconv.py::qconv3_plan and counted apart by the wrapper:
// - halo (qconv_sm90.cuh), every site with C % 32 == 0 and Wo <= 128 (all
//   but conv_in): a block takes whole output rows of one image (128 or 256
//   pixels); per chunk of 64 (or 32) input channels it stages the input
//   halo once in shared memory, s8 by cp.async or through the GN prologue
//   evaluated once per halo element, and runs all 9 taps against it by
//   address shifts, on wgmma with A from registers (ldmatrix) and B from a
//   4-stage weight ring. The s8 input takes 160 output channels a block
//   (256-pixel tiles where they fill the card; where even 128-pixel tiles
//   leave half the card idle, two CTAs split the channel chunks and add
//   their exact sums through distributed shared memory); the GN prologue
//   takes 320, so each halo element is quantized once, with the weights
//   multicast by TMA to a cluster of two.
// - general (below), every other site (conv_in, odd channel counts, strided
//   channels): an implicit GEMM over 64-deep K tiles gathered per tap, the
//   128 x 64 tile of qconv_tile.cuh on mma.sync, double-buffered.
// The im2col matrix never exists in device memory. Both steps of the
// redesign landed: the halo (step A) and the wgmma main loop (step B).
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W): PERF.md row 10.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "qconv_sm90.cuh"

namespace {

using namespace vdq;
using Params = QConvParams;

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
__global__ void __launch_bounds__(kThreads) qconv3_general_kernel(const Params p) {
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
int launch_general(const Params& p, cudaStream_t stream) {
  const long long m = (long long)p.B * p.Ho * p.Wo;
  const dim3 grid(unsigned((m + kBM - 1) / kBM), unsigned((p.N + kBN - 1) / kBN));
  qconv3_general_kernel<T, IN_KIND><<<grid, kThreads, 0, stream>>>(p);
  return int(cudaGetLastError());
}

// dynamic shared memory above 48 KB needs the opt-in, once per kernel
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

template <typename T, int KC, int BN, int BM>
int launch_halo(const Params& p, int smem, cudaStream_t stream) {
  const int need = halo_smem_bytes<KC, BN, BM>(p.halo_h * p.halo_w);
  const int reduce = p.splitk == 2 ? BM * BN * 4 : 0;  // the second CTA's s32 sums
  if (smem != (need > reduce ? need : reduce) || p.rows * p.Wo > BM ||
      (p.splitk == 2 && p.C / KC < 2))
    return int(cudaErrorInvalidValue);
  auto kernel = qconv3_halo_kernel<T, KC, BN, BM>;
  static int smem_set = 0;
  if (const int rc = allow_smem(kernel, smem, smem_set)) return rc;
  const dim3 grid(unsigned(p.B * p.tiles), unsigned((p.N + BN - 1) / BN), unsigned(p.splitk));
  if (p.splitk == 1) {
    kernel<<<grid, 2 * BM, smem, stream>>>(p);
    return int(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(2 * BM);
  cfg.dynamicSmemBytes = size_t(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 2;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, p);
  if (rc != cudaSuccess) return int(rc);
  return int(cudaGetLastError());
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The weights [N, 9 * C] as a 2-D tensor map (K bytes, output channels); a
// box is KC bytes x `rows` channels, laid out with the KC-byte swizzle.
int weight_map(CUtensorMap* map, const int8_t* w, int N, int C, int rows, int kc) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    if (rc != cudaSuccess || q != cudaDriverEntryPointSuccess || fn == nullptr)
      return int(rc != cudaSuccess ? rc : cudaErrorSymbolNotFound);
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {cuuint64_t(9 * C), cuuint64_t(N)};
  const cuuint64_t strides[1] = {cuuint64_t(9 * C)};
  const cuuint32_t box[2] = {cuuint32_t(kc), cuuint32_t(rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(w), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            kc == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : int(cudaErrorInvalidValue);
}

template <typename T, int KC, int BN>
int launch_halo_gn(Params p, int smem, cudaStream_t stream) {
  const int raw_bytes = p.raw ? KC * p.halo_h * p.W * int(sizeof(T)) : 0;
  if (smem != gn_smem_bytes<KC, BN>(p.halo_h * p.halo_w, raw_bytes) || p.rows * p.Wo > 128)
    return int(cudaErrorInvalidValue);
  auto kernel = qconv3_halo_gn_kernel<T, KC, BN>;
  // the producer warpgroups' setmaxnreg.dec must free what the consumers'
  // .inc takes: a kernel compiled to fewer registers would wait forever
  static int regs = -1;
  if (regs < 0) {
    cudaFuncAttributes attr;
    const cudaError_t rc = cudaFuncGetAttributes(&attr, kernel);
    if (rc != cudaSuccess) return int(rc);
    regs = attr.numRegs;
  }
  if (regs * (kHaloThreads + kProducerThreads) <
      kConsumerRegs * kHaloThreads + kProducerRegs * kProducerThreads)
    return int(cudaErrorInvalidConfiguration);
  static int smem_set = 0;
  if (const int rc = allow_smem(kernel, smem, smem_set)) return rc;
  constexpr int SUB = BN < 160 ? BN : 160;
  CUtensorMap map;
  if (const int rc = weight_map(&map, p.w, p.N, p.C, SUB, KC)) return rc;
  const unsigned gx = unsigned(p.B * p.tiles);
  p.cluster = (BN == 320 && gx % 2 == 0) ? 2 : 1;  // pairs of tiles share the weights
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gx, unsigned((p.N + BN - 1) / BN));
  cfg.blockDim = dim3(kHaloThreads + kProducerThreads);
  cfg.dynamicSmemBytes = size_t(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(p.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, p, map);
  if (rc != cudaSuccess) return int(rc);
  return int(cudaGetLastError());
}

template <typename T, int KC>
int dispatch_s8(const Params& p, int bn, int bm, int smem, cudaStream_t stream) {
  if (bm == 128 && bn == 64) return launch_halo<T, KC, 64, 128>(p, smem, stream);
  if (bm == 128 && bn == 160) return launch_halo<T, KC, 160, 128>(p, smem, stream);
  if constexpr (KC == 64) {  // 256-pixel tiles: the weights streamed half as often
    if (bm == 256 && bn == 160) return launch_halo<T, KC, 160, 256>(p, smem, stream);
  }
  return int(cudaErrorInvalidValue);
}

template <typename T, int KC>
int dispatch_gn(const Params& p, int bn, int smem, cudaStream_t stream) {
  if (bn == 64) return launch_halo_gn<T, KC, 64>(p, smem, stream);
  if (bn == 160) return launch_halo_gn<T, KC, 160>(p, smem, stream);
  if (bn == 320) return launch_halo_gn<T, KC, 320>(p, smem, stream);  // the prologue once
  return int(cudaErrorInvalidValue);
}

template <typename T, int IN_KIND>
int dispatch(const Params& p, int path, int kc, int bn, int bm, int smem, cudaStream_t stream) {
  if (path == 0) return launch_general<T, IN_KIND>(p, stream);
  if ((IN_KIND == 1 && (bm != 128 || p.splitk != 1)) || (IN_KIND == 0 && path == 2) ||
      (p.splitk != 1 && p.splitk != 2))
    return int(cudaErrorInvalidValue);
  if (kc == 64) {
    return IN_KIND == 0 ? dispatch_s8<T, 64>(p, bn, bm, smem, stream)
                        : dispatch_gn<T, 64>(p, bn, smem, stream);
  }
  if (kc == 32) {
    return IN_KIND == 0 ? dispatch_s8<T, 32>(p, bn, bm, smem, stream)
                        : dispatch_gn<T, 32>(p, bn, smem, stream);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

// in_kind: 0 s8 input codes, 1 GroupNorm prologue on an input of the output
// dtype; out_kind: 0 bf16, 1 f32 (film and res share the output dtype).
// path 0 general, 1 halo with `rows` output rows a tile of at most `bm`
// pixels, `kc` input channels a staged halo, `bn` output channels a block,
// the channel chunks split over `splitk` CTAs (s8 input) and `smem` bytes of
// dynamic shared memory, 2 the same with the GN prologue's input rows staged
// by cp.async (qconv3_plan). Returns a cudaError_t code; 0 means the
// launch was accepted.
extern "C" int vd_qconv3(const void* x, const void* w, const void* w_scale, const void* bias,
                         const void* s_x, const void* stats, const void* gamma, const void* beta,
                         const void* film, const void* res, void* out, int B, int H, int W, int C,
                         int N, int stride, int with_silu, int vec_a, int vec_b, long long sxb, long long sxh,
                         long long sxw, long long sxc, long long srb, long long srh,
                         long long srw, long long src, long long sob, long long soh,
                         long long sow, long long soc, long long film_sb, int in_kind,
                         int out_kind, int path, int rows, int kc, int bn, int bm, int splitk,
                         int smem, void* stream) {
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
  p.rows = rows;
  p.tiles = rows > 0 ? (p.Ho + rows - 1) / rows : 0;
  p.halo_h = (rows - 1) * stride + 3;
  p.halo_w = (p.Wo - 1) * stride + 3;
  p.halo_we = (p.halo_w + 1) / 2;
  p.hp_magic = div_magic(unsigned(p.halo_h * p.halo_w));
  p.hw_magic = div_magic(unsigned(p.halo_w));
  p.cluster = 1;
  p.splitk = splitk;
  p.raw = path == 2;
  p.sxb = sxb; p.sxh = sxh; p.sxw = sxw; p.sxc = sxc;
  p.srb = srb; p.srh = srh; p.srw = srw; p.src = src;
  p.sob = sob; p.soh = soh; p.sow = sow; p.soc = soc;
  p.film_sb = film_sb;
  if (path >= 1 && (rows < 1 || C % kc != 0 ||
                    p.halo_h * p.halo_w * (kc / 4) >= (1 << 16))) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_kind == 0 && out_kind == 0) return dispatch<__nv_bfloat16, 0>(p, path, kc, bn, bm, smem, st);
  if (in_kind == 0 && out_kind == 1) return dispatch<float, 0>(p, path, kc, bn, bm, smem, st);
  if (in_kind == 1 && out_kind == 0) return dispatch<__nv_bfloat16, 1>(p, path, kc, bn, bm, smem, st);
  if (in_kind == 1 && out_kind == 1) return dispatch<float, 1>(p, path, kc, bn, bm, smem, st);
  return int(cudaErrorInvalidValue);
}
