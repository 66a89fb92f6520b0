// The attention forwards' wgmma kernel (csrc/attn_fwd_sm90.cuh) at heads of
// 88-160 (d % 8 == 0, 16-byte aligned rows), bf16 in, bf16 out, f32 scores
// and sums: the flash forward with or without lse (Mode Flash, FlashLse) and
// the calibrated no-max forward (Mode NoMax).
//
// Replaces, on those heads: vdtpu/ops/pallas/flash.py::_fwd_kernel (through
// _fwd_impl) and _nomax_slim_kernel / _nomax_packed_kernel (through
// _nomax_slim_impl / _nomax_packed_impl), which csrc/flash_fwd.cu's and
// csrc/nomax_fwd.cu's mma.sync kernels ran there before. The four-image
// mcg's 16^2 cross-attentions are the path's site: [4, 256, 8, 160] over
// 1028 keys, 250 launches a request.
//
// Bound at that site: q, k, v read once and out written once are 26.3 MB,
// 0.0078 ms at 3.35 TB/s; the two products are 5.4 GFLOP, 0.0055 ms at 989
// TFLOP/s; 8.4 M exponentials, 0.002 ms. Memory sets the bound. The design
// answers for the wide heads (key tiles, stages, registers) are in
// attn_fwd_sm90.cuh's head comment.
//
// These instantiations are a translation unit of their own so that they
// build beside csrc/flash_fwd.cu and csrc/nomax_fwd.cu (one nvcc each, in
// parallel) instead of lengthening either.

#include "attn_fwd_sm90.cuh"

// q, k, v, o: bf16 [B, rows, H, D] through (batch, row, head) element
// strides; lse: f32 [B, H, N] or nullptr (Flash / FlashLse); shift: the
// no-max bound of (b, h) at shift[b * shift_sb + h] (nomax != 0, where lse
// must be nullptr); qscale: the scale folded into q (scale for the flash
// forward, scale * log2 e for no-max). plan: the caller's AttnFwdPlan.code,
// which must be the wgmma kernel's code that vdattn::plan_code gives these
// arguments with d over 80 (cudaErrorInvalidValue otherwise). Returns a
// cudaError_t code; 0 means the launch was accepted.
extern "C" int vd_attn_fwd_wide(const void* q, const void* k, const void* v, void* o, void* lse,
                                const void* shift, long long shift_sb, int nomax, int B, int N,
                                int M, int H, int D, long long sqb, long long sqn, long long sqh,
                                long long skb, long long skn, long long skh, long long svb,
                                long long svn, long long svh, long long sob, long long son,
                                long long soh, float qscale, int plan, void* stream) {
  const long long strides[9] = {sqb, sqn, sqh, skb, skn, skh, svb, svn, svh};
  if (plan != vdattn::plan_code(D, N, q, k, v, strides) || !vdattn::is_wg(plan) ||
      D <= vdattn::kNarrowD || (nomax != 0 && (shift == nullptr || lse != nullptr)))
    return int(cudaErrorInvalidValue);
  vdattn::Args a = {};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.lse = static_cast<float*>(lse);
  a.shift = static_cast<const float*>(shift);
  a.shift_sb = shift_sb;
  a.B = B; a.N = N; a.M = M; a.H = H; a.D = D;
  a.sqb = sqb; a.sqn = sqn; a.sqh = sqh;
  a.skb = skb; a.skn = skn; a.skh = skh;
  a.svb = svb; a.svn = svn; a.svh = svh;
  a.sob = sob; a.son = son; a.soh = soh;
  a.qscale = qscale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nomax != 0) return vdattn::dispatch_wg_wide<vdattn::Mode::NoMax>(a, st);
  return lse != nullptr ? vdattn::dispatch_wg_wide<vdattn::Mode::FlashLse>(a, st)
                        : vdattn::dispatch_wg_wide<vdattn::Mode::Flash>(a, st);
}
