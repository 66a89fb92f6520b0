"""Calibrated no-max attention forward: a hand-written CUDA kernel and its
plain version.

Counterpart of ``vdtpu/ops/pallas/flash.py::flash_attention_nomax``: the
int8 serving policy's attention, where a calibration pass recorded an upper
bound M on each head's scaled logits (``CrossAttention.attn_shift``), so
the softmax needs no running maximum. The kernel (``csrc/nomax_fwd.cu``)
follows the slim TPU kernel (``_nomax_slim_kernel``): q~ = q * scale *
log2(e) rounded to the input dtype, p = exp2(q~ . k^T - M * log2(e)) in
f32, bf16(p) . v accumulated in f32, the f32 row sum of p as the
denominator, clamped at 1e-30; keys past the kv length get p = 0. The
same kernel serves the TPU's other two no-max kernels: d % 8 != 0
(``_nomax_kernel``, padded in shared memory here) and the native
[B, N, H*D] layout (``_nomax_packed_kernel``: pass [B, N, H, D] views of
it, read in place through strides).

``flash_attention_nomax`` takes the plain version for CPU tensors only;
for CUDA tensors it launches the kernel or raises. It is forward-only, as
the JAX package's is (serving; training keeps the exact flash kernels): it
raises where autograd would need its gradient.
"""
from __future__ import annotations

import torch

from vdtpu_torch.ops.flash import MAX_HEAD_DIM, _aligned

LOG2E = 1.4426950408889634


def _shift_per_head(shift, h: int, device):
    """A float or an [H] tensor -> f32 [H] on device."""
    s = torch.as_tensor(shift, dtype=torch.float32, device=device).reshape(-1)
    if s.numel() == 1:
        s = s.expand(h)
    if s.shape != (h,):
        raise ValueError(f"flash_attention_nomax: shift must be a float or [{h}], "
                         f"got {tuple(s.shape)}")
    return s.contiguous()


def flash_attention_nomax_plain(q, k, v, shift, scale: float | None = None):
    """The kernel's function in plain PyTorch on [B, N, H, D] / [B, M, H, D]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    m2 = _shift_per_head(shift, q.shape[2], q.device) * LOG2E
    qs = (q.float() * (scale * LOG2E)).to(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    p = torch.exp2(s - m2.reshape(1, -1, 1, 1))
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(), v.float())
    den = p.sum(dim=-1).transpose(1, 2)[..., None].clamp_min(1e-30)
    return (o / den).to(q.dtype)


def flash_attention_nomax(q, k, v, shift, scale: float | None = None):
    """No-max attention forward on [B, N, H, D] / [B, M, H, D]; ``shift`` is
    the calibrated bound on the scaled logits, a float or one per head [H]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("flash_attention_nomax is forward-only (int8 serving); train "
                           "without the int8 policy")
    if q.device.type == "cpu":
        return flash_attention_nomax_plain(q, k, v, shift, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_nomax: no kernel for device {q.device}")
    b, n, h, d = q.shape
    m = k.shape[1]
    if k.shape != (b, m, h, d) or v.shape != (b, m, h, d):
        raise ValueError(f"flash_attention_nomax: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash_attention_nomax kernel takes bf16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_nomax kernel takes d_head <= {MAX_HEAD_DIM}, got {d}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention_nomax: q, k and v must share one device")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention_nomax: the head axis must be contiguous")
    if n == 0 or m == 0 or b * h == 0:
        raise ValueError("flash_attention_nomax: empty attention")
    shift_h = _shift_per_head(shift, h, q.device)
    from vdtpu_torch.ops.kernels.build import load
    lib = load("nomax_fwd")
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    vec = int(d % 8 == 0 and all(_aligned(t) for t in (q, k, v)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.vd_nomax_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), shift_h.data_ptr(), 0,
            b, n, m, h, d, q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1),
            k.stride(2), v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(1),
            out.stride(2), float(scale * LOG2E), vec, stream)
    if rc != 0:
        raise RuntimeError(f"nomax_fwd launch failed: cudaError {rc}")
    flash_attention_nomax.launches += 1
    by_kv = flash_attention_nomax.launches_by_kv
    by_kv[m] = by_kv.get(m, 0) + 1
    return out


flash_attention_nomax.launches = 0
flash_attention_nomax.launches_by_kv = {}   # kv length -> launches (ToMe shortens it)
