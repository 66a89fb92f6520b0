"""Flash-attention forward: a hand-written CUDA kernel and its plain version.

Counterpart of ``vdtpu/ops/pallas/flash.py::flash_attention`` (forward
only; the kernel is ``csrc/flash_fwd.cu``). Both take q [B, N, H, D] and
k, v [B, M, H, D] and return softmax(q.k^T * scale).v as [B, N, H, D] in the
input dtype, with the TPU kernel's numerics: the scale is folded into q in
the input dtype, logits and the softmax sums are f32, and the probabilities
are cast to the input dtype before the product with v.

``flash_attention`` takes the plain version for CPU tensors only. For CUDA
tensors it launches the kernel or raises; it never falls back. The kernel
reads q, k and v in place through their strides (any layout whose last axis
is contiguous), so callers pass views of their projections without copies.
"""
from __future__ import annotations

import torch

MAX_HEAD_DIM = 256


def flash_attention_plain(q, k, v, scale: float | None = None):
    """The kernel's function in plain PyTorch (its [B*H, N, M] scores live in
    memory): exact softmax with the unnormalized probabilities cast to the
    input dtype for the product with v, and the division by their f32 sum
    after it, as the online-softmax kernel does."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qs = (q.float() * scale).to(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(), v.float())
    return (o / p.sum(dim=-1).transpose(1, 2)[..., None]).to(q.dtype)


def _aligned(t: torch.Tensor) -> bool:
    """16-byte rows: the kernel's cp.async path needs every row start aligned."""
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])


def flash_attention(q, k, v, scale: float | None = None):
    """Flash-attention forward on [B, N, H, D] / [B, M, H, D]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    b, n, h, d = q.shape
    m = k.shape[1]
    if k.shape != (b, m, h, d) or v.shape != (b, m, h, d):
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash_attention kernel takes bf16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes d_head <= {MAX_HEAD_DIM}, got {d}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v must share one device")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head axis must be contiguous")
    if n == 0 or m == 0 or b * h == 0:
        raise ValueError("flash_attention: empty attention")
    from vdtpu_torch.ops.kernels.build import load
    lib = load("flash_fwd")
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    vec = int(d % 8 == 0 and all(_aligned(t) for t in (q, k, v)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.vd_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, m, h, d,
            q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(1),
            out.stride(2), float(scale), vec, stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
