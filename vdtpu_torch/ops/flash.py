"""Flash attention: hand-written CUDA kernels for the forward and the
backward, their plain versions, and the autograd function joining them.

Counterpart of ``vdtpu/ops/pallas/flash.py::flash_attention`` and its
custom_vjp ``_flash``. q is [B, N, H, D], k and v [B, M, H, D]; the result
is softmax(q.k^T * scale).v as [B, N, H, D] in the input dtype, with the TPU
kernels' numerics:
- forward (``_fwd_impl``, kernel ``csrc/flash_fwd.cu``): the scale is
  folded into q in the input dtype, logits and the softmax sums are f32,
  the probabilities are cast to the input dtype before the product with v;
  with ``with_lse`` it also returns lse = max + log(sum) per row, f32
  [B, H, N], the residual of the backward;
- backward (``_bwd_impl``, kernel ``csrc/flash_bwd.cu``): delta =
  rowsum(dO * O) in f32, p = exp(q.k^T * scale - lse) in f32 (q unscaled),
  dV = p^T.dO with p cast to the input dtype, dS = p * (dO.v^T - delta) *
  scale cast to the input dtype, dQ = dS.k, dK = dS^T.q. The kernel takes
  one pass over key blocks and adds dQ's f32 partials in device memory
  (``flash_attention_bwd_blocked_plain`` is that order of work in plain
  PyTorch, for the tests).

``flash_attention`` is differentiable: where autograd needs its gradient it
runs ``FlashAttention`` (forward with lse, saving q, k, v, o and lse;
backward through the backward kernels), otherwise the forward alone,
without lse. ``flash_attention_fwd`` and ``flash_attention_bwd`` take the
plain versions for CPU tensors only; for CUDA tensors they launch the
kernels or raise, never falling back. The kernels read q, k, v and dO in
place through their strides (any layout whose last axis is contiguous), so
callers pass views of their projections without copies. The plain versions
run with autocast off, so they keep their f32 arithmetic inside an
autocast region.
"""
from __future__ import annotations

import torch

MAX_HEAD_DIM = 256
MAX_BWD_HEAD_DIM = 128  # the backward kernel's widest head
BWD_KEYS, BWD_QUERIES = 128, 64  # csrc/flash_bwd.cu: keys a block owns, queries a tile
LOG2E = 1.4426950408889634


def flash_attention_plain(q, k, v, scale: float | None = None, with_lse: bool = False):
    """The forward kernel's function in plain PyTorch (its [B, H, N, M]
    scores live in memory): exact softmax with the unnormalized
    probabilities cast to the input dtype for the product with v, and the
    division by their f32 sum after it, as the online-softmax kernel does.
    With ``with_lse`` returns (out, lse [B, H, N] f32)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    with torch.autocast(q.device.type, enabled=False):
        qs = (q.float() * scale).to(q.dtype)
        s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(), v.float())
        out = (o / l.transpose(1, 2)[..., None]).to(q.dtype)
    return (out, m[..., 0] + torch.log(l)) if with_lse else out


def flash_attention_bwd_plain(q, k, v, o, lse, do, scale: float | None = None):
    """The backward kernels' function in plain PyTorch: (dq, dk, dv) of
    [B, N, H, D] / [B, M, H, D] in the input dtype from the forward's
    residuals (o, lse [B, H, N]) and the output gradient do."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dt = q.dtype
    with torch.autocast(q.device.type, enabled=False):
        delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2)       # [B, H, N]
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        p = torch.exp(s - lse[..., None])
        dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), do.float())
        dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
        ds = (p * (dp - delta[..., None]) * scale).to(dt).float()
        dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
        dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dq.to(dt), dk.to(dt), dv.to(dt)


def flash_attention_bwd_blocked_plain(q, k, v, o, lse, do, scale: float | None = None):
    """``flash_attention_bwd_plain``'s function in the backward kernel's order
    of work, for the tests: for each block of BWD_KEYS keys, one pass over
    tiles of BWD_QUERIES queries computing s and dP once, p = exp2(s *
    (scale log2 e) - lse log2 e) in f32 (keys past M masked), dV and dK of
    the block accumulated in f32 over the tiles from p and dS rounded to
    the input dtype, and dQ summed in f32 over the key blocks' partials."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dt = q.dtype
    b, n, h, d = q.shape
    m = k.shape[1]
    with torch.autocast(q.device.type, enabled=False):
        f = lambda t: t.float().transpose(1, 2)                       # [B, H, rows, D]
        qf, kf, vf, dof = f(q), f(k), f(v), f(do)
        delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2)  # [B, H, N]
        scale_log2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
        lse2 = lse.float() * torch.tensor(LOG2E, dtype=torch.float32)
        dq = torch.zeros(b, h, n, d)
        dk, dv = torch.zeros(b, h, m, d), torch.zeros(b, h, m, d)
        rnd = lambda t: t.to(dt).float()
        for k0 in range(0, m, BWD_KEYS):
            kb, vb = kf[:, :, k0:k0 + BWD_KEYS], vf[:, :, k0:k0 + BWD_KEYS]
            for q0 in range(0, n, BWD_QUERIES):
                qs = slice(q0, q0 + BWD_QUERIES)
                s = qf[:, :, qs] @ kb.transpose(-1, -2)               # [B, H, q, keys]
                p = torch.exp2(s * scale_log2 - lse2[:, :, qs, None])
                dp = dof[:, :, qs] @ vb.transpose(-1, -2)
                ds = p * (dp - delta[:, :, qs, None]) * scale
                dv[:, :, k0:k0 + BWD_KEYS] += rnd(p).transpose(-1, -2) @ dof[:, :, qs]
                dk[:, :, k0:k0 + BWD_KEYS] += rnd(ds).transpose(-1, -2) @ qf[:, :, qs]
                dq[:, :, qs] += rnd(ds) @ kb
    back = lambda t: t.transpose(1, 2).to(dt)
    return back(dq), back(dk), back(dv)


def _aligned(t: torch.Tensor) -> bool:
    """16-byte rows: the kernels' cp.async path needs every row start aligned."""
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])


def _check(name: str, q, k, v, max_d: int):
    """Device, shape, dtype and layout checks of the kernel wrappers."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    b, n, h, d = q.shape
    m = k.shape[1]
    if k.shape != (b, m, h, d) or v.shape != (b, m, h, d):
        raise ValueError(f"{name}: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"{name} kernel takes bf16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not 1 <= d <= max_d:
        raise ValueError(f"{name} kernel takes d_head <= {max_d}, got {d}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k and v must share one device")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: the head axis must be contiguous")
    if n == 0 or m == 0 or b * h == 0:
        raise ValueError(f"{name}: empty attention")


def flash_attention_fwd(q, k, v, scale: float, with_lse: bool = False):
    """(out, lse or None): the forward kernel, or its plain version for CPU
    tensors."""
    if q.device.type == "cpu":
        res = flash_attention_plain(q, k, v, scale, with_lse)
        return res if with_lse else (res, None)
    _check("flash_attention", q, k, v, MAX_HEAD_DIM)
    from vdtpu_torch.ops.kernels.build import load
    lib = load("flash_fwd")
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, n), dtype=torch.float32, device=q.device)
           if with_lse else None)
    vec = int(d % 8 == 0 and all(_aligned(t) for t in (q, k, v)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.vd_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, b, n, k.shape[1], h, d,
            q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(1),
            out.stride(2), float(scale), vec, stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {rc}")
    flash_attention.launches += 1
    return out, lse


def flash_attention_bwd(q, k, v, o, lse, do, scale: float):
    """(dq, dk, dv): the backward kernel (one pass over key blocks; its f32
    dQ workspace zeroed here and converted to bf16 by a second small kernel),
    or its plain version for CPU tensors. delta = rowsum(dO * O) is one plain
    elementwise pass here, as the JAX package computes it outside Pallas.
    dQ's f32 partials are added in device memory in no fixed order, so its
    last bits may differ from run to run."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    _check("flash_attention_bwd", q, k, v, MAX_BWD_HEAD_DIM)
    b, n, h, d = q.shape
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, h, n):
        raise ValueError(f"flash_attention_bwd: o{tuple(o.shape)} do{tuple(do.shape)} "
                         f"lse{tuple(lse.shape)} do not match q{tuple(q.shape)}")
    if do.dtype != q.dtype or do.stride(-1) != 1:
        do = do.to(q.dtype).contiguous()
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("flash_attention_bwd: lse must be contiguous f32 [B, H, N]")
    from vdtpu_torch.ops.kernels.build import load
    lib = load("flash_bwd")
    delta = (do.float() * o).sum(dim=-1).transpose(1, 2).contiguous()  # o promoted exactly
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    n_pad = -(-n // BWD_QUERIES) * BWD_QUERIES
    dq_acc = torch.zeros((b * h, n_pad, -(-d // 16) * 16), dtype=torch.float32, device=q.device)
    # aligned rows (and a 16-byte aligned lse, which the wgmma kernel reads
    # by TMA) take cp.async or TMA; anything else the element-wise loads
    vec = int(d % 8 == 0 and all(_aligned(t) for t in (q, k, v, do)) and lse.data_ptr() % 16 == 0)
    st = lambda t: (t.stride(0), t.stride(1), t.stride(2))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.vd_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dq_acc.data_ptr(),
            b, n, k.shape[1], h, d, n_pad, *st(q), *st(k), *st(v), *st(do), *st(dq), *st(dk),
            *st(dv), float(scale), vec, stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd launch failed: cudaError {rc}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """``_flash``'s custom_vjp: the forward saves (q, k, v, o, lse), the
    backward runs ``flash_attention_bwd``. Under autocast the backward sees
    the forward's dtypes (custom_fwd / custom_bwd)."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, q, k, v, scale: float):
        out, lse = flash_attention_fwd(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, scale: float | None = None):
    """Flash attention on [B, N, H, D] / [B, M, H, D], differentiable."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, scale)
    return flash_attention_fwd(q, k, v, scale)[0]


flash_attention.launches = 0
