"""GroupNorm(+SiLU): a hand-written Triton kernel and its plain version.

Counterpart of ``vdtpu/ops/pallas/gn_silu.py::gn_silu`` (its ``_kernel``,
reached through ``_fused_impl``). Both compute, per sample and group, f32
statistics as E[x^2] - E[x]^2 (clipped at 0, as flax's GroupNorm does),
then normalize, apply the per-channel affine and an optional SiLU, and cast
back to the input dtype. Layout here is channel-first, [B, C, *spatial]
contiguous, where one group of one sample is one contiguous run of
(C / G) * prod(spatial) elements.

Triton kernel: replaces the TPU kernel's "one whole sample per program",
which does not fit an SM (a 64x64x320 bf16 sample is 2.6 MB against at most
227 KB of shared memory). Bound on this card: one read and one write of x
at 3.35 TB/s (the statistics pass reads x a second time; at the UNet's
sizes that re-read mostly hits the 50 MB L2). Design: a split reduction.
  - stats pass, grid (B*G, S): each program sums x and x^2 in f32 over its
    1/S of the group and writes the two partial sums;
  - apply pass, same grid: each program reduces the group's S partials,
    normalizes its 1/S of the group, applies weight/bias (channel =
    g * C/G + offset // HW) and SiLU, and stores in the input dtype.
S is chosen so that both passes put about eight programs on each of the
132 SMs. At the UNet's sites the device time is 5-13 us a call, and the
host cost of the two Triton launches (about 0.05 ms) dominates; that is
recorded in PERF.md, not fixed, here.

``gn_silu`` takes the plain version for CPU tensors only; for CUDA tensors
it launches the kernels or raises.
"""
from __future__ import annotations

import torch

_BLOCK = 1024
_TARGET_PROGRAMS = 132 * 8
_MAX_SPLIT = 64


def gn_silu_plain(x, weight, bias, groups: int = 32, eps: float = 1e-5,
                  with_silu: bool = True):
    """GroupNorm(+SiLU) over [B, C, *spatial] in plain PyTorch (f32 math)."""
    b, c = x.shape[:2]
    xf = x.float().reshape(b, groups, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    y = y * weight.float().reshape(shape) + bias.float().reshape(shape)
    if with_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def split_count(bg: int, group_len: int) -> int:
    """Programs per group: enough to fill the card, each with >= one block."""
    s = 1
    while (s * 2 <= _MAX_SPLIT and bg * s < _TARGET_PROGRAMS
           and group_len >= s * 2 * _BLOCK):
        s *= 2
    return s


_kernels = None


def _triton_kernels():
    global _kernels
    if _kernels is not None:
        return _kernels
    from vdtpu_torch.ops.kernels.build import use_triton_cache_dir
    use_triton_cache_dir()
    import triton
    import triton.language as tl

    @triton.jit
    def gn_stats_kernel(x_ptr, part_ptr, L, CHUNK, S: tl.constexpr, BLOCK: tl.constexpr):
        bg = tl.program_id(0)
        s = tl.program_id(1)
        base = x_ptr + bg.to(tl.int64) * L
        start = s * CHUNK
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        acc2 = tl.zeros([BLOCK], dtype=tl.float32)
        for off in range(0, CHUNK, BLOCK):
            idx = start + off + tl.arange(0, BLOCK)
            xv = tl.load(base + idx, mask=idx < L, other=0.0).to(tl.float32)
            acc += xv
            acc2 += xv * xv
        out = part_ptr + (bg * S + s) * 2
        tl.store(out, tl.sum(acc, axis=0))
        tl.store(out + 1, tl.sum(acc2, axis=0))

    @triton.jit
    def gn_apply_kernel(x_ptr, y_ptr, w_ptr, b_ptr, part_ptr, L, HW, CPG, G, CHUNK,
                        inv_count, eps, S: tl.constexpr, SP: tl.constexpr,
                        BLOCK: tl.constexpr, WITH_SILU: tl.constexpr):
        bg = tl.program_id(0)
        s = tl.program_id(1)
        so = tl.arange(0, SP)
        sm = so < S
        tot = tl.sum(tl.load(part_ptr + (bg * S + so) * 2, mask=sm, other=0.0), axis=0)
        tot2 = tl.sum(tl.load(part_ptr + (bg * S + so) * 2 + 1, mask=sm, other=0.0), axis=0)
        mean = tot * inv_count
        var = tl.maximum(tot2 * inv_count - mean * mean, 0.0)
        rstd = 1.0 / tl.sqrt(var + eps)
        ch0 = (bg % G) * CPG
        base = bg.to(tl.int64) * L
        start = s * CHUNK
        for off in range(0, CHUNK, BLOCK):
            idx = start + off + tl.arange(0, BLOCK)
            m = idx < L
            xv = tl.load(x_ptr + base + idx, mask=m, other=0.0).to(tl.float32)
            ch = ch0 + idx // HW
            w = tl.load(w_ptr + ch, mask=m, other=0.0).to(tl.float32)
            bb = tl.load(b_ptr + ch, mask=m, other=0.0).to(tl.float32)
            y = (xv - mean) * rstd * w + bb
            if WITH_SILU:
                y = y / (1.0 + tl.exp(-y))
            tl.store(y_ptr + base + idx, y.to(y_ptr.dtype.element_ty), mask=m)

    _kernels = (triton, gn_stats_kernel, gn_apply_kernel)
    return _kernels


def gn_silu(x, weight, bias, groups: int = 32, eps: float = 1e-5, with_silu: bool = True):
    """GroupNorm(groups)(+SiLU) over the channel axis of [B, C, *spatial]."""
    if x.device.type == "cpu":
        return gn_silu_plain(x, weight, bias, groups, eps, with_silu)
    if x.device.type != "cuda":
        raise ValueError(f"gn_silu: no kernel for device {x.device}")
    if x.dim() < 2 or x.shape[1] % groups:
        raise ValueError(f"gn_silu: {groups} groups do not divide shape {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"gn_silu kernel: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("gn_silu kernel takes a contiguous channel-first tensor")
    b, c = x.shape[:2]
    if weight.shape != (c,) or bias.shape != (c,) or weight.device != x.device \
            or bias.device != x.device or not (weight.is_contiguous() and bias.is_contiguous()):
        raise ValueError("gn_silu: weight and bias must be contiguous [C] on x's device")
    if x.numel() == 0:
        raise ValueError("gn_silu: empty input")
    hw = x.numel() // (b * c)
    cpg = c // groups
    group_len = cpg * hw
    bg = b * groups
    s = split_count(bg, group_len)
    chunk = -(-group_len // (s * _BLOCK)) * _BLOCK
    triton, stats_k, apply_k = _triton_kernels()
    part = torch.empty((bg, s, 2), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stats_k[(bg, s)](x, part, group_len, chunk, S=s, BLOCK=_BLOCK, num_warps=4)
        apply_k[(bg, s)](x, y, weight, bias, part, group_len, hw, cpg, groups, chunk,
                         1.0 / group_len, float(eps), S=s, SP=max(2, triton.next_power_of_2(s)),
                         BLOCK=_BLOCK, WITH_SILU=bool(with_silu), num_warps=4)
    gn_silu.launches += 1
    return y


gn_silu.launches = 0
