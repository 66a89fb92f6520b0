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

The int8 serving policy adds two functions on the same split reduction
(kernel K2 of the port; Triton):
  - ``gn_stats``: the stats pass, then a finalize pass that writes [B, 2, C]
    f32 channel-broadcast (mean, rstd). Replaces
    ``vdtpu/ops/pallas/gn_silu.py::gn_stats`` (its ``_stats_kernel``).
  - ``gn_silu_q``: the stats pass, then an apply pass that normalizes,
    applies the affine and SiLU and quantizes to int8 with the static
    activation scale, clip(round half to even(y * (1 / s)), -127, 127): the
    multiply by the reciprocal of ``_kernel_q`` / ``_apply_q_kernel``, not
    ``_quantize_act``'s divide (codes can differ by one at rounding
    boundaries; ROADMAP queue 3). Replaces ``gn_silu_q`` (``_kernel_q``)
    and ``_gn_silu_q_blocked`` (``_stats_kernel`` + ``_apply_q_kernel``),
    whose two-pass design this already is.
The apply pass is where the layout changes: it reads x channel-first
(groups contiguous, as the statistics want) and stores the s8 codes
channels-last, [B, *spatial, C], which is what the int8 conv kernel
(``ops/qconv.py``) reads as its implicit-GEMM K axis. Each program takes a
[64 channels x 64 pixels] block, so both its loads (along pixels) and its
s8 stores (along channels) are contiguous runs; moving the layout here
costs no extra pass, where a separate transpose would read and write the
codes once more. Bound: one read of x and one s8 write, at [4, 320, 64,
64] 10.5 + 5.2 MB, about 0.0047 ms at 3.35 TB/s (the stats pass's
re-read mostly hits L2).

Every wrapper takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernels or raises.
"""
from __future__ import annotations

import torch

_BLOCK = 1024
_TARGET_PROGRAMS = 132 * 8
_MAX_SPLIT = 64
_QBLOCK = 64  # channels and pixels per program of the quantizing apply pass


def gn_stats_plain(x, groups: int = 32, eps: float = 1e-5):
    """[B, C, *spatial] -> [B, 2, C] f32: each channel's group (mean, rstd),
    E[x^2] - E[x]^2 clipped at 0, in plain PyTorch."""
    b, c = x.shape[:2]
    xf = x.float().reshape(b, groups, -1)
    mean = xf.mean(dim=-1)
    var = ((xf * xf).mean(dim=-1) - mean * mean).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    return torch.stack([mean, rstd], dim=1).repeat_interleave(c // groups, dim=2)


def gn_apply(x, stats, weight, bias, with_silu: bool = True):
    """GroupNorm(+SiLU) of [B, C, *spatial] from its [B, 2, C] statistics
    and the per-channel affine, in f32 (the result stays f32)."""
    shape = x.shape[:2] + (1,) * (x.dim() - 2)
    y = (x.float() - stats[:, 0].reshape(shape)) * stats[:, 1].reshape(shape)
    y = y * weight.float().reshape(shape[1:]) + bias.float().reshape(shape[1:])
    return y * torch.sigmoid(y) if with_silu else y


def gn_silu_plain(x, weight, bias, groups: int = 32, eps: float = 1e-5,
                  with_silu: bool = True):
    """GroupNorm(+SiLU) over [B, C, *spatial] in plain PyTorch (f32 math)."""
    st = gn_stats_plain(x, groups, eps)
    return gn_apply(x, st, weight, bias, with_silu).to(x.dtype)


def gn_silu_q_plain(x, weight, bias, s_act, groups: int = 32, eps: float = 1e-5,
                    with_silu: bool = True):
    """GroupNorm(+SiLU) then int8 codes with the static scale ``s_act``,
    clip(round(y * (1 / s_act)), -127, 127) (torch.round: half to even, as
    jnp.round); [B, C, *spatial] in, channels-last [B, *spatial, C] int8 out."""
    y = gn_apply(x, gn_stats_plain(x, groups, eps), weight, bias, with_silu)
    inv = 1.0 / torch.as_tensor(s_act, dtype=torch.float32, device=x.device)
    q = torch.round(y * inv).clamp(-127, 127).to(torch.int8)
    return q.movedim(1, -1).contiguous()


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

    @triton.jit
    def gn_finalize_kernel(part_ptr, out_ptr, C, CPG, G, inv_count, eps, S: tl.constexpr,
                           SP: tl.constexpr, BC: tl.constexpr):
        b = tl.program_id(0)
        c = tl.program_id(1) * BC + tl.arange(0, BC)
        cm = c < C
        so = tl.arange(0, SP)
        row = (b * G + c // CPG) * S
        m2 = cm[:, None] & (so[None, :] < S)
        tot = tl.sum(tl.load(part_ptr + (row[:, None] + so[None, :]) * 2, mask=m2, other=0.0), 1)
        tot2 = tl.sum(tl.load(part_ptr + (row[:, None] + so[None, :]) * 2 + 1, mask=m2,
                              other=0.0), 1)
        mean = tot * inv_count
        var = tl.maximum(tot2 * inv_count - mean * mean, 0.0)
        rstd = 1.0 / tl.sqrt(var + eps)
        tl.store(out_ptr + b * 2 * C + c, mean, mask=cm)
        tl.store(out_ptr + b * 2 * C + C + c, rstd, mask=cm)

    @triton.jit
    def gn_apply_q_kernel(x_ptr, q_ptr, w_ptr, b_ptr, part_ptr, s_ptr, C, HW, CPG, G,
                          inv_count, eps, S: tl.constexpr, SP: tl.constexpr,
                          BC: tl.constexpr, BP: tl.constexpr, WITH_SILU: tl.constexpr):
        b = tl.program_id(0)
        p = tl.program_id(1) * BP + tl.arange(0, BP)
        c = tl.program_id(2) * BC + tl.arange(0, BC)
        cm = c < C
        so = tl.arange(0, SP)
        row = (b * G + c // CPG) * S
        m2 = cm[:, None] & (so[None, :] < S)
        tot = tl.sum(tl.load(part_ptr + (row[:, None] + so[None, :]) * 2, mask=m2, other=0.0), 1)
        tot2 = tl.sum(tl.load(part_ptr + (row[:, None] + so[None, :]) * 2 + 1, mask=m2,
                              other=0.0), 1)
        mean = tot * inv_count
        var = tl.maximum(tot2 * inv_count - mean * mean, 0.0)
        rstd = 1.0 / tl.sqrt(var + eps)
        w = tl.load(w_ptr + c, mask=cm, other=0.0).to(tl.float32)
        bb = tl.load(b_ptr + c, mask=cm, other=0.0).to(tl.float32)
        inv = 1.0 / tl.load(s_ptr)
        m = cm[:, None] & (p[None, :] < HW)
        base = b.to(tl.int64) * C * HW
        xv = tl.load(x_ptr + base + c[:, None] * HW + p[None, :], mask=m, other=0.0)
        y = (xv.to(tl.float32) - mean[:, None]) * rstd[:, None] * w[:, None] + bb[:, None]
        if WITH_SILU:
            y = y / (1.0 + tl.exp(-y))
        v = tl.minimum(tl.maximum(y * inv, -127.0), 127.0)
        # round half to even: adding and removing 1.5 * 2^23 leaves the
        # nearest integer, ties to even, for |v| <= 2^22
        v = (v + 12582912.0) - 12582912.0
        tl.store(q_ptr + base + p[None, :] * C + c[:, None], v.to(tl.int8), mask=m)

    _kernels = (triton, gn_stats_kernel, gn_apply_kernel, gn_finalize_kernel,
                gn_apply_q_kernel)
    return _kernels


def gn_silu(x, weight, bias, groups: int = 32, eps: float = 1e-5, with_silu: bool = True):
    """GroupNorm(groups)(+SiLU) over the channel axis of [B, C, *spatial]."""
    if x.device.type == "cpu":
        return gn_silu_plain(x, weight, bias, groups, eps, with_silu)
    _check_gn_input("gn_silu", x, groups, weight, bias)
    b, c = x.shape[:2]
    hw = x.numel() // (b * c)
    triton, _, apply_k = _triton_kernels()[:3]
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        part, s, group_len, chunk = _stats_partials(x, groups)
        apply_k[(b * groups, s)](x, y, weight, bias, part, group_len, hw, c // groups, groups,
                                 chunk, 1.0 / group_len, float(eps), S=s,
                                 SP=max(2, triton.next_power_of_2(s)), BLOCK=_BLOCK,
                                 WITH_SILU=bool(with_silu), num_warps=4)
    gn_silu.launches += 1
    return y


gn_silu.launches = 0


def _check_gn_input(name: str, x, groups: int, weight=None, bias=None):
    """Shape/type checks shared by the kernel wrappers (CUDA tensors)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dim() < 2 or x.shape[1] % groups or x.numel() == 0:
        raise ValueError(f"{name}: {groups} groups do not divide shape {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"{name} kernel: unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} kernel takes a contiguous channel-first tensor")
    c = x.shape[1]
    for t in (weight, bias):
        if t is not None and (t.shape != (c,) or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name}: weight and bias must be contiguous [C] on x's device")


def _stats_partials(x, groups: int):
    """Launch the stats pass; returns (partials [B*G, S, 2], S, group_len,
    the elements each of the S programs of a group reads)."""
    b, c = x.shape[:2]
    hw = x.numel() // (b * c)
    group_len = (c // groups) * hw
    bg = b * groups
    s = split_count(bg, group_len)
    chunk = -(-group_len // (s * _BLOCK)) * _BLOCK
    stats_k = _triton_kernels()[1]
    part = torch.empty((bg, s, 2), dtype=torch.float32, device=x.device)
    stats_k[(bg, s)](x, part, group_len, chunk, S=s, BLOCK=_BLOCK, num_warps=4)
    return part, s, group_len, chunk


def gn_stats(x, groups: int = 32, eps: float = 1e-5):
    """[B, C, *spatial] -> [B, 2, C] f32 channel-broadcast (mean, rstd)."""
    if x.device.type == "cpu":
        return gn_stats_plain(x, groups, eps)
    _check_gn_input("gn_stats", x, groups)
    b, c = x.shape[:2]
    triton, fin_k = _triton_kernels()[0], _triton_kernels()[3]
    out = torch.empty((b, 2, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        part, s, group_len, _ = _stats_partials(x, groups)
        fin_k[(b, triton.cdiv(c, _QBLOCK))](
            part, out, c, c // groups, groups, 1.0 / group_len, float(eps), S=s,
            SP=max(2, triton.next_power_of_2(s)), BC=_QBLOCK, num_warps=4)
    gn_stats.launches += 1
    return out


gn_stats.launches = 0


def gn_silu_q(x, weight, bias, s_act, groups: int = 32, eps: float = 1e-5,
              with_silu: bool = True):
    """GroupNorm(+SiLU)+int8 quantize: [B, C, *spatial] in, channels-last
    int8 codes [B, *spatial, C] out; ``s_act`` is the static activation
    scale (a 0-d f32 tensor on x's device)."""
    if x.device.type == "cpu":
        return gn_silu_q_plain(x, weight, bias, s_act, groups, eps, with_silu)
    _check_gn_input("gn_silu_q", x, groups, weight, bias)
    if not (torch.is_tensor(s_act) and s_act.numel() == 1 and s_act.dtype == torch.float32
            and s_act.device == x.device):
        raise ValueError("gn_silu_q: s_act must be a one-element f32 tensor on x's device")
    b, c = x.shape[:2]
    hw = x.numel() // (b * c)
    triton, apply_q = _triton_kernels()[0], _triton_kernels()[4]
    q = torch.empty((b,) + tuple(x.shape[2:]) + (c,), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        part, s, group_len, _ = _stats_partials(x, groups)
        apply_q[(b, triton.cdiv(hw, _QBLOCK), triton.cdiv(c, _QBLOCK))](
            x, q, weight, bias, part, s_act, c, hw, c // groups, groups, 1.0 / group_len,
            float(eps), S=s, SP=max(2, triton.next_power_of_2(s)), BC=_QBLOCK, BP=_QBLOCK,
            WITH_SILU=bool(with_silu), num_warps=4)
    gn_silu_q.launches += 1
    return q


gn_silu_q.launches = 0
