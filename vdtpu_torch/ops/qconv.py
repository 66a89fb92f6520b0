"""int8 3x3 convolution: a hand-written CUDA kernel and its plain versions.

Counterpart of ``vdtpu/ops/pallas/qconv.py::qconv3_flat`` (its ``_kernel``:
GN+SiLU+quantize, the nine-tap s8 conv, dequant, bias, FiLM, residual) and
of the s8 x s8 -> s32 ``lax.conv_general_dilated`` inside
``vdtpu/ops/quant.py::QConv``, which every int8 conv site needs: PyTorch
has no int8 convolution on CUDA. The kernel is ``csrc/qconv3.cu`` with
its halo path in ``csrc/qconv_sm90.cuh``; their headers have the bound and
the design. ``qconv3_plan`` is the launch geometry in plain Python (path,
tile rows, channel chunk, output channels a block, grid, shared memory),
which the wrapper hands to the kernel and the CPU tests check; each wrapper
counts its launches by path in ``launches_by_path``.

- ``qconv3``: s8 channels-last input [B, H, W, C] (the per-site path, after
  a quantize), NCHW output.
- ``qconv3_gn``: the compute-dtype NCHW activation plus its GroupNorm
  statistics ([B, 2, C] from ``ops/gn_silu.py::gn_stats``); GN, SiLU and
  the divide-quantize run while the kernel stages each tile (the
  ``conv="fused"`` policy).
- ``qconv3_flat``: the JAX signature, flat [B, H*W, C] in and out, weights
  [3, 3, C, N].

The whole-ResBlock kernel (``conv="fused2"``) is ``csrc/resblock_q.cu``,
counterpart of ``resblock_flat``'s ``_resblock_kernel``: GN1 statistics,
GN1+SiLU+quantize, conv1 + bias + FiLM with the mid rounded to the output
dtype and the GN2 statistics summed in its epilogue, GN2+SiLU+quantize,
conv2 + bias + skip, in one cooperative launch whose convs run row 10's
halo main loop. ``resblock_plan`` is its geometry (route, tile rows and
pixels, output channels a tile, grid, shared memory, statistics slots),
which the kernel derives again and refuses on a mismatch.
- ``resblock_q``: NCHW in and out (the port's layout), weights
  [N, 3, 3, C] and [N, 3, 3, N];
- ``resblock_plain``: its function in plain PyTorch;
- ``resblock_blocked_plain``: the same in the kernel's order of work (the
  statistics from its slots), for the tests;
- ``resblock_flat``: the JAX signature, flat [B, H*W, C] in and out.

Weights are int8 [N, 3, 3, C] (channels last), scales f32 [N]. The
epilogue is f32: acc * (s_x * s_w[n]) + bias[n] (+ FiLM [B, N]) (+ full
residual), then the output dtype. Padding is 1 and the stride 1 or 2.

The wrappers take the plain versions for CPU tensors only. For CUDA
tensors they launch the kernel or raise. The plain versions accumulate
the integer products in f64: every partial sum of s8 x s8 products over
at most 9 x 2560 taps stays far below 2^53, so it is exact (and CUDA has
no integer convolution).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from vdtpu_torch.ops.gn_silu import gn_apply, gn_stats, gn_stats_plain


def _epilogue(acc, s_x, w_scale, bias, add_vec, add_full, out_dtype):
    """acc [B, N, Ho, Wo] exact integers -> the dequantized output."""
    n = acc.shape[1]
    y = acc.float() * (s_x * w_scale.float()).reshape(1, n, 1, 1)
    if bias is not None:
        y = y + bias.float().reshape(1, n, 1, 1)
    if add_vec is not None:
        y = y + add_vec.float().reshape(add_vec.shape[0], n, 1, 1)
    if add_full is not None:
        y = y + add_full.float()
    return y.to(out_dtype)


def qconv3_plain(xq, wq, w_scale, bias, s_x, stride: int = 1, add_vec=None, add_full=None,
                 out_dtype=torch.float32):
    """The kernel's function (s8 input) in plain PyTorch: xq int8
    [B, H, W, C]; add_full NCHW; returns NCHW [B, N, Ho, Wo]."""
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), wq.permute(0, 3, 1, 2).double(),
                   stride=stride, padding=1)
    return _epilogue(acc, s_x, w_scale, bias, add_vec, add_full, out_dtype)


def gn_quantize_plain(x, stats, gamma, beta, s_x, with_silu: bool = True):
    """The kernel's prologue: GroupNorm from [B, 2, C] statistics, affine,
    SiLU and the divide-quantize, in f32; NCHW in, int8 [B, H, W, C] out."""
    y = gn_apply(x, stats, gamma, beta, with_silu)
    q = torch.clamp(torch.round(y / s_x), -127, 127).to(torch.int8)
    return q.permute(0, 2, 3, 1)


def qconv3_gn_plain(x, stats, gamma, beta, s_x, wq, w_scale, bias, with_silu: bool = True,
                    stride: int = 1, add_vec=None, add_full=None):
    """The kernel's function with the GN prologue, in plain PyTorch."""
    xq = gn_quantize_plain(x, stats, gamma, beta, s_x, with_silu)
    return qconv3_plain(xq, wq, w_scale, bias, s_x, stride, add_vec, add_full, x.dtype)


# the card's geometry (H100 SXM) and the kernel's constants (csrc/qconv3.cu,
# csrc/qconv_sm90.cuh, csrc/qconv_tile.cuh)
MAX_SMEM_BYTES = 232_448     # dynamic shared memory a block may opt into
HALO_TILE_PIXELS = 128       # a tile's output pixels (whole rows), or 256 (below)
HALO_STAGES = 4              # kStages: the weight ring
EPILOGUE_CHANNELS = 32       # kEpiCh: f32 output rows the epilogue stages at a time
GENERAL_SMEM_BYTES = 2 * (128 + 64) * (64 + 16)   # the general path's static tiles
WIDE_TILE_MIN_BLOCKS = 128   # 256-pixel tiles where they still fill a wave of 132 SMs
NUM_SMS = 132                # the plans' default: an H100 SXM
SM_SMEM_BYTES = 233_472      # shared memory an SM holds for its blocks (228 KB)


@functools.cache
def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index``, which both launches plan for."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


@dataclasses.dataclass(frozen=True)
class QConvPlan:
    """Geometry of one int8 conv launch: ``path`` "halo" (whole output rows
    of one image a block, the input halo staged once per channel chunk) or
    "general" (K tiles gathered per tap); ``rows`` output rows a tile of at
    most ``bm`` pixels, ``kc`` input channels a staged halo, ``bn`` output
    channels a block, ``grid`` (x, y) blocks, ``smem_bytes`` shared memory
    a block, the halo's ``halo_h`` x ``halo_w`` pixels (0 on the general
    path), ``raw``: the GN prologue's input rows staged in shared memory,
    and ``splitk``: CTAs sharing a tile's channel chunks (grid z)."""
    path: str
    rows: int
    kc: int
    bn: int
    grid: tuple[int, int]
    smem_bytes: int
    halo_h: int = 0
    halo_w: int = 0
    bm: int = HALO_TILE_PIXELS
    raw: bool = False
    splitk: int = 1


def qconv3_plan(b: int, h: int, w: int, c: int, n: int, stride: int, gn: bool = False,
                aligned: bool = True, raw_elt: int = 0, sms: int = NUM_SMS) -> QConvPlan:
    """The kernel's tile plan for input [b, c, h, w] -> n channels; ``gn``:
    the GroupNorm prologue (``qconv3_gn``).

    The halo path takes C % 32 == 0 and Wo <= 128 (``aligned``: s8 input
    and weights 16-byte aligned with unit channel stride, GN statistics and
    affine 16-byte aligned). A tile is rows = min(bm // Wo, Ho) whole output
    rows; the halo ((rows - 1) * stride + 3) x ((Wo - 1) * stride + 3)
    pixels of kc = 64 channels (32 when C % 64 != 0) is double-buffered. A
    block takes bn = 160 output channels when N % 160 == 0, else 64; with the
    GN prologue 320 when N % 320 == 0, so the prologue runs once per halo
    element, not once per N tile. Tiles are bm = 128 pixels, or 256 for the
    s8 input at kc = 64, bn = 160 where that still gives
    WIDE_TILE_MIN_BLOCKS blocks (each streams the weights once for twice
    the pixels). ``raw_elt``: bytes of a GN input element when its rows
    (pixel stride 1, 16-byte aligned) may be staged in shared memory, two
    chunks' worth, where they fit. The s8 input splits the channel chunks
    over two CTAs when twice the grid still fits one wave of resident
    blocks on ``sms`` SMs (the small maps). Everything else takes the
    general path."""
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    general = QConvPlan("general", 0, 64, 64, (-(-b * ho * wo // 128), -(-n // 64)),
                        GENERAL_SMEM_BYTES)
    if not aligned or c % 32 or wo > HALO_TILE_PIXELS:
        return general
    kc = 64 if c % 64 == 0 else 32
    bn = 320 if gn and n % 320 == 0 else 160 if n % 160 == 0 else 64
    bm = HALO_TILE_PIXELS
    wide_tiles = b * -(-ho // min(2 * bm // wo, ho))
    if not gn and kc == 64 and bn == 160 and wide_tiles * (n // bn) >= WIDE_TILE_MIN_BLOCKS:
        bm = 2 * HALO_TILE_PIXELS
    rows = min(bm // wo, ho)
    halo_h, halo_w = (rows - 1) * stride + 3, (wo - 1) * stride + 3
    halo_bytes = 2 * halo_h * halo_w * (kc + 16)
    if gn:   # the weight ring from a 1024-byte boundary, then its 2 x 4 mbarriers
        halo_bytes = -(-halo_bytes // 1024) * 1024 + 2 * HALO_STAGES * 8
    smem = max(halo_bytes + HALO_STAGES * bn * kc, EPILOGUE_CHANNELS * (bm + 4) * 4)
    if smem > MAX_SMEM_BYTES or halo_h * halo_w * kc // 4 >= 1 << 16:
        return general
    raw_bytes = 2 * kc * halo_h * w * raw_elt
    raw = (gn and raw_elt > 0 and w * raw_elt % 16 == 0
           and halo_bytes + HALO_STAGES * bn * kc + raw_bytes <= MAX_SMEM_BYTES)
    if raw:
        smem = max(halo_bytes + HALO_STAGES * bn * kc + raw_bytes, smem)
    grid = (b * -(-ho // rows), -(-n // bn))
    splitk = 1
    split_smem = max(smem, bm * bn * 4)   # the second CTA's s32 sums, handed over
    per_sm = min(1 if bm > 128 else 2, SM_SMEM_BYTES // (split_smem + 1024))
    if not gn and c // kc >= 2 and 2 * grid[0] * grid[1] <= sms * per_sm:
        splitk, smem = 2, split_smem
    return QConvPlan("halo", rows, kc, bn, grid, smem, halo_h, halo_w, bm, raw, splitk)


def _launch(x4, in_kind, wq, w_scale, bias, s_x, stride, add_vec, res4, out4,
            stats=None, gamma=None, beta=None, with_silu=True):
    """One kernel launch on logical NHWC views (any strides) of the input,
    the residual and the output."""
    from vdtpu_torch.ops.kernels.build import load
    b, h, w, c = x4.shape
    n = wq.shape[0]
    dev = x4.device
    if wq.dtype != torch.int8 or wq.shape != (n, 3, 3, c) or not wq.is_contiguous():
        raise ValueError(f"qconv3: weights must be contiguous int8 [N, 3, 3, {c}], got "
                         f"{wq.dtype} {tuple(wq.shape)}")
    if stride not in (1, 2):
        raise ValueError(f"qconv3: stride {stride} (1 or 2)")
    if not (torch.is_tensor(s_x) and s_x.numel() == 1 and s_x.dtype == torch.float32):
        raise ValueError("qconv3: s_x must be a one-element f32 tensor")
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    out_kind = {torch.bfloat16: 0, torch.float32: 1}.get(out4.dtype)
    if out_kind is None:
        raise TypeError(f"qconv3 kernel writes bf16 or f32, not {out4.dtype}")
    f32 = lambda t: t.float().contiguous()
    w_scale, bias = f32(w_scale), (f32(bias) if bias is not None else
                                   torch.zeros(n, device=dev))
    if w_scale.shape != (n,) or bias.shape != (n,):
        raise ValueError("qconv3: w_scale and bias must be [N]")
    tensors = [x4, wq, w_scale, bias, s_x, out4]
    if add_vec is not None:
        if add_vec.shape != (b, n) or add_vec.dtype != out4.dtype or add_vec.stride(1) != 1:
            raise ValueError(f"qconv3: FiLM vector must be [{b}, {n}] {out4.dtype}, "
                             f"unit-stride channels")
        tensors.append(add_vec)
    if res4 is not None:
        if res4.shape != (b, ho, wo, n) or res4.dtype != out4.dtype:
            raise ValueError(f"qconv3: residual must be [{b}, {n}, {ho}, {wo}] {out4.dtype}")
        tensors.append(res4)
    if in_kind == 1:
        if stats.shape != (b, 2, c) or stats.dtype != torch.float32 or not stats.is_contiguous():
            raise ValueError(f"qconv3_gn: stats must be contiguous f32 [{b}, 2, {c}]")
        gamma, beta = f32(gamma), f32(beta)
        tensors += [stats, gamma, beta]
    if any(t.device != dev for t in tensors):
        raise ValueError("qconv3: every tensor must be on the input's device")
    aligned_x = (x4.stride(3) == 1 and x4.data_ptr() % 16 == 0
                 and all(s % 16 == 0 for s in x4.stride()[:3]))
    vec_a = int(in_kind == 0 and c % 64 == 0 and aligned_x)
    vec_b = int(c % 64 == 0 and wq.data_ptr() % 16 == 0)
    # the halo path reads s8 input and weights 16 bytes at a time, and the GN
    # statistics and affine as float4
    aligned = wq.data_ptr() % 16 == 0 and (
        aligned_x if in_kind == 0 else all(t.data_ptr() % 16 == 0 for t in (stats, gamma, beta)))
    # the GN input's rows go to shared memory 16 bytes at a time
    elt = x4.element_size()
    rows_aligned = (in_kind == 1 and x4.stride(2) == 1 and x4.data_ptr() % 16 == 0
                    and all(s * elt % 16 == 0 for s in (x4.stride(0), x4.stride(1), x4.stride(3))))
    plan = qconv3_plan(b, h, w, c, n, stride, in_kind == 1, aligned, elt if rows_aligned else 0,
                       sm_count(_device_index(dev)))
    ptr = lambda t: 0 if t is None else t.data_ptr()
    rs = res4.stride() if res4 is not None else (0, 0, 0, 0)
    lib = load("qconv3")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.vd_qconv3(
            x4.data_ptr(), wq.data_ptr(), w_scale.data_ptr(), bias.data_ptr(), s_x.data_ptr(),
            ptr(stats), ptr(gamma), ptr(beta), ptr(add_vec), ptr(res4), out4.data_ptr(),
            b, h, w, c, n, stride, int(bool(with_silu)), vec_a, vec_b, *x4.stride(), *rs,
            *out4.stride(), add_vec.stride(0) if add_vec is not None else 0, in_kind,
            out_kind, 0 if plan.path == "general" else 2 if plan.raw else 1, plan.rows,
            plan.kc, plan.bn, plan.bm, plan.splitk, plan.smem_bytes, stream)
    if rc != 0:
        raise RuntimeError(f"qconv3 launch failed: cudaError {rc} ({plan})")
    return plan.path


def _nhwc(t):
    return None if t is None else t.permute(0, 2, 3, 1)


def qconv3(xq, wq, w_scale, bias, s_x, stride: int = 1, add_vec=None, add_full=None,
           out_dtype=torch.bfloat16):
    """int8 3x3 conv of s8 codes xq [B, H, W, C] -> [B, N, Ho, Wo] (NCHW) in
    out_dtype; add_vec [B, N], add_full [B, N, Ho, Wo]."""
    if xq.device.type == "cpu":
        return qconv3_plain(xq, wq, w_scale, bias, s_x, stride, add_vec, add_full, out_dtype)
    if xq.device.type != "cuda":
        raise ValueError(f"qconv3: no kernel for device {xq.device}")
    if xq.dtype != torch.int8 or xq.dim() != 4:
        raise TypeError(f"qconv3 takes int8 [B, H, W, C] codes, got {xq.dtype} "
                        f"{tuple(xq.shape)}")
    b, h, w, _ = xq.shape
    n = wq.shape[0]
    out = torch.empty((b, n, (h - 1) // stride + 1, (w - 1) // stride + 1), dtype=out_dtype,
                      device=xq.device)
    path = _launch(xq, 0, wq, w_scale, bias, s_x, stride, add_vec, _nhwc(add_full), _nhwc(out))
    qconv3.launches += 1
    qconv3.launches_by_path[path] += 1
    return out


qconv3.launches = 0
qconv3.launches_by_path = {"halo": 0, "general": 0}   # qconv3_plan's path -> launches


def qconv3_gn(x, stats, gamma, beta, s_x, wq, w_scale, bias, with_silu: bool = True,
              stride: int = 1, add_vec=None, add_full=None):
    """GroupNorm(+SiLU)+quantize prologue and int8 3x3 conv: x [B, C, H, W]
    in the compute dtype, stats [B, 2, C] -> [B, N, Ho, Wo] in x's dtype."""
    if x.device.type == "cpu":
        return qconv3_gn_plain(x, stats, gamma, beta, s_x, wq, w_scale, bias, with_silu,
                               stride, add_vec, add_full)
    if x.device.type != "cuda":
        raise ValueError(f"qconv3_gn: no kernel for device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 4:
        raise TypeError(f"qconv3_gn takes bf16 or f32 [B, C, H, W], got {x.dtype} "
                        f"{tuple(x.shape)}")
    b, _, h, w = x.shape
    n = wq.shape[0]
    out = torch.empty((b, n, (h - 1) // stride + 1, (w - 1) // stride + 1), dtype=x.dtype,
                      device=x.device)
    path = _launch(_nhwc(x), 1, wq, w_scale, bias, s_x, stride, add_vec, _nhwc(add_full),
                   _nhwc(out), stats, gamma, beta, with_silu)
    qconv3_gn.launches += 1
    qconv3_gn.launches_by_path[path] += 1
    return out


qconv3_gn.launches = 0
qconv3_gn.launches_by_path = {"halo": 0, "general": 0}


def qconv3_flat(x, gn_scale, gn_bias, s_act, wq, s_w, bias, h: int, w: int, groups: int = 32,
                eps: float = 1e-5, with_silu: bool = True, add_vec=None, add_full=None):
    """``vdtpu/ops/pallas/qconv.py::qconv3_flat``'s signature: flat
    [B, H*W, C] in, [B, H*W, N] out, weights int8 [3, 3, C, N], add_full
    [B, H*W, N]. The statistics come from ``gn_stats``."""
    b, m, c = x.shape
    if m != h * w:
        raise ValueError(f"qconv3_flat: {m} rows are not {h} x {w}")
    n = wq.shape[-1]
    x_nchw = x.reshape(b, h, w, c).permute(0, 3, 1, 2)
    stats = gn_stats(x_nchw.contiguous(), groups, eps)
    w_oc = wq.permute(3, 0, 1, 2).contiguous()
    res = None if add_full is None else add_full.reshape(b, h, w, n).permute(0, 3, 1, 2)
    s_act = torch.as_tensor(s_act, dtype=torch.float32, device=x.device).reshape(())
    y = qconv3_gn(x_nchw, stats, gn_scale, gn_bias, s_act, w_oc, s_w.reshape(n), bias,
                  with_silu, 1, add_vec, res)
    return y.permute(0, 2, 3, 1).reshape(b, m, n)


def resblock_plain(x, gn1_w, gn1_b, w1q, s1w, b1, sx1, film, gn2_w, gn2_b, w2q, s2w, b2, sx2,
                   skip=None, groups: int = 32, eps: float = 1e-5):
    """The whole-ResBlock kernel's function in plain PyTorch: x [B, C, H, W]
    (any strides), film [B, N], skip [B, N, H, W] or None (identity, C ==
    N). The mid is rounded to x's dtype where ``ref_resblock_flat`` rounds
    it; statistics are E[x^2] - E[x]^2 in f32, clipped at 0."""
    q1 = gn_quantize_plain(x, gn_stats_plain(x, groups, eps), gn1_w, gn1_b, sx1)
    mid = qconv3_plain(q1, w1q, s1w, b1, sx1, 1, film, None, x.dtype)
    q2 = gn_quantize_plain(mid, gn_stats_plain(mid, groups, eps), gn2_w, gn2_b, sx2)
    return qconv3_plain(q2, w2q, s2w, b2, sx2, 1, None, x if skip is None else skip, x.dtype)


# the whole-ResBlock kernel's constants (csrc/resblock_q.cu)
RB_TILES = ((256, 160), (256, 80), (128, 160), (128, 80), (128, 64))   # (bm, bn), preferred first
RB_MIN_FILL = 0.9            # conv tiles over the slots of the waves they take
RB_PHASE_SMEM = 128 * 68 + 4 * 64 * 4 + 64 * 8 + 16 * 8   # kPhaseSmem: the other phases' scratch
RB_MAX_GROUPS = 64


@dataclasses.dataclass(frozen=True)
class ResBlockPlan:
    """Geometry of one whole-ResBlock launch. ``route`` "halo" (both convs
    on row 10's halo main loop, GN2 statistics from conv1's epilogue) or
    "general" (the mma.sync implicit GEMM, GN2 statistics a pass over the
    mid). A conv tile is ``rows`` whole output rows of one sample, at most
    ``bm`` pixels (the block has 2 * bm threads), against ``bn`` output
    channels; ``kc`` input channels a staged halo chunk. ``phases`` are the
    launch's phases, a grid barrier between each two; ``conv_tiles`` the
    tiles of each conv phase; ``grid`` the blocks (resident on every SM);
    ``gn2_slots`` partial sums a GroupNorm group of the mid (one per row
    tile on the halo route, one on the general)."""
    route: str
    rows: int
    bm: int
    kc: int
    bn: int
    phases: tuple[str, ...]
    conv_tiles: int
    smem_bytes: int
    grid: int
    gn2_slots: int

    @property
    def barriers(self) -> int:
        return len(self.phases) - 1

    @property
    def fill(self) -> float:
        """Share of the grid's slots the conv tiles fill over the waves they take."""
        waves = -(-self.conv_tiles // self.grid)
        return self.conv_tiles / (waves * self.grid)


def _rb_pass(bn: int) -> int:
    """Output channels the two convs' epilogues stage at a time (csrc P)."""
    return 80 if bn == 160 else bn


def resblock_plan(b: int, h: int, w: int, c: int, n: int, groups: int = 32,
                  sms: int = NUM_SMS) -> ResBlockPlan:
    """The whole-ResBlock kernel's plan for x [b, c, h, w] -> n channels.

    The halo route takes C % 32 == 0 and N % 32 == 0: kc = 64 input
    channels a halo chunk where both C and N divide by 64, else 32. Of the
    (bm, bn) pairs of ``RB_TILES`` it takes the first whose conv tiles fill
    at least ``RB_MIN_FILL`` of the grid's slots over their waves (else the
    fullest), among those with: w <= bm (rows = min(bm // w, h) whole rows
    a tile), bm = 256 only at kc = 64, N % bn == 0 and every GroupNorm
    group of N inside one epilogue pass (so inside one N tile), shared
    memory within the card's. The grid is min(2 at bm 128, 1 at 256,
    what shared memory allows) blocks an SM x ``sms``. Everything else
    takes the general route (128 x 64 tiles, 256 threads)."""
    hw = h * w
    cpg = n // groups
    per_sm_of = lambda cap, smem: min(cap, SM_SMEM_BYTES // (smem + 1024))
    best = None
    if c % 32 == 0 and n % 32 == 0 and groups <= RB_MAX_GROUPS:
        kc = 64 if c % 64 == 0 and n % 64 == 0 else 32
        for bm, bn in RB_TILES:
            if (bm == 256 and kc != 64) or w > bm or n % bn or _rb_pass(bn) % cpg:
                continue
            rows = min(bm // w, h)
            halo_h, halo_w = rows + 2, w + 2
            smem = max(2 * halo_h * halo_w * (kc + 16) + HALO_STAGES * bn * kc,
                       _rb_pass(bn) * (bm + 4) * 4, bm * (_rb_pass(bn) + 1) * 4,
                       RB_PHASE_SMEM)
            per_sm = per_sm_of(2 if bm == 128 else 1, smem)
            if smem > MAX_SMEM_BYTES or per_sm < 1 or halo_h * halo_w * kc // 4 >= 1 << 16:
                continue
            s2 = -(-h // rows)
            plan = ResBlockPlan("halo", rows, bm, kc, bn,
                                ("gn1_partials", "quantize_x", "conv1", "quantize_mid", "conv2"),
                                b * s2 * (n // bn), smem, per_sm * sms, s2)
            if plan.fill >= RB_MIN_FILL:
                return plan
            if best is None or plan.fill > best.fill:
                best = plan
    if best is not None:
        return best
    smem = max(GENERAL_SMEM_BYTES, RB_PHASE_SMEM)
    return ResBlockPlan("general", 0, 128, 64, 64,
                        ("gn1_partials", "quantize_x", "conv1", "gn2_partials", "quantize_mid",
                         "conv2"),
                        b * -(-hw // 128) * -(-n // 64), smem, per_sm_of(2, smem) * sms, 1)


def _slot_stats(slots, count: float, cpg: int, eps: float):
    """[B, G, S, 2] partial sums -> [B, 2, C] (mean, rstd) as the kernel's
    group_stats finishes them: the slots summed, then f32 E[v^2] - E[v]^2
    clipped at 0."""
    tot = slots.sum(dim=2)
    a, q = tot[..., 0].float(), tot[..., 1].float()
    mean = a / count
    var = (q / count - mean * mean).clamp_min(0.0)
    rstd = 1.0 / torch.sqrt(var + eps)
    return torch.stack([mean, rstd], dim=1).repeat_interleave(cpg, dim=2)


def _group_slots(v, groups: int):
    """GN partial sums of v [B, C, H, W], one slot a (sample, group)."""
    b, c = v.shape[:2]
    vg = v.double().reshape(b, groups, -1)
    return torch.stack([vg.sum(2), (vg * vg).sum(2)], -1)[:, :, None]


def resblock_blocked_plain(x, gn1_w, gn1_b, w1q, s1w, b1, sx1, film, gn2_w, gn2_b, w2q, s2w, b2,
                           sx2, skip=None, groups: int = 32, eps: float = 1e-5,
                           plan: ResBlockPlan | None = None):
    """``resblock_plain`` in the kernel's order of work (tests only): GN1
    statistics from one slot a group; on the halo route the GN2
    statistics from the partial sums that each conv1 tile (row tile x N
    tile) writes for each GroupNorm group of its channels, over the mid as
    rounded to x's dtype; on the general route from one slot a group of
    the mid. Slots are summed in f64 (the kernel's f32 sums differ in
    their last bits; the card tests hold those); every slot is written
    exactly once."""
    b, c, h, w = x.shape
    n = w1q.shape[0]
    plan = plan or resblock_plan(b, h, w, c, n, groups)
    hw, cpg1, cpg2 = h * w, c // groups, n // groups
    st1 = _slot_stats(_group_slots(x, groups), float(hw * cpg1), cpg1, eps)
    q1 = gn_quantize_plain(x, st1, gn1_w, gn1_b, sx1)
    mid = qconv3_plain(q1, w1q, s1w, b1, sx1, 1, film, None, x.dtype)
    if plan.route == "halo":
        m = mid.double()
        slots = torch.full((b, groups, plan.gn2_slots, 2), float("nan"), dtype=torch.float64)
        for mt in range(plan.gn2_slots):            # conv1's row tiles of each sample
            rows = slice(mt * plan.rows, min((mt + 1) * plan.rows, h))
            for nt in range(n // plan.bn):          # its N tiles
                for gl in range(plan.bn // cpg2):   # the groups of the tile's channels
                    grp = nt * plan.bn // cpg2 + gl
                    if not torch.isnan(slots[:, grp, mt]).all():
                        raise AssertionError(f"slot ({grp}, {mt}) written twice")
                    blk = m[:, grp * cpg2:(grp + 1) * cpg2, rows, :]
                    slots[:, grp, mt, 0] = blk.sum((1, 2, 3))
                    slots[:, grp, mt, 1] = (blk * blk).sum((1, 2, 3))
        if torch.isnan(slots).any():
            raise AssertionError("a GN2 slot was never written")
    else:
        slots = _group_slots(mid, groups)
    st2 = _slot_stats(slots, float(hw * cpg2), cpg2, eps)
    q2 = gn_quantize_plain(mid, st2, gn2_w, gn2_b, sx2)
    return qconv3_plain(q2, w2q, s2w, b2, sx2, 1, None, x if skip is None else skip, x.dtype)


def _pixel_strides(name, t4):
    """(batch, pixel, channel) strides of a logical [B, C, H, W] view whose
    pixels share one stride (NCHW, or flat [B, H*W, C] permuted)."""
    sb, sc, sh, sw = t4.stride()
    if sh != t4.shape[3] * sw and t4.shape[2] > 1:
        raise ValueError(f"resblock_q: {name} needs one pixel stride (NCHW or flat NHWC), "
                         f"got strides {t4.stride()}")
    return sb, sw, sc


def _resblock_launch(x, gn1_w, gn1_b, w1q, s1w, b1, sx1, film, gn2_w, gn2_b, w2q, s2w, b2, sx2,
                     skip, groups, eps, out):
    from vdtpu_torch.ops.kernels.build import load
    b, c, h, w = x.shape
    n = w1q.shape[0]
    dev = x.device
    dtype = {torch.bfloat16: 0, torch.float32: 1}.get(x.dtype)
    if dtype is None:
        raise TypeError(f"resblock_q takes bf16 or f32 activations, not {x.dtype}")
    for name, t, shape in (("w1q", w1q, (n, 3, 3, c)), ("w2q", w2q, (n, 3, 3, n))):
        if (t.dtype != torch.int8 or tuple(t.shape) != shape or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"resblock_q: {name} must be contiguous 16-byte aligned int8 "
                             f"{list(shape)}, got {t.dtype} {tuple(t.shape)}")
    if c % groups or n % groups or groups > RB_MAX_GROUPS:
        raise ValueError(f"resblock_q: {c} and {n} channels must divide into {groups} groups "
                         f"(at most {RB_MAX_GROUPS})")
    if skip is None and c != n:
        raise ValueError("resblock_q: an identity skip needs C == N")
    if skip is not None and (tuple(skip.shape) != (b, n, h, w) or skip.dtype != x.dtype):
        raise ValueError(f"resblock_q: skip must be [{b}, {n}, {h}, {w}] {x.dtype}")
    if tuple(film.shape) != (b, n) or film.dtype != x.dtype or film.stride(1) != 1:
        raise ValueError(f"resblock_q: film must be [{b}, {n}] {x.dtype}, unit-stride channels")
    for name, s_x in (("sx1", sx1), ("sx2", sx2)):
        if not (torch.is_tensor(s_x) and s_x.numel() == 1 and s_x.dtype == torch.float32):
            raise ValueError(f"resblock_q: {name} must be a one-element f32 tensor")
    f32 = lambda t, k: t.float().contiguous() if t is not None else torch.zeros(k, device=dev)
    vecs = [f32(t, k) for t, k in ((s1w, n), (b1, n), (gn1_w, c), (gn1_b, c), (s2w, n),
                                   (b2, n), (gn2_w, n), (gn2_b, n))]
    if any(v.shape != (k,) for v, k in zip(vecs, (n, n, c, c, n, n, n, n))):
        raise ValueError("resblock_q: scales, biases and GroupNorm affines must be 1-D")
    tensors = [x, w1q, w2q, sx1, sx2, film, out, *vecs] + ([skip] if skip is not None else [])
    if any(t.device != dev for t in tensors):
        raise ValueError("resblock_q: every tensor must be on the input's device")
    plan = resblock_plan(b, h, w, c, n, groups, sm_count(_device_index(dev)))
    hw = h * w
    mid = torch.empty((b, hw, n), dtype=x.dtype, device=dev)
    s8 = torch.empty((b * hw * max(c, n),), dtype=torch.int8, device=dev)
    part1 = torch.empty((b * groups * 2,), dtype=torch.float32, device=dev)
    part2 = torch.empty((b * groups * plan.gn2_slots * 2,), dtype=torch.float32, device=dev)
    sk = x if skip is None else skip
    strides = (*_pixel_strides("x", x), *_pixel_strides("skip", sk), *_pixel_strides("out", out),
               film.stride(0))
    ptr = lambda t: 0 if t is None else t.data_ptr()
    s1w_, b1_, g1w_, g1b_, s2w_, b2_, g2w_, g2b_ = vecs
    lib = load("resblock_q" if dtype == 0 else "resblock_q_f32")   # one library a dtype
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.vd_resblock_q(
            x.data_ptr(), ptr(skip), out.data_ptr(), w1q.data_ptr(), s1w_.data_ptr(),
            b1_.data_ptr(), g1w_.data_ptr(), g1b_.data_ptr(), sx1.data_ptr(), w2q.data_ptr(),
            s2w_.data_ptr(), b2_.data_ptr(), g2w_.data_ptr(), g2b_.data_ptr(), sx2.data_ptr(),
            film.data_ptr(), mid.data_ptr(), s8.data_ptr(), part1.data_ptr(), part2.data_ptr(),
            b, h, w, c, n, groups, float(eps), *strides, dtype,
            1 if plan.route == "halo" else 0, plan.rows, plan.kc, plan.bn, plan.bm,
            plan.smem_bytes, plan.grid, plan.gn2_slots, stream)
    if rc != 0:
        raise RuntimeError(f"resblock_q launch failed: cudaError {rc} ({plan}; a cooperative "
                           f"launch needs every block resident)")
    resblock_q.launches += 1
    resblock_q.launches_by_path[plan.route] += 1


def resblock_q(x, gn1_w, gn1_b, w1q, s1w, b1, sx1, film, gn2_w, gn2_b, w2q, s2w, b2, sx2,
               skip=None, groups: int = 32, eps: float = 1e-5):
    """Whole int8 ResBlock: x [B, C, H, W] in the compute dtype -> [B, N, H, W]
    in x's dtype. w1q int8 [N, 3, 3, C], w2q int8 [N, 3, 3, N] with f32
    scales s1w, s2w [N]; b1, b2 [N]; sx1, sx2 the calibrated activation
    scales (one-element f32); film [B, N]; skip [B, N, H, W] or None."""
    if x.device.type == "cpu":
        return resblock_plain(x, gn1_w, gn1_b, w1q, s1w, b1, sx1, film, gn2_w, gn2_b, w2q, s2w,
                              b2, sx2, skip, groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"resblock_q: no kernel for device {x.device}")
    if x.dim() != 4:
        raise TypeError(f"resblock_q takes [B, C, H, W], got {tuple(x.shape)}")
    b, _, h, w = x.shape
    out = torch.empty((b, w1q.shape[0], h, w), dtype=x.dtype, device=x.device)
    _resblock_launch(x, gn1_w, gn1_b, w1q, s1w, b1, sx1, film, gn2_w, gn2_b, w2q, s2w, b2, sx2,
                     skip, groups, eps, out)
    return out


resblock_q.launches = 0
resblock_q.launches_by_path = {"halo": 0, "general": 0}   # resblock_plan's route -> launches


def resblock_flat(x, gn1, w1q, s1w, b1, sx1, film, gn2, w2q, s2w, b2, sx2, h: int, w: int,
                  skip=None, groups: int = 32, eps: float = 1e-5):
    """``vdtpu/ops/pallas/qconv.py::resblock_flat``'s signature: flat
    [B, H*W, C] in, [B, H*W, N] out; gn1/gn2 (scale, bias); weights int8
    [3, 3, C, N] and [3, 3, N, N]; skip flat [B, H*W, N] or None."""
    b, m, c = x.shape
    if m != h * w:
        raise ValueError(f"resblock_flat: {m} rows are not {h} x {w}")
    n = w1q.shape[-1]
    nchw = lambda t: t.reshape(b, h, w, t.shape[-1]).permute(0, 3, 1, 2)
    as_f32 = lambda s: torch.as_tensor(s, dtype=torch.float32, device=x.device).reshape(())
    args = (gn1[0], gn1[1], w1q.permute(3, 0, 1, 2).contiguous(), s1w.reshape(n), b1,
            as_f32(sx1), film.reshape(b, n), gn2[0], gn2[1],
            w2q.permute(3, 0, 1, 2).contiguous(), s2w.reshape(n), b2, as_f32(sx2),
            None if skip is None else nchw(skip))
    if x.device.type == "cpu":
        y = resblock_plain(nchw(x), *args, groups, eps)
        return y.permute(0, 2, 3, 1).reshape(b, m, n)
    out = torch.empty((b, m, n), dtype=x.dtype, device=x.device)
    _resblock_launch(nchw(x), *args, groups, eps, nchw(out))
    return out
