"""The three kernels of ``scripts/mosaic_probe.py`` (rows 12-14 of the kernel
table), each a hand-written Hopper kernel beside its plain version.

- ``probe_s8mm`` (row 12, ``mm_kernel``): s8 [M, K] x s8 [K, N] -> s32,
  exact; CUDA C++ on int8 ``mma.sync`` (``csrc/probe_s8mm.cu``).
- ``probe_shift`` (row 13, ``shift_kernel``): i32 [M, C] -> i32 [M, C],
  out[r] = sum of x[r + o] over o in (-66, -1, 1, 66) with 0 <= r + o < M
  (the TPU kernel's ``acc[lo:hi] += x[lo + o:hi + o]``), int32 wrap-around
  sums; Triton.
- ``probe_scratch`` (row 14, ``scratch_kernel``): bf16 [M, C] -> s8
  [M, C], out[0] = 0 and out[r] = s8(x[r - 1]): the TPU kernel writes the
  s8 cast at row offset 2 of a zeroed [M + 4, C] scratch and reads rows
  1 .. M back. The cast truncates toward zero and saturates, as XLA's
  convert does (42.5 -> 42, -32.25 -> -32; values beyond [-128, 127] give
  -128 or 127; NaN is unspecified); Triton.

Rows 13 and 14: each output element reads at most four input elements at
fixed row offsets and writes one; nothing is reused across threads, so the
kernel is masked block loads, which Triton expresses directly (the edge
rows ``lo``/``hi`` are the masks). Their bounds (2.70 MB and 0.49 MB moved
at the probe's shapes: 0.0008 and 0.00015 ms at 3.35 TB/s) sit below a
launch's fixed cost.

Every wrapper takes the plain version for CPU tensors only; for CUDA
tensors it launches its kernel or raises. ``launches`` counts kernel
launches.
"""
from __future__ import annotations

import torch

SHIFT_OFFSETS = (-66, -1, 1, 66)
SCRATCH_ROW_OFFSET = 1   # out[r] = cast(x[r - 1]): written at +2, read from +1
_BM, _BC = 32, 64        # rows x columns per Triton program
MAX_K = ((1 << 31) - 1) // (128 * 128)   # |sum| <= K * 128 * 128 fits s32


def probe_s8mm_plain(a, b):
    """s8 [M, K] x s8 [K, N] -> s32 [M, N] in f64 (exact while every partial
    sum stays below 2^53; the wrapper bounds K so that it stays in s32)."""
    return (a.double() @ b.double()).to(torch.int32)


def probe_shift_plain(x):
    out = torch.zeros_like(x)
    m = x.shape[0]
    for o in SHIFT_OFFSETS:
        lo, hi = max(0, -o), m - max(0, o)
        out[lo:hi] += x[lo + o:hi + o]
    return out


def s8_convert(x):
    """float -> int8 as XLA converts: truncate toward zero, saturate."""
    return x.float().trunc().clamp(-128, 127).to(torch.int8)


def probe_scratch_plain(x):
    out = torch.zeros(x.shape, dtype=torch.int8, device=x.device)
    out[SCRATCH_ROW_OFFSET:] = s8_convert(x[:x.shape[0] - SCRATCH_ROW_OFFSET])
    return out


def _check_cuda(name: str, t, dtype, dim: int = 2):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
        raise TypeError(f"{name} takes a contiguous {dim}-D {dtype} tensor, got {t.dtype} "
                        f"{tuple(t.shape)}")


def probe_s8mm(a, b):
    """s8 [M, K] x s8 [K, N] -> s32 [M, N], exact. The kernel takes K a
    multiple of 16 and at most ``MAX_K`` deep (no s32 overflow)."""
    if a.device.type == "cpu":
        return probe_s8mm_plain(a, b)
    from vdtpu_torch.ops.kernels.build import load
    _check_cuda("probe_s8mm", a, torch.int8)
    _check_cuda("probe_s8mm", b, torch.int8)
    (m, k), n = a.shape, b.shape[1]
    if b.shape[0] != k or b.device != a.device:
        raise ValueError(f"probe_s8mm: a {tuple(a.shape)} and b {tuple(b.shape)} do not chain")
    if k % 16 or k > MAX_K or a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"probe_s8mm: K = {k} must be a multiple of 16 and at most {MAX_K}, "
                         f"operands 16-byte aligned")
    c = torch.empty((m, n), dtype=torch.int32, device=a.device)
    lib = load("probe_s8mm")
    with torch.cuda.device(a.device):
        rc = lib.vd_probe_s8mm(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                               int(n % 16 == 0), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"probe_s8mm launch failed: cudaError {rc}")
    probe_s8mm.launches += 1
    return c


probe_s8mm.launches = 0

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
    def _shift_add(acc, x_ptr, r, c, M, C, O: tl.constexpr):
        src = r + O
        m = ((src >= 0) & (src < M) & (r < M))[:, None] & (c < C)[None, :]
        return acc + tl.load(x_ptr + src[:, None].to(tl.int64) * C + c[None, :], mask=m,
                             other=0)

    @triton.jit
    def shift_kernel(x_ptr, o_ptr, M, C, O0: tl.constexpr, O1: tl.constexpr,
                     O2: tl.constexpr, O3: tl.constexpr, BM: tl.constexpr, BC: tl.constexpr):
        r = tl.program_id(0) * BM + tl.arange(0, BM)
        c = tl.program_id(1) * BC + tl.arange(0, BC)
        acc = tl.zeros([BM, BC], dtype=tl.int32)
        acc = _shift_add(acc, x_ptr, r, c, M, C, O0)
        acc = _shift_add(acc, x_ptr, r, c, M, C, O1)
        acc = _shift_add(acc, x_ptr, r, c, M, C, O2)
        acc = _shift_add(acc, x_ptr, r, c, M, C, O3)
        m = (r < M)[:, None] & (c < C)[None, :]
        tl.store(o_ptr + r[:, None].to(tl.int64) * C + c[None, :], acc, mask=m)

    @triton.jit
    def scratch_kernel(x_ptr, o_ptr, M, C, OFF: tl.constexpr, BM: tl.constexpr,
                       BC: tl.constexpr):
        r = tl.program_id(0) * BM + tl.arange(0, BM)
        c = tl.program_id(1) * BC + tl.arange(0, BC)
        src = r - OFF
        m_out = (r < M)[:, None] & (c < C)[None, :]
        m_in = m_out & (src >= 0)[:, None]
        v = tl.load(x_ptr + src[:, None].to(tl.int64) * C + c[None, :], mask=m_in, other=0.0)
        # truncate toward zero (cvt.rzi, saturating at the int32 range), then
        # saturate to int8 as XLA's convert does
        q = tl.minimum(tl.maximum(v.to(tl.float32).to(tl.int32), -128), 127)
        tl.store(o_ptr + r[:, None].to(tl.int64) * C + c[None, :], q.to(tl.int8), mask=m_out)

    _kernels = (triton, shift_kernel, scratch_kernel)
    return _kernels


def _grid(triton, m: int, c: int):
    return (triton.cdiv(m, _BM), triton.cdiv(c, _BC))


def probe_shift(x):
    """i32 [M, C] -> i32 [M, C], the sum of the rows at offsets -66, -1, 1, 66."""
    if x.device.type == "cpu":
        return probe_shift_plain(x)
    _check_cuda("probe_shift", x, torch.int32)
    triton, shift_k, _ = _triton_kernels()
    m, c = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        shift_k[_grid(triton, m, c)](x, out, m, c, *SHIFT_OFFSETS, BM=_BM, BC=_BC, num_warps=4)
    probe_shift.launches += 1
    return out


probe_shift.launches = 0


def probe_scratch(x):
    """bf16 [M, C] -> s8 [M, C]: row 0 zero, row r the s8 cast of x[r - 1]."""
    if x.device.type == "cpu":
        return probe_scratch_plain(x)
    _check_cuda("probe_scratch", x, torch.bfloat16)
    triton, _, scratch_k = _triton_kernels()
    m, c = x.shape
    out = torch.empty((m, c), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        scratch_k[_grid(triton, m, c)](x, out, m, c, OFF=SCRATCH_ROW_OFFSET, BM=_BM, BC=_BC,
                                       num_warps=4)
    probe_scratch.launches += 1
    return out


probe_scratch.launches = 0
