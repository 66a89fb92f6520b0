"""The three kernels of ``scripts/mosaic_probe.py`` (rows 12-14 of the kernel
table), each a hand-written Hopper kernel beside its plain version.

- ``probe_s8mm`` (row 12, ``mm_kernel``): s8 [M, K] x s8 [K, N] -> s32,
  exact; CUDA C++ on wgmma with A by TMA and K split over a cluster
  (``csrc/probe_s8mm.cu``, geometry ``s8mm_plan``).
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

import dataclasses

import torch

SHIFT_OFFSETS = (-66, -1, 1, 66)
SCRATCH_ROW_OFFSET = 1   # out[r] = cast(x[r - 1]): written at +2, read from +1
_BM, _BC = 32, 64        # rows x columns per Triton program
MAX_K = ((1 << 31) - 1) // (128 * 128)   # |sum| <= K * 128 * 128 fits s32

# csrc/probe_s8mm.cu's geometry: a CTA takes S8MM_TILE_M rows of A against
# S8MM_TILE_N columns of C, K in k32 steps split over a cluster of `split`
# CTAs (1 to S8MM_MAX_SPLIT), a ring stage S8MM_STAGE_K bytes of K
S8MM_TILE_M = S8MM_TILE_N = 128
S8MM_STAGE_K = 64
S8MM_MAX_SPLIT = 4
# clusters of 1, 2, 3, 4 of the kernel's CTAs one NVIDIA H100 80GB HBM3 holds
# at once (cudaOccupancyMaxActiveClusters, one CTA an SM): only 30 clusters
# of 4 fit its GPCs. The wrapper asks the card it runs on.
H100_CLUSTERS = (132, 66, 39, 30)


@dataclasses.dataclass(frozen=True)
class S8mmPlan:
    grid: tuple[int, int, int]        # (row tiles, column tiles, split)
    split: int                        # CTAs of a cluster splitting K
    steps: tuple[tuple[int, int], ...]  # per cluster rank: k32 steps [first, end)
    tma_b: bool                       # B staged by TMA (N % 16 == 0), else read from memory

    def stages(self, rank: int) -> list[tuple[int, int]]:
        """The ring stages of one rank: (first k byte, k32 steps it runs)."""
        lo, hi = self.steps[rank]
        return [(32 * s, min(2, hi - s)) for s in range(lo, hi, 2)]


def s8mm_plan(m: int, n: int, k: int, clusters=H100_CLUSTERS) -> S8mmPlan:
    """The kernel's launch for s8 [m, k] x [k, n] on a card holding
    ``clusters[s - 1]`` clusters of s CTAs at once: the split with the
    fewest k32 steps a rank times waves of clusters (the smaller split on a
    tie), each rank of a split keeping at least one whole stage (two steps);
    rank r takes steps [r * nk // split, (r + 1) * nk // split), nk =
    ceil(k / 32)."""
    tiles_m, tiles_n = -(-m // S8MM_TILE_M), -(-n // S8MM_TILE_N)
    nk = -(-k // 32)

    def cost(split):
        return -(-tiles_m * tiles_n // clusters[split - 1]) * -(-nk // split)

    split = min((s for s in range(1, S8MM_MAX_SPLIT + 1) if s == 1 or nk >= 2 * s),
                key=lambda s: (cost(s), s))
    steps = tuple((r * nk // split, (r + 1) * nk // split) for r in range(split))
    return S8mmPlan((tiles_m, tiles_n, split), split, steps, n % 16 == 0)


def probe_s8mm_plain(a, b):
    """s8 [M, K] x s8 [K, N] -> s32 [M, N] in f64 (exact while every partial
    sum stays below 2^53; the wrapper bounds K so that it stays in s32)."""
    return (a.double() @ b.double()).to(torch.int32)


_card_clusters: dict[int, tuple[int, ...]] = {}


def _clusters(lib, device) -> tuple[int, ...]:
    """The card's cluster capacity for splits 1..S8MM_MAX_SPLIT, asked once."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _card_clusters:
        caps = tuple(lib.vd_probe_s8mm_clusters(s) for s in range(1, S8MM_MAX_SPLIT + 1))
        if min(caps) <= 0:
            raise RuntimeError(f"probe_s8mm: cluster occupancy query failed: {caps}")
        _card_clusters[idx] = caps
    return _card_clusters[idx]


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
        split = s8mm_plan(m, n, k, _clusters(lib, a.device)).split
        rc = lib.vd_probe_s8mm(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, split,
                               torch.cuda.current_stream().cuda_stream)
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
