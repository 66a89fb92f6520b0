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
  [B, H, N], the residual of the backward. ``attn_fwd_plan`` decides, from
  shape, dtype and alignment alone, which of its two kernels a call takes
  (the wgmma/TMA kernel of ``csrc/attn_fwd_sm90.cuh`` or the mma.sync one);
  ``flash_attention_fwd_blocked_plain`` is the wgmma kernel's order of
  work in plain PyTorch, for the tests;
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
kernels or raise, never falling back.

Heads of 88-160 with d % 8 == 0 and aligned rows take the same wgmma
kernel in bf16 (its instantiations in ``csrc/attn_fwd_wide.cu``, 64-key
tiles past d 128) and, in f32, a tf32x3 kernel of 64-row blocks
(``csrc/tf32x3_fwd_wide.cu``); the backward stays on heads up to 80 (no
path runs a wider one), so each head limit is split into a forward and a
backward limit.

bf16 takes the tensor-core kernels above. f32 q, k and v (the port's
default dtype: ``VDSystem(dtype=torch.float32)``, the CLI without
``--bf16``, an experiment that trains with ``bf16: false``) take one of two
f32 routes of the same sources, as the plan decides from shape and
alignment alone:
- "tf32x3" (``vd_flash_fwd_tf32x3``, ``vd_flash_bwd_tf32x3``): heads up to
  80 (forward: 160, ``vd_flash_fwd_tf32x3_wide`` past 80) with d % 8 == 0
  and 16-byte aligned rows (every f32 site of the UNet, the legacy zoo's
  AttentionBlock, the VAE's mid attention, the mcg's d-160
  cross-attentions): wgmma with
  split-f32 products, each operand split into tf32 hi and lo and each
  product taken as lo.hi + hi.lo + hi.hi in f32 accumulators (about 21
  bits of each product; one tf32 pass keeps 11), the softmax and every
  sum in f32. The streamed tiles (K and V forward; q, dO, k and v
  backward) are split once a call into a device workspace the wrappers
  allocate. The backward keeps the TPU's split (a dK/dV kernel and a dQ
  kernel), so no adds cross blocks and it is bit-equal across runs.
  ``flash_attention_fwd_tf32x3_blocked_plain`` and
  ``flash_attention_bwd_tf32x3_blocked_plain`` are their order of work and
  rounding in plain PyTorch, for the tests;
- "f32" (``vd_flash_fwd_f32``, ``vd_flash_bwd_f32``): SIMT kernels with
  f32 products, softmax and accumulators, for every other f32 head and
  layout.
Neither reads ``torch.backends.*.allow_tf32``: the plain versions are the
reference, in full f32. ``launches_by_path`` counts each path. The kernels read q, k, v and dO in
place through their strides (any layout whose last axis is contiguous), so
callers pass views of their projections without copies. The plain versions
run with autocast off, so they keep their f32 arithmetic inside an
autocast region.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

MAX_HEAD_DIM = 256
MAX_BWD_HEAD_DIM = 128  # the backward kernel's widest head
BWD_KEYS, BWD_QUERIES = 128, 64  # csrc/flash_bwd.cu: keys a block owns, queries a tile
LOG2E = 1.4426950408889634

# csrc/attn_fwd_sm90.cuh's geometry (the forward's wgmma kernel): consumer
# warpgroups of ATTN_WG_ROWS query rows (``_consumers``) and a producer
# warpgroup, ATTN_BK-key K/V tiles (ATTN_WIDE_BK past ATTN_WIDE_BK_D,
# ``_key_tile``) in a ring of up to ATTN_MAX_STAGES, heads up to
# ATTN_WG_MAX_D with d % 8 == 0 (past ATTN_WG_NARROW_D instantiated in
# csrc/attn_fwd_wide.cu); Q, K and V land as boxes of ATTN_BOX_COLS columns
# (128 bytes a row, 128-byte swizzle); the mma.sync kernels of
# csrc/flash_fwd.cu and csrc/nomax_fwd.cu take 64 query rows a block. The
# backward's wgmma kernel (csrc/flash_bwd.cu) takes heads up to
# ATTN_WG_BWD_MAX_D.
ATTN_WG_ROWS, ATTN_BK, ATTN_MAX_STAGES = 64, 128, 4
ATTN_WIDE_BK, ATTN_WIDE_BK_D = 64, 128
ATTN_WG_MAX_D = 160
ATTN_WG_NARROW_D = 80
ATTN_WG_BWD_MAX_D = 80
ATTN_BOX_COLS = 64
MAX_SMEM = 232448           # bytes of shared memory a block may take on an H100
F32_ROWS = 64               # the f32 route's query rows a block and keys a tile
# the tf32x3 route (csrc/tf32x3.cuh): forward heads up to TF32X3_MAX_D with
# d % 8 == 0 (past TF32X3_BWD_MAX_D the 64-row kernel of
# csrc/tf32x3_fwd_wide.cu, TF32X3_WIDE_TILE-key tiles), backward heads up to
# TF32X3_BWD_MAX_D; warpgroups of 64 rows (queries forward, keys or queries
# backward), two a block where shared memory holds them; the backward's
# streamed tiles TF32X3_BWD_TILE rows
TF32X3_MAX_D = 160
TF32X3_BWD_MAX_D = 80
TF32X3_WIDE_TILE = 32
TF32X3_BWD_TILE = 32
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _consumers(dp: int, n: int) -> int:
    """Consumer warpgroups a block (``vdattn::consumers``): three (192 query
    rows) for heads padded to 64 or less over 2048 queries or more, whose
    accumulators fit 160 registers; one (64 rows) for heads over
    ATTN_WG_NARROW_D over 256 queries or fewer (the mcg's 16^2
    cross-attention, where 128-row blocks would fill half the card); else
    two (at 1024 queries 192-row blocks leave a third of the last block
    empty and a second wave half full)."""
    if dp <= 64 and n >= 2048:
        return 3
    return 1 if dp > ATTN_WG_NARROW_D and n <= 256 else 2


def _key_tile(dp: int) -> int:
    """Keys a K/V tile of the wgmma forward (``vdattn::key_tile``): 128, or
    64 for heads padded past 128 (three boxes of 64 columns: two stages of
    128 keys would take 241 KB of shared memory at d 160)."""
    return ATTN_BK if dp <= ATTN_WIDE_BK_D else ATTN_WIDE_BK


@dataclasses.dataclass(frozen=True)
class AttnFwdPlan:
    """The launch of one attention forward (flash or no-max): ``path``
    "wgmma" (``attn_fwd_wg_kernel``) or "mma" (the mma.sync kernels, with
    16-byte cp.async loads where ``vec``). The C entry points recompute
    every field ``code`` carries and refuse a call whose code differs."""
    path: str
    dp: int                     # head padded to a multiple of 16 in shared memory
    block_q: int                # query rows a block
    block_k: int                # wgmma: keys a K/V tile
    stages: int                 # wgmma: K/V tiles in shared memory
    smem_bytes: int | None      # wgmma: dynamic shared memory of a block
    grid: tuple[int, int]       # (query blocks, B * H)
    vec: bool

    @property
    def code(self) -> int:
        """The int the C entry points take (``vdattn::plan_code``): 0 / 1 the
        mma.sync kernel without / with cp.async, else 2 | stages << 4 |
        block_k / 64 << 8 | block_q / 64 << 12 | smem_bytes / 8 << 16."""
        if self.path == "mma":
            return int(self.vec)
        return (2 | self.stages << 4 | (self.block_k // 64) << 8 | (self.block_q // 64) << 12
                | (self.smem_bytes // 8) << 16)


@functools.lru_cache(maxsize=None)
def _wg_geometry(dp: int, nc: int) -> tuple[int, int]:
    """(stages, shared-memory bytes) of the wgmma kernel (``vdattn::Geo``):
    1024 bytes to align its base, Q, the deepest K/V ring that fits, and
    the mbarriers (Q, full and empty a stage)."""
    row = -(-dp // ATTN_BOX_COLS) * ATTN_BOX_COLS * 2          # bytes of a tile's row
    bk = _key_tile(dp)
    smem = lambda s: 1024 + ATTN_WG_ROWS * nc * row + s * 2 * bk * row + 8 * (1 + 2 * s)
    stages = max(s for s in range(2, ATTN_MAX_STAGES + 1) if smem(s) <= MAX_SMEM)
    return stages, smem(stages)


def _rows_aligned(ptrs, strides, elem: int = 2) -> bool:
    """16-byte aligned data pointers and (batch, row, head) element strides
    of ``elem``-byte elements: every row of every head starts on 16 bytes
    (cp.async's 16-byte chunks, TMA's box starts, the tf32x3 route's
    16-byte loads)."""
    return not any(p % 16 for p in ptrs) and not any(s * elem % 16 for trio in strides
                                                     for s in trio)


def _takes_tf32x3(d: int, ptrs, strides) -> bool:
    """f32 operands the tf32x3 forward takes: d % 8 == 0 up to TF32X3_MAX_D,
    16-byte aligned rows (``vdf::takes``)."""
    return d % 8 == 0 and d <= TF32X3_MAX_D and _rows_aligned(ptrs, strides, 4)


def _tf32x3_fwd_tile(d: int) -> int:
    """Keys a tile of the tf32x3 forward (``FwdTc::kT``, ``Wide::kT``): 64
    for heads up to 48, else 32 (P's hi and lo fragments take a register a
    key)."""
    return 64 if d <= 48 else 32


def _tf32x3_wide_smem(d: int) -> int:
    """Shared memory of the wide tf32x3 forward (``Wide::kSmem``): two
    stages of K hi, K lo, V^T hi and V^T lo (TF32X3_WIDE_TILE x d floats
    each), Q's 64 rows in f32 at a stride of d + 4 floats, two mbarriers."""
    return 4 * (2 * 4 * TF32X3_WIDE_TILE * d + 64 * (d + 4)) + 16


def attn_fwd_plan(b: int, n: int, m: int, h: int, d: int, strides, ptrs,
                  dtype=torch.bfloat16) -> AttnFwdPlan:
    """Which forward kernel a call on q [b, n, h, d], k and v [b, m, h, d]
    takes, and its geometry. ``strides``: (batch, row, head) element
    strides of q, k and v; ``ptrs``: their data pointers. In f32 the
    tf32x3 kernel takes d <= 160 with d % 8 == 0 and aligned rows (no
    padding of d): up to 80 two warpgroups of 64 query rows a block sharing
    double-buffered split key tiles, past 80 one warpgroup a block with Q
    in f32 and 32-key tiles; the f32 route everything else (64 query rows
    a block, 64-key tiles). In bf16 the wgmma kernel takes d <= 160 with d
    % 8 == 0 and aligned rows (its tiles come by TMA; 64-key tiles past d
    128); everything else takes the mma.sync kernel."""
    dp = -(-d // 16) * 16
    if dtype == torch.float32:
        if _takes_tf32x3(d, ptrs, strides) and d > TF32X3_BWD_MAX_D:
            return AttnFwdPlan("tf32x3", d, 64, TF32X3_WIDE_TILE, 2, _tf32x3_wide_smem(d),
                               (-(-n // 64), b * h), True)
        if _takes_tf32x3(d, ptrs, strides):
            # FwdTc: two warpgroups' Q hi and lo, two stages of K hi, K lo,
            # V^T hi, V^T lo, their two mbarriers
            tile = _tf32x3_fwd_tile(d)
            return AttnFwdPlan("tf32x3", d, 128, tile, 2,
                               4 * (2 * 128 * d + 2 * 4 * tile * d) + 16,
                               (-(-n // 128), b * h), True)
        return AttnFwdPlan("f32", dp, F32_ROWS, F32_ROWS, 1, _f32_fwd_smem(dp),
                           (-(-n // F32_ROWS), b * h), False)
    vec = d % 8 == 0 and _rows_aligned(ptrs, strides)
    if vec and d <= ATTN_WG_MAX_D:
        block_q = ATTN_WG_ROWS * _consumers(dp, n)
        stages, smem = _wg_geometry(dp, block_q // ATTN_WG_ROWS)
        return AttnFwdPlan("wgmma", dp, block_q, _key_tile(dp), stages, smem,
                           (-(-n // block_q), b * h), True)
    return AttnFwdPlan("mma", dp, 64, 64, 2, None, (-(-n // 64), b * h), vec)


def _plan_for(q, k, v) -> AttnFwdPlan:
    b, n, h, d = q.shape
    return attn_fwd_plan(b, n, k.shape[1], h, d, tuple(t.stride()[:3] for t in (q, k, v)),
                         tuple(t.data_ptr() for t in (q, k, v)), q.dtype)


def _f32_fwd_smem(dp: int) -> int:
    """Shared memory of the forward's f32 kernel: Q and K rows of dp + 1
    floats, V rows of dp, the probabilities' 64 x 65."""
    return 4 * (F32_ROWS * (dp + 1) * 2 + F32_ROWS * dp + F32_ROWS * (F32_ROWS + 1))


def flash_bwd_path(d: int, dtype, vec: bool) -> str:
    """The backward kernels a call takes (csrc/flash_bwd.cu): in f32
    "tf32x3" for heads up to TF32X3_BWD_MAX_D (80) with d % 8 == 0 and
    aligned rows (``vec``), else "f32"; in bf16 "wgmma" for heads up to
    ATTN_WG_BWD_MAX_D (80) with aligned rows (``vec``), else "mma". The
    forward's wider limits (160) do not reach the backward: no path trains
    a head over 80."""
    if dtype == torch.float32:
        return "tf32x3" if vec and d <= TF32X3_BWD_MAX_D else "f32"
    return "wgmma" if vec and d <= ATTN_WG_BWD_MAX_D else "mma"


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


def flash_attention_fwd_blocked_plain(q, k, v, scale: float | None = None,
                                      with_lse: bool = False, block_k: int = ATTN_BK):
    """``flash_attention_plain``'s function in the wgmma kernel's order of
    work, for the tests: over tiles of ``block_k`` keys, a running row max
    m (keys past M masked), p = exp2(s log2 e - m log2 e) in f32, l and the
    f32 accumulator rescaled by exp2((m_old - m) log2 e), p rounded to the
    input dtype for the product with v; out = acc / l, lse = m + log(l)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    dt = q.dtype
    b, n, h, d = q.shape
    m_len = k.shape[1]
    with torch.autocast(q.device.type, enabled=False):
        f = lambda t: t.float().transpose(1, 2)                      # [B, H, rows, D]
        qs = f((q.float() * scale).to(dt))
        kf, vf = f(k), f(v)
        log2e = torch.tensor(LOG2E, dtype=torch.float32)
        m_run = torch.full((b, h, n), -torch.inf)
        l_run = torch.zeros(b, h, n)
        acc = torch.zeros(b, h, n, d)
        for k0 in range(0, m_len, block_k):
            s = qs @ kf[:, :, k0:k0 + block_k].transpose(-1, -2)      # [B, H, N, keys]
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            ms = m_new * log2e
            p = torch.exp2(s * log2e - ms[..., None])
            alpha = torch.exp2(m_run * log2e - ms)
            l_run = l_run * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + p.to(dt).float() @ vf[:, :, k0:k0 + block_k]
            m_run = m_new
        out = (acc / l_run[..., None]).transpose(1, 2).to(dt)
    return (out, m_run + torch.log(l_run)) if with_lse else out


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


def _tf32(x):
    """f32 x rounded to tf32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``; f32 out."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm3(a, b, passes: int = 3):
    """a @ b in f32 with both operands split into tf32 hi and lo (hi =
    tf32(x), lo = tf32(x - hi)): lo.hi + hi.lo, then hi.hi, the tf32x3
    kernels' three passes; ``passes=1`` is one tf32 product, hi.hi."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def flash_attention_fwd_tf32x3_blocked_plain(q, k, v, scale: float | None = None,
                                             with_lse: bool = False, passes: int = 3):
    """``flash_attention_plain``'s function for f32 q, k, v in the tf32x3
    forward's order of work and rounding, for the tests: q * scale in f32,
    over tiles of ``_tf32x3_fwd_tile(d)`` keys S = Q.K^T by ``_mm3``, a
    running row max m (keys past M masked), p = exp2(s log2 e - m log2 e),
    O_j = P.V_j by ``_mm3`` in a fresh sum, O = O alpha + O_j and l = l alpha
    + rowsum(p) with alpha = exp2((m_old - m) log2 e); out = O / l, lse = m
    + log(l). ``passes=1`` models one tf32 pass a product (hi.hi)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, n, h, d = q.shape
    m_len, tile = k.shape[1], _tf32x3_fwd_tile(d)
    with torch.autocast(q.device.type, enabled=False):
        f = lambda t: t.float().transpose(1, 2)                      # [B, H, rows, D]
        qs, kf, vf = f(q.float() * scale), f(k), f(v)
        log2e = torch.tensor(LOG2E, dtype=torch.float32)
        m_run = torch.full((b, h, n), -torch.inf)
        l_run = torch.zeros(b, h, n)
        acc = torch.zeros(b, h, n, d)
        for k0 in range(0, m_len, tile):
            s = _mm3(qs, kf[:, :, k0:k0 + tile].transpose(-1, -2), passes)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            ms = m_new * log2e
            p = torch.exp2(s * log2e - ms[..., None])
            alpha = torch.exp2(m_run * log2e - ms)
            l_run = l_run * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + _mm3(p, vf[:, :, k0:k0 + tile], passes)
            m_run = m_new
        out = (acc / l_run[..., None]).transpose(1, 2).contiguous()
    return (out, m_run + torch.log(l_run)) if with_lse else out


def flash_attention_bwd_tf32x3_blocked_plain(q, k, v, o, lse, do, scale: float | None = None,
                                             passes: int = 3):
    """``flash_attention_bwd_plain``'s function for f32 operands in the
    tf32x3 backward's order of work and rounding, for the tests: the dK/dV
    kernel over tiles of TF32X3_BWD_TILE queries (S^T = K.Q^T and dP^T =
    V.dO^T by ``_mm3``, p = exp2(s scale log2 e - lse log2 e), dS = p (dP -
    delta) scale, dV += P^T.dO and dK += dS^T.Q by ``_mm3``, each tile's
    sum added in f32), then the dQ kernel over tiles of as many keys (dQ
    += dS.K). ``passes=1`` models one tf32 pass a product."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, n, h, d = q.shape
    m, tile = k.shape[1], TF32X3_BWD_TILE
    with torch.autocast(q.device.type, enabled=False):
        f = lambda t: t.float().transpose(1, 2)                       # [B, H, rows, D]
        qf, kf, vf, dof = f(q), f(k), f(v), f(do)
        delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2)  # [B, H, N]
        c = torch.tensor(scale, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
        lse2 = lse.float() * torch.tensor(LOG2E, dtype=torch.float32)
        mm = lambda x, y: _mm3(x, y, passes)
        dq, dk, dv = torch.zeros(b, h, n, d), torch.zeros(b, h, m, d), torch.zeros(b, h, m, d)
        for q0 in range(0, n, tile):
            qs = slice(q0, q0 + tile)
            p = torch.exp2(mm(kf, qf[:, :, qs].transpose(-1, -2)) * c - lse2[:, :, None, qs])
            dp = mm(vf, dof[:, :, qs].transpose(-1, -2))
            ds = p * (dp - delta[:, :, None, qs]) * scale                # dS^T [B, H, M, tile]
            dv += mm(p, dof[:, :, qs])
            dk += mm(ds, qf[:, :, qs])
        for k0 in range(0, m, tile):
            ks = slice(k0, k0 + tile)
            p = torch.exp2(mm(qf, kf[:, :, ks].transpose(-1, -2)) * c - lse2[..., None])
            dp = mm(dof, vf[:, :, ks].transpose(-1, -2))
            dq += mm(p * (dp - delta[..., None]) * scale, kf[:, :, ks])
    back = lambda t: t.transpose(1, 2).contiguous()
    return back(dq), back(dk), back(dv)


def _aligned(t: torch.Tensor) -> bool:
    """16-byte rows: the backward's cp.async, TMA and tf32x3 paths need
    every row start aligned."""
    return _rows_aligned((t.data_ptr(),), (t.stride()[:3],), t.element_size())


def _check(name: str, q, k, v, max_d: int):
    """Device, shape, dtype and layout checks of the kernel wrappers."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    b, n, h, d = q.shape
    m = k.shape[1]
    if k.shape != (b, m, h, d) or v.shape != (b, m, h, d):
        raise ValueError(f"{name}: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype and q.dtype in KERNEL_DTYPES):
        raise TypeError(f"{name} kernel takes bf16 or f32, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not 1 <= d <= max_d:
        raise ValueError(f"{name} kernel takes d_head <= {max_d}, got {d}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k and v must share one device")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: the head axis must be contiguous")
    if n == 0 or m == 0 or b * h == 0:
        raise ValueError(f"{name}: empty attention")


def flash_attention_fwd(q, k, v, scale: float, with_lse: bool = False):
    """(out, lse or None): the forward kernel ``attn_fwd_plan`` picks, or the
    plain version for CPU tensors."""
    if q.device.type == "cpu":
        res = flash_attention_plain(q, k, v, scale, with_lse)
        return res if with_lse else (res, None)
    _check("flash_attention", q, k, v, MAX_HEAD_DIM)
    b, n, h, d = q.shape
    plan = _plan_for(q, k, v)
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, n), dtype=torch.float32, device=q.device)
           if with_lse else None)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, b, n, k.shape[1], h, d,
            q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(1),
            out.stride(2), float(scale))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.path == "f32":
            rc = _flash_lib("flash_fwd_f32").vd_flash_fwd_f32(*args, stream)
        elif plan.path == "tf32x3":
            # K and V split once into tiles of hi and lo (4 block_k d floats a tile)
            ws = torch.empty(b * h * -(-k.shape[1] // plan.block_k) * 4 * plan.block_k * d,
                             dtype=torch.float32, device=q.device)
            fn = (_flash_lib("flash_fwd_f32").vd_flash_fwd_tf32x3 if d <= TF32X3_BWD_MAX_D
                  else _flash_lib("tf32x3_fwd_wide").vd_flash_fwd_tf32x3_wide)
            rc = fn(*args[:5], ws.data_ptr(), *args[5:], stream)
        elif plan.path == "wgmma" and plan.dp > ATTN_WG_NARROW_D:   # csrc/attn_fwd_wide.cu
            rc = _flash_lib("attn_fwd_wide").vd_attn_fwd_wide(
                *args[:5], None, 0, 0, *args[5:], plan.code, stream)
        else:
            rc = _flash_lib("flash_fwd").vd_flash_fwd(*args, plan.code, stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed ({plan.path} path): cudaError {rc}")
    flash_attention.launches += 1
    flash_attention.launches_by_path[plan.path] += 1
    if d > ATTN_WG_NARROW_D and plan.path in flash_attention.launches_wide:
        flash_attention.launches_wide[plan.path] += 1
    return out, lse


def flash_attention_bwd(q, k, v, o, lse, do, scale: float):
    """(dq, dk, dv): the backward kernels ``flash_bwd_path`` picks, or the
    plain version for CPU tensors. delta = rowsum(dO * O) is one plain
    elementwise pass here, as the JAX package computes it outside Pallas.
    bf16 (one pass over key blocks; its f32 dQ workspace zeroed here and
    converted to bf16 by a second small kernel) adds dQ's f32 partials in
    device memory in no fixed order, so its last bits may differ from run
    to run; the f32 routes add nothing across blocks and are bit-equal."""
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
    lib = _flash_lib("flash_bwd")
    delta = (do.float() * o).sum(dim=-1).transpose(1, 2).contiguous()  # o promoted exactly
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    # aligned rows (and in bf16 a 16-byte aligned lse, which the wgmma
    # kernel reads by TMA) take cp.async, TMA or the tf32x3 kernels;
    # anything else the element-wise loads
    vec = int(d % 8 == 0 and all(_aligned(t) for t in (q, k, v, do))
              and (q.dtype == torch.float32 or lse.data_ptr() % 16 == 0))
    path = flash_bwd_path(d, q.dtype, bool(vec))
    st = lambda t: (t.stride(0), t.stride(1), t.stride(2))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    strides = (*st(q), *st(k), *st(v), *st(do), *st(dq), *st(dk), *st(dv))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if path == "f32":
            rc = lib.vd_flash_bwd_f32(*ptrs, b, n, k.shape[1], h, d, *strides, float(scale),
                                      stream)
        elif path == "tf32x3":
            # the streamed tiles split once: a dK/dV stage a query tile (q, dO
            # as rows and columns, lse and delta), a dQ stage a key tile
            t = TF32X3_BWD_TILE
            ws_kv = torch.empty(b * h * -(-n // t) * (8 * t * d + 2 * t), dtype=torch.float32,
                                device=q.device)
            ws_q = torch.empty(b * h * -(-k.shape[1] // t) * 6 * t * d, dtype=torch.float32,
                               device=q.device)
            rc = lib.vd_flash_bwd_tf32x3(*ptrs, ws_kv.data_ptr(), ws_q.data_ptr(), b, n,
                                         k.shape[1], h, d, *strides, float(scale), stream)
        else:
            n_pad = -(-n // BWD_QUERIES) * BWD_QUERIES
            dq_acc = torch.zeros((b * h, n_pad, -(-d // 16) * 16), dtype=torch.float32,
                                 device=q.device)
            rc = lib.vd_flash_bwd(*ptrs, dq_acc.data_ptr(), b, n, k.shape[1], h, d, n_pad,
                                  *strides, float(scale), vec, stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd launch failed ({path} path): cudaError {rc}")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_path[path] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
# flash_bwd_path's path -> launches
flash_attention_bwd.launches_by_path = {"wgmma": 0, "mma": 0, "f32": 0, "tf32x3": 0}


@functools.cache
def _flash_lib(name: str):
    """The library of ``csrc/<name>.cu`` with its f32 entry points' types
    (``build.SOURCES`` types each library's first entry)."""
    import ctypes
    from vdtpu_torch.ops.kernels.build import load
    lib = load(name)
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    if name in ("flash_fwd", "attn_fwd_wide", "tf32x3_fwd_wide"):
        return lib
    if name == "flash_fwd_f32":
        f32 = [p] * 5 + [i] * 5 + [ll] * 12 + [f, p]
        types = {"vd_flash_fwd_tf32x3": [p] * 6 + f32[5:]}
    else:
        f32 = [p] * 9 + [i] * 5 + [ll] * 21 + [f, p]
        types = {"vd_flash_bwd_f32": f32, "vd_flash_bwd_tf32x3": [p] * 11 + f32[9:]}
    for fn, argtypes in types.items():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, i
    return lib


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
# attn_fwd_plan's path -> launches
flash_attention.launches_by_path = {"wgmma": 0, "mma": 0, "f32": 0, "tf32x3": 0}
# of those, the launches at heads over 80: csrc/attn_fwd_wide.cu ("wgmma")
# and csrc/tf32x3_fwd_wide.cu ("tf32x3")
flash_attention.launches_wide = {"wgmma": 0, "tf32x3": 0}
