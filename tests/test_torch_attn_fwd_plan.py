"""The attention forward's wgmma kernel (``csrc/attn_fwd_sm90.cuh``) on the
CPU: its order of work (``flash_attention_fwd_blocked_plain``: 128-key
tiles, 64 past d 128, a running max, exp2 with log2 e folded in) against
vdtpu's ``_fwd_impl`` in interpret mode at the kernel's key tile, heads of
8-160; the no-max plain version against ``_nomax_slim_impl``;
``attn_fwd_plan`` at every attention site of the full-width UNet that
reaches a kernel, at every wide head (88-160), and on the shapes and
layouts that must take the mma.sync kernel; and a numpy model of the
swizzled shared-memory layout the kernel's TMA boxes produce and of the
wgmma descriptors and register fragments it reads them through, against
dense products (two boxes of 64 columns at d 96-128, three at d 160)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdtpu.ops.pallas import flash as jflash
from vdtpu_torch.config import configs
from vdtpu_torch.ops import attention
from vdtpu_torch.ops.flash import (
    ATTN_BK, ATTN_BOX_COLS, ATTN_WG_BWD_MAX_D, ATTN_WG_MAX_D, MAX_SMEM, _key_tile,
    attn_fwd_plan, flash_attention_fwd_blocked_plain, flash_attention_plain, flash_bwd_path)
from vdtpu_torch.ops.nomax import flash_attention_nomax_plain

torch.set_num_threads(2)

# f32 on both sides: they differ in exp(x) against exp2(x log2 e) (a
# relative 1e-6 at |x| ~ 10) and in summation order
TOL = 1e-5
# bf16 against the plain version: the card's gate (two bf16 ulps)
ATOL, RTOL = 1e-2, 1.6e-2


def _fold(a):
    b, s, h, d = a.shape
    return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(b * h, s, d))


def _unfold(a, b, h):
    a = np.asarray(a)
    return a.reshape(b, h, *a.shape[1:]).transpose(0, 2, 1, *range(3, a.ndim + 1))


@pytest.mark.parametrize("b,n,m,h,d", [
    (1, 1000, 1000, 2, 40),   # ragged last query block and key tile
    (1, 1000, 1000, 2, 80),
    (2, 300, 77, 1, 40),      # kv shorter than one tile
    (1, 130, 257, 1, 8),      # two whole tiles and one key
    # the wide heads: 128-key tiles at d 96 and 128, 64-key tiles at 160
    # (the four-image mcg's 16^2 cross-attention: 1028 keys, 4 in the last)
    (1, 200, 333, 2, 96),
    (1, 130, 300, 1, 128),
    (1, 260, 1028, 1, 160),
])
def test_blocked_model_matches_jax(b, n, m, h, d):
    rs = np.random.RandomState(n + m + d)
    q, k, v = (rs.randn(b, s, h, d).astype(np.float32) for s in (n, m, m))
    scale = d ** -0.5
    bk = _key_tile(-(-d // 16) * 16)
    o_j, lse_j = jflash._fwd_impl(_fold(q), _fold(k), _fold(v), scale, 128, bk,
                                  interpret=True, with_lse=True)
    out, lse = flash_attention_fwd_blocked_plain(*(torch.tensor(a) for a in (q, k, v)), scale,
                                                 with_lse=True, block_k=bk)
    r = _unfold(o_j, b, h)
    np.testing.assert_allclose(out.numpy(), r, rtol=TOL, atol=TOL * np.abs(r).max())
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j).reshape(b, h, n), rtol=TOL,
                               atol=TOL)
    assert flash_attention_fwd_blocked_plain(*(torch.tensor(a) for a in (q, k, v)),
                                             scale).shape == (b, n, h, d)


@pytest.mark.parametrize("b,n,m,h,d", [(1, 1000, 1000, 2, 40), (2, 200, 77, 2, 80),
                                       (1, 200, 333, 2, 96), (1, 130, 300, 1, 128),
                                       (1, 260, 1028, 1, 160)])
def test_nomax_plain_matches_jax(b, n, m, h, d):
    rs = np.random.RandomState(7 * n + m + d)
    q, k, v = (rs.randn(b, s, h, d).astype(np.float32) for s in (n, m, m))
    scale = d ** -0.5
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * scale
    shift = s.max(axis=(0, 2, 3)).astype(np.float32)      # the calibrated per-head bound
    o_j = jflash._nomax_slim_impl(_fold(q), _fold(k), _fold(v), scale,
                                  jnp.asarray(np.tile(shift, b)), 128,
                                  _key_tile(-(-d // 16) * 16), True)
    out = flash_attention_nomax_plain(*(torch.tensor(a) for a in (q, k, v)),
                                      torch.tensor(shift), scale)
    r = _unfold(o_j, b, h)
    np.testing.assert_allclose(out.numpy(), r, rtol=TOL, atol=TOL * np.abs(r).max())


@pytest.mark.parametrize("b,n,m,h,d", [(1, 200, 300, 2, 40), (1, 130, 1000, 2, 80),
                                       (1, 200, 333, 2, 96), (1, 260, 1028, 2, 160)])
def test_blocked_model_within_the_card_gate_in_bf16(b, n, m, h, d):
    """The running max rounds p to bf16 against the tile's max, the plain
    version against the row's: both within the gate the card holds the
    kernel to (at the kernel's key tile: 64 keys at d 160)."""
    gen = torch.Generator().manual_seed(n + m)
    q, k, v = (torch.randn(b, s, h, d, generator=gen).to(torch.bfloat16) for s in (n, m, m))
    out, lse = flash_attention_fwd_blocked_plain(q, k, v, with_lse=True,
                                                 block_k=_key_tile(-(-d // 16) * 16))
    ref, lse_ref = flash_attention_plain(q, k, v, with_lse=True)
    assert out.dtype == torch.bfloat16
    a, r = out.float(), ref.float()
    assert bool(((a - r).abs() <= ATOL + RTOL * r.abs()).all())
    assert float((lse - lse_ref).abs().max()) <= 1e-3


# the card's relative-L2 gate on the attention forwards (``chip_smoke.py``
# and ``tests/test_torch_gpu.py``: ATTN_MAX_REL_L2)
ATTN_MAX_REL_L2 = 1e-2


@pytest.mark.parametrize("nomax", [False, True])
def test_rel_l2_gate_sees_one_dropped_key_tile(nomax):
    """Over 4096 keys an output is ~0.02, so the elementwise band alone can
    miss a K/V tile the kernel skipped or put in the wrong slot: one
    128-key tile left out reads more than ten times the relative-L2 gate,
    while the bf16 blocked model (the flash kernel's order of work) reads
    inside it."""
    b, n, m, h, d = 1, 512, 4096, 2, 40
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(b, s, h, d, generator=gen).to(torch.bfloat16) for s in (n, m, m))
    keep = torch.ones(m, dtype=torch.bool)
    keep[ATTN_BK:2 * ATTN_BK] = False
    rel = lambda a, r: float((a.float() - r.float()).norm() / r.float().norm())
    if nomax:
        shift = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()).amax(dim=(0, 2, 3))
        shift = shift * d ** -0.5
        ref = flash_attention_nomax_plain(q, k, v, shift)
        dropped = flash_attention_nomax_plain(q, k[:, keep], v[:, keep], shift)
    else:
        ref = flash_attention_plain(q, k, v)
        assert rel(flash_attention_fwd_blocked_plain(q, k, v), ref) <= ATTN_MAX_REL_L2
        dropped = flash_attention_fwd_blocked_plain(q, k[:, keep], v[:, keep])
    assert rel(dropped, ref) > 10 * ATTN_MAX_REL_L2


def _kernel_sites():
    """(n, m, h, d) of every attention of the full-width image UNet at 512^2
    (64^2 latent) that ``ops/attention.py``'s rule sends to a kernel:
    self-attention over q_len >= 256 and kv_len >= 1024 tokens, from the
    config literals; and the 64^2 sites under ToMe 0.75 (4096 tokens merged
    to 1024 before the attention, queries too)."""
    args = configs.OPENAI_UNET_2D_V1["args"]
    sites = set()
    for level, mult in enumerate(args["channel_mult"]):
        ds = 2 ** level
        if ds not in args["attention_resolutions"]:
            continue
        tokens = (64 // ds) ** 2
        d = args["model_channels"] * mult // args["num_heads"]
        for kv in (tokens, 77, 257):      # self, text context, vision context
            if tokens >= attention._FLASH_MIN_Q and kv >= attention._FLASH_MIN_KV:
                sites.add((tokens, kv, args["num_heads"], d))
    sites.add((1024, 1024, args["num_heads"], 40))
    return sorted(sites)


def test_kernel_sites_are_the_main_paths():
    assert _kernel_sites() == [(1024, 1024, 8, 40), (1024, 1024, 8, 80), (4096, 4096, 8, 40)]


@pytest.mark.parametrize("n,m,h,d", _kernel_sites())
# a training micro-batch, a CFG step of 2 images; the serving queue's
# buckets of 4 and 8 images (and 1: batch 2)
@pytest.mark.parametrize("batch", [2, 4, 8, 16])
def test_plan_takes_wgmma_at_every_main_path_site(batch, n, m, h, d):
    """q, k, v are [B, N, H, D] views of the [B, N, H*D] projections
    (``models/transformer.py``): 16-byte aligned, 640-byte rows at d 40 and
    80. The plan does not depend on the softmax mode (Flash, FlashLse and
    NoMax share the geometry), so one plan covers all three."""
    st = lambda rows: (rows * h * d, h * d, d)
    plan = attn_fwd_plan(batch, n, m, h, d, (st(n), st(m), st(m)), (0, 1 << 20, 1 << 21))
    assert plan.path == "wgmma"
    assert plan.smem_bytes <= MAX_SMEM and plan.stages >= 2
    assert plan.block_k == ATTN_BK and plan.dp == -(-d // 16) * 16
    nc = 3 if plan.dp <= 64 and n >= 2048 else 2   # consumer warpgroups of 64 query rows
    assert plan.block_q == 64 * nc
    assert plan.grid == (-(-n // plan.block_q), batch * h)
    assert plan.code == 2 | plan.stages << 4 | 2 << 8 | nc << 12 | plan.smem_bytes // 8 << 16
    assert 0 < plan.code < 2 ** 31 and plan.smem_bytes % 8 == 0   # a C int, exact


@pytest.mark.parametrize("d,offset,why", [
    (168, 0, "head over 160"), (100, 0, "a wide head with d % 8 != 0"), (256, 0, "widest head"),
    (36, 0, "d % 8 != 0"), (40, 1, "one element into the buffer"),
])
def test_plan_takes_mma_elsewhere(d, offset, why):
    n, h = 300, 2
    st = (n * h * d, h * d, d)
    plan = attn_fwd_plan(1, n, n, h, d, (st, st, st), (2 * offset, 0, 0))
    assert plan.path == "mma", why
    assert plan.vec == (offset == 0 and d % 8 == 0) and plan.code == int(plan.vec)
    assert plan.smem_bytes is None and plan.grid == (-(-n // 64), h)


@pytest.mark.parametrize("d", range(88, ATTN_WG_MAX_D + 1, 8))
@pytest.mark.parametrize("n,m", [(256, 1028), (1000, 333)])
def test_plan_takes_wgmma_at_wide_heads_forward_only(d, n, m):
    """Heads of 88-160 (d % 8 == 0, aligned rows) take the wgmma forward in
    every mode (one plan for Flash, FlashLse and NoMax): one consumer
    warpgroup a block over 256 queries or fewer (the mcg's 16^2 site [4,
    256, 8, 160] over 1028 keys: 128 blocks), else two; 128-key tiles up
    to d 128 and 64-key tiles past it; the deepest ring that fits the
    card's shared memory. The backward keeps the mma.sync kernel there:
    its wgmma kernel takes heads up to 80."""
    b, h = 4, 8
    st = lambda rows: (rows * h * d, h * d, d)
    plan = attn_fwd_plan(b, n, m, h, d, (st(n), st(m), st(m)), (0, 1 << 20, 1 << 21))
    dp = -(-d // 16) * 16
    nc = 1 if n <= 256 else 2
    assert plan.path == "wgmma" and plan.dp == dp and plan.block_q == 64 * nc
    assert plan.block_k == (128 if dp <= 128 else 64) == _key_tile(dp)
    boxes = -(-dp // ATTN_BOX_COLS)
    smem = lambda s: (1024 + boxes * 64 * nc * 128 + s * 2 * boxes * plan.block_k * 128
                      + 8 * (1 + 2 * s))
    stages = max(s for s in (2, 3, 4) if smem(s) <= MAX_SMEM)
    assert plan.stages == stages >= 3 and plan.smem_bytes == smem(stages)
    assert plan.grid == (-(-n // (64 * nc)), b * h)
    assert plan.code == (2 | stages << 4 | plan.block_k // 64 << 8 | nc << 12
                         | plan.smem_bytes // 8 << 16) < 2 ** 31
    assert flash_bwd_path(d, torch.bfloat16, True) == "mma" and d > ATTN_WG_BWD_MAX_D


def test_plan_takes_mma_for_unaligned_strides():
    """A head stride of 44 elements (88 bytes) cannot start TMA boxes."""
    n, h, d = 300, 2, 40
    st = (n * h * 44, h * 44, 44)
    assert attn_fwd_plan(1, n, n, h, d, (st, st, st), (0, 0, 0)).path == "mma"


# ---- numpy model of the kernel's shared memory and wgmma operands ----

def _swizzle(addr):
    """The byte address the 128-byte swizzle puts logical byte ``addr`` at
    (the tile 1024-byte aligned): address bits 4-6 XOR bits 7-9 (TMA writes
    and wgmma reads agree on it)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _tma_box(smem, start, x, row0, col0, rows, cols=ATTN_BOX_COLS):
    """One TMA box of ``rows`` x ``cols`` (bf16, 128-byte rows) at byte
    ``start``, swizzled, zero past the tensor's rows and columns."""
    n, d = x.shape
    for r in range(rows):
        for c in range(cols):
            val = x[row0 + r, col0 + c] if row0 + r < n and col0 + c < d else 0.0
            smem[_swizzle(start + r * cols * 2 + c * 2) // 2] = val


def _kmajor_sw128(smem, start, sbo, rows):
    """A [rows, 16] operand through a K-major 128-byte-swizzle descriptor:
    element (r, k) at logical start + 128 (r % 8) + SBO (r // 8) + 2 (k % 8)
    + 16 (k // 8)."""
    r, k = np.meshgrid(np.arange(rows), np.arange(16), indexing="ij")
    return smem[_swizzle(start + 128 * (r % 8) + sbo * (r // 8) + 2 * (k % 8) + 16 * (k // 8))
                // 2]


def _mnmajor_sw128(smem, start, lbo, sbo, cols):
    """A [16, cols] B operand through an MN-major 128-byte-swizzle
    descriptor (the transpose bit): element (k, n) at logical start + 2 (n %
    64) + LBO (n // 64) + 128 (k % 8) + SBO (k // 8)."""
    k, n = np.meshgrid(np.arange(16), np.arange(cols), indexing="ij")
    return smem[_swizzle(start + 2 * (n % 64) + lbo * (n // 64) + 128 * (k % 8)
                         + sbo * (k // 8)) // 2]


def _acc_layout(rows=64, cols=ATTN_BK):
    """(warp, lane, index) -> (row, col) of an m64nN f32 accumulator: lane
    4 g + t of warp w holds index 4 n + e at row 16 w + g + 8 (e >> 1),
    column 8 n + 2 t + (e & 1)."""
    out = {}
    for w in range(rows // 16):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for n in range(cols // 8):
                for e in range(4):
                    out[w, lane, 4 * n + e] = (16 * w + g + 8 * (e >> 1), 8 * n + 2 * t + (e & 1))
    return out


@pytest.mark.parametrize("d,n_rows,m_rows,q0,k0", [
    (40, 4096, 4096, 256, 1024),   # the 64^2 site: d padded to 48
    (80, 1000, 1000, 896, 896),    # ragged last query block and key tile
    (8, 100, 77, 0, 0),
    (96, 1000, 333, 896, 256),     # two boxes, the second zero past column 96
    (128, 300, 300, 128, 128),
    (160, 256, 1028, 128, 1024),   # the mcg's 16^2 site: three boxes, 64-key
                                   # tiles, 4 keys in the last
])
def test_box_layout_and_descriptors_give_dense_products(d, n_rows, m_rows, q0, k0):
    """S = Q.K^T through the kernel's K-major 128-byte-swizzle descriptors
    (every consumer warpgroup, every k16 step) and O = P.V through its MN-major V
    descriptor, with P handed over in the kernel's register fragments,
    against dense numpy products of the same (zero-padded) tiles. Offsets
    are the kernel's (``vdattn::Geo``): Q's boxes at 0, then the ring of
    stages (K's boxes, then V's), then the mbarriers, inside the plan's
    shared-memory bytes (1024 of them to align the base)."""
    rs = np.random.RandomState(d)
    q, k, v = rs.randn(n_rows, d), rs.randn(m_rows, d), rs.randn(m_rows, d)
    st = (n_rows * d, d, d)
    plan = attn_fwd_plan(1, n_rows, m_rows, 1, d, (st, st, st), (0, 0, 0))
    bq, bk, dp, ns = plan.block_q, plan.block_k, plan.dp, plan.stages
    q_box, box = bq * 2 * ATTN_BOX_COLS, bk * 2 * ATTN_BOX_COLS             # bytes
    boxes = -(-dp // ATTN_BOX_COLS)
    assert 1024 + boxes * q_box + ns * 2 * boxes * box + 8 * (1 + 2 * ns) == plan.smem_bytes
    slot = (k0 // bk) % ns
    k_off = boxes * q_box + slot * 2 * boxes * box
    v_off = k_off + boxes * box
    smem = np.zeros((plan.smem_bytes - 1024) // 2)
    for c in range(boxes):
        _tma_box(smem, c * q_box, q, q0, ATTN_BOX_COLS * c, bq)
        _tma_box(smem, k_off + c * box, k, k0, ATTN_BOX_COLS * c, bk)
        _tma_box(smem, v_off + c * box, v, k0, ATTN_BOX_COLS * c, bk)
    pad = lambda x, r0, rows: np.pad(x[r0:r0 + rows], ((0, rows - len(x[r0:r0 + rows])),
                                                         (0, dp - d)))
    qd, kd, vd = pad(q, q0, bq), pad(k, k0, bk), pad(v, k0, bk)

    layout = _acc_layout(cols=bk)
    for wg in range(bq // 64):
        s = np.zeros((64, bk))
        for kk in range(dp // 16):   # qk(): box kk / 4, 32 (kk % 4) bytes in, SBO 1024
            a = _kmajor_sw128(smem, wg * 64 * 128 + (kk // 4) * q_box + (kk % 4) * 32, 1024, 64)
            b = _kmajor_sw128(smem, k_off + (kk // 4) * box + (kk % 4) * 32, 1024, bk)
            s += a @ b.T
        np.testing.assert_allclose(s, qd[64 * wg:64 * wg + 64] @ kd.T, atol=1e-9)
        # the accumulators as registers, packed as pack() does, read back as
        # wgmma's A fragments (a[0]: row g, k 2t; a[1]: row g + 8; a[2], a[3]:
        # k + 8), then O = P.V through pv()'s V descriptor
        p = np.tanh(s)
        regs = {key: p[rc] for key, rc in layout.items()}
        o = np.zeros((64, dp))
        for kc in range(bk // 16):
            frag = np.zeros((64, 16))
            for w in range(4):
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    for r in range(4):   # pa[kc][r] = (s[8 kc + 2 r], s[8 kc + 2 r + 1])
                        lo, hi = regs[w, lane, 8 * kc + 2 * r], regs[w, lane, 8 * kc + 2 * r + 1]
                        row, col = 16 * w + g + 8 * (r & 1), 2 * t + 8 * (r >> 1)
                        frag[row, col:col + 2] = lo, hi
            bv = _mnmajor_sw128(smem, v_off + 16 * kc * 128, box, 1024, dp)
            o += frag @ bv
        np.testing.assert_allclose(o, p @ vd, atol=1e-9)
