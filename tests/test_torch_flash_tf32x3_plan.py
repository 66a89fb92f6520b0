"""The flash kernels' tf32x3 route (``csrc/tf32x3.cuh``, the f32 forward and
backward on wgmma with split-f32 products) on the CPU: its order of work
and rounding (``flash_attention_fwd_tf32x3_blocked_plain``,
``flash_attention_bwd_tf32x3_blocked_plain``: tf32 hi and lo parts, three
passes a product, key or query tiles summed in f32) against vdtpu's
``_fwd_impl`` and ``_bwd_impl`` in interpret mode in f32 at the card's f32
gate, and one tf32 pass a product failing that gate; the wide forward (heads 88-160, ``csrc/tf32x3_fwd_wide.cu``: the
same order of work at 32-key tiles) against ``_fwd_impl`` at d 96, 128 and
160; the plan at every f32 flash site of the full-width UNet, the legacy
zoo and the mcg, at every wide head, and the shapes and strides that stay
on the SIMT "f32" kernels; a numpy model of the kernels' shared-memory
tiles (rows, and columns in the permuted key order) and register fragments
against dense products, and of the wide kernel's f32 Q rows, its A
fragments loaded from them and P.V taken in two halves of the head."""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdtpu.ops.pallas import flash as jflash
from vdtpu_torch.config import configs
from vdtpu_torch.ops import attention
from vdtpu_torch.ops.flash import (
    MAX_SMEM, TF32X3_BWD_MAX_D, TF32X3_BWD_TILE, TF32X3_MAX_D, TF32X3_WIDE_TILE, _tf32,
    attn_fwd_plan, flash_attention_bwd_tf32x3_blocked_plain,
    flash_attention_fwd_tf32x3_blocked_plain, flash_bwd_path)

torch.set_num_threads(2)

# the card's f32 gate (chip_smoke.py F32_ATOL / F32_RTOL / F32_MAX_REL_L2):
# |k - p| <= 2e-5 + 1e-4 |p| and relative L2 <= 1e-5, both sides f32 sums
# in other orders
F32_ATOL, F32_RTOL, F32_MAX_REL_L2 = 2e-5, 1e-4, 1e-5


def _fold(a):
    b, s, h, d = a.shape
    return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(b * h, s, d))


def _unfold(a, b, h):
    a = np.asarray(a)
    return a.reshape(b, h, *a.shape[1:]).transpose(0, 2, 1, *range(3, a.ndim + 1))


def _gate(ours, ref):
    """(within |k - p| <= atol + rtol |p|, relative L2) of one output."""
    ours = np.asarray(ours, np.float64)
    err = np.abs(ours - ref)
    return bool((err <= F32_ATOL + F32_RTOL * np.abs(ref)).all()), float(
        np.linalg.norm(ours - ref) / np.linalg.norm(ref))


def _jax_case(b, n, m, h, d, seed):
    """f32 inputs and vdtpu's forward (out, lse) and backward (dq, dk, dv),
    the Pallas kernels in interpret mode."""
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(b, s, h, d).astype(np.float32) for s in (n, m, m))
    g = rs.randn(b, n, h, d).astype(np.float32)
    scale = d ** -0.5
    o_j, lse_j = jflash._fwd_impl(_fold(q), _fold(k), _fold(v), scale, 64, 128, interpret=True,
                                  with_lse=True)
    grads = jflash._bwd_impl(_fold(q), _fold(k), _fold(v), o_j, lse_j, _fold(g), scale, 64, 128,
                             True)
    out = _unfold(o_j, b, h)
    lse = np.asarray(lse_j).reshape(b, h, n)
    grads = [_unfold(r, b, h) for r in grads]
    return [torch.tensor(a) for a in (q, k, v, g)], out, lse, grads


# ragged query and key tiles; heads of the main path (40, 80), the legacy
# AttentionBlock (64) and the narrowest (8)
CASES = [(1, 200, 300, 2, 40), (1, 130, 257, 1, 80), (2, 70, 100, 1, 64), (1, 64, 96, 1, 8)]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(map(str, c)))
def case(request):
    b, n, m, h, d = request.param
    return request.param, _jax_case(b, n, m, h, d, n + m + d)


def test_blocked_models_match_jax_within_the_f32_gate(case):
    (b, n, m, h, d), ((q, k, v, g), out_j, lse_j, grads_j) = case
    out, lse = flash_attention_fwd_tf32x3_blocked_plain(q, k, v, d ** -0.5, with_lse=True)
    for name, a, r in (("out", out, out_j), ("lse", lse, lse_j)):
        ok, rel = _gate(a.numpy(), r)
        assert ok and rel <= F32_MAX_REL_L2, (name, rel)
    o, lse = torch.tensor(out_j), torch.tensor(lse_j)
    grads = flash_attention_bwd_tf32x3_blocked_plain(q, k, v, o, lse, g, d ** -0.5)
    for name, a, r in zip(("dq", "dk", "dv"), grads, grads_j):
        ok, rel = _gate(a.numpy(), r)
        assert ok and rel <= F32_MAX_REL_L2, (name, rel)


def test_one_tf32_pass_fails_the_f32_gate(case):
    """hi.hi alone (one tf32 product, 11 bits) reads relative L2 errors
    around 4e-4, 40 times the gate: the gate sees what the lo passes add."""
    (b, n, m, h, d), ((q, k, v, g), out_j, lse_j, grads_j) = case
    out = flash_attention_fwd_tf32x3_blocked_plain(q, k, v, d ** -0.5, passes=1)
    assert _gate(out.numpy(), out_j)[1] > 10 * F32_MAX_REL_L2
    grads = flash_attention_bwd_tf32x3_blocked_plain(
        q, k, v, torch.tensor(out_j), torch.tensor(lse_j), g, d ** -0.5, passes=1)
    for a, r in zip(grads, grads_j):
        assert _gate(a.numpy(), r)[1] > 10 * F32_MAX_REL_L2


# the wide forward's heads with ragged query and key tiles: d 96 and 128,
# and the mcg's 16^2 cross-attention (d 160 over 1028 keys, 4 in the last)
WIDE_CASES = [(1, 100, 333, 2, 96), (1, 70, 130, 1, 128), (1, 130, 1028, 1, 160)]


@pytest.fixture(scope="module", params=WIDE_CASES, ids=lambda c: "-".join(map(str, c)))
def wide_case(request):
    """f32 inputs and vdtpu's forward (out, lse) in interpret mode."""
    b, n, m, h, d = request.param
    rs = np.random.RandomState(n + m + d)
    q, k, v = (rs.randn(b, s, h, d).astype(np.float32) for s in (n, m, m))
    o_j, lse_j = jflash._fwd_impl(_fold(q), _fold(k), _fold(v), d ** -0.5, 64, 128,
                                  interpret=True, with_lse=True)
    return request.param, [torch.tensor(a) for a in (q, k, v)], _unfold(o_j, b, h), \
        np.asarray(lse_j).reshape(b, h, n)


def test_wide_fwd_model_matches_jax_within_the_f32_gate(wide_case):
    """The wide kernel's order of work and rounding (32-key tiles, three
    tf32 passes a product, each tile's P.V a fresh f32 sum) against
    ``_fwd_impl``: out within the f32 gate, lse within 1.1e-5 (the card's
    gate)."""
    (b, n, m, h, d), (q, k, v), out_j, lse_j = wide_case
    assert TF32X3_WIDE_TILE == 32
    out, lse = flash_attention_fwd_tf32x3_blocked_plain(q, k, v, d ** -0.5, with_lse=True)
    ok, rel = _gate(out.numpy(), out_j)
    assert ok and rel <= F32_MAX_REL_L2, rel
    assert float(np.abs(lse.numpy() - lse_j).max()) <= 1.1e-5


def test_wide_fwd_one_tf32_pass_fails_the_f32_gate(wide_case):
    (b, n, m, h, d), (q, k, v), out_j, _ = wide_case
    out = flash_attention_fwd_tf32x3_blocked_plain(q, k, v, d ** -0.5, passes=1)
    assert _gate(out.numpy(), out_j)[1] > 10 * F32_MAX_REL_L2


def test_tf32_rounds_to_nearest_ties_away():
    """``_tf32`` is cvt.rna.tf32.f32: 10 mantissa bits, to nearest, ties
    away from zero (an overflow rounds to inf)."""
    x = torch.tensor([1.0, 1 + 2 ** -12, 1 + 2 ** -11, 1 + 3 * 2 ** -12, -(1 + 2 ** -11),
                      torch.finfo(torch.float32).max, 0.0])
    assert _tf32(x).tolist() == [1.0, 1.0, 1 + 2 ** -10, 1 + 2 ** -10, -(1 + 2 ** -10),
                                 float("inf"), 0.0]


# ---- the plan at every f32 flash site ----

def _unet_sites():
    """(n, m, h, d) of every self-attention of the full-width image UNet at
    512^2 (64^2 latent) that the attention rule sends to flash, from the
    config literals, and the four-image mcg's cross-attentions over 1028
    image-context keys (4 x 257) at every map of 256 tokens or more."""
    args = configs.OPENAI_UNET_2D_V1["args"]
    sites = set()
    for level, mult in enumerate(args["channel_mult"]):
        ds = 2 ** level
        if ds not in args["attention_resolutions"]:
            continue
        tokens = (64 // ds) ** 2
        d = args["model_channels"] * mult // args["num_heads"]
        for kv in (tokens, 1028):
            if tokens >= attention._FLASH_MIN_Q and kv >= attention._FLASH_MIN_KV:
                sites.add((tokens, kv, args["num_heads"], d))
    return sorted(sites)


def test_unet_sites_are_the_main_paths():
    assert _unet_sites() == [(256, 1028, 8, 160), (1024, 1024, 8, 80), (1024, 1028, 8, 80),
                             (4096, 1028, 8, 40), (4096, 4096, 8, 40)]


def _views(b, n, m, h, d):
    """Strides and pointers of q [B, N, H, D] and k, v [B, M, H, D] as views
    of the [B, rows, H*D] projections (``models/transformer.py``)."""
    st = lambda rows: (rows * h * d, h * d, d)
    return (st(n), st(m), st(m)), (0, 1 << 20, 1 << 21)


@pytest.mark.parametrize("n,m,h,d", _unet_sites())
# an f32 training micro-batch, a 2-image f32 request's CFG batch; the
# serving queue's buckets of 4 and 8 images
@pytest.mark.parametrize("batch", [2, 4, 8, 16])
def test_plan_at_every_unet_site(batch, n, m, h, d):
    """Every site takes the tf32x3 forward; heads of 40 and 80 the tf32x3
    backward too, the mcg's 16^2 cross-attention (d 160, which no path
    trains) the wide forward and the SIMT backward."""
    strides, ptrs = _views(batch, n, m, h, d)
    plan = attn_fwd_plan(batch, n, m, h, d, strides, ptrs, torch.float32)
    assert plan.path == "tf32x3"
    want = "tf32x3" if d <= TF32X3_BWD_MAX_D else "f32"
    assert flash_bwd_path(d, torch.float32, True) == want
    if d > TF32X3_BWD_MAX_D:
        _check_wide_plan(plan, batch, n, h, d)
    else:
        # two warpgroups of 64 query rows; their Q hi and lo, two stages of
        # K hi, K lo, V^T hi and V^T lo and the stages' two mbarriers
        # (flash_fwd.cu's FwdTc)
        tile = 64 if d <= 48 else 32
        assert (plan.dp, plan.block_q, plan.block_k, plan.stages) == (d, 128, tile, 2)
        assert plan.smem_bytes == 4 * (2 * 128 * d + 2 * 4 * tile * d) + 16 <= MAX_SMEM
        assert plan.grid == (-(-n // 128), batch * h) and plan.vec


def _check_wide_plan(plan, b, n, h, d):
    """The wide tf32x3 forward (tf32x3_fwd_wide.cu's Wide): one warpgroup
    of 64 query rows a block; two stages of K hi, K lo, V^T hi and V^T lo
    (32 x d floats each), Q's rows in f32 at a stride of d + 4 floats, two
    mbarriers."""
    assert (plan.dp, plan.block_q, plan.block_k, plan.stages) == (d, 64, 32, 2)
    assert plan.smem_bytes == 4 * (2 * 4 * 32 * d + 64 * (d + 4)) + 16 <= MAX_SMEM
    assert plan.grid == (-(-n // 64), b * h) and plan.vec


@pytest.mark.parametrize("d", range(88, TF32X3_MAX_D + 1, 8))
def test_plan_takes_the_wide_forward_and_the_simt_backward(d):
    """Every head of 88-160 (d % 8 == 0, aligned rows) takes the wide
    tf32x3 forward; the backward stays on the SIMT kernels (its tf32x3
    kernels take heads up to 80)."""
    n, m, h, b = 256, 1028, 8, 4
    strides, ptrs = _views(b, n, m, h, d)
    plan = attn_fwd_plan(b, n, m, h, d, strides, ptrs, torch.float32)
    assert plan.path == "tf32x3"
    _check_wide_plan(plan, b, n, h, d)
    assert flash_bwd_path(d, torch.float32, True) == "f32"


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_tf32x3", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _legacy_sites():
    """(n, heads, d) of the legacy zoo's flash sites at published widths:
    SD v1 and VD v1 (the UNet's transformer self-attentions, as above) and
    ADM-256's AttentionBlocks (heads of num_head_channels at each attention
    resolution; 1024 tokens at ds 8, the only map of >= 1024 tokens)."""
    cs = _chip_smoke()
    sd, adm = cs.LEGACY_SD_V1, cs.LEGACY_ADM_256
    sites = set()
    for level, mult in enumerate(sd["channel_mult"]):
        ds = 2 ** level
        tokens = (64 // ds) ** 2
        if ds in sd["attention_resolutions"] and tokens >= attention._FLASH_MIN_KV:
            sites.add((tokens, sd["num_heads"], sd["model_channels"] * mult // sd["num_heads"]))
    for level, mult in enumerate(adm["channel_mult"]):
        ds = 2 ** level
        tokens = (adm["image_size"] // ds) ** 2
        if ds in adm["attention_resolutions"] and tokens >= attention._FLASH_MIN_KV:
            ch = adm["model_channels"] * mult
            sites.add((tokens, ch // adm["num_head_channels"], adm["num_head_channels"]))
    return sorted(sites)


def test_legacy_sites():
    assert _legacy_sites() == [(1024, 8, 64), (1024, 8, 80), (4096, 8, 40)]


@pytest.mark.parametrize("n,h,d", _legacy_sites())
@pytest.mark.parametrize("order", ["legacy", "new", "projections"])
def test_plan_at_every_legacy_site(n, h, d, order):
    """The AttentionBlock's q, k and v are strided views of one fused qkv
    [B, N, 3 H d]: [B, N, H, 3, d] (legacy order: row stride 3 H d, head
    stride 3 d, k and v d and 2 d elements in) or [B, N, 3, H, d] (new
    order: head stride d, k and v H d and 2 H d in); the transformers' are
    the projections' views. All take tf32x3, views read in place."""
    b = 2
    if order == "projections":
        strides, ptrs = _views(b, n, n, h, d)
    else:
        hs = 3 * d if order == "legacy" else d
        step = d if order == "legacy" else h * d
        st = (n * 3 * h * d, 3 * h * d, hs)
        strides, ptrs = (st, st, st), tuple(4 * i * step for i in range(3))
    assert attn_fwd_plan(b, n, n, h, d, strides, ptrs, torch.float32).path == "tf32x3"


@pytest.mark.parametrize("d,offset,head_stride,why", [
    (36, 0, None, "d % 8 != 0"),
    (168, 0, None, "head over 160"),
    (100, 0, None, "a wide head with d % 8 != 0"),
    (256, 0, None, "the widest head"),
    (40, 1, None, "one element into its buffer"),
    (40, 0, 42, "head stride of 168 bytes"),
])
def test_plan_stays_on_f32_elsewhere(d, offset, head_stride, why):
    n, h = 300, 2
    hs = d if head_stride is None else head_stride
    st = (n * h * hs, h * hs, hs)
    plan = attn_fwd_plan(1, n, n, h, d, (st, st, st), (4 * offset, 0, 0), torch.float32)
    assert plan.path == "f32", why
    assert plan.grid == (-(-n // 64), h) and plan.smem_bytes <= MAX_SMEM
    vec = d % 8 == 0 and offset == 0 and hs % 4 == 0
    assert flash_bwd_path(d, torch.float32, vec) == "f32", why


def test_bf16_plans_unchanged():
    strides, ptrs = _views(4, 4096, 4096, 8, 40)
    assert attn_fwd_plan(4, 4096, 4096, 8, 40, strides, ptrs).path == "wgmma"
    assert flash_bwd_path(40, torch.bfloat16, True) == "wgmma"


# ---- numpy model of the tiles and fragments ----

def _rows_tile(x, rows):
    """RowsTile::put of x [rows, dp] (rows past len(x) zero): chunk idx at
    row (idx >> 3) / (dp / 4) * 8 + idx % 8, column chunk (idx >> 3) % (dp /
    4), stored as float4 col * rows + row."""
    dp = x.shape[1]
    ch = dp // 4
    smem = np.full(rows * dp, np.nan)
    for idx in range(rows * ch):
        r, c = (idx >> 3) // ch * 8 + (idx & 7), (idx >> 3) % ch
        at = (c * rows + r) * 4
        assert np.isnan(smem[at:at + 4]).all()
        smem[at:at + 4] = x[r, 4 * c:4 * c + 4] if r < len(x) else 0.0
    return smem


def _cols_tile(x, rows):
    """ColsTile::put of x [rows, dp]: item idx is head column idx % dp of
    group G = idx / dp, tile rows 8 (G >> 1) + (G & 1) + (0, 2, 4, 6), one
    float4 at idx."""
    dp = x.shape[1]
    smem = np.full(rows * dp, np.nan)
    for idx in range(rows // 4 * dp):
        n, grp = idx % dp, idx // dp
        r = 8 * (grp >> 1) + (grp & 1) + np.arange(0, 8, 2)
        smem[4 * idx:4 * idx + 4] = [x[i, n] if i < len(x) else 0.0 for i in r]
    return smem


def _kmajor(smem, rows, k, lbo):
    """The [rows, k] operand a K-major no-swizzle descriptor (LBO lbo bytes,
    SBO 128) reads from float offset 0, k8 step kk advanced 2 kk LBO bytes:
    element (i, j) at byte (j // 4) lbo + (i // 8) 128 + (i % 8) 16 + (j % 4) 4."""
    i, j = np.meshgrid(np.arange(rows), np.arange(k), indexing="ij")
    return smem[((j // 4) * lbo + (i // 8) * 128 + (i % 8) * 16 + (j % 4) * 4) // 4]


def _acc_layout(cols):
    """(warp, lane, index) -> (row, col) of an m64nN f32 accumulator."""
    out = {}
    for w in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for n in range(cols // 8):
                for e in range(4):
                    out[w, lane, 4 * n + e] = (16 * w + g + 8 * (e >> 1), 8 * n + 2 * t + (e & 1))
    return out


@pytest.mark.parametrize("tile,d,valid", [
    (64, 40, 64),    # the forward's key tile at the 64^2 sites
    (32, 80, 19),    # the forward and backward tiles at d 80, a ragged last tile
    (32, 8, 32),
    (64, 48, 50),
])
def test_tiles_and_fragments_give_dense_products(tile, d, valid):
    """S = A.B^T through mm3_ss's descriptors (A a 64-row RowsTile, B a
    tile-row RowsTile), and O = P.V through mm3_rs: P handed over as
    split_frags lays the accumulators into tf32 A fragments (a[0] row g,
    column t; a[1] row g + 8; a[2], a[3] column t + 4) and V as a ColsTile
    in the permuted key order, against dense products."""
    rs = np.random.RandomState(tile + d)
    a, bmat, v = rs.randn(64, d), rs.randn(valid, d), rs.randn(valid, d)
    pad = lambda x: np.pad(x, ((0, tile - len(x)), (0, 0)))
    sa = _kmajor(_rows_tile(a, 64), 64, d, 64 * 16)
    sb = _kmajor(_rows_tile(bmat, tile), tile, d, tile * 16)
    s = sa @ sb.T
    np.testing.assert_allclose(s, a @ pad(bmat).T, atol=1e-12)
    p = np.tanh(s)
    regs = {key: p[rc] for key, rc in _acc_layout(tile).items()}
    frag = np.zeros((64, tile))
    for kc in range(tile // 8):
        for w in range(4):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for r, e in enumerate((0, 2, 1, 3)):    # split_frags: a[r] = s[4 kc + e]
                    row = 16 * w + g + 8 * (r & 1)
                    col = 8 * kc + t + 4 * (r >> 1)
                    frag[row, col] = regs[w, lane, 4 * kc + e]
    bv = _kmajor(_cols_tile(v, tile), d, tile, d * 16)   # [N = d, K = tile], logical key order
    np.testing.assert_allclose(frag @ bv.T, p @ pad(v), atol=1e-12)


def test_bwd_tile_constants():
    """The backward's streamed tiles are 32 rows (four k8 steps of the rs
    products), and every head up to 80 fits shared memory (flash_bwd.cu's
    DkvTc / DqTc: two owner warpgroups share each streamed tile up to d 72
    (dK/dV) and 64 (dQ), the dK/dV kernel double-buffers up to 56)."""
    assert TF32X3_BWD_TILE == 32 and TF32X3_BWD_MAX_D == 80
    for d in range(8, TF32X3_BWD_MAX_D + 1, 8):
        # 8 bytes of mbarrier a stage
        own, dkv_stage, dq_stage = 16 * 64 * d, 4 * (8 * 32 * d + 64) + 8, 4 * 6 * 32 * d + 8
        nc_kv = 2 if d <= 72 else 1
        ns_kv = 2 if d <= 56 else 1
        nc_q = 2 if d <= 64 else 1
        assert nc_kv * own + ns_kv * dkv_stage <= MAX_SMEM < nc_kv * own + 2 * dkv_stage or ns_kv == 2
        assert nc_q * own + 2 * dq_stage <= MAX_SMEM < 2 * own + 2 * dq_stage or nc_q == 2
        assert nc_kv == 2 or 2 * own + dkv_stage > MAX_SMEM


@pytest.mark.parametrize("d,valid", [(160, 4), (88, 32), (120, 17)])
def test_wide_q_rows_fragments_and_halves_give_dense_products(d, valid):
    """The wide kernel (tf32x3_fwd_wide.cu): Q's 64 rows in f32 at a row
    stride of d + 4 floats; qk3's A fragments (a[0] row g, column t of k8
    step kk; a[1] row g + 8; a[2], a[3] column t + 4) read from there hit
    32 distinct banks a warp and, against K's RowsTile through the plane
    descriptor (LBO 32 x 16 bytes), give Q.K^T; pv3's two halves of the
    head (kN1 = 8 ceil(d / 16) columns, then the rest) read V's ColsTile
    through descriptors started c0 x 16 bytes into each plane with LBO one
    plane of d rows, and give P.V."""
    tile = TF32X3_WIDE_TILE
    rs = np.random.RandomState(d + valid)
    q, k, v = rs.randn(64, d), rs.randn(valid, d), rs.randn(valid, d)
    pad = lambda x: np.pad(x, ((0, tile - len(x)), (0, 0)))
    ldq = d + 4
    sq = np.full(64 * ldq, np.nan)
    for r in range(64):
        sq[r * ldq:r * ldq + d] = q[r]
    s = np.zeros((64, tile))
    sk = _kmajor(_rows_tile(k, tile), tile, d, tile * 16)    # [tile, d]
    for kk in range(d // 8):
        frag = np.zeros((64, 8))
        for w in range(4):
            banks = set()
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                base = (16 * w + g) * ldq + t
                for e, off in enumerate((8 * kk, 8 * ldq + 8 * kk, 8 * kk + 4,
                                         8 * ldq + 8 * kk + 4)):
                    row, col = 16 * w + g + 8 * (e & 1), 8 * kk + t + 4 * (e >> 1)
                    assert sq[base + off] == q[row, col]
                    frag[row, col - 8 * kk] = sq[base + off]
                banks.add((base + 8 * kk) % 32)
            assert len(banks) == 32
        s += frag @ sk[:, 8 * kk:8 * kk + 8].T
    np.testing.assert_allclose(s, q @ pad(k).T, atol=1e-12)
    p = np.tanh(s)
    regs = {key: p[rc] for key, rc in _acc_layout(tile).items()}
    frag = np.zeros((64, tile))
    for kc in range(tile // 8):
        for w in range(4):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for r, e in enumerate((0, 2, 1, 3)):    # split_frags: a[r] = s[4 kc + e]
                    frag[16 * w + g + 8 * (r & 1), 8 * kc + t + 4 * (r >> 1)] = \
                        regs[w, lane, 4 * kc + e]
    cols = _cols_tile(v, tile)
    n1 = -(-d // 16) * 8
    o = []
    for c0, width in ((0, n1), (n1, d - n1)):
        assert width % 8 == 0 and 0 < width <= 80
        # the descriptor starts c0 x 16 bytes into plane 0: element (i, j) of
        # the [width, tile] operand at byte 16 c0 + (j // 4) 16 d + (i // 8)
        # 128 + (i % 8) 16 + (j % 4) 4
        i, j = np.meshgrid(np.arange(width), np.arange(tile), indexing="ij")
        bv = cols[(16 * c0 + (j // 4) * 16 * d + (i // 8) * 128 + (i % 8) * 16 + (j % 4) * 4)
                  // 4]
        o.append(frag @ bv.T)
    np.testing.assert_allclose(np.concatenate(o, axis=1), p @ pad(v), atol=1e-12)
