"""The whole-ResBlock kernel's plan (``vdtpu_torch/ops/qconv.py::resblock_plan``)
and its order of work (``resblock_blocked_plain``) on the CPU: the conv
tiles cover every (pixel, channel) of both convs once, the halo reads stay
inside the staged halo and hit the right image pixels, shared memory fits
the card, no GroupNorm group straddles two N tiles, each GN2 slot is
written by exactly one conv1 tile, the conv tiles fill a wave at the
full-width UNet's fused2 sites; and the blocked model against vdtpu's
Pallas ``resblock_flat`` (interpret mode) and against ``resblock_plain``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused2 import _resblock_inputs, _to
from vdtpu.ops.pallas import qconv as jqc
from vdtpu_torch.ops.qconv import (HALO_STAGES, MAX_SMEM_BYTES, RB_MIN_FILL, _rb_pass,
                                   resblock_blocked_plain, resblock_plain, resblock_plan)

torch.set_num_threads(2)

# the 8 distinct conv="fused2" sites of one full-width UNet call at B = 4
# (chip_smoke.py's RESBLOCK_SHAPES): (B, C_in, H, W, C_out)
FULL_WIDTH_SITES = [(4, 320, 64, 64, 320), (4, 640, 64, 64, 320), (4, 960, 64, 64, 320),
                    (4, 320, 32, 32, 640), (4, 640, 32, 32, 640), (4, 1920, 32, 32, 640),
                    (4, 1280, 32, 32, 640), (4, 960, 32, 32, 640)]
# tiny shapes: ragged last row tile (8 rows of 24 pixels in 5-row tiles;
# 24 rows of 8 in 16-row tiles), C % 64 != 0 with C % 32 == 0 (32-channel
# halo chunks), C != N, several N tiles and groups a tile; then the
# general route (N % 32 != 0 for the halo's N tiles, C % 32 != 0)
TINY_SITES = [(2, 64, 16, 16, 64), (2, 64, 8, 24, 128), (1, 96, 24, 8, 64),
              (2, 32, 32, 32, 64), (1, 320, 16, 16, 640)]
GENERAL_SITES = [(2, 32, 32, 32, 32), (1, 4, 8, 8, 32), (4, 320, 64, 64, 96)]


def _check_halo_plan(b, c, h, w, n, plan):
    groups = 32
    cpg = n // groups
    assert plan.route == "halo"
    assert plan.barriers == 4 and plan.phases[2] == "conv1" and plan.phases[-1] == "conv2"
    assert c % plan.kc == 0 and n % plan.kc == 0 and n % plan.bn == 0
    assert plan.rows == min(plan.bm // w, h) and plan.rows * w <= plan.bm
    # the halo of a tile (csrc: rows + 2 by w + 2 pixels), double-buffered,
    # and the weight ring fit the block's shared memory, which fits the card
    halo_h, halo_w = plan.rows + 2, w + 2
    assert 2 * halo_h * halo_w * (plan.kc + 16) + HALO_STAGES * plan.bn * plan.kc \
        <= plan.smem_bytes <= MAX_SMEM_BYTES
    assert plan.grid == (2 if plan.bm == 128 else 1) * 132
    # no GroupNorm group straddles an N tile, nor one of the epilogue's passes
    assert plan.bn % cpg == 0 and _rb_pass(plan.bn) % cpg == 0 and plan.bn % _rb_pass(plan.bn) == 0
    # every (sample, pixel, channel) of the conv output exactly once
    tiles_img = -(-h // plan.rows)
    ntn = n // plan.bn
    assert plan.conv_tiles == b * tiles_img * ntn
    cover = np.zeros((b, h, w, n), np.int32)
    slots = np.zeros((b, groups, plan.gn2_slots), np.int32)
    for item in range(plan.conv_tiles):     # csrc conv_halo: make_tile(item / ntn, item % ntn)
        mt, nt = divmod(item, ntn)
        bb, r0 = mt // tiles_img, (mt % tiles_img) * plan.rows
        valid_rows = min(plan.rows, h - r0)
        n0 = nt * plan.bn
        cover[bb, r0:r0 + valid_rows, :, n0:n0 + plan.bn] += 1
        for c0 in range(0, plan.bn, _rb_pass(plan.bn)):     # mid_epilogue's passes
            for gl in range(_rb_pass(plan.bn) // cpg):
                slots[bb, (n0 + c0) // cpg + gl, r0 // plan.rows] += 1
    assert (cover == 1).all()
    assert plan.gn2_slots == tiles_img and (slots == 1).all()
    # halo reads (csrc a_row / tap_offset): every lane's row, clamped to the
    # tile's last valid pixel, and each tap's shift stay inside the staged
    # halo and land on the image pixel (y + dy - 1, x + dx - 1)
    for r0 in range(0, h, plan.rows):
        valid = min(plan.rows, h - r0) * w
        m = np.minimum(np.arange(plan.bm), valid - 1)
        yo, xo = m // w, m % w
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            pos = yo * halo_w + xo + dy * halo_w + dx
            assert pos.min() >= 0 and pos.max() < halo_h * halo_w
            hy, col = pos // halo_w, pos % halo_w
            assert (r0 - 1 + hy == r0 + yo + dy - 1).all() and (col - 1 == xo + dx - 1).all()


@pytest.mark.parametrize("site", FULL_WIDTH_SITES, ids=lambda s: f"{s[1]}x{s[2]}-{s[4]}")
def test_full_width_site_plan(site):
    b, c, h, w, n = site
    plan = resblock_plan(b, h, w, c, n)
    _check_halo_plan(b, c, h, w, n, plan)
    assert plan.fill >= RB_MIN_FILL, (plan.conv_tiles, plan.grid)


@pytest.mark.parametrize("site", TINY_SITES, ids=lambda s: "-".join(map(str, s)))
def test_tiny_site_plan(site):
    b, c, h, w, n = site
    plan = resblock_plan(b, h, w, c, n)
    _check_halo_plan(b, c, h, w, n, plan)
    assert plan.kc == (64 if c % 64 == 0 and n % 64 == 0 else 32)


@pytest.mark.parametrize("site", GENERAL_SITES, ids=lambda s: "-".join(map(str, s)))
def test_general_route_plan(site):
    b, c, h, w, n = site
    plan = resblock_plan(b, h, w, c, n)
    assert plan.route == "general" and plan.bm == 128 and plan.barriers == 5
    assert plan.gn2_slots == 1
    assert plan.conv_tiles == b * -(-h * w // 128) * -(-n // 64)
    assert plan.smem_bytes <= MAX_SMEM_BYTES and plan.grid == 264


def test_plan_tiles():
    p = resblock_plan(4, 64, 64, 320, 320)
    assert (p.bm, p.bn, p.rows, p.conv_tiles, p.grid) == (256, 160, 4, 128, 132)
    p = resblock_plan(4, 32, 32, 640, 640)     # 80 channels a tile: 128 tiles again
    assert (p.bm, p.bn, p.rows, p.conv_tiles, p.grid) == (256, 80, 8, 128, 132)
    # a card with fewer SMs: the same tiles, another grid
    assert resblock_plan(4, 64, 64, 320, 320, sms=114).grid == 114


def _blocked_flat(args, plan=None):
    """resblock_blocked_plain on resblock_flat's flat arguments."""
    x, skip = args["x"], args["skip"]
    b, m, c = x.shape
    h, w = args["h"], args["w"]
    n = args["w1q"].shape[-1]
    nchw = lambda t: t.reshape(b, h, w, t.shape[-1]).permute(0, 3, 1, 2)
    y = resblock_blocked_plain(
        nchw(x), args["gn1"][0], args["gn1"][1], args["w1q"].permute(3, 0, 1, 2).contiguous(),
        args["s1w"].reshape(n), args["b1"], args["sx1"].reshape(()), args["film"],
        args["gn2"][0], args["gn2"][1], args["w2q"].permute(3, 0, 1, 2).contiguous(),
        args["s2w"].reshape(n), args["b2"], args["sx2"].reshape(()),
        None if skip is None else nchw(skip), plan=plan)
    return y.permute(0, 2, 3, 1).reshape(b, m, n)


def _torch_args(args, pdt):
    pa = {k: _to(v, torch.from_numpy, pdt) for k, v in args.items()}
    for k in ("s1w", "s2w", "sx1", "sx2"):   # scales stay f32
        pa[k] = torch.from_numpy(np.asarray(args[k]))
    return pa


# the same codes and exact integer sums on every side; the f32 GN
# statistics, epilogues and the mid's rounding agree to f32 rounding
@pytest.mark.parametrize("c,n,with_skip", [(64, 64, False), (32, 64, True)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_blocked_plain_matches_pallas_kernel_and_plain(c, n, with_skip, dtype):
    args = _resblock_inputs(c, n, with_skip, seed=0)
    jdt, pdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ja = {k: _to(v, jnp.asarray, jdt) for k, v in args.items()}
    for k in ("s1w", "s2w", "sx1", "sx2"):
        ja[k] = jnp.asarray(args[k])
    ref = np.asarray(jqc.resblock_flat(**ja, interpret=True).astype(jnp.float32))
    pa = _torch_args(args, pdt)
    plan = resblock_plan(2, args["h"], args["w"], c, n)
    assert plan.route == "halo"          # the per-tile GN2 slots are what is held here
    out = _blocked_flat(pa, plan)
    assert out.dtype == pdt and tuple(out.shape) == ref.shape
    out = out.float().numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    b, m = args["x"].shape[:2]
    nchw = lambda t: None if t is None else t.reshape(b, 32, 32, t.shape[-1]).permute(0, 3, 1, 2)
    plain = resblock_plain(nchw(pa["x"]), *pa["gn1"], pa["w1q"].permute(3, 0, 1, 2).contiguous(),
                           pa["s1w"].reshape(n), pa["b1"], pa["sx1"].reshape(()), pa["film"],
                           *pa["gn2"], pa["w2q"].permute(3, 0, 1, 2).contiguous(),
                           pa["s2w"].reshape(n), pa["b2"], pa["sx2"].reshape(()),
                           nchw(pa["skip"]))
    plain = plain.permute(0, 2, 3, 1).reshape(b, m, n).float().numpy()
    np.testing.assert_allclose(out, plain, atol=1e-5, rtol=1e-5)
    assert np.abs(ref).max() > 1.0


def test_blocked_plain_general_route_matches_plain():
    """The general route's order of work (GN2 from 256-pixel chunks of the
    mid) at the tiny config's 32-channel level."""
    args = _torch_args(_resblock_inputs(32, 32, False, seed=2), torch.float32)
    plan = resblock_plan(2, 32, 32, 32, 32)
    assert plan.route == "general"
    b, m, n = 2, 32 * 32, 32
    out = _blocked_flat(args, plan)
    x = args["x"].reshape(b, 32, 32, 32).permute(0, 3, 1, 2)
    plain = resblock_plain(x, *args["gn1"], args["w1q"].permute(3, 0, 1, 2).contiguous(),
                           args["s1w"].reshape(n), args["b1"], args["sx1"].reshape(()),
                           args["film"], *args["gn2"], args["w2q"].permute(3, 0, 1, 2).contiguous(),
                           args["s2w"].reshape(n), args["b2"], args["sx2"].reshape(()))
    np.testing.assert_allclose(out.numpy(), plain.permute(0, 2, 3, 1).reshape(b, m, n).numpy(),
                               atol=1e-5, rtol=1e-5)


def test_blocked_plain_sees_a_missing_gn2_slot():
    """A plan whose GN2 slots leave conv1's last row tile out moves the
    statistics, and the output leaves the 1e-5 band by far: the comparison
    above would see it."""
    import dataclasses
    args = _torch_args(_resblock_inputs(64, 64, False, seed=0, b=1, h=10, w=16),
                       torch.float32)
    plan = resblock_plan(1, 10, 16, 64, 64)
    assert plan.gn2_slots == 2                  # 8 rows, then the ragged 2
    good = _blocked_flat(args, plan).numpy()
    bad = _blocked_flat(args, dataclasses.replace(plan, gn2_slots=1)).numpy()
    assert np.abs(bad - good).max() > 1e-3


def test_sass_counter_takes_the_halo_loop():
    """``python -m vdtpu_torch.utils.sass resblock_q``: of a kernel's loops
    with tensor-core instructions, the one with wgmma is taken (the
    whole-ResBlock kernel also holds the general route's shorter mma.sync
    loop), and its work per iteration comes from the template's KC and BN."""
    from vdtpu_torch.utils.sass import _work, main_loop, parse
    listing = """
        Function : _ZN15resblock_kernelI13__nv_bfloat16Li64ELi160ELi256EEEvN6ParamsE
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   IMMA.16832.S8.S8 R4, R8, R10, R4 ;
        /*0020*/              @P0 BRA 0x10 ;
        /*0030*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0040*/                   LDSM.16.M88.4 R12, [R13] ;
        /*0050*/                   WARPGROUP.ARRIVE ;
        /*0060*/                   IGMMA.64x160x32.S8.S8 R24, R12, gdesc[UR4], R24 ;
        /*0070*/              @!P1 BRA 0x30 ;
        /*0080*/                   EXIT ;
    """
    funcs = parse(listing)
    (name, instrs), = funcs.items()
    body = main_loop(instrs)
    assert [t.split()[0] for t in body] == ["BAR.SYNC.DEFER_BLOCKING", "LDSM.16.M88.4",
                                            "WARPGROUP.ARRIVE", "IGMMA.64x160x32.S8.S8", "@!P1"]
    assert _work(name, "resblock_q") == (64 // 32) * (160 // 8)
    assert _work("_Z18qconv3_halo_kernelIfLi32ELi80ELi128EEvN3vdq11QConvParamsE", "qconv3") == 10
