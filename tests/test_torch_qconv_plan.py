"""The int8 conv kernel's tile plan (``vdtpu_torch/ops/qconv.py::qconv3_plan``)
on the CPU: which path each site of the full-width UNet takes, that it fits
the card's shared memory, and a numpy emulation of the halo path's index
arithmetic (``csrc/qconv_sm90.cuh``: the staging map and the ldmatrix row
addresses of each tap) against im2col."""
import dataclasses

import numpy as np
import pytest

from vdtpu_torch.config.configs import OPENAI_UNET_2D_V1
from vdtpu_torch.models.unet import build_program_2d
from vdtpu_torch.ops.qconv import MAX_SMEM_BYTES, qconv3_plan
from vdtpu_torch.ops.quant import QuantPolicy

LATENT, BATCH = 64, 4   # 512^2 images, one CFG UNet call on 2 images


def unet_conv_sites(latent: int = LATENT, batch: int = BATCH):
    """(name, b, c, h, w, n, stride) of every 3x3 conv of one 2-D UNet call of
    ``vd_four_flow_v1-0``, from its config literals (no weights built): the
    conv's input map, as ``QConv.forward`` sees it."""
    a = OPENAI_UNET_2D_V1["args"]
    prog = build_program_2d(a["in_channels"], a["model_channels"], a["out_channels"],
                            a["num_res_blocks"], a["attention_resolutions"], a["channel_mult"],
                            a["num_heads"])
    side, sites = latent, []
    for spec in prog.data:
        if spec.kind in ("conv_in", "out"):
            sites.append((spec.kind, batch, spec.in_ch, side, side, spec.out_ch, 1))
        elif spec.kind == "res":
            sites.append(("res.conv1", batch, spec.in_ch, side, side, spec.out_ch, 1))
            sites.append(("res.conv2", batch, spec.out_ch, side, side, spec.out_ch, 1))
        elif spec.kind == "down":
            sites.append(("down", batch, spec.in_ch, side, side, spec.out_ch, 2))
            side //= 2
        elif spec.kind == "up":
            side *= 2   # nearest 2x, then the conv
            sites.append(("up", batch, spec.in_ch, side, side, spec.out_ch, 1))
    return sites


def int8_sites():
    """The sites that run int8 under ``QuantPolicy()``: input maps of at
    least ``min_pixels`` pixels."""
    min_pixels = QuantPolicy().min_pixels
    return [s for s in unet_conv_sites() if s[3] * s[4] >= min_pixels]


def test_unet_sites_derived():
    sites = unet_conv_sites()
    assert len(sites) == 1 + 2 * 22 + 3 + 3 + 1   # conv_in, 22 ResBlocks, 3 down, 3 up, out
    sides = {s[3] for s in int8_sites()}
    assert sides == {64, 32, 16}                   # 8^2 maps stay in the compute dtype
    assert len(int8_sites()) == 38                 # chip_smoke.py's 38 QConvs a UNet call


@pytest.mark.parametrize("gn", [False, True], ids=["s8", "gn"])
@pytest.mark.parametrize("site", int8_sites(), ids=lambda s: f"{s[0]}-{s[2]}x{s[3]}-{s[5]}s{s[6]}")
def test_full_width_site_plan(site, gn):
    name, b, c, h, w, n, stride = site
    plan = qconv3_plan(b, h, w, c, n, stride, gn, raw_elt=2 if gn else 0)
    assert plan.path == ("general" if name == "conv_in" else "halo")
    assert plan.smem_bytes <= MAX_SMEM_BYTES
    # conv="fused" takes the ResBlock convs of the 64^2 and 32^2 maps: their
    # bf16 input rows fit shared memory beside the halo and the weights
    if gn and name.startswith("res") and h >= 32:
        assert plan.raw
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    if plan.path == "halo":
        assert plan.rows * wo <= plan.bm and c % plan.kc == 0
        assert plan.grid == (b * -(-ho // plan.rows), -(-n // plan.bn))
        assert plan.halo_h == (plan.rows - 1) * stride + 3
        assert plan.halo_w == (wo - 1) * stride + 3


def test_plan_n_tiles():
    p = qconv3_plan(4, 64, 64, 320, 320, 1)
    assert (p.bn, p.bm, p.rows, p.grid) == (160, 256, 4, (64, 2))   # 256-pixel tiles
    assert qconv3_plan(4, 32, 32, 640, 640, 1).bm == 128            # 64 wide blocks: too few
    assert qconv3_plan(4, 64, 64, 320, 320, 1, gn=True).bn == 320   # the prologue once
    assert qconv3_plan(4, 32, 32, 640, 640, 1, gn=True).grid == (32, 2)
    p = qconv3_plan(4, 16, 16, 1280, 1280, 1)   # 64 blocks: the chunks split over 2
    assert (p.grid, p.splitk) == ((8, 8), 2) and p.smem_bytes >= p.bm * p.bn * 4
    assert qconv3_plan(4, 64, 64, 320, 320, 1).splitk == 1           # 128 blocks: one a SM
    assert qconv3_plan(4, 64, 64, 320, 320, 1, gn=True).splitk == 1
    p = qconv3_plan(4, 64, 64, 320, 4, 1)                           # the output conv
    assert p.bn == 64 and p.bm == 128 and p.grid == (128, 1)
    assert qconv3_plan(2, 9, 7, 64, 72, 1).bn == 64


def test_plan_split_counts_the_card_sms():
    """The split of the channel chunks is decided on the card's SMs, the
    count the whole-ResBlock plan takes too (``sm_count``)."""
    assert qconv3_plan(4, 16, 16, 1280, 1280, 1, sms=132).splitk == 2
    assert qconv3_plan(4, 16, 16, 1280, 1280, 1, sms=32).splitk == 1   # 128 CTAs: a wave over


def test_plan_general_cases():
    assert qconv3_plan(2, 16, 16, 4, 64, 1).path == "general"     # C % 32 != 0
    assert qconv3_plan(2, 9, 7, 40, 24, 2).path == "general"
    assert qconv3_plan(1, 8, 300, 64, 64, 1).path == "general"    # Wo > 128
    assert qconv3_plan(1, 8, 8, 64, 64, 1, aligned=False).path == "general"
    assert qconv3_plan(2, 9, 7, 96, 24, 1).kc == 32


# ---------------------------------------------------------------- emulation

def halo_pos(plan, stride, hy, col):
    """Stored position of halo pixel (hy, col): ``halo_pos`` in
    ``csrc/qconv_sm90.cuh`` (stride 2 stores even columns, then odd)."""
    we = (plan.halo_w + 1) // 2
    c2 = col if stride == 1 else (we + (col >> 1) if col & 1 else col >> 1)
    return hy * plan.halo_w + c2


def emulate_halo_conv_taps(x, plan, stride):
    """The halo path's A operand for every output pixel and tap, read the way
    the kernel reads it: per tile, the halo staged into its stored positions
    (0 outside the image), then each lane's row address pix + toff.
    x: [B, H, W, C] codes; returns [B, Ho, Wo, 9, C]."""
    b_, h, w, c = x.shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    tiles = -(-ho // plan.rows)
    assert plan.rows * wo <= plan.bm
    hp = plan.halo_h * plan.halo_w
    we = (plan.halo_w + 1) // 2
    dx1, dx2 = (1, 2) if stride == 1 else (we, 1)
    out = np.full((b_, ho, wo, 9, c), -999, np.int64)
    for bx in range(b_ * tiles):
        b, r0 = bx // tiles, (bx % tiles) * plan.rows
        valid = min(plan.rows, ho - r0) * wo
        halo = np.full((hp, c), -1000, np.int64)
        written = np.zeros(hp, np.int64)
        for hy in range(plan.halo_h):
            for col in range(plan.halo_w):
                yi, xi = r0 * stride - 1 + hy, col - 1
                pos = halo_pos(plan, stride, hy, col)
                assert 0 <= pos < hp
                written[pos] += 1
                inb = 0 <= yi < h and 0 <= xi < w
                halo[pos] = x[b, yi, xi] if inb else 0
        assert (written == 1).all()      # the staging map is a bijection
        for m_raw in range(plan.bm):
            m = min(m_raw, valid - 1)    # pixels past the tile read a valid one
            yo, xo = m // wo, m % wo
            pix = yo * stride * plan.halo_w + xo
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                p = pix + dy * plan.halo_w + (0, dx1, dx2)[dx]
                assert 0 <= p < hp
                if m_raw < valid:
                    out[b, r0 + yo, xo, tap] = halo[p]
    return out


def im2col(x, stride):
    b, h, w, c = x.shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    xp = np.zeros((b, h + 2, w + 2, c), np.int64)
    xp[:, 1:-1, 1:-1] = x
    out = np.zeros((b, ho, wo, 9, c), np.int64)
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        out[:, :, :, tap] = xp[:, dy:dy + (ho - 1) * stride + 1:stride,
                               dx:dx + (wo - 1) * stride + 1:stride]
    return out


@pytest.mark.parametrize("b,h,w,stride,bm", [
    (2, 9, 7, 1, 128), (2, 9, 7, 2, 128), (1, 12, 20, 1, 128), (1, 13, 11, 2, 128),
    (2, 16, 16, 1, 128), (2, 16, 16, 2, 128),  # Wo divides the tile
    (1, 5, 48, 1, 128),                        # 48 does not divide 128: 2 rows, 32 pixels idle
    (1, 4, 130, 2, 128),                       # Wo = 65 > 64: one row a tile
    (1, 19, 16, 1, 256), (1, 21, 30, 2, 256),  # 256-pixel tiles
])
def test_halo_taps_match_im2col(b, h, w, stride, bm):
    c = 32
    rng = np.random.default_rng(0)
    x = rng.integers(-127, 128, (b, h, w, c))
    plan = qconv3_plan(b, h, w, c, 64, stride)
    assert plan.path == "halo"
    if bm != plan.bm:   # the wide tile's geometry on a map small enough to emulate
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        rows = min(bm // wo, ho)
        plan = dataclasses.replace(plan, bm=bm, rows=rows, halo_h=(rows - 1) * stride + 3)
    np.testing.assert_array_equal(emulate_halo_conv_taps(x, plan, stride), im2col(x, stride))


@pytest.mark.parametrize("site", [s for s in int8_sites() if s[0] != "conv_in"],
                         ids=lambda s: f"{s[0]}-{s[2]}x{s[3]}-{s[5]}s{s[6]}")
def test_ldmatrix_phases_conflict_free(site):
    """At every halo site, the 8 row addresses of each ldmatrix phase of A (8
    neighbouring output pixels of one tap) fall in 8 distinct 16-byte bank
    groups of the 128-byte shared-memory row."""
    _, b, c, h, w, n, stride = site
    plan = qconv3_plan(b, h, w, c, n, stride)
    wo = (w - 1) // stride + 1
    ld = plan.kc + 16
    we = (plan.halo_w + 1) // 2
    dx1, dx2 = (1, 2) if stride == 1 else (we, 1)
    valid = min(plan.rows, (h - 1) // stride + 1) * wo
    for m0 in range(0, plan.bm, 8):
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            groups = set()
            for i in range(8):
                m = min(m0 + i, valid - 1)
                p = (m // wo) * stride * plan.halo_w + m % wo + dy * plan.halo_w
                groups.add((p + (0, dx1, dx2)[dx]) * ld // 16 % 8)
            if m0 + 8 <= valid:
                assert len(groups) == 8, (m0, tap, sorted(groups))


def _site_divisors():
    """halo_w and halo_h * halo_w of every halo site, both modes."""
    out = set()
    for _, b, c, h, w, n, stride in int8_sites():
        for gn in (False, True):
            p = qconv3_plan(b, h, w, c, n, stride, gn)
            if p.path == "halo":
                out |= {p.halo_w, p.halo_h * p.halo_w}
    return sorted(out)


@pytest.mark.parametrize("d", _site_divisors() + [1, 2, 3, 7, 255, 4097, 65535])
def test_magic_division_is_exact(d):
    """``div_by`` in ``csrc/qconv_sm90.cuh``: n / d as the high word of n * m,
    m = (2^32 - 1) // d + 1, for every index n < 2^16 the kernel divides."""
    n = np.arange(1 << 16, dtype=np.uint64)
    m = np.uint64(0xFFFFFFFF // d + 1)
    np.testing.assert_array_equal((n * m) >> np.uint64(32), n // np.uint64(d))
