"""The GroupNorm(+SiLU) kernel's plan (``vdtpu_torch/ops/gn_silu.py::gn_plan``)
and its order of work (``gn_blocked_plain``) on the CPU.

The plan is held at every GroupNorm site the port's flows reach, listed from
the config literals: the full-width UNet call at B = 4 (61 sites), the VAE
decoder's and encoder's, and the text diffuser's [8, C, 1] and [8, C, 4]
sites. The blocked model (per-CTA partial sums as the kernel's reduction
teams take them, the cluster's combine in rank order, the apply of the
plan's layout) is held against vdtpu's Pallas ``gn_silu`` in interpret
mode, on both routes."""
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdtpu.ops.pallas import gn_silu as jgn
from vdtpu_torch.config import configs
from vdtpu_torch.models.autoencoder import VAEDecoder, VAEEncoder
from vdtpu_torch.models.layers import GroupNorm32
from vdtpu_torch.models.unet import (C, D, UNet0DNext, UNet2DNext, build_program_0d,
                                     build_program_2d)
from vdtpu_torch.ops.gn_silu import (GN_CLUSTERS, GN_MAX_SMEM, GN_SM_SMEM,
                                     GN_SMEM_BUDGET, GNPlan, gn_blocked_plain, gn_plan, gn_silu,
                                     gn_smem_bytes, gn_variant)

torch.set_num_threads(2)

SMS = 132


def _kwargs(cls, args):
    params = inspect.signature(cls.__init__).parameters
    return {k: v for k, v in args.items() if k in params}


def unet2d_sites(b: int = 4, latent: int = 64):
    """[B, C, H, W] of every GroupNorm call of one image-diffuser call (data
    blocks and context blocks), in program order."""
    a = configs.OPENAI_UNET_2D_V1["args"]
    prog = build_program_2d(a["in_channels"], a["model_channels"], a["out_channels"],
                            a["num_res_blocks"], a["attention_resolutions"], a["channel_mult"],
                            a["num_heads"])
    sites, side, di, ci = [], latent, 0, 0
    for op in prog.layer_order:
        if op == D:
            spec = prog.data[di]
            di += 1
            if spec.kind == "res":
                sites += [(b, spec.in_ch, side, side), (b, spec.out_ch, side, side)]
            elif spec.kind == "down":
                side //= 2
            elif spec.kind == "up":
                side *= 2
            elif spec.kind == "out":
                sites.append((b, spec.in_ch, side, side))
        elif op == C:
            sites.append((b, prog.ctx[ci].channels, side, side))
            ci += 1
    return sites


def unet0d_sites(b: int = 8):
    """[B, F, 1] of the text diffuser's FC blocks, [B, C, S] of its context
    blocks and of its output GroupNorm, in program order."""
    a = configs.OPENAI_UNET_0D_V1_DC["args"]
    prog = build_program_0d(a["input_channels"], a["model_channels"], a["output_channels"],
                            a["num_noattn_blocks"], a["channel_mult"], a["second_dim"],
                            a["with_attn"], a["num_heads"])
    sites, di, ci = [], 0, 0
    sdim = a["second_dim"][0]
    for op in prog.layer_order:
        if op == D:
            spec = prog.data[di]
            di += 1
            if spec.kind == "fc":
                sites += [(b, spec.in_ch, 1), (b, spec.out_ch, 1)]
            elif spec.kind == "out0d":
                sites.append((b, spec.in_ch // sdim, sdim))
        elif op == C:
            sites.append((b, prog.ctx[ci].channels, sdim))
            ci += 1
    return sites


def vae_sites(b: int = 2):
    """[B, C, H, W] of the KL-f8 decoder's GroupNorm calls from a 64^2
    latent, and of its encoder's from a 512^2 image."""
    dd = configs.AUTOKL_V1["args"]["ddconfig"]
    ch, mult, nrb = dd["ch"], dd["ch_mult"], dd["num_res_blocks"]
    dec, side, block_in = [], 64, ch * mult[-1]
    mid = lambda c, s: [(b, c, s, s)] * 5          # two ResBlocks and the attention
    dec += mid(block_in, side)
    for level in reversed(range(len(mult))):
        out = ch * mult[level]
        for _ in range(nrb + 1):
            dec += [(b, block_in, side, side), (b, out, side, side)]
            block_in = out
        if level:
            side *= 2
    dec.append((b, block_in, side, side))
    enc, side, block_in = [], 512, ch
    for level, m in enumerate(mult):
        for _ in range(nrb):
            enc += [(b, block_in, side, side), (b, ch * m, side, side)]
            block_in = ch * m
        if level != len(mult) - 1:
            side //= 2
    enc += mid(block_in, side) + [(b, block_in, side, side)]
    return dec, enc


def _gn_channels(module):
    return sorted(m.weight.shape[0] for m in module.modules() if isinstance(m, GroupNorm32))


def test_site_lists_are_the_models():
    """The listed sites are the port's GroupNorm modules, channel for channel."""
    with torch.device("meta"):
        u2 = UNet2DNext(**_kwargs(UNet2DNext, configs.OPENAI_UNET_2D_V1["args"]))
        u0 = UNet0DNext(**_kwargs(UNet0DNext, configs.OPENAI_UNET_0D_V1_DC["args"]))
        dd = configs.AUTOKL_V1["args"]["ddconfig"]
        dec, enc = VAEDecoder(**_kwargs(VAEDecoder, dd)), VAEEncoder(**_kwargs(VAEEncoder, dd))
    unet, text = unet2d_sites(), unet0d_sites()
    assert len(unet) == 61 and len(text) == 61
    assert sorted(s[1] for s in unet) == sorted(_gn_channels(u2.data_blocks)
                                                + _gn_channels(u2.context_blocks))
    assert sorted(s[1] for s in text) == sorted(_gn_channels(u0.data_blocks)
                                                + _gn_channels(u0.context_blocks))
    d, e = vae_sites()
    assert sorted(s[1] for s in d) == _gn_channels(dec)
    assert sorted(s[1] for s in e) == _gn_channels(enc)
    assert {s[2] for s in unet} == {64, 32, 16, 8} and {s[2] for s in d} == {64, 128, 256, 512}


def _es(dtype):
    return torch.empty((), dtype=dtype).element_size()


def _check_plan(shape, dtype, plan: GNPlan, groups: int = 32):
    b, c = shape[:2]
    hw = math.prod(shape[2:])
    es = _es(dtype)
    cpg = c // groups
    gpb, k = plan.groups_per_band, plan.cluster
    bandc = gpb * cpg
    assert plan.route in ("resident", "streaming") and plan.layout in ("rows", "flat")
    assert k in GN_CLUSTERS and plan.smem_bytes <= GN_MAX_SMEM
    # whole groups a band, every (sample, group) in one band, every pixel in one CTA
    assert groups % gpb == 0 and plan.bands * gpb == b * groups
    assert (plan.clusters == plan.bands if plan.route == "resident"
            else 1 <= plan.clusters <= plan.bands)
    assert plan.pixels * k == hw and plan.threads in (128, 256, 512)
    if plan.layout == "rows":
        assert (hw * es) % 16 == 0 and (plan.pixels * es) % 16 == 0
    else:
        assert k == 1 and plan.route == "resident"
    assert plan.smem_bytes == gn_smem_bytes(plan.route, plan.layout, plan.threads, gpb, bandc,
                                            plan.pixels, hw, es)
    if plan.route == "resident":
        tile = bandc * plan.pixels * es if plan.layout == "rows" else bandc * hw * es + 16
        assert tile <= GN_SMEM_BUDGET + 16 and plan.smem_bytes >= tile
        # one wave: every CTA resident at once on the SMs its clusters can use
        per_sm = min(GN_SM_SMEM // (plan.smem_bytes + 1024), 2048 // plan.threads)
        assert plan.ctas <= GN_CLUSTERS[k] * k * per_sm


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_at_every_unet_site(dtype):
    """The 61 sites of a full-width UNet call at B = 4, in clusters that use
    at least 90% of the card's SMs. In bf16 every site but the 960-channel
    64^2 one (245 KB groups, two waves of resident CTAs; it streams at one
    CTA a group) is resident."""
    for site in unet2d_sites():
        plan = gn_plan(site, dtype, 32)
        _check_plan(site, dtype, plan)
        assert plan.layout == "rows" and plan.ctas >= 0.9 * SMS, (site, plan)
        if dtype == torch.bfloat16:
            assert (plan.route == "streaming") == (site == (4, 960, 64, 64)), (site, plan)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_at_the_vae_and_text_sites(dtype):
    dec, enc = vae_sites(2)
    for site in dec + enc + vae_sites(1)[0]:
        plan = gn_plan(site, dtype, 32)
        _check_plan(site, dtype, plan)
        if site[0] == 2:   # clusters of 16 use 112 of the 132 SMs
            assert plan.ctas >= 112, (site, plan)
        if site[2] == 512:  # 1 MB (f32: 2 MB) groups and more: the CTAs take more than a wave
            assert plan.route == "streaming", (site, plan)
    for site in unet0d_sites():
        plan = gn_plan(site, dtype, 32)
        _check_plan(site, dtype, plan)
        assert plan.route == "resident" and plan.cluster == 1
        assert plan.layout == ("rows" if site[2] * _es(dtype) % 16 == 0 else "flat")


@pytest.mark.parametrize("batch", [2, 8, 16])
def test_plan_at_the_queue_buckets(batch):
    """The serving queue's buckets (1, 4 and 8 images: the UNet at batch 2,
    8 and 16, the KL-f8 decoder at 1, 4 and 8): every UNet and decoder site
    plans validly, its resident CTAs in one wave. At batch 16 the 64^2 maps
    stream (their resident CTAs would take more than a wave)."""
    vae_batch = batch // 2
    for site in unet2d_sites(batch) + vae_sites(vae_batch)[0]:
        plan = gn_plan(site, torch.bfloat16, 32)
        _check_plan(site, torch.bfloat16, plan)
    if batch == 16:
        assert gn_plan((16, 320, 64, 64), torch.bfloat16, 32).route == "streaming"
        assert gn_plan((16, 640, 32, 32), torch.bfloat16, 32).route == "resident"


@pytest.mark.parametrize("shape", [(16, 320, 64, 64), (16, 640, 32, 32), (16, 2560, 8, 8),
                                   (8, 512, 64, 64), (2, 960, 64, 64), (1, 128, 512, 512)])
def test_plan_covers_every_element_once_at_the_buckets(shape):
    plan = gn_plan(shape, torch.bfloat16, 32)
    assert (_cover(shape, plan) == 1).all()


def _cover(shape, plan: GNPlan, groups: int = 32):
    """How often the plan's (band, rank) shares take each element of x."""
    b, c = shape[:2]
    hw = math.prod(shape[2:])
    cpg = c // groups
    bandc = plan.groups_per_band * cpg
    seen = np.zeros((b, c, hw), np.int32)
    for cta in range(plan.ctas):   # csrc: cluster cta // k walks the bands plan.clusters apart
        first, rank = divmod(cta, plan.cluster)
        for band in range(first, plan.bands, plan.clusters):
            bi, c0 = divmod(band, groups // plan.groups_per_band)
            seen[bi, c0 * bandc:(c0 + 1) * bandc, rank * plan.pixels:(rank + 1) * plan.pixels] += 1
    return seen


@pytest.mark.parametrize("shape,groups", [
    ((4, 320, 64, 64), 32), ((2, 512, 128, 128), 32), ((2, 128, 512, 512), 32),
    ((2, 256, 512, 512), 32), ((8, 1280, 1), 32), ((2, 96, 7, 9), 32), ((2, 40, 5, 3), 8)])
def test_plan_covers_every_element_once(shape, groups):
    plan = gn_plan(shape, torch.bfloat16, groups)
    assert (_cover(shape, plan, groups) == 1).all()


@pytest.mark.parametrize("shape", [(4, 960, 64, 64), (2, 512, 128, 128), (2, 128, 512, 512)])
def test_variants_cover_every_element_once(shape):
    """chip_smoke.py's gn_sweep plans: both routes at each cluster size the
    kernel takes, every element in one CTA's share, the C side's layout."""
    seen = set()
    for route in ("resident", "streaming"):
        for k in (1, 2, 4, 8, 16):
            plan = gn_variant(shape, torch.bfloat16, 32, route, k)
            if plan is None:
                continue
            seen.add((route, k))
            assert (plan.route, plan.cluster) == (route, k) and plan.smem_bytes <= GN_MAX_SMEM
            es = 2
            assert plan.smem_bytes == gn_smem_bytes(route, plan.layout, plan.threads,
                                                    plan.groups_per_band, shape[1] // 32,
                                                    plan.pixels, math.prod(shape[2:]), es)
            if shape[2] <= 128:
                assert (_cover(shape, plan) == 1).all()
    assert ("streaming", 2) in seen and ("resident", 16) in seen


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        gn_plan((2, 30, 4, 4), torch.bfloat16, 32)            # 32 groups do not divide 30
    with pytest.raises(TypeError):
        gn_plan((2, 64, 4, 4), torch.int8, 32)
    with pytest.raises(ValueError):   # a 4 MB group of odd rows: no resident or streaming plan
        gn_plan((1, 32, 1, 1_000_001), torch.bfloat16, 32)
    assert gn_variant((2, 96, 7, 9), torch.bfloat16, 32, "streaming", 1) is None  # flat
    assert gn_variant((2, 128, 512, 512), torch.bfloat16, 32, "resident", 8) is None  # 256 KB


def test_wrapper_counts_launches_by_route():
    assert set(gn_silu.launches_by_path) == {"resident", "streaming"}


def _inputs(shape, seed):
    rs = np.random.RandomState(seed)
    c = shape[1]
    x = (rs.randn(*shape) * 2 + 0.3).astype(np.float32)
    return x, (rs.rand(c) + 0.5).astype(np.float32), (rs.randn(c) * 0.1).astype(np.float32)


def _to_jax(x):
    """[B, C, *spatial] -> vdtpu's channel-last [B, *spatial, C]."""
    return jnp.asarray(np.moveaxis(x, 1, -1))


# f32, the JAX test's kernel-vs-GroupNorm tolerance (same E[x^2]-E[x]^2
# statistics, other summation order): rows with a cluster of 2, rows with
# several bands a sample, the flat layout (odd map; the text diffuser's
# [B, F, 1] and [B, C, 4]), and the streaming route (clusters of 2)
@pytest.mark.parametrize("shape,route,want", [
    ((1, 128, 64, 64), None, ("resident", "rows", 2)),
    ((2, 64, 16, 16), None, ("resident", "rows", 1)),
    ((2, 96, 7, 9), None, ("resident", "flat", 1)),
    ((8, 320, 1), None, ("resident", "flat", 1)),
    ((8, 64, 4), None, ("resident", "rows", 1)),
    ((2, 64, 16, 16), "streaming", ("streaming", "rows", 2)),
])
@pytest.mark.parametrize("with_silu", [True, False])
def test_blocked_model_matches_jax_kernel(shape, route, want, with_silu):
    x, w, b = _inputs(shape, sum(shape))
    plan = (gn_plan(shape, torch.float32, 32) if route is None
            else gn_variant(shape, torch.float32, 32, route, want[2]))
    assert (plan.route, plan.layout, plan.cluster) == want
    out = gn_blocked_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 32,
                           1e-6, with_silu, plan)
    ref = jgn.gn_silu(_to_jax(x), jnp.asarray(w), jnp.asarray(b), 32, 1e-6, with_silu,
                      interpret=True)
    np.testing.assert_allclose(np.moveaxis(out.numpy(), 1, -1), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)
