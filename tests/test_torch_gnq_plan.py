"""The int8 GroupNorm kernels' plan (``vdtpu_torch/ops/gn_silu.py::gnq_plan``)
and their order of work (``gnq_blocked_plain``) on the CPU.

The plan is held at every int8 GroupNorm site of the full-width UNet call at
B = 4, listed from the config literals: the 30 ResBlock GroupNorms on maps
of at least 256 pixels (``QuantPolicy.min_pixels``), whose convs run int8
(``gn_silu_q`` under ``gn_prologue="fused"``, ``gn_stats`` under "stats").
The blocked model (per-channel partials of every tile, the fixed-order
combine of each group's partials, the apply and the transposed store of the
codes) is held against vdtpu's Pallas ``gn_silu_q`` (whole slab),
``_gn_silu_q_blocked`` and ``gn_stats`` in interpret mode."""
import importlib.util
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdtpu.ops.pallas import gn_silu as jgn
from vdtpu_torch.config import configs
from vdtpu_torch.models.unet import D, build_program_2d
from vdtpu_torch.ops.gn_silu import (GN_MAX_SMEM, GNQ_GROUP_THREADS, GNQPlan, gn_silu_q,
                                     gn_silu_q_plain, gn_stats, gn_stats_plain,
                                     gnq_blocked_plain, gnq_blocks_per_sm, gnq_plan, gnq_slice,
                                     gnq_smem_bytes, gnq_variants)
from vdtpu_torch.ops.quant import QuantPolicy

torch.set_num_threads(2)

SMS = 132
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# rows of 16-byte vectors that gnq_plan cannot take: odd maps, one pixel a
# channel, C % 16 != 0 in groups of 5 channels (the card tests' shapes)
ODD = [((2, 96, 7, 9), 32), ((3, 320, 33, 17), 32), ((1, 64, 1, 1), 32), ((2, 40, 5, 3), 8)]


def int8_gn_sites(b: int = 4, latent: int = 64):
    """[B, C, H, W] of every ResBlock GroupNorm of one image-diffuser call
    whose conv runs int8 (maps of at least min_pixels pixels), in program
    order: GN1 on the block's input, GN2 on its output width."""
    a = configs.OPENAI_UNET_2D_V1["args"]
    prog = build_program_2d(a["in_channels"], a["model_channels"], a["out_channels"],
                            a["num_res_blocks"], a["attention_resolutions"], a["channel_mult"],
                            a["num_heads"])
    sites, side, di = [], latent, 0
    for op in prog.layer_order:
        if op != D:
            continue
        spec = prog.data[di]
        di += 1
        if spec.kind == "res" and side * side >= QuantPolicy().min_pixels:
            sites += [(b, spec.in_ch, side, side), (b, spec.out_ch, side, side)]
        side = side // 2 if spec.kind == "down" else side * 2 if spec.kind == "up" else side
    return sites


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT,
                                                                             "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_site_list_is_the_models_and_chip_smokes():
    """30 sites a UNet call (chip_smoke.py's modes phase counts 30 gn_silu_q
    launches a call); their 12 distinct shapes are chip_smoke.py's GNQ_SHAPES."""
    sites = int8_gn_sites()
    assert len(sites) == 30
    distinct = sorted(set(sites), key=lambda s: (-s[2], s[1]))
    assert distinct == _chip_smoke().GNQ_SHAPES
    assert {s[2] for s in sites} == {64, 32, 16}


def _es(dtype):
    return torch.empty((), dtype=dtype).element_size()


def _check(shape, dtype, plan: GNQPlan, stats: bool, sms: int = SMS, groups: int = 32):
    b, c = shape[:2]
    hw = math.prod(shape[2:])
    es = _es(dtype)
    if plan.route == "group":   # gn_stats: a CTA a group of whole 16-byte vectors
        assert stats and plan.ctas == plan.tiles == b * groups and plan.cs == 0
        assert plan.pixels == c // groups * hw and plan.pixels % (16 // es) == 0
        assert plan.threads == GNQ_GROUP_THREADS
        return
    assert plan.cs in ((8, 16) if stats else (8, 16, 32)) and plan.threads in (128, 256)
    tpr = plan.threads // plan.cs
    assert 4 <= tpr <= 32 and 32 % tpr == 0        # a channel row's lanes are in one warp
    assert plan.pixels % (16 // es) == 0 and plan.ranges == -(-hw // plan.pixels)
    assert plan.tiles == b * -(-c // plan.cs) * plan.ranges
    assert plan.smem_bytes == gnq_smem_bytes(stats, plan.cs, plan.pixels, es) <= GN_MAX_SMEM
    # the cooperative launch: every CTA resident at once
    assert 1 <= plan.ctas <= min(plan.tiles, sms * gnq_blocks_per_sm(plan.threads,
                                                                     plan.smem_bytes))
    assert plan.route in (("general",) if stats else ("streaming", "general"))
    if plan.route == "streaming":
        assert (hw * es) % 16 == 0 and plan.pixels % (16 // es) == 0 and c % 8 == 0


def _cover(shape, plan: GNQPlan, groups: int = 32):
    """How often the plan's tiles (walked by its CTAs as csrc/gn_q.cu walks
    them; the group route: CTA b * G + g group g of sample b) take each
    element of x."""
    b, c = shape[:2]
    hw = math.prod(shape[2:])
    seen = np.zeros((b, c, hw), np.int8)
    if plan.route == "group":
        flat = seen.reshape(b * groups, -1)
        for cta in range(plan.ctas):
            flat[cta, :plan.pixels] += 1
        return seen
    slices = -(-c // plan.cs)
    for cta in range(plan.ctas):
        for t in range(cta, plan.tiles, plan.ctas):
            bs, pr = divmod(t, plan.ranges)
            bi, s = divmod(bs, slices)
            seen[bi, s * plan.cs:(s + 1) * plan.cs, pr * plan.pixels:(pr + 1) * plan.pixels] += 1
    return seen


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_plan_at_every_int8_site(dtype):
    """Each site takes the streaming route in slices of 32 channels (a
    pixel's codes one 32-byte sector) within 227 KB of shared memory a CTA,
    its CTAs resident at once (one wave), one tile a CTA but at the 640- and
    960-channel 64^2 sites in 16-bit types (21 and 31.5 MB of x) and at the
    widest sites in f32; every variant of the site takes the streaming
    route. gn_stats takes the group route everywhere, one CTA a group (128
    CTAs)."""
    for site in int8_gn_sites():
        plan = gnq_plan(site, dtype, 32)
        _check(site, dtype, plan, False)
        assert plan.route == "streaming" and plan.cs == 32, (site, plan)
        assert plan.ctas >= SMS or plan.ctas == plan.tiles, (site, plan)
        if dtype != torch.float32:
            assert (plan.tiles_per_cta > 1) == (site in ((4, 640, 64, 64), (4, 960, 64, 64)))
        assert {p.route for p in gnq_variants(site, dtype, 32)} == {"streaming"}
        st = gnq_plan(site, dtype, 32, stats=True)
        _check(site, dtype, st, True)
        assert (st.route, st.ctas) == ("group", 128)


@pytest.mark.parametrize("shape", sorted(set(int8_gn_sites()), key=lambda s: (-s[2], s[1])))
def test_tiles_cover_every_element_once(shape):
    for stats in (False, True):
        plan = gnq_plan(shape, torch.bfloat16, 32, stats=stats)
        assert (_cover(shape, plan) == 1).all()


@pytest.mark.parametrize("shape,groups", ODD + [((4, 4, 64, 64), 4), ((2, 64, 16, 16), 32)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_odd_shapes_take_the_general_route(shape, groups, dtype):
    """Rows that are not 16-byte runs, C % 8 != 0 for the codes (conv_in's 4
    channels in 4 groups), and an x that starts off a 16-byte boundary;
    gn_stats' group route (one CTA a group) needs only whole vectors in a
    group."""
    hw = math.prod(shape[2:])
    es = _es(dtype)
    aligned_rows = (hw * es) % 16 == 0
    for stats in (False, True):
        for aligned in (True, False):
            plan = gnq_plan(shape, dtype, groups, stats=stats, aligned=aligned)
            _check(shape, dtype, plan, stats, groups=groups)
            if stats and aligned and (shape[1] // groups * hw) % (16 // es) == 0:
                assert plan.route == "group", (shape, plan)
            else:
                vec = aligned and aligned_rows and not stats and shape[1] % 8 == 0
                assert (plan.route != "general") == vec, (shape, stats, aligned, plan)
                assert plan.cs == gnq_slice(shape[1], stats)
            assert (_cover(shape, plan, groups) == 1).all()


@pytest.mark.parametrize("shape", [(4, 320, 64, 64), (4, 960, 64, 64), (4, 1280, 16, 16),
                                   (4, 640, 32, 32)])
def test_variants_cover_every_element_once(shape):
    """chip_smoke.py's gnq_sweep plans: every slice width, each thread count
    and tile length, every route that applies (gn_stats: the cooperative
    kernel's general route and the group route); the plan is one of them."""
    routes = set()
    for stats in (False, True):
        for cs in ((8, 16) if stats else (8, 16, 32)):
            for plan in gnq_variants(shape, torch.bfloat16, 32, stats=stats, cs=cs):
                _check(shape, torch.bfloat16, plan, stats)
                routes.add(plan.route)
                if shape[2] <= 32 or plan.pixels >= 1024:
                    assert (_cover(shape, plan) == 1).all()
        assert gnq_plan(shape, torch.bfloat16, 32, stats=stats) in gnq_variants(
            shape, torch.bfloat16, 32, stats=stats)
    assert routes == {"streaming", "general", "group"}


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        gnq_plan((2, 64, 4, 4), torch.int8, 32)
    with pytest.raises(TypeError):
        gnq_plan((2, 64, 4, 4), torch.float64, 32, stats=True)
    with pytest.raises(ValueError):
        gnq_plan((2, 30, 4, 4), torch.bfloat16, 32)      # 32 groups do not divide 30
    with pytest.raises(ValueError):
        gnq_plan((0, 64, 4, 4), torch.bfloat16, 32)
    with pytest.raises(ValueError):
        gnq_plan((2, 64, 0), torch.bfloat16, 32, stats=True)


def test_wrappers_count_launches_by_route():
    assert set(gn_silu_q.launches_by_route) == {"streaming", "general"}
    assert set(gn_stats.launches_by_route) == {"group", "general"}


# ---- the blocked model against vdtpu's Pallas kernels (interpret mode) ----

# GroupNorm sums in another order: a code may differ by one where y / s lies
# within f32 rounding of a half-integer; at most 1 in 1000, never by 2
# (tests/test_torch_kernels.py::_codes_agree)
def _codes_agree(ours, theirs, max_frac=1e-3):
    diff = np.abs(ours.astype(np.int32) - theirs.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= max_frac, (diff.max(), (diff > 0).mean())


def _inputs(shape, seed):
    rs = np.random.RandomState(seed)
    c = shape[1]
    x = (rs.randn(*shape) * 2 + 0.3).astype(np.float32)
    return x, (rs.rand(c) + 0.5).astype(np.float32), (rs.randn(c) * 0.1).astype(np.float32)


def _nhwc(x):
    """[B, C, *spatial] -> vdtpu's flat channel-last [B, N, C]."""
    return jnp.asarray(np.moveaxis(x, 1, -1).reshape(x.shape[0], -1, x.shape[1]))


def _plans(shape, stats=False):
    """The plan and a cooperative variant of several pixel ranges (gn_silu_q's
    streaming route; gn_stats' cooperative general route beside its group
    plan), or the general plan."""
    plan = gnq_plan(shape, torch.float32, 32, stats=stats)
    if plan.route == "general":
        return [plan]
    others = [p for p in gnq_variants(shape, torch.float32, 32, stats=stats)
              if p.route != "group" and p.ranges > 1]
    return [plan, min(others, key=lambda p: p.pixels)]


@pytest.mark.parametrize("shape", [(2, 64, 16, 16), (2, 96, 7, 9)])
@pytest.mark.parametrize("with_silu", [True, False])
def test_blocked_model_matches_jax_whole_slab(shape, with_silu):
    x, w, b = _inputs(shape, sum(shape))
    s = np.float32(0.02)
    ref = np.asarray(jgn.gn_silu_q(_nhwc(x), jnp.asarray(w), jnp.asarray(b), jnp.asarray(s),
                                   32, 1e-5, with_silu, interpret=True))
    plain = gn_silu_q_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                            torch.tensor(s), 32, 1e-5, with_silu)
    for plan in _plans(shape):
        out = gnq_blocked_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                                torch.tensor(s), 32, 1e-5, with_silu, plan)
        assert out.dtype == torch.int8 and out.shape == (shape[0],) + shape[2:] + (shape[1],)
        _codes_agree(out.reshape(shape[0], -1, shape[1]).numpy(), ref)
        _codes_agree(out.numpy(), plain.numpy())


def test_blocked_model_matches_jax_blocked():
    """``_gn_silu_q_blocked`` (its two passes at N % 512 == 0), on both
    vector routes' geometries."""
    shape = (2, 64, 32, 32)
    x, w, b = _inputs(shape, 7)
    s = np.float32(0.03)
    ref = np.asarray(jgn._gn_silu_q_blocked(_nhwc(x), jnp.asarray(w), jnp.asarray(b),
                                            jnp.asarray(s), 32, 1e-5, True, True))
    for plan in _plans(shape):
        out = gnq_blocked_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                                torch.tensor(s), 32, 1e-5, True, plan)
        _codes_agree(out.reshape(2, -1, 64).numpy(), ref)


@pytest.mark.parametrize("shape", [(2, 128, 16, 16), (2, 256, 8, 16)])
def test_blocked_model_statistics_match_jax(shape):
    """``gn_stats`` (C % 128 == 0, as vdtpu's kernel needs) on the plan (one
    CTA a group) and a cooperative variant of several ranges; 1e-5."""
    x, _, _ = _inputs(shape, shape[1])
    ref = np.asarray(jgn.gn_stats(_nhwc(x), 32, 1e-5, interpret=True))
    plans = _plans(shape, stats=True)
    assert [p.route for p in plans] == ["group", "general"]
    for plan in plans:
        out = gnq_blocked_plain(torch.from_numpy(x), None, None, None, 32, 1e-5, False, plan,
                                stats=True)
        assert out.shape == (shape[0], 2, shape[1])
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(out.numpy(), gn_stats_plain(torch.from_numpy(x)).numpy(),
                                   atol=1e-5, rtol=1e-5)


def test_blocked_model_statistics_general_route():
    """The general route's element order, against the plain statistics."""
    shape, groups = (2, 40, 5, 3), 8
    x, _, _ = _inputs(shape, 3)
    plan = gnq_plan(shape, torch.float32, groups, stats=True)
    assert plan.route == "general" and plan.cs == 8    # groups of 75 elements: not vectors
    out = gnq_blocked_plain(torch.from_numpy(x), None, None, None, groups, 1e-5, False, plan,
                            stats=True)
    np.testing.assert_allclose(out.numpy(), gn_stats_plain(torch.from_numpy(x), groups).numpy(),
                               atol=1e-5, rtol=1e-5)
