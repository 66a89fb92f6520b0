"""Card-only tests of the port's kernels (marker ``gpu``).

They skip where no CUDA card is present. On the machine with the card,
which has no JAX, run them without the JAX-side conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Each kernel is held against its plain version on the same CUDA inputs at
shapes the main path does not cover: ragged lengths, head widths that need
the kernel's unaligned load path, strided views, other dtypes.
"""
import math

import pytest
import torch

from vdtpu_torch.ops.flash import flash_attention, flash_attention_plain
from vdtpu_torch.ops.gn_silu import gn_silu, gn_silu_plain

pytestmark = pytest.mark.gpu

# two bf16 ulps at the output's magnitude (both sides read the same bf16
# inputs; they differ in f32 summation order and in where they round)
ATOL, RTOL = 1e-2, 1.6e-2
# relative L2 error of the no-max forward against its plain version: sound
# kernels read about 2e-4 at [4, 4096, 8, 40]; leaving out one 128-key tile
# of 4096 reads about 0.18, which the band above lets through where the
# output is ~0.03
ATTN_MAX_REL_L2 = 1e-2


def _rel_l2(out, ref):
    return float((out.float() - ref.float()).norm() / ref.float().norm())


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, dtype=torch.bfloat16):
    return torch.randn(shape, device="cuda", generator=gen).to(dtype)


def _expect_path(d):
    """attn_fwd_plan's path for contiguous (16-byte aligned) q, k, v."""
    return "wgmma" if d % 8 == 0 and d <= 80 else "mma"


def _one_launch(fn, path, call):
    """call() launches fn's kernel once, on ``path``; returns its result."""
    before, by_path = fn.launches, dict(fn.launches_by_path)
    out = call()
    assert fn.launches == before + 1
    assert fn.launches_by_path[path] == by_path[path] + 1, (path, fn.launches_by_path)
    return out


@pytest.mark.parametrize("b,n,m,h,d", [
    (2, 100, 300, 3, 8),
    (1, 257, 1023, 2, 36),     # d % 8 != 0: the unaligned (scalar-load) path
    (2, 128, 128, 2, 256),     # widest head the kernel takes
    (1, 64, 65, 1, 72),
    (2, 1024, 77, 8, 40),      # a cross-attention shape, ragged kv
    (4, 4096, 4096, 8, 40),    # the main path's 64^2 sites
    (4, 1024, 1024, 8, 80),    # the 32^2 sites
    (4, 1024, 1024, 8, 40),    # the 64^2 sites under ToMe 0.75 (queries merged too)
    (2, 4096, 4096, 8, 40),    # the 64^2 sites at half batch (outside the cfg interval)
    (2, 1024, 1024, 8, 80),    # the 32^2 sites at half batch
    (2, 2100, 300, 2, 40),     # 192-row blocks, the last one ragged
    (1, 1000, 1000, 2, 80),    # ragged last query block and key tile on wgmma
    (1, 300, 129, 2, 96),      # a head over 80: mma.sync
])
def test_flash_kernel_matches_plain(gen, b, n, m, h, d):
    q, k, v = _randn(gen, b, n, h, d), _randn(gen, b, m, h, d), _randn(gen, b, m, h, d)
    out = _one_launch(flash_attention, _expect_path(d), lambda: flash_attention(q, k, v))
    torch.testing.assert_close(out.float(), flash_attention_plain(q, k, v).float(),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("b,n,m,h,d", [
    (4, 4096, 1028, 8, 40),    # a four-image mcg request's 64^2 cross-attentions
    (4, 1024, 1028, 8, 80),    # its 32^2 ones
    (4, 256, 1028, 8, 160),    # its 16^2 ones: mma.sync
])
def test_flash_kernel_at_the_mcg_cross_attention_shapes(gen, b, n, m, h, d):
    """1028 keys: the last key tile holds 4 keys, the rest must not count."""
    q, k, v = _randn(gen, b, n, h, d), _randn(gen, b, m, h, d), _randn(gen, b, m, h, d)
    out = _one_launch(flash_attention, _expect_path(d), lambda: flash_attention(q, k, v))
    ref = flash_attention_plain(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL, rtol=RTOL)
    assert _rel_l2(out, ref) <= ATTN_MAX_REL_L2


def test_flash_kernel_reads_strided_views(gen):
    """q, k, v as views of one packed [B, N, 3, H, D] projection, and a
    misaligned start (one element in), which takes the unaligned path."""
    b, n, h, d = 2, 300, 4, 40
    qkv = _randn(gen, b, n, 3, h, d)
    q, k, v = qkv.unbind(dim=2)
    out = _one_launch(flash_attention, "wgmma", lambda: flash_attention(q, k, v))
    torch.testing.assert_close(out.float(), flash_attention_plain(q, k, v).float(), atol=ATOL,
                               rtol=RTOL)
    flat = _randn(gen, b * n * h * d + 1)
    qm = flat[1:].view(b, n, h, d)
    out = _one_launch(flash_attention, "mma", lambda: flash_attention(qm, k, v))
    torch.testing.assert_close(out.float(), flash_attention_plain(qm, k, v).float(), atol=ATOL,
                               rtol=RTOL)
    # q, k, v as [B, N, H, D] views of packed [B, N, H*D] projections
    pk = _randn(gen, b, n, 3 * h * d)
    q, k, v = (t.view(b, n, h, d) for t in pk.split(h * d, dim=-1))
    out = _one_launch(flash_attention, "wgmma", lambda: flash_attention(q, k, v))
    torch.testing.assert_close(out.float(), flash_attention_plain(q, k, v).float(), atol=ATOL,
                               rtol=RTOL)


def test_flash_kernel_refuses(gen):
    q = _randn(gen, 1, 64, 1, 40, dtype=torch.float32)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)
    q = _randn(gen, 1, 64, 1, 264)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)


@pytest.mark.parametrize("source", ["flash_fwd", "nomax_fwd"])
def test_attn_fwd_refuses_a_plan_it_does_not_mirror(gen, source):
    """The C entry points recompute the plan (vdattn::plan_code) and refuse
    a call whose plan code is not theirs, with cudaErrorInvalidValue and no
    launch: the wgmma code on a view one element in, the mma.sync codes on
    an aligned d 40 call."""
    from vdtpu_torch.ops.flash import _plan_for
    from vdtpu_torch.ops.kernels.build import load
    b, n, h, d = 1, 256, 2, 40
    flat = _randn(gen, b * n * h * d + 8)
    aligned, shifted = flat[:-8].view(b, n, h, d), flat[1:-7].view(b, n, h, d)
    wg_code = _plan_for(aligned, aligned, aligned).code
    assert _plan_for(aligned, aligned, aligned).path == "wgmma"
    assert _plan_for(shifted, aligned, aligned).path == "mma"
    out = torch.zeros(b, n, h, d, device="cuda", dtype=torch.bfloat16)
    shift = torch.zeros(h, device="cuda")
    lib = load(source)
    for q, code in ((shifted, wg_code), (aligned, 0), (aligned, 1)):
        st = [x for t in (q, aligned, aligned, out) for x in t.stride()[:3]]
        head = [q.data_ptr(), aligned.data_ptr(), aligned.data_ptr(), out.data_ptr()]
        if source == "flash_fwd":
            rc = lib.vd_flash_fwd(*head, None, b, n, n, h, d, *st, d ** -0.5, code,
                                  torch.cuda.current_stream().cuda_stream)
        else:
            rc = lib.vd_nomax_fwd(*head, shift.data_ptr(), 0, b, n, n, h, d, *st, d ** -0.5,
                                  code, torch.cuda.current_stream().cuda_stream)
        assert rc == 1, (code, rc)   # cudaErrorInvalidValue
    torch.cuda.synchronize()
    assert not bool(out.any())


# (shape, groups, the plan's (route, cluster) in bf16): the flat layout
# (odd maps, pixel counts that are no multiple of 16, the text diffuser's
# [8, F, 1] and [8, C, 4] sites, one-element groups), the rows layout at one
# CTA a band (the UNet's maps; 24 pixels a row), resident clusters of 2 and 8
# (the VAE's 64^2 and 128^2 maps at batch 1), streaming at one CTA a band
# (the UNet's 960-channel 64^2 site), clusters of 2 (the VAE's maps from
# 128^2 at batch 2) and 16 (its 256^2 and 512^2 maps at batch 1): every
# (route, cluster) the plan gives the flows' sites
GN_CASES = [((2, 96, 7, 9), 32, ("resident", 1)), ((3, 320, 33, 17), 32, ("resident", 1)),
            ((1, 64, 1, 1), 32, ("resident", 1)), ((2, 256, 4), 8, ("resident", 1)),
            ((8, 1280, 1), 32, ("resident", 1)), ((8, 320, 4), 32, ("resident", 1)),
            ((2, 64, 3, 8), 32, ("resident", 1)), ((4, 320, 64, 64), 32, ("resident", 1)),
            ((4, 2560, 8, 8), 32, ("resident", 1)), ((1, 512, 64, 64), 32, ("resident", 2)),
            ((1, 512, 128, 128), 32, ("resident", 8)),
            ((4, 960, 64, 64), 32, ("streaming", 1)),
            ((2, 512, 128, 128), 32, ("streaming", 2)),
            ((2, 128, 512, 512), 32, ("streaming", 2)),
            ((1, 256, 256, 256), 32, ("streaming", 16)),
            ((1, 128, 512, 512), 32, ("streaming", 16)),
            # the UNet's maps at half batch (the steps outside the cfg interval)
            ((2, 320, 64, 64), 32, ("resident", 2)), ((2, 960, 64, 64), 32, ("resident", 2)),
            ((2, 640, 32, 32), 32, ("resident", 2)), ((2, 1280, 16, 16), 32, ("resident", 1)),
            ((2, 2560, 8, 8), 32, ("resident", 1))]


@pytest.mark.parametrize("shape,groups,want", GN_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("with_silu", [True, False])
def test_gn_kernel_matches_plain(gen, shape, groups, want, dtype, with_silu):
    """One launch a call on gn_plan's route, within the tolerance of its
    plain version, the same bits run to run (the cluster's combine has a
    fixed order)."""
    from vdtpu_torch.ops.gn_silu import gn_plan
    c = shape[1]
    x = (_randn(gen, *shape, dtype=torch.float32) * 2 + 0.5).to(dtype)
    w = (torch.rand(c, device="cuda", generator=gen) + 0.5).to(dtype)
    bias = _randn(gen, c, dtype=dtype)
    plan = gn_plan(tuple(shape), dtype, groups)
    if dtype == torch.bfloat16:
        assert (plan.route, plan.cluster) == want, plan
    out = _one_launch(gn_silu, plan.route, lambda: gn_silu(x, w, bias, groups, 1e-5, with_silu))
    ref = gn_silu_plain(x, w, bias, groups, 1e-5, with_silu)
    atol, rtol = (1e-5, 1e-5) if dtype == torch.float32 else (ATOL, RTOL)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    assert torch.equal(out, gn_silu(x, w, bias, groups, 1e-5, with_silu))


@pytest.mark.parametrize("route", ["resident", "streaming"])
def test_gn_kernel_routes_agree(gen, route):
    """Both routes at one shape (gn_variant, gn_launch_plan) against the
    plain version: the streaming route at a map the plan keeps resident."""
    from vdtpu_torch.ops.gn_silu import _gn_out, gn_launch_plan, gn_variant
    x = _randn(gen, 4, 640, 32, 32) * 2 + 0.5
    w = torch.rand(640, device="cuda", generator=gen).to(torch.bfloat16) + 0.5
    bias = _randn(gen, 640)
    plan = gn_variant(tuple(x.shape), x.dtype, 32, route, 2)
    out = _gn_out(x)
    gn_launch_plan(x, w, bias, out, 32, 1e-5, True, plan)
    torch.testing.assert_close(out.float(), gn_silu_plain(x, w, bias).float(), atol=ATOL,
                               rtol=RTOL)


def test_gn_kernel_takes_a_misaligned_start(gen):
    """x starting 2 bytes past a 16-byte boundary: the flat layout, y at the
    same address modulo 16."""
    base = _randn(gen, 2 * 64 * 8 * 8 + 1)
    x = base[1:].view(2, 64, 8, 8)
    assert x.data_ptr() % 16 == 2
    w = torch.ones(64, device="cuda", dtype=torch.bfloat16)
    out = gn_silu(x, w, w * 0.1)
    assert out.data_ptr() % 16 == 2
    torch.testing.assert_close(out.float(), gn_silu_plain(x, w, w * 0.1).float(), atol=ATOL,
                               rtol=RTOL)


def test_gn_kernel_refuses_non_contiguous(gen):
    x = _randn(gen, 2, 64, 8, 8).transpose(2, 3)
    w = torch.ones(64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        gn_silu(x, w, w)


def test_tiny_t2i_on_the_card_goes_through_both_kernels(gen):
    """The tiny system in bf16 on the card: its 32^2 latent gives 1024-token
    self-attention sites (d_head 8), so both kernels run; the eps call
    agrees with the same weights in f32 on the CPU."""
    from vdtpu_torch.serving.api import VDInference, VDSystem
    cuda_sys = VDSystem("vd_test_tiny", dtype=torch.bfloat16, device="cuda").init_random(0)
    with torch.no_grad():  # zero output convs would make eps identically 0
        for p in cuda_sys.net.parameters():
            if not bool(p.any()):
                p.copy_(torch.randn(p.shape, device="cuda", generator=gen) * 0.02)
    cpu_sys = VDSystem("vd_test_tiny", device="cpu")
    cpu_sys.load_state_dict({k: v.float().cpu() for k, v in cuda_sys.net.state_dict().items()})
    tok = lambda texts: torch.arange(16).repeat(len(texts), 1).numpy() + 1
    vdi = VDInference(cuda_sys, text_tokenizer=tok, output_dim=(64, 64), ddim_steps=4,
                      latent_downsample=2)
    flash_attention.launches = gn_silu.launches = 0
    img = vdi.inference_t2i("x", seed=0)
    assert tuple(img.shape) == (2, 64, 64, 3) and bool(torch.isfinite(img).all())
    assert flash_attention.launches > 0 and gn_silu.launches > 0
    x = _randn(gen, 2, 4, 32, 32)   # two contexts of 16 tokens: torch._int_mm wants > 16 rows
    t = torch.tensor([500, 500], device="cuda")
    ctx = cuda_sys.ctx_encode(tok(["x", "y"]), "text")
    with torch.no_grad():
        a = cuda_sys.model.apply_model(x, t, ctx, "image", "text").float().cpu().flatten()
        b = cpu_sys.model.apply_model(x.float().cpu(), t.cpu(), ctx.float().cpu(),
                                      "image", "text").flatten()
    assert float(a @ b / (a.norm() * b.norm())) > 0.995


def test_split_walk_on_the_card_equals_the_full_walk(gen):
    """The tiny system in bf16 through the kernels: the input half, then the
    mid and output walk from its cache, against one full walk (single- and
    multi-context); both run the same kernels on the same inputs."""
    from vdtpu_torch.serving.api import VDSystem
    system = VDSystem("vd_test_tiny", dtype=torch.bfloat16, device="cuda").init_random(0)
    with torch.no_grad():  # zero output convs would make eps identically 0
        for p in system.net.parameters():
            if not bool(p.any()):
                p.copy_(torch.randn(p.shape, device="cuda", generator=gen) * 0.02)
    m = system.model
    x, t = _randn(gen, 4, 4, 32, 32), torch.tensor([900, 900, 20, 20], device="cuda")
    ctxs = [_randn(gen, 4, 20, 96), _randn(gen, 4, 17, 96)]
    mc = ([0.3, 0.7], "image", ["text", "image"])
    flash_attention.launches = gn_silu.launches = 0
    with torch.no_grad():
        full = m.apply_model(x, t, ctxs[0], "image", "text")
        n_flash, n_gn = flash_attention.launches, gn_silu.launches
        split, _ = m.apply_model_encreuse(x, t, ctxs[0], "image", "text", None, False)
        assert (flash_attention.launches, gn_silu.launches) == (2 * n_flash, 2 * n_gn)
        mfull = m.apply_model_multicontext(x, t, ctxs, *mc)
        msplit, _ = m.apply_model_multicontext_encreuse(x, t, ctxs, *mc, None, False)
    assert n_flash > 0 and n_gn > 0
    assert _rel_l2(split, full) <= 1e-3 and _rel_l2(msplit, mfull) <= 1e-3


def test_full_width_multicontext_eps_bf16_matches_f32(gen):
    """One full-width multi-context eps call (text + image context,
    attention mixing) in bf16 on the card, through the kernels, against an
    f32 copy of the same diffusers on the CPU (the kernels take bf16 only),
    on the same contexts: chip_smoke.py's eps bound."""
    from vdtpu_torch.models.vd import VDModel
    from vdtpu_torch.serving.api import VDSystem
    system = VDSystem("vd_four_flow_v1-0", dtype=torch.bfloat16, device="cuda").init_random(0)
    with torch.no_grad():  # zero output convs would make eps identically 0
        for p in system.net.parameters():
            if not bool(p.any()):
                p.copy_(torch.randn(p.shape, device="cuda", generator=gen) * 0.02)
    with torch.device("meta"):
        cpu = VDModel.from_config(system.cfg)
    cpu.diffuser.to_empty(device="cpu")
    cpu.diffuser.load_state_dict({k: v.float().cpu()
                                  for k, v in system.model.diffuser.state_dict().items()})
    ids = torch.arange(77, device="cuda").view(1, 77) + 400
    ctxs = [system.ctx_encode(ids, "text"),
            system.ctx_encode(torch.rand((1, 512, 512, 3), device="cuda", generator=gen),
                              "image")]
    x = _randn(gen, 1, 4, 64, 64)
    t = torch.tensor([500], device="cuda")
    args = ([0.3, 0.7], "image", ["text", "image"])
    flash_attention.launches = 0
    with torch.no_grad():
        out = system.model.apply_model_multicontext(x, t, ctxs, *args).float().cpu()
        ref = cpu.diffuser.apply_flow_multicontext(
            x.float().cpu(), t.cpu(), [c.float().cpu() for c in ctxs], *args)
    assert flash_attention.launches == 20   # 10 long self-attention sites, two stacks
    a, b = out.flatten().double(), ref.flatten().double()
    assert float(a @ b / (a.norm() * b.norm())) >= 0.995
    assert float((a - b).norm() / b.norm()) <= 0.05


# ---- int8 serving kernels: no-max attention, GN+SiLU+int8, int8 3x3 conv ----

def _nomax_args(gen, b, n, m, h, d):
    """q, k, v and the true per-head max scaled logit (the calibrated shift)."""
    q, k, v = _randn(gen, b, n, h, d), _randn(gen, b, m, h, d), _randn(gen, b, m, h, d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
    return q, k, v, s.amax(dim=(0, 2, 3))


@pytest.mark.parametrize("b,n,m,h,d", [
    (2, 100, 300, 3, 8),
    (1, 257, 1023, 2, 36),     # d % 8 != 0 (the TPU's _nomax_kernel case), ragged kv
    (2, 128, 77, 2, 80),       # kv shorter than one tile
    (1, 64, 65, 1, 160),
    (4, 4096, 4096, 8, 40),    # the int8 path's 64^2 sites
    (4, 1024, 1024, 8, 80),    # its 32^2 sites
    (4, 1024, 1024, 8, 40),    # the 64^2 sites under ToMe 0.75 (queries merged too)
    (2, 2100, 300, 2, 40),     # 192-row blocks, the last one ragged
    (1, 1000, 1000, 2, 80),    # ragged last query block and key tile on wgmma
])
def test_nomax_kernel_matches_plain(gen, b, n, m, h, d):
    from vdtpu_torch.ops.nomax import flash_attention_nomax, flash_attention_nomax_plain
    q, k, v, shift = _nomax_args(gen, b, n, m, h, d)
    out = _one_launch(flash_attention_nomax, _expect_path(d),
                      lambda: flash_attention_nomax(q, k, v, shift))
    ref = flash_attention_nomax_plain(q, k, v, shift)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL, rtol=RTOL)
    assert _rel_l2(out, ref) <= ATTN_MAX_REL_L2
    # a float shift (one bound for every head) is the same function
    hi = float(shift.max())
    out, ref = flash_attention_nomax(q, k, v, hi), flash_attention_nomax_plain(q, k, v, hi)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL, rtol=RTOL)
    assert _rel_l2(out, ref) <= ATTN_MAX_REL_L2


def test_nomax_kernel_reads_packed_views(gen):
    """q, k, v as [B, N, H, D] views of packed [B, N, H*D] projections (the
    TPU's _nomax_packed_kernel layout) and of one [B, N, 3, H, D] tensor."""
    from vdtpu_torch.ops.nomax import flash_attention_nomax, flash_attention_nomax_plain
    b, n, h, d = 2, 300, 4, 40
    qkv = _randn(gen, b, n, 3 * h * d)
    q, k, v = (t.view(b, n, h, d) for t in qkv.split(h * d, dim=-1))
    shift = torch.full((h,), 6.0, device="cuda")
    out = _one_launch(flash_attention_nomax, "wgmma",
                      lambda: flash_attention_nomax(q, k, v, shift))
    torch.testing.assert_close(out.float(), flash_attention_nomax_plain(q, k, v, shift).float(),
                               atol=ATOL, rtol=RTOL)
    q, k, v = _randn(gen, b, n, 3, h, d).unbind(dim=2)
    out = _one_launch(flash_attention_nomax, "wgmma",
                      lambda: flash_attention_nomax(q, k, v, shift))
    torch.testing.assert_close(out.float(), flash_attention_nomax_plain(q, k, v, shift).float(),
                               atol=ATOL, rtol=RTOL)
    qm = _randn(gen, b * n * h * d + 1)[1:].view(b, n, h, d)
    out = _one_launch(flash_attention_nomax, "mma",
                      lambda: flash_attention_nomax(qm, k, v, shift))
    torch.testing.assert_close(out.float(), flash_attention_nomax_plain(qm, k, v, shift).float(),
                               atol=ATOL, rtol=RTOL)


def test_nomax_kernel_refuses(gen):
    from vdtpu_torch.ops.nomax import flash_attention_nomax
    q = _randn(gen, 1, 64, 2, 40, dtype=torch.float32)
    with pytest.raises(TypeError):
        flash_attention_nomax(q, q, q, 1.0)
    q = _randn(gen, 1, 64, 40, 2).transpose(2, 3)  # head axis not contiguous
    with pytest.raises(ValueError):
        flash_attention_nomax(q, q, q, 1.0)
    q = _randn(gen, 1, 64, 2, 40)
    with pytest.raises(ValueError):
        flash_attention_nomax(q, q, q, torch.ones(3, device="cuda"))


# GN+SiLU+int8: both sides compute f32 statistics in another summation
# order and the kernel's SiLU is y / (1 + exp(-y)) against y * sigmoid(y),
# so a code can differ by one where y / s lies within an f32 rounding of a
# half-integer: at most 1 in 1000 codes, never by more than one
MAX_OFF_BY_ONE = 1e-3


def _codes_agree(a, b):
    diff = (a.int() - b.int()).abs()
    assert int(diff.max()) <= 1
    assert float((diff > 0).float().mean()) <= MAX_OFF_BY_ONE


def _one_route(fn, route, call):
    """call() launches fn's kernel once, on ``route`` (launches_by_route)."""
    before, by = fn.launches, dict(fn.launches_by_route)
    out = call()
    assert fn.launches == before + 1
    assert fn.launches_by_route[route] == by[route] + 1, (route, fn.launches_by_route)
    return out


# (shape, groups, gn_silu_q's route, gn_stats' route): rows that are not
# 16-byte runs, one pixel a channel and C % 16 != 0 (the general route; at
# C % 32 == 0 with whole 32-byte code runs stored by lane pairs around an odd
# last pixel); slices of 32, 16 and 8 channels (gn_stats one CTA a group);
# C % 8 != 0 (masked code bytes); the 960-channel 64^2 UNet site (two tiles a
# CTA). Every other geometry is held in
# test_gn_int8_kernels_every_variant_matches_plain.
GNQ_CASES = [((2, 96, 7, 9), 32, "general", "general"),
             ((3, 320, 33, 17), 32, "general", "general"),
             ((1, 64, 1, 1), 32, "general", "general"),
             ((2, 40, 5, 3), 8, "general", "general"),
             ((2, 64, 16, 16), 32, "streaming", "group"),
             ((2, 48, 16, 16), 16, "streaming", "group"),
             ((2, 40, 16, 16), 8, "streaming", "group"),
             ((2, 4, 16, 16), 4, "general", "group"),
             ((4, 960, 64, 64), 32, "streaming", "group")]


@pytest.mark.parametrize("shape,groups,route,stats_route", GNQ_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_gn_int8_kernels_match_plain(gen, shape, groups, route, stats_route, dtype):
    from vdtpu_torch.ops.gn_silu import (gn_silu_q, gn_silu_q_plain, gn_stats, gn_stats_plain,
                                         gnq_plan, gnq_slice)
    c = shape[1]
    for stats in (False, True):
        plan = gnq_plan(shape, dtype, groups, torch.cuda.get_device_properties(0)
                        .multi_processor_count, stats)
        assert plan.route == (stats_route if stats else route)
        assert plan.cs == (0 if plan.route == "group" else gnq_slice(c, stats))
    x = (_randn(gen, *shape, dtype=torch.float32) * 2 + 0.5).to(dtype)
    w = (torch.rand(c, device="cuda", generator=gen) + 0.5).to(dtype)
    bias = _randn(gen, c, dtype=dtype)
    st = _one_route(gn_stats, stats_route, lambda: gn_stats(x, groups, 1e-5))
    torch.testing.assert_close(st, gn_stats_plain(x, groups, 1e-5), atol=1e-5, rtol=1e-5)
    assert torch.equal(st, gn_stats(x, groups, 1e-5))     # fixed-order sums: the same bits
    s = torch.tensor(0.02, device="cuda")
    for silu in (True, False):
        q = _one_route(gn_silu_q, route, lambda: gn_silu_q(x, w, bias, s, groups, 1e-5, silu))
        assert q.dtype == torch.int8 and q.shape == (shape[0],) + shape[2:] + (c,)
        _codes_agree(q, gn_silu_q_plain(x, w, bias, s, groups, 1e-5, silu))
        assert torch.equal(q, gn_silu_q(x, w, bias, s, groups, 1e-5, silu))


@pytest.mark.parametrize("shape,groups", [((2, 64, 16, 16), 32), ((2, 40, 16, 16), 8),
                                          ((2, 96, 7, 9), 32)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gn_int8_kernels_every_variant_matches_plain(gen, shape, groups, dtype):
    """Every plan gnq_variants gives (each route, slice width, thread count
    and tile length; gn_stats' cooperative general route and its group
    route), each launched through gnq_launch_plan, against the plain
    versions, and the same bits twice."""
    from vdtpu_torch.ops.gn_silu import (gn_silu_q_plain, gn_stats_plain, gnq_launch_plan,
                                         gnq_variants)
    c = shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    x = (_randn(gen, *shape, dtype=torch.float32) * 2 + 0.5).to(dtype)
    w = (torch.rand(c, device="cuda", generator=gen) + 0.5).to(dtype)
    bias = _randn(gen, c, dtype=dtype)
    s = torch.tensor(0.02, device="cuda")
    ref_q, ref_st = gn_silu_q_plain(x, w, bias, s, groups), gn_stats_plain(x, groups)
    seen = set()
    for stats in (False, True):
        plans = {p for cs in ((16, 8) if stats else (32, 16, 8)) if c % cs == 0 or cs == 8
                 for p in gnq_variants(shape, dtype, groups, sms, stats, cs=cs)}
        for plan in sorted(plans, key=str):
            seen.add(plan.route)
            outs = []
            for _ in range(2):
                out = torch.empty_like(ref_st if stats else ref_q)
                gnq_launch_plan(x, out, plan, groups, 1e-5, *(() if stats else (w, bias, s)))
                outs.append(out)
            if stats:
                torch.testing.assert_close(outs[0], ref_st, atol=1e-5, rtol=1e-5)
            else:
                _codes_agree(outs[0], ref_q)
            assert torch.equal(outs[0], outs[1]), plan
    assert seen == ({"general"} if shape[2] == 7 else {"streaming", "general", "group"})


def test_gn_int8_kernels_take_a_misaligned_start(gen):
    """x one element into its buffer: the general route, same results."""
    from vdtpu_torch.ops.gn_silu import gn_silu_q, gn_silu_q_plain, gn_stats, gn_stats_plain
    shape = (2, 64, 16, 16)
    x = _randn(gen, math.prod(shape) + 1)[1:].view(shape)
    w = torch.rand(64, device="cuda", generator=gen) + 0.5
    bias = _randn(gen, 64, dtype=torch.float32)
    s = torch.tensor(0.02, device="cuda")
    st = _one_route(gn_stats, "general", lambda: gn_stats(x))
    torch.testing.assert_close(st, gn_stats_plain(x), atol=1e-5, rtol=1e-5)
    q = _one_route(gn_silu_q, "general", lambda: gn_silu_q(x, w, bias, s))
    _codes_agree(q, gn_silu_q_plain(x, w, bias, s))


def test_gn_int8_kernels_refuse_a_plan_they_do_not_derive(gen):
    """The C entry points recompute the plan: a tile count that is not
    theirs, more CTAs than tiles, and a gn_stats plan on the streaming route
    (a group of whole vectors takes the group kernel) come back as
    cudaError 1."""
    import dataclasses
    from vdtpu_torch.ops.gn_silu import gnq_launch_plan, gnq_variants
    x = _randn(gen, 2, 64, 16, 16)
    w = torch.ones(64, device="cuda", dtype=torch.bfloat16)
    s = torch.tensor(0.02, device="cuda")
    q = torch.empty((2, 16, 16, 64), dtype=torch.int8, device="cuda")
    st = torch.empty((2, 2, 64), device="cuda")
    plan = next(p for p in gnq_variants((2, 64, 16, 16), torch.bfloat16, 32)
                if p.route == "streaming")
    assert plan.ctas == plan.tiles > 1
    for bad in (dataclasses.replace(plan, tiles=plan.tiles + 1),
                dataclasses.replace(plan, ctas=plan.ctas + 1)):
        with pytest.raises(RuntimeError, match="cudaError 1 "):
            gnq_launch_plan(x, q, bad, 32, 1e-5, w, w, s)
    with pytest.raises(RuntimeError, match="cudaError 1 "):
        gnq_launch_plan(x, st, plan, 32, 1e-5)


def test_gn_int8_kernels_refuse(gen):
    from vdtpu_torch.ops.gn_silu import gn_silu_q, gn_stats
    x = _randn(gen, 2, 64, 8, 8)
    w = torch.ones(64, device="cuda", dtype=torch.bfloat16)
    s = torch.tensor(0.02, device="cuda")
    with pytest.raises(ValueError):
        gn_stats(x.transpose(2, 3))
    with pytest.raises(TypeError):
        gn_silu_q(x.to(torch.int32), w, w, s)
    with pytest.raises(ValueError):
        gn_silu_q(x, w, w, 0.02)  # the scale must be a tensor on the card


def _qconv_args(gen, b, c, h, w, n, dtype=torch.bfloat16):
    xq = torch.randint(-127, 128, (b, h, w, c), device="cuda", generator=gen).to(torch.int8)
    wq = torch.randint(-127, 128, (n, 3, 3, c), device="cuda", generator=gen).to(torch.int8)
    w_scale = torch.rand(n, device="cuda", generator=gen) * 1e-3 + 1e-4
    bias = _randn(gen, n, dtype=dtype)
    return xq, wq, w_scale, bias, torch.tensor(0.05, device="cuda")


# the s32 sums are exact on both sides and the f32 epilogue runs the same
# operations in the same order: one rounding of the output dtype apart
QC_TOL = {torch.bfloat16: dict(atol=1e-2, rtol=8e-3), torch.float32: dict(atol=1e-5, rtol=1e-5)}


def _path_launches(fn, plan, call):
    """Run call(); assert it launched once, on the path qconv3_plan chose."""
    before, by_path = fn.launches, dict(fn.launches_by_path)
    out = call()
    assert fn.launches == before + 1
    assert fn.launches_by_path[plan.path] == by_path[plan.path] + 1
    return out


@pytest.mark.parametrize("b,c,h,w,n,stride", [
    (2, 4, 16, 16, 64, 1),      # conv_in: C_in = 4 (the general path)
    (2, 64, 16, 16, 4, 1),      # the output conv: C_out = 4
    (2, 128, 16, 16, 128, 2),   # Downsample2D
    (1, 64, 12, 20, 72, 1),     # non-square map, N not a multiple of the tile
    (2, 40, 9, 7, 24, 2),       # C % 32 != 0: the general path
    (2, 64, 9, 7, 40, 1),       # odd H and W on the halo path
    (1, 96, 13, 11, 160, 2),    # odd, stride 2, 32-channel halo chunks
    (1, 1280, 16, 16, 1280, 1),  # 16^2 map at C = N = 1280: 8 rows a tile
    (1, 320, 64, 64, 320, 2),   # Downsample2D at 64^2 -> 32^2
    (4, 64, 64, 80, 160, 1),    # N = 160 on 160-channel blocks; Wo = 80, one row a tile
    (4, 96, 40, 80, 160, 1),    # the same with 32-channel halo chunks
    (4, 64, 64, 64, 640, 1),    # 256-pixel tiles (4 rows of 64)
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_qconv3_kernel_matches_plain(gen, b, c, h, w, n, stride, dtype):
    from vdtpu_torch.ops.qconv import qconv3, qconv3_plain, qconv3_plan
    xq, wq, w_scale, bias, s_x = _qconv_args(gen, b, c, h, w, n, dtype)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    film = _randn(gen, b, n, dtype=dtype)
    res = _randn(gen, b, n, ho, wo, dtype=dtype)
    plan = qconv3_plan(b, h, w, c, n, stride)
    assert plan.path == ("general" if c % 32 else "halo")
    for add_vec, add_full in ((None, None), (film, None), (None, res), (film, res)):
        out = _path_launches(qconv3, plan, lambda: qconv3(xq, wq, w_scale, bias, s_x, stride,
                                                          add_vec, add_full, dtype))
        assert out.shape == (b, n, ho, wo)
        ref = qconv3_plain(xq, wq, w_scale, bias, s_x, stride, add_vec, add_full, dtype)
        torch.testing.assert_close(out.float(), ref.float(), **QC_TOL[dtype])


@pytest.mark.parametrize("b,c,h,w,n,stride", [
    (2, 64, 16, 16, 64, 1), (1, 96, 10, 14, 40, 1), (2, 64, 16, 16, 64, 2),
    (2, 4, 16, 16, 64, 1),      # C = 4: the general path
    (2, 64, 9, 7, 4, 1),        # odd H and W, N = 4
    (1, 96, 13, 11, 160, 2),
    (1, 1280, 16, 16, 1280, 1),
    (1, 320, 64, 64, 320, 2),
    (4, 64, 64, 80, 160, 1),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_qconv3_gn_kernel_matches_plain(gen, b, c, h, w, n, stride, dtype):
    """The fused GN prologue, with a GN bias large enough that
    quantize(GN(0)) is far from 0: the image edge must stay 0 after
    quantization, as the plain version's zero padding of the codes has it."""
    from vdtpu_torch.ops.gn_silu import gn_stats
    from vdtpu_torch.ops.qconv import qconv3_gn, qconv3_gn_plain, qconv3_plan
    _, wq, w_scale, bias, s_x = _qconv_args(gen, b, c, h, w, n)
    x = (_randn(gen, b, c, h, w, dtype=torch.float32) * 2 + 0.5).to(dtype)
    gamma = torch.rand(c, device="cuda", generator=gen) + 0.5
    beta = torch.full((c,), 2.0, device="cuda")
    st = gn_stats(x, 32 if c % 32 == 0 else c, 1e-5)
    res = _randn(gen, b, n, (h - 1) // stride + 1, (w - 1) // stride + 1, dtype=dtype)
    film = _randn(gen, b, n, dtype=dtype)
    plan = qconv3_plan(b, h, w, c, n, stride, gn=True)
    out = _path_launches(qconv3_gn, plan, lambda: qconv3_gn(
        x, st, gamma, beta, s_x, wq, w_scale, bias, True, stride, film, res))
    ref = qconv3_gn_plain(x, st, gamma, beta, s_x, wq, w_scale, bias, True, stride, film, res)
    torch.testing.assert_close(out.float(), ref.float(), **QC_TOL[dtype])


def test_qconv3_kernel_refuses(gen):
    from vdtpu_torch.ops.qconv import qconv3
    xq, wq, w_scale, bias, s_x = _qconv_args(gen, 1, 64, 8, 8, 64)
    with pytest.raises(TypeError):
        qconv3(xq.float(), wq, w_scale, bias, s_x)
    with pytest.raises(ValueError):
        qconv3(xq, wq.transpose(1, 2), w_scale, bias, s_x)  # weights not contiguous
    with pytest.raises(ValueError):
        qconv3(xq, wq, w_scale, bias, s_x, stride=3)


def test_int_mm_takes_the_transposed_weight(gen):
    """int8_linear hands torch._int_mm the [N, K] table as a [K, N] view;
    a product of 16 rows or fewer runs on zero-padded rows, exactly."""
    from vdtpu_torch.ops.quant import int8_linear
    xq = torch.randint(-127, 128, (40, 64), device="cuda", generator=gen).to(torch.int8)
    wq = torch.randint(-127, 128, (48, 64), device="cuda", generator=gen).to(torch.int8)
    ws = torch.rand(48, device="cuda", generator=gen) * 1e-2
    s = torch.tensor(0.1, device="cuda")
    out = int8_linear(xq, wq, s, ws, out_dtype=torch.float32)
    ref = int8_linear(xq.cpu(), wq.cpu(), s.cpu(), ws.cpu(), out_dtype=torch.float32)
    torch.testing.assert_close(out.cpu(), ref, atol=0, rtol=0)
    small = int8_linear(xq[:16], wq, s, ws)  # torch._int_mm itself takes > 16 rows
    torch.testing.assert_close(small.cpu(), ref[:16], atol=0, rtol=0)


@pytest.mark.parametrize("rows", [1, 4, 16, 17])
def test_int_mm_pads_small_products(gen, rows):
    """The 0-D flows' [2n, F] products: exact against the CPU's int32."""
    from vdtpu_torch.ops.quant import int8_linear
    xq = torch.randint(-127, 128, (rows, 320), device="cuda", generator=gen).to(torch.int8)
    wq = torch.randint(-127, 128, (640, 320), device="cuda", generator=gen).to(torch.int8)
    ws = torch.rand(640, device="cuda", generator=gen) * 1e-2
    bias = torch.randn(640, device="cuda", generator=gen)
    s = torch.tensor(0.07, device="cuda")
    before = int8_linear.launches
    out = int8_linear(xq, wq, s, ws, bias)
    assert int8_linear.launches == before + 1 and out.shape == (rows, 640)
    ref = int8_linear(xq.cpu(), wq.cpu(), s.cpu(), ws.cpu(), bias.cpu())
    torch.testing.assert_close(out.cpu(), ref, atol=0, rtol=0)


def test_tiny_int8_and_tome_on_the_card(gen):
    """The tiny system in bf16 under the calibrated int8 policy: its 1024-
    token sites take the no-max kernel, every conv site the int8 conv
    kernel, the projections torch._int_mm; ToMe 0.5 at 1024 tokens runs
    too. The int8 eps call agrees with the CPU's int8 plain path in f32 on
    the same scales (independent int8 noise on both sides: cosine 0.99)."""
    from vdtpu_torch.ops.nomax import flash_attention_nomax
    from vdtpu_torch.ops.qconv import qconv3
    from vdtpu_torch.ops.quant import int8_linear, quant_state
    from vdtpu_torch.serving.api import VDInference, VDSystem
    cuda_sys = VDSystem("vd_test_tiny", dtype=torch.bfloat16, device="cuda").init_random(0)
    with torch.no_grad():
        for p in cuda_sys.net.parameters():
            if not bool(p.any()):
                p.copy_(torch.randn(p.shape, device="cuda", generator=gen) * 0.02)
    cuda_sys.enable_int8(image_size=64, latent_downsample=2, n=2)
    tok = lambda texts: torch.arange(16).repeat(len(texts), 1).numpy() + 1
    vdi = VDInference(cuda_sys, text_tokenizer=tok, output_dim=(64, 64), ddim_steps=4,
                      latent_downsample=2)
    for fn in (flash_attention, flash_attention_nomax, qconv3, int8_linear):
        fn.launches = 0
    img = vdi.inference_t2i("x", seed=0)
    assert tuple(img.shape) == (2, 64, 64, 3) and bool(torch.isfinite(img).all())
    assert flash_attention.launches == 1   # the tiny VAE's mid attention (no shift)
    assert flash_attention_nomax.launches > 0 and qconv3.launches > 0 and int8_linear.launches > 0
    cuda_sys.enable_tome(0.5, min_tokens=1024)
    img = vdi.inference_t2i("x", seed=0)
    cuda_sys.enable_tome(0)
    assert bool(torch.isfinite(img).all())
    cpu_sys = VDSystem("vd_test_tiny", device="cpu")
    cpu_sys.load_state_dict({k: v.float().cpu() for k, v in cuda_sys.net.state_dict().items()})
    cpu_sys.load_int8({k: v.cpu() for k, v in quant_state(cuda_sys.model.diffuser).items()})
    x = _randn(gen, 2, 4, 32, 32)   # two contexts of 16 tokens: torch._int_mm wants > 16 rows
    t = torch.tensor([500, 500], device="cuda")
    ctx = cuda_sys.ctx_encode(tok(["x", "y"]), "text")
    with torch.no_grad():
        a = cuda_sys.model.apply_model(x, t, ctx, "image", "text").float().cpu().flatten()
        b = cpu_sys.model.apply_model(x.float().cpu(), t.cpu(), ctx.float().cpu(),
                                      "image", "text").flatten()
    assert float(a @ b / (a.norm() * b.norm())) > 0.99


# ---- training: flash backward, autograd through the kernels, tiny train steps ----

def _bwd_close(out, ref):
    """Two bf16 ulps at each gradient's largest magnitude (the gradients are
    small), and relative L2 under 1e-2."""
    for a, r in zip(out, ref):
        a, r = a.float(), r.float()
        top = float(r.abs().max())
        assert bool(torch.isfinite(a).all())
        assert bool(((a - r).abs() <= ATOL * top + RTOL * r.abs()).all())
        assert float((a - r).norm() / r.norm()) < 1e-2


@pytest.mark.parametrize("b,n,m,h,d", [
    (2, 100, 300, 3, 8),
    (1, 257, 1023, 2, 36),     # d % 8 != 0: the unaligned (scalar-load) path
    (2, 128, 128, 2, 128),     # widest head the backward takes
    (1, 64, 65, 1, 72),
    (2, 1024, 77, 8, 40),      # a cross-attention shape, ragged kv
    (2, 4096, 4096, 2, 40),    # the 64^2 sites' length: 32 key blocks add into each dQ row
    (1, 1000, 1000, 2, 80),    # ragged last key block and query tile at d 80
])
def test_flash_bwd_kernel_matches_plain(gen, b, n, m, h, d):
    from vdtpu_torch.ops.flash import flash_attention_bwd, flash_attention_bwd_plain
    q, k, v = _randn(gen, b, n, h, d), _randn(gen, b, m, h, d), _randn(gen, b, m, h, d)
    do = _randn(gen, b, n, h, d)
    o, lse = flash_attention_plain(q, k, v, with_lse=True)
    before = flash_attention_bwd.launches
    out = flash_attention_bwd(q, k, v, o, lse, do, d ** -0.5)
    assert flash_attention_bwd.launches == before + 1
    _bwd_close(out, flash_attention_bwd_plain(q, k, v, o, lse, do, d ** -0.5))


def test_flash_lse_kernel_matches_plain(gen):
    from vdtpu_torch.ops.flash import flash_attention_fwd
    q, k, v = _randn(gen, 2, 300, 3, 40), _randn(gen, 2, 200, 3, 40), _randn(gen, 2, 200, 3, 40)
    out, lse = _one_launch(flash_attention, "wgmma",
                           lambda: flash_attention_fwd(q, k, v, 40 ** -0.5, with_lse=True))
    ref, lse_ref = flash_attention_plain(q, k, v, with_lse=True)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)
    assert flash_attention_fwd(q, k, v, 40 ** -0.5)[1] is None


@pytest.mark.parametrize("b,n,m,h,d", [
    (4, 4096, 4096, 8, 40), (4, 1024, 1024, 8, 80),   # training's forward sites
    (1, 1000, 1000, 2, 80), (2, 130, 77, 2, 8),       # ragged rows and keys
    (1, 257, 300, 2, 36), (1, 200, 300, 1, 128),      # the mma.sync kernel
])
def test_flash_lse_on_both_paths(gen, b, n, m, h, d):
    from vdtpu_torch.ops.flash import flash_attention_fwd
    q, k, v = _randn(gen, b, n, h, d), _randn(gen, b, m, h, d), _randn(gen, b, m, h, d)
    out, lse = _one_launch(flash_attention, _expect_path(d),
                           lambda: flash_attention_fwd(q, k, v, d ** -0.5, with_lse=True))
    ref, lse_ref = flash_attention_plain(q, k, v, with_lse=True)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)


def test_flash_autograd_on_strided_views(gen):
    """flash_attention under autograd on views of one packed projection:
    the forward with lse, the backward kernels, gradients into the packed
    tensor, against autograd through the plain forward."""
    from vdtpu_torch.ops.flash import flash_attention_bwd
    b, n, h, d = 2, 300, 4, 40
    qkv = _randn(gen, b, n, 3, h, d).requires_grad_()
    do = _randn(gen, b, n, h, d)
    before = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention(*qkv.unbind(dim=2))
    (g,) = torch.autograd.grad(out, qkv, do)
    assert (flash_attention.launches, flash_attention_bwd.launches) == (before[0] + 1,
                                                                         before[1] + 1)
    ref = torch.autograd.grad(flash_attention_plain(*qkv.unbind(dim=2)), qkv, do)[0]
    _bwd_close(g.unbind(dim=2), ref.unbind(dim=2))


def test_flash_bwd_on_strided_views_twice(gen):
    """The backward kernel on views of packed projections ([B, N, 3, H, D]
    q/k/v, dO a view of a wider tensor), run twice: each run within the
    plain version's tolerance; dK and dV bit-equal across runs (each block
    owns its keys), dQ within the same bf16 tolerance of the other run (its
    f32 partials are added in device memory in no fixed order)."""
    from vdtpu_torch.ops.flash import flash_attention_bwd, flash_attention_bwd_plain
    b, n, h, d = 2, 777, 4, 40
    qkv = _randn(gen, b, n, 3, h, d)
    q, k, v = qkv.unbind(dim=2)
    do = _randn(gen, b, n, h, 2 * d)[..., :d]
    assert not q.is_contiguous() and not do.is_contiguous()
    o, lse = flash_attention_plain(q, k, v, with_lse=True)
    first = flash_attention_bwd(q, k, v, o, lse, do, d ** -0.5)
    second = flash_attention_bwd(q, k, v, o, lse, do, d ** -0.5)
    ref = flash_attention_bwd_plain(q, k, v, o, lse, do, d ** -0.5)
    _bwd_close(first, ref)
    _bwd_close(second, ref)
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])
    _bwd_close(second[:1], first[:1])


def test_flash_bwd_takes_an_offset_lse(gen):
    """An lse view that does not start on 16 bytes (the wgmma kernel reads
    lse by TMA) takes the other kernel, within the same tolerance."""
    from vdtpu_torch.ops.flash import flash_attention_bwd, flash_attention_bwd_plain
    b, n, h, d = 1, 300, 2, 40
    q, k, v, do = (_randn(gen, b, n, h, d) for _ in range(4))
    o, lse = flash_attention_plain(q, k, v, with_lse=True)
    lse_off = torch.empty(lse.numel() + 1, device="cuda")[1:].view_as(lse).copy_(lse)
    assert lse_off.data_ptr() % 16 != 0 and lse_off.is_contiguous()
    out = flash_attention_bwd(q, k, v, o, lse_off, do, d ** -0.5)
    _bwd_close(out, flash_attention_bwd_plain(q, k, v, o, lse, do, d ** -0.5))


def test_flash_bwd_refuses(gen):
    from vdtpu_torch.ops.flash import flash_attention_bwd
    q = _randn(gen, 1, 64, 1, 136)
    o, lse = flash_attention_plain(q, q, q, with_lse=True)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, q, q, o, lse, q, 0.1)


def _tiny_train_system(gen):
    from vdtpu_torch.serving.api import VDSystem
    system = VDSystem("vd_test_tiny", device="cuda", use_checkpoint=False).init_random(0)
    with torch.no_grad():  # zero output convs would zero every gradient upstream
        for p in system.net.parameters():
            if not bool(p.any()):
                p.copy_(torch.randn(p.shape, device="cuda", generator=gen) * 0.02)
    return system, system.for_training(torch.bfloat16)


def test_tiny_training_on_the_card(gen, tmp_path, monkeypatch):
    """Tiny-config training in bf16 autocast on the card: its 32^2 latent
    gives 1024-token self-attention sites, so a micro-batch runs the flash
    forward and backward kernels and the GN kernel; its gradient agrees with
    the same gradient through the plain versions (cosine > 0.99). Then
    Trainer steps with a checkpoint, and a fresh system restored from it
    holds the same parameters, EMA and optimizer state."""
    from vdtpu_torch.ops import flash as flash_mod
    from vdtpu_torch.ops import gn_silu as gn_mod
    from vdtpu_torch.ops.flash import flash_attention_bwd
    from vdtpu_torch.training.harness import Trainer, make_loss_fn
    from vdtpu_torch.training.optim import get_optimizer
    freeze = ("diffuser_text_data",)
    system, params = _tiny_train_system(gen)
    tok = torch.arange(16, device="cuda").repeat(4, 1) + 1
    ctx = system.ctx_encode(tok.cpu().numpy(), "text")
    x = _randn(gen, 4, 4, 32, 32, dtype=torch.float32)
    t = torch.tensor([10, 300, 600, 990], device="cuda")
    noise = _randn(gen, 4, 4, 32, 32, dtype=torch.float32)
    loss_fn = make_loss_fn(system.model, "image", "text", freeze)

    def grads():
        for p in params.values():
            p.grad = None
        loss_fn(x, ctx, t, noise)[0].backward()
        return torch.cat([p.grad.flatten() for p in params.values() if p.grad is not None])

    flash_attention.launches = flash_attention_bwd.launches = gn_silu.launches = 0
    g_kern = grads()
    assert flash_attention.launches > 0 and gn_silu.launches > 0
    assert flash_attention_bwd.launches == flash_attention.launches
    with monkeypatch.context() as mp:
        mp.setattr(flash_mod, "flash_attention_fwd",
                   lambda q, k, v, s, with_lse=False: (
                       flash_mod.flash_attention_plain(q, k, v, s, True) if with_lse
                       else (flash_mod.flash_attention_plain(q, k, v, s), None)))
        mp.setattr(flash_mod, "flash_attention_bwd", flash_mod.flash_attention_bwd_plain)
        mp.setattr(gn_mod, "_gn_silu_fwd", gn_mod.gn_silu_plain)
        launches = flash_attention.launches
        g_plain = grads()
        assert flash_attention.launches == launches
    assert float(g_kern @ g_plain / (g_kern.norm() * g_plain.norm())) > 0.99

    def trainer(system, params):
        opt, set_lr = get_optimizer("adamw", params, {"diffuser_text_context": 0.5}, freeze,
                                    weight_decay=0.01)
        return Trainer(system.model, params, opt, set_lr, None, ema_decay=0.99, grad_accum=2,
                       ckpt_dir=str(tmp_path), freeze_groups=freeze, log_every=1)

    first = trainer(system, params)
    first.run([{"x": x, "ctx": ctx}] * 2, num_iters=2)
    assert math.isfinite(first.last_loss)
    restored = trainer(*_tiny_train_system(gen))
    restored.restore()
    a, b = first.state, restored.state
    assert b.step == 2 and b.ema.num_updates == 2
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]) and torch.equal(a.ema.shadow[k],
                                                                     b.ema.shadow[k]), k
    sa, sb = a.opt_state.state_dict()["state"], b.opt_state.state_dict()["state"]
    assert sa.keys() == sb.keys() and all(torch.equal(sa[i]["nu"], sb[i]["nu"]) for i in sa)
    restored.run([{"x": x, "ctx": ctx}], num_iters=3)
    assert math.isfinite(restored.last_loss)


# ---- the whole-ResBlock int8 kernel (conv="fused2") and image variation ----

# The kernel and its plain version sum the GroupNorm statistics in other
# orders, so a code can flip where y / s lies within f32 rounding of a
# half-integer, and a flipped mid code moves the GN2 statistics by a last
# bit: bounded as the chip check bounds it (share of elements outside two
# output ulps, relative L2)
RB_MAX_OUTSIDE, RB_MAX_REL_L2 = 1e-3, 1e-2
# f32 at the UNet's full widths: millions of codes are quantized there, and
# some lie within f32 rounding of a half-integer, so a last-bit difference
# in the GN statistics (the sums' order) flips a few of them and moves
# every output they feed by far more than f32's band. The gate sits
# between the kernel's readings at the 9 full-width cases below (H100:
# 1.5-11.1% outside the band, relative L2 1.6e-4 to 3.8e-4) and those of
# the plain version with its mid rounded to bf16 (99.7-99.8% outside,
# relative L2 3.4e-3 to 5.1e-3), which the test shows the gate refuses
RB_F32_WIDE_OUTSIDE, RB_F32_WIDE_REL_L2 = 0.25, 1e-3


def _resblock_args(gen, b, c, n, h, w, dtype, with_skip):
    from vdtpu_torch.ops.quant import quantize_weight
    rnd = lambda *shape: torch.randn(shape, device="cuda", generator=gen)
    x = (rnd(b, c, h, w) * 2 + 0.5).to(dtype)
    w1q, s1w = quantize_weight(rnd(n, 3, 3, c))
    w2q, s2w = quantize_weight(rnd(n, 3, 3, n))
    return (x, torch.rand(c, device="cuda", generator=gen) + 0.5, rnd(c) * 0.1,
            w1q.contiguous(), s1w * 0.05, rnd(n) * 0.1, torch.tensor(0.03, device="cuda"),
            (rnd(b, n) * 0.5).to(dtype), torch.rand(n, device="cuda", generator=gen) + 0.5,
            rnd(n) * 0.1, w2q.contiguous(), s2w * 0.05, rnd(n) * 0.1,
            torch.tensor(0.02, device="cuda"), rnd(b, n, h, w).to(dtype) if with_skip else None)


def _resblock_reading(out, ref):
    """(share of the elements outside the band: two bf16 ulps in bf16,
    1e-5 in f32; relative L2 error)."""
    a, r = out.float(), ref.float()
    assert bool(torch.isfinite(a).all())
    band = (1e-2 + 1.6e-2 * r.abs()) if out.dtype == torch.bfloat16 else (1e-5 + 1e-5 * r.abs())
    return float(((a - r).abs() > band).float().mean()), float((a - r).norm() / r.norm())


def _resblock_close(out, ref, max_outside=RB_MAX_OUTSIDE, max_rel=RB_MAX_REL_L2):
    outside, rel = _resblock_reading(out, ref)
    assert outside <= max_outside and rel <= max_rel, (outside, rel)
    return outside, rel


def _resblock_bf16_mid(x, g1, be1, w1q, s1w, b1, sx1, film, g2, be2, w2q, s2w, b2, sx2, skip):
    """resblock_plain in f32 with the mid rounded to bf16: what an f32
    kernel that rounded its mid wrongly would give."""
    from vdtpu_torch.ops.gn_silu import gn_stats_plain
    from vdtpu_torch.ops.qconv import gn_quantize_plain, qconv3_plain
    q1 = gn_quantize_plain(x, gn_stats_plain(x), g1, be1, sx1)
    mid = qconv3_plain(q1, w1q, s1w, b1, sx1, 1, film, None, torch.bfloat16).float()
    q2 = gn_quantize_plain(mid, gn_stats_plain(mid), g2, be2, sx2)
    return qconv3_plain(q2, w2q, s2w, b2, sx2, 1, None, x if skip is None else skip, x.dtype)


@pytest.mark.parametrize("b,c,n,h,w,with_skip", [
    (2, 64, 64, 16, 16, False),     # identity skip, 64-channel halo chunks
    (2, 64, 128, 8, 24, True),      # channel change: a skip tensor; 5-row tiles, ragged 3
    (1, 96, 64, 24, 8, True),       # C % 64 != 0: 32-channel chunks; 16-row tiles, ragged 8
    (2, 32, 32, 32, 32, False),     # the tiny config's 32-channel level: the general route
    (1, 320, 640, 16, 16, True),    # several N tiles, several groups a tile
    (2, 32, 64, 32, 32, True),      # C != N at 32-channel chunks
    (1, 64, 64, 10, 16, False),     # 8-row tiles, the last one 2 rows
    (4, 320, 96, 64, 64, True),     # 96 channels no halo N tile divides: the general
                                    # route at the 64^2 map (chip_smoke.py)
    # the 8 distinct conv="fused2" sites of the full-width UNet (chip_smoke.py)
    (4, 320, 320, 64, 64, False), (4, 640, 320, 64, 64, True), (4, 960, 320, 64, 64, True),
    (4, 320, 640, 32, 32, True), (4, 640, 640, 32, 32, False), (4, 1920, 640, 32, 32, True),
    (4, 1280, 640, 32, 32, True), (4, 960, 640, 32, 32, True),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_resblock_kernel_matches_plain(gen, b, c, n, h, w, with_skip, dtype):
    from vdtpu_torch.ops.qconv import resblock_plain, resblock_plan, resblock_q, sm_count
    args = _resblock_args(gen, b, c, n, h, w, dtype, with_skip)
    route = resblock_plan(b, h, w, c, n, sms=sm_count(0)).route
    before, by_route = resblock_q.launches, resblock_q.launches_by_path[route]
    out = resblock_q(*args)
    assert resblock_q.launches == before + 1 and out.shape == (b, n, h, w)
    assert resblock_q.launches_by_path[route] == by_route + 1
    assert route == ("general" if c % 32 or n % 64 else "halo")
    assert out.dtype == dtype
    ref = resblock_plain(*args)
    if dtype == torch.float32 and b * c * h * w >= 4 * 320 * 32 * 32:   # full width
        reading, wrong = (_resblock_reading(t, ref) for t in (out, _resblock_bf16_mid(*args)))
        print(f"f32 resblock {(b, c, h, w, n)}: kernel (outside, rel L2) {reading}, "
              f"bf16-rounded mid {wrong}")
        _resblock_close(out, ref, RB_F32_WIDE_OUTSIDE, RB_F32_WIDE_REL_L2)
        assert wrong[0] > RB_F32_WIDE_OUTSIDE or wrong[1] > RB_F32_WIDE_REL_L2, wrong
    else:
        _resblock_close(out, ref)
    assert torch.equal(out, resblock_q(*args))   # fixed-order sums: deterministic


@pytest.mark.parametrize("field,delta", [("grid", 1), ("smem_bytes", 16), ("rows", -1),
                                         ("bn", 16), ("gn2_slots", 1), ("kc", -32),
                                         ("bm", 128)])
def test_resblock_kernel_refuses_a_plan_it_does_not_mirror(gen, monkeypatch, field, delta):
    """The launch derives the plan's geometry again and refuses a mismatch
    (cudaErrorInvalidValue), never running a tile map it did not check."""
    import dataclasses
    from vdtpu_torch.ops import qconv
    args = _resblock_args(gen, 2, 64, 64, 16, 16, torch.bfloat16, False)
    real = qconv.resblock_plan
    plan = real(2, 16, 16, 64, 64)
    assert plan.route == "halo"
    bad = dataclasses.replace(plan, **{field: getattr(plan, field) + delta})
    monkeypatch.setattr(qconv, "resblock_plan", lambda *a, **k: bad)
    before = qconv.resblock_q.launches
    with pytest.raises(RuntimeError, match="cudaError 1 "):
        qconv.resblock_q(*args)
    assert qconv.resblock_q.launches == before


def test_resblock_flat_takes_the_jax_layout(gen):
    """resblock_flat: flat [B, H*W, C] in and out, weights [3, 3, C, N]."""
    from vdtpu_torch.ops.qconv import resblock_flat, resblock_plain
    b, c, n, h, w = 2, 64, 128, 16, 8
    (x, g1, be1, w1q, s1w, b1, sx1, film, g2, be2, w2q, s2w, b2, sx2,
     skip) = _resblock_args(gen, b, c, n, h, w, torch.bfloat16, True)
    flat = lambda t: t.permute(0, 2, 3, 1).reshape(b, h * w, t.shape[1]).contiguous()
    out = resblock_flat(flat(x), (g1, be1), w1q.permute(1, 2, 3, 0), s1w, b1, sx1, film,
                        (g2, be2), w2q.permute(1, 2, 3, 0), s2w, b2, sx2, h, w,
                        skip=flat(skip))
    ref = resblock_plain(x, g1, be1, w1q, s1w, b1, sx1, film, g2, be2, w2q, s2w, b2, sx2, skip)
    _resblock_close(out, flat(ref))


def test_resblock_kernel_refuses(gen):
    from vdtpu_torch.ops.qconv import resblock_q
    args = list(_resblock_args(gen, 1, 64, 64, 8, 8, torch.bfloat16, False))
    bad = dict(enumerate(args))
    bad[3] = args[3].float()                      # weights not int8
    with pytest.raises(ValueError):
        resblock_q(*bad.values())
    bad = dict(enumerate(args))
    bad[7] = args[7].float()                      # FiLM in another dtype
    with pytest.raises(ValueError):
        resblock_q(*bad.values())
    with pytest.raises(TypeError):
        resblock_q(args[0].half(), *args[1:7], args[7].half(), *args[8:])
    args64 = list(_resblock_args(gen, 1, 64, 128, 8, 8, torch.bfloat16, False))
    with pytest.raises(ValueError):               # identity skip with C != N
        resblock_q(*args64)


def test_tiny_i2i_and_fused2_on_the_card(gen):
    """The tiny system in bf16 on the card: image variation from noise and
    from the image's latent (VAE encoder, focus filter, colour adjust);
    then four-flow int8 calibration and t2i under conv="fused2", whose
    32-channel 32^2 level takes the whole-ResBlock kernel; its eps call
    agrees with conv="fused" on the same scales."""
    from vdtpu_torch.ops.qconv import qconv3_gn, resblock_q
    from vdtpu_torch.ops.quant import QuantPolicy
    from vdtpu_torch.serving.api import VDInference, VDSystem
    cuda_sys = VDSystem("vd_test_tiny", dtype=torch.bfloat16, device="cuda").init_random(0)
    with torch.no_grad():
        for p in cuda_sys.net.parameters():
            if not bool(p.any()):
                p.copy_(torch.randn(p.shape, device="cuda", generator=gen) * 0.02)
    tok = lambda texts: torch.arange(16).repeat(len(texts), 1).numpy() + 1
    vdi = VDInference(cuda_sys, text_tokenizer=tok, output_dim=(64, 64), ddim_steps=4,
                      latent_downsample=2)
    image = torch.rand(1, 50, 70, 3, device="cuda", generator=gen)
    for fid, fcs, clr in ((0.0, 0.5, None), (0.5, 0.3, "Simple")):
        img = vdi.inference_i2i(image, fid, fcs, clr, seed=0)
        assert tuple(img.shape) == (2, 64, 64, 3) and bool(torch.isfinite(img).all())
        assert 0.0 <= float(img.min()) and float(img.max()) <= 1.0
    cuda_sys.enable_int8(image_size=64, latent_downsample=2, n=2)
    x = _randn(gen, 2, 4, 32, 32)
    t = torch.tensor([500, 500], device="cuda")
    ctx = cuda_sys.ctx_encode(tok(["x", "y"]), "text")
    eps, counts = {}, {}
    for conv in ("fused", "fused2"):
        cuda_sys.set_quant_policy(QuantPolicy(conv=conv))
        resblock_q.launches = qconv3_gn.launches = 0
        with torch.no_grad():
            eps[conv] = cuda_sys.model.apply_model(x, t, ctx, "image", "text").float()
        counts[conv] = (resblock_q.launches, qconv3_gn.launches)
    # every ResBlock that "fused" runs as two fused convs is one fused2 launch
    assert counts["fused"][0] == 0 and counts["fused2"][1] == 0
    assert counts["fused"][1] == 2 * counts["fused2"][0] > 0, counts
    a, b = eps["fused2"].flatten().double(), eps["fused"].flatten().double()
    assert float(a @ b / (a.norm() * b.norm())) > 0.99
    img = vdi.inference_t2i("x", seed=0)
    assert bool(torch.isfinite(img).all())


@pytest.mark.parametrize("m,k,n", [
    (4096, 2880, 128),    # the probe's product
    (300, 288, 72),       # ragged M, K not a multiple of 64, N below a tile
    (17, 16, 24),         # N % 16 != 0: B read from memory, not a tensor map
    (513, 1040, 200),
    (4096, 2880, 256),    # two column tiles
    (257, 4112, 32),      # K % 32 == 16: the last rank's last step half past K
    (300, 1056, 72),      # 33 k32 steps over the ranks: a remainder
])
def test_probe_s8mm_kernel_matches_plain(gen, m, k, n):
    from vdtpu_torch.ops.probes import probe_s8mm, probe_s8mm_plain
    a = torch.randint(-128, 128, (m, k), device="cuda", generator=gen).to(torch.int8)
    b = torch.randint(-128, 128, (k, n), device="cuda", generator=gen).to(torch.int8)
    before = probe_s8mm.launches
    out = probe_s8mm(a, b)
    assert probe_s8mm.launches == before + 1 and out.dtype == torch.int32
    assert torch.equal(out, probe_s8mm_plain(a, b))
    ones = torch.ones_like(a), torch.ones_like(b)
    assert bool((probe_s8mm(*ones) == k).all())


@pytest.mark.parametrize("m,k,n", [(300, 1056, 72), (257, 4112, 32), (4096, 2880, 128)])
def test_probe_s8mm_every_split_matches_plain(gen, m, k, n):
    """The kernel at each cluster split of K (1 to 4 CTAs, remainders
    included), bit-equal to the plain version; the planner takes one."""
    from vdtpu_torch.ops.kernels.build import load
    from vdtpu_torch.ops.probes import S8MM_MAX_SPLIT, probe_s8mm_plain
    a = torch.randint(-128, 128, (m, k), device="cuda", generator=gen).to(torch.int8)
    b = torch.randint(-128, 128, (k, n), device="cuda", generator=gen).to(torch.int8)
    ref = probe_s8mm_plain(a, b)
    lib = load("probe_s8mm")
    for split in range(1, S8MM_MAX_SPLIT + 1):
        c = torch.empty((m, n), dtype=torch.int32, device="cuda")
        assert lib.vd_probe_s8mm(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, split,
                                 torch.cuda.current_stream().cuda_stream) == 0
        assert torch.equal(c, ref), split
    c = torch.empty((m, n), dtype=torch.int32, device="cuda")   # a split past the steps
    assert lib.vd_probe_s8mm(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, 16, 4,
                             torch.cuda.current_stream().cuda_stream) != 0


def test_probe_s8mm_refuses(gen):
    from vdtpu_torch.ops.probes import MAX_K, probe_s8mm
    a = torch.zeros((32, 40), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError):                 # K % 16 != 0
        probe_s8mm(a, torch.zeros((40, 16), dtype=torch.int8, device="cuda"))
    deep = MAX_K // 16 * 16 + 16
    with pytest.raises(ValueError):                 # K past MAX_K: s32 could overflow
        probe_s8mm(torch.zeros((4, deep), dtype=torch.int8, device="cuda"),
                   torch.zeros((deep, 16), dtype=torch.int8, device="cuda"))
    with pytest.raises(ValueError):                 # operands on two devices
        probe_s8mm(torch.zeros((32, 48), dtype=torch.int8, device="cuda"),
                   torch.zeros((48, 16), dtype=torch.int8))
    with pytest.raises(TypeError):
        probe_s8mm(a.float(), torch.zeros((40, 16), device="cuda"))
    with pytest.raises(ValueError):                 # the shapes do not chain
        probe_s8mm(torch.zeros((32, 48), dtype=torch.int8, device="cuda"),
                   torch.zeros((32, 16), dtype=torch.int8, device="cuda"))


@pytest.mark.parametrize("m,c", [(1056, 320), (67, 5), (200, 129)])
def test_probe_shift_kernel_matches_plain(gen, m, c):
    from vdtpu_torch.ops.probes import probe_shift, probe_shift_plain
    x = torch.randint(-(1 << 20), 1 << 20, (m, c), device="cuda", generator=gen,
                      dtype=torch.int32)
    before = probe_shift.launches
    out = probe_shift(x)
    assert probe_shift.launches == before + 1
    assert torch.equal(out, probe_shift_plain(x))


@pytest.mark.parametrize("m,c", [(512, 320), (3, 7), (100, 130)])
def test_probe_scratch_kernel_matches_plain(gen, m, c):
    """Values inside [-127, 127] (truncation toward zero) and the edges of
    the range."""
    from vdtpu_torch.ops.probes import probe_scratch, probe_scratch_plain
    x = ((torch.rand((m, c), device="cuda", generator=gen) * 2 - 1) * 127).to(torch.bfloat16)
    x.view(-1)[:4] = torch.tensor([42.5, -32.25, 127.0, -128.0], device="cuda")[:x.numel()]
    before = probe_scratch.launches
    out = probe_scratch(x)
    assert probe_scratch.launches == before + 1 and out.dtype == torch.int8
    assert torch.equal(out, probe_scratch_plain(x))


def test_tiny_text_flows_on_the_card(gen):
    """The tiny system in bf16 on the card: i2t and t2t end to end, every
    decoded row BOS first with ids inside the vocabulary, and the first
    decode step's logits against the f32 CPU copy."""
    from vdtpu_torch.serving.api import VDInference, VDSystem
    cuda_sys = VDSystem("vd_test_tiny", dtype=torch.bfloat16, device="cuda").init_random(0)
    tok = lambda texts: torch.arange(16).repeat(len(texts), 1).numpy() + 1
    vdi = VDInference(cuda_sys, text_tokenizer=tok, output_dim=(64, 64), ddim_steps=4,
                      latent_downsample=2, text_latent_dim=96)
    image = torch.rand(1, 50, 70, 3, device="cuda", generator=gen)
    for texts in (vdi.inference_i2t(image, seed=0), vdi.inference_t2t("x", seed=0)):
        assert len(texts) == 4   # ids joined by spaces, cut before EOS (599)
        assert all(0 <= int(t) < 599 for s in texts for t in s.split())
    vae = cuda_sys.vae["text"]
    z = torch.randn(3, 96, device="cuda", generator=gen)
    ids = vae.decode_ids(z, torch.Generator(device="cuda").manual_seed(1))
    assert tuple(ids.shape) == (3, 30) and bool((ids[:, 0] == vae.bos_id).all())
    assert bool((ids[:, -1] == vae.eos_id).all()) and int(ids.max()) < 600
    cpu_sys = VDSystem("vd_test_tiny", device="cpu")
    cpu_sys.load_state_dict({k: v.float().cpu() for k, v in cuda_sys.net.state_dict().items()})
    bos = torch.full((3, 1), vae.bos_id, dtype=torch.long)
    with torch.no_grad():
        a = vae.decoder(bos.cuda(), z)[:, 0].double().cpu().flatten()
        b = cpu_sys.vae["text"].decoder(bos, z.cpu())[:, 0].double().flatten()
    assert float(a @ b / (a.norm() * b.norm())) > 0.995


def test_tome_merge_is_deterministic_on_the_card(gen):
    """ToMe's merge at the UNet's 64^2 sites at the queue's largest bucket
    (batch 16) and at [4, 4096, 320]: two merges of the same input are
    bit-equal, a row's merge does not depend on its co-riders, and the
    card's merge agrees with the CPU's (f32 sums in another order, then the
    bf16 rounding)."""
    from vdtpu_torch.ops.tome import ToMeSpec, build_merge
    spec = ToMeSpec(0.75)
    for b in (4, 16):
        x = _randn(gen, b, 4096, 320)
        outs = [build_merge(x, spec)[0](x) for _ in range(2)]
        assert outs[0].shape == (b, 1024, 320) and torch.equal(outs[0], outs[1])
        other = x.clone()
        other[1:] = _randn(gen, b - 1, 4096, 320)
        assert torch.equal(build_merge(other, spec)[0](other)[0], outs[0][0])
    cpu = build_merge(x[:2].float().cpu(), spec)[0](x[:2].float().cpu())
    card = build_merge(x[:2], spec)[0](x[:2]).float().cpu()
    # a near-tie of cosine scores may send a source to another destination
    assert ((card - cpu).abs() <= ATOL + RTOL * cpu.abs()).float().mean() > 0.99


def test_tiny_queue_on_the_card(gen):
    """The serving queue on the card (tiny system, bf16, int8 + ToMe at its
    1024-token sites): at a fixed bucket a request's image does not depend
    on its co-riders, and at bucket 1 it is inference_t2i at n = 1, bit for
    bit."""
    from vdtpu_torch.serving.api import VDInference, VDSystem
    from vdtpu_torch.serving.queue import BatchingQueue
    cuda_sys = VDSystem("vd_test_tiny", dtype=torch.bfloat16, device="cuda").init_random(0)
    with torch.no_grad():
        for p in cuda_sys.net.parameters():
            if not bool(p.any()):
                p.copy_(torch.randn(p.shape, device="cuda", generator=gen) * 0.02)
    tok = lambda texts: (torch.arange(16).repeat(len(texts), 1)
                         + torch.tensor([len(t) for t in texts])[:, None]).numpy() + 1
    vdi = VDInference(cuda_sys, text_tokenizer=tok, output_dim=(64, 64), ddim_steps=4,
                      latent_downsample=2, n_sample_image=1)

    def run(riders, buckets=(4,)):
        with BatchingQueue(vdi, buckets=buckets, max_wait_ms=300.0) as q:
            f = q.submit("a red cat", 3)
            for text, seed in riders:
                q.submit(text, seed)
            return f.result(600)

    for mode in ("exact", "int8_tome"):
        if mode == "int8_tome":
            cuda_sys.enable_int8(image_size=64, latent_downsample=2, n=2)
            cuda_sys.enable_tome(0.75, min_tokens=1024)
        a = run([("a dog", 1), ("the sea at night", 2), ("a red cat", 4)])
        b = run([])
        assert torch.equal(a, b) and a.shape == (64, 64, 3), mode
        assert torch.equal(run([], buckets=(1,)), vdi.inference_t2i("a red cat", 3)[0]), mode
    cuda_sys.enable_tome(0)
