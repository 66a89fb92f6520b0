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


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, dtype=torch.bfloat16):
    return torch.randn(shape, device="cuda", generator=gen).to(dtype)


@pytest.mark.parametrize("b,n,m,h,d", [
    (2, 100, 300, 3, 8),
    (1, 257, 1023, 2, 36),     # d % 8 != 0: the unaligned (scalar-load) path
    (2, 128, 128, 2, 256),     # widest head the kernel takes
    (1, 64, 65, 1, 72),
    (2, 1024, 77, 8, 40),      # a cross-attention shape, ragged kv
])
def test_flash_kernel_matches_plain(gen, b, n, m, h, d):
    q, k, v = _randn(gen, b, n, h, d), _randn(gen, b, m, h, d), _randn(gen, b, m, h, d)
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(out.float(), flash_attention_plain(q, k, v).float(),
                               atol=ATOL, rtol=RTOL)


def test_flash_kernel_reads_strided_views(gen):
    """q, k, v as views of one packed [B, N, 3, H, D] projection, and a
    misaligned start (one element in), which takes the unaligned path."""
    b, n, h, d = 2, 300, 4, 40
    qkv = _randn(gen, b, n, 3, h, d)
    q, k, v = qkv.unbind(dim=2)
    torch.testing.assert_close(flash_attention(q, k, v).float(),
                               flash_attention_plain(q, k, v).float(), atol=ATOL, rtol=RTOL)
    flat = _randn(gen, b * n * h * d + 1)
    qm = flat[1:].view(b, n, h, d)
    torch.testing.assert_close(flash_attention(qm, k, v).float(),
                               flash_attention_plain(qm, k, v).float(), atol=ATOL, rtol=RTOL)


def test_flash_kernel_refuses(gen):
    q = _randn(gen, 1, 64, 1, 40, dtype=torch.float32)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)
    q = _randn(gen, 1, 64, 1, 264)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)


@pytest.mark.parametrize("shape,groups", [((2, 96, 7, 9), 32), ((3, 320, 33, 17), 32),
                                          ((1, 64, 1, 1), 32), ((2, 256, 4), 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("with_silu", [True, False])
def test_gn_kernel_matches_plain(gen, shape, groups, dtype, with_silu):
    c = shape[1]
    x = (_randn(gen, *shape, dtype=torch.float32) * 2 + 0.5).to(dtype)
    w = (torch.rand(c, device="cuda", generator=gen) + 0.5).to(dtype)
    bias = _randn(gen, c, dtype=dtype)
    before = gn_silu.launches
    out = gn_silu(x, w, bias, groups, 1e-5, with_silu)
    assert gn_silu.launches == before + 1
    ref = gn_silu_plain(x, w, bias, groups, 1e-5, with_silu)
    atol, rtol = (1e-5, 1e-5) if dtype == torch.float32 else (ATOL, RTOL)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


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
])
def test_nomax_kernel_matches_plain(gen, b, n, m, h, d):
    from vdtpu_torch.ops.nomax import flash_attention_nomax, flash_attention_nomax_plain
    q, k, v, shift = _nomax_args(gen, b, n, m, h, d)
    before = flash_attention_nomax.launches
    out = flash_attention_nomax(q, k, v, shift)
    assert flash_attention_nomax.launches == before + 1
    torch.testing.assert_close(out.float(), flash_attention_nomax_plain(q, k, v, shift).float(),
                               atol=ATOL, rtol=RTOL)
    # a float shift (one bound for every head) is the same function
    hi = float(shift.max())
    torch.testing.assert_close(flash_attention_nomax(q, k, v, hi).float(),
                               flash_attention_nomax_plain(q, k, v, hi).float(),
                               atol=ATOL, rtol=RTOL)


def test_nomax_kernel_reads_packed_views(gen):
    """q, k, v as [B, N, H, D] views of packed [B, N, H*D] projections (the
    TPU's _nomax_packed_kernel layout) and of one [B, N, 3, H, D] tensor."""
    from vdtpu_torch.ops.nomax import flash_attention_nomax, flash_attention_nomax_plain
    b, n, h, d = 2, 300, 4, 40
    qkv = _randn(gen, b, n, 3 * h * d)
    q, k, v = (t.view(b, n, h, d) for t in qkv.split(h * d, dim=-1))
    shift = torch.full((h,), 6.0, device="cuda")
    torch.testing.assert_close(flash_attention_nomax(q, k, v, shift).float(),
                               flash_attention_nomax_plain(q, k, v, shift).float(),
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


@pytest.mark.parametrize("shape,groups", [((2, 96, 7, 9), 32), ((3, 320, 33, 17), 32),
                                          ((1, 64, 1, 1), 32), ((2, 40, 5, 3), 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gn_int8_kernels_match_plain(gen, shape, groups, dtype):
    from vdtpu_torch.ops.gn_silu import gn_silu_q, gn_silu_q_plain, gn_stats, gn_stats_plain
    c = shape[1]
    x = (_randn(gen, *shape, dtype=torch.float32) * 2 + 0.5).to(dtype)
    w = (torch.rand(c, device="cuda", generator=gen) + 0.5).to(dtype)
    bias = _randn(gen, c, dtype=dtype)
    st = gn_stats(x, groups, 1e-5)
    torch.testing.assert_close(st, gn_stats_plain(x, groups, 1e-5), atol=1e-5, rtol=1e-5)
    s = torch.tensor(0.02, device="cuda")
    for silu in (True, False):
        q = gn_silu_q(x, w, bias, s, groups, 1e-5, silu)
        assert q.dtype == torch.int8 and q.shape == (shape[0],) + shape[2:] + (c,)
        _codes_agree(q, gn_silu_q_plain(x, w, bias, s, groups, 1e-5, silu))


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


@pytest.mark.parametrize("b,c,h,w,n,stride", [
    (2, 4, 16, 16, 64, 1),      # conv_in: C_in = 4 (element-wise staging)
    (2, 64, 16, 16, 4, 1),      # the output conv: C_out = 4
    (2, 128, 16, 16, 128, 2),   # Downsample2D
    (1, 64, 12, 20, 72, 1),     # non-square map, N not a multiple of the tile
    (2, 40, 9, 7, 24, 2),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_qconv3_kernel_matches_plain(gen, b, c, h, w, n, stride, dtype):
    from vdtpu_torch.ops.qconv import qconv3, qconv3_plain
    xq, wq, w_scale, bias, s_x = _qconv_args(gen, b, c, h, w, n, dtype)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    film = _randn(gen, b, n, dtype=dtype)
    res = _randn(gen, b, n, ho, wo, dtype=dtype)
    for add_vec, add_full in ((None, None), (film, None), (None, res), (film, res)):
        before = qconv3.launches
        out = qconv3(xq, wq, w_scale, bias, s_x, stride, add_vec, add_full, dtype)
        assert qconv3.launches == before + 1 and out.shape == (b, n, ho, wo)
        ref = qconv3_plain(xq, wq, w_scale, bias, s_x, stride, add_vec, add_full, dtype)
        torch.testing.assert_close(out.float(), ref.float(), **QC_TOL[dtype])


@pytest.mark.parametrize("b,c,h,w,n,stride", [
    (2, 64, 16, 16, 64, 1), (1, 96, 10, 14, 40, 1), (2, 64, 16, 16, 64, 2)])
def test_qconv3_gn_kernel_matches_plain(gen, b, c, h, w, n, stride):
    """The fused GN prologue, with a GN bias large enough that
    quantize(GN(0)) is far from 0: the image edge must stay 0 after
    quantization, as the plain version's zero padding of the codes has it."""
    from vdtpu_torch.ops.gn_silu import gn_stats
    from vdtpu_torch.ops.qconv import qconv3_gn, qconv3_gn_plain
    _, wq, w_scale, bias, s_x = _qconv_args(gen, b, c, h, w, n)
    x = (_randn(gen, b, c, h, w, dtype=torch.float32) * 2 + 0.5).to(torch.bfloat16)
    gamma = torch.rand(c, device="cuda", generator=gen) + 0.5
    beta = torch.full((c,), 2.0, device="cuda")
    st = gn_stats(x, 32, 1e-5)
    res = _randn(gen, b, n, (h - 1) // stride + 1, (w - 1) // stride + 1)
    film = _randn(gen, b, n)
    before = qconv3_gn.launches
    out = qconv3_gn(x, st, gamma, beta, s_x, wq, w_scale, bias, True, stride, film, res)
    assert qconv3_gn.launches == before + 1
    ref = qconv3_gn_plain(x, st, gamma, beta, s_x, wq, w_scale, bias, True, stride, film, res)
    torch.testing.assert_close(out.float(), ref.float(), **QC_TOL[torch.bfloat16])


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
    """int8_linear hands torch._int_mm the [N, K] table as a [K, N] view."""
    from vdtpu_torch.ops.quant import int8_linear
    xq = torch.randint(-127, 128, (40, 64), device="cuda", generator=gen).to(torch.int8)
    wq = torch.randint(-127, 128, (48, 64), device="cuda", generator=gen).to(torch.int8)
    ws = torch.rand(48, device="cuda", generator=gen) * 1e-2
    s = torch.tensor(0.1, device="cuda")
    out = int8_linear(xq, wq, s, ws, out_dtype=torch.float32)
    ref = int8_linear(xq.cpu(), wq.cpu(), s.cpu(), ws.cpu(), out_dtype=torch.float32)
    torch.testing.assert_close(out.cpu(), ref, atol=0, rtol=0)
    with pytest.raises(ValueError):
        int8_linear(xq[:16], wq, s, ws)  # torch._int_mm needs more than 16 rows


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
    out, lse = flash_attention_fwd(q, k, v, 40 ** -0.5, with_lse=True)
    ref, lse_ref = flash_attention_plain(q, k, v, with_lse=True)
    torch.testing.assert_close(out.float(), ref.float(), atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)
    assert flash_attention_fwd(q, k, v, 40 ** -0.5)[1] is None


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
