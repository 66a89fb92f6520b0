"""Card-only tests of the port's kernels (marker ``gpu``).

They skip where no CUDA card is present. On the machine with the card,
which has no JAX, run them without the JAX-side conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Each kernel is held against its plain version on the same CUDA inputs at
shapes the main path does not cover: ragged lengths, head widths that need
the kernel's unaligned load path, strided views, other dtypes.
"""
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
    x = _randn(gen, 1, 4, 32, 32)
    t = torch.tensor([500], device="cuda")
    ctx = cuda_sys.ctx_encode(tok(["x"]), "text")
    with torch.no_grad():
        a = cuda_sys.model.apply_model(x, t, ctx, "image", "text").float().cpu().flatten()
        b = cpu_sys.model.apply_model(x.float().cpu(), t.cpu(), ctx.float().cpu(),
                                      "image", "text").flatten()
    assert float(a @ b / (a.norm() * b.norm())) > 0.995
