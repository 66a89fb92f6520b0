"""Image variation (``inference_i2i``), port against the JAX package, on the
tiny config in f32: the CLIP image context encoder, the resize and CLIP
preprocessing, the VAE posterior, the focus filter, the colour adjust, the
x0 (img2img) start of DDIM, and the flow end to end.

Both systems carry the same weights: the port's seeded init, its all-zero
tensors replaced by seeded normals (as ``test_torch_slice`` does with the
JAX init), loaded into a JAX system whose parameter trees come from
``jax.eval_shape`` (a jitted JAX init of the tiny system costs ~40 s). The
two packages draw different random numbers from one seed, so the JAX side's
sampler is handed the port's x_T and noise (the port draws them from
``torch.Generator(seed)``); nothing else is patched.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdtpu.models import clip as jclip
from vdtpu.models.distributions import DiagonalGaussian as JDiagonalGaussian
from vdtpu.sampling.ddim import DDIMSampler as JDDIMSampler
from vdtpu.sampling.ddim import DDIMTables as JDDIMTables
from vdtpu.serving import api as japi
from vdtpu.serving import postprocess as jpost
from vdtpu.serving.api import VDSystem as JVDSystem
from vdtpu_torch.models.clip import preprocess_images
from vdtpu_torch.models.distributions import DiagonalGaussian
from vdtpu_torch.ops.flash import flash_attention
from vdtpu_torch.ops.gn_silu import gn_silu
from vdtpu_torch.sampling.ddim import DDIMTables
from vdtpu_torch.serving import postprocess
from vdtpu_torch.serving.api import VDInference, VDSystem, regularize_image

torch.set_num_threads(2)


def tiny_systems_from_port(seed: int = 0, image_size: int = 64):
    """(JAX system, port system on the CPU, the shared state dict) of
    ``vd_test_tiny``, every part (the Optimus text VAE included), from the
    port's init."""
    psys = VDSystem("vd_test_tiny", device="cpu").init_random(seed)
    rs = np.random.RandomState(seed)
    sd = {k: (v.numpy().copy() if v.any() else rs.normal(0, 0.02, tuple(v.shape)))
          for k, v in sorted(psys.net.state_dict().items())}
    sd = {k: np.asarray(v, np.float32) for k, v in sd.items()}
    psys.load_state_dict(sd, strict=True)
    jsys = JVDSystem("vd_test_tiny")
    jsys.params = jax_param_templates(jsys, image_size)
    assert not jsys.load_torch_checkpoint(sd, strict=True)
    return jsys, psys, sd


def jax_param_templates(jsys, image_size: int = 64):
    """vdtpu's param tree of ``jsys`` as shapes (``jax.eval_shape``, no
    init run): the structure its checkpoint loader fills."""
    key = jax.random.PRNGKey(0)
    zeros = lambda *shape, dt=jnp.float32: jnp.zeros(shape, dt)
    sz = jsys.ctx["image"].image_size
    shapes = lambda init, *args: jax.eval_shape(lambda: init(key, *args)["params"])
    return {
        "diffuser": jax.eval_shape(jsys.model.init_params, key),
        "vae": {"image": shapes(jsys.vae["image"].init, zeros(1, image_size, image_size, 3)),
                "text": jax.eval_shape(jsys.vae["text"].init_params, key)},
        "ctx": {"image": shapes(jsys.ctx["image"].init, zeros(1, sz, sz, 3)),
                "text": shapes(jsys.ctx["text"].init,
                               zeros(1, jsys.ctx["text"].max_len, dt=jnp.int32))}}


@pytest.fixture(scope="module")
def systems():
    return tiny_systems_from_port()


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    flash_attention.launches = gn_silu.launches = 0
    yield
    assert flash_attention.launches == 0 and gn_silu.launches == 0


def _image(seed, h, w):
    return np.random.RandomState(seed).rand(1, h, w, 3).astype(np.float32)


# f32 vision tower, LayerNorms and projection: summation order only
def test_clip_image_context_parity(systems):
    jsys, psys, _ = systems
    rs = np.random.RandomState(3)
    px = rs.randn(2, 56, 56, 3).astype(np.float32)
    ref = np.asarray(jsys.ctx["image"].apply({"params": jsys.params["ctx"]["image"]},
                                             jnp.asarray(px)))
    with torch.no_grad():
        out = psys.ctx["image"](torch.from_numpy(px)).numpy()
    assert out.shape == ref.shape == (2, 17, 96)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    # through ctx_encode: a raw non-square image, resized and cropped first
    img = _image(4, 50, 71)
    np.testing.assert_allclose(psys.ctx_encode(img, "image").numpy(),
                               np.asarray(jsys.ctx_encode(img, "image")), atol=1e-5, rtol=1e-5)


# separable weight matrices built as jax.image.scale_and_translate builds
# them: f32 rounding of the weights and of the two contractions only
@pytest.mark.parametrize("h,w,size", [(37, 53, 56), (517, 389, 224), (71, 50, 224),
                                      (300, 301, 56)])
def test_preprocess_images_matches_jax(h, w, size):
    x = _image(h, h, w)
    ref = np.asarray(jclip.preprocess_images(jnp.asarray(x), size))
    out = preprocess_images(torch.from_numpy(x), size).numpy()
    assert out.shape == ref.shape == (1, size, size, 3)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("h,w,hw", [(37, 53, (64, 64)), (517, 389, (64, 96)),
                                    (64, 64, (64, 64)), (33, 95, (47, 31)), (600, 451, (512, 512))])
def test_regularize_image_matches_jax(h, w, hw):
    x = _image(w, h, w)
    ref = np.asarray(japi.regularize_image(jnp.asarray(x), hw))
    out = regularize_image(torch.from_numpy(x), hw).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


# the KL encoder, f32 convs and GroupNorms: summation order only
def test_vae_posterior_parity(systems):
    jsys, psys, _ = systems
    x = np.random.RandomState(6).rand(2, 64, 64, 3).astype(np.float32)
    ref = np.asarray(jsys.vae_encode(x, "image"))
    out = psys.vae_encode(torch.from_numpy(x), "image").numpy()
    assert out.shape == ref.shape == (2, 32, 32, 4)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)


def test_diagonal_gaussian_matches_jax():
    rs = np.random.RandomState(7)
    moments = (rs.randn(2, 5, 5, 8) * 20).astype(np.float32)   # logvar beyond the clamp
    ref = JDiagonalGaussian(jnp.asarray(moments))
    post = DiagonalGaussian(torch.from_numpy(moments))
    for name in ("mean", "logvar", "std"):
        np.testing.assert_allclose(getattr(post, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-6, err_msg=name)
    assert float(post.logvar.min()) == -30.0 and float(post.logvar.max()) == 20.0
    np.testing.assert_array_equal(post.mode().numpy(), np.asarray(ref.mode()))
    noise = torch.randn(post.mean.shape, generator=torch.Generator().manual_seed(1))
    sample = post.sample(torch.Generator().manual_seed(1))
    torch.testing.assert_close(sample, post.mean + post.std * noise, atol=0, rtol=0)
    nchw = DiagonalGaussian(torch.from_numpy(moments).permute(0, 3, 1, 2), channel_axis=1)
    torch.testing.assert_close(nchw.mode().permute(0, 2, 3, 1), post.mode(), atol=0, rtol=0)


# thin SVD on both sides; singular vectors differ in sign between the
# libraries but each rank's u s v^T does not: f32 rounding of the SVD. The
# [2, 16, 96] case has fewer tokens than q = 20 ranks (the tiny config's
# image context), the [1, 40, 48] case more
@pytest.mark.parametrize("shape", [(2, 16, 96), (1, 40, 48)])
@pytest.mark.parametrize("lvl", [0.0, 0.3, 0.5, 0.7, 1.0])
def test_adjust_rank_matches_jax(shape, lvl):
    x = np.random.RandomState(8).randn(*shape).astype(np.float32)
    ref = np.asarray(jpost.AdjustRank(max_drop_rank=(1, 5), q=20)(jnp.asarray(x), lvl))
    out = postprocess.AdjustRank(max_drop_rank=(1, 5), q=20)(torch.from_numpy(x), lvl).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
    if lvl != 0.5:
        assert np.abs(out - x).max() > 1e-2   # the filter did something


def test_color_adjust_simple_matches_jax():
    rs = np.random.RandomState(9)
    out = rs.rand(2, 16, 12, 3).astype(np.float32) ** 2
    ref_img = rs.rand(1, 16, 12, 3).astype(np.float32)
    want = np.asarray(jpost.color_adjust_simple(jnp.asarray(out), jnp.asarray(ref_img)))
    got = postprocess.color_adjust_simple(torch.from_numpy(out), torch.from_numpy(ref_img))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("k", [25, 1])
def test_x0_init_matches_jax(systems, k):
    """q_sample of x0 at the k-th ascending timestep with injected noise, and
    the tables cut to their k lowest rows."""
    jsys, psys, _ = systems
    rs = np.random.RandomState(10)
    x0, noise = (rs.randn(2, 8, 8, 4).astype(np.float32) for _ in range(2))
    info = {"type": "image", "x0": x0, "x0_forward_timesteps": k, "noise": noise}
    jt = JDDIMTables.create(jsys.model.schedule, 50, 0.0)
    x_j, tj = JDDIMSampler(jsys.model)._x_init(jax.random.PRNGKey(0), x0.shape, info, jt,
                                               jnp.float32)
    pt = DDIMTables.create(psys.model.schedule, 50, 0.0)
    x_p, tp = psys.sampler.x0_init(None, x0.shape, info, pt, torch.float32, "cpu")
    np.testing.assert_allclose(x_p.numpy(), np.asarray(x_j), atol=1e-6, rtol=1e-6)
    assert len(tp.timesteps) == k
    np.testing.assert_array_equal(tp.timesteps, np.asarray(tj.timesteps))
    for name in ("alphas", "alphas_prev", "sigmas", "sqrt_one_minus_alphas"):
        np.testing.assert_allclose(getattr(tp, name), np.asarray(getattr(tj, name)),
                                   rtol=1e-6, err_msg=name)


# f32 end to end, 4 DDIM steps at CFG 7.5 as the t2i slice (1e-4): the
# guidance amplifies per-call summation-order differences
@pytest.mark.parametrize("fid,fcs,clr", [(0.0, 0.5, None), (0.5, 0.3, "Simple")])
def test_i2i_slice_parity(systems, fid, fcs, clr, monkeypatch):
    jsys, psys, _ = systems
    kw = dict(output_dim=(64, 64), ddim_steps=4, n_sample_image=2, latent_downsample=2)
    image = _image(11, 50, 70)
    seed = 3
    draw = torch.randn((2, 32, 32, 4), generator=torch.Generator().manual_seed(seed))
    jvdi = japi.VDInference(jsys, **kw)
    inner = jvdi._sample

    def sample(key, shape, x_info, c_info):   # the port's draw, as x_T or as x0's noise
        x_info = dict(x_info, **({"noise": draw.numpy()} if "x0" in x_info
                                 else {"xt": draw.numpy()}))
        return inner(key, shape, x_info, c_info)

    monkeypatch.setattr(jvdi, "_sample", sample)
    ref = np.asarray(jvdi.inference_i2i(image, fid, fcs, clr, seed))
    out = VDInference(psys, **kw).inference_i2i(image, fid, fcs, clr, seed)
    assert tuple(out.shape) == ref.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)
    resized = np.asarray(japi.regularize_image(jnp.asarray(image), (64, 64)))
    assert np.abs(ref - resized).max() > 1e-2   # not the fid_lvl 1 short-circuit


def test_i2i_fid_one_returns_the_resized_image(systems):
    _, psys, _ = systems
    image = _image(12, 40, 90)
    out = VDInference(psys, output_dim=(64, 64), latent_downsample=2).inference_i2i(
        image, 1.0, 0.5, None, 0)
    ref = np.asarray(japi.regularize_image(jnp.asarray(image), (64, 64)))
    np.testing.assert_allclose(out.numpy(), np.repeat(ref, 2, axis=0), atol=1e-5, rtol=1e-5)
