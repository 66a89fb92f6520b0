"""The text-to-image slice, port against the JAX package, on the tiny config.

One JAX ``VDSystem("vd_test_tiny")`` with the weights of ``init_random(0,
image_size=64)`` for the parts the port builds (every part since the
Optimus text VAE was ported) exports its checkpoint; every all-zero array in it
is replaced by seeded normals (std 0.02), as
``tests/_reference.py::derandomize_zeros`` does, because a zero-initialized
output conv makes the UNet output identically zero. The result loads into
JAX and into the port with ``strict=True``. Then the same token ids and
the same numpy x_T go through both samplers (f32, 64^2 output,
latent_downsample 2, n = 2, 4 DDIM steps, CFG 7.5) and both VAE decoders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _tiny import det_tokenizer
from vdtpu.serving.api import VDSystem as JVDSystem
from vdtpu_torch.interop.from_jax import system_state_dict_from_jax
from vdtpu_torch.ops.flash import flash_attention
from vdtpu_torch.ops.gn_silu import gn_silu
from vdtpu_torch.serving.api import VDInference, VDSystem

torch.set_num_threads(2)

PROMPT = "a red cat"


def _jax_init(jsys, seed: int = 0, image_size: int = 64):
    """``init_random(seed, image_size)`` of the parts the port builds (the
    diffusers, the image and text VAEs, both context encoders): the same
    keys, each init under ``jax.jit``, which gives the same arrays as the
    eager init in about half its time."""
    kd, kv, kc1, kc2, kt = jax.random.split(jax.random.PRNGKey(seed), 5)
    x = jnp.zeros((1, image_size, image_size, 3))
    ids = jnp.zeros((1, jsys.ctx["text"].max_len), jnp.int32)
    sz = jsys.ctx["image"].image_size
    px = jnp.zeros((1, sz, sz, 3))
    jsys.params["diffuser"] = jax.jit(jsys.model.init_params)(kd)
    jsys.params["vae"]["image"] = jax.jit(lambda k: jsys.vae["image"].init(k, x))(kv)["params"]
    jsys.params["vae"]["text"] = jax.jit(jsys.vae["text"].init_params)(kt)
    jsys.params["ctx"] = {
        "image": jax.jit(lambda k: jsys.ctx["image"].init(k, px))(kc1)["params"],
        "text": jax.jit(lambda k: jsys.ctx["text"].init(k, ids))(kc2)["params"]}
    return jsys


def build_tiny_systems():
    """(JAX system, port system on the CPU, the shared checkpoint): the
    tiny config's JAX init, its all-zero arrays replaced by seeded
    normals, loaded into both with strict=True."""
    jsys = _jax_init(JVDSystem("vd_test_tiny"))
    sd = jsys.export_torch_checkpoint()
    rs = np.random.RandomState(0)
    sd = {k: (rs.normal(0, 0.02, np.shape(sd[k])).astype(np.float32)
              if not np.any(sd[k]) else np.asarray(sd[k], np.float32)) for k in sorted(sd)}
    jsys.load_torch_checkpoint(sd, strict=True)
    psys = VDSystem("vd_test_tiny", device="cpu")
    result = psys.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    return jsys, psys, sd


@pytest.fixture(scope="module")
def systems():
    return build_tiny_systems()


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    flash_attention.launches = gn_silu.launches = 0
    yield
    assert flash_attention.launches == 0 and gn_silu.launches == 0


def test_state_dict_from_jax_matches_export(systems):
    jsys, _, sd = systems
    ours = system_state_dict_from_jax(jax.device_get(jsys.params))
    assert sorted(ours) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(ours[k], sd[k], err_msg=k)


def test_port_builds_every_key_of_its_prefixes(systems):
    _, psys, sd = systems
    own = set(psys.net.state_dict())
    assert own == {k for k in sd if k.startswith(VDSystem.PREFIXES)}
    assert any(k.startswith("diffuser.text.data_blocks") for k in own)


def test_load_jax_params_equals_checkpoint(systems):
    jsys, _, sd = systems
    psys = VDSystem("vd_test_tiny", device="cpu")
    psys.load_jax_params(jax.device_get(jsys.params), strict=True)
    for k, v in psys.net.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


def _contexts(jsys, psys, n=2):
    out = []
    for text in ("", PROMPT):
        ids = det_tokenizer([text])
        jc = np.asarray(jsys.ctx_encode(ids, "text"))
        pc = psys.ctx_encode(ids, "text").numpy()
        out.append((np.repeat(jc, n, axis=0), np.repeat(pc, n, axis=0)))
    return out


# f32 CLIP text tower: summation order only (measured max 2.4e-7)
def test_text_context_parity(systems):
    jsys, psys, _ = systems
    for jc, pc in _contexts(jsys, psys):
        np.testing.assert_allclose(pc, jc, atol=1e-5, rtol=1e-5)


def test_text_diffuser_walk_parity(systems):
    """The (text, text) flow: FC blocks, the 0-D tokenization and _Out0D."""
    jsys, psys, _ = systems
    rs = np.random.RandomState(5)
    x = rs.randn(2, 96).astype(np.float32)
    t = np.array([10, 700], np.int32)
    ctx = rs.randn(2, 16, 96).astype(np.float32)
    ref = jsys.model.apply_model(jsys.params["diffuser"], x, t, ctx, "text", "text")
    with torch.no_grad():
        out = psys.model.apply_model(torch.from_numpy(x), torch.from_numpy(t).long(),
                                     torch.from_numpy(ctx), "text", "text")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


# f32 end to end, tolerance 1e-4: 4 guided steps amplify the
# per-call summation-order differences by the guidance scale 7.5 (measured
# max 1.6e-5 on latents up to 18, 1.7e-6 on the decoded image)
def test_t2i_slice_parity(systems):
    jsys, psys, _ = systems
    (ju, pu), (jc, pc) = _contexts(jsys, psys)
    xt = np.random.RandomState(1).randn(2, 32, 32, 4).astype(np.float32)
    c_j = {"type": "text", "conditioning": jc, "unconditional_conditioning": ju,
           "unconditional_guidance_scale": 7.5}
    z_j = np.asarray(jsys.sampler.sample(
        jsys.params["diffuser"], jax.random.PRNGKey(0), 4, xt.shape,
        {"type": "image", "xt": xt}, c_j))
    img_j = np.asarray(jsys.vae_decode(z_j, "image"))
    c_p = {"type": "text", "conditioning": torch.from_numpy(pc),
           "unconditional_conditioning": torch.from_numpy(pu),
           "unconditional_guidance_scale": 7.5}
    z_p = psys.sampler.sample(None, 4, xt.shape, {"type": "image", "xt": xt}, c_p,
                              device="cpu")
    img_p = psys.vae_decode(z_p, "image")
    assert z_p.shape == z_j.shape and img_p.shape == img_j.shape == (2, 64, 64, 3)
    assert np.abs(z_j - xt).max() > 0.1           # the sampler moved the latent
    np.testing.assert_allclose(z_p.numpy(), z_j, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(img_p.numpy(), img_j, atol=1e-4, rtol=1e-4)


def test_noise_injection_parity(systems):
    """eta > 0 with one injected noise table (numpy, NHWC) on both sides,
    temperature 0.7: the noise term of the DDIM update."""
    jsys, psys, _ = systems
    (ju, pu), (jc, pc) = _contexts(jsys, psys)
    rs = np.random.RandomState(2)
    xt = rs.randn(2, 32, 32, 4).astype(np.float32)
    table = rs.randn(4, 2, 32, 32, 4).astype(np.float32)   # one row per step
    z_j = np.asarray(jsys.sampler.sample(
        jsys.params["diffuser"], jax.random.PRNGKey(0), 4, xt.shape,
        {"type": "image", "xt": xt},
        {"type": "text", "conditioning": jc, "unconditional_conditioning": ju,
         "unconditional_guidance_scale": 7.5}, eta=0.5, temperature=0.7, noise_table=table))
    z_p = psys.sampler.sample(
        None, 4, xt.shape, {"type": "image", "xt": xt},
        {"type": "text", "conditioning": pc, "unconditional_conditioning": pu,
         "unconditional_guidance_scale": 7.5}, eta=0.5, temperature=0.7, noise_table=table,
        device="cpu")
    np.testing.assert_allclose(z_p.numpy(), z_j, atol=1e-4, rtol=1e-4)


def test_noise_dropout_draws_from_the_generator(systems):
    """Noise dropout has no JAX-comparable draw (jax.random vs torch): it
    must be seeded by the caller's generator and change the result."""
    _, psys, _ = systems
    u, c = (psys.ctx_encode(det_tokenizer([t]), "text").repeat(2, 1, 1) for t in ("", PROMPT))
    c = {"type": "text", "conditioning": c, "unconditional_conditioning": u,
         "unconditional_guidance_scale": 7.5}
    run = lambda p: psys.sampler.sample(torch.Generator().manual_seed(3), 4, (2, 32, 32, 4),
                                        {"type": "image"}, c, eta=1.0, noise_dropout=p,
                                        device="cpu")
    a, b = run(0.5), run(0.5)
    assert torch.equal(a, b) and not torch.equal(a, run(0.0))


def test_inference_t2i_runs_on_cpu(systems):
    _, psys, _ = systems
    vdi = VDInference(psys, text_tokenizer=det_tokenizer, output_dim=(64, 64),
                      ddim_steps=4, n_sample_image=2, latent_downsample=2)
    out = vdi.inference_t2i(PROMPT, seed=0)
    assert tuple(out.shape) == (2, 64, 64, 3)
    assert bool(torch.isfinite(out).all())
    assert 0.0 <= float(out.min()) and float(out.max()) <= 1.0
    assert torch.equal(out, vdi.inference_t2i(PROMPT, seed=0))
    assert not torch.equal(out, vdi.inference_t2i(PROMPT, seed=1))


def test_system_refuses_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VDSystem("vd_test_tiny")
