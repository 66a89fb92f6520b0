"""The multi-context flows (``inference_dcg``, ``inference_tcg``,
``inference_mcg``), port against the JAX package, on the tiny config in
f32: the bilinear resize, the masked CLIP image context, the multi-context
walk under attention and layer mixing, the multi-context DDIM sampler, the
three flows end to end, and a dual-context request under token merging.

Both systems carry the same weights (``test_torch_i2i.tiny_systems_from_port``).
The two packages draw different random numbers from one seed, so the JAX
side's sampler is handed the port's x_T (the port draws it from
``torch.Generator(seed)``); nothing else is patched.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _tiny import det_tokenizer
from test_torch_i2i import tiny_systems_from_port
from vdtpu.models import clip as jclip
from vdtpu.ops import tome as jtome
from vdtpu.serving import api as japi
from vdtpu_torch.models.clip import vision_token_mask
from vdtpu_torch.ops.flash import flash_attention
from vdtpu_torch.ops.gn_silu import gn_silu
from vdtpu_torch.ops.resize import resize
from vdtpu_torch.serving.api import VDInference, regularize_image

torch.set_num_threads(2)

KW = dict(output_dim=(64, 64), ddim_steps=4, n_sample_image=2, latent_downsample=2)
LATENT = (2, 32, 32, 4)


@pytest.fixture(scope="module")
def systems():
    return tiny_systems_from_port()


@pytest.fixture(autouse=True)
def _restore_jax_tome_and_no_launches():
    flash_attention.launches = gn_silu.launches = 0
    yield
    jtome.set_tome(None)
    assert flash_attention.launches == 0 and gn_silu.launches == 0


def _rand(seed, *shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _mask(seed, h, w):
    """A seeded rectangle of ones on zeros, [1, h, w, 1]."""
    rs = np.random.RandomState(seed)
    m = np.zeros((1, h, w, 1), np.float32)
    top, left = rs.randint(0, h // 2), rs.randint(0, w // 2)
    m[:, top:top + h // 3, left:left + w // 2] = 1.0
    return m


# the weight matrices built as jax.image.scale_and_translate builds them with
# the triangle kernel: f32 rounding of the weights and the two contractions
@pytest.mark.parametrize("h,w,c,hw", [(37, 53, 3, (64, 64)), (517, 389, 1, (64, 96)),
                                      (50, 70, 1, (64, 64)), (512, 512, 1, (224, 224)),
                                      (33, 95, 3, (47, 31))])
def test_bilinear_resize_matches_jax(h, w, c, hw):
    # noise on a ramp from -0.5 to 1.5 across the width: bilinear is not clamped
    x = _rand(h + w, 1, h, w, c) * 0.2 + np.linspace(-0.5, 1.5, w, dtype=np.float32)[:, None]
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, *hw, c), "bilinear"))
    np.testing.assert_allclose(resize(torch.from_numpy(x), hw, "bilinear").numpy(), ref,
                               atol=1e-5, rtol=1e-5)
    ref = np.asarray(japi.regularize_image(jnp.asarray(x), hw, "bilinear"))
    out = regularize_image(torch.from_numpy(x), hw, "bilinear").numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    assert out.min() < 0.0 or out.max() > 1.0


def test_vision_token_mask_matches_jax():
    m = np.concatenate([_mask(1, 56, 56), _rand(2, 1, 56, 56, 1) * 1.4 - 0.2])
    ref = np.asarray(jclip.vision_token_mask(jnp.asarray(m), patch=14))
    out = vision_token_mask(torch.from_numpy(m), 14).numpy()
    assert out.shape == ref.shape == (2, 17, 1)
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)


# f32 vision tower with the mask applied twice: summation order only
def test_masked_ctx_encode_matches_jax(systems):
    jsys, psys, _ = systems
    img = _rand(3, 1, 64, 64, 3)
    m = 1.0 - _mask(4, 64, 64)                       # at 64^2, resized to the encoder's 56^2
    ref = np.asarray(jsys.ctx_encode(img, "image", masks=m))
    out = psys.ctx_encode(img, "image", masks=m).numpy()
    assert out.shape == ref.shape == (1, 17, 96)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    assert np.abs(out - psys.ctx_encode(img, "image").numpy()).max() > 1e-2


def _walk_inputs(x_type, n_ctx):
    rs = np.random.RandomState(5 + n_ctx)
    x = rs.randn(*((2, 32, 32, 4) if x_type == "image" else (2, 96))).astype(np.float32)
    t = np.array([10, 700], np.int32)
    ctxs = [rs.randn(2, m, 96).astype(np.float32) for m in (16, 17, 34)[:n_ctx]]
    return x, t, ctxs, ["text", "image", "image"][:n_ctx]


def _jax_walk(jsys, x, t, ctxs, ratios, x_type, c_types, **kw):
    """vdtpu's multi-context walk under one jit (its eager first call costs
    about three times the compile)."""
    walk = jax.jit(lambda p, x, t, cs: jsys.model.apply_model_multicontext(
        p, x, t, cs, ratios, x_type, c_types, **kw))
    return np.asarray(walk(jsys.params["diffuser"], x, t, [jnp.asarray(c) for c in ctxs]))


def _port_walk(psys, x, t, ctxs, *args, **kw):
    xp = torch.from_numpy(x)
    xp = xp.permute(0, 3, 1, 2) if xp.dim() == 4 else xp
    with torch.no_grad():
        out = psys.model.apply_model_multicontext(
            xp.contiguous(), torch.from_numpy(t).long(), [torch.from_numpy(c) for c in ctxs],
            *args, **kw)
    return (out.permute(0, 2, 3, 1) if out.dim() == 4 else out).numpy()


# f32 walks through the same blocks: summation order only (as the
# single-context walk parity, 2e-5)
@pytest.mark.parametrize("x_type,n_ctx", [("image", 2), ("image", 3), ("text", 2)])
def test_attention_mixing_matches_jax(systems, x_type, n_ctx):
    jsys, psys, _ = systems
    x, t, ctxs, c_types = _walk_inputs(x_type, n_ctx)
    ratios = [2.0, 1.0, 0.5][:n_ctx]                  # normalized inside the walk
    ref = _jax_walk(jsys, x, t, ctxs, ratios, x_type, c_types)
    out = _port_walk(psys, x, t, ctxs, ratios, x_type, c_types)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("x_type", ["image", "text"])
def test_layer_mixing_matches_jax(systems, x_type):
    jsys, psys, _ = systems
    x, t, ctxs, c_types = _walk_inputs(x_type, 3)
    choices = [2, 0, 1, 1, 2, 0, 2]
    assert len(choices) == psys.model.num_context_slots(x_type)
    ref = _jax_walk(jsys, x, t, ctxs, [1.0, 1.0, 1.0], x_type, c_types, mixing_type="layer",
                    layer_choices=jnp.asarray(choices))
    out = _port_walk(psys, x, t, ctxs, [1.0, 1.0, 1.0], x_type, c_types,
                     mixing_type="layer", layer_choices=choices)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)
    other = _port_walk(psys, x, t, ctxs, [1.0, 1.0, 1.0], x_type, c_types,
                       mixing_type="layer", layer_choices=[0] * len(choices))
    assert np.abs(out - other).max() > 1e-3          # the choices matter


@pytest.mark.parametrize("x_type,c_type", [("image", "text"), ("image", "image"),
                                           ("text", "image")])
def test_one_context_walk_equals_apply_flow(systems, x_type, c_type):
    _, psys, _ = systems
    x, t, ctxs, _ = _walk_inputs(x_type, 1)
    xp = torch.from_numpy(x)
    xp = (xp.permute(0, 3, 1, 2) if xp.dim() == 4 else xp).contiguous()
    with torch.no_grad():
        single = psys.model.apply_model(xp, torch.from_numpy(t).long(),
                                        torch.from_numpy(ctxs[0]), x_type, c_type)
    out = _port_walk(psys, x, t, ctxs, [0.3], x_type, [c_type])
    back = single.permute(0, 2, 3, 1) if single.dim() == 4 else single
    assert np.array_equal(out, back.numpy())


def test_context_slots_and_layer_choices(systems):
    jsys, psys, _ = systems
    for x_type in ("image", "text"):
        assert psys.model.num_context_slots(x_type) == jsys.model.num_context_slots(x_type)
    draw = lambda seed, ratios: psys.model.sample_layer_choices(
        torch.Generator().manual_seed(seed), ratios, "image")
    a = draw(3, [0.2, 0.5, 0.3])
    assert a.shape == (psys.model.num_context_slots("image"),) and a.dtype == torch.long
    assert torch.equal(a, draw(3, [0.2, 0.5, 0.3]))
    seen = torch.cat([draw(s, [2.0, 0.0, 1.0]) for s in range(40)])
    assert set(seen.tolist()) == {0, 2}              # never the context of ratio 0


def _c_infos(scale=7.5):
    rs = np.random.RandomState(6)
    out = []
    for c_type, m, ratio in (("text", 16, 0.6), ("image", 34, 0.4)):
        c = (rs.randn(2, m, 96) * 0.3).astype(np.float32)
        out.append({"type": c_type, "conditioning": c, "unconditional_conditioning": c * 0,
                    "unconditional_guidance_scale": scale, "ratio": ratio})
    return out


def _torch_infos(c_infos):
    return [{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
             for k, v in ci.items()} for ci in c_infos]


# f32, 4 DDIM steps at CFG 7.5, as test_t2i_slice_parity (1e-4)
def test_sample_multicontext_matches_jax(systems):
    jsys, psys, _ = systems
    xt = np.random.RandomState(7).randn(*LATENT).astype(np.float32)
    c_infos = _c_infos()
    z_j = np.asarray(jsys.sampler.sample_multicontext(
        jsys.params["diffuser"], jax.random.PRNGKey(0), 4, xt.shape,
        {"type": "image", "xt": xt}, c_infos))
    z_p = psys.sampler.sample_multicontext(None, 4, xt.shape, {"type": "image", "xt": xt},
                                           _torch_infos(c_infos), device="cpu")
    np.testing.assert_allclose(z_p.numpy(), z_j, atol=1e-4, rtol=1e-4)
    img_j = np.asarray(jsys.vae_decode(z_j, "image"))
    np.testing.assert_allclose(psys.vae_decode(z_p, "image").numpy(), img_j, atol=1e-4,
                               rtol=1e-4)


def test_one_context_sample_multicontext_equals_sample(systems):
    _, psys, _ = systems
    c_info = _torch_infos(_c_infos())[1]
    run = lambda fn, info: fn(torch.Generator().manual_seed(4), 4, LATENT, {"type": "image"},
                              info, eta=0.7, device="cpu")
    single = run(psys.sampler.sample, c_info)
    multi = run(psys.sampler.sample_multicontext, [c_info])
    assert torch.equal(single, multi)


def test_mixed_guidance_scales_raise(systems):
    jsys, psys, _ = systems
    c_infos = _c_infos()
    c_infos[1]["unconditional_guidance_scale"] = 5.0
    with pytest.raises(ValueError, match="guidance scale"):
        jsys.sampler.sample_multicontext(jsys.params["diffuser"], jax.random.PRNGKey(0), 4,
                                         LATENT, {"type": "image"}, c_infos)
    with pytest.raises(ValueError, match="guidance scale"):
        psys.sampler.sample_multicontext(None, 4, LATENT, {"type": "image"},
                                         _torch_infos(c_infos), device="cpu")


def test_mcg_without_an_image_raises(systems):
    jsys, psys, _ = systems
    ctxs = [None, {"image": None, "strength": 1.0}]
    with pytest.raises(ValueError):
        japi.VDInference(jsys, text_tokenizer=det_tokenizer, **KW).inference_mcg(
            ctxs, "a red cat", 0.5, 0)
    with pytest.raises(ValueError, match="image"):
        VDInference(psys, text_tokenizer=det_tokenizer, **KW).inference_mcg(
            ctxs, "a red cat", 0.5, 0)


def _jax_vdi(jsys, seed, monkeypatch):
    """vdtpu's VDInference, its multi-context sampler started at the port's x_T."""
    jvdi = japi.VDInference(jsys, text_tokenizer=det_tokenizer, **KW)
    inner = jvdi._sample_multi
    draw = torch.randn(LATENT, generator=torch.Generator().manual_seed(seed)).numpy()
    monkeypatch.setattr(jvdi, "_sample_multi", lambda key, shape, x_info, c_infos: inner(
        key, shape, dict(x_info, xt=draw), c_infos))
    return jvdi


def _images():
    return [_rand(11, 1, 50, 70, 3), _rand(12, 1, 64, 64, 3), _rand(13, 1, 80, 60, 3)]


def _flow(name, images):
    """(call of a VDInference, inputs shown expected) of each flow's request."""
    if name == "dcg":
        return lambda vdi: vdi.inference_dcg(images[0], 0.3, "a red cat", 0.5, 3), None
    if name == "tcg":
        ctxs = [{"image": images[0], "strength": 0.8, "fcs_lvl": 0.4},
                {"image": images[1], "mask": _mask(14, 50, 70), "fcs_lvl": 0.6},
                {"image": images[2]}]                # cut: tcg keeps two
        return lambda vdi: vdi.inference_tcg(ctxs, "a red cat", 0.3, 3), 2
    ctxs = [{"image": images[0], "fcs_lvl": 0.7}, None,
            {"image": images[1], "mask": _mask(15, 64, 64), "strength": 0.6},
            {"image": images[2], "strength": 1.3}]
    return lambda vdi: vdi.inference_mcg(ctxs, None, 0.5, 3), 3


# f32 end to end, 4 DDIM steps at CFG 7.5, as the t2i and i2i slices (1e-4)
@pytest.mark.parametrize("name", ["dcg", "tcg", "mcg"])
def test_flow_matches_jax(systems, name, monkeypatch):
    jsys, psys, _ = systems
    call, n_shown = _flow(name, _images())
    ref = call(_jax_vdi(jsys, 3, monkeypatch))
    out = call(VDInference(psys, text_tokenizer=det_tokenizer, **KW))
    if n_shown is not None:
        (ref_shown, ref), (shown, out) = ref, out
        assert len(shown) == len(ref_shown) == n_shown
        for a, b in zip(shown, ref_shown):
            assert tuple(a.shape) == (1, 64, 64, 3)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    ref = np.asarray(ref)
    assert tuple(out.shape) == ref.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


# both packages merge the same tokens at the 1024-token site (one merge a
# walk, shared by the two context stacks); f32 summation order otherwise
def test_dcg_with_tome_matches_jax(systems, monkeypatch):
    jsys, psys, _ = systems
    call, _ = _flow("dcg", _images())
    jsys.enable_tome(0.5, min_tokens=1024)
    ref = np.asarray(call(_jax_vdi(jsys, 3, monkeypatch)))
    vdi = VDInference(psys, text_tokenizer=det_tokenizer, **KW)
    psys.enable_tome(0.5, min_tokens=1024)
    try:
        out = call(vdi).numpy()
    finally:
        psys.enable_tome(0)
    assert np.abs(out - call(vdi).numpy()).max() > 1e-3   # merging changed the result
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
