"""The sampler modes (DPM-Solver++(2M), encoder reuse, the cfg interval and
the DDIM intermediates), port against the JAX package, on the tiny config
in f32: the solver's tables and loop, the encoder-reuse schedule, the
UNet's split walk (single- and multi-context, both mixings), ``sample``
and ``sample_multicontext`` under each mode and each composition the JAX
package allows, ``VDInference``'s knobs on the t2i, i2i (x0 start), t2t
and dcg flows, a token-merging request under encoder reuse, and every
combination the JAX package refuses.

Both systems carry the same weights (``test_torch_i2i.tiny_systems_from_port``).
At eta 0 the port draws nothing after x_T; the JAX side is handed the
port's x_T (and the x0 start's noise), directly or by patching its
``VDInference._sample`` / ``_sample_multi``. Latents at 16^2 (the 32^2
images of the flows), 4 steps: 4 model calls of CFG 7.5, where the
guidance amplifies per-call summation-order differences, so whole samples
are held at relative L2 <= 1e-4, as the text flows are.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _tiny import det_tokenizer
from test_torch_i2i import tiny_systems_from_port
from vdtpu.ops import tome as jtome
from vdtpu.ops.schedules import DiffusionSchedule as JDiffusionSchedule
from vdtpu.sampling import ddim as jddim
from vdtpu.sampling import dpmpp as jdpmpp
from vdtpu.serving import api as japi
from vdtpu_torch.ops.flash import flash_attention
from vdtpu_torch.ops.gn_silu import gn_silu
from vdtpu_torch.ops.schedules import DiffusionSchedule
from vdtpu_torch.sampling import ddim, dpmpp
from vdtpu_torch.serving.api import VDInference

torch.set_num_threads(2)

STEPS = 4
LATENT = (2, 16, 16, 4)
KW = dict(text_tokenizer=det_tokenizer, output_dim=(32, 32), ddim_steps=STEPS,
          n_sample_image=2, n_sample_text=4, latent_downsample=2, text_latent_dim=96)
REUSE = {"interval": 2, "warmup": 1}     # key steps 0 and 2 of 4


@pytest.fixture(scope="module")
def systems():
    return tiny_systems_from_port()


@pytest.fixture(autouse=True)
def _restore_jax_tome_and_no_launches():
    flash_attention.launches = gn_silu.launches = 0
    yield
    jtome.set_tome(None)
    assert flash_attention.launches == 0 and gn_silu.launches == 0


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _schedules():
    args = (1000, "linear", 0.00085, 0.012)
    return JDiffusionSchedule.create(*args), DiffusionSchedule.create(*args)


# ---- tables and loops ----

@pytest.mark.parametrize("steps,truncate,lof", [(20, None, None), (10, None, None),
                                                (50, 25, None), (14, None, False),
                                                (30, 7, True), (1, None, None)])
def test_dpmpp_tables_equal_jax(steps, truncate, lof):
    js, ps = _schedules()
    want = jdpmpp.DPMppTables.create(js, steps, truncate=truncate, lower_order_final=lof)
    got = dpmpp.DPMppTables.create(ps, steps, truncate=truncate, lower_order_final=lof)
    for name in ("timesteps", "alphas", "sigmas", "sigma_ratio", "alpha_phi", "w2"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    for a, b in ((0, 3), (2, len(got.timesteps))):
        cut, ref = dpmpp.slice_tables(got, a, b), jdpmpp.slice_tables(want, a, b)
        np.testing.assert_array_equal(cut.w2, ref.w2)
        np.testing.assert_array_equal(cut.timesteps, ref.timesteps)


@pytest.mark.parametrize("steps", [4, 20, 50])
@pytest.mark.parametrize("interval,warmup", [(2, 5), (3, 0), (1, 5), (4, 2), (2, 60)])
def test_encoder_reuse_schedule_equals_jax(steps, interval, warmup):
    got = ddim.encoder_reuse_schedule(steps, interval, warmup)
    np.testing.assert_array_equal(got, jddim.encoder_reuse_schedule(steps, interval, warmup))
    assert got[0]


def test_ddim_slice_tables_equal_jax():
    js, ps = _schedules()
    want = jddim.DDIMTables.create(js, 20, 0.3)
    got = ddim.DDIMTables.create(ps, 20, 0.3)
    for a, b in ((0, 5), (5, 17), (17, 20)):
        cut, ref = ddim.slice_tables(got, a, b), jddim.slice_tables(want, a, b)
        for name in ("timesteps", "alphas", "alphas_prev", "sigmas", "sqrt_one_minus_alphas"):
            np.testing.assert_array_equal(getattr(cut, name), getattr(ref, name))


def _analytic_eps(abar, c2=4.0):
    """The exact eps of x0 ~ N(0, c2 I), for both packages' eps contracts."""
    a_j, a_t = jnp.asarray(abar, jnp.float32), torch.as_tensor(abar, dtype=torch.float32)

    def jax_eps(x, t, i):
        a = a_j[t][:, None]
        return x * jnp.sqrt(1.0 - a) / (a * c2 + (1.0 - a))

    def port_eps(x, t):
        a = a_t[t][:, None]
        return x * torch.sqrt(1.0 - a) / (a * c2 + (1.0 - a))

    return jax_eps, port_eps


# f32 elementwise updates in the same order: rounding of the sqrt and of
# the division only
@pytest.mark.parametrize("steps", [10, 20])
def test_dpmpp_loop_matches_scan_and_segments_bitwise(steps):
    js, ps = _schedules()
    jax_eps, port_eps = _analytic_eps(np.asarray(ps.alphas_cumprod, np.float64))
    x = (np.random.RandomState(steps).randn(4, 8) * 3).astype(np.float32)
    want = np.asarray(jdpmpp.dpmpp_scan(jax_eps, jnp.asarray(x),
                                        jdpmpp.DPMppTables.create(js, steps)))
    tables = dpmpp.DPMppTables.create(ps, steps)
    whole = dpmpp.dpmpp_loop(port_eps, torch.from_numpy(x), tables)
    np.testing.assert_allclose(whole.numpy(), want, atol=1e-6, rtol=1e-6)
    xs, m = torch.from_numpy(x), None
    for a, b in ((0, 3), (3, steps - 2), (steps - 2, steps)):
        xs, m = dpmpp.dpmpp_loop(port_eps, xs, dpmpp.slice_tables(tables, a, b), m_prev=m,
                                 return_carry=True)
    assert torch.equal(xs, whole)
    always = dpmpp.dpmpp_loop_encreuse(lambda x, t, use_cache, cache: (port_eps(x, t), None),
                                       torch.from_numpy(x), tables, np.ones(steps, bool))
    assert torch.equal(always, whole)


# ---- the split walk ----

def _walk_case(x_type, n_ctx, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(*((2, 16, 16, 4) if x_type == "image" else (2, 96))).astype(np.float32)
    t = np.array([10, 700], np.int32)
    ctxs = [rs.randn(2, m, 96).astype(np.float32) for m in (16, 17, 34)[:n_ctx]]
    return x, t, ctxs


def _nchw(x):
    x = torch.from_numpy(x)
    return (x.permute(0, 3, 1, 2) if x.dim() == 4 else x).contiguous()


def _nhwc(x):
    return (x.permute(0, 2, 3, 1) if x.dim() == 4 else x).numpy()


# f32 half walks through the same blocks: summation order only (as the
# whole walks' parity, 2e-5); the split equals the port's whole walk exactly
@pytest.mark.parametrize("x_type,c_types,mixing", [
    ("image", ["text"], None), ("text", ["image"], None),
    ("image", ["text", "image"], "attention"), ("text", ["text", "image", "image"], "layer")])
def test_split_walk_matches_jax(systems, x_type, c_types, mixing):
    jsys, psys, _ = systems
    x, t, ctxs = _walk_case(x_type, len(c_types), 20 + len(c_types))
    n_slots = psys.model.num_context_slots(x_type)
    choices = [i % len(c_types) for i in range(n_slots)][::-1]
    jm, pm = jsys.model, psys.model
    if mixing is None:
        def jax_halves(p, x, t, cs, cache_t):
            h, hs = jm.apply_model_encoder(p, x, cache_t, cs[0], x_type, c_types[0])
            out, _ = jm.apply_model_encreuse(p, x, t, cs[0], x_type, c_types[0], (h, hs), True)
            return h, hs, out
        port_enc = lambda x, t, cs: pm.apply_model_encoder(x, t, cs[0], x_type, c_types[0])
        port_reuse = lambda x, t, cs, cache, use: pm.apply_model_encreuse(
            x, t, cs[0], x_type, c_types[0], cache, use)
        port_full = lambda x, t, cs: pm.apply_model(x, t, cs[0], x_type, c_types[0])
    else:
        mix = dict(mixing_type=mixing, layer_choices=None if mixing == "attention" else
                   jnp.asarray(choices))
        ratios = [1.0, 0.5, 2.0][:len(c_types)]

        def jax_halves(p, x, t, cs, cache_t):
            h, hs = jm.apply_model_multicontext_encoder(p, x, cache_t, cs, ratios, x_type,
                                                        c_types, **mix)
            out, _ = jm.apply_model_multicontext_encreuse(p, x, t, cs, ratios, x_type, c_types,
                                                          (h, hs), True, **mix)
            return h, hs, out
        pmix = dict(mixing_type=mixing, layer_choices=None if mixing == "attention" else choices)
        port_enc = lambda x, t, cs: pm.apply_model_multicontext_encoder(
            x, t, cs, ratios, x_type, c_types, **pmix)
        port_reuse = lambda x, t, cs, cache, use: pm.apply_model_multicontext_encreuse(
            x, t, cs, ratios, x_type, c_types, cache, use, **pmix)
        port_full = lambda x, t, cs: pm.apply_model_multicontext(
            x, t, cs, ratios, x_type, c_types, **pmix)
    # the cache of an earlier timestep drives the decoder at the current one
    t_key = np.array([200, 900], np.int32)
    h_j, hs_j, out_j = jax.jit(jax_halves)(jsys.params["diffuser"], x, t,
                                           [jnp.asarray(c) for c in ctxs], t_key)
    xp, tp, cp = _nchw(x), torch.from_numpy(t).long(), [torch.from_numpy(c) for c in ctxs]
    with torch.no_grad():
        h, hs = port_enc(xp, torch.from_numpy(t_key).long(), cp)
        out, cache = port_reuse(xp, tp, cp, (h, hs), True)
        full = port_full(xp, tp, cp)
        own, own_cache = port_reuse(xp, tp, cp, None, False)
    assert len(hs) == len(hs_j) and cache[1] is hs
    for a, b in zip((h, *hs), (h_j, *hs_j)):
        np.testing.assert_allclose(_nhwc(a), np.asarray(b), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_nhwc(out), np.asarray(out_j), atol=1e-5, rtol=1e-5)
    assert torch.equal(own, full) and len(own_cache[1]) == len(hs)
    assert np.abs(_nhwc(out) - _nhwc(full)).max() > 1e-3      # the stale cache mattered


def test_reuse_before_a_key_step_raises(systems):
    _, psys, _ = systems
    x, t, ctxs = _walk_case("image", 1, 3)
    with pytest.raises(ValueError, match="key step"):
        psys.model.apply_model_encreuse(_nchw(x), torch.from_numpy(t).long(),
                                        torch.from_numpy(ctxs[0]), "image", "text", None, True)


# ---- sample / sample_multicontext against the JAX package ----

def _c_info(seed, c_type="text", m=16, scale=7.5, ratio=None):
    rs = np.random.RandomState(seed)
    c = (rs.randn(2, m, 96) * 0.3).astype(np.float32)
    out = {"type": c_type, "conditioning": c, "unconditional_conditioning": c * 0,
           "unconditional_guidance_scale": scale}
    if ratio is not None:
        out["ratio"] = ratio
    return out


def _torch_info(ci):
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in ci.items()}


def _xt(seed, shape=LATENT):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("modes", [dict(method="dpmpp2m"), dict(cfg_interval=(0.125, 0.625))],
                         ids=["dpmpp2m", "cfg_interval"])
def test_sample_modes_match_jax(systems, modes):
    jsys, psys, _ = systems
    xt, ci = _xt(1), _c_info(2)
    want = np.asarray(jsys.sampler.sample(jsys.params["diffuser"], jax.random.PRNGKey(0),
                                          STEPS, LATENT, {"type": "image", "xt": xt}, ci,
                                          **modes))
    got = psys.sampler.sample(None, STEPS, LATENT, {"type": "image", "xt": xt},
                              _torch_info(ci), device="cpu", **modes).numpy()
    plain = psys.sampler.sample(None, STEPS, LATENT, {"type": "image", "xt": xt},
                                _torch_info(ci), device="cpu").numpy()
    assert _rel(got, want) <= 1e-4
    assert np.abs(got - plain).max() > 1e-3                    # the mode changed the sample


# (mixing, modes, cfg band): encoder reuse, the cfg interval (0.375, 0.875)
# -> steps [2, 4) of 4 (round half to even: floor would give [1, 3)) and
# the two compositions with DPM-Solver++
@pytest.mark.parametrize("mixing,modes", [
    ("layer", dict(encoder_reuse=REUSE)),
    ("attention", dict(cfg_interval=(0.375, 0.875))),
    ("attention", dict(method="dpmpp2m", encoder_reuse=REUSE)),
    ("layer", dict(method="dpmpp2m", cfg_interval=(0.5, 1.0)))],
    ids=["encreuse-layer", "cfg_interval-attention", "dpmpp2m+encreuse-attention",
         "dpmpp2m+cfg_interval-layer"])
def test_sample_multicontext_modes_match_jax(systems, mixing, modes):
    jsys, psys, _ = systems
    xt = _xt(3)
    c_infos = [_c_info(4, "text", 16, ratio=0.6), _c_info(5, "image", 34, ratio=0.4)]
    choices = [0, 1, 1, 0, 1, 0, 0] if mixing == "layer" else None
    want = np.asarray(jsys.sampler.sample_multicontext(
        jsys.params["diffuser"], jax.random.PRNGKey(0), STEPS, LATENT,
        {"type": "image", "xt": xt}, c_infos, mixing_type=mixing,
        layer_choices=None if choices is None else jnp.asarray(choices), **modes))
    got = psys.sampler.sample_multicontext(
        None, STEPS, LATENT, {"type": "image", "xt": xt}, [_torch_info(c) for c in c_infos],
        mixing_type=mixing, layer_choices=choices, device="cpu", **modes).numpy()
    assert _rel(got, want) <= 1e-4


def test_sample_encoder_reuse_matches_jax_and_interval_one_is_exact(systems):
    """Single-context encoder reuse with DDIM (and composed with DPM-Solver++
    in the t2i flow below); interval 1 runs every encoder: plain DDIM."""
    jsys, psys, _ = systems
    xt, ci = _xt(6), _c_info(7)
    run = lambda **kw: psys.sampler.sample(None, STEPS, LATENT, {"type": "image", "xt": xt},
                                           _torch_info(ci), device="cpu", **kw)
    want = np.asarray(jsys.sampler.sample(jsys.params["diffuser"], jax.random.PRNGKey(0),
                                          STEPS, LATENT, {"type": "image", "xt": xt}, ci,
                                          encoder_reuse=REUSE))
    got = run(encoder_reuse=REUSE)
    assert _rel(got.numpy(), want) <= 1e-4
    assert torch.equal(run(encoder_reuse=1), run())
    assert np.abs(got.numpy() - run().numpy()).max() > 1e-3


def test_intermediates_match_jax(systems):
    jsys, psys, _ = systems
    ci = _c_info(8)
    x0, noise = _xt(9), _xt(10)
    info = {"type": "image", "x0": x0, "x0_forward_timesteps": 3, "noise": noise}
    x_j, inter_j = jsys.sampler.sample(jsys.params["diffuser"], jax.random.PRNGKey(0), STEPS,
                                       LATENT, info, ci, return_intermediates=True)
    x_p, inter_p = psys.sampler.sample(None, STEPS, LATENT, info, _torch_info(ci),
                                       device="cpu", return_intermediates=True)
    assert _rel(x_p.numpy(), np.asarray(x_j)) <= 1e-4
    for name in ("pred_xt", "pred_x0"):
        assert tuple(inter_p[name].shape) == np.shape(inter_j[name]) == (3, *LATENT)
        assert _rel(inter_p[name].numpy(), np.asarray(inter_j[name])) <= 1e-4
    assert torch.equal(inter_p["pred_xt"][-1], x_p)


@pytest.mark.parametrize("sampler", ["sample", "sample_multicontext"])
def test_cfg_interval_segments_share_the_generator(systems, sampler):
    """At eta 0.7: the full band is plain CFG bit for bit and an empty band
    is the conditional model alone (scale 1), both from one seed."""
    _, psys, _ = systems
    ci = _torch_info(_c_info(11))
    infos = ci if sampler == "sample" else [ci]
    single = lambda info, **kw: getattr(psys.sampler, sampler)(
        torch.Generator().manual_seed(5), STEPS, LATENT, {"type": "image"}, info, eta=0.7,
        device="cpu", **kw)
    plain = single(infos)
    assert torch.equal(single(infos, cfg_interval=(0.0, 1.0)), plain)
    cond_only = dict(ci, unconditional_guidance_scale=1.0)
    want = single(cond_only if sampler == "sample" else [cond_only])
    assert torch.equal(single(infos, cfg_interval=(0.5, 0.5)), want)
    assert not torch.equal(want, plain)
    band = single(infos, cfg_interval=(0.25, 0.75))
    assert not torch.equal(band, plain) and not torch.equal(band, want)


# ---- every combination the JAX package refuses ----

REFUSED = [
    dict(method="euler"),
    dict(method="dpmpp2m", eta=0.5),
    dict(method="dpmpp2m", noise_table=True),
    dict(method="dpmpp2m", return_intermediates=True),
    dict(encoder_reuse=2, noise_table=True),
    dict(encoder_reuse={"interval": 2, "warmup": 3}, return_intermediates=True),
    dict(cfg_interval=(0.7, 0.2)),
    dict(cfg_interval=(-0.1, 0.5)),
    dict(cfg_interval=(0.2, 1.5)),
    dict(cfg_interval=(0.2, 0.8), scale=1.0),
    dict(cfg_interval=(0.2, 0.8), uncond=None),
    dict(cfg_interval=(0.2, 0.8), encoder_reuse=2),
    dict(cfg_interval=(0.2, 0.8), noise_table=True),
    dict(cfg_interval=(0.2, 0.8), return_intermediates=True),
    dict(cfg_interval=(0.2, 0.8), method="dpmpp2m", encoder_reuse=2),
]


def _refused_call(sys_, kw, jax_side: bool, multi: bool):
    kw = dict(kw)
    ci = _c_info(12, scale=kw.pop("scale", 7.5))
    if "uncond" in kw:
        ci["unconditional_conditioning"] = kw.pop("uncond")
    if kw.pop("noise_table", False):
        kw["noise_table"] = np.zeros((STEPS, *LATENT), np.float32)
    info = {"type": "image", "xt": _xt(13)}
    if jax_side:
        if multi:
            return sys_.sampler.sample_multicontext(
                sys_.params["diffuser"], jax.random.PRNGKey(0), STEPS, LATENT, info, [ci], **kw)
        return sys_.sampler.sample(sys_.params["diffuser"], jax.random.PRNGKey(0), STEPS,
                                   LATENT, info, ci, **kw)
    fn = sys_.sampler.sample_multicontext if multi else sys_.sampler.sample
    return fn(None, STEPS, LATENT, info, [_torch_info(ci)] if multi else _torch_info(ci),
              device="cpu", **kw)


@pytest.mark.parametrize("kw", REFUSED, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_refused_combinations_raise_as_in_jax(systems, kw):
    jsys, psys, _ = systems
    with pytest.raises(ValueError):
        _refused_call(jsys, kw, True, False)
    with pytest.raises(ValueError):
        _refused_call(psys, kw, False, False)
    # the multi-context samplers: a missing unconditional context is zeros
    # there (guidance stays on); the JAX package's takes no noise table
    if "uncond" not in kw:
        if "noise_table" not in kw:
            with pytest.raises(ValueError):
                _refused_call(jsys, kw, True, True)
        with pytest.raises(ValueError):
            _refused_call(psys, kw, False, True)


# ---- VDInference's knobs through the flows ----

def _port_draw(seed, shape):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).numpy()


def _jax_vdi(jsys, monkeypatch, seed, shape, **modes):
    """vdtpu's VDInference with the modes, its samplers started at the
    port's draw (x_T, or the x0 start's noise)."""
    jvdi = japi.VDInference(jsys, **KW, **modes)
    draw = _port_draw(seed, shape)
    inner, inner_multi = jvdi._sample, jvdi._sample_multi

    def inject(x_info):
        return dict(x_info, **({"noise": draw} if "x0" in x_info else {"xt": draw}))

    monkeypatch.setattr(jvdi, "_sample", lambda key, shape, x_info, c_info: inner(
        key, shape, inject(x_info), c_info))
    monkeypatch.setattr(jvdi, "_sample_multi", lambda key, shape, x_info, c_infos: inner_multi(
        key, shape, inject(x_info), c_infos))
    return jvdi


IMAGE = np.random.RandomState(30).rand(1, 40, 50, 3).astype(np.float32)
FLOWS = {
    "t2i": (lambda vdi: vdi.inference_t2i("a red cat", 3), LATENT,
            dict(sampler="dpmpp2m", encoder_reuse=REUSE)),
    # fid 0.5: the x0 start runs 2 of 4 steps; the band (0.5, 1) of those 2
    "i2i": (lambda vdi: vdi.inference_i2i(IMAGE, 0.5, 0.3, "Simple", 3), LATENT,
            dict(sampler="dpmpp2m", cfg_interval=(0.5, 1.0))),
    "dcg": (lambda vdi: vdi.inference_dcg(IMAGE, 0.4, "a red cat", 0.5, 3), LATENT,
            dict(sampler="dpmpp2m")),
}


@pytest.mark.parametrize("flow", list(FLOWS))
def test_image_flow_modes_match_jax(systems, flow, monkeypatch):
    jsys, psys, _ = systems
    call, shape, modes = FLOWS[flow]
    ref = np.asarray(call(_jax_vdi(jsys, monkeypatch, 3, shape, **modes)))
    out = call(VDInference(psys, **KW, **modes)).numpy()
    assert out.shape == ref.shape == (2, 32, 32, 3)
    assert _rel(out, ref) <= 1e-4
    exact = call(VDInference(psys, **KW)).numpy()
    assert np.abs(out - exact).max() > 1e-3


def test_t2t_encoder_reuse_matches_jax(systems, monkeypatch):
    """The 0-D flows go through ``_sample_text``: the latent each package
    hands its text decoder, under encoder reuse on the text diffuser."""
    jsys, psys, _ = systems
    latents = {}

    def keep(name):
        def decode(x, rng):
            latents[name] = np.asarray(x)
            return []
        return decode

    jvdi = _jax_vdi(jsys, monkeypatch, 3, (4, 96), encoder_reuse=REUSE)
    monkeypatch.setattr(jvdi, "_decode_texts", keep("jax"))
    jvdi.inference_t2t("a red cat", 3)
    for name, modes in (("port", dict(encoder_reuse=REUSE)), ("exact", {})):
        vdi = VDInference(psys, **KW, **modes)
        monkeypatch.setattr(vdi, "_decode_texts", keep(name))
        vdi.inference_t2t("a red cat", 3)
    assert latents["port"].shape == latents["jax"].shape == (4, 96)
    assert _rel(latents["port"], latents["jax"]) <= 1e-4
    assert np.abs(latents["port"] - latents["exact"]).max() > 1e-3


# both packages merge the same tokens at the 256-token sites, in each half
# of the split walk its own merge; f32 summation order otherwise
def test_tome_encoder_reuse_request_matches_jax(systems, monkeypatch):
    jsys, psys, _ = systems
    call = lambda vdi: vdi.inference_t2i("a red cat", 4)
    modes = dict(encoder_reuse=REUSE)
    jsys.enable_tome(0.5, min_tokens=256)
    ref = np.asarray(call(_jax_vdi(jsys, monkeypatch, 4, LATENT, **modes)))
    vdi = VDInference(psys, **KW, **modes)
    psys.enable_tome(0.5, min_tokens=256)
    try:
        out = call(vdi).numpy()
    finally:
        psys.enable_tome(0)
    assert _rel(out, ref) <= 1e-4
    assert np.abs(out - call(vdi).numpy()).max() > 1e-3      # merging changed the result
