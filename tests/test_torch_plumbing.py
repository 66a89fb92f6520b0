"""The serving plumbing, port against the JAX package, on the tiny config in
f32: the upstream noise replay (``vdtpu_torch.interop.noise``) and the
sampler fed with it, the CLIP feature helpers, and serving the port's own
``Trainer`` checkpoints (``VDSystem.load_vdtpu_torch_checkpoint``).

Both systems carry the same weights (``test_torch_i2i.tiny_systems_from_port``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _tiny import det_tokenizer
from test_torch_i2i import tiny_systems_from_port
from vdtpu.interop import noise as jnoise
from vdtpu_torch.interop import noise
from vdtpu_torch.serving.api import VDSystem
from vdtpu_torch.training import optim
from vdtpu_torch.training.checkpoints import checkpoint_path, save_checkpoint
from vdtpu_torch.training.harness import Trainer

torch.set_num_threads(2)

LATENT_NCHW = (2, 4, 16, 16)
STEPS = 4


@pytest.fixture(scope="module")
def systems():
    return tiny_systems_from_port()


@pytest.mark.parametrize("seed,k", [(0, None), (7, None), (3, 2), (11, 4)])
def test_capture_equals_jax_package(seed, k):
    want = jnoise.capture(seed, LATENT_NCHW, STEPS, k)
    got = noise.capture(seed, LATENT_NCHW, STEPS, k)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == np.float32
        np.testing.assert_array_equal(got[name], want[name])
        np.testing.assert_array_equal(noise.nchw_to_nhwc(got[name]),
                                      jnoise.nchw_to_nhwc(want[name]))
    assert got["step_noise"].shape == (STEPS if k is None else k, *LATENT_NCHW)


def _c_info(seed):
    c = (np.random.RandomState(seed).randn(2, 16, 96) * 0.3).astype(np.float32)
    return {"type": "text", "conditioning": c, "unconditional_conditioning": c * 0,
            "unconditional_guidance_scale": 7.5}


# f32, 4 DDIM steps at CFG 7.5 and eta 0.5 on the upstream draws, as the
# t2i slice (relative L2 1e-4): both samplers consume the same noise
@pytest.mark.parametrize("k", [None, 2])
def test_sampler_on_captured_noise_matches_jax(systems, k):
    jsys, psys, _ = systems
    draws = noise.capture(5, LATENT_NCHW, STEPS, k)
    table = noise.nchw_to_nhwc(draws["step_noise"])
    shape = noise.nchw_to_nhwc(np.zeros(LATENT_NCHW)).shape
    if k is None:
        info = {"type": "image", "xt": noise.nchw_to_nhwc(draws["xt"])}
    else:
        x0 = np.random.RandomState(6).randn(*shape).astype(np.float32)
        info = {"type": "image", "x0": x0, "x0_forward_timesteps": k,
                "noise": noise.nchw_to_nhwc(draws["q_noise"])}
    ci = _c_info(4)
    want = np.asarray(jsys.sampler.sample(jsys.params["diffuser"], jax.random.PRNGKey(0),
                                          STEPS, shape, info, ci, eta=0.5, noise_table=table))
    tci = {k_: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k_, v in ci.items()}
    got = psys.sampler.sample(torch.Generator().manual_seed(1), STEPS, shape, info, tci,
                              eta=0.5, noise_table=table, device="cpu").numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-4
    other = psys.sampler.sample(torch.Generator().manual_seed(1), STEPS, shape, info, tci,
                                eta=0.5, noise_table=table * 0.5, device="cpu").numpy()
    assert np.abs(other - got).max() > 1e-3                  # the table was consumed


# f32 CLIP towers: summation order only
def test_clip_features_match_jax(systems):
    jsys, psys, _ = systems
    images = np.random.RandomState(8).rand(2, 40, 50, 3).astype(np.float32)
    want = np.asarray(jsys.clip_image_features(images))
    got = psys.clip_image_features(images).numpy()
    assert got.shape == want.shape == (2, 96)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    ids = det_tokenizer(["a red cat on a mat", "hello", ""])
    want = np.asarray(jsys.clip_text_features(ids))
    got = psys.clip_text_features(ids)
    assert tuple(got.shape) == want.shape == (3, 96)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    eot = ids.argmax(-1)
    full = psys.ctx_encode(ids, "text")
    assert torch.equal(got, full[torch.arange(3), torch.from_numpy(eot).long()])
    assert torch.equal(psys.clip_text_features(torch.from_numpy(ids)), got)


def _trained(tmp):
    """Two Trainer steps of the tiny diffusers (EMA 0.99) with checkpoints
    iter_1 and last; returns the trainer."""
    system = VDSystem("vd_test_tiny", device="cpu").init_random(0)
    params = system.for_training(torch.float32)
    opt, set_lr = optim.get_optimizer("adamw", params, weight_decay=0.01)
    trainer = Trainer(system.model, params, opt, set_lr, ema_decay=0.99, ckpt_dir=str(tmp),
                      ckpt_every=1, log_every=10)
    rs = np.random.RandomState(9)
    batches = [{"x": rs.randn(2, 4, 8, 8).astype(np.float32),
                "ctx": rs.randn(2, 16, 96).astype(np.float32)} for _ in range(2)]
    trainer.run(batches, num_iters=2, seed=3)
    return trainer


def _diffuser_equals(system, tree):
    return all(torch.equal(p, tree[name]) for name, p in system.model.diffuser.named_parameters())


def test_load_vdtpu_torch_checkpoint(tmp_path):
    trainer = _trained(tmp_path / "run")
    state = trainer.state
    shadow, raw = state.ema.shadow, state.params
    assert any(not torch.equal(shadow[k], raw[k]) for k in raw)
    serve = VDSystem("vd_test_tiny", device="cpu").init_random(1)
    assert serve.load_vdtpu_torch_checkpoint(str(tmp_path / "run")) == "last"
    assert _diffuser_equals(serve, shadow)                    # the EMA shadow by default
    assert serve.load_vdtpu_torch_checkpoint(str(tmp_path / "run"), "iter_1",
                                             use_ema=False) == "iter_1"
    assert not _diffuser_equals(serve, raw)                   # one step before the last
    serve.load_vdtpu_torch_checkpoint(str(tmp_path / "run"), use_ema=False)
    assert _diffuser_equals(serve, raw)

    # a run without EMA: the raw params; the highest iter_N is the latest
    bare = dataclasses.replace(state, ema=None)
    for tag in ("iter_3", "iter_12", "best"):
        save_checkpoint(str(tmp_path / "bare"), tag, bare)
    assert serve.load_vdtpu_torch_checkpoint(str(tmp_path / "bare")) == "iter_12"
    assert _diffuser_equals(serve, raw)

    # the {"diffuser", "ctx"} tree: the context encoder goes to ctx[ctx_slot]
    ctx = {k: v + 0.5 for k, v in serve.ctx["text"].state_dict().items()}
    payload = {"params": {"diffuser": dict(raw), "ctx": ctx},
               "ema": {"shadow": {"diffuser": dict(shadow), "ctx": ctx}, "num_updates": 2},
               "opt_state": {}, "step": 2}
    (tmp_path / "both").mkdir()
    torch.save(payload, checkpoint_path(str(tmp_path / "both"), "best"))
    assert serve.load_vdtpu_torch_checkpoint(str(tmp_path / "both"), ctx_slot="text") == "best"
    assert _diffuser_equals(serve, shadow)
    assert all(torch.equal(v, ctx[k]) for k, v in serve.ctx["text"].state_dict().items())

    # a checkpoint of another model is refused
    payload["ema"]["shadow"]["diffuser"] = {k: v for k, v in shadow.items()
                                            if not k.startswith("image.")}
    torch.save(payload, checkpoint_path(str(tmp_path / "both"), "last"))
    with pytest.raises(KeyError, match="missing"):
        serve.load_vdtpu_torch_checkpoint(str(tmp_path / "both"))
