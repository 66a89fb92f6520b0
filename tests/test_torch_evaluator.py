"""The port's evaluators (``vdtpu_torch/training/evaluator.py``) and its
eval run's sampling (``training/launch.py::build_eval``) against the JAX
package on the CPU.

The evaluators reduce in float64 on the host where vdtpu reduces in the
inputs' float32: their summaries agree to 1e-6 relative on the same
embeddings. ``frechet_distance`` runs the same scipy calls in float64 on
both sides: 1e-9 relative, a rank-deficient covariance (fewer samples than
dimensions, the eps retry) included. The slice as a whole: the tiny
system's eval sample function against vdtpu's ``run_eval`` sample-function
body on the same weights, captions and x_T, a few f32 steps: images within
1e-4, the CLIP-sim summary within 1e-5 and CLIP-FID within 1e-3 relative
(its square root of a rank-deficient product amplifies f32 rounding).
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_i2i import tiny_systems_from_port
from vdtpu.training import evaluator as jev
from vdtpu_torch.ops.flash import flash_attention
from vdtpu_torch.ops.gn_silu import gn_silu
from vdtpu_torch.training import evaluator as pev
from vdtpu_torch.training.launch import EVAL_DEFAULTS, build_eval, run_eval

torch.set_num_threads(2)

CAPTIONS = ("a red cat", "a lighthouse on a cliff at dawn", "a bowl of ramen", "a fox")
STEPS, LATENT = 3, 16


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    flash_attention.launches = gn_silu.launches = 0
    yield
    assert flash_attention.launches == 0 and gn_silu.launches == 0


def _embeddings(seed, n=5, d=32):
    rs = np.random.RandomState(seed)
    return rs.randn(n, d).astype(np.float32), rs.randn(n, d).astype(np.float32)


def test_registry_names():
    assert pev.get_evaluator("clip_similarity", image_embed_fn=None,
                             text_embed_fn=None).__class__ is pev.ClipSimilarityEvaluator
    assert pev.get_evaluator("fid", feature_fn=None).__class__ is pev.FIDEvaluator
    assert set(pev._REG) == set(jev._REG)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_clip_similarity_matches_jax(kind):
    batches = [_embeddings(s) for s in (1, 2)]
    wrap = (lambda a: a) if kind == "numpy" else (lambda a: torch.from_numpy(a).bfloat16())
    unwrap = (lambda a: a) if kind == "numpy" else (
        lambda a: torch.from_numpy(a).bfloat16().float().numpy())
    ident = lambda z: z
    ours = pev.ClipSimilarityEvaluator(ident, ident)
    ref = jev.ClipSimilarityEvaluator(ident, ident)
    for zi, zt in batches:
        ours.add_batch(wrap(zi), wrap(zt))
        ref.add_batch(unwrap(zi), unwrap(zt))
    out, want = ours.summarize(), ref.summarize()
    assert set(out) == set(want) == {"clip_similarity"}
    np.testing.assert_allclose(out["clip_similarity"], want["clip_similarity"], rtol=1e-6)
    ours.clear()
    assert ours.summarize() == {"clip_similarity": 0.0}


@pytest.mark.parametrize("n,d", [(64, 8), (4, 16)])   # full rank; rank 3 of 16
def test_frechet_distance_matches_jax(n, d):
    rs = np.random.RandomState(n + d)
    a, b = rs.randn(n, d), rs.randn(n, d) * 1.3 + 0.2
    stats = lambda x: (x.mean(0), np.cov(x, rowvar=False))
    out = pev.frechet_distance(*stats(a), *stats(b))
    ref = jev.frechet_distance(*stats(a), *stats(b))
    assert np.isfinite(out)
    np.testing.assert_allclose(out, ref, rtol=1e-9)


def test_fid_evaluator_matches_jax():
    rs = np.random.RandomState(3)
    fake = [rs.randn(6, 8).astype(np.float32) for _ in range(2)]
    real = [rs.randn(6, 8).astype(np.float32) + 0.5 for _ in range(2)]
    ours, ref = pev.FIDEvaluator(lambda x: x), jev.FIDEvaluator(lambda x: x)
    ours.add_batch(torch.from_numpy(fake[0]), torch.from_numpy(real[0]))
    ours.add_batch(fake[1])
    ours.add_reference(real[1])
    ref.add_batch(fake[0], real[0])
    ref.add_batch(fake[1])
    ref.add_reference(real[1])
    np.testing.assert_allclose(ours.summarize()["fid"], ref.summarize()["fid"], rtol=1e-5)
    ours.clear()
    assert not ours.real and not ours.fake


def test_eval_stage_matches_jax(capsys):
    """Both stages feed every batch's sample-function outputs to the
    evaluator, log every ``log_every`` batches and the summary, and clear."""
    data = [_embeddings(s, n=3) for s in range(4)]
    ours = pev.EvalStage(pev.ClipSimilarityEvaluator(lambda z: z, lambda z: z),
                         lambda batch: batch, log_every=2)
    ref = jev.EvalStage(jev.ClipSimilarityEvaluator(lambda z: z, lambda z: z),
                        lambda batch: batch, log_every=2)
    out = ours(iter(data))
    logged = capsys.readouterr().out
    want = ref(iter(data))
    np.testing.assert_allclose(out["clip_similarity"], want["clip_similarity"], rtol=1e-6)
    assert "eval processed 2 batches" in logged and "eval processed 4 batches" in logged
    assert "eval summary: clip_similarity=" in logged
    assert not ours.evaluator.sims


# ---- the slice as a whole: the eval run's sampling on the tiny system ----

@pytest.fixture(scope="module")
def systems():
    return tiny_systems_from_port()


def _tokenizer(psys):
    """CLIP-shaped ids for the tiny text tower: BOS, one crc32 id per word,
    EOT (the largest id) padding to the tower's length."""
    enc = psys.ctx["text"]
    vocab, length = enc.text_model.embeddings.token_embedding.num_embeddings, enc.max_len

    def tok(texts):
        rows = []
        for t in texts:
            ids = [1 + zlib.crc32(w.encode()) % (vocab - 3) for w in t.split()][:length - 2]
            rows.append([vocab - 2] + ids + [vocab - 1] * (length - 1 - len(ids)))
        return np.array(rows, np.int64)
    return tok


def _jax_eval(jsys, tok, vcfg, batches, xts):
    """vdtpu's run_eval sample-function body with x_T handed in, and its
    evaluator wiring."""
    v = {**EVAL_DEFAULTS, **vcfg}
    uncond_1 = jsys.ctx_encode(tok([""]), "text")
    if v["evaluator"] == "clip_similarity":
        ev = jev.get_evaluator("clip_similarity", image_embed_fn=jsys.clip_image_features,
                               text_embed_fn=jsys.clip_text_features)
    else:
        ev = jev.get_evaluator("fid", feature_fn=jsys.clip_image_features)
    images = []
    for batch, xt in zip(batches, xts):
        ids = tok(list(batch["caption"]))
        c = jsys.ctx_encode(ids, "text")
        u = jnp.tile(uncond_1, (c.shape[0], 1, 1))
        x = jsys.sampler.sample(
            jsys.params["diffuser"], jax.random.PRNGKey(0), v["ddim_steps"], xt.shape,
            {"type": "image", "xt": jnp.asarray(xt)},
            {"type": "text", "conditioning": c, "unconditional_conditioning": u,
             "unconditional_guidance_scale": v["scale"]},
            dtype=jsys.dtype, method=v["sampler"])
        imgs = jsys.vae_decode(x, "image")
        images.append(np.asarray(imgs))
        ev.add_batch(*((imgs, ids) if v["evaluator"] == "clip_similarity"
                       else (imgs, batch["image"])))
    return ev.summarize(), images


@pytest.mark.parametrize("vcfg", [
    {"ddim_steps": STEPS, "latent_size": LATENT},
    {"ddim_steps": STEPS, "latent_size": LATENT, "sampler": "dpmpp2m", "evaluator": "fid"}],
    ids=["ddim-clip_similarity", "dpmpp2m-fid"])
def test_eval_run_matches_jax(systems, vcfg):
    jsys, psys, _ = systems
    tok = _tokenizer(psys)
    rs = np.random.RandomState(5)
    batches = [{"caption": list(CAPTIONS[i:i + 2]),
                "image": rs.rand(2, 2 * LATENT, 2 * LATENT, 3).astype(np.float32)}
               for i in (0, 2)]
    # the port's x_T stream: one generator seeded with the config's seed (0)
    g = torch.Generator().manual_seed(0)
    xts = [torch.randn((2, LATENT, LATENT, 4), generator=g).numpy() for _ in batches]
    want, ref_images = _jax_eval(jsys, tok, vcfg, batches, xts)
    # the sample function alone: the images vdtpu's body decodes
    sample_fn, _ = build_eval(psys, tok, vcfg)
    for batch, ref in zip(batches, ref_images):
        imgs, second = sample_fn(batch)
        assert imgs.shape == ref.shape == (2, 2 * LATENT, 2 * LATENT, 3)
        np.testing.assert_allclose(imgs.numpy(), ref, atol=1e-4)
        if vcfg.get("evaluator") == "fid":
            assert second is batch["image"]
        else:
            np.testing.assert_array_equal(second, tok(batch["caption"]))
    out = run_eval(psys, tok, dict(vcfg, max_batches=2), iter(batches + batches))
    name = vcfg.get("evaluator", "clip_similarity")
    assert set(out) == {name} and np.isfinite(out[name])
    np.testing.assert_allclose(out[name], want[name],
                               rtol=1e-5 if name == "clip_similarity" else 1e-3)


def test_eval_draws_from_its_seed(systems):
    """Each batch's x_T comes from one generator seeded with
    the config's seed: two runs agree bit for bit, another seed differs."""
    _, psys, _ = systems
    tok = _tokenizer(psys)
    batch = {"caption": list(CAPTIONS[:2])}
    run = lambda seed: build_eval(psys, tok, {"ddim_steps": 2, "latent_size": 8,
                                              "seed": seed})[0](batch)[0]
    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
