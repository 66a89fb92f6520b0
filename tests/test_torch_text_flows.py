"""The text flows (``inference_i2t``, ``inference_t2t``), port against the
JAX package, on the tiny config in f32: the whole flow with the same x_T
and the same decode draws, ``remove_duplicate_word``, the text VAE's
weights across (``from_jax`` and the strict load of
``export_torch_checkpoint()``), and the sampler's [n, F] latents.

Both systems carry the port's seeded init (``tiny_systems_from_port``). The
JAX side's sampler is handed the port's x_T (patching its
``VDInference._sample``, as ``test_torch_i2i`` does), and the port's text
decode is handed JAX's Gumbel draws, replayed from the key vdtpu decodes
with (``fold_in(PRNGKey(seed), 1)``; ``test_torch_optimus.gumbel_replay``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _tiny import det_tokenizer
from test_torch_i2i import tiny_systems_from_port
from test_torch_optimus import gumbel_replay
from vdtpu.sampling.ddim import DDIMSampler as JDDIMSampler
from vdtpu.serving import api as japi
from vdtpu.serving import postprocess as jpost
from vdtpu_torch.interop.from_jax import system_state_dict_from_jax
from vdtpu_torch.serving import postprocess
from vdtpu_torch.serving.api import VDInference, VDSystem

torch.set_num_threads(2)

PROMPT = "a red cat"


@pytest.fixture(scope="module")
def systems():
    return tiny_systems_from_port()


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# f32 end to end, 4 DDIM steps at CFG 7.5 on the 0-D diffuser, then the
# GPT-2 decode on the same draws: latent relative L2 <= 1e-4 (the guidance
# amplifies per-call summation-order differences), texts equal
@pytest.mark.parametrize("flow", ["i2t", "t2t"])
def test_text_flow_matches_jax(systems, flow, monkeypatch):
    jsys, psys, _ = systems
    kw = dict(text_tokenizer=det_tokenizer, output_dim=(64, 64), ddim_steps=4,
              n_sample_text=4, latent_downsample=2, text_latent_dim=96)
    seed = 3
    image = np.random.RandomState(12).rand(1, 50, 70, 3).astype(np.float32)
    run = (lambda vdi: vdi.inference_i2t(image, seed)) if flow == "i2t" else \
        (lambda vdi: vdi.inference_t2t(PROMPT, seed))
    draw = torch.randn((4, 96), generator=torch.Generator().manual_seed(seed))
    latents = {}
    jvdi = japi.VDInference(jsys, **kw)
    inner = jvdi._sample

    def sample(key, shape, x_info, c_info):   # the port's x_T
        out = inner(key, shape, dict(x_info, xt=draw.numpy()), c_info)
        latents["jax"] = np.asarray(out)
        return out

    monkeypatch.setattr(jvdi, "_sample", sample)
    ref = run(jvdi)

    vae = psys.vae["text"]
    decode_ids = vae.decode_ids
    table = gumbel_replay(jax.random.fold_in(jax.random.PRNGKey(seed), 1), 4, 600)

    def replayed(z, generator=None, temperature=1.0, gumbel_table=None):   # JAX's draws
        latents["port"] = z.numpy().copy()
        return decode_ids(z, None, temperature, table)

    monkeypatch.setattr(vae, "decode_ids", replayed)
    out = run(VDInference(psys, **kw))
    assert latents["port"].shape == latents["jax"].shape == (4, 96)
    assert _rel(latents["port"], latents["jax"]) <= 1e-4
    assert out == ref and len(out) == 4
    assert np.abs(latents["jax"] - draw.numpy()).max() > 1e-2   # the sampler ran


def test_text_flows_run_from_the_seed(systems):
    """Without injected draws: the same seed gives the same texts, the
    first draw of the seed's generator is x_T, the decode continues it."""
    _, psys, _ = systems
    vdi = VDInference(psys, text_tokenizer=det_tokenizer, output_dim=(64, 64), ddim_steps=4,
                      latent_downsample=2, text_latent_dim=96)
    a, b = vdi.inference_t2t(PROMPT, 5), vdi.inference_t2t(PROMPT, 5)
    assert a == b and len(a) == 4
    assert vdi.inference_t2t(PROMPT, 6) != a


CAPTIONS = [
    "a cat cat cat sitting on on the mat mat .",
    "a red red, red car. a red car. a red car.",
    "(a dog) (a dog) running running fast fast!",
    "the the quick brown brown fox the quick brown fox jumps jumps over",
    "one two three one two three one two three four",
    "[bracket] [bracket] word; word; end end end?",
    "",
    "single",
    "no repeats in this caption at all",
]


def test_remove_duplicate_word_matches_jax():
    rs = np.random.RandomState(13)
    words = ["a", "cat", "dog", "the", "red", "on", "mat.", "(big", "car,", "run!"]
    texts = CAPTIONS + [" ".join(rs.choice(words, rs.randint(1, 16))) for _ in range(60)]
    changed = 0
    for t in texts:
        out = postprocess.remove_duplicate_word(t)
        assert out == jpost.remove_duplicate_word(t), t
        changed += out != t
    assert changed > len(texts) // 2


def test_text_vae_weights_across(systems):
    """``from_jax`` of the full params tree (vae.text included) equals
    vdtpu's own export key for key, Conv1D kernels [in, out]; the export
    loads into the port with strict=True."""
    jsys, _, sd = systems
    params = jax.device_get(jsys.params)
    export = jsys.export_torch_checkpoint()
    ours = system_state_dict_from_jax(params)
    assert sorted(ours) == sorted(export)
    for k in export:
        np.testing.assert_array_equal(ours[k], np.asarray(export[k]), err_msg=k)
    assert ours["vae.text.decoder.transformer.h.0.mlp.c_fc.weight"].shape == (64, 256)
    assert ours["vae.text.encoder.encoder.layer.0.intermediate.dense.weight"].shape == (128, 64)
    psys = VDSystem("vd_test_tiny", device="cpu")
    res = psys.load_state_dict(export, strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    text = {k for k in psys.net.state_dict() if k.startswith("vae.text.")}
    assert len(text) > 40
    for k in text:
        np.testing.assert_array_equal(psys.net.state_dict()[k].numpy(), sd[k], err_msg=k)
    from_params = VDSystem("vd_test_tiny", device="cpu")
    from_params.load_jax_params(params, strict=True)
    for k in text:
        np.testing.assert_array_equal(from_params.net.state_dict()[k].numpy(), sd[k], err_msg=k)


# the sampler on the 0-D diffuser's [n, F] latents, with eta > 0 and an
# injected noise table in the JAX layout [S, n, F]: f32, summation order
@pytest.mark.parametrize("c_type", ["text", "image"])
def test_sampler_rank2_latents(systems, c_type):
    jsys, psys, _ = systems
    rs = np.random.RandomState(14)
    steps, n = 4, 2
    xt = rs.randn(n, 96).astype(np.float32)
    table = rs.randn(steps, n, 96).astype(np.float32)
    ctx_len = 16 if c_type == "text" else 17
    c, u = (rs.randn(n, ctx_len, 96).astype(np.float32) for _ in range(2))
    c_info = {"type": c_type, "conditioning": c, "unconditional_conditioning": u,
              "unconditional_guidance_scale": 7.5}
    ref = np.asarray(JDDIMSampler(jsys.model).sample(
        jsys.params["diffuser"], jax.random.PRNGKey(0), steps, (n, 96),
        {"type": "text", "xt": jnp.asarray(xt)}, c_info, eta=0.5, noise_table=table))
    out = psys.sampler.sample(None, steps, (n, 96), {"type": "text", "xt": xt}, c_info,
                              eta=0.5, noise_table=table).numpy()
    assert out.shape == ref.shape == (n, 96)
    assert _rel(out, ref) <= 1e-4
    no_noise = psys.sampler.sample(None, steps, (n, 96), {"type": "text", "xt": xt}, c_info,
                                   eta=0.5, noise_table=np.zeros_like(table)).numpy()
    assert _rel(no_noise, out) > 1e-3   # the table's noise entered


def test_vae_encode_text_matches_jax(systems, tmp_path, monkeypatch):
    """VDSystem.vae_encode(texts, "text"): lowercased wordpieces through the
    BERT encoder, the posterior mean (f32, 1e-5), on a mini vocabulary
    given to both VAEs."""
    from vdtpu.data.tokenizers import BertWordPieceTokenizer as JBert
    from vdtpu_torch.data.tokenizers import BertWordPieceTokenizer
    jsys, psys, _ = systems
    texts = ["A red cat, sitting.", "two dogs run on the beach", "café déjà vu"]
    words = sorted({w for t in texts for w in t.lower().replace(",", " , ").replace(
        ".", " . ").split()} | {"cafe", "deja"})
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words) + "\n",
                     encoding="utf-8")
    monkeypatch.setattr(jsys.vae["text"], "tokenizer_encoder", JBert(str(vocab)))
    monkeypatch.setattr(psys.vae["text"], "tokenizer_encoder",
                        BertWordPieceTokenizer(str(vocab)))
    ref = np.asarray(jsys.vae_encode(texts, "text"))
    out = psys.vae_encode(texts, "text").numpy()
    assert out.shape == ref.shape == (3, 96)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
