"""The Optimus text VAE, port against the JAX package, on ``optimus_tiny``
in f32 with the same weights: the BERT encoder's posterior mean, GPT-2's
teacher-forced logits (which a transposed Conv1D would break), the
top-k / top-p filter, and ``generate`` step for step.

The weights are the port's seeded init with its all-zero tensors replaced
by seeded normals, loaded into the JAX VAE through its own ``load_torch``
(which transposes the four GPT-2 Conv1D kernels). The two packages draw
different random numbers, so ``generate`` is compared on JAX's own draws:
its key splits are replayed into a Gumbel table with ``jax.random.gumbel``
(``jax.random.categorical`` is argmax(logits + gumbel) in JAX 0.9), the
table is first checked against vdtpu's own ids, then handed to the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdtpu.config.bank import model_cfg_bank as jax_bank
from vdtpu.config.registry import build as jax_build
from vdtpu.models import optimus as jopt
from vdtpu_torch.config.configs import model_cfg_bank
from vdtpu_torch.config.registry import build
from vdtpu_torch.models import optimus as popt
from vdtpu_torch.models.layers import init_random

torch.set_num_threads(2)

TOL = 1e-5   # f32 on both sides: summation order only


def tiny_text_vaes(seed: int = 0):
    """(JAX OptimusVAE, its params {"encoder", "decoder"}, port OptimusVAE,
    the shared state dict without the ``vae.text.`` prefix)."""
    pvae = build(model_cfg_bank()("optimus_tiny"))
    init_random(pvae, torch.Generator().manual_seed(seed))
    rs = np.random.RandomState(seed)
    sd = {k: np.asarray(v.numpy() if v.any() else rs.normal(0, 0.02, tuple(v.shape)),
                        np.float32)
          for k, v in sorted(pvae.state_dict().items())}
    pvae.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    jvae = jax_build(jax_bank()("optimus_tiny"))
    box = {"text": jax.eval_shape(jvae.init_params, jax.random.PRNGKey(0))}
    assert not jvae.load_torch({"vae.text." + k: v for k, v in sd.items()}, box, strict=True)
    return jvae, box["text"], pvae, sd


@pytest.fixture(scope="module")
def vaes():
    return tiny_text_vaes()


def test_bos_eos_rule():
    pvae = build(model_cfg_bank()("optimus_tiny"))
    assert (pvae.bos_id, pvae.eos_id) == (598, 599)
    with torch.device("meta"):
        full = build(model_cfg_bank()("optimus_v1"))
    assert (full.bos_id, full.eos_id) == (jopt.GPT2_BOS, jopt.GPT2_EOS) == (50258, 50259)
    assert full.tokenizer_encoder is None and full.tokenizer_decoder is None  # no vocab files
    assert sum(p.numel() for p in full.parameters()) > 200e6


def test_bert_encode_matches_jax(vaes):
    jvae, params, pvae, _ = vaes
    rs = np.random.RandomState(1)
    ids = rs.randint(1, 500, (3, 12)).astype(np.int32)
    ids[1, 7:] = 0   # padding: masked keys
    ids[2, 3:] = 0
    ref = np.asarray(jvae.encode_ids(params, ids))
    with torch.no_grad():
        out = pvae.encode_ids(ids).numpy()
    assert out.shape == ref.shape == (3, 96)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)


def _teacher_forced(jvae, params, pvae, ids, z):
    ref = np.asarray(jvae.decoder.apply({"params": params["decoder"]}, jnp.asarray(ids),
                                        jnp.asarray(z)))
    with torch.no_grad():
        out = pvae.decoder(torch.from_numpy(ids).long(), torch.from_numpy(z)).numpy()
    return out, ref


def test_gpt2_teacher_forced_logits_match_jax(vaes):
    jvae, params, pvae, sd = vaes
    rs = np.random.RandomState(2)
    ids = rs.randint(0, 600, (2, 9)).astype(np.int32)
    z = rs.randn(2, 96).astype(np.float32)
    out, ref = _teacher_forced(jvae, params, pvae, ids, z)
    assert out.shape == ref.shape == (2, 9, 600)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)
    # a square Conv1D loaded in the Linear convention loads silently and
    # moves the logits far outside the tolerance
    bad = build(model_cfg_bank()("optimus_tiny"))
    key = "decoder.transformer.h.0.attn.c_proj.weight"
    bad.load_state_dict({k: torch.from_numpy(v.T.copy() if k == key else v)
                         for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        moved = bad.decoder(torch.from_numpy(ids).long(), torch.from_numpy(z)).numpy()
    assert np.abs(moved - ref).max() > 100 * TOL


@pytest.mark.parametrize("top_k", [0, 1, 5, 50])
@pytest.mark.parametrize("top_p", [0.0, 0.5, 0.9, 1.0])
def test_top_k_top_p_filter_matches_jax(top_k, top_p):
    logits = (np.random.RandomState(3).randn(4, 600) * 3).astype(np.float32)
    ref = np.asarray(jopt.top_k_top_p_filter(jnp.asarray(logits), top_k, top_p))
    out = popt.top_k_top_p_filter(torch.from_numpy(logits), top_k, top_p).numpy()
    np.testing.assert_array_equal(out, ref)
    kept = (out > -1e9).sum(axis=1)
    if top_k == 0 and top_p in (0.0, 1.0):
        assert (kept == 600).all()
    else:
        assert (kept < 600).all() and (kept >= 1).all()


def gumbel_replay(key, batch: int, vocab: int, steps: int = jopt.MAX_DECODE_LEN - 1):
    """The Gumbel draws of vdtpu's generate, [steps, B, V]: one key split per
    step (key [2]: one [B, V] draw), or per-row keys [B, 2] split per row."""
    rows = []
    for _ in range(steps):
        if key.ndim == 2:
            ks = jax.vmap(jax.random.split)(key)
            key, sub = ks[:, 0], ks[:, 1]
            rows.append(jax.vmap(lambda k: jax.random.gumbel(k, (vocab,), jnp.float32))(sub))
        else:
            key, sub = jax.random.split(key)
            rows.append(jax.random.gumbel(sub, (batch, vocab), jnp.float32))
    return np.array(jnp.stack(rows))


# random weights give peaked logits (std ~8); temperatures 4 and 8 make the
# Gumbel draws decide tokens, which the test asserts
@pytest.mark.parametrize("mode,top_k,top_p,temperature", [
    ("single", 0, 1.0, 1.0), ("single", 0, 1.0, 8.0), ("per_row", 0, 1.0, 8.0),
    ("single", 5, 0.9, 4.0)])
def test_generate_matches_jax(vaes, mode, top_k, top_p, temperature):
    jvae, params, pvae, _ = vaes
    b = 3
    z = (np.random.RandomState(4).randn(b, 96) * 3).astype(np.float32)
    key = jax.random.PRNGKey(5)
    if mode == "per_row":
        key = jax.random.split(key, b)
    ref = np.asarray(jvae.decoder.apply(
        {"params": params["decoder"]}, jnp.asarray(z), key, temperature=temperature,
        top_k=top_k, top_p=top_p, eos_token=jvae.eos_id, bos_token=jvae.bos_id,
        method=jopt.OptimusGPT2Connector.generate))
    table = gumbel_replay(key, b, 600)
    # the replay reproduces vdtpu's own draws: its teacher-forced logits on
    # its own ids, filtered as generate filters them, plus the table pick
    # each sampled (not forced, not done) token
    logits = np.asarray(jvae.decoder.apply({"params": params["decoder"]},
                                           jnp.asarray(ref[:, :-1]), jnp.asarray(z)))
    checked = noise_decided = 0
    for i in range(ref.shape[1] - 2):
        live = ~(ref[:, 1:i + 1] == jvae.eos_id).any(axis=1)
        filt = np.asarray(jopt.top_k_top_p_filter(jnp.asarray(logits[:, i] / temperature),
                                                  top_k, top_p))
        pick = np.argmax(filt + table[i], axis=-1)
        np.testing.assert_array_equal(pick[live], ref[live, i + 1])
        checked += int(live.sum())
        noise_decided += int((pick != np.argmax(filt, axis=-1))[live].sum())
    assert checked >= b * 10
    assert temperature == 1.0 or noise_decided > 0
    with torch.no_grad():
        out = pvae.decoder.generate(torch.from_numpy(z), temperature=temperature, top_k=top_k,
                                    top_p=top_p, eos_token=pvae.eos_id,
                                    bos_token=pvae.bos_id, gumbel_table=table).numpy()
    np.testing.assert_array_equal(out, ref)


def test_decode_matches_jax(vaes):
    """decode: BOS skipped, cut at the first EOS, ids joined by spaces."""
    jvae, params, pvae, _ = vaes
    z = (np.random.RandomState(6).randn(4, 96) * 3).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = jvae.decode(params, z, temperature=1.0, rng=key)
    with torch.no_grad():
        out = pvae.decode(torch.from_numpy(z), gumbel_table=gumbel_replay(key, 4, 600))
    assert out == ref and all(s for s in out)


def test_eos_forcing_and_done_rows(vaes):
    *_, pvae, _ = vaes
    eos, steps = pvae.eos_id, jopt.MAX_DECODE_LEN - 1
    table = np.zeros((steps, 3, 600), np.float32)
    table[:, :, 17] = 1e6          # token 17 wins every draw ...
    table[3, 0, eos] = 2e6         # ... but row 0 draws EOS at step 3
    table[0, 2, eos] = 2e6         # and row 2 at the first step
    with torch.no_grad():
        ids = pvae.decode_ids(torch.zeros(3, 96), gumbel_table=table).numpy()
    assert ids.shape == (3, jopt.MAX_DECODE_LEN)
    assert (ids[:, 0] == pvae.bos_id).all()
    np.testing.assert_array_equal(ids[0], [pvae.bos_id, 17, 17, 17] + [eos] * 26)
    np.testing.assert_array_equal(ids[1], [pvae.bos_id] + [17] * 28 + [eos])   # forced
    np.testing.assert_array_equal(ids[2], [pvae.bos_id] + [eos] * 29)
    with torch.no_grad():
        texts = pvae.decode(torch.zeros(3, 96), gumbel_table=table)
    assert texts == ["17 17 17", " ".join(["17"] * 28), ""]


def test_generate_from_generators(vaes):
    """Draws from torch.Generators: one for the batch, or one per row, where
    a row's tokens do not depend on its co-riders."""
    *_, pvae, _ = vaes
    z = torch.from_numpy((np.random.RandomState(8).randn(3, 96) * 3).astype(np.float32))
    gens = lambda: [torch.Generator().manual_seed(s) for s in (10, 11, 12)]
    with torch.no_grad():
        a = pvae.decode_ids(z, torch.Generator().manual_seed(9))
        b = pvae.decode_ids(z, torch.Generator().manual_seed(9))
        rows = pvae.decode_ids(z, gens())
        alone = pvae.decode_ids(z[1:2], gens()[1:2])
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(rows[1:2], alone, rtol=0, atol=0)
    with pytest.raises(ValueError):
        pvae.decode_ids(z, gens()[:2])
