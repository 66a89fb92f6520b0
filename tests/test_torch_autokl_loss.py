"""The VAE training loss of the port (``vdtpu_torch/models/autokl_loss.py``),
the posterior's KL and NLL and the reconstruction pass, against the JAX
package on the CPU.

Both sides get the same weights: vdtpu's loss tree is drawn in numpy on
``jax.eval_shape`` templates (no JAX init of VGG16) and handed to the port
through ``interop.from_jax.loss_state_dict_from_jax``; the tiny VAE comes
from ``test_torch_i2i.tiny_systems_from_port``. Everything is f32, so the
bounds are summation order: 1e-5 relative on the posterior terms, 1e-4 on
the convolution stacks (VGG16's 13 layers, the discriminator, the VAE) and
on the losses and the adaptive weight built on them (elementwise, with an
absolute floor of a tenth of the bound at the tensor's scale, for the
elements near zero).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_i2i import tiny_systems_from_port
from vdtpu.models import autokl_loss as jloss
from vdtpu.models.autoencoder import AutoencoderKL as JAutoencoderKL
from vdtpu.models.distributions import DiagonalGaussian as JDiagonalGaussian
from vdtpu.models.distributions import normal_kl as jnormal_kl
from vdtpu_torch.interop.from_jax import loss_state_dict_from_jax
from vdtpu_torch.models import autokl_loss as ploss
from vdtpu_torch.models.distributions import DiagonalGaussian, normal_kl
from vdtpu_torch.ops.gn_silu import gn_silu

torch.set_num_threads(2)

SIZE = 32          # LPIPS and discriminator inputs (VGG16's fifth slice at 2x2)
DISC_START = 5


def _nhwc(t):
    return np.asarray(t.detach().numpy()).transpose(0, 2, 3, 1)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _jax_loss_tree(seed: int = 0):
    """vdtpu's loss tree at SIZE: lecun-normal kernels, small biases, BatchNorm
    scales and statistics away from their init values, logvar 0.3."""
    loss = jloss.LPIPSWithDiscriminator(disc_start=DISC_START, kl_weight=1e-3, disc_weight=0.5)
    shapes = jax.eval_shape(lambda k: loss.init_params(k, image_size=SIZE), jax.random.PRNGKey(0))
    rs = np.random.RandomState(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            return rs.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        if name in ("scale", "var"):
            return rs.uniform(0.5, 1.5, s.shape)
        return rs.randn(*s.shape) * 0.1

    tree = jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(draw(p, s), np.float32), shapes)
    tree["logvar"] = np.float32(0.3)
    return loss, tree


@pytest.fixture(scope="module")
def losses():
    jl, tree = _jax_loss_tree()
    pl = ploss.LPIPSWithDiscriminator(disc_start=DISC_START, kl_weight=1e-3, disc_weight=0.5)
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in loss_state_dict_from_jax(tree).items()}
    pl.load_state_dict(sd, strict=True)
    return jl, tree, pl


@pytest.fixture(scope="module")
def systems():
    return tiny_systems_from_port()


def _images(seed, b=2, size=SIZE):
    rs = np.random.RandomState(seed)
    return [rs.uniform(-1, 1, (b, size, size, 3)).astype(np.float32) for _ in range(2)]


def _close(out, ref, rtol, name=""):
    np.testing.assert_allclose(np.asarray(out, np.float64), np.asarray(ref, np.float64),
                               rtol=rtol, atol=0.1 * rtol * max(1.0, float(np.abs(ref).max())),
                               err_msg=name)


# ---- distributions ----

def test_kl_nll_normal_kl_match_jax():
    rs = np.random.RandomState(1)
    m1 = (rs.randn(2, 5, 5, 8) * 3).astype(np.float32)
    m2 = (rs.randn(2, 5, 5, 8) * 3).astype(np.float32)
    sample = rs.randn(2, 5, 5, 4).astype(np.float32)
    j1, j2 = JDiagonalGaussian(jnp.asarray(m1)), JDiagonalGaussian(jnp.asarray(m2))
    # the port's NCHW posterior, split on dim 1, sums to the same values
    p1 = DiagonalGaussian(_nchw(m1), channel_axis=1)
    p2 = DiagonalGaussian(_nchw(m2), channel_axis=1)
    np.testing.assert_allclose(p1.var.numpy(), np.asarray(j1.var).transpose(0, 3, 1, 2), rtol=1e-6)
    np.testing.assert_allclose(p1.kl().numpy(), np.asarray(j1.kl()), rtol=1e-5)
    np.testing.assert_allclose(p1.kl(p2).numpy(), np.asarray(j1.kl(j2)), rtol=1e-5)
    np.testing.assert_allclose(p1.nll(_nchw(sample)).numpy(),
                               np.asarray(j1.nll(jnp.asarray(sample))), rtol=1e-5)
    np.testing.assert_allclose(p1.nll(_nchw(sample), axes=(1, 2, 3)).numpy(),
                               np.asarray(j1.nll(jnp.asarray(sample), axes=(1, 2, 3))),
                               rtol=1e-5)
    # normal_kl broadcasts tensors against floats
    a, b = rs.randn(3, 4).astype(np.float32), rs.randn(3, 4).astype(np.float32)
    np.testing.assert_allclose(
        normal_kl(torch.from_numpy(a), torch.from_numpy(b), 0.0, 0.5).numpy(),
        np.asarray(jnormal_kl(jnp.asarray(a), jnp.asarray(b), 0.0, 0.5)), rtol=1e-5)


def test_deterministic_posterior_matches_jax():
    m = np.random.RandomState(2).randn(2, 3, 3, 8).astype(np.float32)
    j = JDiagonalGaussian(jnp.asarray(m), deterministic=True)
    p = DiagonalGaussian(torch.from_numpy(m), deterministic=True)
    torch.testing.assert_close(p.sample(torch.Generator().manual_seed(0)), p.mean, atol=0, rtol=0)
    for out, ref in ((p.kl(), j.kl()), (p.nll(p.mean), j.nll(j.mean))):
        assert out.shape == ref.shape == (2,)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# ---- LPIPS, VGG16 and the discriminator through the converter ----

def test_vgg16_features_match_jax(losses):
    jl, tree, pl = losses
    x, _ = _images(3)
    ref = jloss.VGG16Features().apply({"params": tree["lpips"]["net"]}, jnp.asarray(x))
    with torch.no_grad():
        out = pl.lpips.net(_nchw(x))
    assert len(out) == len(ref) == 5
    for k, (o, r) in enumerate(zip(out, ref)):
        assert _nhwc(o).shape == np.asarray(r).shape
        _close(_nhwc(o), np.asarray(r), 1e-4, f"slice {k}")


def test_lpips_matches_jax(losses):
    jl, tree, pl = losses
    x, y = _images(4)
    ref = np.asarray(jl.lpips.apply({"params": tree["lpips"]}, jnp.asarray(x), jnp.asarray(y)))
    with torch.no_grad():
        out = pl.lpips(_nchw(x), _nchw(y)).numpy()
    assert out.shape == (2, 1, 1, 1) and ref.shape == (2, 1, 1, 1)
    np.testing.assert_allclose(out, ref, rtol=1e-4)


def test_discriminator_matches_jax(losses):
    """Batch statistics in the pass; the statistics flax would store equal
    the port's update from the same pass; running statistics when not
    training."""
    jl, tree, pl = losses
    x, _ = _images(5)
    disc = jl.discriminator
    variables = {"params": tree["discriminator"], "batch_stats": tree["disc_stats"]}
    ref, new = disc.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    d = ploss.NLayerDiscriminator()
    d.load_state_dict({k[len("discriminator."):]: v for k, v in pl.state_dict().items()
                       if k.startswith("discriminator.")})
    with torch.no_grad():
        out = d(_nchw(x))
        stats = d.update_stats()
    _close(_nhwc(out), np.asarray(ref), 1e-4)
    for name, st in new["batch_stats"].items():
        for leaf, key in (("mean", "running_mean"), ("var", "running_var")):
            np.testing.assert_allclose(stats[f"{name}.{key}"].numpy(), np.asarray(st[leaf]),
                                       rtol=1e-4, atol=1e-6, err_msg=f"{name}.{key}")
    ref_eval = disc.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        out_eval = pl.discriminator(_nchw(x), train=False)
    _close(_nhwc(out_eval), np.asarray(ref_eval), 1e-4)


def test_d_losses_and_adopt_weight_match_jax():
    rs = np.random.RandomState(6)
    lr, lf = rs.randn(4, 1, 8, 8).astype(np.float32), rs.randn(4, 1, 8, 8).astype(np.float32)
    for pf, jf in ((ploss.hinge_d_loss, jloss.hinge_d_loss),
                   (ploss.vanilla_d_loss, jloss.vanilla_d_loss)):
        np.testing.assert_allclose(float(pf(torch.from_numpy(lr), torch.from_numpy(lf))),
                                   float(jf(jnp.asarray(lr), jnp.asarray(lf))), rtol=1e-6)
    for step in (0, 4, 5, 6):
        assert ploss.adopt_weight(1.0, step, threshold=5) == float(
            jloss.adopt_weight(1.0, step, threshold=5))


def _posterior(seed):
    m = np.random.RandomState(seed).randn(2, 4, 4, 8).astype(np.float32)
    return JDiagonalGaussian(jnp.asarray(m)), DiagonalGaussian(_nchw(m), channel_axis=1)


@pytest.mark.parametrize("step,d_weight", [(DISC_START - 1, None), (DISC_START, None),
                                           (DISC_START + 3, 0.7)])
def test_generator_loss_matches_jax(losses, step, d_weight):
    jl, tree, pl = losses
    x, rec = _images(7)
    jpost, ppost = _posterior(8)
    ref, rlog = jl.generator_loss(tree, jnp.asarray(x), jnp.asarray(rec), jpost, step,
                                  None if d_weight is None else jnp.asarray(d_weight))
    before = {k: v.clone() for k, v in pl.discriminator.state_dict().items()}
    with torch.no_grad():
        out, log = pl.generator_loss(_nchw(x), _nchw(rec), ppost, step,
                                     None if d_weight is None else torch.tensor(d_weight))
    assert set(log) == set(rlog)
    for k in rlog:
        np.testing.assert_allclose(float(log[k]), float(rlog[k]), rtol=1e-4, err_msg=k)
    # the generator branch leaves the running statistics as they were
    for k, v in pl.discriminator.state_dict().items():
        torch.testing.assert_close(v, before[k], atol=0, rtol=0)


def test_discriminator_loss_matches_jax(losses):
    jl, tree, pl = losses
    x, rec = _images(9)
    ref, rlog, st = jl.discriminator_loss(tree, jnp.asarray(x), jnp.asarray(rec), DISC_START)
    saved = {k: v.clone() for k, v in pl.state_dict().items()}
    try:
        with torch.no_grad():
            out, log, stats = pl.discriminator_loss(_nchw(x), _nchw(rec), DISC_START)
        assert set(log) == set(rlog)
        for k in rlog:
            np.testing.assert_allclose(float(log[k]), float(rlog[k]), rtol=1e-4, err_msg=k)
        # the real batch's statistics, returned and stored
        for name, s in st["batch_stats"].items():
            for leaf, key in (("mean", "running_mean"), ("var", "running_var")):
                np.testing.assert_allclose(stats[f"{name}.{key}"].numpy(), np.asarray(s[leaf]),
                                           rtol=1e-4, atol=1e-6, err_msg=f"{name}.{key}")
                torch.testing.assert_close(pl.discriminator.state_dict()[f"{name}.{key}"],
                                           stats[f"{name}.{key}"], atol=0, rtol=0)
    finally:
        pl.load_state_dict(saved)


# ---- the reconstruction pass and the adaptive weight on the tiny VAE ----

def _jax_vae(systems):
    jsys, psys, _ = systems
    return jsys.vae["image"], jsys.params["vae"]["image"], psys.vae["image"]


def test_autoencoder_forward_matches_jax(systems):
    jvae, jp, pvae = _jax_vae(systems)
    x = np.random.RandomState(10).rand(2, 64, 64, 3).astype(np.float32)
    ref, jpost = jvae.apply({"params": jp}, jnp.asarray(x))
    with torch.no_grad():
        out, post = pvae(_nchw(x))
    assert out.shape == (2, 3, 64, 64)
    _close(_nhwc(out), np.asarray(ref), 1e-4, "mode")
    _close(_nhwc(post.mean), np.asarray(jpost.mean), 1e-4, "mean")
    # unclamped: the decode leaves [0, 1] on random weights
    assert float(out.min()) < 0.0 or float(out.max()) > 1.0
    # a sample: the same noise handed to both sides
    noise = torch.randn(post.mean.shape, generator=torch.Generator().manual_seed(11))
    with torch.no_grad():
        out_s, _ = pvae(_nchw(x), generator=torch.Generator().manual_seed(11))
    z = jpost.mean + jpost.std * jnp.asarray(_nhwc(noise))
    ref_s = jvae.apply({"params": jp}, z, clamp=False, method=JAutoencoderKL.decode)
    _close(_nhwc(out_s), np.asarray(ref_s), 1e-4, "sample")


def test_adaptive_weight_matches_jax(losses, systems):
    """d_weight from one reconstruction graph (torch.autograd.grad on the
    decoder's conv_out weight) against vdtpu's jax.grad of a re-run decoder;
    then the generator loss with it."""
    jl, tree, pl = losses
    jvae, jp, pvae = _jax_vae(systems)
    rs = np.random.RandomState(12)
    z = rs.randn(2, 32, 32, 4).astype(np.float32)
    x = rs.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)

    def decode_fn(k, zz):
        p = jax.tree_util.tree_map(lambda a: a, jp)
        p["decoder"]["conv_out"]["kernel"] = k
        return jvae.apply({"params": p}, zz, clamp=False, method=JAutoencoderKL.decode)

    ref = float(jl.calculate_adaptive_weight(tree, jnp.asarray(x), decode_fn,
                                             jp["decoder"]["conv_out"]["kernel"], jnp.asarray(z)))
    # the reference lies below the clip at 1e4, so the comparison reads the
    # ratio of the two gradients' norms and not the clip
    assert 0.0 < ref < 1e4 * jl.discriminator_weight
    w = pvae.decoder.conv_out.weight
    w.requires_grad_(True)
    try:
        rec = pvae.decode(_nchw(z), clamp=False)
        nll, _ = pl.nll_and_rec(_nchw(x), rec)
        g = -torch.mean(pl.discriminator(rec))
        out = pl.calculate_adaptive_weight(nll, g, w)
        assert not out.requires_grad
        np.testing.assert_allclose(float(out), ref, rtol=1e-4)
        _, post = pvae(rec.detach().clamp(0.0, 1.0))
        loss, log = pl.generator_loss(_nchw(x), rec, post, DISC_START, last_layer=w)
        np.testing.assert_allclose(float(log["d_weight"]), ref, rtol=1e-4)
        loss.backward()
        assert w.grad is not None and bool(torch.isfinite(w.grad).all())
    finally:
        w.requires_grad_(False)
        w.grad = None
    assert gn_silu.launches == 0
