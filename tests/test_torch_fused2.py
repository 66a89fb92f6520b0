"""The whole-ResBlock int8 path (``conv="fused2"``) and vdtpu's four-flow
calibration, port against the JAX package on the CPU (f32 unless stated).

- ``resblock_plain`` (the function of ``csrc/resblock_q.cu``) against
  vdtpu's Pallas ``resblock_flat`` in interpret mode and against its jnp
  reference ``ref_resblock_flat``;
- ``enable_int8()`` over the four flows against vdtpu's ``enable_int8()``,
  the port handed the same random draws (JAX's, recomputed here);
- the row padding that lets ``torch._int_mm`` take the 0-D flows' products.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_i2i import tiny_systems_from_port
from vdtpu.ops import quant as jquant
from vdtpu.ops.pallas import qconv as jqc
from vdtpu_torch.interop.from_jax import quant_state_from_jax
from vdtpu_torch.ops import quant
from vdtpu_torch.ops.qconv import resblock_flat, resblock_plain, resblock_q
from vdtpu_torch.serving.api import FOUR_FLOWS

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_launches():
    resblock_q.launches = quant.int8_linear.launches = 0
    yield
    assert resblock_q.launches == 0 and quant.int8_linear.launches == 0
    jquant.set_policy(None)


def _resblock_inputs(c, n, with_skip, seed, b=2, h=32, w=32):
    """Flat [B, H*W, C] activations, int8 tables [3, 3, C, N], per-channel
    scales, GroupNorm affines, FiLM and an optional skip, as numpy."""
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.randn(*s).astype(np.float32)
    return dict(
        x=f(b, h * w, c) * 2 + 0.5, gn1=((rs.rand(c) + 0.5).astype(np.float32), f(c) * 0.1),
        w1q=rs.randint(-127, 128, (3, 3, c, n)).astype(np.int8),
        s1w=(rs.rand(n) * 1e-3 + 1e-4).astype(np.float32), b1=f(n) * 0.1, sx1=np.float32(0.03),
        film=f(b, n), gn2=((rs.rand(n) + 0.5).astype(np.float32), f(n) * 0.1),
        w2q=rs.randint(-127, 128, (3, 3, n, n)).astype(np.int8),
        s2w=(rs.rand(n) * 1e-3 + 1e-4).astype(np.float32), b2=f(n) * 0.1, sx2=np.float32(0.05),
        h=h, w=w, skip=f(b, h * w, n) if with_skip else None)


def _to(a, conv, dtype):
    """numpy inputs -> JAX or torch arrays in ``dtype``; the int8 tables and
    the f32 scales keep their own dtypes."""
    if a is None or isinstance(a, int):
        return a
    if isinstance(a, tuple):
        return tuple(_to(t, conv, dtype) for t in a)
    t = conv(np.asarray(a))
    if np.asarray(a).dtype == np.int8:
        return t
    return t.astype(dtype) if conv is jnp.asarray else t.to(dtype)


def _both(c, n, with_skip, dtype, seed=0):
    """(vdtpu's Pallas kernel in interpret mode, the port's plain version)
    on the same inputs, flat [B, H*W, N], as f32 numpy."""
    args = _resblock_inputs(c, n, with_skip, seed)
    jdt, pdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ja = {k: _to(v, jnp.asarray, jdt) for k, v in args.items()}
    pa = {k: _to(v, torch.from_numpy, pdt) for k, v in args.items()}
    for k in ("s1w", "s2w", "sx1", "sx2"):   # scales stay f32 on both sides
        ja[k], pa[k] = jnp.asarray(args[k]), torch.from_numpy(np.asarray(args[k]))
    ref = jqc.resblock_flat(**ja, interpret=True)
    out = resblock_flat(**pa)
    assert out.dtype == pdt and out.shape == tuple(ref.shape)
    return np.asarray(ref.astype(jnp.float32)), out.float().numpy()


# the same codes and exact integer sums on both sides; the f32 GN
# statistics, epilogues and the mid's rounding agree to f32 rounding
@pytest.mark.parametrize("c,n,with_skip", [(64, 64, False), (32, 64, True)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_resblock_plain_matches_pallas_kernel(c, n, with_skip, dtype):
    ref, out = _both(c, n, with_skip, dtype)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    assert np.abs(ref).max() > 1.0


@pytest.mark.parametrize("c,n,with_skip", [(64, 64, False), (32, 64, True)])
def test_resblock_plain_matches_reference(c, n, with_skip):
    """Against ``ref_resblock_flat``, whose two-pass variance (mean, then the
    centred second moment) can flip a borderline code: bounded as
    tests/test_qconv_resblock.py bounds the Pallas kernel against it."""
    args = _resblock_inputs(c, n, with_skip, seed=1)
    ja = {k: _to(v, jnp.asarray, jnp.float32) for k, v in args.items()}
    ref = np.asarray(jqc.ref_resblock_flat(**ja))
    pa = {k: _to(v, torch.from_numpy, torch.float32) for k, v in args.items()}
    out = resblock_flat(**pa).numpy()
    assert np.abs(out - ref).max() <= 0.02 * np.abs(ref).max()


def test_pad_rows_for_int_mm():
    """``torch._int_mm`` takes more than 16 rows: fewer are zero-padded to 24
    (the next multiple of 8 above 16), exactly, and the result sliced back."""
    rows = lambda m: quant.pad_rows(torch.zeros((m, 8), dtype=torch.int8)).shape[0]
    assert [rows(m) for m in (1, 4, 16, 17, 40)] == [24, 24, 24, 17, 40]
    x = torch.randint(-127, 128, (5, 16), dtype=torch.int8)
    padded = quant.pad_rows(x)
    assert padded.shape == (24, 16) and padded.dtype == torch.int8
    assert torch.equal(padded[:5], x) and not padded[5:].any()
    wq = torch.randint(-127, 128, (8, 16), dtype=torch.int8)
    full = padded.int() @ wq.int().t()
    assert torch.equal(full[:5], x.int() @ wq.int().t()) and not full[5:].any()
    assert quant.pad_rows(padded) is padded


# ---- vdtpu's four flows: enable_int8 on the same draws ----------------------

TIMESTEPS = (0, 250, 500, 750, 999)


@contextlib.contextmanager
def _shared_captures():
    """vdtpu's ``calibrate`` jits a fresh capture closure per flow on every
    call; the two calibrations below run the same function of the same
    model, so they share one compiled capture per flow (its defaults name
    the flow)."""
    real, cache = jax.jit, {}

    def jit(fn, *args, **kwargs):
        if fn.__name__ == "run" and fn.__defaults__:
            if fn.__defaults__ not in cache:
                cache[fn.__defaults__] = real(fn, *args, **kwargs)
            return cache[fn.__defaults__]
        return real(fn, *args, **kwargs)

    jax.jit = jit
    try:
        yield
    finally:
        jax.jit = real


def _jax_draws(jsys, n, image_size, latent_downsample, seed=0):
    """The draws of vdtpu's ``enable_int8``: one key for the ids and the
    pixels, ``fold_in(key, 7000 + i)`` for the latent probe at timestep i."""
    key = jax.random.PRNGKey(seed)
    enc_t, enc_i = jsys.ctx["text"], jsys.ctx["image"]
    ids = np.asarray(jax.random.randint(key, (2 * n, enc_t.max_len), 0, enc_t.vocab_size))
    px = np.asarray(jax.random.uniform(key, (2 * n, enc_i.image_size, enc_i.image_size, 3)))
    s = image_size // latent_downsample
    shapes = {"image": (2 * n, s, s, 4), "text": (2 * n, 96)}
    noise = {x: [np.asarray(jax.random.normal(jax.random.fold_in(key, 7000 + i), shape))
                 for i in range(len(TIMESTEPS))] for x, shape in shapes.items()}
    return ids, px, noise


@pytest.fixture(scope="module")
def four_flows():
    """(vdtpu's enable_int8 scales, vdtpu's scales on probes one ulp away,
    the port's calibrate_flows state on vdtpu's draws)."""
    jsys, psys, _ = tiny_systems_from_port()
    ids, px, noise = _jax_draws(jsys, 1, 64, 2)
    with _shared_captures():
        jsys.enable_int8(image_size=64, latent_downsample=2, n=1)
        scales = jax.device_get(jsys.params["diffuser"]["quant"])
        params = jsys.params["diffuser"]["params"]
        ctx = {c: jsys.ctx_encode(a, c) for c, a in (("text", ids), ("image", px))}
        jquant.set_policy("int8")
        ulp = jquant.calibrate(jsys.model, params, [
            (jnp.asarray(np.nextafter(x, np.float32(np.inf))), jnp.full((2,), t, jnp.int32),
             ctx[c_type], x_type, c_type)
            for x_type, c_type in FOUR_FLOWS for t, x in zip(TIMESTEPS, noise[x_type])])
        jquant.set_policy(None)
    psys.calibrate_flows(ids, px, noise, FOUR_FLOWS, TIMESTEPS)
    own = {k: v.clone() for k, v in quant.quant_state(psys.model.diffuser).items()}
    return quant_state_from_jax(scales), quant_state_from_jax(jax.device_get(ulp)), own


def test_enable_int8_four_flows_match_jax(four_flows):
    """Queue 3's rule for calibrated scales (``test_torch_int8::
    test_calibration_matches_jax`` on one flow): weight tables identical,
    weight scales within one f32 rounding, the sites no quantizer feeds
    within f32 rounding, and every other site held to vdtpu's own spread on
    probes one ulp away (RMS over sites within 3x), and within 10%."""
    theirs, ulp, own = four_flows
    assert sorted(own) == sorted(theirs) == sorted(ulp)
    for flow_part in ("image.data_blocks", "image.context_blocks", "text.data_blocks",
                      "text.context_blocks"):
        assert any(k.startswith(flow_part) for k in own), flow_part
    for k, v in own.items():
        if v.dtype == torch.int8:
            np.testing.assert_array_equal(v.numpy(), theirs[k], err_msg=k)
    rel = lambda a, keys: np.array([float(np.abs(np.asarray(a[k]) - theirs[k]).max()
                                          / np.abs(theirs[k]).max()) for k in keys])
    mine = {k: v.numpy() for k, v in own.items()}
    ws = [k for k in own if k.endswith("w_scale")]
    assert rel(mine, ws).max() <= 1.2e-7
    # inputs straight from the encoders or the probes: f32 rounding
    clean = [k for k in own if k.endswith("act_scale_kv")] + ["image.data_blocks.0.0.act_scale"]
    assert rel(mine, clean).max() <= 1e-5
    acts = [k for k in own if k.endswith(("act_scale", "act_scale_kv", "attn_shift"))]
    port, spread = rel(mine, acts), rel(ulp, acts)
    rms = lambda r: float(np.sqrt(np.mean(r ** 2)))
    assert 0 < rms(spread) < 0.05
    assert rms(port) <= 3 * rms(spread) and port.max() <= 0.1, (rms(port), rms(spread),
                                                                  port.max())
