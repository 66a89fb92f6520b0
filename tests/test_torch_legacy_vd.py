"""The legacy two-trunk diffuser (UNetModelVD) and ``vd_inference`` against
vdtpu on the CPU.

``LegacyUNetVD``: all four (xtype, ctype) routes, ``forward_dc``, the
parameter-free resamples, and a 4-step classifier-free-guided DDIM loop
over the image route (``cfg_eps_fn`` + ``ddim_loop`` against vdtpu's
``cfg_eps_fn`` + ``ddim_scan`` on the same x_T), on the weights and widths
of ``test_torch_legacy.py`` (relative L2 <= REL_L2, f32 both sides).

``vd_inference``: the config is patched to ``vd_test_tiny`` on both sides;
a ``.pt`` of the reference's keys (flat, or under ``state_dict``) loads
into the port as into vdtpu, bf16 under ``fp16``, and the non-strict load
returns the keys a partial checkpoint lacks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vdtpu.serving.api as japi
from test_torch_i2i import jax_param_templates, tiny_systems_from_port
from test_torch_legacy import CFG_0DMD, CFG_2D, CTX, T2, X84, X_JAX, carry, check, nchw, t
from vdtpu.models import legacy as JL
from vdtpu.ops.schedules import DiffusionSchedule as JDiffusionSchedule
from vdtpu.sampling import ddim as jddim
from vdtpu_torch.config.configs import model_cfg_bank
from vdtpu_torch.interop.from_jax import system_state_dict_from_jax
from vdtpu_torch.models import legacy as L
from vdtpu_torch.ops.schedules import DiffusionSchedule
from vdtpu_torch.sampling import ddim
from vdtpu_torch.serving import api

torch.set_num_threads(2)

X_TXT = np.random.RandomState(4).randn(2, 24).astype(np.float32)
C_VIS = np.random.RandomState(5).randn(2, 9, 16).astype(np.float32)
IMG_CFG = {"type": "openai_unet_2d", "args": dict(CFG_2D)}
TXT_CFG = {"type": "openai_unet_0dmd", "args": dict(CFG_0DMD)}


def _vd_pair(img_cfg=IMG_CFG, seed: int = 8):
    jm = JL.LegacyUNetVD(img_cfg, TXT_CFG)
    pm = L.LegacyUNetVD(img_cfg, TXT_CFG).eval()
    params = carry(jm, pm, X_JAX, jnp.asarray(X_TXT), jnp.asarray(T2), jnp.asarray(C_VIS),
                   jnp.asarray(CTX), seed=seed, method=JL.LegacyUNetVD.init_walk)
    return jm, pm, params


@pytest.fixture(scope="module")
def vd():
    return _vd_pair()


@pytest.mark.parametrize("xtype,ctype", [("image", "prompt"), ("image", "vision"),
                                         ("text", "prompt"), ("text", "vision")])
def test_unet_vd_routes(vd, xtype, ctype):
    """The zip walk's four routes: data layers from the xtype trunk, context
    layers from the image trunk for vision, else the text trunk."""
    jm, pm, params = vd
    x_j, x_p = (X_JAX, t(X84)) if xtype == "image" else (jnp.asarray(X_TXT), t(X_TXT))
    c = C_VIS if ctype == "vision" else CTX
    want = jm.apply({"params": params}, x_j, jnp.asarray(T2), jnp.asarray(c),
                    xtype=xtype, ctype=ctype)
    want = nchw(want) if xtype == "image" else np.asarray(want)
    with torch.no_grad():
        got = pm(x_p, t(T2), t(c), xtype=xtype, ctype=ctype).numpy()
    check(got, want, f"{xtype}/{ctype}")


@pytest.mark.parametrize("xtype", ["image", "text"])
def test_unet_vd_forward_dc(vd, xtype):
    """forward_dc: each context layer's delta of two contexts (vision 9
    tokens, prompt 7) blended at r = 0.25."""
    jm, pm, params = vd
    x_j, x_p = (X_JAX, t(X84)) if xtype == "image" else (jnp.asarray(X_TXT), t(X_TXT))
    want = jm.apply({"params": params}, x_j, jnp.asarray(T2), jnp.asarray(C_VIS),
                    jnp.asarray(CTX), xtype, "vision", "prompt", 0.25,
                    method=JL.LegacyUNetVD.forward_dc)
    want = nchw(want) if xtype == "image" else np.asarray(want)
    with torch.no_grad():
        got = pm.forward_dc(x_p, t(T2), t(C_VIS), t(CTX), xtype, "vision", "prompt",
                            0.25).numpy()
    check(got, want, f"forward_dc {xtype}")


def test_unet_vd_paramfree_resample():
    """conv_resample False in the image trunk: the average pool and the
    nearest upsample walk through the zip dispatcher."""
    jm, pm, params = _vd_pair({"type": "openai_unet_2d",
                               "args": dict(CFG_2D, conv_resample=False)}, seed=9)
    want = nchw(jm.apply({"params": params}, X_JAX, jnp.asarray(T2), jnp.asarray(CTX),
                         xtype="image", ctype="prompt"))
    with torch.no_grad():
        got = pm(t(X84), t(T2), t(CTX), xtype="image", ctype="prompt").numpy()
    check(got, want)


def test_vd_cfg_ddim_loop(vd):
    """4 DDIM steps at CFG 7.5 over the image route: the port's cfg_eps_fn
    + ddim_loop against vdtpu's cfg_eps_fn + ddim_scan, on the same x_T."""
    jm, pm, params = vd
    args = (1000, "linear", 0.00085, 0.012)
    jt = jddim.DDIMTables.create(JDiffusionSchedule.create(*args), 4, 0.0)
    pt = ddim.DDIMTables.create(DiffusionSchedule.create(*args), 4, 0.0)
    uncond = np.random.RandomState(6).randn(2, 7, 16).astype(np.float32)
    jeps = jddim.cfg_eps_fn(
        lambda x, tt, c: jm.apply({"params": params}, x, tt, c, xtype="image",
                                  ctype="prompt"), jnp.asarray(CTX), jnp.asarray(uncond), 7.5)
    want = jddim.ddim_scan(jeps, X_JAX, jax.random.PRNGKey(0), jt)
    peps = ddim.cfg_eps_fn(lambda x, tt, c: pm(x, tt, c, xtype="image", ctype="prompt"),
                           t(CTX), t(uncond), 7.5)
    with torch.no_grad():
        got = ddim.ddim_loop(peps, t(X84), pt).numpy()
    check(got, nchw(want))


# ---- vd_inference ----

@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    """A complete tiny checkpoint of the reference's keys, saved two ways."""
    _, _, sd = tiny_systems_from_port(seed=3)
    sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    root = tmp_path_factory.mktemp("vd_inference")
    nested, flat = root / "nested.pt", root / "flat.pt"
    torch.save({"state_dict": sd}, nested)
    torch.save(sd, flat)
    return sd, nested, flat


@pytest.fixture
def tiny_bank(monkeypatch):
    """vd_inference builds ``vd_four_flow_v1-0``: both packages' banks give
    ``vd_test_tiny`` under that name here."""
    port_bank, jax_bank = model_cfg_bank, japi.model_cfg_bank
    monkeypatch.setattr(api, "model_cfg_bank", lambda: lambda name: port_bank()("vd_test_tiny"))
    monkeypatch.setattr(japi, "model_cfg_bank",
                        lambda: lambda name: jax_bank()("vd_test_tiny"))


@pytest.mark.parametrize("fp16", [False, True])
def test_vd_inference_loads_as_vdtpu(tiny_checkpoint, tiny_bank, monkeypatch, fp16):
    """The port's vd_inference and vdtpu's on the same ``{"state_dict":
    ...}`` .pt: the same weights key for key, bf16 under fp16 (vdtpu's
    seeded init is replaced by its shapes: a complete checkpoint overwrites
    every leaf)."""
    sd, nested, _ = tiny_checkpoint
    monkeypatch.setattr(japi.VDSystem, "init_random",
                        lambda self, seed=0: setattr(self, "params", jax_param_templates(self))
                        or self)
    jvdi = japi.vd_inference(fp16=fp16, checkpoint=str(nested))
    vdi = api.vd_inference(fp16=fp16, checkpoint=str(nested), device="cpu", ddim_steps=4)
    assert isinstance(vdi, api.VDInference) and vdi.ddim_steps == 4
    dtype = torch.bfloat16 if fp16 else torch.float32
    jsd = system_state_dict_from_jax(jax.device_get(jvdi.sys.params))
    own = vdi.sys.net.state_dict()
    assert set(own) == set(jsd)
    for k, v in own.items():
        assert v.dtype == dtype, k
        assert np.array_equal(v.float().numpy(), np.asarray(jsd[k], np.float32)), k
        assert torch.equal(v, sd[k].to(dtype)), k


def test_vd_inference_flat_dict_missing_keys_and_which(tiny_checkpoint, tiny_bank, tmp_path):
    """A flat .pt loads as the nested one; the non-strict load returns the
    keys a partial dict lacks; another ``which`` raises."""
    sd, nested, flat = tiny_checkpoint
    a = api.vd_inference(checkpoint=str(flat), device="cpu").sys.net.state_dict()
    b = api.vd_inference(checkpoint=str(nested), device="cpu").sys.net.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    dropped = sorted(k for k in sd if k.startswith("ctx.text."))
    assert dropped
    partial = {k: v for k, v in sd.items() if k not in dropped}
    system = api.VDSystem("vd_four_flow_v1-0", device="cpu").init_random(0)
    before = {k: v.clone() for k, v in system.net.state_dict().items() if k in dropped}
    assert sorted(system.load_torch_checkpoint(partial)) == dropped
    own = system.net.state_dict()
    assert all(torch.equal(own[k], before[k]) for k in dropped)     # kept from the init
    assert all(torch.equal(own[k], partial[k]) for k in partial if k in own)
    path = tmp_path / "partial.pt"
    torch.save({"state_dict": partial}, path)
    vdi = api.vd_inference(checkpoint=str(path), device="cpu")
    assert all(torch.equal(vdi.sys.net.state_dict()[k], partial[k]) for k in partial
               if k in own)
    with pytest.raises(ValueError, match="not supported"):
        api.vd_inference(which="v2.0", device="cpu")


def test_vd_inference_takes_the_card_by_default(tiny_bank, monkeypatch):
    """No device named: the card, and no silent CPU fallback without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.vd_inference()


def test_lazy_public_surface():
    import vdtpu
    import vdtpu_torch
    for name in vdtpu._LAZY:
        assert name in dir(vdtpu_torch)
        assert getattr(vdtpu_torch, name) is not None
    assert vdtpu_torch.vd_inference is api.vd_inference
    assert vdtpu_torch.model_cfg_bank is model_cfg_bank
    with pytest.raises(AttributeError):
        vdtpu_torch.not_a_name  # noqa: B018
