"""The port's legacy diffuser zoo (``vdtpu_torch/models/legacy.py``)
against ``vdtpu.models.legacy``, family by family, in f32 on the CPU.

Same weights on both sides: the JAX module's init, its all-zero arrays
(zero-initialized output convs and projections, biases) replaced by seeded
normals, carried into the port through ``legacy_state_dict_from_jax`` and
loaded with ``strict=True``. Same seeded numpy inputs at the tiny widths of
``tests/test_legacy.py`` (32 channels, mult [1, 2], 8^2 maps, context
7 x 16); the port runs NCHW, so maps are transposed. Tolerance: relative
L2 <= REL_L2 (f32 on both sides, other summation orders only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdtpu.models import legacy as JL
from vdtpu_torch.config.registry import build
from vdtpu_torch.interop.from_jax import legacy_state_dict_from_jax
from vdtpu_torch.models import legacy as L
from vdtpu_torch.models.layers import init_random
from vdtpu_torch.models.transformer import SpatialTransformer
from vdtpu_torch.ops.flash import flash_attention
from vdtpu_torch.ops.gn_silu import gn_silu

torch.set_num_threads(2)

REL_L2 = 1e-5

X84 = np.random.RandomState(0).randn(2, 4, 8, 8).astype(np.float32)
T2 = np.array([3, 500], dtype=np.int64)
CTX = np.random.RandomState(1).randn(2, 7, 16).astype(np.float32)
CTX9 = np.random.RandomState(7).randn(2, 9, 16).astype(np.float32)
X_JAX = jnp.asarray(X84.transpose(0, 2, 3, 1))

SD_KW = dict(image_size=8, in_channels=4, model_channels=32, out_channels=4,
             num_res_blocks=1, attention_resolutions=[1, 2], channel_mult=[1, 2],
             num_heads=4, use_spatial_transformer=True, context_dim=16)
CFG_2D = dict(input_channels=4, model_channels=32, output_channels=4,
              context_dim=16, num_noattn_blocks=(1, 1), channel_mult=(1, 2),
              with_attn=[True, False], num_heads=4, use_checkpoint=False)
CFG_0D = dict(input_channels=24, model_channels=32, output_channels=24,
              context_dim=16, num_noattn_blocks=(1, 1), channel_mult=(1, 2),
              with_attn=[True, False], num_heads=4, use_checkpoint=False)
CFG_0DMD = dict(CFG_0D, second_dim=(4, 4))


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    """CPU tensors take the plain versions: no kernel launches."""
    flash_attention.launches = gn_silu.launches = 0
    yield
    assert flash_attention.launches == 0 and gn_silu.launches == 0


def derandomize(params, seed: int):
    """Every all-zero leaf replaced by N(0, 0.02) draws (a zero output
    conv would make a block an identity and prove nothing)."""
    rs = np.random.RandomState(seed)
    flat, tree = jax.tree_util.tree_flatten(jax.device_get(params))
    flat = [rs.normal(0, 0.02, np.shape(a)).astype(np.float32) if not np.any(a)
            else np.asarray(a) for a in flat]
    return jax.tree_util.tree_unflatten(tree, flat)


def carry(jmod, port, *init_args, seed: int = 0, method=None):
    """JAX params (init, derandomized) loaded into ``port`` strictly."""
    params = jmod.init(jax.random.PRNGKey(seed), *init_args, method=method)["params"]
    params = derandomize(params, seed)
    sd = legacy_state_dict_from_jax(params)
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                         strict=True)
    return params


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def t(a):
    return torch.from_numpy(np.array(a))


def check(got, want, what: str = ""):
    assert np.isfinite(got).all(), what
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = rel_l2(got, want)
    assert err <= REL_L2, f"{what}: relative L2 {err:.3e} > {REL_L2}"


def _conv_case(jcls, pcls, kw, *, context=None, y=None, seed=0, **call):
    jm, pm = jcls(**kw), pcls(**kw).eval()
    args = [X_JAX, jnp.asarray(T2)]
    if context is not None or y is not None:
        args.append(None if context is None else jnp.asarray(context))
    if y is not None:
        args.append(jnp.asarray(y))
    params = carry(jm, pm, *args, seed=seed)
    want = nchw(jm.apply({"params": params}, *args, **call))
    with torch.no_grad():
        got = pm(t(X84), t(T2), None if context is None else t(context),
                 **({"y": t(y)} if y is not None else {}), **call).numpy()
    check(got, want)
    return pm


def test_openai_unet_spatial_transformer():
    """SD-style UNetModel: spatial transformers on the context."""
    _conv_case(JL.LegacyUNetModel, L.LegacyUNetModel, SD_KW, context=CTX, seed=1)


def test_disable_self_attn_spatial_transformer():
    """disable_self_attentions: attn1 attends to the context too (its k/v
    projections take context_dim inputs)."""
    kw = dict(SD_KW, disable_self_attentions=[True, False])
    pm = _conv_case(JL.LegacyUNetModel, L.LegacyUNetModel, kw, context=CTX, seed=2)
    st = pm.input_blocks[1][1]
    assert isinstance(st, SpatialTransformer)
    assert st.transformer_blocks[0].attn1.to_k.in_features == 16
    assert pm.input_blocks[3][1].transformer_blocks[0].attn1.to_k.in_features == 64


def test_spatial_transformer_disable_self_attn_module():
    """The module alone on the [B, C, N] view: JAX's SpatialTransformer
    with disable_self_attn against the port's, tokens of another length
    than the context."""
    from vdtpu.models.transformer import SpatialTransformer as JST
    x = np.random.RandomState(4).randn(2, 12, 32).astype(np.float32)
    jm = JST(32, 4, 8, disable_self_attn=True)
    pm = SpatialTransformer(32, 4, 8, 16, disable_self_attn=True).eval()
    params = derandomize(jm.init(jax.random.PRNGKey(3), jnp.asarray(x),
                                 jnp.asarray(CTX))["params"], 3)
    sd = legacy_state_dict_from_jax({"st": params})
    pm.load_state_dict({k[3:]: t(v) for k, v in sd.items()}, strict=True)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(CTX)))
    with torch.no_grad():
        got = pm(t(x).transpose(1, 2), t(CTX)).transpose(1, 2).numpy()
    check(got, want)


@pytest.mark.parametrize("new_order", [False, True])
def test_openai_unet_attention_block(new_order):
    """The self-attention AttentionBlock, both qkv orders."""
    kw = dict(image_size=8, in_channels=4, model_channels=32, out_channels=4,
              num_res_blocks=1, attention_resolutions=[2], channel_mult=[1, 2],
              num_heads=4, use_new_attention_order=new_order)
    _conv_case(JL.LegacyUNetModel, L.LegacyUNetModel, kw, seed=3 + new_order)


def test_openai_unet_scale_shift_updown_classcond():
    """Guided-diffusion options: scale-shift FiLM, resblock up/down, the
    class embedding, num_head_channels."""
    kw = dict(image_size=8, in_channels=4, model_channels=32, out_channels=4,
              num_res_blocks=1, attention_resolutions=[2], channel_mult=[1, 2],
              num_heads=-1, num_head_channels=8, use_scale_shift_norm=True,
              resblock_updown=True, num_classes=5)
    _conv_case(JL.LegacyUNetModel, L.LegacyUNetModel, kw, y=np.array([1, 4]), seed=5)


def test_openai_unet_id_predictor_pool_nn_up():
    """n_embed (the id_predictor head, no SiLU) and conv_resample False (the
    parameter-free average pool and nearest upsample)."""
    kw = dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
              attention_resolutions=[2], channel_mult=[1, 2], num_heads=2,
              conv_resample=False, n_embed=12)
    pm = _conv_case(JL.LegacyUNetModel, L.LegacyUNetModel, kw, seed=6)
    assert not list(pm.input_blocks[2].parameters())


def test_dual_context():
    """UNetModelDualContext: one branch (which_attn 0 or 1) and the blend
    of two contexts of different lengths (7 and 9 tokens)."""
    jm, pm = JL.LegacyUNetDualContext(**SD_KW), L.LegacyUNetDualContext(**SD_KW).eval()
    params = carry(jm, pm, X_JAX, jnp.asarray(T2), jnp.asarray(CTX), None, 0, seed=7)
    for which in (0, 1):
        want = nchw(jm.apply({"params": params}, X_JAX, jnp.asarray(T2), jnp.asarray(CTX),
                             which_attn=which))
        with torch.no_grad():
            got = pm(t(X84), t(T2), t(CTX), which_attn=which).numpy()
        check(got, want, f"which {which}")
    want = nchw(jm.apply({"params": params}, X_JAX, jnp.asarray(T2),
                         (jnp.asarray(CTX), jnp.asarray(CTX9)), which_attn=0.3))
    with torch.no_grad():
        got = pm(t(X84), t(T2), (t(CTX), t(CTX9)), which_attn=0.3).numpy()
    check(got, want, "blend 0.3")


@pytest.mark.parametrize("st", [False, True])
def test_nocontext(st):
    """UNetModelNoContext: the AttentionBlock, or spatial transformers whose
    attn2 is a self-attention; a context passed in is ignored."""
    kw = dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
              attention_resolutions=[2], channel_mult=[1, 2], num_heads=4,
              use_spatial_transformer=st)
    jm, pm = JL.LegacyUNetNoContext(**kw), L.LegacyUNetNoContext(**kw).eval()
    params = carry(jm, pm, X_JAX, jnp.asarray(T2), seed=8 + st)
    want = nchw(jm.apply({"params": params}, X_JAX, jnp.asarray(T2)))
    with torch.no_grad():
        got = pm(t(X84), t(T2), t(CTX)).numpy()
    check(got, want)


def test_nocontext_noatt_and_decoderonly():
    kw = dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
              channel_mult=[1, 2])
    _conv_case(JL.LegacyUNetNoContextNoAtt, L.LegacyUNetNoContextNoAtt, kw, seed=10)
    for seed, extra in ((11, {}), (12, dict(use_scale_shift_norm=True, resblock_updown=True)),
                        (13, dict(conv_resample=False))):
        kw = dict(in_channels=4, out_channels=3, model_channels=32, num_res_blocks=1,
                  channel_mult=[2, 1], **extra)
        jm, pm = JL.LegacyDecoderOnly(**kw), L.LegacyDecoderOnly(**kw).eval()
        params = carry(jm, pm, X_JAX, jnp.asarray(T2), seed=seed)
        want = nchw(jm.apply({"params": params}, X_JAX, jnp.asarray(T2)))
        with torch.no_grad():
            got = pm(t(X84), t(T2)).numpy()
        check(got, want, f"decoder-only {extra}")


def test_unet_2d_legacy():
    """UNetModel2D through the factory that takes the reference's names."""
    jm, pm = JL.legacy_unet_2d(**CFG_2D), L.legacy_unet_2d(**CFG_2D).eval()
    params = carry(jm, pm, X_JAX, jnp.asarray(T2), jnp.asarray(CTX), seed=14)
    want = nchw(jm.apply({"params": params}, X_JAX, jnp.asarray(T2), jnp.asarray(CTX)))
    with torch.no_grad():
        got = pm(t(X84), t(T2), t(CTX)).numpy()
    check(got, want)


@pytest.mark.parametrize("md", [False, True])
def test_unet_0d_legacy(md):
    """UNetModel0D on a [B, C] input (the [B, C, 1, 1] map: real 1x1 and
    3x3 stride-2 convs) and UNetModel0D_MultiDim (flat [B, C*S])."""
    x = np.random.RandomState(2 + md).randn(2, 24).astype(np.float32)
    jcls, pcls = (JL.LegacyUNet0DMultiDim, L.LegacyUNet0DMultiDim) if md else \
        (JL.LegacyUNet0D, L.LegacyUNet0D)
    kw = CFG_0DMD if md else CFG_0D
    jm, pm = jcls(**kw), pcls(**kw).eval()
    params = carry(jm, pm, jnp.asarray(x), jnp.asarray(T2), jnp.asarray(CTX), seed=15 + md)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(T2),
                               jnp.asarray(CTX)))
    with torch.no_grad():
        got = pm(t(x), t(T2), t(CTX)).numpy()
    check(got, want)
    if not md:   # the [B, C, 1, 1] input takes the same path
        with torch.no_grad():
            check(pm(t(x)[:, :, None, None], t(T2), t(CTX)).numpy(), want, "[B, C, 1, 1]")


_REGISTRY_CASES = [
    ("openai_unet", SD_KW, "ctx"), ("openai_unet_dual_context", SD_KW, "dual"),
    ("openai_unet_nocontext", dict(SD_KW, use_spatial_transformer=False), "none"),
    ("openai_unet_nocontext_noatt", dict(in_channels=4, model_channels=32, out_channels=4,
                                         num_res_blocks=1, channel_mult=[1, 2]), "none"),
    ("openai_unet_nocontext_noatt_decoderonly", dict(model_channels=32, channel_mult=[2, 1],
                                                     num_res_blocks=1), "dec"),
    ("openai_unet_2d", CFG_2D, "ctx"), ("openai_unet_0d", CFG_0D, "0d"),
    ("openai_unet_0dmd", CFG_0DMD, "0d"),
    ("openai_unet_vd", {"unet_image_cfg": {"type": "openai_unet_2d", "args": CFG_2D},
                        "unet_text_cfg": {"type": "openai_unet_0dmd", "args": CFG_0DMD}},
     "vd"),
]


@pytest.mark.parametrize("name,args,call", _REGISTRY_CASES, ids=[c[0] for c in _REGISTRY_CASES])
def test_registry_builds_each_family(name, args, call):
    """``build({"type", "args"})`` gives the family's module, and it runs."""
    from vdtpu.config.registry import get_builder
    model = build({"type": name, "args": args}).eval()
    init_random(model, torch.Generator().manual_seed(0))
    assert type(model).__name__ == (get_builder(name)(**args).__class__.__name__
                                    if name != "openai_unet_2d" else "LegacyUNet2D")
    x0 = torch.zeros(2, 24)
    with torch.no_grad():
        out = {"ctx": lambda: model(t(X84), t(T2), t(CTX)),
               "dual": lambda: model(t(X84), t(T2), t(CTX), which_attn=1),
               "none": lambda: model(t(X84), t(T2)),
               "dec": lambda: model(t(X84), t(T2)),
               "0d": lambda: model(x0, t(T2), t(CTX)),
               "vd": lambda: model(x0, t(T2), t(CTX), xtype="text")}[call]()
    assert torch.isfinite(out).all()


def test_options_that_raise():
    with pytest.raises(ValueError):
        L.LegacyUNetModel(dims=3)
    with pytest.raises(ValueError):
        L.LegacyUNetModel(use_spatial_transformer=True, attention_resolutions=[1])
    with pytest.raises(TypeError):
        L.LegacyUNetModel(not_an_option=1)
    L.LegacyUNetModel(**SD_KW, use_fp16=True)   # accepted and ignored, as image_size


def test_load_by_rank():
    """Reference weights load by rank: the AttentionBlock's width-1 Conv1d
    qkv / proj_out ([O, I, 1]) and 1x1 Conv2d weights ([O, I, 1, 1]) into
    the port's [O, I] layers, a [O, I] weight into a 1x1 conv layer; a
    Conv1d of width 3 raises."""
    kw = dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
              attention_resolutions=[2], channel_mult=[1, 2], num_heads=4,
              use_spatial_transformer=False)
    src = L.LegacyUNetModel(**kw)
    init_random(src, torch.Generator().manual_seed(0))
    sd = {k: v.clone() for k, v in src.state_dict().items()}
    for k, v in list(sd.items()):
        if k.endswith((".qkv.weight", ".proj_out.weight")):
            sd[k] = v[:, :, None] if k.startswith("input") else v[:, :, None, None]
    dst = L.LegacyUNetModel(**kw)
    dst.load_state_dict(sd, strict=True)
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    # the spatial transformers' 1x1 convs ([O, I, 1, 1] in the port) take [O, I]
    st_src = L.LegacyUNetModel(**SD_KW)
    init_random(st_src, torch.Generator().manual_seed(1))
    sd = {k: (v[:, :, 0, 0] if k.endswith("proj_in.weight") else v)
          for k, v in st_src.state_dict().items()}
    st_dst = L.LegacyUNetModel(**SD_KW)
    st_dst.load_state_dict(sd, strict=True)
    assert torch.equal(st_dst.input_blocks[1][1].proj_in.weight,
                       st_src.input_blocks[1][1].proj_in.weight)
    bad = dict(src.state_dict())
    w = bad["middle_block.1.qkv.weight"]
    bad["middle_block.1.qkv.weight"] = w[:, :, None].expand(-1, -1, 3).contiguous()
    with pytest.raises(ValueError, match="width 3"):
        L.LegacyUNetModel(**kw).load_state_dict(bad)


def test_remat_same_forward_and_grad():
    """use_checkpoint rematerializes under autograd: the same output and
    gradients as without."""
    a = L.LegacyUNetModel(**SD_KW, use_checkpoint=True)
    init_random(a, torch.Generator().manual_seed(0))
    b = L.LegacyUNetModel(**SD_KW)
    b.load_state_dict(a.state_dict())
    x = t(X84).requires_grad_()
    outs = []
    for m in (a, b):
        out = m(x, t(T2), t(CTX))
        g = torch.autograd.grad(out.square().sum(), [x, *m.parameters()])
        outs.append((out.detach(), g))
    assert torch.allclose(outs[0][0], outs[1][0])
    for ga, gb in zip(outs[0][1], outs[1][1]):
        assert torch.allclose(ga, gb, rtol=1e-5, atol=1e-6)


def _chip_smoke():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_legacy", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_DC = {"unet_image_cfg": {"type": "openai_unet_2d", "args": CFG_2D},
       "unet_text_cfg": {"type": "openai_unet_0dmd", "args": CFG_0DMD}}
_SITE_CASES = [   # (id, type, args, call(model, x, x0, c, c9), legacy_sites keywords)
    ("st-disable-self", "openai_unet", dict(SD_KW, disable_self_attentions=[True, False]),
     lambda m, x, x0, c, c9: m(x, t(T2), c), dict(side=8, ctx=7)),
    ("attn-legacy", "openai_unet", dict(SD_KW, use_spatial_transformer=False),
     lambda m, x, x0, c, c9: m(x, t(T2)), dict(side=8)),
    ("attn-new", "openai_unet", dict(SD_KW, use_spatial_transformer=False,
                                     use_new_attention_order=True),
     lambda m, x, x0, c, c9: m(x, t(T2)), dict(side=8)),
    ("scale-shift-updown", "openai_unet",
     dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
          attention_resolutions=[2], channel_mult=[1, 2], num_heads=-1, num_head_channels=8,
          use_scale_shift_norm=True, resblock_updown=True, num_classes=5),
     lambda m, x, x0, c, c9: m(x, t(T2), None, torch.tensor([1, 4])), dict(side=8)),
    ("id-pool", "openai_unet", dict(in_channels=4, model_channels=32, out_channels=4,
                                    num_res_blocks=1, attention_resolutions=[2],
                                    channel_mult=[1, 2], num_heads=2, conv_resample=False,
                                    n_embed=12),
     lambda m, x, x0, c, c9: m(x, t(T2)), dict(side=8)),
    ("dual-0", "openai_unet_dual_context", SD_KW,
     lambda m, x, x0, c, c9: m(x, t(T2), c, which_attn=0), dict(side=8, ctx=7, which=0)),
    ("dual-1", "openai_unet_dual_context", SD_KW,
     lambda m, x, x0, c, c9: m(x, t(T2), c9, which_attn=1), dict(side=8, ctx=9, which=1)),
    ("dual-blend", "openai_unet_dual_context", SD_KW,
     lambda m, x, x0, c, c9: m(x, t(T2), (c, c9), which_attn=0.3), dict(side=8, ctx=(7, 9))),
    ("nocontext-st", "openai_unet_nocontext", dict(SD_KW, context_dim=None),
     lambda m, x, x0, c, c9: m(x, t(T2)), dict(side=8)),
    ("noatt", "openai_unet_nocontext_noatt",
     dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
          channel_mult=[1, 2]), lambda m, x, x0, c, c9: m(x, t(T2)), dict(side=8)),
    ("decoder-res-up", "openai_unet_nocontext_noatt_decoderonly",
     dict(model_channels=32, channel_mult=[2, 1], num_res_blocks=1, resblock_updown=True,
          use_scale_shift_norm=True), lambda m, x, x0, c, c9: m(x, t(T2)), dict(side=8)),
    ("2d", "openai_unet_2d", CFG_2D, lambda m, x, x0, c, c9: m(x, t(T2), c),
     dict(side=8, ctx=7)),
    ("0d", "openai_unet_0d", CFG_0D, lambda m, x, x0, c, c9: m(x0, t(T2), c), dict(ctx=7)),
    ("0dmd", "openai_unet_0dmd", CFG_0DMD, lambda m, x, x0, c, c9: m(x0, t(T2), c),
     dict(ctx=7)),
    ("vd-image", "openai_unet_vd", _DC,
     lambda m, x, x0, c, c9: m(x, t(T2), c9, xtype="image", ctype="vision"),
     dict(side=8, ctx=9)),
    ("vd-text", "openai_unet_vd", _DC,
     lambda m, x, x0, c, c9: m(x0, t(T2), c, xtype="text", ctype="prompt"),
     dict(ctx=7, xtype="text")),
    ("vd-dc-image", "openai_unet_vd", _DC,
     lambda m, x, x0, c, c9: m.forward_dc(x, t(T2), c9, c, "image", "vision", "prompt", 0.3),
     dict(side=8, ctx=(9, 7))),
    ("vd-dc-text", "openai_unet_vd", _DC,
     lambda m, x, x0, c, c9: m.forward_dc(x0, t(T2), c9, c, "text", "vision", "prompt", 0.3),
     dict(ctx=(9, 7), xtype="text")),
]


@pytest.mark.parametrize("kind,args,call,where", [c[1:] for c in _SITE_CASES],
                         ids=[c[0] for c in _SITE_CASES])
def test_chip_smoke_legacy_sites_match_the_walk(monkeypatch, kind, args, call, where):
    """chip_smoke.py derives main_legacy's launch counts from the layer
    program (``legacy_sites``): its GroupNorm input shapes and attention
    sites (queries, keys, heads, d_head) equal those one call makes."""
    from vdtpu_torch.models import layers
    from vdtpu_torch.ops import attention
    cs = _chip_smoke()
    model = build({"type": kind, "args": dict(args)}).eval()
    init_random(model, torch.Generator().manual_seed(0))
    gn, attn = [], []
    inner_gn, inner_pick = layers.gn_silu, attention.pick_backend
    monkeypatch.setattr(layers, "gn_silu",
                        lambda x, *a: gn.append(tuple(x.shape)) or inner_gn(x, *a))
    monkeypatch.setattr(attention, "pick_backend", lambda q, k: attn.append(
        (q.shape[1], k.shape[1], q.shape[2], q.shape[3])) or inner_pick(q, k))
    with torch.no_grad():
        call(model, t(X84), torch.zeros(2, 24), t(CTX), t(CTX9))
    want_gn, want_attn = cs.legacy_sites(model, 2, **where)
    assert sorted(gn) == sorted(want_gn)
    assert sorted(attn) == sorted(want_attn)
