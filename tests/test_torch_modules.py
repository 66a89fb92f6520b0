"""The port's kernel-holding modules against the JAX modules.

Same weights on both sides: flax params from init, their all-zero arrays
(zero-initialized output projections and biases) replaced by seeded
normals, carried into the port through ``state_dict_from_jax`` and loaded
with ``strict=True``. Same seeded numpy inputs; the port runs NCHW, so
inputs and outputs are transposed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdtpu.models.blocks import ResBlock2D as JResBlock2D
from vdtpu.models.transformer import SpatialTransformer as JSpatialTransformer
from vdtpu.ops.attention import set_attention_backend as jax_set_backend
from vdtpu_torch.interop.from_jax import state_dict_from_jax
from vdtpu_torch.models.blocks import ResBlock2D
from vdtpu_torch.models.transformer import SpatialTransformer
from vdtpu_torch.ops import attention
from vdtpu_torch.ops.flash import flash_attention
from vdtpu_torch.ops.gn_silu import gn_silu

torch.set_num_threads(2)


def _derandomize(params, seed: int):
    """Replace every all-zero leaf with N(0, 0.02) draws (a zero proj_out
    or output conv would make the module an identity and prove nothing)."""
    rs = np.random.RandomState(seed)
    flat, tree = jax.tree_util.tree_flatten(params)
    flat = [rs.normal(0, 0.02, np.shape(a)).astype(np.float32) if not np.any(a)
            else np.asarray(a) for a in flat]
    return jax.tree_util.tree_unflatten(tree, flat)


def _load(module, params, prefix):
    sd = state_dict_from_jax(params, prefix)
    module.load_state_dict({k[len(prefix):]: torch.from_numpy(np.array(v))
                            for k, v in sd.items()}, strict=True)
    return module.eval()


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    flash_attention.launches = gn_silu.launches = 0
    yield
    assert flash_attention.launches == 0 and gn_silu.launches == 0


# f32 through GN, two LayerNorms, three attentions and a GEGLU MLP at 1024
# tokens: the two frameworks sum in different orders (measured max 1.5e-6
# on outputs up to 5); 2e-5 leaves room for other BLAS builds
@pytest.mark.parametrize("backend", ["auto", "flash"])
def test_spatial_transformer_1024_tokens(backend, monkeypatch):
    """"flash" routes every site of both sides through the flash function:
    the Pallas kernel in interpret mode, and the port's wrapper, which on
    CPU tensors runs its plain version."""
    c, heads, dh, ctx_dim, n = 320, 8, 40, 96, 1024
    rs = np.random.RandomState(0)
    tokens = rs.randn(1, n, c).astype(np.float32)
    ctx = rs.randn(1, 77, ctx_dim).astype(np.float32)
    jm = JSpatialTransformer(c, heads, dh)
    params = _derandomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(tokens),
                                  jnp.asarray(ctx))["params"], 1)
    prefix = "diffuser.image.context_blocks.0.0."   # where proj_in/out are 1x1 convs
    pm = _load(SpatialTransformer(c, heads, dh, ctx_dim), params, prefix)
    if backend == "flash":
        monkeypatch.setattr(attention, "pick_backend", lambda q, k: "flash")
    jax_set_backend(None if backend == "auto" else backend)
    try:
        ref = jm.apply({"params": params}, jnp.asarray(tokens), jnp.asarray(ctx))
    finally:
        jax_set_backend(None)
    with torch.no_grad():
        out = pm(torch.from_numpy(tokens).transpose(1, 2).contiguous(), torch.from_numpy(ctx))
    np.testing.assert_allclose(out.transpose(1, 2).numpy(), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)


# f32 through two GN+SiLU and two 3x3 convs: conv summation order differs
@pytest.mark.parametrize("cin,cout", [(64, 64), (64, 128)])
def test_resblock2d(cin, cout):
    rs = np.random.RandomState(cin + cout)
    x = rs.randn(2, 16, 16, cin).astype(np.float32)
    emb = rs.randn(2, 256).astype(np.float32)
    jm = JResBlock2D(cin, cout)
    params = _derandomize(jm.init(jax.random.PRNGKey(1), jnp.asarray(x),
                                  jnp.asarray(emb))["params"], 2)
    prefix = "diffuser.image.data_blocks.1.0."
    pm = _load(ResBlock2D(cin, cout, 256), params, prefix)
    ref = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(emb))
    with torch.no_grad():
        out = pm(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(), torch.from_numpy(emb))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)
