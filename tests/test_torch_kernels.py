"""The port's kernel functions against the JAX package's kernels.

On CPU tensors each wrapper runs its kernel's plain version; the JAX side
runs its Pallas kernel in interpret mode, as tests/test_flash_attention.py
and tests/test_gn_silu.py do. Inputs are seeded numpy arrays handed to
both. Launch counters must stay at 0: nothing here reaches a CUDA kernel.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdtpu.ops import schedules as jsched
from vdtpu.ops.attention import _xla_attention
from vdtpu.ops.pallas.flash import flash_attention as jax_flash
from vdtpu.ops.pallas.gn_silu import gn_silu as jax_gn_silu
from vdtpu_torch.ops import attention, schedules
from vdtpu_torch.ops.flash import flash_attention, flash_attention_plain
from vdtpu_torch.ops.gn_silu import gn_silu, gn_silu_plain, split_count

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _counters_stay_zero():
    flash_attention.launches = 0
    gn_silu.launches = 0
    yield
    assert flash_attention.launches == 0 and gn_silu.launches == 0


def _qkv(rs, b, n, m, h, d):
    return (rs.randn(b, n, h, d).astype(np.float32), rs.randn(b, m, h, d).astype(np.float32),
            rs.randn(b, m, h, d).astype(np.float32))


# f32: the JAX test's own flash-vs-XLA tolerance (online vs one-shot softmax,
# other f32 summation orders)
@pytest.mark.parametrize("n,m,d,h", [
    (128, 128, 8, 2),      # narrow head
    (256, 256, 40, 2),     # d_head of the 64^2 level (320 ch / 8 heads), padded to 48
    (160, 256, 80, 2),     # d_head of the 32^2 level, ragged q
    (128, 200, 40, 1),     # kv length not a multiple of the 128-key block
])
def test_flash_plain_matches_jax_kernel_f32(n, m, d, h):
    rs = np.random.RandomState(n + m + d)
    q, k, v = _qkv(rs, 2, n, m, h, d)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    block_q=64, block_k=128, interpret=True)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)


def test_flash_plain_matches_jax_kernel_bf16():
    """bf16 inputs: both fold the scale into q in bf16 and cast the
    probabilities to bf16 before P.V; they differ in where the softmax
    normalization happens, so the bound is two bf16 ulps of the output."""
    rs = np.random.RandomState(7)
    q, k, v = _qkv(rs, 1, 128, 192, 2, 40)
    ref = jax_flash(*(jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v)),
                    block_q=64, block_k=128, interpret=True)
    out = flash_attention(*(torch.from_numpy(t).bfloat16() for t in (q, k, v)))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=1e-2, rtol=1.6e-2)


def test_flash_plain_matches_plain_attention():
    rs = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(t) for t in _qkv(rs, 2, 64, 96, 4, 24))
    out = flash_attention_plain(q, k, v, 0.3)
    ref = attention.plain_attention(q, k, v, None, 0.3)
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=1e-5)


def test_plain_attention_matches_jax_xla_path_with_mask():
    """The plain path is _xla_attention: f32 logits, finfo.min masking."""
    rs = np.random.RandomState(4)
    q, k, v = _qkv(rs, 2, 16, 16, 2, 8)
    mask = np.tril(np.ones((16, 16), bool))[None, None]
    ref = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(mask), 8 ** -0.5)
    out = attention.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-5)


def test_backend_rule():
    cuda = lambda *shape: types.SimpleNamespace(is_cuda=True, shape=shape)
    assert attention.pick_backend(cuda(2, 4096, 8, 40), cuda(2, 4096, 8, 40)) == "flash"
    assert attention.pick_backend(cuda(2, 1024, 8, 80), cuda(2, 1024, 8, 80)) == "flash"
    assert attention.pick_backend(cuda(2, 4096, 8, 40), cuda(2, 77, 8, 40)) == "plain"
    assert attention.pick_backend(cuda(2, 256, 8, 160), cuda(2, 256, 8, 160)) == "plain"
    assert attention.pick_backend(cuda(1, 4096, 1, 512), cuda(1, 4096, 1, 512)) == "plain"
    cpu = torch.zeros(1, 4096, 1, 8)
    assert attention.pick_backend(cpu, cpu) == "plain"


def test_wrappers_raise_off_cpu_and_cuda():
    """No silent fallback: a tensor on neither the CPU nor CUDA is refused."""
    q = torch.zeros(1, 8, 1, 8, device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    x = torch.zeros(1, 32, 2, 2, device="meta")
    with pytest.raises(ValueError):
        gn_silu(x, torch.ones(32), torch.zeros(32))


# f32: the JAX test's kernel-vs-GroupNorm tolerance (same E[x^2]-E[x]^2
# statistics, other summation order)
@pytest.mark.parametrize("c", [32, 320])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("with_silu", [True, False])
def test_gn_plain_matches_jax_kernel(c, eps, with_silu):
    rs = np.random.RandomState(c)
    x = (rs.randn(2, 8, 6, c) * 2 + 0.3).astype(np.float32)   # NHWC
    scale = (rs.rand(c) + 0.5).astype(np.float32)
    bias = (rs.randn(c) * 0.1).astype(np.float32)
    ref = jax_gn_silu(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 32, eps,
                      with_silu, interpret=True)
    out = gn_silu(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                  torch.from_numpy(scale), torch.from_numpy(bias), 32, eps, with_silu)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)


def test_gn_plain_matches_torch_group_norm():
    rs = np.random.RandomState(9)
    x = torch.from_numpy(rs.randn(2, 64, 5, 7).astype(np.float32))
    w = torch.from_numpy(rs.rand(64).astype(np.float32) + 0.5)
    b = torch.from_numpy(rs.randn(64).astype(np.float32))
    ref = torch.nn.functional.silu(torch.nn.functional.group_norm(x, 32, w, b, 1e-5))
    torch.testing.assert_close(gn_silu_plain(x, w, b, 32, 1e-5, True), ref,
                               atol=1e-5, rtol=1e-5)


def test_gn_split_fills_the_card():
    # (B*G, group length) of the UNet and VAE sites -> programs per pass
    assert split_count(128, 40960) * 128 >= 132 * 8
    assert split_count(32, 4 * 512 * 512) * 32 >= 132 * 8
    assert split_count(64, 64) == 1          # a group shorter than one block


@pytest.mark.parametrize("kind", ["linear", "cosine", "sqrt_linear", "sqrt"])
def test_beta_schedules_match_jax(kind):
    np.testing.assert_array_equal(schedules.make_beta_schedule(kind, 1000, 0.00085, 0.012),
                                  jsched.make_beta_schedule(kind, 1000, 0.00085, 0.012))


def test_schedule_tables_match_jax():
    js = jsched.DiffusionSchedule.create(1000, "linear", 0.00085, 0.012)
    ps = schedules.DiffusionSchedule.create(1000, "linear", 0.00085, 0.012)
    np.testing.assert_array_equal(ps.alphas_cumprod, js.alphas_cumprod)
    for steps in (4, 50):
        jt = jsched.make_ddim_timesteps(steps, 1000)
        np.testing.assert_array_equal(schedules.make_ddim_timesteps(steps, 1000), jt)
        for a, b in zip(schedules.make_ddim_sampling_parameters(ps.alphas_cumprod, jt, 0.5),
                        jsched.make_ddim_sampling_parameters(js.alphas_cumprod, jt, 0.5)):
            np.testing.assert_array_equal(a, b)


def test_timestep_embedding_matches_jax():
    """The argument t * freq reaches 999, where one f32 ulp is 6e-5 and the
    two libraries' exp(freq) differ by an ulp: cos/sin agree to ~2 ulps of
    the argument."""
    t = np.array([0, 1, 250, 999], np.int32)
    for dim in (32, 321):
        ref = jsched.timestep_embedding(jnp.asarray(t), dim)
        out = schedules.timestep_embedding(torch.from_numpy(t), dim)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=0)
