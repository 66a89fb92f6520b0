"""Gradients of the port's kernel functions against the JAX package's.

On CPU tensors the port's wrappers run their plain versions (flash forward
with lse, the flash backward, GN+SiLU recomputed and differentiated); the
JAX side runs its Pallas kernels in interpret mode under ``jax.vjp``, as
tests/test_flash_attention.py and tests/test_gn_silu.py do. Inputs and
output cotangents are seeded numpy arrays handed to both, in f32. Launch
counters stay at 0: nothing here reaches a CUDA kernel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdtpu.ops.pallas import flash as jflash
from vdtpu.ops.pallas.gn_silu import gn_silu as jax_gn_silu
from vdtpu_torch.ops.flash import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
    flash_attention_plain)
from vdtpu_torch.ops.gn_silu import gn_silu

torch.set_num_threads(2)

# f32 on both sides; they differ in summation order only (the Pallas
# backward accumulates over 512-wide blocks, the plain version in one einsum)
TOL = 1e-5


@pytest.fixture(autouse=True)
def _counters_stay_zero():
    for c in (flash_attention, flash_attention_bwd, gn_silu):
        c.launches = 0
    yield
    assert flash_attention.launches == flash_attention_bwd.launches == gn_silu.launches == 0


def _close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL * max(1.0, np.abs(b).max()),
                               err_msg=what)


@pytest.mark.parametrize("b,n,m,h,d", [
    (2, 200, 300, 2, 40),   # d_head of the 64^2 level; ragged q and kv (padded by vdtpu)
    (1, 520, 136, 2, 80),   # d_head of the 32^2 level; two 512-row q blocks, ragged
])
def test_flash_grads_match_jax(b, n, m, h, d):
    rs = np.random.RandomState(n + m + d)
    q, k, v = (rs.randn(b, s, h, d).astype(np.float32) for s in (n, m, m))
    g = rs.randn(b, n, h, d).astype(np.float32)
    out_j, vjp = jax.vjp(lambda q_, k_, v_: jflash.flash_attention(q_, k_, v_, interpret=True),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_j = vjp(jnp.asarray(g))
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = flash_attention(qt, kt, vt)
    out.backward(torch.tensor(g))
    _close(out.detach().numpy(), out_j, "out")
    for name, ours, ref in zip("qkv", (qt.grad, kt.grad, vt.grad), grads_j):
        _close(ours.numpy(), ref, f"d{name}")


def test_flash_lse_matches_jax():
    b, n, m, h, d = 2, 200, 300, 2, 40
    rs = np.random.RandomState(1)
    q, k, v = (rs.randn(b, s, h, d).astype(np.float32) for s in (n, m, m))
    fold = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3).reshape(b * h, a.shape[1], d))
    _, lse_j = jflash._fwd_impl(fold(q), fold(k), fold(v), d ** -0.5, 200, 384,
                                interpret=True, with_lse=True)
    out, lse = flash_attention_fwd(*(torch.tensor(a) for a in (q, k, v)), d ** -0.5,
                                   with_lse=True)
    assert lse.shape == (b, h, n) and lse.dtype == torch.float32
    _close(lse.numpy().reshape(b * h, n), lse_j, "lse")
    _close(out.numpy(), flash_attention_plain(*(torch.tensor(a) for a in (q, k, v))).numpy(),
           "out with lse vs without")


def test_flash_bwd_plain_matches_autograd_of_the_forward():
    """The backward's function is the forward's gradient: the plain
    backward against autograd through the plain forward (f32)."""
    rs = np.random.RandomState(2)
    q, k, v = (torch.tensor(rs.randn(2, s, 3, 24).astype(np.float32), requires_grad=True)
               for s in (70, 90, 90))
    g = torch.tensor(rs.randn(2, 70, 3, 24).astype(np.float32))
    out, lse = flash_attention_plain(q, k, v, with_lse=True)
    ref = torch.autograd.grad(out, (q, k, v), g)
    ours = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), out.detach(),
                                     lse.detach(), g)
    for a, r in zip(ours, ref):
        _close(a.numpy(), r.numpy(), "plain backward")


def test_flash_without_grad_returns_no_graph():
    q = torch.randn(1, 8, 1, 8)
    assert not flash_attention(q, q, q).requires_grad
    with torch.no_grad():
        qg = q.clone().requires_grad_()
        assert not flash_attention(qg, qg, qg).requires_grad


@pytest.mark.parametrize("shape,groups,with_silu", [
    ((2, 64, 5, 6), 32, True),    # [B, C, H, W]
    ((3, 96, 7), 32, False),      # [B, C, S] (the 0-D diffuser's view)
])
def test_gn_silu_grads_match_jax(shape, groups, with_silu):
    rs = np.random.RandomState(sum(shape))
    c = shape[1]
    x = (rs.randn(*shape) * 2 + 0.5).astype(np.float32)
    w = (rs.rand(c) + 0.5).astype(np.float32)
    bias = (rs.randn(c) * 0.1).astype(np.float32)
    g = rs.randn(*shape).astype(np.float32)
    x_nhwc = np.moveaxis(x, 1, -1)
    y_j, vjp = jax.vjp(lambda x_, w_, b_: jax_gn_silu(x_, w_, b_, groups, 1e-5, with_silu,
                                                      interpret=True),
                       jnp.asarray(x_nhwc), jnp.asarray(w), jnp.asarray(bias))
    gx_j, gw_j, gb_j = vjp(jnp.asarray(np.moveaxis(g, 1, -1)))
    xt, wt, bt = (torch.tensor(a, requires_grad=True) for a in (x, w, bias))
    y = gn_silu(xt, wt, bt, groups, 1e-5, with_silu)
    y.backward(torch.tensor(g))
    _close(np.moveaxis(y.detach().numpy(), 1, -1), y_j, "y")
    _close(np.moveaxis(xt.grad.numpy(), 1, -1), gx_j, "dx")
    _close(wt.grad.numpy(), gw_j, "dweight")
    _close(bt.grad.numpy(), gb_j, "dbias")


def test_gn_silu_grad_only_where_needed():
    """The backward differentiates only the inputs that need it (a frozen
    affine gets none)."""
    x = torch.randn(2, 64, 3, 3, requires_grad=True)
    w, b = torch.ones(64), torch.zeros(64)
    gn_silu(x, w, b).sum().backward()
    assert x.grad is not None and w.grad is None and b.grad is None
