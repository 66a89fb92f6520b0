"""The port's kernel functions against the JAX package's kernels.

On CPU tensors each wrapper runs its kernel's plain version; the JAX side
runs its Pallas kernel in interpret mode, as tests/test_flash_attention.py,
tests/test_gn_silu.py and tests/test_qconv_fused.py do. Inputs are seeded
numpy arrays handed to both. Launch counters must stay at 0: nothing here
reaches a CUDA kernel.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdtpu.ops import schedules as jsched
from vdtpu.ops.attention import _xla_attention
from jax import lax

from vdtpu.ops.pallas import flash as jflash
from vdtpu.ops.pallas import gn_silu as jgn
from vdtpu.ops.pallas import qconv as jqconv
from vdtpu.ops.pallas.flash import flash_attention as jax_flash
from vdtpu.ops.pallas.gn_silu import gn_silu as jax_gn_silu
from vdtpu_torch.ops import attention, schedules
from vdtpu_torch.ops.flash import flash_attention, flash_attention_plain
from vdtpu_torch.ops.gn_silu import gn_silu, gn_silu_plain, gn_silu_q, gn_stats
from vdtpu_torch.ops.nomax import flash_attention_nomax
from vdtpu_torch.ops.qconv import qconv3, qconv3_flat, qconv3_gn

torch.set_num_threads(2)

COUNTERS = (flash_attention, gn_silu, gn_silu_q, gn_stats, flash_attention_nomax, qconv3,
            qconv3_gn)


@pytest.fixture(autouse=True)
def _counters_stay_zero():
    for c in COUNTERS:
        c.launches = 0
    yield
    assert all(c.launches == 0 for c in COUNTERS)


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
    """Each side is first held to a float64 softmax attention at the same
    tolerance, so a failure names the side that moved: both agree with it
    to ~4e-7 and with each other to ~1.2e-7, bit-stable run to run."""
    rs = np.random.RandomState(n + m + d)
    q, k, v = _qkv(rs, 2, n, m, h, d)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    block_q=64, block_k=128, interpret=True)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64) * d ** -0.5, k.astype(np.float64))
    p = np.exp(s - s.max(-1, keepdims=True))
    truth = np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v.astype(np.float64))
    np.testing.assert_allclose(np.asarray(ref), truth, atol=2e-5, rtol=1e-4,
                               err_msg="vdtpu's Pallas kernel (interpret) against float64")
    np.testing.assert_allclose(out.numpy(), truth, atol=2e-5, rtol=1e-4,
                               err_msg="the port's plain version against float64")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)


def flash_f32_hashes(runs: int, n=128, m=128, d=8, h=2):
    """Hashes of each side's output over ``runs`` runs of the f32 case above
    in this process: ({port hash: count}, {vdtpu hash: count}, the largest
    |port - vdtpu|). ``python tests/test_torch_kernels.py RUNS`` prints
    them (run several at once to load the machine as parallel test workers do)."""
    import hashlib
    rs = np.random.RandomState(n + m + d)
    q, k, v = _qkv(rs, 2, n, m, h, d)
    digest = lambda a: hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()[:12]
    port, ref, worst = {}, {}, 0.0
    for _ in range(runs):
        r = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 block_q=64, block_k=128, interpret=True))
        o = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)).numpy()
        port[digest(o)] = port.get(digest(o), 0) + 1
        ref[digest(r)] = ref.get(digest(r), 0) + 1
        worst = max(worst, float(np.abs(o - r).max()))
    return port, ref, worst


def test_flash_f32_sides_are_bit_stable():
    port, ref, worst = flash_f32_hashes(8)
    assert len(port) == 1 and len(ref) == 1 and worst < 2e-5


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
    with pytest.raises(ValueError):
        flash_attention_nomax(q, q, q, 1.0)
    for fn in (gn_stats, lambda t: gn_silu_q(t, torch.ones(32), torch.zeros(32),
                                               torch.ones(()))):
        with pytest.raises(ValueError):
            fn(x)
    with pytest.raises(ValueError):
        qconv3(torch.zeros(1, 4, 4, 8, dtype=torch.int8, device="meta"),
               torch.zeros(8, 3, 3, 8, dtype=torch.int8), torch.ones(8), torch.zeros(8),
               torch.ones(()))


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


# ---- no-max attention (K1) against the TPU's three no-max kernels ----------

def _true_shift(q, k):
    """Per-head max of the scaled logits: the calibrated bound's ideal."""
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    return s.max(axis=(0, 2, 3)).astype(np.float32)


# f32: exp2(s log2e - M log2e) against the TPU kernels' own exp / exp2
# forms and summation orders (the flash tests' tolerance)
@pytest.mark.parametrize("n,m,d,packed", [
    (128, 128, 8, False),     # slim kernel, narrow head
    (256, 256, 40, False),    # d_head of the 64^2 level
    (160, 200, 80, False),    # ragged q and kv
    (128, 200, 40, True),     # the head-packed kernel, ragged kv
])
def test_nomax_plain_matches_jax_kernels_f32(n, m, d, packed, monkeypatch):
    monkeypatch.setenv("VDTPU_NOMAX_PACKED", "1" if packed else "0")
    rs = np.random.RandomState(n + m + d)
    q, k, v = _qkv(rs, 2, n, m, 2, d)
    shift = _true_shift(q, k)
    ref = jflash.flash_attention_nomax(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(shift), interpret=True)
    out = flash_attention_nomax(*(torch.from_numpy(t) for t in (q, k, v)),
                                torch.from_numpy(shift))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)


def test_nomax_plain_matches_jax_lane_kernel_f32():
    """d % 8 != 0: ``_nomax_impl`` (shift in an extra K lane, denominator
    from a ones column of V), called directly on the folded layout, with a
    float shift above the true maximum."""
    rs = np.random.RandomState(12)
    q, k, v = _qkv(rs, 2, 96, 130, 2, 12)
    shift = float(_true_shift(q, k).max()) + 1.5
    fold = lambda t: jnp.asarray(t).transpose(0, 2, 1, 3).reshape(4, t.shape[1], 12)
    ref = jflash._nomax_impl(fold(q), fold(k), fold(v), 12 ** -0.5,
                             jnp.full((4,), shift, jnp.float32), 96, 256, True)
    ref = np.asarray(ref).reshape(2, 2, 96, 12).transpose(0, 2, 1, 3)
    out = flash_attention_nomax(*(torch.from_numpy(t) for t in (q, k, v)), shift)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=1e-4)


def test_nomax_plain_matches_jax_slim_kernel_bf16():
    """bf16: the slim kernel's q~ rounding and bf16(p) . v, as the port's
    kernel does; two bf16 ulps of the output."""
    rs = np.random.RandomState(8)
    q, k, v = _qkv(rs, 1, 128, 192, 2, 40)
    shift = _true_shift(*(np.asarray(jnp.asarray(t).astype(jnp.bfloat16).astype(jnp.float32))
                          for t in (q, k)))
    ref = jflash.flash_attention_nomax(*(jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v)),
                                       jnp.asarray(shift), interpret=True)
    out = flash_attention_nomax(*(torch.from_numpy(t).bfloat16() for t in (q, k, v)),
                                torch.from_numpy(shift))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=1e-2, rtol=1.6e-2)


# ---- GN+SiLU+int8 and GN statistics (K2) against rows 7, 8 and 9 -----------

# GroupNorm sums in another order: a code may differ by one where y / s
# lies within f32 rounding of a half-integer; at most 1 in 1000, never by 2
def _codes_agree(ours, theirs, max_frac=1e-3):
    diff = np.abs(ours.astype(np.int32) - theirs.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= max_frac, (diff.max(), (diff > 0).mean())


def _gn_inputs(rs, b, hw, c):
    x = (rs.randn(b, hw, c) * 2 + 0.3).astype(np.float32)      # flat NHWC
    return (x, (rs.rand(c) + 0.5).astype(np.float32), (rs.randn(c) * 0.1).astype(np.float32))


def _nchw(x, h, w):
    return torch.from_numpy(x).reshape(x.shape[0], h, w, -1).permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("with_silu", [True, False])
def test_gn_silu_q_plain_matches_jax_whole_slab(with_silu):
    rs = np.random.RandomState(21)
    x, g, b = _gn_inputs(rs, 2, 12 * 10, 64)
    s = np.float32(0.02)
    ref = jgn.gn_silu_q(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), jnp.asarray(s), 32,
                        1e-5, with_silu, interpret=True)
    out = gn_silu_q(_nchw(x, 12, 10), torch.from_numpy(g), torch.from_numpy(b),
                    torch.tensor(s), 32, 1e-5, with_silu)
    assert out.dtype == torch.int8 and out.shape == (2, 12, 10, 64)
    _codes_agree(out.reshape(2, 120, 64).numpy(), np.asarray(ref))


def test_gn_silu_q_plain_matches_jax_blocked():
    rs = np.random.RandomState(22)
    x, g, b = _gn_inputs(rs, 2, 32 * 32, 64)        # N % 512 == 0
    s = np.float32(0.03)
    ref = jgn._gn_silu_q_blocked(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                                 jnp.asarray(s), 32, 1e-5, True, True)
    out = gn_silu_q(_nchw(x, 32, 32), torch.from_numpy(g), torch.from_numpy(b),
                    torch.tensor(s), 32, 1e-5, True)
    _codes_agree(out.reshape(2, 1024, 64).numpy(), np.asarray(ref))


@pytest.mark.parametrize("c", [128, 256])
def test_gn_stats_plain_matches_jax(c):
    rs = np.random.RandomState(c)
    x, _, _ = _gn_inputs(rs, 2, 16 * 16, c)
    ref = jgn.gn_stats(jnp.asarray(x), 32, 1e-5, interpret=True)
    out = gn_stats(_nchw(x, 16, 16), 32, 1e-5)
    assert out.shape == (2, 2, c) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


# ---- int8 3x3 conv (K3) against row 10 and the s8 lax conv ----------------

def _qconv_case(rs, b, h, w, c, n):
    x = rs.randn(b, h * w, c).astype(np.float32)
    gs = (rs.randn(c) * 0.2 + 1.0).astype(np.float32)
    gb = (rs.randn(c) * 0.1).astype(np.float32)
    wq = rs.randint(-127, 128, (3, 3, c, n)).astype(np.int8)
    s_w = (rs.rand(n) * 0.01 + 0.001).astype(np.float32)
    bias = (rs.randn(n) * 0.1).astype(np.float32)
    return x, gs, gb, wq, s_w, bias, rs.randn(b, n).astype(np.float32), \
        rs.randn(b, h * w, n).astype(np.float32)


# identical codes feed exact integer sums, so only the f32 epilogue and the
# GN statistics' summation order differ (tests/test_qconv_fused.py's 2e-5);
# a GN code flip moves its outputs further: at most 1 in 1000 outputs
@pytest.mark.parametrize("h,w,c,n,groups,adds", [
    (8, 8, 64, 128, 8, "film"),
    (8, 8, 64, 128, 8, "skip"),
    (16, 8, 32, 64, 4, "film+skip"),   # non-square, C_in != C_out
    (8, 8, 64, 64, 32, "film+skip"),
])
def test_qconv3_flat_plain_matches_jax_kernel(h, w, c, n, groups, adds):
    rs = np.random.RandomState(h * w + c + n)
    x, gs, gb, wq, s_w, bias, av, af = _qconv_case(rs, 2, h, w, c, n)
    av = av if "film" in adds else None
    af = af if "skip" in adds else None
    j = lambda t: None if t is None else jnp.asarray(t)
    ref = jqconv.qconv3_flat(j(x), j(gs), j(gb), jnp.float32(0.05), j(wq), j(s_w), j(bias), h, w,
                             groups=groups, add_vec=j(av), add_full=j(af), interpret=True)
    t = lambda a: None if a is None else torch.from_numpy(a)
    out = qconv3_flat(t(x), t(gs), t(gb), 0.05, t(wq), t(s_w), t(bias), h, w, groups=groups,
                      add_vec=t(av), add_full=t(af))
    assert out.shape == (2, h * w, n)
    bad = ~np.isclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    assert bad.mean() <= 1e-3, bad.mean()


@pytest.mark.parametrize("c,n,stride", [(4, 32, 1), (4, 32, 2), (32, 48, 2), (64, 16, 1)])
def test_qconv3_plain_matches_lax_s8_conv(c, n, stride):
    """The s8-input conv (every QConv site): exact s32 sums, then the f32
    dequant, bias and adds, against lax's s8 conv (``_ref_conv_dequant``
    takes stride 1 only, so stride 2 calls lax.conv_general_dilated as
    ``QConv`` does)."""
    rs = np.random.RandomState(c * n + stride)
    b, h, w = 2, 12, 10
    xq = rs.randint(-127, 128, (b, h, w, c)).astype(np.int8)
    wq = rs.randint(-127, 128, (3, 3, c, n)).astype(np.int8)
    s_w = (rs.rand(n) * 0.01).astype(np.float32)
    bias = rs.randn(n).astype(np.float32)
    sx = np.float32(0.05)
    if stride == 1:
        ref = np.asarray(jqconv._ref_conv_dequant(jnp.asarray(xq), jnp.asarray(wq),
                                                  jnp.asarray(sx), jnp.asarray(s_w),
                                                  jnp.asarray(bias)))
    else:
        dims = lax.conv_dimension_numbers(xq.shape, wq.shape, ("NHWC", "HWIO", "NHWC"))
        acc = lax.conv_general_dilated(jnp.asarray(xq), jnp.asarray(wq), (2, 2),
                                       [(1, 1), (1, 1)], dimension_numbers=dims,
                                       preferred_element_type=jnp.int32)
        ref = np.asarray(acc.astype(jnp.float32) * (sx * jnp.asarray(s_w)) + jnp.asarray(bias))
    out = qconv3(torch.from_numpy(xq), torch.from_numpy(wq.transpose(3, 0, 1, 2).copy()),
                 torch.from_numpy(s_w), torch.from_numpy(bias), torch.tensor(sx), stride,
                 out_dtype=torch.float32)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-6, atol=1e-6)


if __name__ == "__main__":
    import sys
    print(flash_f32_hashes(int(sys.argv[1]) if len(sys.argv) > 1 else 50))
