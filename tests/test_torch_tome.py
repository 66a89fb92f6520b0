"""Token merging (``vdtpu_torch/ops/tome.py``) against ``vdtpu/ops/tome.py``.

The cases of tests/test_tome.py on the port (merge counts, lossless merge
of duplicated tokens, the unmerge mapping, bit-identity when off), the
merge itself on the same numpy inputs through both packages, and the tiny
text-to-image flow with ``enable_tome(0.5, min_tokens=1024)`` on both: the
tiny 32^2 latent's 1024-token level is the only one it can reach. f32
throughout; the JAX ToMe policy is process-global and every test restores
it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _tiny import det_tokenizer
from test_torch_i2i import tiny_systems_from_port
from test_torch_slice import PROMPT
from vdtpu.ops import tome as jtome
from vdtpu_torch.models.transformer import BasicTransformerBlock
from vdtpu_torch.ops.flash import flash_attention
from vdtpu_torch.ops.gn_silu import gn_silu
from vdtpu_torch.ops.tome import ToMeSpec, ToMeWalk, _partition, build_merge, merge_count

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _restore_jax_tome_and_no_launches():
    flash_attention.launches = gn_silu.launches = 0
    yield
    jtome.set_tome(None)
    assert flash_attention.launches == 0 and gn_silu.launches == 0


def test_merge_count_alignment():
    assert merge_count(4096, 0.5) == 2048
    assert merge_count(4096, 0.75) == 3072          # the serving ratio: 1024 tokens left
    assert (4096 - merge_count(4096, 0.3)) % 256 == 0
    r = merge_count(4096, 0.95)
    assert r <= 3072 and (4096 - r) % 256 == 0
    assert merge_count(16, 0.25) == 4
    assert merge_count(4096, 0.0) == 0
    for n in (16, 64, 100, 1024, 2048, 4096):
        for ratio in (0.1, 0.5, 0.75, 0.9):
            assert merge_count(n, ratio) == jtome.merge_count(n, ratio)
            dst, src = _partition(n)
            jdst, jsrc = jtome._partition(n)
            np.testing.assert_array_equal(dst, jdst)
            np.testing.assert_array_equal(src, jsrc)


def test_spec_validation():
    with pytest.raises(ValueError, match="ratio"):
        ToMeSpec(ratio=1.0)
    assert ToMeSpec(0.5) == ToMeSpec(0.5, 4096)


def test_duplicated_tokens_merge_losslessly():
    rs = np.random.RandomState(0)
    n, c = 16, 8
    x = rs.randn(2, n, c).astype(np.float32)
    dst_idx, src_idx = _partition(n)
    for b in range(2):
        x[b, src_idx[0]] = x[b, dst_idx[0]]
        x[b, src_idx[1]] = x[b, dst_idx[0]]
        x[b, src_idx[5]] = x[b, dst_idx[2]]
        x[b, src_idx[9]] = x[b, dst_idx[3]]
    merge, unmerge, n_red = build_merge(torch.from_numpy(x), ToMeSpec(0.25, min_tokens=1))
    assert n_red == n - 4
    out = unmerge(merge(torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(out, x, rtol=1e-6, atol=1e-6)


def test_merge_matches_jax_and_unmerge_mapping():
    """Same assignment as vdtpu on the same input (scores in f32, ties
    absent), so merge and unmerge agree to f32 rounding of the means."""
    rs = np.random.RandomState(1)
    x = rs.randn(3, 64, 5).astype(np.float32)
    h = rs.randn(3, 64, 7).astype(np.float32)   # another width, the same assignment
    spec = ToMeSpec(0.5, min_tokens=1)
    merge, unmerge, n_red = build_merge(torch.from_numpy(x), spec)
    jmerge, junmerge, jn_red = jtome.build_merge(jnp.asarray(x), jtome.ToMeSpec(0.5, 1))
    assert n_red == jn_red == 64 - merge_count(64, 0.5)
    m = merge(torch.from_numpy(h))
    assert m.shape == (3, n_red, 7)
    np.testing.assert_allclose(m.numpy(), np.asarray(jmerge(jnp.asarray(h))), rtol=1e-6,
                               atol=1e-6)
    u = unmerge(m).numpy()
    np.testing.assert_array_equal(u, np.asarray(junmerge(jnp.asarray(m.numpy()))))
    const = torch.ones(3, 64, 2)
    np.testing.assert_allclose(unmerge(merge(const)).numpy(), 1.0, rtol=1e-6)
    eq = (np.abs(u - h) < 1e-6).all(axis=-1)
    assert eq.sum(axis=1).min() >= n_red - 16       # kept srcs pass through


def _merge_scatter_add(x, h, spec):
    """The merge as the port computed it before its one-hot product: the
    sources added into their destinations by ``scatter_add_`` (whose atomic
    adds land in any order on a card)."""
    b, n, _ = x.shape
    r = merge_count(n, spec.ratio)
    dst_np, src_np = _partition(n)
    dst_idx, src_idx = torch.from_numpy(dst_np), torch.from_numpy(src_np)
    xm = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-6)
    best_val, best_dst = torch.einsum("bsc,bdc->bsd", xm[:, src_idx], xm[:, dst_idx]).max(-1)
    order = torch.argsort(-best_val, dim=-1, stable=True)
    merged_pos, kept_pos = order[:, :r], order[:, r:]
    dst_of = torch.gather(best_dst, 1, merged_pos)
    rows = lambda t, idx: torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1]))
    counts = torch.zeros((b, len(dst_np))).scatter_add_(1, dst_of, torch.ones(dst_of.shape))
    hsrc, hdst = h[:, src_idx], h[:, dst_idx]
    add = torch.zeros(hdst.shape).scatter_add_(
        1, dst_of[..., None].expand(-1, -1, h.shape[-1]), rows(hsrc, merged_pos))
    return torch.cat([rows(hsrc, kept_pos), (hdst + add) / (1.0 + counts[..., None])], dim=1)


# the one-hot product sums each destination's sources in another order than
# scatter_add_ did: f32 rounding of sums of up to 48 terms here
@pytest.mark.parametrize("clustered", [False, True])
def test_merge_matches_the_scatter_add_merge(clustered):
    rs = np.random.RandomState(6)
    x = rs.randn(3, 256, 8).astype(np.float32)
    if clustered:   # most sources closest to one destination: long sums
        x[:, :, 0] += 30.0
    h = torch.from_numpy(rs.randn(3, 256, 12).astype(np.float32))
    spec = ToMeSpec(0.75, min_tokens=1)
    merge, _, n_red = build_merge(torch.from_numpy(x), spec)
    ref = _merge_scatter_add(torch.from_numpy(x), h, spec)
    out = merge(h)
    assert out.shape == ref.shape == (3, n_red, 12)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)


def test_merge_of_a_row_does_not_depend_on_its_co_riders():
    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.randn(4, 256, 8).astype(np.float32))
    spec = ToMeSpec(0.75, min_tokens=1)
    merge, _, _ = build_merge(x, spec)
    other = x.clone()
    other[1:] = torch.from_numpy(rs.randn(3, 256, 8).astype(np.float32))
    merge_other, _, _ = build_merge(other, spec)
    assert torch.equal(merge(x)[0], merge_other(other)[0])
    assert torch.equal(merge(x), merge(x))


def test_block_bit_identical_when_off_or_below_min_tokens():
    torch.manual_seed(0)
    blk = BasicTransformerBlock(16, 2, 8, 16).eval()
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 64, 16).astype(np.float32))
    ctx = torch.randn(2, 5, 16)
    with torch.no_grad():
        base = blk(x, ctx)
        assert torch.equal(blk(x, ctx, ToMeWalk(ToMeSpec(0.5, min_tokens=65))), base)
        merged = blk(x, ctx, ToMeWalk(ToMeSpec(0.5, min_tokens=16)))
    assert torch.isfinite(merged).all() and (merged - base).abs().max() > 1e-6


def test_walk_reuses_one_merge_per_size():
    walk = ToMeWalk(ToMeSpec(0.5, min_tokens=16))
    x = torch.randn(2, 64, 8)
    assert walk.merge(x) is walk.merge(torch.randn(2, 64, 8))
    assert walk.merge(torch.randn(2, 16, 8)) is not walk.merge(x)


@pytest.fixture(scope="module")
def systems():
    return tiny_systems_from_port()


# f32, both packages merge the same tokens (the assignment is an argmax of
# cosine scores with no near-ties here); what remains is f32 summation
# order, amplified over 4 guided steps as in test_torch_slice (measured
# max 1.4e-5 on latents up to 18.6)
def test_tiny_t2i_with_tome_matches_jax(systems):
    jsys, psys, _ = systems
    u, c = (np.repeat(np.asarray(jsys.ctx_encode(det_tokenizer([t]), "text")), 2, axis=0)
            for t in ("", PROMPT))
    xt = np.random.RandomState(3).randn(2, 32, 32, 4).astype(np.float32)
    c_info = {"type": "text", "conditioning": c, "unconditional_conditioning": u,
              "unconditional_guidance_scale": 7.5}
    jsys.enable_tome(0.5, min_tokens=1024)
    z_j = np.asarray(jsys.sampler.sample(jsys.params["diffuser"], jax.random.PRNGKey(0), 4,
                                         xt.shape, {"type": "image", "xt": xt}, c_info))
    psys.enable_tome(0.5, min_tokens=1024)
    try:
        z_p = psys.sampler.sample(None, 4, xt.shape, {"type": "image", "xt": xt},
                                  {**c_info, "conditioning": torch.from_numpy(c),
                                   "unconditional_conditioning": torch.from_numpy(u)},
                                  device="cpu")
        psys.enable_tome(0)
        z_off = psys.sampler.sample(None, 4, xt.shape, {"type": "image", "xt": xt},
                                    {**c_info, "conditioning": torch.from_numpy(c),
                                     "unconditional_conditioning": torch.from_numpy(u)},
                                    device="cpu")
    finally:
        psys.enable_tome(0)
    assert np.abs(z_p.numpy() - z_off.numpy()).max() > 1e-3   # merging changed the result
    np.testing.assert_allclose(z_p.numpy(), z_j, atol=1e-4, rtol=1e-4)
