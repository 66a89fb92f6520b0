"""The flash backward kernel's order of work on the CPU
(``vdtpu_torch/ops/flash.py::flash_attention_bwd_blocked_plain``, the plain
model of ``csrc/flash_bwd.cu``: one pass over 128-key blocks, 64-query
tiles, s and dP once, exp2 with log2 e folded into the scale and lse, dQ
summed in f32 over the key blocks' partials) against vdtpu's ``_bwd_impl``
run in interpret mode, at shapes whose query and key counts leave ragged
last tiles and blocks; and in bf16 against ``flash_attention_bwd_plain``,
the plain version the card holds the kernel to."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdtpu.ops.pallas import flash as jflash
from vdtpu_torch.ops.flash import (
    BWD_KEYS, BWD_QUERIES, flash_attention_bwd_blocked_plain, flash_attention_bwd_plain,
    flash_attention_plain)

torch.set_num_threads(2)

# f32 on both sides: they differ in summation order (vdtpu sums dQ over its
# key blocks inside one kernel, the model over 128-key partials) and in
# exp(x) against exp2(x log2 e) (a relative 1e-6 at |x| ~ 10)
TOL = 1e-5
# bf16 against the plain version: the card's gate, two bf16 ulps at each
# gradient's largest magnitude and relative L2 under 1e-2 (both round p and
# dS to bf16; they differ in f32 summation order and exp2 against exp)
ATOL, RTOL, MAX_REL_L2 = 1e-2, 1.6e-2, 1e-2


@pytest.mark.parametrize("b,n,m,h,d", [
    (1, 200, 300, 2, 40),   # 3 full query tiles + 8, 2 full key blocks + 44
    (2, 70, 130, 1, 8),     # one full tile + 6 queries, one block + 2 keys
    (1, 64, 128, 1, 40),    # whole tiles and blocks
])
def test_blocked_model_matches_jax(b, n, m, h, d):
    assert n % BWD_QUERIES or m % BWD_KEYS or (n, m) == (BWD_QUERIES, BWD_KEYS)
    rs = np.random.RandomState(n + m + d)
    q, k, v = (rs.randn(b, s, h, d).astype(np.float32) for s in (n, m, m))
    g = rs.randn(b, n, h, d).astype(np.float32)
    fold = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3).reshape(b * h, a.shape[1], d))
    unfold = lambda a, s: np.asarray(a).reshape(b, h, s, d).transpose(0, 2, 1, 3)
    scale = d ** -0.5
    o_j, lse_j = jflash._fwd_impl(fold(q), fold(k), fold(v), scale, 64, 128, interpret=True,
                                  with_lse=True)
    grads_j = jflash._bwd_impl(fold(q), fold(k), fold(v), o_j, lse_j, fold(g), scale, 64, 128,
                               True)
    o = torch.tensor(unfold(o_j, n))
    lse = torch.tensor(np.asarray(lse_j).reshape(b, h, n))
    ours = flash_attention_bwd_blocked_plain(*(torch.tensor(a) for a in (q, k, v)), o, lse,
                                             torch.tensor(g), scale)
    for name, a, r, s in zip("qkv", ours, grads_j, (n, m, m)):
        r = unfold(r, s)
        np.testing.assert_allclose(a.numpy(), r, rtol=TOL, atol=TOL * np.abs(r).max(),
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("b,n,m,h,d", [(1, 200, 300, 2, 40), (1, 130, 257, 2, 80)])
def test_blocked_model_within_the_card_gate_in_bf16(b, n, m, h, d):
    gen = torch.Generator().manual_seed(n + m)
    q, k, v = (torch.randn(b, s, h, d, generator=gen).to(torch.bfloat16) for s in (n, m, m))
    do = torch.randn(b, n, h, d, generator=gen).to(torch.bfloat16)
    o, lse = flash_attention_plain(q, k, v, with_lse=True)
    ours = flash_attention_bwd_blocked_plain(q, k, v, o, lse, do)
    refs = flash_attention_bwd_plain(q, k, v, o, lse, do)
    for a, r in zip(ours, refs):
        assert a.dtype == torch.bfloat16
        a, r = a.float(), r.float()
        assert bool(((a - r).abs() <= ATOL * r.abs().max() + RTOL * r.abs()).all())
        assert float((a - r).norm() / r.norm()) < MAX_REL_L2


def test_sass_counter_takes_the_mma_loop():
    """``vdtpu_torch.utils.sass`` (the per-score SASS counts of PERF.md) on a
    hand-written listing: of three loops, the innermost one with the
    tensor-core instructions is taken (not the one without, not the one
    enclosing it), each instruction counted once."""
    from vdtpu_torch.utils.sass import main_loop, parse
    listing = """
        Function : kernel_a
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDS R2, [R3] ;
        /*0020*/              @P0 BRA 0x10 ;
        /*0030*/                   HMMA.16816.F32.BF16 R4, R8, R10, R4 ;
        /*0040*/                   MUFU.EX2 R5, R5 ;
        /*0050*/                   FFMA R6, R5, R6, R7 ;
        /*0060*/              @!P1 BRA 0x30 ;
        /*0070*/                   IADD3 R1, R1, 0x1, RZ ;
        /*0080*/              @!P2 BRA 0x30 ;
        /*0090*/                   EXIT ;
    """
    funcs = parse(listing)
    assert list(funcs) == ["kernel_a"] and len(funcs["kernel_a"]) == 10
    body = main_loop(funcs["kernel_a"])
    assert [t.split()[0] for t in body] == ["HMMA.16816.F32.BF16", "MUFU.EX2", "FFMA", "@!P1"]
