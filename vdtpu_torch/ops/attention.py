"""Attention: one entry point, two backends (``vdtpu/ops/attention.py``).

- ``plain``: two matmuls with an f32 softmax (``_xla_attention``), for the
  short cross-attentions (77 keys), the 256-token self-attentions and the
  VAE's one 512-wide head;
- ``flash``: the hand-written flash-attention kernel (``ops/flash.py``) for
  the long self-attentions (1024 and 4096 tokens), or, when the site has a
  calibrated logit bound (``softmax_shift``, the int8 serving policy) and
  no mask, the no-max kernel (``ops/nomax.py``).

The rule is the JAX package's ``_pick_backend``: a site goes to flash when
its tensors are on CUDA, q_len >= 256, kv_len >= 1024 and d_head <= 256.
The plain path is exact softmax and ignores the shift (softmax is
shift-invariant), as the JAX package's XLA path does. Both paths are
differentiable (the flash kernel through its backward kernels; the no-max
kernel is forward-only and raises under autograd). The plain path's logits
and softmax are f32 with autocast off, as ``_xla_attention``'s are.
"""
from __future__ import annotations

import torch

from vdtpu_torch.ops.flash import MAX_HEAD_DIM, flash_attention
from vdtpu_torch.ops.nomax import flash_attention_nomax

_FLASH_MIN_Q = 256
_FLASH_MIN_KV = 1024


def pick_backend(q, k) -> str:
    if (q.is_cuda and q.shape[1] >= _FLASH_MIN_Q and k.shape[1] >= _FLASH_MIN_KV
            and q.shape[-1] <= MAX_HEAD_DIM):
        return "flash"
    return "plain"


def plain_attention(q, k, v, mask=None, scale: float = 1.0):
    """matmul + f32 softmax + matmul, [B, Q, H, D] -> [B, Q, H, D]."""
    with torch.autocast(q.device.type, enabled=False):
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def scaled_dot_product_attention(q, k, v, mask=None, scale: float | None = None,
                                 softmax_shift=None):
    """Multi-head attention; q [B, Q, H, D], k/v [B, K, H, D]; mask
    broadcastable to [B, H, Q, K] (True = keep) forces the plain path;
    softmax_shift (a float or [H]) is an upper bound on the scaled logits."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if mask is None and pick_backend(q, k) == "flash":
        if softmax_shift is not None:
            return flash_attention_nomax(q, k, v, softmax_shift, scale)
        return flash_attention(q, k, v, scale)
    return plain_attention(q, k, v, mask, scale)
