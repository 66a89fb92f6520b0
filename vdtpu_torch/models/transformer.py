"""Cross-attention transformer (``vdtpu/models/transformer.py``): GEGLU,
FeedForward, CrossAttention, BasicTransformerBlock, SpatialTransformer.

``SpatialTransformer`` takes the channel-first view of its stream,
[B, C, N] (an NCHW map with its spatial axes flattened, or the 0-D
diffuser's channel-major latent), so its GroupNorm runs on contiguous
groups; tokens are the [B, N, C] transpose of that. Attention dispatches
through ``ops/attention.py``: the long self-attentions go to the flash
kernel, which reads q, k and v as views of the projections, without copies.

Under an int8 policy the q/k/v projections share one activation quantize
(``fused_proj``; a cross-attention has a q site and a ``_kv`` site on the
context), residuals ride the output projections' f32 epilogues, and each
attention owns a calibrated per-head bound on its scaled logits
(``attn_shift``), which sends its long sites to the no-max kernel. With a
``ToMeWalk`` (token merging) the self-attention of long maps runs on the
merged tokens.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vdtpu_torch.models.layers import Conv1x1Linear, GroupNorm32, LayerNorm, apply_add, dense
from vdtpu_torch.ops.attention import scaled_dot_product_attention
from vdtpu_torch.ops.quant import QuantState, fused_proj

_SHIFT_CHUNK = 256  # queries per block of the calibration pass's logit max


class GEGLU(nn.Module):
    """x * gelu(gate) (exact erf gelu) with a fused 2x projection."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = dense(dim_in, dim_out * 2)

    def forward(self, x):
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU MLP, keys net.0 / net.2."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Identity(), dense(inner, dim)])

    def forward(self, x, residual=None):
        h = self.net[0](x)
        return self.net[2](h) if residual is None else apply_add(self.net[2], h, residual)


class CrossAttention(QuantState, nn.Module):
    """Multi-head attention; self-attention when context is None. Scale
    d_head**-0.5; q/k/v projections have no bias, the output one does.
    Under int8 it owns the shared activation scales of its projections
    (``act_scale``, ``act_scale_kv``) and its logit bound ``attn_shift``."""

    QUANT_BUFFERS = ("act_scale", "act_scale_kv", "attn_shift")

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: int | None = None):
        super().__init__()
        self.init_quant()
        inner = heads * dim_head
        context_dim = query_dim if context_dim is None else context_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = dense(query_dim, inner, bias=False)
        self.to_k = dense(context_dim, inner, bias=False)
        self.to_v = dense(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([dense(inner, query_dim)])

    def forward(self, x, context=None, residual=None):
        b, n, _ = x.shape
        if context is None:
            q, k, v = fused_proj(self, x, [self.to_q, self.to_k, self.to_v])
        else:
            (q,) = fused_proj(self, x, [self.to_q])
            k, v = fused_proj(self, context, [self.to_k, self.to_v], "_kv")
        m = k.shape[1]
        q = q.view(b, n, self.heads, self.dim_head)
        k = k.view(b, m, self.heads, self.dim_head)
        v = v.view(b, m, self.heads, self.dim_head)
        out = scaled_dot_product_attention(q, k, v, softmax_shift=self._logit_shift(q, k))
        out = out.reshape(b, n, self.heads * self.dim_head)
        return self.to_out[0](out) if residual is None else apply_add(self.to_out[0], out,
                                                                      residual)

    def _logit_shift(self, q, k):
        """The calibrated per-head bound on the scaled logits: recorded while
        calibrating (the max over blocks of 256 queries, in f32), read at
        serving; None outside the int8 policy."""
        if self.calib is not None:
            scale = q.shape[-1] ** -0.5
            kf = k.float()
            mx = torch.full((self.heads,), -1e30, device=q.device)
            for q0 in range(0, q.shape[1], _SHIFT_CHUNK):
                s = torch.einsum("bqhd,bkhd->bhqk", q[:, q0:q0 + _SHIFT_CHUNK].float(), kf)
                mx = torch.maximum(mx, (s * scale).amax(dim=(0, 2, 3)))
            self.record("logit_max", mx)
            return None
        return self.attn_shift if self.policy is not None else None

    def attach_tables(self) -> None:
        if self.act_scale is not None:
            for d in (self.to_q, self.to_k, self.to_v):
                d.w_q, d.w_scale = (t.contiguous() for t in d.tables())


class BasicTransformerBlock(nn.Module):
    """self-attn -> cross-attn(context) -> GEGLU FF, pre-LN residuals.
    ``disable_self_attn`` (a legacy-zoo option) makes attn1 a second
    cross-attention on the context, with token merging off for it;
    ``context_dim`` None (the legacy no-context families) keeps attn2 a
    self-attention."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int | None,
                 disable_self_attn: bool = False):
        super().__init__()
        self.disable_self_attn = disable_self_attn
        self.attn1 = CrossAttention(dim, heads, dim_head,
                                    context_dim if disable_self_attn else None)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim)
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.norm3 = LayerNorm(dim, eps=1e-5)

    def forward(self, x, context, tome=None):
        if self.disable_self_attn:
            x = self.attn1(self.norm1(x), context=context, residual=x)
        elif tome is not None and tome.applies(x):
            merge, unmerge, _ = tome.merge(x)
            x = x + unmerge(self.attn1(merge(self.norm1(x))))
        else:
            x = self.attn1(self.norm1(x), residual=x)
        x = self.attn2(self.norm2(x), context=context, residual=x)
        return self.ff(self.norm3(x), residual=x)


class SpatialTransformer(nn.Module):
    """GroupNorm(eps 1e-6) -> proj_in -> transformer blocks -> zero proj_out,
    plus the input. proj_in/proj_out are the reference's 1x1 convs."""

    def __init__(self, channels: int, heads: int, dim_head: int, context_dim: int | None,
                 depth: int = 1, disable_self_attn: bool = False):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = Conv1x1Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, dim_head, context_dim, disable_self_attn)
             for _ in range(depth)])
        self.proj_out = Conv1x1Linear(inner, channels, zero_init=True)

    def forward(self, x, context, tome=None):
        """x: [B, C, N] channel-first; returns the same layout."""
        h = self.proj_in(self.norm(x).transpose(1, 2))
        for block in self.transformer_blocks:
            h = block(h, context, tome)
        if self.proj_out.policy is not None:
            return self.proj_out(h, add=x.transpose(1, 2)).transpose(1, 2)
        return x + self.proj_out(h).transpose(1, 2)
