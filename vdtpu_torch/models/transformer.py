"""Cross-attention transformer (``vdtpu/models/transformer.py``): GEGLU,
FeedForward, CrossAttention, BasicTransformerBlock, SpatialTransformer.

``SpatialTransformer`` takes the channel-first view of its stream,
[B, C, N] (an NCHW map with its spatial axes flattened, or the 0-D
diffuser's channel-major latent), so its GroupNorm runs on contiguous
groups; tokens are the [B, N, C] transpose of that. Attention dispatches
through ``ops/attention.py``: the long self-attentions go to the flash
kernel, which reads q, k and v as views of the projections, without copies.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from vdtpu_torch.models.layers import Conv1x1Linear, GroupNorm32, LayerNorm, dense
from vdtpu_torch.ops.attention import scaled_dot_product_attention


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

    def forward(self, x):
        return self.net[2](self.net[0](x))


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when context is None. Scale
    d_head**-0.5; q/k/v projections have no bias, the output one does."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: int | None = None):
        super().__init__()
        inner = heads * dim_head
        context_dim = query_dim if context_dim is None else context_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = dense(query_dim, inner, bias=False)
        self.to_k = dense(context_dim, inner, bias=False)
        self.to_v = dense(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([dense(inner, query_dim)])

    def forward(self, x, context=None):
        context = x if context is None else context
        b, n, _ = x.shape
        m = context.shape[1]
        q = self.to_q(x).view(b, n, self.heads, self.dim_head)
        k = self.to_k(context).view(b, m, self.heads, self.dim_head)
        v = self.to_v(context).view(b, m, self.heads, self.dim_head)
        out = scaled_dot_product_attention(q, k, v)
        return self.to_out[0](out.reshape(b, n, self.heads * self.dim_head))


class BasicTransformerBlock(nn.Module):
    """self-attn -> cross-attn(context) -> GEGLU FF, pre-LN residuals."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim)
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.norm3 = LayerNorm(dim, eps=1e-5)

    def forward(self, x, context):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context=context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    """GroupNorm(eps 1e-6) -> proj_in -> transformer blocks -> zero proj_out,
    plus the input. proj_in/proj_out are the reference's 1x1 convs."""

    def __init__(self, channels: int, heads: int, dim_head: int, context_dim: int,
                 depth: int = 1):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = Conv1x1Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, dim_head, context_dim) for _ in range(depth)])
        self.proj_out = Conv1x1Linear(inner, channels, zero_init=True)

    def forward(self, x, context):
        """x: [B, C, N] channel-first; returns the same layout."""
        h = self.proj_in(self.norm(x).transpose(1, 2))
        for block in self.transformer_blocks:
            h = block(h, context)
        return x + self.proj_out(h).transpose(1, 2)
