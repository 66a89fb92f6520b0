"""KL-f8 image VAE, decode path (``vdtpu/models/autoencoder.py``), NCHW.

Names follow the reference tree (``decoder.up.1.block.0.conv1`` …,
``post_quant_conv``). GroupNorms (eps 1e-6) run through the GN(+SiLU)
kernel, fused with the swish that follows them. The mid-block attention is
one 512-wide head over all pixels and takes the plain attention path, as
in the JAX package (d_head > 256). The encoder waits for a later slice.
"""
from __future__ import annotations

from typing import Sequence

from torch import nn

from vdtpu_torch.models.layers import GroupNorm32, Upsample2D, conv3
from vdtpu_torch.ops.attention import scaled_dot_product_attention


class VAEResnetBlock(nn.Module):
    """GN-swish-conv3 twice, 1x1 nin_shortcut when the width changes."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = GroupNorm32(in_channels, eps=1e-6)
        self.conv1 = conv3(in_channels, out_channels, quant=False)
        self.norm2 = GroupNorm32(out_channels, eps=1e-6)
        self.conv2 = conv3(out_channels, out_channels, quant=False)
        if in_channels != out_channels:
            self.nin_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x):
        h = self.conv1(self.norm1(x, silu=True))
        h = self.conv2(self.norm2(h, silu=True))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class VAEAttnBlock(nn.Module):
    """Single-head spatial self-attention with 1x1 projections."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.q = nn.Conv2d(channels, channels, 1)
        self.k = nn.Conv2d(channels, channels, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.norm(x)
        # [B, HW, 1, C] with C contiguous: a small VAE (d <= 256, >= 1024
        # pixels) sends this site to the flash kernel, which reads rows in place
        tok = lambda t: t.flatten(2).transpose(1, 2).contiguous()[:, :, None, :]
        out = scaled_dot_product_attention(tok(self.q(h)), tok(self.k(h)), tok(self.v(h)),
                                           scale=c ** -0.5)
        out = out[:, :, 0, :].transpose(1, 2).reshape(b, c, hh, ww)
        return x + self.proj_out(out)


class _Mid(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.block_1 = VAEResnetBlock(channels, channels)
        self.attn_1 = VAEAttnBlock(channels)
        self.block_2 = VAEResnetBlock(channels, channels)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


class _UpLevel(nn.Module):
    def __init__(self, blocks, attns, upsample):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if attns:
            self.attn = nn.ModuleList(attns)
        if upsample is not None:
            self.upsample = upsample


class VAEDecoder(nn.Module):
    """conv_in -> mid -> up levels (highest first) -> GN-swish -> conv_out."""

    def __init__(self, ch: int, out_ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 z_channels: int, attn_resolutions: Sequence[int] = (),
                 resolution: int = 256):
        super().__init__()
        num_res = len(ch_mult)
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (num_res - 1)
        self.conv_in = conv3(z_channels, block_in, quant=False)
        self.mid = _Mid(block_in)
        levels = [None] * num_res
        for i_level in reversed(range(num_res)):
            block_out = ch * ch_mult[i_level]
            blocks, attns = [], []
            for _ in range(num_res_blocks + 1):
                blocks.append(VAEResnetBlock(block_in, block_out))
                block_in = block_out
                if curr_res in attn_resolutions:
                    attns.append(VAEAttnBlock(block_in))
            up = Upsample2D(block_in, quant=False) if i_level != 0 else None
            if i_level != 0:
                curr_res *= 2
            levels[i_level] = _UpLevel(blocks, attns, up)
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm32(block_in, eps=1e-6)
        self.conv_out = conv3(block_in, out_ch, quant=False)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            for i, block in enumerate(level.block):
                h = block(h)
                if hasattr(level, "attn"):
                    h = level.attn[i](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(self.norm_out(h, silu=True))


class AutoencoderKL(nn.Module):
    """Decode path of the KL autoencoder: latent [B, z, h, w] -> image
    [B, 3, 8h, 8w] in [0, 1] (clamped)."""

    def __init__(self, ddconfig=None, embed_dim: int = 4, **_unused):
        super().__init__()
        dd = dict(ddconfig)
        self.decoder = VAEDecoder(
            ch=dd["ch"], out_ch=dd["out_ch"], ch_mult=tuple(dd["ch_mult"]),
            num_res_blocks=dd["num_res_blocks"], z_channels=dd["z_channels"],
            attn_resolutions=tuple(dd.get("attn_resolutions") or ()),
            resolution=dd.get("resolution", 256))
        self.post_quant_conv = nn.Conv2d(embed_dim, dd["z_channels"], 1)

    def decode(self, z, clamp: bool = True):
        dec = (self.decoder(self.post_quant_conv(z)) + 1.0) / 2.0
        return dec.clamp(0.0, 1.0) if clamp else dec
