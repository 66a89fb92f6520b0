"""KL-f8 image VAE (``vdtpu/models/autoencoder.py``), NCHW.

Names follow the reference tree (``encoder.down.0.block.1.conv2``,
``decoder.up.1.block.0.conv1`` …, ``quant_conv``, ``post_quant_conv``).
GroupNorms (eps 1e-6) run through the GN(+SiLU) kernel, fused with the
swish that follows them. The mid-block attentions are one 512-wide head
over all pixels and take the plain attention path, as in the JAX package
(d_head > 256). The encoder's stride-2 downsample pads (0, 1, 0, 1), as
the reference does.
"""
from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from vdtpu_torch.models.distributions import DiagonalGaussian

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


class _Down(nn.Module):
    """Asymmetric-pad stride-2 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class _DownLevel(nn.Module):
    def __init__(self, blocks, attns, downsample):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if attns:
            self.attn = nn.ModuleList(attns)
        if downsample is not None:
            self.downsample = downsample


class VAEEncoder(nn.Module):
    """conv_in -> down levels -> mid -> GN-swish -> conv_out (2 z_channels
    moments with double_z)."""

    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int, z_channels: int,
                 double_z: bool = True, attn_resolutions: Sequence[int] = (),
                 resolution: int = 256, in_channels: int = 3):
        super().__init__()
        self.conv_in = conv3(in_channels, ch, quant=False)
        curr_res, block_in = resolution, ch
        levels = []
        for i_level, mult in enumerate(ch_mult):
            block_out = ch * mult
            blocks, attns = [], []
            for _ in range(num_res_blocks):
                blocks.append(VAEResnetBlock(block_in, block_out))
                block_in = block_out
                if curr_res in attn_resolutions:
                    attns.append(VAEAttnBlock(block_in))
            down = _Down(block_in) if i_level != len(ch_mult) - 1 else None
            if down is not None:
                curr_res //= 2
            levels.append(_DownLevel(blocks, attns, down))
        self.down = nn.ModuleList(levels)
        self.mid = _Mid(block_in)
        self.norm_out = GroupNorm32(block_in, eps=1e-6)
        self.conv_out = conv3(block_in, 2 * z_channels if double_z else z_channels, quant=False)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            for i, block in enumerate(level.block):
                h = block(h)
                if hasattr(level, "attn"):
                    h = level.attn[i](h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        return self.conv_out(self.norm_out(self.mid(h), silu=True))


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
    """The KL autoencoder: image [B, 3, H, W] in [0, 1] -> posterior over
    latents [B, z, H/8, W/8]; latent -> image in [0, 1] (clamped);
    ``forward`` is the reconstruction pass that its training loss
    (``models/autokl_loss.py``) differentiates."""

    def __init__(self, ddconfig=None, embed_dim: int = 4, **_unused):
        super().__init__()
        dd = dict(ddconfig)
        self.encoder = VAEEncoder(
            ch=dd["ch"], ch_mult=tuple(dd["ch_mult"]), num_res_blocks=dd["num_res_blocks"],
            z_channels=dd["z_channels"], double_z=dd.get("double_z", True),
            attn_resolutions=tuple(dd.get("attn_resolutions") or ()),
            resolution=dd.get("resolution", 256), in_channels=dd.get("in_channels", 3))
        z_moments = 2 * dd["z_channels"] if dd.get("double_z", True) else dd["z_channels"]
        self.quant_conv = nn.Conv2d(z_moments, 2 * embed_dim, 1)
        self.decoder = VAEDecoder(
            ch=dd["ch"], out_ch=dd["out_ch"], ch_mult=tuple(dd["ch_mult"]),
            num_res_blocks=dd["num_res_blocks"], z_channels=dd["z_channels"],
            attn_resolutions=tuple(dd.get("attn_resolutions") or ()),
            resolution=dd.get("resolution", 256))
        self.post_quant_conv = nn.Conv2d(embed_dim, dd["z_channels"], 1)

    def posterior(self, x) -> DiagonalGaussian:
        """x [B, 3, H, W] in [0, 1], mapped to [-1, 1] (as the reference) in
        x's dtype, then cast to the weights' dtype."""
        h = (x * 2.0 - 1.0).to(self.quant_conv.weight.dtype)
        return DiagonalGaussian(self.quant_conv(self.encoder(h)), channel_axis=1)

    def encode(self, x, generator=None):
        """The posterior's mode, or a sample drawn from ``generator``."""
        post = self.posterior(x)
        return post.mode() if generator is None else post.sample(generator)

    def decode(self, z, clamp: bool = True):
        dec = (self.decoder(self.post_quant_conv(z)) + 1.0) / 2.0
        return dec.clamp(0.0, 1.0) if clamp else dec

    def forward(self, x, generator=None):
        """The reconstruction pass of VAE training: (the unclamped decode of
        the posterior's mode, or of a sample drawn from ``generator``; the
        posterior)."""
        post = self.posterior(x)
        z = post.mode() if generator is None else post.sample(generator)
        return self.decode(z, clamp=False), post
