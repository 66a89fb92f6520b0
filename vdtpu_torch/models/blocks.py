"""UNet data-layer blocks (``vdtpu/models/blocks.py``): the 2-D ResBlock
(NCHW) and the 0-D FC block (flat [B, F] features).

Torch key layout of the reference: ``in_layers.{0,2}``, ``emb_layers.1``,
``out_layers.{0,3}``, ``skip_connection``. The unnamed slots (SiLU, dropout)
are parameter-free placeholders, and each GroupNorm runs fused with its
SiLU (``GroupNorm32(x, silu=True)``). Dropout is 0 on this path.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from vdtpu_torch.models.layers import Conv1x1Linear, GroupNorm32, conv3, dense


class ResBlock2D(nn.Module):
    """GN-SiLU-conv3 -> +time-FiLM -> GN-SiLU-zero conv3, learned skip."""

    def __init__(self, channels: int, out_channels: int, emb_dim: int):
        super().__init__()
        self.in_layers = nn.ModuleList([GroupNorm32(channels), nn.Identity(),
                                        conv3(channels, out_channels)])
        self.emb_layers = nn.ModuleList([nn.Identity(), dense(emb_dim, out_channels)])
        self.out_layers = nn.ModuleList([GroupNorm32(out_channels), nn.Identity(),
                                         nn.Identity(),
                                         conv3(out_channels, out_channels, zero=True)])
        self.skip_connection = (nn.Identity() if channels == out_channels
                                else nn.Conv2d(channels, out_channels, 1))

    def forward(self, x, emb):
        e = self.emb_layers[1](F.silu(emb))
        h = self.in_layers[2](self.in_layers[0](x, silu=True)) + e[:, :, None, None]
        h = self.out_layers[3](self.out_layers[0](h, silu=True))
        return self.skip_connection(x) + h


class FCBlock(nn.Module):
    """The 0-D ResBlock on [B, F]: its 1x1 convs are linear maps."""

    def __init__(self, channels: int, out_channels: int, emb_dim: int):
        super().__init__()
        self.in_layers = nn.ModuleList([GroupNorm32(channels), nn.Identity(),
                                        Conv1x1Linear(channels, out_channels)])
        self.emb_layers = nn.ModuleList([nn.Identity(), dense(emb_dim, out_channels)])
        self.out_layers = nn.ModuleList([GroupNorm32(out_channels), nn.Identity(),
                                         nn.Identity(),
                                         Conv1x1Linear(out_channels, out_channels,
                                                       zero_init=True)])
        self.skip_connection = (nn.Identity() if channels == out_channels
                                else Conv1x1Linear(channels, out_channels))

    def forward(self, x, emb):
        e = self.emb_layers[1](F.silu(emb))
        h = self.in_layers[0](x[:, :, None], silu=True)[:, :, 0]
        h = self.in_layers[2](h) + e
        h = self.out_layers[0](h[:, :, None], silu=True)[:, :, 0]
        return self.out_layers[3](h) + self.skip_connection(x)
