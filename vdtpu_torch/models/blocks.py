"""UNet data-layer blocks (``vdtpu/models/blocks.py``): the 2-D ResBlock
(NCHW) and the 0-D FC block (flat [B, F] features).

Torch key layout of the reference: ``in_layers.{0,2}``, ``emb_layers.1``,
``out_layers.{0,3}``, ``skip_connection``. The unnamed slots (SiLU, dropout)
are parameter-free placeholders, and each GroupNorm runs fused with its
SiLU (``GroupNorm32(x, silu=True)``). Dropout is 0 on this path.

Under an int8 policy (``ops/quant.py``) the ResBlock's FiLM and residual
adds ride its convs' f32 epilogues, and the policy picks how each GN+SiLU
meets its conv's quantize (``_gn_conv``), or runs GN+SiLU+quantize inside
the conv kernel (``conv="fused"``, sites of at least ``fused_min_pixels``
with 8-aligned sizes), or runs the whole block in one kernel
(``conv="fused2"``, at such a site whose two convs have calibrated tables
and run int8; else as under "fused", as vdtpu's ``_fused_flat`` falls
back). The FiLM projection and the 1x1 skip conv stay in the compute
dtype, as in the JAX package.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from vdtpu_torch.models.layers import Conv1x1Linear, GroupNorm32, apply_add, conv3, dense
from vdtpu_torch.ops import quant


class ResBlock2D(nn.Module):
    """GN-SiLU-conv3 -> +time-FiLM -> GN-SiLU-zero conv3, learned skip."""

    def __init__(self, channels: int, out_channels: int, emb_dim: int):
        super().__init__()
        self.in_layers = nn.ModuleList([GroupNorm32(channels), nn.Identity(),
                                        conv3(channels, out_channels)])
        self.emb_layers = nn.ModuleList([nn.Identity(),
                                         dense(emb_dim, out_channels, quant=False)])
        self.out_layers = nn.ModuleList([GroupNorm32(out_channels), nn.Identity(),
                                         nn.Identity(),
                                         conv3(out_channels, out_channels, zero=True)])
        self.skip_connection = (nn.Identity() if channels == out_channels
                                else nn.Conv2d(channels, out_channels, 1))

    def forward(self, x, emb):
        e = self.emb_layers[1](F.silu(emb))[:, :, None, None]
        pol = self.in_layers[2].policy
        if pol is None:
            h = self.in_layers[2](self.in_layers[0](x, silu=True)) + e
            h = self.out_layers[3](self.out_layers[0](h, silu=True))
            return self.skip_connection(x) + h
        skip = self.skip_connection(x)
        if pol.conv in ("fused", "fused2") and self._fused_eligible(x, pol):
            conv1, conv2 = self.in_layers[2], self.out_layers[3]
            if pol.conv == "fused2" and quant.fused2_ready(conv1, conv2, x.shape[1],
                                                           x.shape[2] * x.shape[3]):
                return quant.resblock_int8(x, self.in_layers[0], conv1, e[:, :, 0, 0],
                                           self.out_layers[0], conv2,
                                           None if skip is x else skip)
            h = self.in_layers[2](x, gn=self.in_layers[0], add=e, fused=True)
            return self.out_layers[3](h, gn=self.out_layers[0], add=skip, fused=True)
        h = self._gn_conv(x, self.in_layers[0], self.in_layers[2], e, pol)
        return self._gn_conv(h, self.out_layers[0], self.out_layers[3], skip, pol)

    @staticmethod
    def _gn_conv(x, norm, conv, add, pol):
        """GN+SiLU then conv with the add in its epilogue; the "fused" and
        "stats" prologues hand the GroupNorm to the conv."""
        if pol.gn_prologue in ("fused", "stats"):
            return conv(x, gn=norm, add=add)
        return apply_add(conv, norm(x, silu=True), add)

    def _fused_eligible(self, x, pol) -> bool:
        """``vdtpu/ops/pallas/qconv.py::eligible`` without its backend check."""
        _, c, h, w = x.shape
        n = self.in_layers[2].out_channels
        return (h * w >= pol.fused_min_pixels and h % 8 == 0 and w % 8 == 0
                and c % 8 == 0 and n % 8 == 0)


class FCBlock(nn.Module):
    """The 0-D ResBlock on [B, F]: its 1x1 convs are linear maps."""

    def __init__(self, channels: int, out_channels: int, emb_dim: int):
        super().__init__()
        self.in_layers = nn.ModuleList([GroupNorm32(channels), nn.Identity(),
                                        Conv1x1Linear(channels, out_channels)])
        self.emb_layers = nn.ModuleList([nn.Identity(),
                                         dense(emb_dim, out_channels, quant=False)])
        self.out_layers = nn.ModuleList([GroupNorm32(out_channels), nn.Identity(),
                                         nn.Identity(),
                                         Conv1x1Linear(out_channels, out_channels,
                                                       zero_init=True)])
        self.skip_connection = (nn.Identity() if channels == out_channels
                                else Conv1x1Linear(channels, out_channels))

    def forward(self, x, emb):
        e = self.emb_layers[1](F.silu(emb))
        h = self.in_layers[0](x[:, :, None], silu=True)[:, :, 0]
        h = apply_add(self.in_layers[2], h, e)
        h = self.out_layers[0](h[:, :, None], silu=True)[:, :, 0]
        return apply_add(self.out_layers[3], h, self.skip_connection(x))
