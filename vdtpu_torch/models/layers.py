"""Small shared layers (``vdtpu/models/layers.py``), channel-first.

Parameter names and shapes are the reference torch state-dict's, so a
checkpoint exported by the JAX package (``VDSystem.export_torch_checkpoint``)
loads with ``strict=True``. Every GroupNorm runs through the GN(+SiLU)
kernel of ``ops/gn_silu.py``, fused with the SiLU that follows it where
there is one. Norm statistics are f32 whatever the compute dtype.

``conv3`` and ``dense`` build the int8-capable ``QConv`` / ``QDense`` of
``ops/quant.py`` (plain layers until a policy is attached) unless
``quant=False``, which the JAX package sets on the time-embed MLP, the
ResBlock FiLM projections, the context encoders and the VAE. Under int8 a
``GroupNorm32`` also serves as the parameter holder of a fused GN prologue
(the JAX ``GNParams``): the conv reads its weight and bias.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vdtpu_torch.ops.gn_silu import gn_silu
from vdtpu_torch.ops.quant import QConv, QDense


class GroupNorm32(nn.Module):
    """GroupNorm parameters ({weight, bias}) whose forward is the GN(+SiLU)
    kernel over [B, C, *spatial]."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, silu: bool = False):
        return gn_silu(x.contiguous(), self.weight, self.bias, self.groups, self.eps, silu)


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in f32 and cast back (flax ``dtype=float32``)."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class Conv1x1Linear(QDense):
    """A 1x1 convolution stored as the reference stores it ([O, I, 1, 1]
    weight) applied as a linear map over the last axis of its input."""

    def __init__(self, in_features: int, out_features: int, zero_init: bool = False):
        super().__init__(in_features, out_features)
        self.weight = nn.Parameter(torch.empty(out_features, in_features, 1, 1))
        self.weight.zero_init = zero_init

    def weight2d(self):
        return self.weight.flatten(1)


def zero_init(module: nn.Module) -> nn.Module:
    """Mark a layer's weight as zero-initialized (the reference's zero_module)."""
    module.weight.zero_init = True
    return module


def conv3(in_ch: int, out_ch: int, stride: int = 1, zero: bool = False,
          quant: bool = True) -> nn.Conv2d:
    conv = (QConv(in_ch, out_ch, stride) if quant
            else nn.Conv2d(in_ch, out_ch, 3, stride=stride, padding=1))
    return zero_init(conv) if zero else conv


def dense(in_features: int, out_features: int, bias: bool = True,
          zero: bool = False, quant: bool = True) -> nn.Linear:
    lin = (QDense(in_features, out_features, bias=bias) if quant
           else nn.Linear(in_features, out_features, bias=bias))
    return zero_init(lin) if zero else lin


def apply_add(module: nn.Module, x, add):
    """module(x) + add; under int8 the add rides the layer's f32 epilogue
    (one rounding to the compute dtype instead of two)."""
    if getattr(module, "policy", None) is not None:
        return module(x, add=add)
    return module(x) + add


class TimeEmbedMLP(nn.Sequential):
    """Dense -> SiLU -> Dense, torch layout ``time_embed.{0,2}``."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__(dense(in_dim, dim, quant=False), nn.SiLU(),
                         dense(dim, dim, quant=False))


class Upsample2D(nn.Module):
    """Nearest 2x upsample + 3x3 conv."""

    def __init__(self, channels: int, quant: bool = True):
        super().__init__()
        self.conv = conv3(channels, channels, quant=quant)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.op = conv3(channels, channels, stride=2)

    def forward(self, x):
        return self.op(x)


@torch.no_grad()
def init_random(module: nn.Module, generator: torch.Generator) -> None:
    """The port's seeded init: lecun-normal weights (std 1/sqrt(fan_in), as
    flax's default kernel init), N(0, 1) embeddings, zero biases, unit norm
    scales, zeros where the reference zero-initializes, and N(0, init_std)
    where a parameter names its own (CLIP's class embedding)."""
    for mod in module.modules():
        for name, p in mod.named_parameters(recurse=False):
            if getattr(p, "zero_init", False):
                p.zero_()
            elif isinstance(mod, nn.Embedding):
                p.copy_(torch.randn(p.shape, generator=generator, device=p.device))
            elif isinstance(mod, (GroupNorm32, nn.LayerNorm)):
                p.fill_(1.0 if name == "weight" else 0.0)
            elif getattr(p, "init_std", None) is not None:
                p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * p.init_std)
            elif name == "bias":
                p.zero_()
            else:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=generator, device=p.device)
                        * fan_in ** -0.5)
