"""Diagonal Gaussian posterior (``vdtpu/models/distributions.py``): the
mode and a sample; ``kl`` and ``nll`` (VAE training) are not ported.

Randomness comes from an explicit ``torch.Generator`` (the JAX package
takes a PRNG key); the two draw different numbers from one seed, so tests
compare ``mode`` and hand both sides the same noise."""
from __future__ import annotations

import torch


class DiagonalGaussian:
    """Moments [..., 2C, ...] split along ``channel_axis`` into mean and
    logvar (clamped to [-30, 20])."""

    def __init__(self, moments, channel_axis: int = -1):
        self.mean, logvar = moments.chunk(2, dim=channel_axis)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, generator: torch.Generator | None = None):
        noise = torch.randn(self.mean.shape, generator=generator, device=self.mean.device,
                            dtype=self.mean.dtype)
        return self.mean + self.std * noise

    def mode(self):
        return self.mean
