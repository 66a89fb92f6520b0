"""Diagonal Gaussian posterior (``vdtpu/models/distributions.py``): the
mode, a sample, and the VAE training terms ``kl`` and ``nll``, with the
module-level ``normal_kl``.

Randomness comes from an explicit ``torch.Generator`` (the JAX package
takes a PRNG key); the two draw different numbers from one seed, so tests
compare ``mode`` and hand both sides the same noise. ``kl`` and ``nll`` sum
over every axis but the first, so they do not depend on the layout."""
from __future__ import annotations

import math

import torch


class DiagonalGaussian:
    """Moments [..., 2C, ...] split along ``channel_axis`` into mean and
    logvar (clamped to [-30, 20]). ``deterministic``: ``sample`` returns the
    mean, ``kl`` and ``nll`` return zeros."""

    def __init__(self, moments, deterministic: bool = False, channel_axis: int = -1):
        self.mean, logvar = moments.chunk(2, dim=channel_axis)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.deterministic = deterministic
        self.std = torch.exp(0.5 * self.logvar)
        self.var = torch.exp(self.logvar)

    def sample(self, generator: torch.Generator | None = None):
        if self.deterministic:
            return self.mean
        noise = torch.randn(self.mean.shape, generator=generator, device=self.mean.device,
                            dtype=self.mean.dtype)
        return self.mean + self.std * noise

    def mode(self):
        return self.mean

    def _zeros(self):
        return torch.zeros(self.mean.shape[:1], device=self.mean.device)

    def kl(self, other: "DiagonalGaussian | None" = None):
        """KL(self || other), or against N(0, I) when ``other`` is None: [B]."""
        if self.deterministic:
            return self._zeros()
        dims = tuple(range(1, self.mean.dim()))
        if other is None:
            return 0.5 * torch.sum(self.mean ** 2 + self.var - 1.0 - self.logvar, dim=dims)
        return 0.5 * torch.sum((self.mean - other.mean) ** 2 / other.var
                               + self.var / other.var - 1.0 - self.logvar + other.logvar,
                               dim=dims)

    def nll(self, sample, axes=None):
        """Negative log-likelihood of ``sample``, summed over ``axes`` (every
        axis but the first by default)."""
        if self.deterministic:
            return torch.zeros(sample.shape[:1], device=sample.device)
        if axes is None:
            axes = tuple(range(1, sample.dim()))
        return 0.5 * torch.sum(math.log(2.0 * math.pi) + self.logvar
                               + (sample - self.mean) ** 2 / self.var, dim=axes)


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL between two Gaussians, elementwise with broadcasting (tensors or
    floats mixed)."""
    logvar1, logvar2 = (torch.as_tensor(v) for v in (logvar1, logvar2))
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + (mean1 - mean2) ** 2 * torch.exp(-logvar2))
