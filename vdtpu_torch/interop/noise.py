"""The upstream app's per-request torch noise, replayed
(``vdtpu/interop/noise.py``, the port's own copy).

The reference app pins its RNG per request with ``np.random.seed(seed);
torch.manual_seed(seed + 100)`` and then draws, in order: x_T
(``torch.randn(shape)``, pure-noise mode) or the q_sample noise of the x0
start, then one ``torch.randn_like(x)`` per sampling step, even at eta 0.
The port seeds a ``torch.Generator`` with ``seed`` and draws nothing at
eta 0, so a seed alone does not give the upstream x_T. ``capture`` replays
the upstream stream on the CPU; its draws handed to ``DDIMSampler.sample``
as ``x_info={"xt": ...}`` (or ``{"x0": ..., "noise": ...}``) and
``noise_table=...`` (NHWC: ``nchw_to_nhwc``) make the sampler consume the
upstream noise as it is.
"""
from __future__ import annotations

import numpy as np
import torch


def capture(seed: int, shape, steps: int, x0_forward_timesteps: int | None = None):
    """The draws of one upstream request, numpy f32: "xt" (pure-noise mode)
    or "q_noise" (x0 mode: ``x0_forward_timesteps`` set), then
    "step_noise" [S, *shape], S the steps that run. ``shape`` is the NCHW
    latent batch the reference draws, e.g. (2, 4, 64, 64)."""
    np.random.seed(seed)
    torch.manual_seed(seed + 100)
    out = {}
    if x0_forward_timesteps is None:
        out["xt"] = torch.randn(tuple(shape)).numpy()
        n = steps
    else:
        out["q_noise"] = torch.randn(tuple(shape)).numpy()
        n = int(x0_forward_timesteps)
    out["step_noise"] = np.stack([torch.randn(tuple(shape)).numpy() for _ in range(n)])
    return out


def nchw_to_nhwc(a: np.ndarray) -> np.ndarray:
    """NCHW latents (and [S, N, C, H, W] tables) to the sampler's NHWC."""
    return np.transpose(a, (0, 2, 3, 1)) if a.ndim == 4 else \
        np.transpose(a, (0, 1, 3, 4, 2)) if a.ndim == 5 else a
