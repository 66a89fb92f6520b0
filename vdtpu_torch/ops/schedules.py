"""Diffusion schedule math (``vdtpu/ops/schedules.py``): host-side numpy
tables in float64, stored as f32, plus the sinusoidal timestep embedding.

Only what sampling needs is here: the beta schedules, the cumulative
alphas of ``DiffusionSchedule``, the DDIM timestep ladder and its
(sigma, alpha, alpha_prev) tables.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def make_beta_schedule(schedule: str, n_timestep: int, linear_start: float = 1e-4,
                       linear_end: float = 2e-2, cosine_s: float = 8e-3) -> np.ndarray:
    """Beta table, float64: ``linear`` (sqrt-space linspace squared, the
    VD default), ``cosine``, ``sqrt_linear`` or ``sqrt``."""
    if schedule == "linear":
        betas = np.linspace(linear_start**0.5, linear_end**0.5, n_timestep,
                            dtype=np.float64) ** 2
    elif schedule == "cosine":
        t = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(t / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = np.clip(1.0 - alphas[1:] / alphas[:-1], 0.0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"unknown beta schedule {schedule!r}")
    return betas


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Per-timestep tables the samplers read (f32 numpy)."""
    betas: np.ndarray
    alphas_cumprod: np.ndarray
    num_timesteps: int

    @classmethod
    def create(cls, timesteps: int = 1000, beta_schedule: str = "linear",
               linear_start: float = 1e-4, linear_end: float = 2e-2,
               cosine_s: float = 8e-3) -> "DiffusionSchedule":
        betas = make_beta_schedule(beta_schedule, timesteps, linear_start=linear_start,
                                   linear_end=linear_end, cosine_s=cosine_s)
        alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
        return cls(betas=betas.astype(np.float32),
                   alphas_cumprod=alphas_cumprod.astype(np.float32),
                   num_timesteps=int(betas.shape[0]))


def make_ddim_timesteps(num_ddim_timesteps: int, num_ddpm_timesteps: int,
                        method: str = "uniform") -> np.ndarray:
    """DDIM timestep subsequence, ascending, +1 and clamped to the schedule."""
    if method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        steps = np.arange(0, num_ddpm_timesteps, c)
    elif method == "quad":
        steps = (np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8),
                             num_ddim_timesteps) ** 2).astype(int)
    else:
        raise NotImplementedError(f"ddim discretization {method!r}")
    return np.minimum(steps + 1, num_ddpm_timesteps - 1)


def make_ddim_sampling_parameters(alphacums: np.ndarray, ddim_timesteps: np.ndarray,
                                  eta: float):
    """Per-step (sigma, alpha, alpha_prev) tables."""
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.concatenate([alphacums[:1], alphacums[ddim_timesteps[:-1]]])
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding [B, dim] in f32, [cos | sin] layout."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device)
                      / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb
