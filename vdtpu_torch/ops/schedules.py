"""Diffusion schedule math (``vdtpu/ops/schedules.py``): host-side numpy
tables in float64, stored as f32, plus the sinusoidal timestep embedding.

The beta schedules, every table of ``DiffusionSchedule`` (the samplers'
and training's), ``q_sample``, the DDIM timestep ladder and its
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
    """Every per-timestep table of ``vdtpu/ops/schedules.py::DiffusionSchedule``
    (f32 numpy, length ``num_timesteps``): the samplers read ``betas`` and
    ``alphas_cumprod``, training reads ``sqrt_alphas_cumprod``,
    ``sqrt_one_minus_alphas_cumprod`` (``q_sample``) and ``lvlb_weights``."""
    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    lvlb_weights: np.ndarray
    num_timesteps: int

    @classmethod
    def create(cls, timesteps: int = 1000, beta_schedule: str = "linear",
               linear_start: float = 1e-4, linear_end: float = 2e-2,
               cosine_s: float = 8e-3, given_betas: np.ndarray | None = None,
               v_posterior: float = 0.0, parameterization: str = "eps"
               ) -> "DiffusionSchedule":
        """The tables in float64, stored as f32 (``lvlb_weights`` from f32
        factors, its row 0 copied from row 1, as the JAX package does)."""
        betas = (np.asarray(given_betas, dtype=np.float64) if given_betas is not None
                 else make_beta_schedule(beta_schedule, timesteps, linear_start=linear_start,
                                         linear_end=linear_end, cosine_s=cosine_s))
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas, axis=0)
        alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
        posterior_variance = ((1 - v_posterior) * betas * (1.0 - alphas_cumprod_prev)
                              / (1.0 - alphas_cumprod) + v_posterior * betas)
        f32 = lambda a: np.asarray(a, dtype=np.float32)
        if parameterization == "eps":
            with np.errstate(divide="ignore"):  # posterior_variance[0] == 0
                lvlb = f32(betas) ** 2 / (2 * f32(posterior_variance) * f32(alphas)
                                          * (1 - f32(alphas_cumprod)))
        elif parameterization == "x0":
            lvlb = 0.5 * np.sqrt(f32(alphas_cumprod)) / (2.0 * 1 - f32(alphas_cumprod))
        else:
            raise NotImplementedError(parameterization)
        lvlb = lvlb.copy()
        lvlb[0] = lvlb[1]
        return cls(
            betas=f32(betas),
            alphas_cumprod=f32(alphas_cumprod),
            alphas_cumprod_prev=f32(alphas_cumprod_prev),
            sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
            log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1)),
            posterior_variance=f32(posterior_variance),
            posterior_log_variance_clipped=f32(np.log(np.maximum(posterior_variance, 1e-20))),
            posterior_mean_coef1=f32(betas * np.sqrt(alphas_cumprod_prev)
                                     / (1.0 - alphas_cumprod)),
            posterior_mean_coef2=f32((1.0 - alphas_cumprod_prev) * np.sqrt(alphas)
                                     / (1.0 - alphas_cumprod)),
            lvlb_weights=f32(lvlb),
            num_timesteps=int(betas.shape[0]))

    def q_sample(self, x_start, t, noise):
        """x_t ~ q(x_t | x_0) for x_start of any rank, t [B] (f32 math)."""
        return (extract(self.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
                + extract(self.sqrt_one_minus_alphas_cumprod, t, x_start.ndim) * noise)


def extract(table: np.ndarray, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """table[t] as f32 on t's device, shaped [B, 1, ..., 1] for rank ndim."""
    out = torch.as_tensor(table, device=t.device)[t.long()]
    return out.reshape(out.shape[0], *((1,) * (ndim - 1)))


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
