"""DPM-Solver++(2M) (``vdtpu/sampling/dpmpp.py``) as a Python loop.

A second-order multistep exponential-integrator solver in x0-prediction
space (Lu et al., arXiv 2211.01095: "dpmsolver++", midpoint, multistep)
over the DDIM timestep ladder and its terminal point. Every per-step
scalar (the (alpha, sigma) pair of the eval point, sigma_{i+1}/sigma_i,
alpha_{i+1}(e^{-h_i} - 1) and the second-order weight 0.5/r_i) is a
float64 host table rounded to f32, as in the JAX package; the rows go to
the device once per request and each is cast to x's dtype before use.
The previous x0 prediction rides from step to step (and from segment to
segment: ``m_prev`` / ``return_carry``, so a segmented run equals a whole
one bit for bit); the first step and, for ladders under 15 steps, the
last one drop to first order through a zero weight.

Deterministic only: eta, temperature and noise stay with DDIM.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from vdtpu_torch.ops.schedules import DiffusionSchedule, make_ddim_timesteps


@dataclasses.dataclass(frozen=True)
class DPMppTables:
    """Per-step tables, ordered as sampled (t descending). The grid is the
    S eval points plus the terminal point at alphas_cumprod[0], the final
    alpha_prev of the DDIM tables."""
    timesteps: np.ndarray     # int32 [S]
    alphas: np.ndarray        # f32 [S] sqrt(abar) at the eval point
    sigmas: np.ndarray        # f32 [S] sqrt(1 - abar)
    sigma_ratio: np.ndarray   # f32 [S] sigma_{i+1} / sigma_i
    alpha_phi: np.ndarray     # f32 [S] alpha_{i+1} * (exp(-h_i) - 1)
    w2: np.ndarray            # f32 [S] 0.5 / r_i where the second order is on

    @classmethod
    def create(cls, schedule: DiffusionSchedule, steps: int, truncate: int | None = None,
               lower_order_final: bool | None = None) -> "DPMppTables":
        """``truncate``: keep the ``truncate`` lowest timesteps (the x0
        start); ``lower_order_final`` (None: on when S < 15) zeroes the last
        step's second-order weight."""
        ts = make_ddim_timesteps(steps, schedule.num_timesteps)
        if truncate is not None:
            ts = ts[:truncate]
        abar = np.asarray(schedule.alphas_cumprod, np.float64)
        grid = np.concatenate([abar[ts[::-1]], abar[:1]])
        alpha, sigma = np.sqrt(grid), np.sqrt(1.0 - grid)
        lam = np.log(alpha / sigma)
        h = lam[1:] - lam[:-1]
        s = len(ts)
        w2 = np.zeros((s,), np.float64)
        if s > 1:
            w2[1:] = 0.5 * h[1:] / h[:-1]
        if lower_order_final is None:
            lower_order_final = s < 15
        if lower_order_final and s > 1:
            w2[-1] = 0.0
        f32 = lambda a: np.ascontiguousarray(np.asarray(a, np.float32))
        return cls(timesteps=np.ascontiguousarray(ts[::-1].astype(np.int32)),
                   alphas=f32(alpha[:-1]), sigmas=f32(sigma[:-1]),
                   sigma_ratio=f32(sigma[1:] / sigma[:-1]),
                   alpha_phi=f32(alpha[1:] * np.expm1(-h)), w2=f32(w2))

    def on_device(self, dtype, device) -> torch.Tensor:
        """[S, 5] rows of (alpha, sigma, sigma_ratio, alpha_phi, w2), each
        f32 value rounded to ``dtype``."""
        rows = np.stack([self.alphas, self.sigmas, self.sigma_ratio, self.alpha_phi,
                         self.w2], axis=1).reshape(-1, 5)
        return torch.as_tensor(rows, dtype=torch.float32).to(device=device, dtype=dtype)


def slice_tables(tables: DPMppTables, a: int, b: int) -> DPMppTables:
    """Rows [a, b). The coefficients were derived from the whole grid, so a
    slice keeps a non-zero w2 at its head: the previous segment's x0
    prediction comes in as ``m_prev``."""
    return dataclasses.replace(tables, **{f.name: getattr(tables, f.name)[a:b]
                                          for f in dataclasses.fields(tables)})


def _dpmpp_update(x, eps, row, m_prev):
    """One solver step from x_i; returns (x_{i+1}, m_i)."""
    a, s, rt, ap, w = row[0], row[1], row[2], row[3], row[4]
    m = (x - s * eps) / a
    return rt * x - ap * (m + w * (m - m_prev)), m


def dpmpp_loop(eps_fn: Callable, x, tables: DPMppTables, m_prev=None,
               return_carry: bool = False):
    """The solver over ``tables``; eps_fn(x, t[B]) -> eps. ``m_prev`` is the
    previous segment's x0 prediction (None: zeros, which the head's zero
    weight leaves inert); ``return_carry`` returns (x, m) for the next."""
    rows = tables.on_device(x.dtype, x.device)
    ts = torch.as_tensor(tables.timesteps, dtype=torch.long).to(x.device)
    m = torch.zeros_like(x) if m_prev is None else m_prev
    for i in range(len(tables.timesteps)):
        x, m = _dpmpp_update(x, eps_fn(x, ts[i].expand(x.shape[0])), rows[i], m)
    return (x, m) if return_carry else x


def dpmpp_loop_encreuse(eps_fn: Callable, x, tables: DPMppTables, key_mask):
    """``dpmpp_loop`` with the encoder-reuse cache carried from step to step:
    eps_fn(x, t[B], use_cache, cache) -> (eps, cache), the cache reused on
    the steps where ``key_mask`` is False (the first step is a key step)."""
    rows = tables.on_device(x.dtype, x.device)
    ts = torch.as_tensor(tables.timesteps, dtype=torch.long).to(x.device)
    m, cache = torch.zeros_like(x), None
    for i in range(len(tables.timesteps)):
        eps, cache = eps_fn(x, ts[i].expand(x.shape[0]), not bool(key_mask[i]), cache)
        x, m = _dpmpp_update(x, eps, rows[i], m)
    return x
