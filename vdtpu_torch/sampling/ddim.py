"""DDIM sampler (``vdtpu/sampling/ddim.py``) as a Python loop.

Per-step (alpha, alpha_prev, sigma) values are host-side tables; they go
to the device once per request and each step reads its row there, so the
loop adds no host-device synchronization. Classifier-free guidance is one
2x-batched model call per step, [uncond, cond]. Noise comes from an
explicit ``torch.Generator`` or, for comparisons with the JAX package, a
pre-drawn ``noise_table``.

``DDIMSampler.sample`` (one context) and ``sample_multicontext`` (the
blend flows' contexts, mixed by ratio or chosen per context slot, under one
guidance scale) take and return NHWC image latents, as the JAX API does,
and the model runs NCHW in between; text latents are [n, F] on both sides.
Both share the start and the loop: x_T as given, pure noise, or (img2img)
x0 noised to the k-th lowest timestep with only the k lowest steps left to
run. Encoder reuse, DPM-Solver++ and the cfg interval are later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from vdtpu_torch.ops.schedules import (
    DiffusionSchedule, make_ddim_sampling_parameters, make_ddim_timesteps)


@dataclasses.dataclass(frozen=True)
class DDIMTables:
    """Per-step tables, ordered as sampled (t descending)."""
    timesteps: np.ndarray     # int32 [S]
    alphas: np.ndarray        # f32 [S]
    alphas_prev: np.ndarray
    sigmas: np.ndarray
    sqrt_one_minus_alphas: np.ndarray

    @classmethod
    def create(cls, schedule: DiffusionSchedule, steps: int,
               eta: float = 0.0) -> "DDIMTables":
        ts = make_ddim_timesteps(steps, schedule.num_timesteps)
        sig, al, alp = make_ddim_sampling_parameters(schedule.alphas_cumprod, ts, eta)
        rev = lambda a: np.ascontiguousarray(np.asarray(a, np.float32)[::-1])
        return cls(timesteps=np.ascontiguousarray(ts[::-1].astype(np.int32)),
                   alphas=rev(al), alphas_prev=rev(alp), sigmas=rev(sig),
                   sqrt_one_minus_alphas=rev(np.sqrt(1.0 - np.asarray(al, np.float64))))

    def tail(self, k: int) -> "DDIMTables":
        """The k lowest-timestep rows (the trailing k: rows run t descending)."""
        cut = lambda a: a[len(a) - k:]
        return dataclasses.replace(
            self, timesteps=cut(self.timesteps), alphas=cut(self.alphas),
            alphas_prev=cut(self.alphas_prev), sigmas=cut(self.sigmas),
            sqrt_one_minus_alphas=cut(self.sqrt_one_minus_alphas))

    def on_device(self, dtype, device) -> torch.Tensor:
        """[S, 4] rows of (alpha, alpha_prev, sigma, sqrt(1 - alpha)) in dtype."""
        rows = np.stack([self.alphas, self.alphas_prev, self.sigmas,
                         self.sqrt_one_minus_alphas], axis=1)
        return torch.as_tensor(rows, dtype=torch.float32).to(device=device, dtype=dtype)


def _ddim_update(x, eps, row, generator=None, temperature: float = 1.0,
                 noise_dropout: float = 0.0, noise_unit=None, add_noise: bool = True):
    """One x_t -> x_{t-1} DDIM update (ref ddim.py:158-171), in x.dtype.
    ``row`` holds (alpha, alpha_prev, sigma, sqrt(1 - alpha)) in x.dtype;
    ``noise_unit`` replaces the generator's standard-normal draw. With
    ``add_noise`` False (every sigma is 0: eta = 0) the noise term, which
    is then exactly 0, is skipped. Returns x_{t-1}."""
    a_t, a_prev, sigma, som = row[0], row[1], row[2], row[3]
    pred_x0 = (x - som * eps) / torch.sqrt(a_t)
    dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma ** 2, min=0.0)) * eps
    x_prev = torch.sqrt(a_prev) * pred_x0 + dir_xt
    if add_noise:
        unit = noise_unit.to(x.dtype) if noise_unit is not None else torch.randn(
            x.shape, generator=generator, device=x.device, dtype=x.dtype)
        noise = sigma * unit * temperature
        if noise_dropout > 0.0:
            keep = torch.rand(x.shape, generator=generator, device=x.device) >= noise_dropout
            noise = torch.where(keep, noise / (1.0 - noise_dropout), torch.zeros_like(noise))
        x_prev = x_prev + noise
    return x_prev


def cfg_eps_fn(apply_model: Callable, cond, uncond, scale: float) -> Callable:
    """Classifier-free-guided eps: one 2x-batched call on [uncond, cond]."""
    if scale == 1.0 or uncond is None:
        return lambda x, t: apply_model(x, t, cond)
    c_in = torch.cat([uncond, cond], dim=0)

    def eps(x, t):
        e = apply_model(torch.cat([x, x], dim=0), torch.cat([t, t], dim=0), c_in)
        e_u, e_c = e.chunk(2, dim=0)
        return e_u + scale * (e_c - e_u)

    return eps


def cfg_eps_fn_multicontext(apply_multi: Callable, conds, unconds, scale: float) -> Callable:
    """Multi-context CFG (ref ddim.py:244-277): one 2x-batched call, each
    context as [uncond_i, cond_i], under the one guidance scale."""
    if scale == 1.0:
        return lambda x, t: apply_multi(x, t, conds)
    c_in = [torch.cat([u, c], dim=0) for u, c in zip(unconds, conds)]

    def eps(x, t):
        e = apply_multi(torch.cat([x, x], dim=0), torch.cat([t, t], dim=0), c_in)
        e_u, e_c = e.chunk(2, dim=0)
        return e_u + scale * (e_c - e_u)

    return eps


def ddim_loop(eps_fn: Callable, x, tables: DDIMTables, generator=None,
              temperature: float = 1.0, noise_dropout: float = 0.0, noise_table=None):
    """The reversed-timestep loop over x in the model's layout.
    noise_table: [S, *x.shape] unit normals, one row per step."""
    rows = tables.on_device(x.dtype, x.device)
    ts = torch.as_tensor(tables.timesteps, dtype=torch.long).to(x.device)
    has_noise = bool((tables.sigmas != 0).any())
    for i in range(len(tables.timesteps)):
        t = ts[i].expand(x.shape[0])
        eps = eps_fn(x, t)
        unit = None if noise_table is None else noise_table[i]
        x = _ddim_update(x, eps, rows[i], generator, temperature, noise_dropout, unit,
                         add_noise=has_noise or unit is not None)
    return x


class DDIMSampler:
    """Sampler bound to a ``VDModel`` (the JAX ``DDIMSampler.sample`` and
    ``sample_multicontext`` API)."""

    def __init__(self, model):
        self.model = model

    def x0_init(self, generator, shape, x_info, tables: DDIMTables, dtype, device):
        """img2img start (``vdtpu/sampling/ddim.py::_x_init``): x0 [n, h, w, c]
        q-sampled at the k-th ascending timestep, k = x0_forward_timesteps,
        with ``x_info["noise"]`` or the generator's normals; returns (x_t
        NHWC, the tables cut to their k lowest rows)."""
        k = int(x_info["x0_forward_timesteps"])
        t0 = int(tables.timesteps[::-1][k])
        x0 = torch.as_tensor(x_info["x0"]).to(device=device, dtype=dtype)
        if x_info.get("noise") is not None:
            noise = torch.as_tensor(x_info["noise"]).to(device=device, dtype=dtype)
        else:
            noise = torch.randn(tuple(shape), generator=generator, device=device, dtype=dtype)
        t = torch.full((x0.shape[0],), t0, dtype=torch.long, device=device)
        return self.model.schedule.q_sample(x0, t, noise).to(dtype), tables.tail(k)

    def _run(self, eps, generator, steps: int, shape, x_info, eta: float, temperature: float,
             noise_dropout: float, dtype, noise_table, device):
        """The start and the loop of both samplers: x_T as ``x_info['xt']``,
        x0 noised (``x0_init``) or the generator's normals; then the DDIM
        loop over ``eps`` in the model's layout (NCHW for images), the
        result back in the caller's (NHWC)."""
        tables = DDIMTables.create(self.model.schedule, steps, eta)
        if x_info.get("xt") is not None:
            x = torch.as_tensor(x_info["xt"]).to(device=device, dtype=dtype)
        elif x_info.get("x0") is not None:
            x, tables = self.x0_init(generator, shape, x_info, tables, dtype, device)
        else:
            x = torch.randn(tuple(shape), generator=generator, device=device, dtype=dtype)
        image = x.dim() == 4
        if image:
            x = x.permute(0, 3, 1, 2).contiguous()
        if noise_table is not None:
            noise_table = torch.as_tensor(noise_table).to(device=device, dtype=dtype)
            if image:
                noise_table = noise_table.permute(0, 1, 4, 2, 3)
        x = ddim_loop(eps, x, tables, generator, temperature, noise_dropout, noise_table)
        return x.permute(0, 2, 3, 1) if image else x

    def sample(self, generator, steps: int, shape, x_info, c_info, eta: float = 0.0,
               temperature: float = 1.0, noise_dropout: float = 0.0, dtype=torch.float32,
               noise_table=None, device=None):
        """Single-context sampling with CFG. ``shape``, ``x_info['xt']`` and
        ``x_info['x0']`` are NHWC ([n, h, w, c]) for a 2-D diffuser and [n, F]
        for a 0-D one (the text latent); the result has the same layout.
        ``noise_table`` is [S, *shape] (the JAX package's layout), one row
        per step that runs."""
        x_type, c_type = x_info["type"], c_info["type"]
        scale = float(c_info.get("unconditional_guidance_scale", 1.0))
        cond = torch.as_tensor(c_info["conditioning"]).to(device=device, dtype=dtype)
        uncond = c_info.get("unconditional_conditioning")
        if uncond is not None:
            uncond = torch.as_tensor(uncond).to(device=cond.device, dtype=dtype)
        apply = lambda xx, tt, cc: self.model.apply_model(xx, tt, cc, x_type, c_type)
        return self._run(cfg_eps_fn(apply, cond, uncond, scale), generator, steps, shape,
                         x_info, eta, temperature, noise_dropout, dtype, noise_table,
                         cond.device)

    def sample_multicontext(self, generator, steps: int, shape, x_info, c_info_list,
                            eta: float = 0.0, temperature: float = 1.0,
                            noise_dropout: float = 0.0, mixing_type: str = "attention",
                            layer_choices=None, dtype=torch.float32, noise_table=None,
                            device=None):
        """Multi-context sampling (ref ddim.py:173-242): ``c_info_list`` holds
        one c_info per context (its ``type``, ``conditioning``,
        ``unconditional_conditioning`` (None: zeros), ``ratio`` (default 1)
        and guidance scale, which must be one for all). ``mixing_type`` and
        ``layer_choices`` as in ``MultiDiffuser.apply_flow_multicontext``;
        everything else as in ``sample``."""
        scales = {float(ci.get("unconditional_guidance_scale", 1.0)) for ci in c_info_list}
        if len(scales) != 1:
            raise ValueError("all contexts must share one guidance scale (ref ddim.py:256-261)")
        if mixing_type == "layer" and layer_choices is None:
            raise ValueError("mixing_type='layer' requires layer_choices")
        choices = None if layer_choices is None else torch.as_tensor(layer_choices).tolist()
        x_type = x_info["type"]
        c_types = [ci["type"] for ci in c_info_list]
        ratios = [float(ci.get("ratio", 1.0)) for ci in c_info_list]
        conds = [torch.as_tensor(ci["conditioning"]).to(device=device, dtype=dtype)
                 for ci in c_info_list]
        unconds = [torch.zeros_like(c) if ci.get("unconditional_conditioning") is None
                   else torch.as_tensor(ci["unconditional_conditioning"]).to(c)
                   for c, ci in zip(conds, c_info_list)]
        apply = lambda xx, tt, cc: self.model.apply_model_multicontext(
            xx, tt, cc, ratios, x_type, c_types, mixing_type, choices)
        return self._run(cfg_eps_fn_multicontext(apply, conds, unconds, scales.pop()),
                         generator, steps, shape, x_info, eta, temperature, noise_dropout,
                         dtype, noise_table, conds[0].device)
