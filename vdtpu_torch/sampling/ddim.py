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
run. Both take the JAX package's opt-in sampler modes, with its rules for
combining them:

- ``method="dpmpp2m"``: DPM-Solver++(2M) over the same ladder
  (``sampling/dpmpp.py``); eta 0 only, no ``noise_table`` or
  intermediates.
- ``encoder_reuse``: an interval, or ``{"interval", "warmup"}``; on the
  steps ``encoder_reuse_schedule`` marks False only the UNet's mid and
  output walk runs, from the last key step's (h, skips) at the current
  timestep embedding (Faster Diffusion, arXiv 2312.09608). With either
  method; no ``noise_table``, intermediates or cfg interval.
- ``cfg_interval=(lo, hi)``: guidance only on the steps [round(lo S),
  round(hi S)) of the S that run; the others call the model on the
  conditional context alone, at half the batch. Three segments share the
  generator (the JAX package threads its key), so (0, 1) is plain CFG bit
  for bit. Needs active guidance; with either method.
- ``return_intermediates``: the per-step ``pred_xt`` / ``pred_x0`` stacks
  of plain DDIM.

At eta 0 the loop draws nothing, where the JAX package splits its key
every step: the draws of the two packages differ in any case, and parity
runs hand both the same x_T and ``noise_table``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, NamedTuple

import numpy as np
import torch

from vdtpu_torch.ops.schedules import (
    DiffusionSchedule, make_ddim_sampling_parameters, make_ddim_timesteps)
from vdtpu_torch.sampling.dpmpp import DPMppTables, dpmpp_loop, dpmpp_loop_encreuse
from vdtpu_torch.sampling.dpmpp import slice_tables as dpmpp_slice_tables


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
        return slice_tables(self, len(self.timesteps) - k, len(self.timesteps))

    def on_device(self, dtype, device) -> torch.Tensor:
        """[S, 4] rows of (alpha, alpha_prev, sigma, sqrt(1 - alpha)) in dtype."""
        rows = np.stack([self.alphas, self.alphas_prev, self.sigmas,
                         self.sqrt_one_minus_alphas], axis=1).reshape(-1, 4)
        return torch.as_tensor(rows, dtype=torch.float32).to(device=device, dtype=dtype)


def slice_tables(tables: DDIMTables, a: int, b: int) -> DDIMTables:
    """Rows [a, b) of the descending tables."""
    return dataclasses.replace(tables, **{f.name: getattr(tables, f.name)[a:b]
                                          for f in dataclasses.fields(tables)})


def encoder_reuse_schedule(steps: int, interval: int = 2, warmup: int = 5) -> np.ndarray:
    """Key-step mask of encoder reuse (True: the encoder runs): the first
    ``warmup`` steps, then every ``interval``-th. Interval 1 is the exact
    path."""
    mask = np.zeros((steps,), bool)
    mask[:warmup] = True
    mask[warmup::interval] = True
    return mask


def _ddim_update(x, eps, row, generator=None, temperature: float = 1.0,
                 noise_dropout: float = 0.0, noise_unit=None, add_noise: bool = True):
    """One x_t -> x_{t-1} DDIM update (ref ddim.py:158-171), in x.dtype.
    ``row`` holds (alpha, alpha_prev, sigma, sqrt(1 - alpha)) in x.dtype;
    ``noise_unit`` replaces the generator's standard-normal draw. With
    ``add_noise`` False (every sigma is 0: eta = 0) the noise term, which
    is then exactly 0, is skipped. Returns (x_{t-1}, pred_x0)."""
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
    return x_prev, pred_x0


def _doubled(x, t):
    return torch.cat([x, x], dim=0), torch.cat([t, t], dim=0)


def _guided(e, scale: float):
    """e_u + scale (e_c - e_u) of a [uncond, cond] batch."""
    e_u, e_c = e.chunk(2, dim=0)
    return e_u + scale * (e_c - e_u)


def cfg_eps_fn(apply_model: Callable, cond, uncond, scale: float) -> Callable:
    """Classifier-free-guided eps: one 2x-batched call on [uncond, cond]."""
    if scale == 1.0 or uncond is None:
        return lambda x, t: apply_model(x, t, cond)
    c_in = torch.cat([uncond, cond], dim=0)
    return lambda x, t: _guided(apply_model(*_doubled(x, t), c_in), scale)


def cfg_eps_fn_stateful(apply_model: Callable, cond, uncond, scale: float) -> Callable:
    """``cfg_eps_fn`` for encoder reuse: apply_model(x, t, c, use_cache,
    cache) -> (eps, cache); returns eps(x, t, use_cache, cache) -> (eps,
    cache), the cache of the whole 2x batch."""
    if scale == 1.0 or uncond is None:
        return lambda x, t, use_cache, cache: apply_model(x, t, cond, use_cache, cache)
    c_in = torch.cat([uncond, cond], dim=0)

    def eps(x, t, use_cache, cache):
        e, cache = apply_model(*_doubled(x, t), c_in, use_cache, cache)
        return _guided(e, scale), cache

    return eps


def cfg_eps_fn_multicontext(apply_multi: Callable, conds, unconds, scale: float) -> Callable:
    """Multi-context CFG (ref ddim.py:244-277): one 2x-batched call, each
    context as [uncond_i, cond_i], under the one guidance scale."""
    if scale == 1.0:
        return lambda x, t: apply_multi(x, t, conds)
    c_in = [torch.cat([u, c], dim=0) for u, c in zip(unconds, conds)]
    return lambda x, t: _guided(apply_multi(*_doubled(x, t), c_in), scale)


def cfg_eps_fn_multicontext_stateful(apply_multi: Callable, conds, unconds,
                                     scale: float) -> Callable:
    """``cfg_eps_fn_multicontext`` for encoder reuse: apply_multi(x, t, ctxs,
    use_cache, cache) -> (eps, cache)."""
    if scale == 1.0:
        return lambda x, t, use_cache, cache: apply_multi(x, t, conds, use_cache, cache)
    c_in = [torch.cat([u, c], dim=0) for u, c in zip(unconds, conds)]

    def eps(x, t, use_cache, cache):
        e, cache = apply_multi(*_doubled(x, t), c_in, use_cache, cache)
        return _guided(e, scale), cache

    return eps


def _rows(tables: DDIMTables, x):
    return (tables.on_device(x.dtype, x.device),
            torch.as_tensor(tables.timesteps, dtype=torch.long).to(x.device))


def ddim_loop(eps_fn: Callable, x, tables: DDIMTables, generator=None,
              temperature: float = 1.0, noise_dropout: float = 0.0, noise_table=None,
              return_intermediates: bool = False):
    """The reversed-timestep loop over x in the model's layout.
    noise_table: [S, *x.shape] unit normals, one row per step. With
    ``return_intermediates``: (x, {"pred_xt": [S, *x.shape], "pred_x0": ...})."""
    rows, ts = _rows(tables, x)
    add_noise = bool((tables.sigmas != 0).any())
    xts, x0s = [], []
    for i in range(len(tables.timesteps)):
        eps = eps_fn(x, ts[i].expand(x.shape[0]))
        unit = None if noise_table is None else noise_table[i]
        x, pred_x0 = _ddim_update(x, eps, rows[i], generator, temperature, noise_dropout,
                                  unit, add_noise=add_noise or unit is not None)
        if return_intermediates:
            xts.append(x)
            x0s.append(pred_x0)
    if return_intermediates:
        stack = lambda v: torch.stack(v) if v else x.new_zeros((0, *x.shape))
        return x, {"pred_xt": stack(xts), "pred_x0": stack(x0s)}
    return x


def ddim_loop_encreuse(eps_fn: Callable, x, tables: DDIMTables, key_mask, generator=None,
                       temperature: float = 1.0, noise_dropout: float = 0.0):
    """``ddim_loop`` with the encoder-reuse cache carried from step to step:
    eps_fn(x, t[B], use_cache, cache) -> (eps, cache), the cache reused on
    the steps where ``key_mask`` is False (the first step is a key step)."""
    rows, ts = _rows(tables, x)
    add_noise = bool((tables.sigmas != 0).any())
    cache = None
    for i in range(len(tables.timesteps)):
        eps, cache = eps_fn(x, ts[i].expand(x.shape[0]), not bool(key_mask[i]), cache)
        x, _ = _ddim_update(x, eps, rows[i], generator, temperature, noise_dropout,
                            add_noise=add_noise)
    return x


class _EpsFns(NamedTuple):
    """The model calls one request may need: guided, conditional only (the
    steps outside the cfg interval) and guided with encoder reuse."""
    guided: Callable
    cond_only: Callable
    stateful: Callable


def _modes(method: str, eta: float, has_noise_table: bool, return_intermediates: bool,
           encoder_reuse, cfg_interval, cfg_on: bool):
    """The JAX package's checks of the sampler modes; returns (the encoder
    reuse spec or None, the cfg interval or None)."""
    enc = None
    if encoder_reuse:
        enc = dict(encoder_reuse) if isinstance(encoder_reuse, Mapping) \
            else {"interval": int(encoder_reuse)}
        if has_noise_table or return_intermediates:
            raise ValueError("encoder_reuse is incompatible with noise_table / "
                             "return_intermediates")
    if method not in ("ddim", "dpmpp2m"):
        raise ValueError(f"unknown sampling method {method!r}")
    if method == "dpmpp2m" and (float(eta) != 0.0 or has_noise_table or return_intermediates):
        raise ValueError("dpmpp2m is deterministic: requires eta=0 and is exclusive with "
                         "noise_table / return_intermediates")
    itv = None
    if cfg_interval is not None:
        itv = (float(cfg_interval[0]), float(cfg_interval[1]))
        if not 0.0 <= itv[0] <= itv[1] <= 1.0:
            raise ValueError("cfg_interval must satisfy 0 <= lo <= hi <= 1")
        if not cfg_on:
            raise ValueError("cfg_interval requires active CFG (scale != 1 with an "
                             "unconditional context)")
        if enc is not None or has_noise_table or return_intermediates:
            raise ValueError("cfg_interval composes with ddim or dpmpp2m only (no "
                             "encoder_reuse / noise_table / return_intermediates)")
    return enc, itv


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

    def _run(self, fns: _EpsFns, generator, steps: int, shape, x_info, eta: float,
             temperature: float, noise_dropout: float, dtype, noise_table, device,
             method: str, enc, itv, return_intermediates: bool):
        """The start and the loop of both samplers: x_T as ``x_info['xt']``,
        x0 noised (``x0_init``) or the generator's normals; then the loop of
        ``method`` under the modes over the model's layout (NCHW for
        images), the result (and intermediates) back in the caller's."""
        tables = DDIMTables.create(self.model.schedule, steps, eta)
        truncate = None
        if x_info.get("xt") is not None:
            x = torch.as_tensor(x_info["xt"]).to(device=device, dtype=dtype)
        elif x_info.get("x0") is not None:
            x, tables = self.x0_init(generator, shape, x_info, tables, dtype, device)
            truncate = int(x_info["x0_forward_timesteps"])
        else:
            x = torch.randn(tuple(shape), generator=generator, device=device, dtype=dtype)
        image = x.dim() == 4
        if image:
            x = x.permute(0, 3, 1, 2).contiguous()
        if noise_table is not None:
            noise_table = torch.as_tensor(noise_table).to(device=device, dtype=dtype)
            if image:
                noise_table = noise_table.permute(0, 1, 4, 2, 3)
        loop_kw = dict(generator=generator, temperature=temperature,
                       noise_dropout=noise_dropout)
        inter = None
        if method == "dpmpp2m":
            dtables = DPMppTables.create(self.model.schedule, steps, truncate=truncate)
        if enc is not None:
            mask = encoder_reuse_schedule(len(tables.timesteps), **enc)
            x = (dpmpp_loop_encreuse(fns.stateful, x, dtables, mask) if method == "dpmpp2m"
                 else ddim_loop_encreuse(fns.stateful, x, tables, mask, **loop_kw))
        elif itv is not None:
            s = len(tables.timesteps)
            a, b = int(round(itv[0] * s)), int(round(itv[1] * s))
            m = None
            for lo, hi, fn in ((0, a, fns.cond_only), (a, b, fns.guided),
                               (b, s, fns.cond_only)):
                if hi <= lo:
                    continue
                if method == "dpmpp2m":
                    x, m = dpmpp_loop(fn, x, dpmpp_slice_tables(dtables, lo, hi), m_prev=m,
                                      return_carry=True)
                else:
                    x = ddim_loop(fn, x, slice_tables(tables, lo, hi), **loop_kw)
        elif method == "dpmpp2m":
            x = dpmpp_loop(fns.guided, x, dtables)
        elif return_intermediates:
            x, inter = ddim_loop(fns.guided, x, tables, noise_table=noise_table,
                                 return_intermediates=True, **loop_kw)
        else:
            x = ddim_loop(fns.guided, x, tables, noise_table=noise_table, **loop_kw)
        if image:
            x = x.permute(0, 2, 3, 1)
            if inter is not None:
                inter = {k: v.permute(0, 1, 3, 4, 2) for k, v in inter.items()}
        return x if inter is None else (x, inter)

    def sample(self, generator, steps: int, shape, x_info, c_info, eta: float = 0.0,
               temperature: float = 1.0, noise_dropout: float = 0.0, dtype=torch.float32,
               noise_table=None, device=None, method: str = "ddim", encoder_reuse=None,
               cfg_interval=None, return_intermediates: bool = False):
        """Single-context sampling with CFG. ``shape``, ``x_info['xt']`` and
        ``x_info['x0']`` are NHWC ([n, h, w, c]) for a 2-D diffuser and [n, F]
        for a 0-D one (the text latent); the result has the same layout.
        ``noise_table`` is [S, *shape] (the JAX package's layout), one row
        per step that runs. ``method``, ``encoder_reuse``, ``cfg_interval``
        and ``return_intermediates`` as in the module docstring; with
        intermediates the result is (x, {"pred_xt", "pred_x0"}), [S, *shape]
        each."""
        x_type, c_type = x_info["type"], c_info["type"]
        scale = float(c_info.get("unconditional_guidance_scale", 1.0))
        uncond = c_info.get("unconditional_conditioning")
        enc, itv = _modes(method, eta, noise_table is not None, return_intermediates,
                          encoder_reuse, cfg_interval, not (scale == 1.0 or uncond is None))
        cond = torch.as_tensor(c_info["conditioning"]).to(device=device, dtype=dtype)
        if uncond is not None:
            uncond = torch.as_tensor(uncond).to(device=cond.device, dtype=dtype)
        apply = lambda xx, tt, cc: self.model.apply_model(xx, tt, cc, x_type, c_type)
        fns = _EpsFns(
            cfg_eps_fn(apply, cond, uncond, scale), cfg_eps_fn(apply, cond, None, 1.0),
            cfg_eps_fn_stateful(
                lambda xx, tt, cc, use_cache, cache: self.model.apply_model_encreuse(
                    xx, tt, cc, x_type, c_type, cache, use_cache), cond, uncond, scale))
        return self._run(fns, generator, steps, shape, x_info, eta, temperature,
                         noise_dropout, dtype, noise_table, cond.device, method, enc, itv,
                         return_intermediates)

    def sample_multicontext(self, generator, steps: int, shape, x_info, c_info_list,
                            eta: float = 0.0, temperature: float = 1.0,
                            noise_dropout: float = 0.0, mixing_type: str = "attention",
                            layer_choices=None, dtype=torch.float32, noise_table=None,
                            device=None, method: str = "ddim", encoder_reuse=None,
                            cfg_interval=None, return_intermediates: bool = False):
        """Multi-context sampling (ref ddim.py:173-242): ``c_info_list`` holds
        one c_info per context (its ``type``, ``conditioning``,
        ``unconditional_conditioning`` (None: zeros), ``ratio`` (default 1)
        and guidance scale, which must be one for all). ``mixing_type`` and
        ``layer_choices`` as in ``MultiDiffuser.apply_flow_multicontext``;
        everything else as in ``sample`` (guidance is active whenever the
        scale is not 1)."""
        scales = {float(ci.get("unconditional_guidance_scale", 1.0)) for ci in c_info_list}
        if len(scales) != 1:
            raise ValueError("all contexts must share one guidance scale (ref ddim.py:256-261)")
        scale = scales.pop()
        enc, itv = _modes(method, eta, noise_table is not None, return_intermediates,
                          encoder_reuse, cfg_interval, scale != 1.0)
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
        fns = _EpsFns(
            cfg_eps_fn_multicontext(apply, conds, unconds, scale),
            cfg_eps_fn_multicontext(apply, conds, unconds, 1.0),
            cfg_eps_fn_multicontext_stateful(
                lambda xx, tt, cc, use_cache, cache:
                    self.model.apply_model_multicontext_encreuse(
                        xx, tt, cc, ratios, x_type, c_types, cache, use_cache, mixing_type,
                        choices), conds, unconds, scale))
        return self._run(fns, generator, steps, shape, x_info, eta, temperature,
                         noise_dropout, dtype, noise_table, conds[0].device, method, enc,
                         itv, return_intermediates)
