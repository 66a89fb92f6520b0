"""Versatile-Diffusion orchestrator (``vdtpu/models/vd.py``): the named
diffusers, the flow walk, the schedule, the latent scaling and the
training loss (``q_sample``, ``get_loss``, ``p_losses``, the learnable
``logvar`` under ``learn_logvar``).

``MultiDiffuser`` registers each diffuser under its name, so its state-dict
keys are ``<name>.…`` and, under ``VDSystem``, ``diffuser.<name>.…`` as
in the reference checkpoint. ``apply_flow`` takes its data blocks and time
embedding from the ``x_type`` diffuser (or ``global_layer_ptr``) and its
context blocks from the ``c_type`` diffuser. ``MultiDiffuser.tome`` is the
serving system's token-merging spec (``VDSystem.enable_tome``; None: off),
handed to every walk.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Mapping

import torch
from torch import nn

from vdtpu_torch.config.registry import build
from vdtpu_torch.ops.schedules import DiffusionSchedule, extract
from vdtpu_torch.ops.tome import ToMeSpec


class MultiDiffuser(nn.ModuleDict):
    """name -> diffuser; the flows walk across them. ``use_checkpoint``
    (None: each diffuser's config flag) and ``remat_max_channels`` override
    every diffuser's remat settings, as in the JAX package."""

    def __init__(self, diffuser_cfgs, global_layer_ptr: str | None = None,
                 use_checkpoint: bool | None = None, remat_max_channels: int | None = None):
        over = {} if use_checkpoint is None else {"use_checkpoint": use_checkpoint}
        if remat_max_channels is not None:
            over["remat_max_channels"] = remat_max_channels
        super().__init__({name: build(cfg, **over) for name, cfg in diffuser_cfgs})
        self.global_layer_ptr = global_layer_ptr
        self.tome: ToMeSpec | None = None
        orders = [u.program.layer_order for u in self.values()]
        if any(o != orders[0] for o in orders[1:]):
            raise ValueError("diffuser layer programs are not aligned")

    def apply_flow(self, x, timesteps, context, x_type: str, c_type: str):
        """Data blocks from x_type, context blocks from c_type (vd.py:330-381)."""
        emb = self[self.global_layer_ptr or x_type].time_embedding(timesteps, x.dtype)
        host = self[x_type]
        return host.walk(x, emb, context, host, self[c_type], tome=self.tome)


@dataclasses.dataclass
class VDModel:
    """The diffusers + schedule + latent scaling + loss of one VD config.

    ``dtype`` is the compute dtype of ``p_losses``: below f32 the UNet runs
    under ``torch.autocast`` with the parameters kept in f32, as the JAX
    package's ``VDModel(dtype=bf16)`` keeps flax's f32 params. Serving casts
    the modules instead and does not read it."""
    diffuser: MultiDiffuser
    schedule: DiffusionSchedule
    latent_scale_factor: Mapping[str, float]
    loss_type: str = "l2"
    l_simple_weight: float = 1.0
    l_elbo_weight: float = 0.0
    learn_logvar: bool = False
    logvar_init: float = 0.0
    dtype: torch.dtype = torch.float32
    logvar: nn.Parameter | None = None

    @classmethod
    def from_config(cls, cfg: Mapping[str, Any], use_checkpoint: bool | None = None,
                    remat_max_channels: int | None = None) -> "VDModel":
        """Builds the diffusers (and ``logvar``) on the current default
        device, in f32. ``use_checkpoint`` / ``remat_max_channels`` as in
        ``MultiDiffuser``: pass False for serving-only systems or to train
        without remat."""
        args = cfg["args"]
        if args.get("parameterization", "eps") != "eps":
            raise NotImplementedError("the port runs eps-parameterized models only")
        diffuser = MultiDiffuser([(n, c) for n, c in args["diffuser_cfg_list"]],
                                 global_layer_ptr=args.get("global_layer_ptr"),
                                 use_checkpoint=use_checkpoint,
                                 remat_max_channels=remat_max_channels)
        schedule = DiffusionSchedule.create(
            timesteps=args.get("timesteps", 1000),
            beta_schedule=args.get("beta_schedule", "linear"),
            linear_start=args.get("beta_linear_start", 1e-4),
            linear_end=args.get("beta_linear_end", 2e-2),
            v_posterior=args.get("v_posterior", 0.0))
        learn_logvar = args.get("learn_logvar", False)
        logvar_init = args.get("logvar_init", 0.0)
        # the reference's nn.Parameter of size [num_timesteps] (ref vd.py:101-103)
        logvar = (nn.Parameter(torch.full((schedule.num_timesteps,), float(logvar_init)))
                  if learn_logvar else None)
        return cls(diffuser=diffuser, schedule=schedule,
                   latent_scale_factor=dict(args.get("latent_scale_factor") or {}),
                   loss_type=args.get("loss_type", "l2"),
                   l_simple_weight=args.get("l_simple_weight", 1.0),
                   l_elbo_weight=args.get("l_elbo_weight", 0.0),
                   learn_logvar=learn_logvar, logvar_init=logvar_init, logvar=logvar)

    def named_parameters(self) -> Iterator[tuple[str, nn.Parameter]]:
        """The JAX package's param tree, flat: ``<diffuser>.<module path>``
        for every diffuser parameter, then ``logvar`` when it is learned."""
        yield from self.diffuser.named_parameters()
        if self.logvar is not None:
            yield "logvar", self.logvar

    def apply_model(self, x, timesteps, context, x_type: str, c_type: str):
        """eps for x in the model's own layout (NCHW for images)."""
        return self.diffuser.apply_flow(x, timesteps, context, x_type, c_type)

    def scale_latent(self, z, which: str):
        s = self.latent_scale_factor.get(which)
        return z if s is None else z * s

    def unscale_latent(self, z, which: str):
        s = self.latent_scale_factor.get(which)
        return z if s is None else z / s

    # ---- training ----

    def q_sample(self, x_start, t, noise):
        return self.schedule.q_sample(x_start, t, noise)

    def get_loss(self, pred, target):
        if self.loss_type == "l1":
            return (target - pred).abs()
        if self.loss_type == "l2":
            return (target - pred) ** 2
        raise NotImplementedError(self.loss_type)

    def p_losses(self, x, t, context, x_type: str, c_type: str, noise):
        """The eps-parameterized diffusion loss (ref vd.py:246-280), (loss, aux):

        loss = l_simple_weight * mean(loss_simple / exp(logvar_t) + logvar_t)
             + l_elbo_weight * mean(lvlb_weights[t] * loss_simple)

        logvar_t is ``logvar[t]`` under learn_logvar, else ``logvar_init``.
        The UNet runs in ``dtype`` (autocast); the loss is f32."""
        x_noisy = self.q_sample(x, t, noise)
        with torch.autocast(x.device.type, dtype=self.dtype,
                            enabled=self.dtype != torch.float32):
            model_out = self.apply_model(x_noisy, t, context, x_type, c_type)
        bsz = model_out.shape[0]
        per_ex = self.get_loss(model_out.float(), noise.float()).reshape(bsz, -1).mean(-1)
        loss_simple = per_ex.mean()
        if self.learn_logvar:
            logvar_t = self.logvar[t]
        else:
            logvar_t = torch.full_like(per_ex, self.logvar_init)
        gamma = per_ex / torch.exp(logvar_t) + logvar_t
        lvlb = (extract(self.schedule.lvlb_weights, t, 1) * per_ex).mean()
        loss = self.l_simple_weight * gamma.mean() + self.l_elbo_weight * lvlb
        aux = {"loss_simple": loss_simple, "loss_vlb": lvlb, "Loss": loss}
        if self.learn_logvar:
            aux["loss_gamma"] = gamma.mean()
            aux["logvar"] = self.logvar.mean()
        return loss, aux
