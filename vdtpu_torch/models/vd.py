"""Versatile-Diffusion orchestrator (``vdtpu/models/vd.py``): the named
diffusers, the flow walk, the schedule and the latent scaling.

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
from typing import Any, Mapping

from torch import nn

from vdtpu_torch.config.registry import build
from vdtpu_torch.ops.schedules import DiffusionSchedule
from vdtpu_torch.ops.tome import ToMeSpec


class MultiDiffuser(nn.ModuleDict):
    """name -> diffuser; the flows walk across them."""

    def __init__(self, diffuser_cfgs, global_layer_ptr: str | None = None):
        super().__init__({name: build(cfg) for name, cfg in diffuser_cfgs})
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
    """The diffusers + schedule + latent scaling of one VD config."""
    diffuser: MultiDiffuser
    schedule: DiffusionSchedule
    latent_scale_factor: Mapping[str, float]

    @classmethod
    def from_config(cls, cfg: Mapping[str, Any]) -> "VDModel":
        """Builds the diffusers on the current default device, in f32."""
        args = cfg["args"]
        if args.get("parameterization", "eps") != "eps":
            raise NotImplementedError("the port samples eps-parameterized models only")
        diffuser = MultiDiffuser([(n, c) for n, c in args["diffuser_cfg_list"]],
                                 global_layer_ptr=args.get("global_layer_ptr"))
        schedule = DiffusionSchedule.create(
            timesteps=args.get("timesteps", 1000),
            beta_schedule=args.get("beta_schedule", "linear"),
            linear_start=args.get("beta_linear_start", 1e-4),
            linear_end=args.get("beta_linear_end", 2e-2))
        return cls(diffuser=diffuser, schedule=schedule,
                   latent_scale_factor=dict(args.get("latent_scale_factor") or {}))

    def apply_model(self, x, timesteps, context, x_type: str, c_type: str):
        """eps for x in the model's own layout (NCHW for images)."""
        return self.diffuser.apply_flow(x, timesteps, context, x_type, c_type)

    def scale_latent(self, z, which: str):
        s = self.latent_scale_factor.get(which)
        return z if s is None else z * s

    def unscale_latent(self, z, which: str):
        s = self.latent_scale_factor.get(which)
        return z if s is None else z / s
