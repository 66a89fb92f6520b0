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

``apply_flow_multicontext`` is the multi-context walk of the blend flows
(dcg, tcg, mcg): the data blocks of ``x_type``, and at every context slot
the context blocks of each context's diffuser, mixed by ratio
("attention") or one chosen per slot ("layer").

The ``*_encoder`` flows walk the input half only and return (h, skips);
the ``*_encreuse`` flows take that cache and a ``use_cache`` flag, run the
input half where the flag is off and the mid and output walk always, and
return (eps, cache): the JAX package's encoder-reuse serving mode.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Mapping, Sequence

import torch
from torch import nn

from vdtpu_torch.config.registry import build
from vdtpu_torch.ops.schedules import DiffusionSchedule, extract
from vdtpu_torch.ops.tome import ToMeSpec, ToMeWalk


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

    def _emb(self, timesteps, dtype, x_type: str):
        return self[self.global_layer_ptr or x_type].time_embedding(timesteps, dtype)

    def apply_flow(self, x, timesteps, context, x_type: str, c_type: str):
        """Data blocks from x_type, context blocks from c_type (vd.py:330-381)."""
        host = self[x_type]
        return host.walk(x, self._emb(timesteps, x.dtype, x_type), context, host,
                         self[c_type], tome=self.tome)

    def apply_flow_encoder(self, x, timesteps, context, x_type: str, c_type: str):
        """The input half of ``apply_flow``: (h, skip stack)."""
        host = self[x_type]
        return host.walk_encoder(x, self._emb(timesteps, x.dtype, x_type), context, host,
                                 self[c_type], tome=self.tome)

    def apply_flow_encreuse(self, x, timesteps, context, x_type: str, c_type: str, cache,
                            use_cache: bool):
        """``apply_flow`` under encoder reuse (Faster Diffusion, arXiv
        2312.09608): with ``use_cache`` the input half is skipped and the
        cached (h, skips) of the last key step drive the mid and output
        walk at the current timestep embedding; else the input half runs
        and its state becomes the cache. Returns (eps, cache)."""
        host, ctx_host = self[x_type], self[c_type]
        emb = self._emb(timesteps, x.dtype, x_type)
        if not use_cache:
            cache = host.walk_encoder(x, emb, context, host, ctx_host, tome=self.tome)
        elif cache is None:
            raise ValueError("encoder reuse needs a key step before its first reuse")
        h, hs = cache
        return host.walk_decoder(h, hs, emb, context, host, ctx_host, tome=self.tome), cache

    def _mc_step(self, host, contexts, ratios, c_types, mixing_type: str, layer_choices):
        """context_step of one multi-context walk (its own ``ToMeWalk``)."""
        if len(contexts) != len(c_types) or (mixing_type == "attention"
                                             and len(ratios) != len(contexts)):
            raise ValueError("one c_type (and one ratio) per context")
        tome = self.tome and ToMeWalk(self.tome)

        def run(i, ci, h):
            return self[c_types[i]].run_context(ci, h, contexts[i], tokenizer=host, tome=tome)

        if mixing_type == "attention":
            r = torch.as_tensor(ratios, dtype=torch.float32)
            r = r / r.sum()

            def step(ci, h):
                mixed = None
                for i in range(len(contexts)):
                    hi = run(i, ci, h) * r[i].to(h.dtype)
                    mixed = hi if mixed is None else mixed + hi
                return mixed
        elif mixing_type == "layer":
            if layer_choices is None:
                raise ValueError("mixing_type='layer' requires layer_choices")
            choices = [int(c) for c in layer_choices]
            if len(choices) != len(host.program.ctx) or not all(
                    0 <= c < len(contexts) for c in choices):
                raise ValueError(f"layer_choices {choices}: one context index per slot")

            def step(ci, h):
                return run(choices[ci], ci, h)
        else:
            raise ValueError(f"unknown mixing_type {mixing_type!r}")
        return step

    def apply_flow_multicontext(self, x, timesteps, contexts, ratios, x_type: str,
                                c_types: Sequence[str], mixing_type: str = "attention",
                                layer_choices=None):
        """vd.py:404-455: data blocks from x_type; at context slot ci each
        context i runs the context blocks of ``c_types[i]``.

        "attention": every context's stack runs and the outputs are summed
        in context order, each times its ratio (normalized in f32, then cast
        to h's dtype). "layer": ``layer_choices[ci]`` (ints, one per slot;
        ``VDModel.sample_layer_choices`` draws them) picks the one context
        whose stack runs at slot ci. The JAX package runs every stack there
        and sums them times a one-hot; the port runs only the chosen one,
        which gives the same values (x * 1 + y * 0 = x for finite y). One
        ``ToMeWalk`` serves the whole walk, every stack included."""
        host = self[x_type]
        step = self._mc_step(host, contexts, ratios, c_types, mixing_type, layer_choices)
        return host.run_tokens(host.program.layer_order, x,
                               self._emb(timesteps, x.dtype, x_type), step)

    def apply_flow_multicontext_encoder(self, x, timesteps, contexts, ratios, x_type: str,
                                        c_types: Sequence[str],
                                        mixing_type: str = "attention", layer_choices=None):
        """The input half of the multi-context walk: (h, skip stack)."""
        host = self[x_type]
        step = self._mc_step(host, contexts, ratios, c_types, mixing_type, layer_choices)
        return host.run_tokens(host.program.i_order, x, self._emb(timesteps, x.dtype, x_type),
                               step, return_skips=True)

    def apply_flow_multicontext_encreuse(self, x, timesteps, contexts, ratios, x_type: str,
                                         c_types: Sequence[str], cache, use_cache: bool,
                                         mixing_type: str = "attention", layer_choices=None):
        """The multi-context walk under encoder reuse, mixing in both halves
        (each half its own ``ToMeWalk``); as ``apply_flow_encreuse``.
        Returns (eps, cache)."""
        host = self[x_type]
        emb = self._emb(timesteps, x.dtype, x_type)
        mix = (contexts, ratios, c_types, mixing_type, layer_choices)
        if not use_cache:
            cache = host.run_tokens(host.program.i_order, x, emb, self._mc_step(host, *mix),
                                    return_skips=True)
        elif cache is None:
            raise ValueError("encoder reuse needs a key step before its first reuse")
        h, hs = cache
        di, ci = host._encoder_counts()
        out = host.run_tokens(host.program.m_order + host.program.o_order, h, emb,
                              self._mc_step(host, *mix), hs=hs, di=di, ci=ci)
        return out, cache


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

    def apply_model_multicontext(self, x, timesteps, contexts, ratios, x_type: str,
                                 c_types: Sequence[str], mixing_type: str = "attention",
                                 layer_choices=None):
        """eps of the multi-context walk (``MultiDiffuser.apply_flow_multicontext``)."""
        return self.diffuser.apply_flow_multicontext(
            x, timesteps, contexts, ratios, x_type, c_types, mixing_type, layer_choices)

    def apply_model_encoder(self, x, timesteps, context, x_type: str, c_type: str):
        """(h, skips) of the input half (``MultiDiffuser.apply_flow_encoder``)."""
        return self.diffuser.apply_flow_encoder(x, timesteps, context, x_type, c_type)

    def apply_model_encreuse(self, x, timesteps, context, x_type: str, c_type: str, cache,
                             use_cache: bool):
        """(eps, cache) under encoder reuse (``MultiDiffuser.apply_flow_encreuse``)."""
        return self.diffuser.apply_flow_encreuse(x, timesteps, context, x_type, c_type, cache,
                                                 use_cache)

    def apply_model_multicontext_encoder(self, x, timesteps, contexts, ratios, x_type: str,
                                         c_types: Sequence[str],
                                         mixing_type: str = "attention", layer_choices=None):
        """(h, skips) of the multi-context walk's input half."""
        return self.diffuser.apply_flow_multicontext_encoder(
            x, timesteps, contexts, ratios, x_type, c_types, mixing_type, layer_choices)

    def apply_model_multicontext_encreuse(self, x, timesteps, contexts, ratios, x_type: str,
                                          c_types: Sequence[str], cache, use_cache: bool,
                                          mixing_type: str = "attention", layer_choices=None):
        """(eps, cache) of the multi-context walk under encoder reuse."""
        return self.diffuser.apply_flow_multicontext_encreuse(
            x, timesteps, contexts, ratios, x_type, c_types, cache, use_cache, mixing_type,
            layer_choices)

    def num_context_slots(self, x_type: str = "image") -> int:
        """Context-block slots of a diffuser's program."""
        return len(self.diffuser[x_type].program.ctx)

    def sample_layer_choices(self, generator, ratios, x_type: str = "image"):
        """One context index per slot, drawn from the normalized ratios with
        ``generator`` (the reference's npr.choice per slot): a long tensor
        [num_context_slots] on the generator's device, for mixing "layer"."""
        r = torch.as_tensor(ratios, dtype=torch.float32, device=generator.device)
        return torch.multinomial(r / r.sum(), self.num_context_slots(x_type),
                                 replacement=True, generator=generator)

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
