"""Serving API (``vdtpu/serving/api.py``): ``VDSystem`` builds and owns the
modules of a VD config, ``VDInference`` runs the flows. This slice serves
text-to-image.

``VDSystem`` builds ``diffuser.*`` (every diffuser of the config, so every
``diffuser.*`` key of a checkpoint loads), ``ctx.text`` and the
``vae.image`` decoder; its ``net`` module carries the reference's state-dict
keys. It runs on CUDA unless the caller passes ``device="cpu"``, and raises
when CUDA is absent and the CPU was not asked for.

Serving policy: ``enable_int8`` attaches a ``QuantPolicy`` to the
diffusers' call sites and calibrates them (``ops/quant.py``);
``enable_tome`` switches token merging on (``ops/tome.py``). Both are
state of the system, not of the process.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from vdtpu_torch.config.configs import model_cfg_bank
from vdtpu_torch.config.registry import build
from vdtpu_torch.interop.from_jax import system_state_dict_from_jax
from vdtpu_torch.models.layers import init_random
from vdtpu_torch.models.vd import VDModel
from vdtpu_torch.ops.quant import (
    QuantPolicy, calibrate, load_quant_state, quant_state, set_quant_policy)
from vdtpu_torch.ops.tome import ToMeSpec
from vdtpu_torch.sampling.ddim import DDIMSampler


def resolve_device(device=None) -> torch.device:
    """CUDA unless the caller names a device; no silent CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the card; pass "
                               "device='cpu' to run its plain versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class _CtxHolder(nn.Module):
    """Keeps the reference's ``ctx.<name>.model.`` key prefix."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model


class VDSystem:
    """Every module and weight of one VD config (this slice's parts)."""

    # state-dict prefixes the port builds; load_state_dict ignores the rest
    PREFIXES = ("diffuser.", "ctx.text.model.", "vae.image.decoder.",
                "vae.image.post_quant_conv.")

    def __init__(self, cfg_name: str = "vd_four_flow_v1-0", dtype=torch.float32,
                 device=None):
        self.cfg = model_cfg_bank()(cfg_name)
        self.device = resolve_device(device)
        self.dtype = dtype
        args = self.cfg["args"]
        with torch.device(self.device):
            self.model = VDModel.from_config(self.cfg)
            self.net = nn.Module()
            self.net.diffuser = self.model.diffuser
            self.net.ctx = nn.ModuleDict({name: _CtxHolder(build(sub))
                                          for name, sub in args["ctx_cfg_list"]
                                          if name == "text"})
            self.net.vae = nn.ModuleDict({name: build(sub)
                                          for name, sub in args["vae_cfg_list"]
                                          if name == "image"})
        self.net.eval().requires_grad_(False)
        self.net.to(dtype)
        self.sampler = DDIMSampler(self.model)
        self.quant_policy: QuantPolicy | None = None

    @property
    def ctx(self) -> Mapping[str, nn.Module]:
        return {name: holder.model for name, holder in self.net.ctx.items()}

    @property
    def vae(self) -> Mapping[str, nn.Module]:
        return dict(self.net.vae.items())

    # ---- parameters ----

    def init_random(self, seed: int = 0) -> "VDSystem":
        """Seeded random weights from the port's own init (layers.init_random)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        init_random(self.net, gen)
        return self

    def cast(self, dtype) -> "VDSystem":
        self.net.to(dtype)
        self.dtype = dtype
        return self

    def load_state_dict(self, sd: Mapping[str, Any], strict: bool = True):
        """Load a reference-keyed state dict (torch tensors or numpy arrays)
        over the prefixes the port builds; strict within them."""
        own = {k: v if torch.is_tensor(v) else torch.tensor(np.asarray(v))
               for k, v in sd.items() if k.startswith(self.PREFIXES)}
        return self.net.load_state_dict(own, strict=strict)

    def load_jax_params(self, params: Mapping[str, Any], strict: bool = True):
        """Load a JAX ``VDSystem.params`` tree (numpy leaves)."""
        return self.load_state_dict(system_state_dict_from_jax(params), strict=strict)

    # ---- serving policy ----

    def set_quant_policy(self, policy: QuantPolicy | None) -> "VDSystem":
        """Attach ``policy`` to every diffuser call site (None: the exact
        compute-dtype path). Calibrated state stays, so a calibrated system
        can switch between policy modes."""
        set_quant_policy(self.model.diffuser, policy)
        self.quant_policy = policy
        return self

    @torch.no_grad()
    def enable_int8(self, image_size: int = 512, latent_downsample: int = 8, n: int = 2,
                    timesteps=(0, 250, 500, 750, 999), seed: int = 0,
                    flows=(("image", "text"),), policy: QuantPolicy = QuantPolicy()):
        """Calibrated int8 serving (``vdtpu/serving/api.py::enable_int8``):
        attach ``policy`` and record every site's activation scale and every
        attention's logit bound over (noise, t, context) probes spanning the
        timestep range, 2n samples each; the statistics merge by max across
        probes and flows. Probes come from a ``torch.Generator`` seeded with
        ``seed``, the context from this system's text encoder on random ids.
        A second call is a no-op."""
        if self.quant_policy is not None and quant_state(self.model.diffuser):
            return self
        for x_type, c_type in flows:
            if (x_type, c_type) != ("image", "text"):
                raise NotImplementedError(f"flow ({x_type}, {c_type}): its context encoder or "
                                          f"data diffuser is a later slice of the port")
        gen = torch.Generator(device=self.device).manual_seed(seed)
        enc = self.ctx["text"]
        vocab = enc.text_model.embeddings.token_embedding.num_embeddings
        ids = torch.randint(0, vocab, (2 * n, enc.max_len), generator=gen, device=self.device)
        ctx = self.ctx_encode(ids.cpu().numpy(), "text").to(self.dtype)
        in_ch = self.model.diffuser["image"].program.data[0].in_ch
        s = image_size // latent_downsample
        probes = [(torch.randn((2 * n, in_ch, s, s), generator=gen, device=self.device,
                               dtype=self.dtype),
                   torch.full((2 * n,), t, device=self.device), ctx, "image", "text")
                  for t in timesteps]
        return self.calibrate(probes, policy)

    def calibrate(self, probes, policy: QuantPolicy = QuantPolicy()) -> "VDSystem":
        """Calibrate on explicit probes: (x NCHW, t, context, x_type, c_type)."""
        self.set_quant_policy(policy)

        def run():
            for x, t, ctx, x_type, c_type in probes:
                self.model.apply_model(x, t, ctx, x_type, c_type)

        calibrate(self.model.diffuser, run)
        return self

    def load_int8(self, state: Mapping[str, Any],
                  policy: QuantPolicy = QuantPolicy()) -> "VDSystem":
        """int8 serving with given scales and tables (``quant_state`` keys,
        e.g. ``interop.from_jax.quant_state_from_jax``) instead of a
        calibration pass."""
        self.set_quant_policy(policy)
        load_quant_state(self.model.diffuser, state)
        return self

    def enable_tome(self, ratio: float = 0.5, min_tokens: int = 4096) -> "VDSystem":
        """Token merging at every self-attention site of at least
        ``min_tokens`` tokens (``vdtpu/serving/api.py::enable_tome``);
        ratio 0 switches it off. Composes with int8."""
        self.model.diffuser.tome = (ToMeSpec(float(ratio), int(min_tokens))
                                    if ratio else None)
        return self

    # ---- stages ----

    @torch.no_grad()
    def ctx_encode(self, x, which: str = "text"):
        if which != "text":
            raise NotImplementedError(f"{which!r} context encoding is a later slice")
        ids = torch.as_tensor(np.asarray(x), dtype=torch.long, device=self.device)
        return self.ctx["text"](ids)

    @torch.no_grad()
    def vae_decode(self, z, which: str = "image"):
        """NHWC latent (scaled) -> NHWC image in [0, 1]."""
        if which != "image":
            raise NotImplementedError(f"{which!r} decoding is a later slice")
        z = torch.as_tensor(z).to(device=self.device, dtype=self.dtype)
        z = self.model.unscale_latent(z, which).permute(0, 3, 1, 2)
        return self.vae["image"].decode(z.contiguous()).permute(0, 2, 3, 1)


class VDInference:
    """Flow-level API (``vdtpu.serving.api.VDInference``); text-to-image."""

    def __init__(self, system: VDSystem,
                 text_tokenizer: Callable[[Sequence[str]], np.ndarray] | None = None,
                 output_dim=(512, 512), ddim_steps: int = 50, ddim_eta: float = 0.0,
                 n_sample_image: int = 2, image_latent_dim: int = 4,
                 latent_downsample: int = 8):
        self.sys = system
        self.tokenizer = text_tokenizer
        self.output_dim = tuple(output_dim)
        self.ddim_steps = ddim_steps
        self.ddim_eta = ddim_eta
        self.n_sample_image = n_sample_image
        self.scale_textto = 7.5
        self.image_latent_dim = image_latent_dim
        self.latent_downsample = latent_downsample

    def _encode_text(self, texts: Sequence[str]):
        if self.tokenizer is None:
            raise RuntimeError("no CLIP tokenizer configured; construct VDInference "
                               "with text_tokenizer")
        return self.sys.ctx_encode(np.asarray(self.tokenizer(list(texts))), "text")

    def _image_shape(self, n: int):
        h, w = self.output_dim
        f = self.latent_downsample
        return (n, h // f, w // f, self.image_latent_dim)

    @torch.no_grad()
    def inference_t2i(self, text: str, seed: int):
        """[n, H, W, 3] images in [0, 1] for one prompt."""
        n = self.n_sample_image
        u = self._encode_text([""]).repeat(n, 1, 1)
        c = self._encode_text([text]).repeat(n, 1, 1)
        gen = torch.Generator(device=self.sys.device).manual_seed(seed)
        x = self.sys.sampler.sample(
            gen, self.ddim_steps, self._image_shape(n), {"type": "image"},
            {"type": "text", "conditioning": c, "unconditional_conditioning": u,
             "unconditional_guidance_scale": self.scale_textto},
            eta=self.ddim_eta, dtype=self.sys.dtype, device=self.sys.device)
        return self.sys.vae_decode(x, "image")
