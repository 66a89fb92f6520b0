"""Serving API (``vdtpu/serving/api.py``): ``VDSystem`` builds and owns the
modules of a VD config, ``VDInference`` runs the flows. The port serves
all seven of the JAX package's flows: text-to-image, image variation
(``inference_i2i``), image-to-text (``inference_i2t``), text-to-text
(``inference_t2t``) and the blends of a prompt with images, masked or not
(``inference_dcg``, ``inference_tcg``, ``inference_mcg``).

``VDSystem`` builds ``diffuser.*`` (every diffuser of the config, so every
``diffuser.*`` key of a checkpoint loads), ``ctx.image`` and ``ctx.text``
(the CLIP context encoders), the ``vae.image`` KL autoencoder (encoder and
decoder) and the ``vae.text`` Optimus VAE (BERT encoder, GPT-2 decoder);
its ``net`` module carries the reference's state-dict keys. It
runs on CUDA unless the caller passes ``device="cpu"``, and raises when CUDA
is absent and the CPU was not asked for.

Serving policy: ``enable_int8`` attaches a ``QuantPolicy`` to the
diffusers' call sites and calibrates them over vdtpu's four flows
(``ops/quant.py``); ``enable_tome`` switches token merging on
(``ops/tome.py``). Both are state of the system, not of the process.

Evaluation and weights: ``clip_image_features`` / ``clip_text_features``
give the CLIP embeddings the metrics read; ``load_vdtpu_torch_checkpoint``
serves the port's own ``Trainer`` checkpoints.

Training: the constructor freezes the whole net in one dtype;
``for_training`` turns the diffusers back into a trainable tree for
``vdtpu_torch.training``: f32 master parameters, or bf16 ones with
``params_dtype`` (the counterpart of the JAX package's ``cast_params`` in
its launcher), computing in a lower dtype under autocast.
``ctx_encode`` runs without gradients; ``trainable_ctx`` makes a context
encoder trainable and gives the function that encodes with grad inside the
loss (the trainable context encoder). ``with_text_vae=False`` leaves the
Optimus VAE out (image-flow training needs no text VAE); ``free_towers``
drops the VAEs and the context encoders once a latent cache holds what
they encode.

Batch-parallel serving (``VDInference(mesh=)``, ``parallel/mesh.py``):
every rank of a dp group draws the whole request's x_T (or its q-sample
noise) from the seed, exactly as one process draws it, and samples its
own rows of x_T, cond and uncond (``Mesh.row_range``); the latents are
gathered so every rank holds the whole batch (the text flows decode it
whole, their generator where one process's would be), and the images are
decoded by rows and all-gathered, so every rank returns the whole result.
Each rank runs a smaller batch than one process, so the kernels and
libraries see other shapes: f32 agrees to rounding, not bit for bit.
Sampling at eta > 0 under dp raises (each rank would draw its own step
noise). Two ways to drive it: every rank calls the same flow (SPMD), or
rank 0 leads (``with vdi.lead():``, e.g. around a ``BatchingQueue``) and
every other rank runs ``vdi.follow()``: each ``_sample`` /
``_sample_multi`` call (``_sample_text`` goes through ``_sample``) and,
under dp, each image decode of the leader is first broadcast
(``collectives.broadcast_object``), and the followers run it until the
leader's stop message. Under tp the ranks of a tp group run the same rows
through sharded layers (``shard_module``), so they follow the sampling
too. The int8 policy and ToMe run under dp as they run alone (their rows
are independent at a calibrated scale); the int8 policy under tp raises
(``shard_module``).
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from vdtpu_torch.config.configs import model_cfg_bank
from vdtpu_torch.config.registry import build
from vdtpu_torch.interop.from_jax import system_state_dict_from_jax
from vdtpu_torch.models.clip import preprocess_images, vision_token_mask
from vdtpu_torch.models.layers import init_random
from vdtpu_torch.models.vd import VDModel
from vdtpu_torch.ops.quant import (
    QuantPolicy, calibrate, load_quant_state, quant_state, set_quant_policy)
from vdtpu_torch.ops.resize import resize
from vdtpu_torch.ops.tome import ToMeSpec
from vdtpu_torch.sampling.ddim import DDIMSampler
from vdtpu_torch.serving.postprocess import (
    AdjustRank, color_adjust_simple, remove_duplicate_word)

# (x_type, c_type) of vdtpu's four flows, the default of ``enable_int8``
FOUR_FLOWS = (("image", "text"), ("image", "image"), ("text", "image"), ("text", "text"))


def regularize_image(x, hw, method: str = "bicubic"):
    """Resize an NHWC float batch to ``hw`` = (H, W) as the JAX package does
    (``jax.image.resize``, antialiased): images bicubic, clamped to [0, 1];
    masks ``method="bilinear"``, unclamped. A batch already at ``hw`` is
    returned as it is."""
    x = torch.as_tensor(x)
    if tuple(x.shape[1:3]) == (int(hw[0]), int(hw[1])):
        return x
    out = resize(x, hw, method)
    return out.clamp(0.0, 1.0) if method == "bicubic" else out


def resolve_device(device=None) -> torch.device:
    """CUDA unless the caller names a device; no silent CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the card; pass "
                               "device='cpu' to run its plain versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def vd_inference(which: str = "v1.0", fp16: bool = False, checkpoint: str | None = None,
                 device=None, **kw) -> "VDInference":
    """Drop-in for the reference constructor (``app.py``):
    ``vd_inference(which="v1.0", fp16=True)`` -> a ready ``VDInference`` of
    ``vd_four_flow_v1-0``, on the card unless ``device`` names another.
    ``fp16`` means bf16 (the system is built in it, so the checkpoint's
    tensors are cast as they load); ``checkpoint`` is a torch ``.pt`` /
    ``.pth`` of the reference's keys (a ``{"state_dict": ...}`` wrapper or
    the flat dict; a path or anything ``torch.load`` reads), loaded
    non-strict over the seeded init. ``kw`` goes to ``VDInference``."""
    if which != "v1.0":
        raise ValueError("Model type not supported")
    dtype = torch.bfloat16 if fp16 else torch.float32
    system = VDSystem("vd_four_flow_v1-0", dtype=dtype, device=device).init_random(0)
    if checkpoint:
        sd = torch.load(checkpoint, map_location="cpu")
        system.load_torch_checkpoint(sd.get("state_dict", sd))
    return VDInference(system, **kw)


class _CtxHolder(nn.Module):
    """Keeps the reference's ``ctx.<name>.model.`` key prefix."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model


class VDSystem:
    """Every module and weight of one VD config (this slice's parts)."""

    # state-dict prefixes the port builds; load_state_dict ignores the rest
    PREFIXES = ("diffuser.", "ctx.image.model.", "ctx.text.model.", "vae.image.encoder.",
                "vae.image.quant_conv.", "vae.image.decoder.", "vae.image.post_quant_conv.",
                "vae.text.encoder.", "vae.text.decoder.")

    def __init__(self, cfg_name: str = "vd_four_flow_v1-0", dtype=torch.float32,
                 device=None, use_checkpoint: bool | None = None,
                 remat_max_channels: int | None = None, with_text_vae: bool = True,
                 model_args: Mapping[str, Any] | None = None):
        """``use_checkpoint`` / ``remat_max_channels``: the diffusers' remat
        in training (None: each diffuser's config flag); serving ignores them.
        ``with_text_vae=False`` builds no Optimus VAE. ``model_args`` replaces
        keys of the config's args (an experiment's overlay, as the JAX
        package's ``model_args``)."""
        self.cfg = model_cfg_bank()(cfg_name)
        if model_args:
            self.cfg = dict(self.cfg, args=dict(self.cfg["args"], **model_args))
        self.device = resolve_device(device)
        self.dtype = dtype
        args = self.cfg["args"]
        with torch.device(self.device):
            self.model = VDModel.from_config(self.cfg, use_checkpoint=use_checkpoint,
                                             remat_max_channels=remat_max_channels)
            self.net = nn.Module()
            self.net.diffuser = self.model.diffuser
            self.net.ctx = nn.ModuleDict({name: _CtxHolder(build(sub))
                                          for name, sub in args["ctx_cfg_list"]})
            self.net.vae = nn.ModuleDict({name: build(sub)
                                          for name, sub in args["vae_cfg_list"]
                                          if name != "text" or with_text_vae})
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

    def for_training(self, compute_dtype=torch.bfloat16,
                     params_dtype=torch.float32) -> dict[str, nn.Parameter]:
        """Make the diffusers (and a learned ``logvar``) trainable:
        ``params_dtype`` master parameters (f32, or bf16 master weights) with
        gradients on, ``p_losses`` computing in ``compute_dtype`` under
        autocast. Returns the parameters by name
        (``VDModel.named_parameters``), the tree the trainer takes. The
        context encoders and the VAEs keep the system's dtype and stay frozen;
        to sample from the trained diffusers, ``cast`` the system."""
        if compute_dtype == torch.float32 and params_dtype != torch.float32:
            raise ValueError(f"{params_dtype} master weights compute in that dtype or "
                             "another 16-bit one, not in f32")
        self.model.diffuser.to(params_dtype).train().requires_grad_(True)
        if self.model.logvar is not None:
            self.model.logvar.data = self.model.logvar.data.to(params_dtype)
            self.model.logvar.requires_grad_(True)
        self.model.dtype = compute_dtype
        return dict(self.model.named_parameters())

    def trainable_ctx(self, which: str = "text", compute_dtype=torch.bfloat16,
                      params_dtype=torch.float32):
        """Make context encoder ``which`` trainable (``params_dtype``
        parameters, gradients on) for the trainable-context-encoder path:
        (its parameters by name, ``encode(raw)`` -> context with grad, in
        ``compute_dtype`` under autocast). ``raw`` is what ``ctx_encode``
        takes: token ids [B, L] (text) or NHWC images in [0, 1] (image)."""
        enc = self.ctx[which]
        enc.to(params_dtype).train().requires_grad_(True)

        def encode(raw):
            with torch.autocast(self.device.type, dtype=compute_dtype,
                                enabled=compute_dtype != torch.float32):
                if which == "image":
                    px = preprocess_images(torch.as_tensor(raw).to(self.device), enc.image_size)
                    return enc(px)
                return enc(torch.as_tensor(raw).to(device=self.device, dtype=torch.long))
        return dict(enc.named_parameters()), encode

    def free_towers(self) -> None:
        """Drop the VAEs and the context encoders (after a latent cache
        holds what they encode): only the diffusers stay on the device."""
        for name in list(self.net.vae):
            del self.net.vae[name]
        for name in list(self.net.ctx):
            del self.net.ctx[name]
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def load_state_dict(self, sd: Mapping[str, Any], strict: bool = True):
        """Load a reference-keyed state dict (torch tensors or numpy arrays)
        over the prefixes the port builds; strict within them."""
        own = {k: v if torch.is_tensor(v) else torch.tensor(np.asarray(v))
               for k, v in sd.items() if k.startswith(self.PREFIXES)}
        return self.net.load_state_dict(own, strict=strict)

    def load_torch_checkpoint(self, state_dict: Mapping[str, Any], strict: bool = False
                              ) -> list[str]:
        """Load the published flat state dict (``vd-four-flow-v1-0.pth``'s
        keys), non-strict by default as the JAX package's
        ``load_torch_checkpoint``: returns the keys the port builds that the
        dict lacks."""
        return list(self.load_state_dict(state_dict, strict=strict).missing_keys)

    def load_jax_params(self, params: Mapping[str, Any], strict: bool = True):
        """Load a JAX ``VDSystem.params`` tree (numpy leaves)."""
        return self.load_state_dict(system_state_dict_from_jax(params), strict=strict)

    def load_vdtpu_torch_checkpoint(self, ckpt_dir: str, tag: str | None = None,
                                    use_ema: bool = True, ctx_slot: str = "text") -> str:
        """Serve weights trained by the port's ``Trainer``
        (``training/checkpoints.py``'s ``<ckpt_dir>/<tag>.pt``; ``tag`` None:
        ``latest_tag``). ``use_ema`` takes the EMA shadow where the run kept
        one, else the raw parameters. A ``{"diffuser": ..., "ctx": ...}``
        tree (a run that also trained the context encoder) loads its context
        encoder into ``ctx[ctx_slot]``. Every diffuser parameter must be in
        the checkpoint; a learned ``logvar`` loads where the model has one.
        Returns the tag loaded."""
        from vdtpu_torch.training.checkpoints import latest_tag, restore_checkpoint
        if tag is None:
            tag = latest_tag(ckpt_dir)
        payload = restore_checkpoint(ckpt_dir, tag, map_location="cpu")
        ema = payload.get("ema")
        src = ema["shadow"] if (use_ema and isinstance(ema, Mapping)
                                and ema.get("shadow") is not None) else payload["params"]
        diff, ctx = ((src["diffuser"], src.get("ctx")) if isinstance(src.get("diffuser"), Mapping)
                     else (src, None))
        diff = dict(diff)
        logvar = diff.pop("logvar", None)
        want = {name for name, _ in self.model.diffuser.named_parameters()}
        if set(diff) != want:
            raise KeyError(f"checkpoint {tag!r}: diffuser parameters missing "
                           f"{sorted(want - set(diff))[:5]}, unexpected "
                           f"{sorted(set(diff) - want)[:5]}")
        with torch.no_grad():
            self.model.diffuser.load_state_dict(diff, strict=False)
            if logvar is not None and self.model.logvar is not None:
                self.model.logvar.copy_(logvar)
        if ctx is not None:
            self.ctx[ctx_slot].load_state_dict(ctx, strict=True)
        return tag

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
                    timesteps=(0, 250, 500, 750, 999), seed: int = 0, flows=FOUR_FLOWS,
                    policy: QuantPolicy = QuantPolicy()):
        """Calibrated int8 serving (``vdtpu/serving/api.py::enable_int8``):
        attach ``policy`` and record every site's activation scale and every
        attention's logit bound over (noise, t, context) probes spanning the
        timestep range, 2n samples each, for each flow of ``flows`` (all
        four by default); the statistics merge by max across probes and
        flows. The draws come from a ``torch.Generator`` seeded with
        ``seed``: random ids for the text encoder, uniform pixels for the
        image encoder, one normal latent per (data type, timestep), as the
        JAX package draws them. A second call is a no-op."""
        if self.quant_policy is not None and quant_state(self.model.diffuser):
            return self
        gen = torch.Generator(device=self.device).manual_seed(seed)
        c_types = {c for _, c in flows}
        ids = pixels = None
        if "text" in c_types:
            enc = self.ctx["text"]
            vocab = enc.text_model.embeddings.token_embedding.num_embeddings
            ids = torch.randint(0, vocab, (2 * n, enc.max_len), generator=gen,
                                device=self.device)
        if "image" in c_types:
            sz = self.ctx["image"].image_size
            pixels = torch.rand((2 * n, sz, sz, 3), generator=gen, device=self.device)
        noise = {x_type: [torch.randn(self._probe_shape(x_type, n, image_size,
                                                        latent_downsample),
                                      generator=gen, device=self.device)
                          for _ in timesteps]
                 for x_type in dict.fromkeys(x for x, _ in flows)}
        return self.calibrate_flows(ids, pixels, noise, flows, timesteps, policy)

    def _probe_shape(self, x_type: str, n: int, image_size: int, latent_downsample: int):
        """NHWC latent [2n, s, s, C] of a 2-D diffuser, [2n, F] of a 0-D one."""
        a = dict(self.cfg["args"]["diffuser_cfg_list"])[x_type]["args"]
        if "in_channels" in a:
            s = image_size // latent_downsample
            return (2 * n, s, s, a["in_channels"])
        return (2 * n, a["input_channels"])

    @torch.no_grad()
    def calibrate_flows(self, ids, pixels, noise, flows=FOUR_FLOWS,
                        timesteps=(0, 250, 500, 750, 999),
                        policy: QuantPolicy = QuantPolicy()) -> "VDSystem":
        """Calibrate on given draws: ``ids`` [2n, L] for the text context,
        ``pixels`` NHWC [2n, S, S, 3] in [0, 1] for the image context,
        ``noise[x_type][i]`` the latent probe (NHWC, or [2n, F]) at
        ``timesteps[i]``. Contexts come from this system's encoders."""
        ctxs = {}
        if ids is not None:
            ctxs["text"] = self.ctx_encode(ids, "text").to(self.dtype)
        if pixels is not None:
            ctxs["image"] = self.ctx_encode(pixels, "image").to(self.dtype)
        probes = []
        for x_type, c_type in flows:
            for t, x in zip(timesteps, noise[x_type]):
                x = torch.as_tensor(x).to(device=self.device, dtype=self.dtype)
                if x.dim() == 4:
                    x = x.permute(0, 3, 1, 2).contiguous()
                probes.append((x, torch.full((x.shape[0],), int(t), device=self.device),
                               ctxs[c_type], x_type, c_type))
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
    def ctx_encode(self, x, which: str = "text", masks=None):
        """Token ids [B, L] -> text context; NHWC images in [0, 1] -> image
        context, always through ``preprocess_images`` (resize and crop where
        needed, the CLIP mean/std always). ``masks`` [B, H, W, 1] (1 keeps a
        pixel) gives the masked image context: the mask goes bilinear
        straight to the encoder's size (no crop), then per token
        (``vision_token_mask``)."""
        if which == "image":
            enc = self.ctx["image"]
            px = preprocess_images(torch.as_tensor(x).to(self.device), enc.image_size)
            if masks is None:
                return enc(px.to(self.dtype))
            m = torch.as_tensor(masks).to(device=self.device, dtype=torch.float32)
            m = resize(m, (enc.image_size, enc.image_size), "bilinear")
            return enc(px.to(self.dtype), vision_token_mask(m, enc.patch))
        if which != "text":
            raise ValueError(f"no context encoder {which!r}")
        ids = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x), dtype=torch.long)
        return self.ctx["text"](ids.to(device=self.device, dtype=torch.long))

    def clip_image_features(self, images):
        """The CLS token of the image context [B, D] (NHWC images in [0, 1])."""
        return self.ctx_encode(images, "image")[:, 0]

    def clip_text_features(self, token_ids):
        """The text context at each row's first EOT id (the largest id) [B, D]."""
        ids = (token_ids if torch.is_tensor(token_ids) else torch.as_tensor(np.asarray(token_ids)))
        ids = ids.to(device=self.device, dtype=torch.long)
        z = self.ctx_encode(ids, "text")
        return z[torch.arange(z.shape[0], device=z.device), ids.argmax(dim=-1)]

    @torch.no_grad()
    def vae_encode(self, x, which: str = "image"):
        """NHWC image in [0, 1] -> NHWC scaled latent (the posterior's mode);
        texts -> [n, 768] text latents (the posterior's mean; needs the BERT
        tokenizer)."""
        if which == "text":
            return self.model.scale_latent(self.vae["text"].encode(x), which)
        if which != "image":
            raise ValueError(f"no VAE {which!r}")
        x = torch.as_tensor(x).to(self.device).permute(0, 3, 1, 2).contiguous()
        z = self.vae["image"].encode(x)
        return self.model.scale_latent(z, which).permute(0, 2, 3, 1)

    @torch.no_grad()
    def vae_decode(self, z, which: str = "image", **text_kw):
        """NHWC latent (scaled) -> NHWC image in [0, 1]; a text latent
        [n, 768] -> n texts (``text_kw``: ``generator``, ``temperature``,
        ``gumbel_table`` of ``OptimusVAE.decode``)."""
        z = torch.as_tensor(z).to(device=self.device, dtype=self.dtype)
        z = self.model.unscale_latent(z, which)
        if which == "text":
            return self.vae["text"].decode(z, **text_kw)
        if which != "image":
            raise ValueError(f"no VAE {which!r}")
        return self.vae["image"].decode(z.permute(0, 3, 1, 2).contiguous()).permute(0, 2, 3, 1)


class VDInference:
    """Flow-level API (``vdtpu.serving.api.VDInference``): text-to-image,
    image variation, image-to-text, text-to-text, and the multi-context
    blends (dual, triple and multi-context) under attention mixing."""

    def __init__(self, system: VDSystem,
                 text_tokenizer: Callable[[Sequence[str]], np.ndarray] | None = None,
                 output_dim=(512, 512), ddim_steps: int = 50, ddim_eta: float = 0.0,
                 n_sample_image: int = 2, n_sample_text: int = 4, image_latent_dim: int = 4,
                 text_latent_dim: int = 768, latent_downsample: int = 8,
                 sampler: str = "ddim", encoder_reuse=None, cfg_interval=None, mesh=None):
        """``sampler`` ("ddim" or "dpmpp2m"), ``encoder_reuse`` (None, an
        interval or {"interval", "warmup"}) and ``cfg_interval`` (None or
        (lo, hi)) are the sampler modes of every flow
        (``sampling/ddim.py``); the defaults are exact DDIM. ``mesh``: the
        batch rows go over its dp group (module docstring)."""
        self.sys = system
        self.mesh = mesh
        self._leading = False
        self.tokenizer = text_tokenizer
        self.output_dim = tuple(output_dim)
        self.ddim_steps = ddim_steps
        self.ddim_eta = ddim_eta
        self.n_sample_image = n_sample_image
        self.n_sample_text = n_sample_text
        self.scale_textto = 7.5
        self.scale_imgto = 7.5
        self.image_latent_dim = image_latent_dim
        self.text_latent_dim = text_latent_dim
        self.latent_downsample = latent_downsample
        self.text_temperature = 1.0
        self.sampler = sampler
        self.encoder_reuse = encoder_reuse
        self.cfg_interval = cfg_interval
        self.adjust_rank_f = AdjustRank(max_drop_rank=(1, 5), q=20)

    def _encode_text(self, texts: Sequence[str]):
        if self.tokenizer is None:
            raise RuntimeError("no CLIP tokenizer configured; construct VDInference "
                               "with text_tokenizer")
        return self.sys.ctx_encode(np.asarray(self.tokenizer(list(texts))), "text")

    def _focus_filter(self, ci, fcs_lvl: float):
        """AdjustRank on the local tokens; the global CLS token is kept (the
        JAX package's ``disentanglement_noglobal``, always on)."""
        return torch.cat([ci[:, 0:1], self.adjust_rank_f(ci[:, 1:], fcs_lvl)], dim=1)

    def _regularize(self, image, method: str = "bicubic"):
        """Input regularization to output_dim (images bicubic, masks
        bilinear, as the reference)."""
        x = torch.as_tensor(image).to(device=self.sys.device, dtype=torch.float32)
        return regularize_image(x, self.output_dim, method)

    def _image_shape(self, n: int):
        h, w = self.output_dim
        f = self.latent_downsample
        return (n, h // f, w // f, self.image_latent_dim)

    def _modes(self) -> dict:
        return dict(eta=self.ddim_eta, dtype=self.sys.dtype, device=self.sys.device,
                    method=self.sampler, encoder_reuse=self.encoder_reuse,
                    cfg_interval=self.cfg_interval)

    def _dp(self) -> bool:
        return self.mesh is not None and self.mesh.dp > 1

    def _sample(self, gen, shape, x_info, c_info):
        return self._run("sample", gen, shape, x_info, c_info)

    def _sample_multi(self, gen, shape, x_info, c_info_list):
        return self._run("multi", gen, shape, x_info, c_info_list)

    def _run(self, kind: str, gen, shape, x_info, c_info):
        """``_sample`` ("sample") and ``_sample_multi`` ("multi"); under dp,
        x_T (or the q-sample noise) is drawn whole from ``gen`` as the
        sampler would draw it, this rank's rows are sampled and the latents
        gathered."""
        from vdtpu_torch.parallel.collectives import gather_rows
        if self._leading:
            state = None if gen is None else gen.get_state()
            self._send((kind, state, tuple(shape), x_info, c_info))
        sample = (self.sys.sampler.sample if kind == "sample"
                  else self.sys.sampler.sample_multicontext)
        if not self._dp():
            return sample(gen, self.ddim_steps, shape, x_info, c_info, **self._modes())
        if self.ddim_eta:
            raise NotImplementedError("batch-parallel sampling at eta > 0: each rank would "
                                      "draw its own step noise (serve it at dp = 1)")
        n, dt, dev = shape[0], self.sys.dtype, self.sys.device
        x_info = dict(x_info)
        if x_info.get("xt") is None:
            key = "noise" if x_info.get("x0") is not None else "xt"
            if x_info.get(key) is None:
                x_info[key] = torch.randn(tuple(shape), generator=gen, device=dev, dtype=dt)
        lo, hi = self.mesh.row_range(n)

        def rows(d):
            return {k: v[lo:hi] if torch.is_tensor(v) and v.dim() and v.shape[0] == n else v
                    for k, v in d.items()}
        local_shape = (hi - lo, *shape[1:])
        if hi == lo:      # fewer rows than ranks: a zero block in the gather
            x = torch.zeros(local_shape, device=dev, dtype=dt)
        else:
            ci = rows(c_info) if kind == "sample" else [rows(c) for c in c_info]
            x = sample(gen, self.ddim_steps, local_shape, rows(x_info), ci, **self._modes())
        return gather_rows(x, n, self.mesh)

    def _decode_images(self, x):
        """[n, H, W, 3] images of latents x; under dp each rank decodes its
        rows and the images are all-gathered."""
        from vdtpu_torch.parallel.collectives import gather_rows
        if not self._dp():   # the VAE is not sharded: a tp follower has no part in it
            return self.sys.vae_decode(x, "image")
        if x.shape[0] < self.mesh.dp:
            raise ValueError(f"{x.shape[0]} images over dp={self.mesh.dp}: every rank "
                             "decodes a row at least")
        if self._leading:
            self._send(("decode", x))
        lo, hi = self.mesh.row_range(x.shape[0])
        return gather_rows(self.sys.vae_decode(x[lo:hi], "image"), x.shape[0], self.mesh)

    # ---- leader and followers ----

    def _send(self, msg) -> None:
        from vdtpu_torch.parallel.collectives import broadcast_object
        broadcast_object(msg, src=0)

    @contextlib.contextmanager
    def lead(self):
        """Context manager on rank 0 of a mesh of several ranks: its samples
        and decodes are broadcast to the followers (``follow``) while it is
        open; leaving it sends them the stop message."""
        if self.mesh is None or self.mesh.size == 1 or self.mesh.rank != 0:
            raise RuntimeError("lead() runs on rank 0 of a mesh of several ranks")
        self._leading = True
        try:
            yield self
        finally:
            self._leading = False
            self._send(None)

    @torch.no_grad()
    def follow(self) -> int:
        """A follower's loop (every rank but 0): run each sample and decode
        the leader broadcasts, until its stop message. Returns the number
        of calls run."""
        from vdtpu_torch.parallel.collectives import broadcast_object
        if self.mesh is None or self.mesh.rank == 0:
            raise RuntimeError("follow() runs on the ranks other than 0")
        calls = 0
        while True:
            msg = broadcast_object(None, src=0, device=self.sys.device)
            if msg is None:
                return calls
            calls += 1
            if msg[0] == "decode":
                self._decode_images(msg[1])
                continue
            kind, state, shape, x_info, c_info = msg
            gen = None
            if state is not None:
                gen = torch.Generator(device=self.sys.device)
                gen.set_state(state.cpu())
            self._run(kind, gen, shape, x_info, c_info)

    @torch.no_grad()
    def inference_t2i(self, text: str, seed: int):
        """[n, H, W, 3] images in [0, 1] for one prompt."""
        n = self.n_sample_image
        u = self._encode_text([""]).repeat(n, 1, 1)
        c = self._encode_text([text]).repeat(n, 1, 1)
        gen = torch.Generator(device=self.sys.device).manual_seed(seed)
        x = self._sample(gen, self._image_shape(n), {"type": "image"},
                         {"type": "text", "conditioning": c, "unconditional_conditioning": u,
                          "unconditional_guidance_scale": self.scale_textto})
        return self._decode_images(x)

    @torch.no_grad()
    def inference_i2i(self, image, fid_lvl: float, fcs_lvl: float, clr_adj: str | None,
                      seed: int):
        """Image variation: image [1, H, W, 3] in [0, 1], any H, W, resized to
        output_dim first (so fid_lvl 1 returns the resized image, n times).
        fid_lvl: the share of the DDIM steps skipped by starting from the
        image's own latent (0: from noise); fcs_lvl: the focus filter's
        level (0.5: off); clr_adj "Simple" matches the outputs' colour
        statistics to the input's. Returns [n, H, W, 3] in [0, 1]."""
        n = self.n_sample_image
        cx = self._regularize(image)
        if fid_lvl == 1:
            return cx.repeat(n, 1, 1, 1)
        ci = self.sys.ctx_encode(cx, "image")
        c = self._focus_filter(ci, fcs_lvl).repeat(n, 1, 1)
        u = torch.zeros_like(c)
        gen = torch.Generator(device=self.sys.device).manual_seed(seed)
        x_info = {"type": "image"}
        if fid_lvl != 0:
            x0 = self.sys.vae_encode(cx, "image").repeat(n, 1, 1, 1)
            x_info = {"type": "image", "x0": x0,
                      "x0_forward_timesteps": int(self.ddim_steps * (1 - fid_lvl))}
        x = self._sample(gen, self._image_shape(n), x_info,
                         {"type": "image", "conditioning": c, "unconditional_conditioning": u,
                          "unconditional_guidance_scale": self.scale_imgto})
        out = self._decode_images(x)
        if clr_adj == "Simple":
            out = color_adjust_simple(out, cx)
        return out

    def _decode_texts(self, x, generator) -> list[str]:
        texts = self.sys.vae_decode(x, "text", generator=generator,
                                    temperature=self.text_temperature)
        return [remove_duplicate_word(t) for t in texts]

    def _sample_text(self, gen, c, u, c_type: str, scale: float):
        return self._sample(gen, (self.n_sample_text, self.text_latent_dim), {"type": "text"},
                            {"type": c_type, "conditioning": c, "unconditional_conditioning": u,
                             "unconditional_guidance_scale": scale})

    @torch.no_grad()
    def inference_i2t(self, image, seed: int) -> list[str]:
        """n_sample_text captions of image [1, H, W, 3] in [0, 1] (resized to
        output_dim first); the unconditional context is the CLIP vision
        embedding of a black image. One generator seeded with ``seed``
        draws the DDIM start and then the decode's Gumbel noise."""
        n = self.n_sample_text
        cx = self._regularize(image)
        c = self.sys.ctx_encode(cx, "image").repeat(n, 1, 1)
        u = self.sys.ctx_encode(torch.zeros_like(cx), "image").repeat(n, 1, 1)
        gen = torch.Generator(device=self.sys.device).manual_seed(seed)
        x = self._sample_text(gen, c, u, "image", self.scale_imgto)
        return self._decode_texts(x, gen)

    @torch.no_grad()
    def inference_t2t(self, text: str, seed: int) -> list[str]:
        """n_sample_text texts from a prompt; the unconditional context is
        the CLIP text embedding of ""."""
        n = self.n_sample_text
        u = self._encode_text([""]).repeat(n, 1, 1)
        c = self._encode_text([text]).repeat(n, 1, 1)
        gen = torch.Generator(device=self.sys.device).manual_seed(seed)
        x = self._sample_text(gen, c, u, "text", self.scale_textto)
        return self._decode_texts(x, gen)

    @torch.no_grad()
    def inference_dcg(self, image, fcs_lvl: float, text: str, textstrength: float,
                      seed: int):
        """Dual-context (app.py:436-492): one image (focus ``fcs_lvl``) and a
        prompt, the prompt's share ``textstrength``. Returns [n, H, W, 3]."""
        return self.inference_mcg([{"image": image, "strength": 1.0, "fcs_lvl": fcs_lvl}],
                                  text, textstrength, seed)[1]

    @torch.no_grad()
    def inference_tcg(self, image_ctxs, text: str | None, textstrength: float, seed: int):
        """Triple-context: ``inference_mcg`` on the first two image contexts."""
        return self.inference_mcg(image_ctxs[:2], text, textstrength, seed)

    @torch.no_grad()
    def inference_mcg(self, image_ctxs: Sequence[Mapping[str, Any] | None],
                      text: str | None, textstrength: float, seed: int):
        """Multi-context blend (app.py:500-579). Each image context is a dict:
        ``image`` [1, H, W, 3] in [0, 1] (any size; resized to output_dim),
        ``strength`` (default 1), ``fcs_lvl`` (default 0.5: no focus
        filter), ``mask`` [1, H, W, 1] (optional; 1 hides a pixel). Returns
        (the inputs as shown, one [1, H, W, 3] per image used;
        [n, H, W, 3] images in [0, 1])."""
        n = self.n_sample_image
        inputs_shown, c_info_list = self._mcg_context(image_ctxs, text, textstrength, n)
        gen = torch.Generator(device=self.sys.device).manual_seed(seed)
        x = self._sample_multi(gen, self._image_shape(n), {"type": "image"}, c_info_list)
        return inputs_shown, self._decode_images(x)

    def _mcg_context(self, image_ctxs, text: str | None, textstrength: float, n: int):
        """(inputs_shown, c_info_list) of a multi-context request, tiled to n
        rows: the text context first (ratio ``textstrength``; skipped when
        there is no text or its strength is 0), then the image contexts
        concatenated along the tokens (ratio 1 - textstrength), each
        focus-filtered, then scaled by its strength; the unconditional image
        context is zeros. The guidance scale blends ``scale_imgto`` and
        ``scale_textto`` by ``textstrength``."""
        c_info_list = []
        if text and textstrength != 0:
            scale = self.scale_imgto * (1 - textstrength) + self.scale_textto * textstrength
            c_info_list.append({
                "type": "text", "conditioning": self._encode_text([text]).repeat(n, 1, 1),
                "unconditional_conditioning": self._encode_text([""]).repeat(n, 1, 1),
                "unconditional_guidance_scale": scale, "ratio": textstrength})
        else:
            scale, textstrength = self.scale_imgto, 0.0
        inputs_shown, imc = [], []
        for ctx in image_ctxs:
            if ctx is None or ctx.get("image") is None:
                continue
            cx = self._regularize(ctx["image"])
            mask = ctx.get("mask")
            if mask is not None:
                m = 1.0 - self._regularize(mask, "bilinear")
                inputs_shown.append(cx * m)
                ci = self.sys.ctx_encode(cx, "image", masks=m)
            else:
                inputs_shown.append(cx)
                ci = self.sys.ctx_encode(cx, "image")
            ci = self._focus_filter(ci, ctx.get("fcs_lvl", 0.5))
            strength = torch.tensor(float(ctx.get("strength", 1.0)), dtype=ci.dtype)
            imc.append((ci * strength).repeat(n, 1, 1))
        if not imc:
            raise ValueError("a multi-context request needs at least one image")
        cis = torch.cat(imc, dim=1)
        c_info_list.append({
            "type": "image", "conditioning": cis,
            "unconditional_conditioning": torch.zeros_like(cis),
            "unconditional_guidance_scale": scale, "ratio": 1 - textstrength})
        return inputs_shown, c_info_list
