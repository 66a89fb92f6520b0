"""The eval run of the training launcher (``vdtpu/training/launch.py::
run_eval``): generate images from the captions of eval batches with a
frozen ``VDSystem`` and score them with an evaluator of
``training/evaluator.py``.

A sample function takes a batch ``{"caption": [...], "image": NHWC in
[0, 1]}``: the captions through the CLIP tokenizer and ``ctx_encode``,
the encoding of "" tiled as the unconditional context, one DDIM (or
DPM-Solver++) run with classifier-free guidance, ``vae_decode``. CLIP-sim
pairs the images with their token ids (``clip_image_features`` /
``clip_text_features``); FID compares their CLIP vision features with the
batch's own images. The launcher's CLI, its webdataset loader, its
``summary.yaml`` and its log file are not ported yet: any iterable of
batches runs here.
"""
from __future__ import annotations

import itertools
from typing import Callable, Iterable, Mapping

import numpy as np
import torch

from vdtpu_torch.training.evaluator import EvalStage, get_evaluator

# the eval: section's keys and vdtpu's defaults
EVAL_DEFAULTS = {"ddim_steps": 50, "scale": 7.5, "latent_size": 64, "latent_dim": 4,
                 "evaluator": "clip_similarity", "sampler": "ddim", "seed": 0,
                 "max_batches": None}


def build_eval(system, tokenizer: Callable, vcfg: Mapping | None = None):
    """(sample_fn, evaluator) of an eval run of ``system`` under the eval
    keys ``vcfg`` (``EVAL_DEFAULTS`` for the missing ones). ``sampler``
    ("ddim" or "dpmpp2m") is the method of ``DDIMSampler.sample``.
    Each batch's x_T [B, s, s, latent_dim] is the next draw of normals from
    one generator seeded with ``seed``, on the system's device (the
    samplers draw nothing else at eta 0)."""
    v = {**EVAL_DEFAULTS, **dict(vcfg or {})}
    steps, scale, method = int(v["ddim_steps"]), float(v["scale"]), v["sampler"]
    s, dim, name = int(v["latent_size"]), int(v["latent_dim"]), v["evaluator"]
    gen = torch.Generator(device=system.device).manual_seed(int(v["seed"]))
    uncond_1 = system.ctx_encode(np.asarray(tokenizer([""])), "text")

    @torch.no_grad()
    def sample_fn(batch):
        ids = np.asarray(tokenizer(list(batch["caption"])))
        c = system.ctx_encode(ids, "text")
        u = uncond_1.repeat(c.shape[0], 1, 1)
        shape = (c.shape[0], s, s, dim)
        xt = torch.randn(shape, generator=gen, device=system.device)
        x = system.sampler.sample(
            gen, steps, shape, {"type": "image", "xt": xt},
            {"type": "text", "conditioning": c, "unconditional_conditioning": u,
             "unconditional_guidance_scale": scale},
            dtype=system.dtype, device=system.device, method=method)
        imgs = system.vae_decode(x, "image")
        return (imgs, ids) if name == "clip_similarity" else (imgs, batch["image"])

    if name == "clip_similarity":
        evaluator = get_evaluator(name, image_embed_fn=system.clip_image_features,
                                  text_embed_fn=system.clip_text_features)
    else:
        evaluator = get_evaluator(name, feature_fn=system.clip_image_features)
    return sample_fn, evaluator


def run_eval(system, tokenizer: Callable, vcfg: Mapping | None,
             batches: Iterable) -> dict[str, float]:
    """Score ``system`` on ``batches`` (at most ``max_batches``) through
    ``EvalStage``; returns the evaluator's summary."""
    sample_fn, evaluator = build_eval(system, tokenizer, vcfg)
    limit = {**EVAL_DEFAULTS, **dict(vcfg or {})}["max_batches"]
    loader = itertools.islice(batches, limit) if limit else batches
    return EvalStage(evaluator, sample_fn)(loader)
