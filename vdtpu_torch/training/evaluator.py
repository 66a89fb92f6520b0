"""Evaluators of the eval stage (``vdtpu/training/evaluator.py``): the
add-batch / summarize contract, a registry, and

- ``ClipSimilarityEvaluator``: the mean CLIP cosine between generated
  images and their prompts (the paper's CLIP-sim), from any pair of
  embedding functions (e.g. ``VDSystem.clip_image_features`` /
  ``clip_text_features``);
- ``FIDEvaluator``: the Frechet distance between pooled features of
  generated and reference images (CLIP vision CLS features by default in
  the eval run, "CLIP-FID", so no Inception weights are needed).

Embeddings and features may be CUDA or CPU tensors or numpy arrays; every
reduction runs in float64 numpy on the host.
"""
from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from vdtpu_torch.utils.logging import print_log

_REG: dict[str, type] = {}


def register_evaluator(name):
    def deco(cls):
        _REG[name] = cls
        return cls
    return deco


def get_evaluator(name: str, **kw):
    return _REG[name](**kw)


def to_numpy(x) -> np.ndarray:
    """A tensor (any device, any float dtype) or array as float64 numpy."""
    if torch.is_tensor(x):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float64)


@register_evaluator("clip_similarity")
class ClipSimilarityEvaluator:
    """Mean cosine(image CLS embedding, text pooled embedding)."""

    def __init__(self, image_embed_fn: Callable, text_embed_fn: Callable):
        self.image_embed_fn = image_embed_fn
        self.text_embed_fn = text_embed_fn
        self.sims: list[np.ndarray] = []
        self.sample_n = None

    def set_sample_n(self, n):
        self.sample_n = n

    def add_batch(self, images, texts):
        zi = to_numpy(self.image_embed_fn(images))   # [B, D]
        zt = to_numpy(self.text_embed_fn(texts))     # [B, D]
        zi = zi / np.linalg.norm(zi, axis=-1, keepdims=True)
        zt = zt / np.linalg.norm(zt, axis=-1, keepdims=True)
        self.sims.append((zi * zt).sum(-1))

    def summarize(self) -> dict[str, float]:
        sims = np.concatenate(self.sims) if self.sims else np.zeros(1)
        return {"clip_similarity": float(sims.mean())}

    def clear(self):
        self.sims.clear()


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1 - mu2||^2 + Tr(S1 + S2 - 2 (S1 S2)^1/2) through scipy's sqrtm,
    retried on S + eps I where the root is not finite; its real part.
    (vdtpu passes ``disp=False``, which newer scipy no longer takes; the
    root is the same.)"""
    from scipy import linalg
    mu1, sigma1, mu2, sigma2 = (np.asarray(a, np.float64) for a in (mu1, sigma1, mu2, sigma2))
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


@register_evaluator("fid")
class FIDEvaluator:
    """Frechet distance between generated and reference feature sets."""

    def __init__(self, feature_fn: Callable):
        self.feature_fn = feature_fn
        self.real: list[np.ndarray] = []
        self.fake: list[np.ndarray] = []

    def add_batch(self, fake_images, real_images=None):
        self.fake.append(to_numpy(self.feature_fn(fake_images)))
        if real_images is not None:
            self.real.append(to_numpy(self.feature_fn(real_images)))

    def add_reference(self, real_images):
        self.real.append(to_numpy(self.feature_fn(real_images)))

    def summarize(self) -> dict[str, float]:
        fake = np.concatenate(self.fake)
        real = np.concatenate(self.real)
        stats = lambda x: (x.mean(0), np.cov(x, rowvar=False))
        mu1, s1 = stats(real)
        mu2, s2 = stats(fake)
        return {"fid": frechet_distance(mu1, s1, mu2, s2)}

    def clear(self):
        self.real.clear()
        self.fake.clear()


class EvalStage:
    """Iterate an eval loader, run the sample function on each batch, feed
    the evaluator its outputs, summarize (and clear) at the end."""

    def __init__(self, evaluator, sample_fn: Callable, log_every: int = 10):
        self.evaluator = evaluator
        self.sample_fn = sample_fn
        self.log_every = log_every

    def __call__(self, loader: Iterable) -> dict[str, float]:
        for i, batch in enumerate(loader):
            self.evaluator.add_batch(*self.sample_fn(batch))
            if (i + 1) % self.log_every == 0:
                print_log(f"eval processed {i + 1} batches")
        summary = self.evaluator.summarize()
        print_log("eval summary: " + " ".join(f"{k}={v:.4f}" for k, v in summary.items()))
        self.evaluator.clear()
        return summary
