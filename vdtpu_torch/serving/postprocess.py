"""Serving-side post-processing (``vdtpu/serving/postprocess.py``): the
focus filter over CLIP vision tokens and the simple colour adjust.

``AdjustRank`` is the JAX package's deterministic thin-SVD PCA (the
reference draws a randomized ``torch.pca_lowrank``). Singular vectors are
defined up to sign, and the sign differs between libraries, but each
rank's term u * s * v^T does not, so the result is the JAX package's up to
f32 rounding. ``remove_duplicate_word`` cleans the text flows' sampled
captions.
"""
from __future__ import annotations

import numpy as np
import torch


def _decompose(x, q: int):
    """Rank-q PCA of token matrices x [B, N, D] (f32): (u, s, vt, mean over
    D, the residual beyond rank q). The SVD has min(N, D) ranks; q keeps at
    most that many."""
    x_mean = x.mean(dim=-1, keepdim=True)
    xc = x - x_mean
    u, s, vt = torch.linalg.svd(xc, full_matrices=False)
    u, s, vt = u[:, :, :q], s[:, :q], vt[:, :q, :]
    return u, s, vt, x_mean, xc - torch.einsum("bnq,bq,bqd->bnd", u, s, vt)


class AdjustRank:
    """Focus filter: lvl < 0.5 weakens the leading (semantic) principal
    ranks, lvl > 0.5 the trailing (style) ranks and drops the residual;
    0.5 is the identity. The result keeps each sample's standard deviation."""

    def __init__(self, max_drop_rank=(1, 5), q: int = 20):
        self.max_semantic_drop_rank = max_drop_rank[0]
        self.max_style_drop_rank = max_drop_rank[1]
        self.q = q

    def _sem_weights(self, lvl: float) -> np.ndarray:
        t0, y00 = np.exp((0 - 0.5) * 2), -self.max_semantic_drop_rank
        t1, y01 = np.exp((0.5 - 0.5) * 2), 1.0
        y0 = (np.exp((lvl - 0.5) * 2) - t0) / (t1 - t0) * (y01 - y00) + y00
        w = np.ones(self.q, np.float32)
        x1 = self.max_semantic_drop_rank + 1
        for xi in range(0, self.max_semantic_drop_rank + 1):
            yi = (xi - 0) / (x1 - 0) * (1.0 - y0) + y0
            w[xi] = max(yi, 0.0)
        return w

    def _sty_weights(self, lvl: float) -> np.ndarray:
        t0, y00 = np.exp((1 - 0.5) * 2), -(self.q - self.max_style_drop_rank)
        t1, y01 = np.exp((0.5 - 0.5) * 2), 1.0
        y0 = (np.exp((lvl - 0.5) * 2) - t0) / (t1 - t0) * (y01 - y00) + y00
        w = np.ones(self.q, np.float32)
        x0, x1 = self.q - 1, self.max_style_drop_rank - 1
        for xi in range(self.max_style_drop_rank, self.q):
            yi = (xi - x0) / (x1 - x0) * (1.0 - y0) + y0
            w[xi] = max(yi, 0.0)
        return w

    def __call__(self, x, lvl: float):
        """x [B, N, D] tokens -> the filtered tokens in x's dtype."""
        if lvl == 0.5:
            return x
        if not 0 <= lvl <= 1:
            raise ValueError(f"focus level {lvl} outside [0, 1]")
        x32 = x.float()
        std_save = x32.std(dim=(-2, -1), correction=0)
        u, s, vt, x_mean, x_remain = _decompose(x32, self.q)
        weights = self._sem_weights(lvl) if lvl < 0.5 else self._sty_weights(lvl)
        s = s * torch.as_tensor(weights[:s.shape[-1]], device=x.device)
        if lvl > 0.5:
            x_remain = 0.0
        x_new = torch.einsum("bnq,bq,bqd->bnd", u, s, vt) + x_mean + x_remain
        std_new = x_new.std(dim=(-2, -1), correction=0)
        x_new = x_new / std_new[:, None, None] * std_save[:, None, None]
        return x_new.to(x.dtype)


def color_adjust_simple(imout, ref_image):
    """Match each channel's mean and standard deviation of NHWC outputs in
    [0, 1] to those of the reference image, then clip to [0, 1]."""
    stats = lambda t: (t.mean(dim=(1, 2), keepdim=True),
                       t.std(dim=(1, 2), keepdim=True, correction=0))
    ref_mean, ref_std = stats(ref_image)
    out_mean, out_std = stats(imout)
    return ((imout - out_mean) / out_std * ref_std + ref_mean).clamp(0.0, 1.0)


def remove_duplicate_word(tx: str) -> str:
    """Iteratively collapse repeated n-gram runs in a sampled caption: words
    first, then runs of 2, 3, ... words, with leading brackets and trailing
    punctuation split off as their own items (``<puncnext>`` markers) and
    glued back at the end."""
    if tx == "":
        return tx

    def split_and_puncsplit(text: str) -> list[str]:
        out = []
        for word in text.split(" "):
            pre, post = [], []
            while word and word[0] in "([{":
                pre += [word[0], "<puncnext>"]
                word = word[1:]
            while word and word[-1] in "?!.,:;}])":
                post = ["<puncnext>", word[-1]] + post
                word = word[:-1]
            out += pre + ([word] if word else []) + post
        return out

    def remove_duplicates(items: list[str], length: int) -> list[str]:
        changed = True
        while changed:
            changed = False
            for i in range(len(items) - length):
                if items[i] == items[i + length]:
                    del items[i + 1:i + 1 + length]
                    changed = True
                    break
        return items

    items = split_and_puncsplit(tx)
    length = 1
    while len(items) > 1:
        items = remove_duplicates(items, length)
        if len(items) > 1:
            # each unit grows by its right neighbour's length-th word
            items = [items[i] + " " + _last_word(items[i + 1], length)
                     for i in range(len(items) - 1)]
            length += 1
    out = items[0] if items else ""
    return out.replace(" <puncnext> ", "")


def _last_word(s: str, length: int) -> str:
    parts = s.split(" ")
    return parts[length - 1] if parts else s
