"""Token merging (ToMe) at the long self-attention sites
(``vdtpu/ops/tome.py``): an opt-in approximate serving mode.

The ToMe-for-Stable-Diffusion recipe (Bolya & Hoffman, arXiv 2303.17604)
with fixed merge counts:
- tokens split into ``dst`` (one per 2x2 patch of a square even map, else
  every 4th token) and ``src`` (the rest);
- each src token's nearest dst by cosine similarity on the block input;
- the ``r`` most similar src tokens are averaged into their dst, the
  self-attention runs on the remaining N - r tokens, and on unmerge every
  merged token reads its dst's output.

The spec is configuration of the system (``VDSystem.enable_tome``), not a
process global. ``ToMeWalk`` is the state of one UNet walk: the first
eligible site of a walk computes the assignment for its (batch, tokens)
and later sites of that size reuse it, as the JAX package's per-walk
cache does; the walk object is dropped when the walk ends.

Under int8 the calibrated logit bound stays a valid upper bound: merged
tokens are convex combinations, and mean(q) . mean(k) <= max_ij q_i . k_j.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ToMeSpec:
    """ratio: fraction of all tokens merged away at an eligible site, capped
    at the src partition (3/4 of the tokens). min_tokens: shorter sites are
    untouched (default: only the 64x64 = 4096-token maps)."""
    ratio: float = 0.5
    min_tokens: int = 4096

    def __post_init__(self):
        if not 0.0 <= self.ratio < 1.0:
            raise ValueError(f"tome ratio must be in [0, 1), got {self.ratio}")


def _partition(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Static (dst_idx, src_idx) for an n-token site."""
    h = math.isqrt(n)
    if h * h == n and h % 2 == 0:
        dst = np.arange(n).reshape(h, h)[0::2, 0::2].reshape(-1)
    else:
        dst = np.arange(0, n, 4)
    mask = np.ones(n, bool)
    mask[dst] = False
    return dst.astype(np.int64), np.nonzero(mask)[0].astype(np.int64)


def merge_count(n: int, ratio: float) -> int:
    """Merged-token count r for an n-token site: capped at the src partition
    and, for n >= 2048, rounded down so n - r is a multiple of 256."""
    _, src_idx = _partition(n)
    r = min(int(n * ratio), len(src_idx))
    align = 256 if n >= 2048 else 1
    return max(r - (-(n - r)) % align, 0)


def build_merge(x, spec: ToMeSpec):
    """The merge of one call from the block input x [B, N, C]: (merge,
    unmerge, n_reduced), closures that apply the same assignment to any
    [B, N, C'] tensor / its [B, n_reduced, C'] attention output."""
    b, n, _ = x.shape
    r = merge_count(n, spec.ratio)
    if r == 0:
        return (lambda h: h), (lambda a: a), n
    dst_np, src_np = _partition(n)
    dst_idx = torch.from_numpy(dst_np).to(x.device)
    src_idx = torch.from_numpy(src_np).to(x.device)
    ns, nd = len(src_np), len(dst_np)

    xm = x.float()
    xm = xm / (torch.linalg.vector_norm(xm, dim=-1, keepdim=True) + 1e-6)
    scores = torch.einsum("bsc,bdc->bsd", xm[:, src_idx], xm[:, dst_idx])
    best_val, best_dst = scores.max(dim=-1)                       # [B, Ns]
    order = torch.argsort(-best_val, dim=-1, stable=True)
    merged_pos, kept_pos = order[:, :r], order[:, r:]
    dst_of = torch.gather(best_dst, 1, merged_pos)                # [B, r]

    def rows(t, idx):
        return torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1]))

    # merged source j of row b lands on destination dst_of[b, j]: the sum
    # into each destination is a product with this one-hot [B, nd, r], summed
    # in f32 in an order the shapes fix (atomic adds of scatter_add_ land in
    # any order on a card), so a row's merge is the same from run to run and
    # whatever its co-riders. A 16-bit input on the card takes a one-hot of
    # its own type (0 and 1 are exact) and the tensor cores' products summed
    # in f32 (bmm's out_dtype, a CUDA op); elsewhere the product is in f32.
    low = x.is_cuda and x.dtype in (torch.bfloat16, torch.float16)
    onehot = torch.zeros((b, nd, r), dtype=x.dtype if low else torch.float32, device=x.device)
    onehot.scatter_(1, dst_of[:, None], 1.0)
    counts = onehot.sum(dim=-1, dtype=torch.float32)              # exact: sums of ones

    def merge(h):
        hsrc, hdst = h[:, src_idx], h[:, dst_idx]
        src = rows(hsrc, merged_pos)
        add = (torch.bmm(onehot, src.to(onehot.dtype), out_dtype=torch.float32) if low
               else torch.bmm(onehot, src.float()))
        hdst = ((hdst.float() + add) / (1.0 + counts[..., None])).to(h.dtype)
        return torch.cat([rows(hsrc, kept_pos), hdst], dim=1)    # [B, N - r, C]

    # which reduced row each original token reads
    inv_src = torch.empty((b, ns), dtype=torch.int64, device=x.device)
    inv_src.scatter_(1, kept_pos, torch.arange(ns - r, device=x.device).expand(b, -1))
    inv_src.scatter_(1, merged_pos, (ns - r) + dst_of)
    inv = torch.empty((b, n), dtype=torch.int64, device=x.device)
    inv[:, src_idx] = inv_src
    inv[:, dst_idx] = (ns - r) + torch.arange(nd, device=x.device)

    def unmerge(a):
        return rows(a, inv)

    return merge, unmerge, n - r


class ToMeWalk:
    """Token-merging state of one UNet walk: the spec and the merges built
    so far, one per (batch, tokens)."""

    def __init__(self, spec: ToMeSpec):
        self.spec = spec
        self._merges: dict[tuple[int, int], tuple] = {}

    def applies(self, x) -> bool:
        return x.shape[1] >= self.spec.min_tokens

    def merge(self, x):
        """build_merge(x, spec), reused by later sites of the same size."""
        key = (x.shape[0], x.shape[1])
        ent = self._merges.get(key)
        if ent is None:
            ent = self._merges[key] = build_merge(x, self.spec)
        return ent
