"""Exponential moving average of parameters (``vdtpu/training/ema.py``).

Warmup-aware decay min(decay, (1 + n) / (10 + n)), n the new update count,
computed in f32 as the JAX package computes it. The shadow is a tree of
tensors beside the parameters (a dict by name, or the trainable context
encoder's ``{"diffuser": ..., "ctx": ...}`` of such dicts), updated in
place where the JAX package returns a new tree: one ``_foreach_lerp_``
over f32 leaves. A bf16 shadow (bf16 master parameters) takes the JAX
package's arithmetic in its own dtype, each operation rounded: 1 - d
rounded to bf16, then s - (1 - d) * (s - p). At d = 0.9999 a step moves a
leaf only where |s - p| exceeds about 40 of its ulps: smaller moves round
away, as they do in the JAX package.

A frozen parameter never moves, so its average equals it bit for bit:
``ema_init(..., alias=names)`` lets those leaves of the shadow share the
parameters' storage (no second copy on the device or in a checkpoint) and
``ema_update`` skips them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Mapping

import numpy as np
import torch


@dataclasses.dataclass
class EmaState:
    shadow: dict[str, Any]
    num_updates: int  # -1: no warmup (fixed decay)


def tree_items(tree: Mapping[str, Any], prefix: str = "") -> Iterator[tuple[str, torch.Tensor]]:
    """(dotted name, tensor) of every leaf of a nested dict of tensors."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from tree_items(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def tree_map(fn, tree: Mapping[str, Any]) -> dict[str, Any]:
    return {k: tree_map(fn, v) if isinstance(v, Mapping) else fn(v) for k, v in tree.items()}


def ema_init(params: Mapping[str, Any], use_num_updates: bool = True,
             alias=()) -> EmaState:
    """The shadow, a copy of ``params``; leaves named in ``alias`` (dotted
    names of frozen parameters) share the parameters' storage."""
    alias = set(alias)

    def init(tree, prefix=""):
        return {k: init(v, f"{prefix}{k}.") if isinstance(v, Mapping)
                else v.detach() if f"{prefix}{k}" in alias else v.detach().clone()
                for k, v in tree.items()}
    return EmaState(init(params), 0 if use_num_updates else -1)


@torch.no_grad()
def ema_update(state: EmaState, params: Mapping[str, Any], decay: float = 0.9999) -> EmaState:
    """shadow <- shadow - (1 - d) * (shadow - param), in place; returns state."""
    n = state.num_updates
    new_n = n + 1 if n >= 0 else n
    d = np.float32(decay)
    if new_n >= 0:
        d = min(d, np.float32(1 + new_n) / np.float32(10 + new_n))
    one_minus = float(np.float32(1.0) - d)
    live = dict(tree_items(params))
    by_dtype: dict[torch.dtype, tuple[list, list]] = {}
    for k, s in tree_items(state.shadow):
        p = live[k].detach()
        if s.data_ptr() == p.data_ptr():
            continue                  # a frozen leaf's shadow is the leaf
        shadows, ps = by_dtype.setdefault(s.dtype, ([], []))
        shadows.append(s)
        ps.append(p)
    for dt, (shadows, ps) in by_dtype.items():
        if dt == torch.float32:
            torch._foreach_lerp_(shadows, ps, one_minus)
        else:
            step = torch._foreach_sub(shadows, ps)
            torch._foreach_mul_(step, float(torch.tensor(one_minus).to(dt)))
            torch._foreach_sub_(shadows, step)
    state.num_updates = new_n
    return state


def ema_params(state: EmaState) -> dict[str, Any]:
    """The averaged params (for eval)."""
    return state.shadow
