"""Exponential moving average of parameters (``vdtpu/training/ema.py``).

Warmup-aware decay min(decay, (1 + n) / (10 + n)), n the new update count,
computed in f32 as the JAX package computes it. The shadow is a dict of
tensors beside the parameters, updated in place (one ``_foreach_lerp_``
over the whole tree) where the JAX package returns a new tree.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch


@dataclasses.dataclass
class EmaState:
    shadow: dict[str, torch.Tensor]
    num_updates: int  # -1: no warmup (fixed decay)


def ema_init(params: Mapping[str, torch.Tensor], use_num_updates: bool = True) -> EmaState:
    return EmaState({k: p.detach().clone() for k, p in params.items()},
                    0 if use_num_updates else -1)


@torch.no_grad()
def ema_update(state: EmaState, params: Mapping[str, torch.Tensor],
               decay: float = 0.9999) -> EmaState:
    """shadow <- shadow - (1 - d) * (shadow - param), in place; returns state."""
    n = state.num_updates
    new_n = n + 1 if n >= 0 else n
    d = np.float32(decay)
    if new_n >= 0:
        d = min(d, np.float32(1 + new_n) / np.float32(10 + new_n))
    one_minus = float(np.float32(1.0) - d)
    keys = list(state.shadow)
    torch._foreach_lerp_([state.shadow[k] for k in keys], [params[k].detach() for k in keys],
                         one_minus)
    state.num_updates = new_n
    return state


def ema_params(state: EmaState) -> dict[str, torch.Tensor]:
    """The averaged params (for eval)."""
    return state.shadow
