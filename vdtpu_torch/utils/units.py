"""Activation registry and parameter counts (``vdtpu/utils/units.py``).

``get_unit(name)``: a string-named activation for configurable layers
(``relu``, ``silu`` / ``swish``, ``gelu`` (tanh form, as ``jax.nn.gelu``
defaults), ``sigmoid``, ``tanh``, ``sine``, ``lrelu<slope>``,
``elu[<alpha>]``, and ``none`` / ``identity`` / None). ``get_total_param``
and ``get_total_param_sum``: the reference's parameter count and its cheap
weight fingerprint (the sum of every value in f32), over a module or a
(nested) dict of tensors.
"""
from __future__ import annotations

import re
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn


def get_unit(name: str | None) -> Callable:
    """String -> activation fn; parameterized forms like 'lrelu0.2'."""
    if name is None or name in ("none", "identity"):
        return lambda x: x
    fixed = {"relu": F.relu, "silu": F.silu, "swish": F.silu,
             "gelu": lambda x: F.gelu(x, approximate="tanh"), "sigmoid": torch.sigmoid,
             "tanh": torch.tanh, "sine": torch.sin}
    if name in fixed:
        return fixed[name]
    m = re.fullmatch(r"lrelu([\d.]+)", name)
    if m:
        slope = float(m.group(1))
        return lambda x: F.leaky_relu(x, slope)
    m = re.fullmatch(r"elu([\d.]*)", name)
    if m:
        alpha = float(m.group(1)) if m.group(1) else 1.0
        return lambda x: F.elu(x, alpha)
    raise KeyError(f"unknown unit {name!r}")


def _leaves(params):
    if isinstance(params, nn.Module):
        return [p for _, p in params.named_parameters()]
    from vdtpu_torch.training.ema import tree_items
    return [torch.as_tensor(v) for _, v in sorted(tree_items(params))]


def get_total_param(params) -> int:
    """Total parameter count of a module or a tree (ref get_total_param)."""
    return sum(int(p.numel()) for p in _leaves(params))


@torch.no_grad()
def get_total_param_sum(params) -> float:
    """Sum of all parameter values in f32 (ref get_total_param_sum): each
    leaf summed, then the leaves in name order."""
    total = torch.zeros((), dtype=torch.float32)
    for p in _leaves(params):
        total = total + p.float().sum().cpu()
    return float(total)
