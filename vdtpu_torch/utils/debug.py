"""Numerical guards (``vdtpu/utils/debug.py``).

- ``assert_all_finite(tree, name)``: raise ``FloatingPointError`` naming
  the leaves that hold a NaN or an Inf (the JAX package's message).
- ``checked(fn)``: ``fn`` under a ``TorchDispatchMode`` that looks at every
  op, raising ``FloatingPointError`` where ``jax.experimental.checkify``'s
  ``float_checks`` raises: a division by zero (float or integer, 0/0
  included, with checkify's message), and any op whose result holds a NaN
  (log(-1), inf - inf; checkify flags an op that passes a NaN on, too).
  The check reads each result on the host (a device synchronization an
  op), so it is for finding a fault, not for a timed run. Kernels launched
  through ctypes run outside the dispatcher; the ops around them are
  checked.
- ``debug_nan_hook(x, name)``: a print when a tensor is not finite; returns x.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_DIVS = {"div", "div_", "true_divide", "remainder", "fmod", "floor_divide"}
_UNINITIALIZED = ("empty", "new_empty")


def _tree_items(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_items(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_items(v, f"{path}/{i}" if path else str(i))
    else:
        yield path, tree


def assert_all_finite(tree, name: str = "tree"):
    """Raise on NaN/Inf anywhere in a (nested) dict / list of tensors."""
    bad = []
    for path, leaf in _tree_items(tree):
        t = torch.as_tensor(leaf)
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            bad.append(path)
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad[:10]}")


def _floats(xs):
    return [x for x in tree_flatten(xs)[0] if torch.is_tensor(x) and x.is_floating_point()]


class _FloatChecks(TorchDispatchMode):
    """checkify's float_checks over every op: a division by zero, a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name.startswith(_UNINITIALIZED):    # fresh memory: its bits mean nothing yet
            return func(*args, **kwargs)
        den = args[1] if name in _DIVS and len(args) > 1 else (
            args[0] if name in ("reciprocal", "reciprocal_") else None)
        if den is not None and (bool((den == 0).any()) if torch.is_tensor(den) else den == 0):
            raise FloatingPointError(f"division by zero in {name}")
        out = func(*args, **kwargs)
        if any(bool(torch.isnan(o).any()) for o in _floats(out)):
            raise FloatingPointError(f"nan generated by primitive: {name}")
        return out


def checked(fn: Callable) -> Callable:
    """``fn`` with every op checked for a division by zero or a NaN."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _FloatChecks():
            return fn(*args, **kwargs)
    return wrapper


def debug_nan_hook(x, name: str = "tensor"):
    """Print the count of non-finite elements of x when there are any."""
    bad = int((~torch.isfinite(x)).sum())
    if bad:
        print(f"NaN/Inf in {name}: {bad} elements")
    return x
