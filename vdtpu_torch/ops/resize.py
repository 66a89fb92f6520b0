"""Bicubic and bilinear image resize, the port's copy of
``jax.image.resize(..., "bicubic" | "bilinear")``.

JAX resamples with ``scale_and_translate``: for each resized axis a weight
matrix [in, out] whose column j holds the kernel at the distances from
output sample (j + 0.5) / scale - 0.5 to every input pixel, the kernel
stretched by 1 / scale when downsampling (antialiasing), each column
renormalised to sum 1 (which also renormalises at the edges), and columns
whose sample falls outside the input zeroed. The bicubic kernel is Keys'
cubic with a = -0.5, the bilinear one the triangle max(0, 1 - |x|).
``F.interpolate`` takes a = -0.75 for the cubic and treats the edges
otherwise, with ``antialias=True`` too, so the port builds the same
matrices and applies them as one contraction per axis. Plain PyTorch, no
kernel: the TPU package has none either.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


_KERNELS = {"bicubic": _keys_cubic, "bilinear": _triangle}


@functools.lru_cache(maxsize=64)
def weight_matrix(in_size: int, out_size: int, method: str = "bicubic") -> np.ndarray:
    """[in_size, out_size] f32 resampling weights of one axis
    (``jax._src.image.scale.compute_weight_mat``, translation 0)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))  # JAX divides in Python floats
    kernel_scale = max(inv_scale, f32(1.0))       # antialiasing when downsampling
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = _KERNELS[method](x).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32)


def resize(x, hw, method: str = "bicubic"):
    """[B, H, W, C] -> [B, hw[0], hw[1], C] in f32 (JAX's result type for a
    float input); an axis already at its size is left as it is."""
    if method not in _KERNELS:
        raise ValueError(f"unknown resize method {method!r}")
    x = torch.as_tensor(x).float()
    for axis, size in ((1, int(hw[0])), (2, int(hw[1]))):
        if x.shape[axis] == size:
            continue
        w = torch.as_tensor(weight_matrix(x.shape[axis], size, method), device=x.device)
        x = torch.tensordot(x, w, dims=([axis], [0])).movedim(-1, axis)
    return x
