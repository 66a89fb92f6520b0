"""Checkpoint save/restore (``vdtpu/training/checkpoints.py``): orbax becomes
``torch.save`` / ``torch.load`` of one file per tag, ``<ckpt_dir>/<tag>.pt``.

A checkpoint holds the parameters, the optimizer's state dict, the EMA
(shadow and update count) and the step, as the JAX package's does. Saves
are synchronous and atomic (written to a temporary file, then renamed);
loads read tensors only (``weights_only=True``).
"""
from __future__ import annotations

import os
import re
from typing import Any

import torch


def checkpoint_path(ckpt_dir: str, tag: str) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"{tag}.pt")


def save_checkpoint(ckpt_dir: str, tag: str, state) -> str:
    """state: ``vdtpu_torch.training.harness.TrainState``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, tag)
    payload = {
        "params": {k: v.detach() for k, v in state.params.items()},
        "opt_state": state.opt_state.state_dict(),
        "ema": None if state.ema is None else
            {"shadow": state.ema.shadow, "num_updates": state.ema.num_updates},
        "step": state.step,
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(ckpt_dir: str, tag: str, map_location=None) -> dict[str, Any]:
    return torch.load(checkpoint_path(ckpt_dir, tag), map_location=map_location,
                      weights_only=True)


def latest_tag(ckpt_dir: str) -> str:
    """Most recent checkpoint tag in a run dir: ``last``, else the highest
    ``iter_N``, else ``best``."""
    tags = [f[:-3] for f in os.listdir(ckpt_dir) if f.endswith(".pt")]
    if "last" in tags:
        return "last"
    iters = sorted((int(m.group(1)), t) for t in tags
                   if (m := re.fullmatch(r"iter_(\d+)", t)))
    if iters:
        return iters[-1][1]
    if "best" in tags:
        return "best"
    raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
