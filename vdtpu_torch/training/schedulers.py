"""Indexable LR schedulers (``vdtpu/training/schedulers.py``, pure Python;
the port keeps its own copy).

Schedulers are indexable (``sched[itern] -> lr``), composable sequentially,
and support per-parameter-group LR scaling (``pg_lrscale``). The LDM-style
schedules scale by the global batch size x grad-accum, with the batch size
an explicit argument.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

_REG: dict[str, type] = {}


def register_scheduler(name):
    def deco(cls):
        _REG[name] = cls
        return cls
    return deco


def get_scheduler(cfg: Mapping | None, **ctx):
    if cfg is None:
        return None
    cfg = dict(cfg)
    typ = cfg.pop("type")
    if typ not in _REG:
        raise KeyError(f"unknown scheduler {typ!r}")
    return _REG[typ](**cfg, **ctx)


class _Base:
    step_num: int

    def __getitem__(self, idx: int) -> float:
        raise NotImplementedError

    def set_lr(self, optim_or_fn, idx: int):
        return self[idx]


@register_scheduler("constant")
class ConstantScheduler(_Base):
    def __init__(self, lr: float, num_itr: int = int(1e9), **_):
        self.lr, self.step_num = lr, num_itr

    def __getitem__(self, idx):
        return self.lr


@register_scheduler("poly")
class PolyScheduler(_Base):
    """lr decays polynomially from start to end over num_itr (ref :70-93)."""
    def __init__(self, start_lr: float, end_lr: float, num_itr: int, power: float = 1.0, **_):
        self.start_lr, self.end_lr = start_lr, end_lr
        self.step_num, self.power = num_itr, power

    def __getitem__(self, idx):
        a = min(max(idx / max(self.step_num - 1, 1), 0.0), 1.0)
        return self.end_lr + (self.start_lr - self.end_lr) * (1 - a) ** self.power


@register_scheduler("linear")
class LinearScheduler(PolyScheduler):
    def __init__(self, start_lr, end_lr, num_itr, **_):
        super().__init__(start_lr, end_lr, num_itr, power=1.0)


@register_scheduler("multistage")
class MultiStageScheduler(_Base):
    """Piecewise-constant: lr_base * gamma^stage at given milestones (ref :95-125)."""
    def __init__(self, start_lr: float, milestones: Sequence[int], gamma: float,
                 num_itr: int, **_):
        self.start_lr = start_lr
        self.milestones = sorted(milestones)
        self.gamma, self.step_num = gamma, num_itr

    def __getitem__(self, idx):
        power = sum(1 for m in self.milestones if idx >= m)
        return self.start_lr * (self.gamma ** power)


@dataclasses.dataclass
class SequentialScheduler(_Base):
    """Concatenate schedulers back-to-back (ref constructor :127-145)."""
    schedulers: Sequence[_Base]

    def __post_init__(self):
        self.step_num = sum(s.step_num for s in self.schedulers)

    def __getitem__(self, idx):
        for s in self.schedulers:
            if idx < s.step_num:
                return s[idx]
            idx -= s.step_num
        return self.schedulers[-1][self.schedulers[-1].step_num - 1]


@register_scheduler("ldm_warmup_cosine")
class LambdaWarmUpCosineScheduler(_Base):
    """LDM warmup->cosine multiplier x base_lr (ref :151-190)."""
    def __init__(self, base_lr: float, warm_up_steps: int, lr_min: float,
                 lr_max: float, lr_start: float, max_decay_steps: int, **_):
        self.base_lr = base_lr
        self.warm = warm_up_steps
        self.lr_min, self.lr_max, self.lr_start = lr_min, lr_max, lr_start
        self.max_decay = max_decay_steps
        self.step_num = max_decay_steps

    def multiplier(self, n):
        if n < self.warm:
            return (self.lr_max - self.lr_start) / self.warm * n + self.lr_start
        t = (n - self.warm) / (self.max_decay - self.warm)
        t = min(t, 1.0)
        return self.lr_min + 0.5 * (self.lr_max - self.lr_min) * (
            1 + np.cos(t * np.pi))

    def __getitem__(self, idx):
        return self.base_lr * self.multiplier(idx)


@register_scheduler("stable_diffusion_linear")
class StableDiffusionLinearScheduler(_Base):
    """Constant lr scaled by global batch x grad-accum (ref :246-262)."""
    def __init__(self, base_lr: float, num_itr: int = int(1e9),
                 global_batch_size: int = 1, gradacc_every: int = 1, **_):
        self.lr = base_lr * global_batch_size * gradacc_every
        self.step_num = num_itr

    def __getitem__(self, idx):
        return self.lr


def with_pg_lrscale(scheduler: _Base, pg_scales: Mapping[str, float]):
    """Per-parameter-group LR: {group_name: scale} (ref :54-68).
    Returns {group: callable idx->lr}."""
    return {g: (lambda idx, s=s: scheduler[idx] * s) for g, s in pg_scales.items()}
