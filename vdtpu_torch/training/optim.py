"""Optimizer factory with parameter groups (``vdtpu/training/optim.py``).

``get_optimizer(type, params, pg_lrscale, freeze, **kw)`` returns
``(optimizer, set_lr)`` over a dict of named parameters (the flat names of
``VDModel.named_parameters``). It equals the JAX package's optax chain step
for step:
- one parameter group per ``pg_lrscale`` entry and one "default" group (at
  scale 1) for every other parameter; ``set_lr(optimizer, lr)`` pushes the
  scheduler's lr and each group steps at lr * its scale
  (``inject_hyperparams``);
- frozen groups (``freeze``: ``parameter_group_of`` labels) are left out:
  they hold no state and never move (``optax.set_to_zero``);
- every other parameter steps each time, including those the flow never
  touches (no gradient: optax sees zeros), so Adam's moments decay and
  AdamW's weight decay applies to them too, where ``torch.optim.AdamW``
  would skip them;
- AdamW is ``scale_by_adam`` -> ``add_decayed_weights`` ->
  ``scale_by_learning_rate``: p -= lr * (mu_hat / (sqrt(nu_hat) + eps) +
  wd * p), bias corrections 1 - b**count in f32 as optax takes them;
  ``mu_dtype`` stores the first moment only in that dtype (nu stays f32)
  and the update reads it before the cast, as optax does; "adam" is the
  same without decay;
- "sgd" is ``optax.sgd``: a momentum trace t = g + momentum * t (Nesterov:
  g + momentum * t), p -= lr * t;
- bf16 parameters (bf16 master weights, ``params_dtype``) keep both
  moments in bf16, as optax's ``zeros_like`` gives them, and take optax's
  arithmetic in that dtype, every operation rounded and every constant
  (b1, 1 - b1, b2, 1 - b2, the bias corrections, eps, the decay and the
  lr) rounded to bf16 first: bit-equal to the JAX package's jitted update.
``params`` may be the trainable context encoder's tree, ``{"diffuser":
{name: tensor}, "ctx": {name: tensor}}``: its leaves are named
"diffuser.<name>" and "ctx.<name>", and the context encoder's fall in the
group "ctx_<first part of the name>", as the JAX package labels them.
The updates are ``torch._foreach_*`` passes over chunks of the group, so the
temporaries stay small beside the moments.
"""
from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch

_CHUNK = 1 << 27  # elements of parameters per foreach pass (bounds the temporaries)
_EPS = 1e-8       # optax's Adam eps (vdtpu passes none)


def parameter_group_of(path) -> str:
    """VD parameter groups, diffuser_<name>_<part> (ref vd.py:108-112), for a
    flat parameter name ("image.data_blocks.3.0.in_layers.0.weight") or its
    tuple of parts: <name> is the diffuser, <part> global (time_embed), data,
    context or other. A trainable context encoder's "ctx.<part>..." is
    ctx_<part>."""
    if isinstance(path, str):
        path = tuple(path.split("."))
    if path[0] == "ctx":
        return f"ctx_{path[1] if len(path) > 1 else 'all'}"
    if path[0] == "diffuser" and len(path) > 1:
        path = path[1:]
    name = path[0]
    head = path[1] if len(path) > 1 else ""
    if head.startswith("time_embed"):
        part = "global"
    elif head.startswith("data_blocks"):
        part = "data"
    elif head.startswith("context_blocks"):
        part = "context"
    else:
        part = "other"
    return f"diffuser_{name}_{part}"


def _chunks(params: list[torch.Tensor]):
    """Consecutive runs of params of at most _CHUNK elements (one at least)."""
    run, size = [], 0
    for i, p in enumerate(params):
        if run and size + p.numel() > _CHUNK:
            yield run
            run, size = [], 0
        run.append(i)
        size += p.numel()
    if run:
        yield run


class AdamW(torch.optim.Optimizer):
    """optax.adamw (weight_decay > 0) or optax.adam (0), with each group's
    lr = group["lr"] * group["lr_scale"]; see the module docstring."""

    def __init__(self, params, lr: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                 weight_decay: float = 0.0, mu_dtype: torch.dtype | None = None):
        super().__init__(params, dict(lr=lr, lr_scale=1.0, b1=b1, b2=b2,
                                      weight_decay=weight_decay, count=0))
        self.mu_dtype = mu_dtype

    def _state(self, p):
        st = self.state[p]
        if not st:
            low = p.dtype != torch.float32   # optax: the moments in the param dtype
            st["mu"] = torch.zeros_like(p, dtype=p.dtype if low else self.mu_dtype or p.dtype)
            st["nu"] = torch.zeros_like(p)
        return st

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict)
        if self.mu_dtype is not None:  # the base class casts state to the param dtype
            for p, st in self.state.items():
                if p.dtype == torch.float32:
                    st["mu"] = st["mu"].to(self.mu_dtype)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        for group in self.param_groups:
            group["count"] += 1
            b1, b2, n = group["b1"], group["b2"], group["count"]
            lr = group["lr"] * group["lr_scale"]
            bc1, bc2 = (float(np.float32(1) - np.float32(b) ** np.int32(n)) for b in (b1, b2))
            params = [p for p in group["params"] if p.dtype == torch.float32]
            low = [p for p in group["params"] if p.dtype != torch.float32]
            for idx in _chunks(low):
                self._step_low(group, [low[i] for i in idx], bc1, bc2)
            for idx in _chunks(params):
                ps = [params[i] for i in idx]
                sts = [self._state(p) for p in ps]
                nus = [st["nu"] for st in sts]
                if self.mu_dtype is None:
                    mus = [st["mu"] for st in sts]
                    torch._foreach_mul_(mus, b1)
                else:  # optax: b1 * mu in mu's dtype (b1 rounded to it first), the
                    # rest and the update in f32
                    b1_mu = float(torch.tensor(b1).to(self.mu_dtype))
                    mus = [m.float() for m in torch._foreach_mul([st["mu"] for st in sts], b1_mu)]
                with_g = [i for i, p in enumerate(ps) if p.grad is not None]
                no_g = [i for i, p in enumerate(ps) if p.grad is None]
                grads = [ps[i].grad for i in with_g]
                if with_g:
                    v = [nus[i] for i in with_g]
                    torch._foreach_add_([mus[i] for i in with_g], grads, alpha=1 - b1)
                    torch._foreach_mul_(v, b2)
                    torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
                if no_g:  # a zero gradient
                    torch._foreach_mul_([nus[i] for i in no_g], b2)
                denom = torch._foreach_div(nus, bc2)
                torch._foreach_sqrt_(denom)
                torch._foreach_add_(denom, _EPS)
                upd = torch._foreach_div(mus, bc1)
                torch._foreach_div_(upd, denom)
                del denom
                if group["weight_decay"]:
                    torch._foreach_add_(upd, ps, alpha=group["weight_decay"])
                torch._foreach_add_(ps, upd, alpha=-lr)
                if self.mu_dtype is not None:
                    for st, m in zip(sts, mus):
                        st["mu"].copy_(m)
        return None

    def _step_low(self, group, ps, bc1: float, bc2: float):
        """optax's adam(w) on low-precision parameters and moments: each
        operation in the parameter dtype, constants rounded to it first."""
        dt = ps[0].dtype
        c = lambda v: float(torch.tensor(v, dtype=torch.float32).to(dt))
        b1, b2 = group["b1"], group["b2"]
        sts = [self._state(p) for p in ps]
        mus, nus = [st["mu"] for st in sts], [st["nu"] for st in sts]
        torch._foreach_mul_(mus, c(b1))
        torch._foreach_mul_(nus, c(b2))
        with_g = [i for i, p in enumerate(ps) if p.grad is not None]
        if with_g:   # (1 - b) * g + b * m; a zero gradient adds an exact 0
            grads = [ps[i].grad.to(dt) for i in with_g]
            torch._foreach_add_([mus[i] for i in with_g], torch._foreach_mul(grads, c(1 - b1)))
            g2 = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(g2, c(1 - b2))
            torch._foreach_add_([nus[i] for i in with_g], g2)
            del g2, grads
        denom = torch._foreach_div(nus, c(bc2))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, c(_EPS))
        upd = torch._foreach_div(mus, c(bc1))
        torch._foreach_div_(upd, denom)
        del denom
        if group["weight_decay"]:
            torch._foreach_add_(upd, torch._foreach_mul(ps, c(group["weight_decay"])))
        torch._foreach_mul_(upd, -c(c(group["lr"]) * c(group["lr_scale"])))
        torch._foreach_add_(ps, upd)


class SGD(torch.optim.Optimizer):
    """optax.sgd: momentum trace (None or 0: plain SGD), optional Nesterov."""

    def __init__(self, params, lr: float = 0.0, momentum: float = 0.0,
                 nesterov: bool = False):
        super().__init__(params, dict(lr=lr, lr_scale=1.0, momentum=momentum,
                                      nesterov=nesterov))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("SGD.step takes no closure")
        for group in self.param_groups:
            lr = group["lr"] * group["lr_scale"]
            mom = group["momentum"]
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                if mom:
                    t = self.state[p].setdefault("trace", torch.zeros_like(p))
                    t.mul_(mom).add_(g)
                    g = g + mom * t if group["nesterov"] else t
                p.add_(g, alpha=-lr)
        return None


def _make(type: str, groups, **kw) -> torch.optim.Optimizer:
    if type in ("adam", "adamw"):
        mu = kw.get("mu_dtype")
        mu = getattr(torch, mu) if isinstance(mu, str) else mu
        return AdamW(groups, b1=kw.get("b1", 0.9), b2=kw.get("b2", 0.999),
                     weight_decay=kw.get("weight_decay", 1e-2) if type == "adamw" else 0.0,
                     mu_dtype=mu)
    if type == "sgd":
        return SGD(groups, momentum=kw.get("momentum", 0.0), nesterov=kw.get("nesterov", False))
    raise KeyError(f"unknown optimizer {type!r}")


def get_optimizer(type: str = "adamw", params: Mapping[str, torch.Tensor] | None = None,
                  pg_lrscale: Mapping[str, float] | None = None,
                  freeze: tuple[str, ...] | list[str] | None = None,
                  **kw) -> tuple[torch.optim.Optimizer, Callable]:
    """(optimizer, set_lr) over the named ``params``; ``set_lr(optimizer, lr)``
    sets every group's lr and returns the optimizer."""
    from vdtpu_torch.training.ema import tree_items
    pg_lrscale = dict(pg_lrscale or {})
    freeze = tuple(freeze or ())
    groups: dict[str, list] = {}
    for name, p in tree_items(params or {}):
        g = parameter_group_of(name)
        if g in freeze:
            continue
        groups.setdefault(g if g in pg_lrscale else "default", []).append(p)
    param_groups = [dict(params=ps, lr_scale=float(pg_lrscale.get(label, 1.0)), label=label)
                    for label, ps in groups.items()]
    opt = _make(type, param_groups, **kw)

    def set_lr(optimizer, lr):
        for group in optimizer.param_groups:
            group["lr"] = lr
        return optimizer
    return opt, set_lr
