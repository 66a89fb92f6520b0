"""Training harness (``vdtpu/training/harness.py``): the eps-loss train
step and the step-typed outer loop.

- ``make_loss_fn``: the model's ``p_losses`` on pre-encoded context (frozen
  encoders, the harness's default contract); ``freeze_groups`` turns off
  the gradients of the named parameter groups, so the backward neither
  computes nor keeps them (the JAX package's stop_gradient).
- ``make_train_step``: one optimizer update. The batch splits contiguously
  into ``grad_accum`` micro-batches; each runs forward and backward, the
  gradients sum in place and are divided by ``grad_accum`` before the
  single update, and the loss and metrics are averaged. Then the EMA.
  t and noise are taken as given (the tests hand in the JAX package's
  draws) or drawn for the whole batch from a ``torch.Generator``.
- ``Trainer``: iter / epoch / sample units, the lr pushed from an indexable
  scheduler each step (at ``step // grad_accum``, as the JAX package
  indexes it), logging cadence, ``eval_fn`` with a best-checkpoint keep,
  periodic and final checkpoints, ``restore`` and ``last_loss``. Each
  step's generator is seeded from (seed, step), so a restored run draws
  what the uninterrupted run would have drawn.

PyTorch keeps the parameters in the model: ``TrainState.params`` is the
dict of the live parameters by name (``VDModel.named_parameters``), which
the step updates in place, and ``opt_state`` is the optimizer that owns the
optimizer state. Not ported: the trainable context encoder
(``ctx_encode_fn``), the device mesh, async checkpoints and donation.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable, Mapping

import numpy as np
import torch

from vdtpu_torch.models.vd import VDModel
from vdtpu_torch.training.ema import EmaState, ema_init, ema_update
from vdtpu_torch.training.optim import parameter_group_of
from vdtpu_torch.utils.logging import MetricAccumulator, print_log


@dataclasses.dataclass
class TrainState:
    params: dict[str, torch.Tensor]
    opt_state: torch.optim.Optimizer
    ema: EmaState | None
    step: int = 0


def _check_trainable(model: VDModel) -> None:
    """Training runs the exact path: the int8 serving policy and token
    merging are forward-only."""
    if model.diffuser.tome is not None:
        raise RuntimeError("training with token merging on: call enable_tome(0) first")
    if any(getattr(m, "policy", None) is not None for m in model.diffuser.modules()):
        raise RuntimeError("training under the int8 serving policy: call "
                           "set_quant_policy(None) first")


def make_loss_fn(model: VDModel, x_type: str, c_type: str,
                 freeze_groups: tuple[str, ...] = ()):
    """loss_fn(x, ctx, t, noise) -> (loss, aux) on the model's parameters;
    the parameters of ``freeze_groups`` (``parameter_group_of`` labels) stop
    requiring gradients here."""
    _check_trainable(model)
    fz = tuple(freeze_groups)
    for name, p in model.named_parameters():
        if parameter_group_of(name) in fz:
            p.requires_grad_(False)

    def loss_fn(x, ctx, t, noise):
        return model.p_losses(x, t, ctx, x_type, c_type, noise)
    return loss_fn


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one step's t and noise, seeded from (seed, step)."""
    s = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s)


def make_train_step(model: VDModel, optimizer: torch.optim.Optimizer,
                    x_type: str = "image", c_type: str = "text",
                    ema_decay: float | None = None, grad_accum: int = 1,
                    freeze_groups: tuple[str, ...] = ()):
    """step(state, x, ctx, t=None, noise=None, gen=None) -> (loss, aux):
    one update of ``state`` in place. x [B, ...] in the model's layout, ctx
    [B, L, C]; t [B] and noise like x, or both None and drawn from ``gen``.
    The lr is whatever ``set_lr`` last pushed."""
    loss_fn = make_loss_fn(model, x_type, c_type, freeze_groups)
    n_t = model.schedule.num_timesteps

    def step(state: TrainState, x, ctx, t=None, noise=None, gen=None):
        b = x.shape[0]
        if b % grad_accum:
            raise ValueError(f"batch {b} does not split into {grad_accum} micro-batches")
        if t is None:
            t = torch.randint(0, n_t, (b,), generator=gen, device=x.device)
            noise = torch.randn(x.shape, generator=gen, device=x.device, dtype=x.dtype)
        optimizer.zero_grad(set_to_none=True)
        mb = b // grad_accum
        losses, auxs = [], []
        for i in range(grad_accum):
            sl = slice(i * mb, (i + 1) * mb)
            loss, aux = loss_fn(x[sl], ctx[sl], t[sl], noise[sl])
            loss.backward()
            losses.append(loss.detach())
            auxs.append({k: v.detach() for k, v in aux.items()})
        if grad_accum > 1:
            grads = [p.grad for p in state.params.values() if p.grad is not None]
            torch._foreach_div_(grads, float(grad_accum))
        optimizer.step()
        if ema_decay is not None:
            ema_update(state.ema, state.params, ema_decay)
        loss = torch.stack(losses).mean()
        aux = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
        return loss, aux

    return step


class Trainer:
    """The step-typed outer loop (ref train_stage, utils.py:61-307)."""

    def __init__(self, model: VDModel, params: Mapping[str, torch.Tensor],
                 optimizer: torch.optim.Optimizer, set_lr: Callable, scheduler=None,
                 x_type: str = "image", c_type: str = "text",
                 ema_decay: float | None = None, grad_accum: int = 1,
                 log_every: int = 100, ckpt_every: int | None = None,
                 ckpt_dir: str | None = None, eval_fn: Callable | None = None,
                 eval_every: int | None = None, freeze_groups: tuple[str, ...] = ()):
        self.model = model
        self.set_lr = set_lr
        self.scheduler = scheduler
        self.grad_accum = grad_accum
        self.log_every = log_every
        self.ckpt_every = ckpt_every
        self.ckpt_dir = ckpt_dir
        self.eval_fn = eval_fn
        self.eval_every = eval_every
        self.best_metric = None
        self._loss_dev = None  # device scalar; float'd lazily (last_loss)
        self._step = make_train_step(model, optimizer, x_type, c_type, ema_decay,
                                     grad_accum, tuple(freeze_groups))
        params = dict(params)
        ema = ema_init(params) if ema_decay is not None else None
        self.state = TrainState(params, optimizer, ema, 0)

    def run(self, batches: Iterable[Mapping[str, Any]], num_iters: int | None = None,
            seed: int = 0, unit: str = "iter", num_units: int | None = None,
            batches_per_epoch: int | None = None, batch_size: int | None = None):
        """batches yield {'x': latents, 'ctx': context}. unit='iter' runs
        num_iters (or num_units) optimizer steps, 'epoch' num_units *
        batches_per_epoch, 'sample' ceil(num_units / batch_size)."""
        if unit == "iter":
            num_iters = num_iters if num_iters is not None else num_units
        elif unit == "epoch":
            if batches_per_epoch is None:
                raise ValueError("epoch unit needs batches_per_epoch")
            num_iters = num_units * batches_per_epoch
        elif unit == "sample":
            if batch_size is None:
                raise ValueError("sample unit needs batch_size")
            num_iters = -(-num_units // batch_size)
        else:
            raise ValueError(f"unknown step unit {unit!r}")
        device = next(iter(self.state.params.values())).device
        logm = MetricAccumulator()
        pending: list = []  # (device aux, weight) awaiting the log window

        def drain_metrics():
            for a, w in pending:
                logm.accumulate({k: float(v) for k, v in a.items()}, weight=w)
            pending.clear()

        t0 = time.time()
        it = iter(batches)
        while self.state.step < num_iters:
            batch = next(it)
            lr = (self.scheduler[self.state.step // self.grad_accum]
                  if self.scheduler is not None else 1e-4)
            self.set_lr(self.state.opt_state, lr)
            x = torch.as_tensor(batch["x"], device=device)
            ctx = torch.as_tensor(batch["ctx"], device=device)
            gen = step_generator(seed, self.state.step, device)
            loss, aux = self._step(self.state, x, ctx, gen=gen)
            self.state.step += 1
            self._loss_dev = loss
            pending.append((aux, x.shape[0]))
            if len(pending) >= 256:
                drain_metrics()
            if self.state.step % self.log_every == 0:
                drain_metrics()
                print_log(f"Iter {self.state.step} | LR {lr:.3e} | {logm.summary()} "
                          f"| Time {time.time() - t0:.1f}s")
                logm.reset()
            if self.eval_fn is not None and self.eval_every and \
                    self.state.step % self.eval_every == 0:
                metric = self.eval_fn(self.state)
                if self.best_metric is None or metric < self.best_metric:
                    self.best_metric = metric
                    self._save("best")
            if self.ckpt_every and self.state.step % self.ckpt_every == 0:
                self._save(f"iter_{self.state.step}")
        self._save("last")
        return self.state

    @property
    def last_loss(self):
        """Most recent step's scalar loss (waits for the device value)."""
        return None if self._loss_dev is None else float(self._loss_dev)

    def _save(self, tag: str):
        if not self.ckpt_dir:
            return
        from vdtpu_torch.training.checkpoints import save_checkpoint
        save_checkpoint(self.ckpt_dir, tag, self.state)

    @torch.no_grad()
    def restore(self, ckpt_dir: str | None = None, tag: str | None = None):
        """Resume from a checkpoint: params, optimizer state, EMA and step,
        copied into the live tensors."""
        from vdtpu_torch.training.checkpoints import latest_tag, restore_checkpoint
        ckpt_dir = ckpt_dir or self.ckpt_dir
        if tag is None:
            tag = latest_tag(ckpt_dir)
        payload = restore_checkpoint(ckpt_dir, tag, map_location="cpu")
        params = self.state.params
        if set(payload["params"]) != set(params):
            raise KeyError(f"checkpoint {tag!r} has other parameters than this model")
        for k, v in payload["params"].items():
            params[k].copy_(v)
        self.state.opt_state.load_state_dict(payload["opt_state"])
        ema = self.state.ema
        if ema is not None and payload.get("ema") is not None:
            for k, v in payload["ema"]["shadow"].items():
                ema.shadow[k].copy_(v)
            ema.num_updates = int(payload["ema"]["num_updates"])
        self.state.step = int(payload["step"])
        return self.state
