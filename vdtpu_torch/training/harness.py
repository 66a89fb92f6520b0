"""Training harness (``vdtpu/training/harness.py``): the eps-loss train
step and the step-typed outer loop.

- ``make_loss_fn``: the model's ``p_losses`` on pre-encoded context (frozen
  encoders, the harness's default contract), or, with ``ctx_encode_fn``,
  on raw encoder input (token ids, pixels) that the trainable context
  encoder turns into context inside the loss, so its parameters get
  gradients (the reference's ctx_encode_trainable); the trainable tree is
  then ``{"diffuser": {name: tensor}, "ctx": {name: tensor}}``.
  ``freeze_groups`` turns off the gradients of the named parameter groups,
  so the backward neither computes nor keeps them (the JAX package's
  stop_gradient).
- ``make_train_step``: one optimizer update. The batch splits contiguously
  into ``grad_accum`` micro-batches; each runs forward and backward, the
  gradients sum in place and are divided by ``grad_accum`` before the
  single update, and the loss and metrics are averaged. Then the EMA.
  t and noise are taken as given (the tests hand in the JAX package's
  draws) or drawn for the whole batch from a ``torch.Generator``.
- ``Trainer``: iter / epoch / sample units, the lr pushed from an indexable
  scheduler each step (at ``step // grad_accum``, as the JAX package
  indexes it), logging cadence, ``eval_fn`` with a best-checkpoint keep,
  periodic and final checkpoints (``async_ckpt``: host snapshot, disk
  write in the background; ``iter_N`` and ``last`` of one step are one
  file, hard-linked), ``restore`` and ``last_loss``. The EMA shadow of a
  frozen group shares the parameters' storage (they never move, so the
  average equals them bit for bit). Each step's generator is seeded
  from (seed, step), so a restored run draws what the uninterrupted run
  would have drawn.

PyTorch keeps the parameters in the modules: ``TrainState.params`` is the
tree of the live parameters by name (``VDModel.named_parameters``, or the
combined tree above), which the step updates in place, and ``opt_state``
is the optimizer that owns the optimizer state. ``donate`` is accepted and
means nothing here: the step already updates in place, so no second copy
of the training state exists to give up.

Data and tensor parallelism (``Trainer(mesh=)``, ``parallel/mesh.py``):
the diffusers are sharded over tp (``shard_module``: the same
``Parameter`` objects keep their names and hold their slices, so the
optimizer built over them and the EMA made here work on the slices), and
each rank's batches are its own rows of the global batch. The step draws t
and noise for the global batch from the (seed, step) generator and takes
its rows (given t and noise are the global batch's too), so every rank
draws what one process would draw. After the micro-batch loop and before
``optimizer.step()`` one all-reduce mean a step runs over the dp group, on
flat buckets of the gradients that exist: the JAX package's psum. Then dp
= 2 equals one process up to summation order, and every replica applies
the same update. A checkpoint holds the full tensors whatever (dp, tp):
every rank gathers, rank 0 writes, and a restore gives each rank its slice.
The JAX package's DDP-free design is kept on purpose (``parallel/mesh.py``
says why).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable, Mapping

import numpy as np
import torch

from vdtpu_torch.models.vd import VDModel
from vdtpu_torch.training.ema import EmaState, ema_init, ema_update, tree_items
from vdtpu_torch.training.optim import parameter_group_of
from vdtpu_torch.utils.logging import MetricAccumulator, print_log


@dataclasses.dataclass
class TrainState:
    params: dict[str, Any]
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
                 freeze_groups: tuple[str, ...] = (), ctx_encode_fn: Callable | None = None,
                 params: Mapping[str, Any] | None = None):
    """loss_fn(x, ctx, t, noise) -> (loss, aux) on the model's parameters.
    With ``ctx_encode_fn``, ctx is the encoder's raw input and
    ``ctx_encode_fn(ctx)`` (which runs the trainable encoder with grad) the
    context. The parameters of ``freeze_groups`` (``parameter_group_of``
    labels) in ``params`` (the trainable tree; default the model's) stop
    requiring gradients here."""
    _check_trainable(model)
    fz = tuple(freeze_groups)
    for name, p in tree_items(params if params is not None else dict(model.named_parameters())):
        if parameter_group_of(name) in fz:
            p.requires_grad_(False)

    def loss_fn(x, ctx, t, noise):
        if ctx_encode_fn is not None:
            ctx = ctx_encode_fn(ctx)
        return model.p_losses(x, t, ctx, x_type, c_type, noise)
    return loss_fn


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one step's t and noise, seeded from (seed, step)."""
    s = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s)


def make_train_step(model: VDModel, optimizer: torch.optim.Optimizer,
                    x_type: str = "image", c_type: str = "text",
                    ema_decay: float | None = None, grad_accum: int = 1,
                    freeze_groups: tuple[str, ...] = (), ctx_encode_fn: Callable | None = None,
                    params: Mapping[str, Any] | None = None, mesh=None):
    """step(state, x, ctx, t=None, noise=None, gen=None) -> (loss, aux):
    one update of ``state`` in place. x [B, ...] in the model's layout, ctx
    [B, L, C] (the encoder's raw input with ``ctx_encode_fn``); t [B] and
    noise like x, or both None and drawn from ``gen``. The lr is whatever
    ``set_lr`` last pushed. Under a ``mesh`` with dp > 1, x and ctx are
    the rank's rows of a global batch of dp * B, t and noise (given or
    drawn) the global batch's, and the gradients are averaged over the dp
    group before the update; ``step.comm_s`` holds the seconds of the last
    step's all-reduce (the device synchronized first)."""
    from vdtpu_torch.parallel.collectives import all_reduce_mean
    from vdtpu_torch.parallel.mesh import batch_rows
    loss_fn = make_loss_fn(model, x_type, c_type, freeze_groups, ctx_encode_fn, params)
    n_t = model.schedule.num_timesteps
    dp = 1 if mesh is None else mesh.dp

    def step(state: TrainState, x, ctx, t=None, noise=None, gen=None):
        b = x.shape[0]
        if b % grad_accum:
            raise ValueError(f"batch {b} does not split into {grad_accum} micro-batches")
        if t is None:
            t = torch.randint(0, n_t, (b * dp,), generator=gen, device=x.device)
            noise = torch.randn((b * dp, *x.shape[1:]), generator=gen, device=x.device,
                                dtype=x.dtype)
        if dp > 1:
            if t.shape[0] != b * dp:
                raise ValueError(f"t of {t.shape[0]} rows: the global batch is {b * dp}")
            t, noise = batch_rows(t, mesh), batch_rows(noise, mesh)
        optimizer.zero_grad(set_to_none=True)
        mb = b // grad_accum
        losses, auxs = [], []
        for i in range(grad_accum):
            sl = slice(i * mb, (i + 1) * mb)
            loss, aux = loss_fn(x[sl], ctx[sl], t[sl], noise[sl])
            loss.backward()
            losses.append(loss.detach())
            auxs.append({k: v.detach() for k, v in aux.items()})
        grads = [p.grad for _, p in tree_items(state.params) if p.grad is not None]
        if grad_accum > 1:
            torch._foreach_div_(grads, float(grad_accum))
        if dp > 1:
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            t0 = time.perf_counter()
            all_reduce_mean(grads, mesh.dp_group)
            step.comm_s = time.perf_counter() - t0
        optimizer.step()
        if ema_decay is not None:
            ema_update(state.ema, state.params, ema_decay)
        loss = torch.stack(losses).mean()
        aux = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
        return loss, aux

    step.comm_s = 0.0
    return step


class Trainer:
    """The step-typed outer loop (ref train_stage, utils.py:61-307)."""

    def __init__(self, model: VDModel, params: Mapping[str, torch.Tensor],
                 optimizer: torch.optim.Optimizer, set_lr: Callable, scheduler=None,
                 x_type: str = "image", c_type: str = "text",
                 ema_decay: float | None = None, grad_accum: int = 1,
                 log_every: int = 100, ckpt_every: int | None = None,
                 ckpt_dir: str | None = None, eval_fn: Callable | None = None,
                 eval_every: int | None = None, freeze_groups: tuple[str, ...] = (),
                 ctx_encode_fn: Callable | None = None, async_ckpt: bool = False,
                 donate: bool = False, mesh=None):
        """``params``: the trainable tree (with ``ctx_encode_fn``, the
        ``{"diffuser", "ctx"}`` one); ``donate`` is accepted for the JAX
        package's config key and does nothing (module docstring). ``mesh``
        (``parallel.mesh.make_mesh``): the diffusers are sharded over its tp
        group here, before the EMA exists and before the optimizer's first
        step; a trainable context encoder stays whole on every rank (its
        gradients are averaged over dp with the rest)."""
        del donate
        self.model = model
        self.mesh = mesh
        if mesh is not None and mesh.tp > 1:
            from vdtpu_torch.parallel.mesh import shard_module
            if optimizer.state:
                raise RuntimeError("Trainer(mesh=) shards the parameters: hand it an "
                                   "optimizer that has not stepped")
            shard_module(model.diffuser, mesh)
        self.set_lr = set_lr
        self.scheduler = scheduler
        self.grad_accum = grad_accum
        self.log_every = log_every
        self.ckpt_every = ckpt_every
        self.ckpt_dir = ckpt_dir
        self.eval_fn = eval_fn
        self.eval_every = eval_every
        self.async_ckpt = async_ckpt
        self.best_metric = None
        self.after_step: Callable | None = None
        self._loss_dev = None  # device scalar; float'd lazily (last_loss)
        self._saved = None     # (step, file) of the last save
        params = dict(params)
        self._step = make_train_step(model, optimizer, x_type, c_type, ema_decay,
                                     grad_accum, tuple(freeze_groups), ctx_encode_fn, params,
                                     mesh)
        frozen = [k for k, _ in tree_items(params) if parameter_group_of(k) in freeze_groups]
        ema = ema_init(params, alias=frozen) if ema_decay is not None else None
        self.state = TrainState(params, optimizer, ema, 0)

    def run(self, batches: Iterable[Mapping[str, Any]], num_iters: int | None = None,
            seed: int = 0, unit: str = "iter", num_units: int | None = None,
            batches_per_epoch: int | None = None, batch_size: int | None = None):
        """batches yield {'x': latents, 'ctx': context} (under a mesh, the
        rank's rows), and may carry the step's draws {'t', 'noise'} (of the
        global batch), else they come from the (seed, step) generator.
        unit='iter' runs num_iters (or num_units) optimizer steps, 'epoch'
        num_units * batches_per_epoch, 'sample' ceil(num_units /
        batch_size). ``after_step(trainer)``, if set as an attribute, runs
        after every step (the replicas' check of the dry run)."""
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
        device = next(tree_items(self.state.params))[1].device
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
            if batch.get("t") is not None:   # given draws (the global batch's)
                loss, aux = self._step(self.state, x, ctx,
                                       torch.as_tensor(batch["t"], device=device),
                                       torch.as_tensor(batch["noise"], device=device))
            else:
                gen = step_generator(seed, self.state.step, device)
                loss, aux = self._step(self.state, x, ctx, gen=gen)
            self.state.step += 1
            self._loss_dev = loss
            pending.append((aux, x.shape[0]))
            if self.after_step is not None:
                self.after_step(self)
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
        if self.async_ckpt:
            from vdtpu_torch.training.checkpoints import wait_for_saves
            wait_for_saves()   # 'last' and the cadence saves on disk
        if self.mesh is not None:
            self.mesh.barrier()   # rank 0's files are on disk for every rank
        self._saved = None
        return self.state

    @property
    def comm_seconds(self) -> float:
        """Seconds of the last step's dp all-reduce (0 without one)."""
        return self._step.comm_s

    @property
    def last_loss(self):
        """Most recent step's scalar loss (waits for the device value)."""
        return None if self._loss_dev is None else float(self._loss_dev)

    def _save(self, tag: str):
        if not self.ckpt_dir:
            return
        from vdtpu_torch.training.checkpoints import link_checkpoint, save_checkpoint
        step, block = self.state.step, not self.async_ckpt
        if self._saved is not None and self._saved[0] == step:   # one state, one file
            if self.mesh is None or self.mesh.rank == 0:
                link_checkpoint(self.ckpt_dir, tag, self._saved[1], block=block)
        else:
            self._saved = (step, save_checkpoint(self.ckpt_dir, tag, self.state, block=block,
                                                 mesh=self.mesh))

    @torch.no_grad()
    def restore(self, ckpt_dir: str | None = None, tag: str | None = None):
        """Resume from a checkpoint: params, optimizer state, EMA and step,
        copied into the live tensors (under a mesh, each rank its tp slice
        of the full tensors every checkpoint holds)."""
        from vdtpu_torch.parallel.mesh import Mesh, local_slice
        from vdtpu_torch.training.checkpoints import (
            latest_tag, map_opt_tensors, restore_checkpoint)
        ckpt_dir = ckpt_dir or self.ckpt_dir
        if tag is None:
            tag = latest_tag(ckpt_dir)
        mesh = self.mesh or Mesh()
        payload = restore_checkpoint(ckpt_dir, tag, map_location="cpu")
        params = dict(tree_items(self.state.params))
        saved = dict(tree_items(payload["params"]))
        if set(saved) != set(params):
            raise KeyError(f"checkpoint {tag!r} has other parameters than this model")
        for k, v in saved.items():
            params[k].copy_(local_slice(v, params[k], mesh))
        opt = self.state.opt_state
        opt.load_state_dict(map_opt_tensors(payload["opt_state"], opt,
                                            lambda t, p: local_slice(t, p, mesh)))
        ema = self.state.ema
        if ema is not None and payload.get("ema") is not None:
            shadow = dict(tree_items(ema.shadow))
            for k, v in tree_items(payload["ema"]["shadow"]):
                shadow[k].copy_(local_slice(v, params[k], mesh))
            ema.num_updates = int(payload["ema"]["num_updates"])
        self.state.step = int(payload["step"])
        return self.state
