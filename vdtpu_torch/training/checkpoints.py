"""Checkpoint save/restore (``vdtpu/training/checkpoints.py``): orbax becomes
``torch.save`` / ``torch.load`` of one file per tag, ``<ckpt_dir>/<tag>.pt``.

A checkpoint holds the parameters, the optimizer's state dict, the EMA
(shadow and update count) and the step, as the JAX package's does. Every
save is atomic (a temporary file, then a rename); loads read tensors only
(``weights_only=True``).

``save_checkpoint(..., block=False)`` is the counterpart of orbax's
``AsyncCheckpointer``: the payload is copied to host memory before the
call returns (``optimizer.state_dict()`` and the parameters hand back the
live tensors, which the next step updates in place), and one writer thread
runs ``torch.save`` and the rename while training goes on. Saves in flight
are written in the order they were made; ``link_checkpoint`` saves a tag
of a state already saved as a hard link. ``wait_for_saves()`` joins them
and re-raises a writer's error; a blocking save, ``restore_checkpoint`` and
``latest_tag`` each join them first, so none sees a half-written tag.

Under a mesh (``parallel/mesh.py``) the layout does not depend on (dp, tp):
a checkpoint has the keys and full shapes of a one-process run. Every rank
gathers its tp slices (parameters, optimizer moments, EMA shadow) in step,
then rank 0 alone snapshots and writes (in the background with
``block=False``); the other ranks write nothing. A restore reads the full
tensors on every rank and each takes its slice (``Trainer.restore``), so a
tp = 2 checkpoint loads at tp = 1 and back.
"""
from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any

import torch

_lock = threading.Lock()
_pending: list[threading.Thread] = []
_errors: list[BaseException] = []


def checkpoint_path(ckpt_dir: str, tag: str) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"{tag}.pt")


def _host_copy(obj, memo=None):
    """Tensors copied to the CPU (a new tensor even where one lies there),
    containers rebuilt around them; views of one tensor (an EMA leaf that
    shares a frozen parameter's storage) stay one copy, so ``torch.save``
    writes it once."""
    memo = {} if memo is None else memo
    if torch.is_tensor(obj):
        key = (obj.untyped_storage().data_ptr(), obj.storage_offset(), tuple(obj.shape),
               obj.stride(), obj.dtype, obj.device)
        if key not in memo:
            memo[key] = obj.detach().to("cpu", copy=True)
        return memo[key]
    if isinstance(obj, dict):
        return {k: _host_copy(v, memo) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v, memo) for v in obj)
    return obj


def map_opt_tensors(sd: dict[str, Any], optimizer: torch.optim.Optimizer, fn) -> dict:
    """An optimizer state dict with every per-parameter tensor t replaced by
    fn(t, parameter); scalars and the groups stay as they are."""
    order = [p for g in optimizer.param_groups for p in g["params"]]
    state = {i: {k: fn(v, order[i]) if torch.is_tensor(v) and v.dim() > 0 else v
                 for k, v in st.items()} for i, st in sd["state"].items()}
    return {**sd, "state": state}


def _payload(state, mesh=None) -> dict[str, Any]:
    from vdtpu_torch.training.ema import tree_items, tree_map
    params = tree_map(lambda v: v.detach(), state.params)
    opt = state.opt_state.state_dict()
    shadow = None if state.ema is None else state.ema.shadow
    if mesh is not None and mesh.tp > 1:
        from vdtpu_torch.parallel.mesh import full_state_dict, full_tensor
        live = dict(tree_items(state.params))
        opt = map_opt_tensors(opt, state.opt_state, lambda t, p: full_tensor(t, p, mesh))
        if shadow is not None:
            shadow = full_state_dict(shadow, mesh, like=live)
        params = tree_map(lambda v: v.detach(), full_state_dict(state.params, mesh))
    return {
        "params": params,
        "opt_state": opt,
        "ema": None if state.ema is None else
            {"shadow": shadow, "num_updates": state.ema.num_updates},
        "step": state.step,
    }


def _write(path: str, payload) -> None:
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def wait_for_saves() -> None:
    """Block until every save in flight is on disk; re-raise a writer's
    error."""
    while True:
        with _lock:
            if not _pending:
                break
            t = _pending[0]
        t.join()
        with _lock:
            if _pending and _pending[0] is t:
                _pending.pop(0)
    with _lock:
        errors = list(_errors)
        _errors.clear()
    if errors:
        raise RuntimeError(f"an async checkpoint save failed: {errors[0]!r}") from errors[0]


def snapshot(state, mesh=None) -> dict[str, Any]:
    """The checkpoint payload of ``state`` copied to host memory."""
    return _host_copy(_payload(state, mesh))


def _in_background(tag: str, job) -> None:
    """Run ``job`` on a writer thread after the saves in flight (saves land
    in the order they were made); its error is kept for ``wait_for_saves``."""
    with _lock:
        prev = _pending[-1] if _pending else None

    def writer():
        if prev is not None:
            prev.join()
        try:
            job()
        except BaseException as e:          # re-raised by wait_for_saves
            with _lock:
                _errors.append(e)

    t = threading.Thread(target=writer, name=f"ckpt-{tag}", daemon=True)
    with _lock:
        _pending.append(t)
    t.start()


def save_checkpoint(ckpt_dir: str, tag: str, state, *, block: bool = True,
                    mesh=None) -> str:
    """state: ``vdtpu_torch.training.harness.TrainState``. ``block=False``
    snapshots to host memory now and writes in the background. Under a
    ``mesh`` every rank must call it (the tp gather); rank 0 writes."""
    path = checkpoint_path(ckpt_dir, tag)
    if mesh is not None and mesh.rank != 0:
        _payload(state, mesh)    # the tp gather is a collective
        return path
    os.makedirs(ckpt_dir, exist_ok=True)
    if block:
        wait_for_saves()
        _write(path, _payload(state, mesh))
    else:
        payload = snapshot(state, mesh)   # before the next step moves the tensors
        _in_background(tag, lambda: _write(path, payload))
    return path


def link_checkpoint(ckpt_dir: str, tag: str, src: str, *, block: bool = True) -> str:
    """Save ``tag`` as a hard link to the checkpoint file ``src`` (a save
    of the same state: ``iter_N`` and ``last`` of one step), after the saves
    in flight (``block=False``: in the background); where the file system
    takes no hard link, a copy."""
    path = checkpoint_path(ckpt_dir, tag)

    def link():
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            os.link(src, tmp)
        except OSError:
            shutil.copyfile(src, tmp)
        os.replace(tmp, path)

    if block:
        wait_for_saves()
        link()
    else:
        _in_background(tag, link)
    return path


def restore_checkpoint(ckpt_dir: str, tag: str, map_location=None) -> dict[str, Any]:
    wait_for_saves()  # a save of this tag in flight must land first
    return torch.load(checkpoint_path(ckpt_dir, tag), map_location=map_location,
                      weights_only=True, mmap=True)


def latest_tag(ckpt_dir: str) -> str:
    """Most recent checkpoint tag in a run dir: ``last``, else the highest
    ``iter_N``, else ``best``."""
    wait_for_saves()  # tag discovery must see every save made
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
