"""The process mesh and the tensor-parallel layout (``vdtpu/parallel/mesh.py``).

The JAX package lays a (dp, tp) ``jax.sharding.Mesh`` over its devices and
lets the partitioner place every op. Here each rank is one process
(``torchrun``, or ``parallel/dryrun.py``), and the mesh is a pair of
process groups:

- ``init_distributed()`` starts the process group from torchrun's
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``); without ``WORLD_SIZE`` it starts nothing (a world of
  one). The backend is NCCL when each rank of the host has a card of its
  own, gloo when ranks share a card or run on the CPU (NCCL refuses two
  ranks on one device).
- ``make_mesh(tp)``: rank r has dp index r // tp and tp index r % tp, as
  ``np.arange(n).reshape(n // tp, tp)`` lays them out; an n that tp does
  not divide raises, as in the JAX package. A world of one (no process
  group) is the same mesh with dp = tp = 1 and no groups.
- ``param_spec`` / ``shard_module``: the JAX package's rule picks the same
  tensors. A Dense kernel [in, out] is the port's ``weight`` [out, in] and
  a conv kernel HWIO is OIHW, so "out" is dim 0 here: a ``nn.Linear`` /
  ``nn.Conv2d`` (the int8-capable ``QDense`` / ``QConv`` included) whose
  out is at least 128 and divisible by tp keeps rows
  [tp_index * out / tp, (tp_index + 1) * out / tp) of its weight and bias,
  under the same parameter names (the same ``Parameter`` objects, so
  ``load_state_dict``, the optimizer's groups and ``freeze`` still go by
  name). Its forward gathers the output features
  (``collectives.gather_features``) after summing its input gradient over
  tp (``reduce_input_grad``). Norm scales and biases, which the JAX
  package also lays out over tp, stay replicated here: the activations are
  whole at every layer boundary. The int8 serving policy under tp raises
  (its weight tables would be the slice's).
- ``full_state_dict``: the tp slices gathered into the full tensors, on
  every rank (a checkpoint's layout does not depend on (dp, tp)).

Why not DDP or DTensor: a ``VDModel`` holds diffusers and context stacks
that a flow never touches (the text data blocks in a t2i step), and
``freeze_groups`` turns gradients off by group, so DDP's reducer would wait
on parameters that get no gradient (or need ``find_unused_parameters``);
the harness already sums its micro-batches by hand, and one explicit
bucketed all-reduce a step is the JAX package's psum. DTensor's
``ColwiseParallel`` would hand DTensors to the port's ctypes kernels.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from vdtpu_torch.ops.quant import QConv, QDense
from vdtpu_torch.parallel.collectives import (
    gather_dim, gather_features, reduce_input_grad)

@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place in a (dp, tp) grid of processes and its groups
    (None for a group of one)."""
    dp: int = 1
    tp: int = 1
    rank: int = 0
    dp_group: Any = None
    tp_group: Any = None

    @property
    def dp_index(self) -> int:
        return self.rank // self.tp

    @property
    def tp_index(self) -> int:
        return self.rank % self.tp

    @property
    def size(self) -> int:
        return self.dp * self.tp

    def row_range(self, n: int, dp_index: int | None = None) -> tuple[int, int]:
        """[lo, hi) of dp index ``dp_index``'s rows (default this rank's) of
        an n-row batch, as ``np.array_split`` cuts it."""
        d = self.dp_index if dp_index is None else dp_index
        q, r = divmod(n, self.dp)
        lo = d * q + min(d, r)
        return lo, lo + q + (d < r)

    def barrier(self) -> None:
        if self.size > 1:
            import torch.distributed as dist
            dist.barrier()


def mesh_layout(n: int, tp: int = 1) -> np.ndarray:
    """[dp, tp] grid of the ranks 0..n-1; raises where tp does not divide n."""
    if n % tp:
        raise ValueError(f"{n} devices not divisible by tp={tp}")
    return np.arange(n).reshape(n // tp, tp)


def pick_backend(device_type: str, local_world: int) -> str:
    """NCCL where every rank of the host has a card of its own, else gloo."""
    if device_type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def init_distributed(device_type: str = "cuda", backend: str | None = None,
                     timeout_s: float = 600.0) -> tuple[int, int, int]:
    """Start the default process group from torchrun's environment; returns
    (rank, world size, local rank). Without ``WORLD_SIZE`` in the
    environment nothing starts and (0, 1, 0) comes back. ``backend`` None:
    ``pick_backend``. Under NCCL the rank's card is made current first."""
    import datetime

    import torch.distributed as dist
    if "WORLD_SIZE" not in os.environ:
        return 0, 1, 0
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if not dist.is_initialized():
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        backend = backend or pick_backend(device_type, local_world)
        if device_type == "cuda":
            torch.cuda.set_device(local % torch.cuda.device_count())
        dist.init_process_group(backend, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
    return rank, world, local


def make_mesh(tp: int = 1) -> Mesh:
    """The (dp, tp) mesh of the started process group (a world of one
    without one). Every rank makes every group, in the same order."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        mesh_layout(1, tp)
        return Mesh(1, 1, 0)
    n, rank = dist.get_world_size(), dist.get_rank()
    grid = mesh_layout(n, tp)
    dp = n // tp
    mesh = Mesh(dp, tp, rank)
    if tp > 1:
        for row in grid:
            g = dist.new_group([int(r) for r in row])
            if rank in row:
                mesh.tp_group = g
    if dp > 1:
        for col in grid.T:
            g = dist.new_group([int(r) for r in col])
            if rank in col:
                mesh.dp_group = g
    return mesh


def batch_rows(x, mesh: Mesh):
    """This rank's rows of a batch (leading dim over dp, ``row_range``)."""
    lo, hi = mesh.row_range(x.shape[0])
    return x[lo:hi]


# ---- tensor parallelism ---------------------------------------------------------------

def _out_features(m: nn.Module) -> int:
    return getattr(m, "tp_out", m.weight.shape[0])


def param_spec(owner: nn.Module, leaf: str, tp: int) -> int | None:
    """The dim of ``owner``'s parameter ``leaf`` that tp shards (0: the
    output features), or None (replicated)."""
    if tp <= 1 or leaf not in ("weight", "bias") or not isinstance(owner, (nn.Linear, nn.Conv2d)):
        return None
    out = _out_features(owner)
    return 0 if out >= 128 and out % tp == 0 else None


def sharded_names(module: nn.Module, tp: int) -> dict[str, int]:
    """{parameter name: sharded dim} of every parameter ``param_spec``
    shards under ``module``."""
    out = {}
    for path, m in module.named_modules():
        for leaf, p in m.named_parameters(recurse=False):
            dim = param_spec(m, leaf, tp)
            if dim is not None:
                out[f"{path}.{leaf}" if path else leaf] = dim
    return out


def _refuse_int8(self, *a, **kw):
    raise RuntimeError("the int8 serving policy under tensor parallelism: its weight "
                       "tables would hold the tp slice (not ported: serve int8 at tp=1)")


def _qdense_linear(self, x):
    return gather_features(QDense.linear(self, reduce_input_grad(x, self.tp_mesh)), -1,
                           self.tp_mesh)


def _qconv_conv(self, x):
    return gather_features(QConv.conv(self, reduce_input_grad(x, self.tp_mesh)), 1,
                           self.tp_mesh)


def _linear_forward(self, x):
    return gather_features(nn.Linear.forward(self, reduce_input_grad(x, self.tp_mesh)), -1,
                           self.tp_mesh)


def _conv_forward(self, x):
    return gather_features(nn.Conv2d.forward(self, reduce_input_grad(x, self.tp_mesh)), 1,
                           self.tp_mesh)


_TP_CLASSES: dict[type, type] = {}


def _tp_class(base: type) -> type:
    """The sharded-output subclass of a layer class."""
    if base not in _TP_CLASSES:
        if issubclass(base, QDense):
            ns = {"linear": _qdense_linear, "tables": _refuse_int8}
        elif issubclass(base, QConv):
            ns = {"conv": _qconv_conv, "tables": _refuse_int8}
        elif issubclass(base, nn.Linear):
            ns = {"forward": _linear_forward}
        else:
            ns = {"forward": _conv_forward}
        _TP_CLASSES[base] = type(f"TP{base.__name__}", (base,), ns)
    return _TP_CLASSES[base]


@torch.no_grad()
def shard_module(module: nn.Module, mesh: Mesh) -> dict[str, int]:
    """Keep this rank's tp slice of every parameter ``param_spec`` shards
    under ``module``, in place and under the same names; the owning layers
    gather their output features. Returns {name: sharded dim}. A layer
    sharded already is left as it is; tp = 1 changes nothing."""
    if mesh.tp == 1:
        return {}
    out = {}
    for path, m in module.named_modules():
        if getattr(m, "tp_mesh", None) is not None or param_spec(m, "weight", mesh.tp) is None:
            continue
        n_out = m.weight.shape[0]
        k = n_out // mesh.tp
        lo = mesh.tp_index * k
        for leaf in ("weight", "bias"):
            p = getattr(m, leaf, None)
            if p is None:
                continue
            p.tp_full_shape = tuple(p.shape)
            p.data = p.data[lo:lo + k].clone()
            out[f"{path}.{leaf}" if path else leaf] = 0
        m.tp_mesh, m.tp_out = mesh, n_out
        m.__class__ = _tp_class(type(m))
    return out


def is_sharded(t) -> bool:
    return getattr(t, "tp_full_shape", None) is not None


def full_tensor(t: torch.Tensor, like, mesh: Mesh | None) -> torch.Tensor:
    """``t`` (a slice shaped like the sharded parameter ``like``, or the
    parameter itself) gathered over tp; anything else as it is."""
    if mesh is None or mesh.tp == 1 or not is_sharded(like) or \
            tuple(t.shape) == like.tp_full_shape:
        return t
    return gather_dim(t.detach(), 0, mesh.tp_group)


def local_slice(full: torch.Tensor, like, mesh: Mesh | None) -> torch.Tensor:
    """This rank's slice of a full tensor for the sharded parameter ``like``."""
    if mesh is None or mesh.tp == 1 or not is_sharded(like) or \
            tuple(full.shape) != like.tp_full_shape:
        return full
    k = full.shape[0] // mesh.tp
    return full[mesh.tp_index * k:(mesh.tp_index + 1) * k]


def full_state_dict(tree: Mapping[str, Any], mesh: Mesh | None,
                    like: Mapping[str, Any] | None = None, prefix: str = "") -> dict[str, Any]:
    """A (nested) tree with the tp slices gathered into the full tensors, on
    every rank (a collective: every rank calls it). ``like``: the live
    parameters by dotted name, for a tree of other tensors shaped like them
    (the EMA shadow, gradients); None: the tree holds the parameters."""
    return {k: full_state_dict(v, mesh, like, f"{prefix}{k}.") if isinstance(v, Mapping)
            else full_tensor(v, v if like is None else like[f"{prefix}{k}"], mesh)
            for k, v in tree.items()}


@torch.no_grad()
def tree_fingerprint(tree: Mapping[str, Any]) -> int:
    """A hash of the bits of every tensor of a (nested) tree, computed where
    the tensors lie: equal trees give equal numbers, and a flipped bit
    anywhere changes it (the replicas' check)."""
    from vdtpu_torch.training.ema import tree_items
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    total = 0
    for i, (name, t) in enumerate(sorted(tree_items(tree), key=lambda kv: kv[0])):
        bits = t.detach().contiguous().reshape(-1).view(ints[t.element_size()]).to(torch.int64)
        w = torch.arange(1, bits.numel() + 1, device=bits.device, dtype=torch.int64)
        h = int((bits * (w * 2654435761 % 1000003 + 1)).sum())
        total = (total * 1000000007 + h + i) % (1 << 61)
    return total
