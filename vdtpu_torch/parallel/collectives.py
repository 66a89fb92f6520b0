"""The collectives of the port's data and tensor parallelism, over
``torch.distributed`` (the JAX package leaves them to XLA: the implicit
all-gather of sharded activations and the psum of the gradients).

- ``gather_features(x, dim, mesh)``: an autograd ``Function``. Forward:
  the tp group's slices of ``x`` joined along ``dim`` in tp order.
  Backward: the rank's slice of the incoming gradient, with no collective:
  every rank of a tp group computes the same loss on the same (gathered)
  activations, so the incoming gradient is already whole and equal on
  every rank, and an all-reduce would scale it by tp.
- ``reduce_input_grad(x, mesh)``: identity forward; backward all-reduces
  (sums) the gradient over the tp group. It stands in front of every
  sharded projection: a rank's input gradient W_r^T dy_r is only its
  slice's share of the whole W^T dy.
- ``all_reduce_mean(tensors, group)``: the mean over a group, in place, on
  flat buckets of one dtype (one collective a bucket): the data-parallel
  gradient reduction, once a step.
- ``broadcast_object(obj, src, group)``: a picklable object from ``src``;
  tensors travel on the host and come back on ``device``.
- ``gather_rows(x, n, mesh)``: the dp group's row blocks of an n-row batch
  (``mesh.row_range``) joined in dp order, on every rank.

Routes. NCCL refuses two ranks on one card, so ranks that share it run
gloo, whose documentation lists CPU tensors only for its gathers (torch
2.11's gloo does gather CUDA tensors on an H100). So under
gloo a CUDA tensor is copied to the host on the caller's stream, reduced or
gathered there, and copied back, whatever the build supports; a 16-bit
tensor is gathered and summed in f32 and rounded back (a gather stays
exact). ``gather_routes`` counts the gathers by route: "device" (NCCL, or
gloo on the CPU) or "host" (gloo on CUDA tensors), "_f32" where widened.
Nothing moves to the host on the NCCL path.
"""
from __future__ import annotations

import collections
from typing import Any, Sequence

import torch

# gathers by route: "device" or "host", with "_f32" where widened
gather_routes: collections.Counter = collections.Counter()

_BUCKET_BYTES = 1 << 28   # the most bytes of one flat all-reduce


def _dist():
    import torch.distributed as dist
    return dist


def group_size(group) -> int:
    return 1 if group is None else _dist().get_world_size(group)


def _backend(group) -> str:
    return _dist().get_backend(group)


def _comm_device(group) -> torch.device:
    """Where a collective on host values runs: the card under NCCL, else
    the CPU."""
    if _backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _staged(t: torch.Tensor, group) -> tuple[torch.Tensor, bool, bool]:
    """(the buffer a collective works on, staged on the host, widened):
    under gloo a CUDA tensor goes to the host and a 16-bit one to f32."""
    gloo = _backend(group) == "gloo"
    host, wide = gloo and t.is_cuda, gloo and t.dtype in (torch.bfloat16, torch.float16)
    buf = t.to("cpu" if host else t.device, torch.float32 if wide else t.dtype,
               copy=host or wide)
    return buf.contiguous(), host, wide


def _all_reduce(t: torch.Tensor, group) -> None:
    """Sum ``t`` over ``group`` in place (``_staged`` under gloo)."""
    buf, host, wide = _staged(t, group)
    _dist().all_reduce(buf, group=group)
    if host or wide:
        t.copy_(buf)


def _gather_dim0(x: torch.Tensor, group) -> torch.Tensor:
    """[n * k, ...] of the group's [k, ...] slices, in group rank order."""
    n = group_size(group)
    src, host, wide = _staged(x, group)
    gather_routes[("host" if host else "device") + ("_f32" if wide else "")] += 1
    out = src.new_empty((n * x.shape[0], *x.shape[1:]))
    _dist().all_gather_into_tensor(out, src, group=group)
    return out.to(x.device, x.dtype) if host or wide else out


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's slices of x joined along ``dim``, contiguous (no
    autograd)."""
    if group_size(group) == 1:
        return x
    dim = dim % x.dim()
    return _gather_dim0(x.movedim(dim, 0), group).movedim(0, dim).contiguous()


class _GatherFeatures(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.index, ctx.k = dim % x.dim(), mesh.tp_index, x.shape[dim]
        return gather_dim(x, dim, mesh.tp_group)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.k
        return g.narrow(ctx.dim, lo, ctx.k), None, None


def gather_features(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The tp group's output-feature slices joined along ``dim``; the
    gradient is the rank's slice (module docstring)."""
    if mesh.tp == 1:
        return x
    return _GatherFeatures.apply(x, dim, mesh)


class _ReduceInputGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _all_reduce(g, ctx.mesh.tp_group)
        return g, None


def reduce_input_grad(x: torch.Tensor, mesh) -> torch.Tensor:
    """Identity; the backward sums the input gradient over the tp group."""
    if mesh.tp == 1 or not torch.is_grad_enabled():
        return x
    return _ReduceInputGrad.apply(x, mesh)


@torch.no_grad()
def all_reduce_mean(tensors: Sequence[torch.Tensor], group) -> int:
    """Each tensor replaced by its mean over ``group``, in place, through
    flat buckets of at most ``_BUCKET_BYTES`` of one dtype and device.
    Returns the number of collectives (0 for a group of one)."""
    n = group_size(group)
    if n == 1 or not tensors:
        return 0
    by_kind: dict[tuple, list[torch.Tensor]] = {}
    for t in tensors:
        by_kind.setdefault((t.dtype, t.device), []).append(t)
    calls = 0
    for ts in by_kind.values():
        run, size = [], 0
        for t in ts + [None]:
            if t is not None and (not run or size + t.numel() * t.element_size() <= _BUCKET_BYTES):
                run.append(t)
                size += t.numel() * t.element_size()
                continue
            flat = torch.cat([r.reshape(-1) for r in run])
            _all_reduce(flat, group)
            flat.div_(n)
            torch._foreach_copy_(run, [c.view_as(r) for c, r in
                                       zip(flat.split([r.numel() for r in run]), run)])
            calls += 1
            if t is not None:
                run, size = [t], t.numel() * t.element_size()
    return calls


def all_reduce_scalars(values: Sequence[float], group) -> list[float]:
    """The mean of host floats over ``group``."""
    n = group_size(group)
    if n == 1:
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=_comm_device(group))
    _dist().all_reduce(t, group=group)
    return [float(v) / n for v in t.cpu()]


def _tree_to(obj, device):
    if torch.is_tensor(obj):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _tree_to(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_to(v, device) for v in obj)
    return obj


def broadcast_object(obj: Any, src: int = 0, group=None, device=None) -> Any:
    """``obj`` of global rank ``src`` on every rank of ``group`` (the world
    by default); its tensors are pickled from the host and land on
    ``device`` (None: the CPU)."""
    dist = _dist()
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return obj
    box = [_tree_to(obj, "cpu") if dist.get_rank() == src else None]
    dist.broadcast_object_list(box, src=src, group=group,
                               device=_comm_device(group) if _backend(group) == "nccl" else None)
    return _tree_to(box[0], device or "cpu")


def gather_rows(x: torch.Tensor, n: int, mesh) -> torch.Tensor:
    """The n-row batch whose rows ``mesh.row_range(n)`` this rank holds in
    ``x``, on every rank: blocks zero-padded to the largest, gathered over
    the dp group, cut back to n rows."""
    if mesh.dp == 1:
        return x
    k = -(-n // mesh.dp)
    pad = x.new_zeros((k, *x.shape[1:]))
    pad[:x.shape[0]] = x
    full = gather_dim(pad, 0, mesh.dp_group)
    blocks = [mesh.row_range(n, d) for d in range(mesh.dp)]
    return torch.cat([full[d * k:d * k + hi - lo] for d, (lo, hi) in enumerate(blocks)])
