"""Logging (``vdtpu/utils/logging.py``): ``print_log``, the run's log file
(``set_log_file``, which the training launcher registers) and
``MetricAccumulator`` (weighted running means of scalar metrics).

Under a started process group (``parallel/mesh.py``) ``print_log`` and the
log file are rank 0's alone, and ``MetricAccumulator.means()`` is the mean
of every rank's means, as the JAX package's
``process_allgather(...).mean(0)`` gives it: a collective, so every rank
calls it at the same point. The TensorBoard writer is not ported.
"""
from __future__ import annotations

import os
from typing import Mapping

_LOG_FILES: list[str] = []


def set_log_file(path: str | None):
    """Append every ``print_log`` line to ``path`` too (None: to no file)."""
    _LOG_FILES.clear()
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        _LOG_FILES.append(path)


def process_rank() -> int:
    """This process's rank in the started process group (0 without one)."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def print_log(*console_info):
    """One console line from the parts, appended to the log file if one is
    set, on rank 0 only; a failed append drops the line rather than stop a
    training step."""
    if process_rank() != 0:
        return
    msg = " ".join(str(i) for i in console_info)
    print(msg)
    for f in _LOG_FILES:
        try:
            with open(f, "a") as fh:
                fh.write(msg + "\n")
        except OSError:
            pass


class MetricAccumulator:
    """Weighted running means of scalar metrics."""

    def __init__(self):
        self.sums: dict[str, float] = {}
        self.weights: dict[str, float] = {}

    def accumulate(self, metrics: Mapping[str, float], weight: float = 1.0):
        for k, v in metrics.items():
            self.sums[k] = self.sums.get(k, 0.0) + float(v) * weight
            self.weights[k] = self.weights.get(k, 0.0) + weight

    def means(self) -> dict[str, float]:
        """{metric: weighted mean}; across processes the mean of the ranks'
        means (every rank must hold the same metric names)."""
        local = {k: self.sums[k] / max(self.weights[k], 1e-12) for k in self.sums}
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            from vdtpu_torch.parallel.collectives import all_reduce_scalars
            keys = sorted(local)
            vals = all_reduce_scalars([local[k] for k in keys], dist.group.WORLD)
            local = dict(zip(keys, vals))
        return local

    def summary(self) -> str:
        return " ".join(f"{k}:{v:.4f}" for k, v in sorted(self.means().items()))

    def reset(self):
        self.sums.clear()
        self.weights.clear()
