"""Logging (``vdtpu/utils/logging.py``): ``print_log``, the run's log file
(``set_log_file``, which the training launcher registers) and
``MetricAccumulator`` (weighted running means of scalar metrics).

One process drives one card here, so there is no cross-process mean. The
JAX package's multi-host gather and TensorBoard writer are not ported.
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


def print_log(*console_info):
    """One console line from the parts, appended to the log file if one is
    set; a failed append drops the line rather than stop a training step."""
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
        return {k: self.sums[k] / max(self.weights[k], 1e-12) for k in self.sums}

    def summary(self) -> str:
        return " ".join(f"{k}:{v:.4f}" for k, v in sorted(self.means().items()))

    def reset(self):
        self.sums.clear()
        self.weights.clear()
