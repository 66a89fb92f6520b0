"""Logging (``vdtpu/utils/logging.py``): ``print_log`` and
``MetricAccumulator`` (weighted running means of scalar metrics).

One process drives one card here, so there is no cross-process mean. The
JAX package's log-file registration (``set_log_file``, which its launch
CLI calls), multi-host gather and TensorBoard writer are not ported.
"""
from __future__ import annotations

from typing import Mapping


def print_log(*console_info):
    """One console line from the parts."""
    print(" ".join(str(i) for i in console_info))


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
