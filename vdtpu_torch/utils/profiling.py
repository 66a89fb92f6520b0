"""Tracing and profiling (``vdtpu/utils/profiling.py``).

- ``trace(log_dir)``: a ``torch.profiler`` capture (CPU, and the card's
  kernels where there is one) whose Chrome trace is written to
  ``<log_dir>/trace.json`` on exit; it yields the profiler.
- ``annotate(name)``: a named range in the trace (``record_function``).
- ``Timer``: a wall timer whose ``stop`` waits for the card first.
- ``ThroughputMeter``: units/s and steps/s over a window.
- ``device_memory_stats()``: the card's allocator counters in bytes
  (``torch.cuda.memory_stats``), by device; empty on the CPU.
- ``summarize_trace(log_dir)``: the device kernel events of a written
  trace (kernels, copies and sets; not the annotated ranges' device spans,
  which would count their kernels twice), summed by op class, in ms.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import time
from typing import Callable, Iterator

import torch

TRACE_FILE = "trace.json"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a trace; ``<log_dir>/trace.json`` (Chrome / Perfetto)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside a trace."""
    with torch.profiler.record_function(name):
        yield


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Wall timer; ``stop`` synchronizes the card before it reads the clock."""

    def __init__(self):
        _sync()
        self.start = time.perf_counter()

    def stop(self, result=None) -> float:
        del result   # the device is synchronized whatever was computed
        _sync()
        return time.perf_counter() - self.start


class ThroughputMeter:
    """Images/s / tokens/s style counters for step loops."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._units = 0.0
        self._steps = 0

    def update(self, units: float):
        self._units += units
        self._steps += 1

    def rates(self) -> dict[str, float]:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return {"units_per_sec": self._units / dt,
                "steps_per_sec": self._steps / dt,
                "window_sec": dt}


def device_memory_stats() -> dict[str, dict[str, int]]:
    """{"cuda:<i>": {allocator counter with "bytes" in its name: value}}."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return {}
    return {f"cuda:{i}": {k: v for k, v in torch.cuda.memory_stats(i).items() if "bytes" in k}
            for i in range(torch.cuda.device_count())}


def op_class(name: str) -> str:
    """A kernel's name without its trailing digits and dots."""
    return re.sub(r"[.\d]+$", "", name)


def summarize_trace(log_dir: str, top: int | None = 20,
                    classify: Callable[[str], str] = op_class,
                    device: bool = True) -> dict[str, float]:
    """ms by class (``classify`` of the event's name) of the device events
    of ``<log_dir>/trace.json``, the ``top`` largest (None: all);
    ``device=False`` sums the host's operator events instead."""
    path = os.path.join(log_dir, TRACE_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {TRACE_FILE} under {log_dir}")
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    cats = _DEVICE_CATS if device else ("cpu_op",)
    dur: collections.Counter = collections.Counter()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in cats:
            dur[classify(e.get("name", ""))] += float(e.get("dur", 0))
    return {k: v / 1000.0 for k, v in dur.most_common(top)}
