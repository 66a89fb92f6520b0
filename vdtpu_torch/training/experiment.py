"""Experiment bootstrap (``vdtpu/training/experiment.py``): the run
directory, the config dump, the code snapshot, seeding and resume.

- experiment id = unix time x 100; ``debug`` pins it to 999999999999 with
  the signature "debug", so a debug run overwrites the last one;
- the run dir ``<log_root>/<name>/<id>[_<signature>]`` with ``weight/``
  (checkpoints) and ``tensorboard/``;
- the resolved config dumped as ``config.json`` (the port reads no YAML),
  an existing dump moved to ``config.json.version<n>`` first;
- a snapshot of the ``vdtpu_torch`` package under ``code/``;
- ``resume(dir)`` reads the dumped config back, dumps a versioned copy and
  logs into the same ``train.log``.

Under a started process group every rank builds an ``Experiment``, but
rank 0 alone makes the run dir, dumps the config and snapshots the code,
and broadcasts the dir (the experiment id is the clock's, so each rank
would otherwise name its own); on resume rank 0 reads the config and
broadcasts it, then dumps the versioned copy.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any

import numpy as np

from vdtpu_torch.utils.logging import process_rank, set_log_file

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def get_experiment_id(ref_time: float | None = None) -> int:
    return int((time.time() if ref_time is None else ref_time) * 100)


class Experiment:
    """Owns the run directory, the config and code snapshot, and resume."""

    def __init__(self, cfg: dict[str, Any], log_root: str = "log",
                 signature: list[str] | None = None, debug: bool = False,
                 seed: int | None = None):
        self.cfg = cfg
        self.debug = debug
        self.seed = seed
        if debug:
            self.experiment_id = 999999999999
            signature = ["debug"]
        else:
            self.experiment_id = get_experiment_id()
        sig = "_".join(str(s) for s in (signature or []))
        name = cfg.get("name", cfg.get("model", "experiment"))
        self._set_dir(os.path.join(log_root, str(name),
                                   f"{self.experiment_id}" + (f"_{sig}" if sig else "")))

    def _set_dir(self, log_dir: str):
        self.log_dir = log_dir
        self.weight_dir = os.path.join(log_dir, "weight")
        self.tb_dir = os.path.join(log_dir, "tensorboard")

    def initiate(self, snapshot_code: bool = True) -> "Experiment":
        from vdtpu_torch.parallel.collectives import broadcast_object
        if process_rank() == 0:
            os.makedirs(self.weight_dir, exist_ok=True)
            os.makedirs(self.tb_dir, exist_ok=True)
            self.dump_cfg()
            if snapshot_code:
                self.save_code()
        self._set_dir(broadcast_object(self.log_dir, src=0))
        set_log_file(os.path.join(self.log_dir, "train.log"))
        if self.seed is not None:
            np.random.seed(self.seed)
        return self

    def dump_cfg(self, name: str = "config.json"):
        path = os.path.join(self.log_dir, name)
        if os.path.exists(path):
            n = 0
            while os.path.exists(f"{path}.version{n}"):
                n += 1
            shutil.move(path, f"{path}.version{n}")
        with open(path, "w") as f:
            json.dump(self.cfg, f, indent=1)

    def save_code(self):
        """Snapshot the ``vdtpu_torch`` package into ``<run>/code``."""
        shutil.copytree(_PKG, os.path.join(self.log_dir, "code", "vdtpu_torch"),
                        dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__", "*.so", "*.pyc"))

    @classmethod
    def resume(cls, resume_dir: str) -> "Experiment":
        from vdtpu_torch.parallel.collectives import broadcast_object
        cfg = None
        if process_rank() == 0:
            with open(os.path.join(resume_dir, "config.json")) as f:
                cfg = json.load(f)
        cfg = broadcast_object(cfg, src=0)
        exp = cls.__new__(cls)
        exp.cfg, exp.debug, exp.seed = cfg, False, None
        exp._set_dir(resume_dir)
        exp.experiment_id = cfg.get("experiment_id", 0)
        if process_rank() == 0:
            exp.dump_cfg()   # a versioned copy for the resumed run
        set_log_file(os.path.join(exp.log_dir, "train.log"))
        return exp
