"""Experiment configurations of the training launcher as Python literals
(``vdtpu/config/experiments/*.yaml``; the port reads no YAML).

``load_experiment(arg)`` takes the name of a literal here or the path of a
JSON file with the same keys.
"""
from __future__ import annotations

import copy
import json
import os
from typing import Any

# vdtpu/config/experiments/vd_laion_t2i.yaml: fine-tune the t2i flow on
# Laion-style webdataset shards
VD_LAION_T2I: dict[str, Any] = {
    "name": "vd_laion_t2i",
    "model": "vd_four_flow_v1-0",
    "bf16": True,
    "pretrained": None,          # path to vd-four-flow-v1-0.pth to fine-tune
    "clip_vocab": None,          # path to CLIP vocab.json
    "clip_merges": None,         # path to CLIP merges.txt
    "data": {
        "shards": "/data/laion/tars",
        "batch_size": 64,
        "image_size": 512,
        "shuffle_buffer": 2000,
    },
    "train": {
        "x_type": "image",
        "c_type": "text",
        "num_iters": 100000,
        "batch_size": 64,
        "gradacc_every": 2,
        "tp": 1,
        "optimizer": "adamw",
        "optimizer_args": {"weight_decay": 0.01},
        "pg_lrscale": {
            "diffuser_image_data": 1.0,
            "diffuser_image_context": 1.0,
            "diffuser_text_data": 0.5,
            "diffuser_text_context": 0.5,
        },
        "scheduler": {"type": "stable_diffusion_linear", "base_lr": 1.0e-07,
                      "num_itr": 100000},
        "ema_decay": 0.9999,
        "log_every": 100,
        "ckpt_every": 5000,
    },
}

EXPERIMENTS = {"vd_laion_t2i": VD_LAION_T2I}


def load_experiment(arg: str) -> dict[str, Any]:
    """A copy of the literal named ``arg``, else the JSON file at ``arg``."""
    if arg in EXPERIMENTS:
        return copy.deepcopy(EXPERIMENTS[arg])
    if not os.path.exists(arg):
        raise FileNotFoundError(f"--config {arg!r}: neither an experiment of "
                                f"{sorted(EXPERIMENTS)} nor a JSON file")
    with open(arg) as f:
        return json.load(f)
