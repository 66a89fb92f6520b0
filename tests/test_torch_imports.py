"""Import hygiene of the port: ``vdtpu_torch`` and ``chip_smoke.py`` use
torch, never JAX, flax, YAML or the JAX package ``vdtpu``."""
import os
import pkgutil
import re
import subprocess
import sys

import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "vdtpu_torch")

_BLOCKED = ("jax", "jaxlib", "flax", "yaml", "vdtpu")
_IMPORT_RE = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|flax|yaml|vdtpu)(?:\.|\s|$)",
                        re.MULTILINE)


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


# modules of the int8 + ToMe slice and of the training slice: they name no
# attention library call at all
_SLICE2 = ("ops/nomax.py", "ops/qconv.py", "ops/quant.py", "ops/tome.py",
           "csrc/nomax_fwd.cu", "csrc/qconv3.cu", "csrc/flash_bwd.cu", "ops/flash.py",
           "training/harness.py", "training/optim.py", "training/ema.py",
           "training/schedulers.py", "training/checkpoints.py", "utils/logging.py",
           "csrc/qconv_tile.cuh", "csrc/resblock_q.cu", "ops/resize.py",
           "models/distributions.py", "serving/postprocess.py", "models/optimus.py",
           "data/tokenizers.py", "ops/probes.py", "probes.py", "csrc/probe_s8mm.cu",
           "utils/timing.py", "serving/queue.py", "serving/cli.py", "serving/webui.py")


def test_every_module_imports_with_jax_flax_yaml_blocked():
    modules = ["vdtpu_torch"] + [m.name for m in pkgutil.walk_packages([PKG], "vdtpu_torch.")]
    assert len(modules) > 15
    assert {"vdtpu_torch.ops.nomax", "vdtpu_torch.ops.qconv", "vdtpu_torch.ops.quant",
            "vdtpu_torch.ops.tome"} <= set(modules)
    assert {"vdtpu_torch.training.harness", "vdtpu_torch.training.optim",
            "vdtpu_torch.training.ema", "vdtpu_torch.training.schedulers",
            "vdtpu_torch.training.checkpoints", "vdtpu_torch.utils.logging"} <= set(modules)
    assert {"vdtpu_torch.ops.resize", "vdtpu_torch.models.distributions",
            "vdtpu_torch.serving.postprocess"} <= set(modules)
    assert {"vdtpu_torch.models.optimus", "vdtpu_torch.data.tokenizers",
            "vdtpu_torch.ops.probes", "vdtpu_torch.probes",
            "vdtpu_torch.utils.timing"} <= set(modules)
    assert {"vdtpu_torch.serving.queue", "vdtpu_torch.serving.cli",
            "vdtpu_torch.serving.webui"} <= set(modules)
    code = "\n".join([
        "import importlib, sys",
        *[f"sys.modules[{name!r}] = None" for name in _BLOCKED],
        f"for m in {modules!r}: importlib.import_module(m)",
        "import chip_smoke",
        "print('imported', len(sys.modules))",
    ])
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_sources_name_no_jax_package_and_no_library_attention():
    for path in _sources():
        with open(path) as f:
            text = f.read()
        rel = os.path.relpath(path, ROOT)
        assert not _IMPORT_RE.search(text), f"{rel} imports a JAX-side module"
        if rel.startswith("vdtpu_torch"):
            # the port's path holds no library attention and no compiler
            assert "F.scaled_dot_product_attention" not in text, rel
            assert "functional.scaled_dot_product_attention" not in text, rel
            assert "torch.compile" not in text, rel


def test_slice2_sources_name_no_library_attention_or_compiler():
    for rel in _SLICE2:
        with open(os.path.join(PKG, rel)) as f:
            text = f.read()
        assert "scaled_dot_product_attention" not in text, rel
        assert "torch.compile" not in text, rel
