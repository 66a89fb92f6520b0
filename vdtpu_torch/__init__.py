"""Versatile Diffusion on PyTorch and CUDA: the port of the JAX package
``vdtpu`` to one NVIDIA H100. Modules keep the JAX package's names.

Public surface (lazy imports keep ``import vdtpu_torch`` light):
  vdtpu_torch.VDSystem / VDInference / vd_inference: serving
  vdtpu_torch.model_cfg_bank: the named model-config bank
  vdtpu_torch.VDModel, DDIMSampler, BatchingQueue
"""

_LAZY = {
    "VDSystem": ("vdtpu_torch.serving.api", "VDSystem"),
    "VDInference": ("vdtpu_torch.serving.api", "VDInference"),
    "vd_inference": ("vdtpu_torch.serving.api", "vd_inference"),
    "model_cfg_bank": ("vdtpu_torch.config.configs", "model_cfg_bank"),
    "VDModel": ("vdtpu_torch.models.vd", "VDModel"),
    "DDIMSampler": ("vdtpu_torch.sampling.ddim", "DDIMSampler"),
    "BatchingQueue": ("vdtpu_torch.serving.queue", "BatchingQueue"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'vdtpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
