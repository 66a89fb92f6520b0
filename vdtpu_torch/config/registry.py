"""Component registry of the port: config ``type`` name -> module class
(or factory function).

The port's own table (the JAX package's maps to flax classes). Classes are
imported when first looked up, so importing the registry builds nothing.
"""
from __future__ import annotations

import importlib
from typing import Any

_TYPES = {
    "openai_unet_2d_next": ("vdtpu_torch.models.unet", "UNet2DNext"),
    "openai_unet_0d_next": ("vdtpu_torch.models.unet", "UNet0DNext"),
    "autoencoderkl": ("vdtpu_torch.models.autoencoder", "AutoencoderKL"),
    "clip_text_context_encoder": ("vdtpu_torch.models.clip", "CLIPTextContextEncoder"),
    "clip_image_context_encoder": ("vdtpu_torch.models.clip", "CLIPImageContextEncoder"),
    "optimus_vae_next": ("vdtpu_torch.models.optimus", "build_optimus"),
    "optimus_bert_connector": ("vdtpu_torch.models.optimus", "OptimusBertConnector"),
    "optimus_gpt2_connector": ("vdtpu_torch.models.optimus", "OptimusGPT2Connector"),
    "optimus_bert_tokenizer": ("vdtpu_torch.models.optimus", "build_bert_tokenizer"),
    "optimus_gpt2_tokenizer": ("vdtpu_torch.models.optimus", "build_gpt2_tokenizer"),
    # the legacy (pre-v2) diffuser zoo, vdtpu/models/legacy.py's nine families
    "openai_unet": ("vdtpu_torch.models.legacy", "LegacyUNetModel"),
    "openai_unet_dual_context": ("vdtpu_torch.models.legacy", "LegacyUNetDualContext"),
    "openai_unet_nocontext": ("vdtpu_torch.models.legacy", "LegacyUNetNoContext"),
    "openai_unet_nocontext_noatt": ("vdtpu_torch.models.legacy", "LegacyUNetNoContextNoAtt"),
    "openai_unet_nocontext_noatt_decoderonly": ("vdtpu_torch.models.legacy",
                                                "LegacyDecoderOnly"),
    "openai_unet_2d": ("vdtpu_torch.models.legacy", "legacy_unet_2d"),
    "openai_unet_0d": ("vdtpu_torch.models.legacy", "LegacyUNet0D"),
    "openai_unet_0dmd": ("vdtpu_torch.models.legacy", "LegacyUNet0DMultiDim"),
    "openai_unet_vd": ("vdtpu_torch.models.legacy", "LegacyUNetVD"),
}


def get_class(type_name: str):
    if type_name not in _TYPES:
        raise KeyError(f"component type {type_name!r} is not ported; the port has "
                       f"{sorted(_TYPES)}")
    module, cls = _TYPES[type_name]
    return getattr(importlib.import_module(module), cls)


def build(cfg: dict, **overrides) -> Any:
    """Instantiate a component from a resolved config ({type, args})."""
    args = dict(cfg.get("args") or {})
    args.update(overrides)
    return get_class(cfg["type"])(**args)
