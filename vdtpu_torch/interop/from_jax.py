"""JAX param trees -> the port's state dict (numpy, reference torch keys).

The port's own copy of the renaming and transposing rules of
``vdtpu/interop/torch_convert.py::flax_to_torch`` and ``vd_conv1x1_pred``:
a flax path joined with "." plus the leaf renamed (kernel/scale/embedding
-> weight) is the torch key; conv kernels [kh, kw, I, O] become
[O, I, kh, kw], dense kernels [I, O] become [O, I], and the dense kernels
that the reference stores as 1x1 convs get [O, I, 1, 1].

Input leaves are numpy arrays, e.g. ``jax.device_get(system.params[...])``.
The same rules convert every tree the port builds: the diffusers, both
CLIP context encoders (``ctx.image``: the patch-embedding conv, the class
and position embeddings, HF's LayerNorm names), the whole image VAE
(``encoder``, ``quant_conv``, ``decoder``, ``post_quant_conv``) and the
Optimus text VAE (BERT and GPT-2 towers); ``loss_state_dict_from_jax``
converts the VAE training loss (LPIPS, the discriminator and its
BatchNorm statistics); ``legacy_state_dict_from_jax`` the legacy diffuser
zoo (``vdtpu/models/legacy.py``). ``quant_state_from_jax`` converts the int8 serving policy's calibrated
scales and weight tables the same way.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np

_LEAF_RENAME = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def vd_conv1x1_pred(torch_key: str) -> bool:
    """Dense in flax, 1x1 Conv2d in the reference: SpatialTransformer
    proj_in/proj_out and the 0-D diffuser's FC-block convs."""
    k = torch_key
    if k.endswith((".proj_in.weight", ".proj_out.weight")) and "context_blocks" in k:
        return True
    return "diffuser.text." in k and "data_blocks" in k and k.endswith(
        ("in_layers.2.weight", "out_layers.3.weight", "skip_connection.weight"))


def _flatten(tree: Mapping[str, Any], path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, path + (k,))
        else:
            yield path + (k,), v


def state_dict_from_jax(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    """One flax param tree -> {prefix + torch key: numpy array}."""
    sd: dict[str, np.ndarray] = {}
    for path, val in _flatten(tree):
        *parents, leaf = path
        key = prefix + ".".join([*parents, _LEAF_RENAME.get(leaf, leaf)])
        v = np.asarray(val)
        if leaf == "kernel":
            if v.ndim == 4:
                v = v.transpose(3, 2, 0, 1)
            elif v.ndim == 3:
                v = v.transpose(2, 1, 0)
            elif v.ndim == 2:
                v = v.T
                if vd_conv1x1_pred(key):
                    v = v[:, :, None, None]
        sd[key] = v
    return sd


# GPT-2's Conv1D projections: weight [in, out] in the reference, which is
# the flax kernel as it is (the dense rule above transposes it)
GPT2_CONV1D = (".attn.c_attn.weight", ".attn.c_proj.weight", ".mlp.c_fc.weight",
               ".mlp.c_proj.weight")


def system_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """A JAX ``VDSystem.params`` tree ({"diffuser", "vae", "ctx"}) -> the flat
    reference checkpoint, key for key what ``VDSystem.export_torch_checkpoint``
    writes; the Optimus text VAE's ``{"encoder", "decoder"}`` trees go under
    ``vae.text.encoder.`` / ``vae.text.decoder.``, its Conv1D kernels
    untransposed."""
    sd = state_dict_from_jax(params["diffuser"], "diffuser.")
    for name, p in params.get("vae", {}).items():
        if name == "text":
            for tower in ("encoder", "decoder"):
                part = state_dict_from_jax(p[tower], f"vae.text.{tower}.")
                sd.update({k: (v.T if k.endswith(GPT2_CONV1D) else v) for k, v in part.items()})
            continue
        sd.update(state_dict_from_jax(p, f"vae.{name}."))
    for name, p in params.get("ctx", {}).items():
        sd.update(state_dict_from_jax(p, f"ctx.{name}.model."))
    return sd


# dense kernels of the legacy zoo that the port keeps as 1x1 convs
# ([O, I, 1, 1], ``Conv1x1Linear``): the transformers' projections and the
# FC blocks' convs (the ResBlocks' are 3x3 / 1x1 conv kernels already)
_LEGACY_1X1 = (".proj_in.weight", ".proj_out.weight", ".proj_in_0.weight",
               ".proj_in_1.weight", ".proj_out_0.weight", ".proj_out_1.weight",
               ".in_layers.2.weight", ".out_layers.3.weight", ".skip_connection.weight")


def legacy_state_dict_from_jax(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    """A param tree of vdtpu's legacy zoo (one family, numpy leaves) -> the
    state dict of the port's module (``vdtpu_torch/models/legacy.py``), the
    reference's keys: every layer of ``state_dict_from_jax``'s rules (the
    time and label embeddings, ``id_predictor``, the DualSpatialTransformer's
    ``norm_i`` / ``proj_in_i`` / ``transformer_blocks_i.d`` / ``proj_out_i``),
    with the transformers' projections and the FC blocks' convs as
    [O, I, 1, 1]; the AttentionBlock's ``qkv`` and ``proj_out`` stay
    [O, I]."""
    sd = state_dict_from_jax(tree, prefix)
    attn = {k[:-len("qkv.weight")] for k in sd if k.endswith(".qkv.weight")}
    for k, v in sd.items():
        attn_proj = k.endswith(".proj_out.weight") and k[:-len("proj_out.weight")] in attn
        if v.ndim == 2 and k.endswith(_LEGACY_1X1) and not attn_proj:
            sd[k] = v[:, :, None, None]
    return sd


_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def loss_state_dict_from_jax(tree: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """vdtpu's VAE loss tree (``LPIPSWithDiscriminator.init_params``:
    ``{"lpips", "discriminator", "disc_stats", "logvar"}``) -> the state dict
    of ``models/autokl_loss.py::LPIPSWithDiscriminator``: conv kernels
    [kh, kw, I, O] -> [O, I, kh, kw]; BatchNorm ``scale`` / ``bias`` ->
    ``weight`` / ``bias``, its ``mean`` / ``var`` statistics ->
    ``running_mean`` / ``running_var``."""
    sd = state_dict_from_jax(tree["lpips"], "lpips.")
    sd.update(state_dict_from_jax(tree["discriminator"], "discriminator."))
    for path, v in _flatten(tree.get("disc_stats") or {}):
        *parents, leaf = path
        sd["discriminator." + ".".join([*parents, _BN_STATS[leaf]])] = np.asarray(v)
    sd["logvar"] = np.asarray(tree["logvar"], np.float32).reshape(())
    return sd


def _leaf_nodes(tree: Mapping[str, Any], path=()):
    """(path, {leaf name: value}) for every node of a nested dict with leaves."""
    leaves = {k: v for k, v in tree.items() if not isinstance(v, Mapping)}
    if leaves:
        yield path, leaves
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaf_nodes(v, path + (k,))


def quant_state_from_jax(scales: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """The JAX ``quant`` collection (``system.params["diffuser"]["quant"]``
    after ``enable_int8``, numpy leaves) -> the port's quant buffers,
    ``quant_state`` keys relative to the ``MultiDiffuser``.

    Scales become 0-d (``act_scale``, ``act_scale_kv``) or [H]
    (``attn_shift``); conv tables [3, 3, C, N] become [N, 3, 3, C] and
    dense tables [K, N] become [N, K], with [N] scales. An attention owner
    (a node with ``attn_shift``) holds its projections' tables side by
    side (q|k|v, or q and k|v with a ``_kv`` site); they are split onto
    ``to_q``, ``to_k`` and ``to_v``."""
    out: dict[str, np.ndarray] = {}
    f32 = lambda v: np.asarray(v, np.float32)
    for path, leaves in _leaf_nodes(scales):
        at = lambda *names: ".".join(path + names)
        for key in ("act_scale", "act_scale_kv"):
            if key in leaves:
                out[at(key)] = f32(leaves[key]).reshape(())
        if "attn_shift" in leaves:
            out[at("attn_shift")] = f32(leaves["attn_shift"]).reshape(-1)
            groups = ([("w_q", "w_scale", ("to_q",)), ("w_q_kv", "w_scale_kv", ("to_k", "to_v"))]
                      if "act_scale_kv" in leaves else
                      [("w_q", "w_scale", ("to_q", "to_k", "to_v"))])
            for wkey, skey, names in groups:
                if wkey not in leaves:
                    continue
                wq = np.asarray(leaves[wkey], np.int8)
                ws = f32(leaves[skey]).reshape(-1)
                f = wq.shape[1] // len(names)
                for i, name in enumerate(names):
                    out[at(name, "w_q")] = np.ascontiguousarray(wq[:, i * f:(i + 1) * f].T)
                    out[at(name, "w_scale")] = ws[i * f:(i + 1) * f].copy()
        elif "w_q" in leaves:
            wq = np.asarray(leaves["w_q"], np.int8)
            wq = wq.transpose(3, 0, 1, 2) if wq.ndim == 4 else wq.T
            out[at("w_q")] = np.ascontiguousarray(wq)
            out[at("w_scale")] = f32(leaves["w_scale"]).reshape(-1)
    return out
