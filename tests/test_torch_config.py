"""The port's literal configs against the JAX package's resolved YAML bank,
over the keys the port reads."""
import pytest
import torch

from vdtpu.config.bank import model_cfg_bank as jax_bank
from vdtpu_torch.config.configs import model_cfg_bank
from vdtpu_torch.config.registry import build, get_class

torch.set_num_threads(2)

TOP_KEYS = ("beta_linear_start", "beta_linear_end", "timesteps", "global_layer_ptr",
            "latent_scale_factor")


def _entry(cfg_list, name):
    return dict(cfg_list)[name]


@pytest.mark.parametrize("name", ["vd_four_flow_v1-0", "vd_test_tiny"])
def test_literals_match_bank(name):
    ours, ref = model_cfg_bank()(name), jax_bank()(name)
    assert ours["type"] == ref["type"]
    for k in TOP_KEYS:
        assert ours["args"].get(k) == ref["args"].get(k), k
    for lst in ("diffuser_cfg_list", "vae_cfg_list", "ctx_cfg_list"):
        for sub_name, sub in ours["args"][lst]:
            want = _entry(ref["args"][lst], sub_name)
            assert (sub["type"], sub["args"]) == (want["type"], want["args"]), (lst, sub_name)
    assert [n for n, _ in ours["args"]["diffuser_cfg_list"]] == \
        [n for n, _ in ref["args"]["diffuser_cfg_list"]]


@pytest.mark.parametrize("name", ["optimus_v1", "optimus_bert_encoder", "optimus_gpt2_decoder",
                                  "optimus_tiny"])
def test_text_vae_literals_match_bank(name):
    ours, ref = model_cfg_bank()(name), jax_bank()(name)
    assert (ours["type"], ours["args"]) == (ref["type"], ref["args"])


@pytest.mark.parametrize("name", ["vd_four_flow_v1-0", "vd_test_tiny"])
def test_every_component_type_builds(name):
    cfg = model_cfg_bank()(name)
    for lst in ("diffuser_cfg_list", "vae_cfg_list", "ctx_cfg_list"):
        for _, sub in cfg["args"][lst]:
            assert get_class(sub["type"]) is not None
    with torch.device("meta"):  # full width without allocating it
        unet = build(cfg["args"]["diffuser_cfg_list"][0][1])
    assert len(unet.program.ctx) == len(unet.context_blocks)


def test_bank_returns_copies_and_rejects_unknown():
    bank = model_cfg_bank()
    a = bank("vd_test_tiny")
    a["args"]["timesteps"] = 1
    assert bank("vd_test_tiny")["args"]["timesteps"] == 1000
    with pytest.raises(KeyError):
        bank("openai_unet_2d_v1_g")   # in the JAX bank, not built by the port
