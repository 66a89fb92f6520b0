"""The model configs of this slice as Python literals.

The JAX package resolves its configs from YAML (``vdtpu/config/configs/``);
the machine with the card has no YAML parser, so the port carries the
resolved entries it builds: ``vd_four_flow_v1-0`` (with ``autokl_v1``,
``optimus_v1``, ``clip_image_context_encoder``, ``clip_text_context_encoder``,
``openai_unet_2d_v1`` and ``openai_unet_0d_v1_dc``) and ``vd_test_tiny``
with its parts (``optimus_tiny`` its text VAE). The Optimus tokenizers'
vocabulary paths are the bank's; the files are user-supplied, and a text
VAE built without them decodes to token ids.
``tests/test_torch_config.py`` holds these literals against the resolved
JAX bank.
"""
from __future__ import annotations

import copy

AUTOKL_V1 = {
    "type": "autoencoderkl",
    "name": "autokl_v1",
    "args": {
        "embed_dim": 4,
        "ddconfig": {
            "double_z": True, "z_channels": 4, "resolution": 256, "in_channels": 3,
            "out_ch": 3, "ch": 128, "ch_mult": [1, 2, 4, 4], "num_res_blocks": 2,
            "attn_resolutions": [], "dropout": 0.0,
        },
    },
}

CLIP_TEXT_CONTEXT_ENCODER = {
    "type": "clip_text_context_encoder",
    "name": "clip_text_context_encoder",
    "args": {},  # ViT-L/14 text tower defaults (models/clip.py)
}

CLIP_IMAGE_CONTEXT_ENCODER = {
    "type": "clip_image_context_encoder",
    "name": "clip_image_context_encoder",
    "args": {},  # ViT-L/14 vision tower defaults (models/clip.py)
}

OPTIMUS_BERT_ENCODER = {
    "symbol": "optimus",
    "type": "optimus_bert_connector",
    "name": "optimus_bert_encoder",
    "args": {
        "config": {
            "hidden_act": "gelu", "hidden_size": 768, "intermediate_size": 3072,
            "layer_norm_eps": 1e-12, "max_position_embeddings": 512,
            "num_attention_heads": 12, "num_hidden_layers": 12, "type_vocab_size": 2,
            "vocab_size": 28996, "attention_probs_dropout_prob": 0.1,
            "hidden_dropout_prob": 0.1, "initializer_range": 0.02,
        },
        "latent_size": 768,
    },
}

OPTIMUS_BERT_TOKENIZER = {
    "symbol": "optimus",
    "type": "optimus_bert_tokenizer",
    "name": "optimus_bert_tokenizer",
    "args": {"do_lower_case": False, "max_len": 512,
             "vocab_file": "vocab/bert-base-cased-vocab.txt"},
}

OPTIMUS_GPT2_DECODER = {
    "symbol": "optimus",
    "type": "optimus_gpt2_connector",
    "name": "optimus_gpt2_decoder",
    "args": {
        "config": {
            "hidden_size": 768, "latent_size": 768, "layer_norm_epsilon": 1e-05,
            "max_position_embeddings": 1024, "n_ctx": 1024, "n_embd": 768, "n_head": 12,
            "n_layer": 12, "n_positions": 1024, "vocab_size": 50260, "attn_pdrop": 0.1,
            "embd_pdrop": 0.1, "resid_pdrop": 0.1, "initializer_range": 0.02,
        },
    },
}

OPTIMUS_GPT2_TOKENIZER = {
    "symbol": "optimus",
    "type": "optimus_gpt2_tokenizer",
    "name": "optimus_gpt2_tokenizer",
    "args": {"do_lower_case": False, "max_len": 1024, "vocab_file": "vocab/gpt2-vocab.json",
             "merges_file": "vocab/gpt2-merges.txt"},
}

OPTIMUS_V1 = {
    "symbol": "optimus",
    "type": "optimus_vae_next",
    "name": "optimus_v1",
    "args": {
        "encoder": OPTIMUS_BERT_ENCODER, "decoder": OPTIMUS_GPT2_DECODER,
        "tokenizer_encoder": OPTIMUS_BERT_TOKENIZER,
        "tokenizer_decoder": OPTIMUS_GPT2_TOKENIZER,
        "args": {"latent_size": 768},
    },
}

OPENAI_UNET_2D_V1 = {
    "type": "openai_unet_2d_next",
    "name": "openai_unet_2d_v1",
    "args": {
        "in_channels": 4, "out_channels": 4, "model_channels": 320,
        "attention_resolutions": [4, 2, 1], "num_res_blocks": [2, 2, 2, 2],
        "channel_mult": [1, 2, 4, 4], "num_heads": 8, "context_dim": 768,
        "use_checkpoint": True, "parts": ["global", "data", "context"],
    },
}

OPENAI_UNET_0D_V1_DC = {
    "type": "openai_unet_0d_next",
    "name": "openai_unet_0d_v1_dc",
    "args": {
        "input_channels": 768, "model_channels": 320, "output_channels": 768,
        "num_noattn_blocks": [2, 2, 2, 2], "channel_mult": [1, 2, 4, 4],
        "second_dim": [4, 4, 4, 4], "with_attn": [True, True, True, False],
        "num_heads": 8, "context_dim": 768, "use_checkpoint": True,
        "parts": ["data", "context"],
    },
}

VD_FOUR_FLOW_V1_0 = {
    "type": "vd_v2_0",
    "name": "vd_four_flow_v1-0",
    "args": {
        "beta_linear_start": 0.00085, "beta_linear_end": 0.012, "timesteps": 1000,
        "use_ema": False,
        "vae_cfg_list": [["image", AUTOKL_V1], ["text", OPTIMUS_V1]],
        "ctx_cfg_list": [["image", CLIP_IMAGE_CONTEXT_ENCODER],
                         ["text", CLIP_TEXT_CONTEXT_ENCODER]],
        "diffuser_cfg_list": [["image", OPENAI_UNET_2D_V1], ["text", OPENAI_UNET_0D_V1_DC]],
        "global_layer_ptr": "image",
        "latent_scale_factor": {"image": 0.18215},
    },
}

AUTOKL_TINY = {
    "type": "autoencoderkl",
    "name": "autokl_tiny",
    "args": {
        "embed_dim": 4,
        "ddconfig": {
            "double_z": True, "z_channels": 4, "resolution": 64, "in_channels": 3,
            "out_ch": 3, "ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1,
            "attn_resolutions": [], "dropout": 0.0,
        },
    },
}

OPTIMUS_BERT_TINY = {
    "type": "optimus_bert_connector",
    "name": "optimus_bert_tiny",
    "args": {
        "config": {
            "vocab_size": 500, "hidden_size": 64, "num_hidden_layers": 2,
            "num_attention_heads": 4, "intermediate_size": 128, "max_position_embeddings": 64,
            "type_vocab_size": 2, "layer_norm_eps": 1e-12,
        },
        "latent_size": 96,
    },
}

OPTIMUS_GPT2_TINY = {
    "type": "optimus_gpt2_connector",
    "name": "optimus_gpt2_tiny",
    "args": {
        "config": {
            "vocab_size": 600, "n_embd": 64, "n_layer": 2, "n_head": 4, "n_positions": 64,
            "n_ctx": 64, "hidden_size": 64, "latent_size": 96, "layer_norm_epsilon": 1e-05,
        },
    },
}

OPTIMUS_TINY = {
    "type": "optimus_vae_next",
    "name": "optimus_tiny",
    "args": {"encoder": OPTIMUS_BERT_TINY, "decoder": OPTIMUS_GPT2_TINY,
             "args": {"latent_size": 96}},
}

CLIP_TEXT_TINY = {
    "type": "clip_text_context_encoder",
    "name": "clip_text_tiny",
    "args": {
        "tower": {"hidden": 64, "layers": 2, "heads": 4, "intermediate": 128},
        "vocab_size": 1000, "max_len": 16, "projection_dim": 96,
    },
}

CLIP_IMAGE_TINY = {
    "type": "clip_image_context_encoder",
    "name": "clip_image_tiny",
    "args": {
        "tower": {"hidden": 64, "layers": 2, "heads": 4, "intermediate": 128},
        "image_size": 56, "patch": 14, "projection_dim": 96,
    },
}

OPENAI_UNET_2D_TINY = {
    "type": "openai_unet_2d_next",
    "name": "openai_unet_2d_tiny",
    "args": {
        "in_channels": 4, "out_channels": 4, "model_channels": 32,
        "attention_resolutions": [1, 2], "num_res_blocks": [1, 1], "channel_mult": [1, 2],
        "num_heads": 4, "context_dim": 96, "parts": ["global", "data", "context"],
    },
}

OPENAI_UNET_0D_TINY_DC = {
    "type": "openai_unet_0d_next",
    "name": "openai_unet_0d_tiny_dc",
    "args": {
        "input_channels": 96, "model_channels": 32, "output_channels": 96,
        "num_noattn_blocks": [1, 1], "channel_mult": [1, 2], "second_dim": [4, 4],
        "with_attn": [True, True], "num_heads": 4, "context_dim": 96,
        "parts": ["data", "context"],
    },
}

VD_TEST_TINY = {
    "type": "vd_v2_0",
    "name": "vd_test_tiny",
    "args": {
        "beta_linear_start": 0.00085, "beta_linear_end": 0.012, "timesteps": 1000,
        "use_ema": False,
        "vae_cfg_list": [["image", AUTOKL_TINY], ["text", OPTIMUS_TINY]],
        "ctx_cfg_list": [["image", CLIP_IMAGE_TINY], ["text", CLIP_TEXT_TINY]],
        "diffuser_cfg_list": [["image", OPENAI_UNET_2D_TINY],
                              ["text", OPENAI_UNET_0D_TINY_DC]],
        "global_layer_ptr": "image",
        "latent_scale_factor": {"image": 0.18215},
    },
}

_BANK = {c["name"]: c for c in (
    VD_FOUR_FLOW_V1_0, AUTOKL_V1, OPTIMUS_V1, OPTIMUS_BERT_ENCODER, OPTIMUS_BERT_TOKENIZER,
    OPTIMUS_GPT2_DECODER, OPTIMUS_GPT2_TOKENIZER, CLIP_IMAGE_CONTEXT_ENCODER,
    CLIP_TEXT_CONTEXT_ENCODER, OPENAI_UNET_2D_V1, OPENAI_UNET_0D_V1_DC, VD_TEST_TINY,
    AUTOKL_TINY, OPTIMUS_TINY, OPTIMUS_BERT_TINY, OPTIMUS_GPT2_TINY, CLIP_IMAGE_TINY,
    CLIP_TEXT_TINY, OPENAI_UNET_2D_TINY, OPENAI_UNET_0D_TINY_DC)}


def model_cfg_bank():
    """``vdtpu.config.bank.model_cfg_bank`` counterpart: name -> a fresh copy
    of the resolved config."""
    def lookup(name: str) -> dict:
        if name not in _BANK:
            raise KeyError(f"unknown config {name!r}; the port has {sorted(_BANK)}")
        return copy.deepcopy(_BANK[name])
    return lookup
