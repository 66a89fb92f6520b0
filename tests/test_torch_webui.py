"""The WebUI's gradio-free layer (``vdtpu_torch/serving/webui.py``): the
seven tabs' instructions, the example registry and the mask and image
plumbing against ``vdtpu.serving.webui``, each tab handler against its
``VDInference`` call on the tiny config, and ``build_app`` without gradio."""
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from _tiny import det_tokenizer
from vdtpu.serving import webui as jwebui
from vdtpu_torch.serving import webui
from vdtpu_torch.serving.api import VDInference, VDSystem

torch.set_num_threads(2)

MODES = ("Text-to-Image", "Image-Variation", "Image-to-Text", "Text-Variation",
         "Dual-Context", "Triple-Context", "Multi-Context")


def _pil(arr):
    return Image.fromarray((arr * 255).astype(np.uint8))


def _arr(seed, h=32, w=32):
    return np.random.RandomState(seed).rand(h, w, 3).astype(np.float32)


def _as_uint8(images):
    return [np.asarray(im) for im in images]


def _want(batch):
    return list((batch.numpy() * 255).astype(np.uint8))


@pytest.fixture(scope="module")
def vdi():
    sys_ = VDSystem("vd_test_tiny", device="cpu").init_random(0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():   # zero-initialized output layers drawn, so every block acts
        for p in sys_.net.parameters():
            if not p.any():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    return VDInference(sys_, text_tokenizer=det_tokenizer, output_dim=(32, 32), ddim_steps=2,
                       n_sample_image=2, n_sample_text=2, latent_downsample=2,
                       text_latent_dim=96)


@pytest.mark.parametrize("mode", MODES)
def test_instructions_and_examples_as_vdtpu(mode):
    assert webui.get_instruction(mode) == jwebui.get_instruction(mode)
    assert webui.get_example(mode) == jwebui.get_example(mode)
    assert webui.get_example(mode, "/a") == jwebui.get_example(mode, "/a")


def test_examples_registry():
    assert len(webui.get_example("Text-to-Image")) == 2
    assert webui.get_example("Image-Variation") == []
    rows = webui.get_example("Triple-Context", assets_dir="/assets")
    assert rows and rows[0][0].startswith("/assets/")
    assert len(webui.get_example("Multi-Context", "/a")[0]) == 4 * 5 + 3


def test_mask_and_image_batches_as_vdtpu():
    m = Image.fromarray((np.eye(8) * 255).astype(np.uint8))
    out = webui._mask_batch(m)
    assert out.shape == (1, 8, 8, 1) and out.max() == 1.0
    np.testing.assert_array_equal(out, jwebui._mask_batch(m))
    np.testing.assert_array_equal(webui._mask_batch({"image": None, "mask": m}), out)
    rgb = _pil(_arr(1, 8, 8))
    np.testing.assert_array_equal(webui._mask_batch(rgb), jwebui._mask_batch(rgb))
    assert webui._mask_batch(None) is None
    assert webui._mask_batch({"mask": None}) is None
    im = _pil(_arr(2, 20, 28))
    for size in (None, (20, 28), (32, 32)):
        np.testing.assert_array_equal(webui._to_batch(im, size), jwebui._to_batch(im, size))
    assert webui._to_batch(im, (32, 32)).shape == (1, 32, 32, 3)
    arr = (_arr(3, 20, 28) * 255).astype(np.float32)   # an array input resizes too
    np.testing.assert_allclose(webui._to_batch(arr, (32, 32)), jwebui._to_batch(arr, (32, 32)),
                               atol=1e-5)


def test_image_ctx():
    im, m = _pil(_arr(4)), Image.fromarray((np.eye(32) * 255).astype(np.uint8))
    assert webui._image_ctx(None, m, 1.0, 0.5, True) is None
    ctx = webui._image_ctx(im, m, 0.7, 0.3, True, (32, 32))
    assert ctx["strength"] == 0.7 and ctx["fcs_lvl"] == 0.3 and ctx["mask"].shape == (1, 32, 32, 1)
    assert "mask" not in webui._image_ctx(im, m, 0.7, 0.3, False, (32, 32))


def test_handlers_equal_their_flows(vdi):
    h = webui.make_handlers(vdi)
    assert sorted(h) == ["dcg", "i2i", "i2t", "mcg", "t2i", "t2t", "tcg"]
    a, b, c = _arr(5), _arr(6), _arr(7)
    im_a, im_b, im_c = _pil(a), _pil(b), _pil(c)
    ba, bb, bc = (np.asarray(p, np.float32)[None] / 255.0 for p in (im_a, im_b, im_c))
    mask = Image.fromarray((np.eye(32) * 255).astype(np.uint8))
    mb = webui._mask_batch(mask)
    checks = {
        "t2i": (h["t2i"]("a red cat", 3), vdi.inference_t2i("a red cat", 3)),
        "i2i": (h["i2i"](im_a, 0.5, 0.3, True, 4),
                vdi.inference_i2i(ba, 0.5, 0.3, "Simple", 4)),
        "dcg": (h["dcg"](im_b, 0.5, "a dog", 0.4, 5),
                vdi.inference_dcg(bb, 0.5, "a dog", 0.4, 5)),
        "tcg": (h["tcg"](im_a, mask, 1.0, 0.5, True, im_b, None, 0.7, 0.3, False,
                         "snow", 0.3, 6),
                vdi.inference_tcg([{"image": ba, "strength": 1.0, "fcs_lvl": 0.5, "mask": mb},
                                   {"image": bb, "strength": 0.7, "fcs_lvl": 0.3}],
                                  "snow", 0.3, 6)[1]),
        "mcg": (h["mcg"]("", 0.0, 7, im_a, None, 1.0, 0.5, False, None, None, 1.0, 0.5, False,
                         im_c, mask, 0.5, 0.6, True, None, None, 1.0, 0.5, False),
                vdi.inference_mcg([{"image": ba, "strength": 1.0, "fcs_lvl": 0.5},
                                   {"image": bc, "strength": 0.5, "fcs_lvl": 0.6, "mask": mb}],
                                  None, 0.0, 7)[1]),
    }
    for name, (got, ref) in checks.items():
        assert len(got) == 2, name
        for x, y in zip(_as_uint8(got), _want(ref)):
            np.testing.assert_array_equal(x, y, err_msg=name)
    assert h["i2t"](im_c, 8) == "\n".join(vdi.inference_i2t(bc, 8))
    assert h["t2t"]("a red cat", 9) == "\n".join(vdi.inference_t2t("a red cat", 9))
    # an upload of another size is resized to output_dim on the way in
    assert np.asarray(h["i2i"](_pil(_arr(8, 20, 44)), 1.0, 0.5, False, 1)[0]).shape == (32, 32, 3)


def test_build_app_without_gradio(vdi, monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(RuntimeError, match="gradio is not installed"):
        webui.build_app(vdi)
