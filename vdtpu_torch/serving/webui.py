"""The WebUI's application layer (``vdtpu/serving/webui.py``): the seven tabs'
handlers, the example registry and the mask plumbing, free of gradio.

Gradio is an optional dependency (absent here and on the card's machine):
``build_app`` imports it lazily and raises a clear error where it is
absent, and ``vdtpu_torch.serving.cli`` covers the same flows headlessly.
The tab callbacks live in ``make_handlers`` so they are testable without
gradio; PIL is imported only where a handler converts images.
"""
from __future__ import annotations

import os

import numpy as np

_INSTRUCTIONS = {
    "Text-to-Image": "Generate image from text prompt.",
    "Image-Variation": "Generate image conditioned on reference image.",
    "Image-to-Text": "Generate text from reference image.",
    "Text-Variation": "Generate text from reference text prompt.",
    "Dual-Context": "Generate image conditioned on both text and image.",
    "Triple-Context": "Generate image conditioned on text and up to two "
                      "(maskable) images.",
    "Multi-Context": "Generate image from multiple (masked, weighted) contexts.",
}


def get_instruction(mode: str) -> str:
    return _INSTRUCTIONS[mode]


def get_example(mode: str, assets_dir: str | None = None):
    """Pinned input + seed example rows per tab. Text-only tabs always have
    examples; image tabs get them when an assets directory is supplied."""
    if mode == "Text-to-Image":
        return [
            ["a dream of a village in china, by Caspar David Friedrich, "
             "matte painting trending on artstation HQ", 23],
            ["a beautiful landscape with mountains and rivers", 20],
        ]
    if mode == "Text-Variation":
        return [["heavy arms gundam penguin mech", 20]]
    if assets_dir is None:
        return []
    a = lambda name: os.path.join(assets_dir, name)
    if mode == "Image-Variation":
        return [[a("ghibli.jpg"), 0.0, 0.5, False, 20],
                [a("matisse.jpg"), 0.0, 1.0, True, 20]]
    if mode == "Image-to-Text":
        return [[a("house_by_lake.jpg"), 20]]
    if mode == "Dual-Context":
        return [[a("benz.jpg"), 0.5, "cyberpunk 2077", 0.7, 22]]
    if mode == "Triple-Context":
        return [[a("night_light.jpg"), None, 1.0, 0.5, False,
                 a("paris.jpg"), None, 0.94, 0.5, False,
                 "snow on the street", 0.4, 28]]
    if mode == "Multi-Context":
        return [[a("e0i0.jpg"), None, 1.0, 0.5, False,
                 a("e0i1.jpg"), None, 1.0, 0.5, False,
                 None, None, 1.0, 0.5, False,
                 None, None, 1.0, 0.5, False,
                 "", 0.0, 20]]
    return []


def _to_batch(pil_image, size=None) -> np.ndarray:
    """PIL image (or array) -> [1, H, W, 3] float batch, bicubic-resized to
    ``size`` = (H, W) when given: every upload is regularized to
    output_dim. PIL images resize in PIL, arrays through
    ``regularize_image``."""
    if size is not None and not isinstance(pil_image, np.ndarray):
        from PIL import Image
        h, w = int(size[0]), int(size[1])
        if isinstance(pil_image, Image.Image) and pil_image.size != (w, h):
            pil_image = pil_image.resize((w, h), resample=Image.Resampling.BICUBIC)
    arr = np.asarray(pil_image, np.float32)[None] / 255.0
    if size is not None and arr.shape[1:3] != (int(size[0]), int(size[1])):
        from vdtpu_torch.serving.api import regularize_image
        arr = regularize_image(arr, size).numpy()
    return arr


def _to_pil(batch):
    from PIL import Image
    return [Image.fromarray((b * 255).astype(np.uint8))
            for b in batch.float().cpu().numpy()]


def _mask_batch(mask_img):
    """Sketch-pad output -> [1, H, W, 1] float mask (white strokes = keep).
    Takes a PIL image, an {"image", "mask"} dict (gradio's sketch tool), or
    None."""
    if mask_img is None:
        return None
    if isinstance(mask_img, dict):
        mask_img = mask_img.get("mask") or mask_img.get("image")
        if mask_img is None:
            return None
    m = np.asarray(mask_img, np.float32)
    if m.ndim == 3:
        m = m[..., :3].mean(-1)
    return (m / max(m.max(), 1e-6))[None, ..., None]


def _image_ctx(im, mask, strength, fcs, use_mask, size=None):
    if im is None:
        return None
    ctx = {"image": _to_batch(im, size), "strength": float(strength), "fcs_lvl": float(fcs)}
    if use_mask:
        mb = _mask_batch(mask)
        if mb is not None:
            ctx["mask"] = mb
    return ctx


def make_handlers(vdi):
    """Tab callbacks of a ``VDInference`` (free of gradio). Uploads are
    bicubic-resized to vdi.output_dim on the way in; VDInference
    regularizes again, which leaves them as they are."""
    dim = vdi.output_dim

    def t2i(text, seed):
        return _to_pil(vdi.inference_t2i(text, int(seed)))

    def i2i(im, fid, fcs, clr, seed):
        return _to_pil(vdi.inference_i2i(_to_batch(im, dim), fid, fcs,
                                         "Simple" if clr else None, int(seed)))

    def i2t(im, seed):
        return "\n".join(vdi.inference_i2t(_to_batch(im, dim), int(seed)))

    def t2t(text, seed):
        return "\n".join(vdi.inference_t2t(text, int(seed)))

    def dcg(im, fcs, text, strength, seed):
        return _to_pil(vdi.inference_dcg(_to_batch(im, dim), fcs, text, strength, int(seed)))

    def tcg(im1, m1, s1, f1, u1, im2, m2, s2, f2, u2, text, tstrength, seed):
        ctxs = [c for c in (_image_ctx(im1, m1, s1, f1, u1, dim),
                            _image_ctx(im2, m2, s2, f2, u2, dim)) if c]
        _, out = vdi.inference_tcg(ctxs, text or None, float(tstrength), int(seed))
        return _to_pil(out)

    def mcg(text, tstrength, seed, *rows):
        ctxs = [c for c in (_image_ctx(*rows[i:i + 5], size=dim)
                            for i in range(0, len(rows), 5)) if c]
        _, out = vdi.inference_mcg(ctxs, text or None, float(tstrength), int(seed))
        return _to_pil(out)

    return {"t2i": t2i, "i2i": i2i, "i2t": i2t, "t2t": t2t, "dcg": dcg, "tcg": tcg,
            "mcg": mcg}


def _maybe_examples(gr, mode, inputs, fn, outputs, assets_dir, cache_examples):
    rows = get_example(mode, assets_dir)
    if rows:
        gr.Examples(examples=rows, inputs=inputs, fn=fn, outputs=outputs,
                    cache_examples=cache_examples)


def _sketch_kwargs(gr):
    # gradio 3.x sketch tool; newer gradios draw masks in ImageEditor
    import inspect
    if "tool" in inspect.signature(gr.Image.__init__).parameters:
        return {"tool": "sketch"}
    return {}


def _image_ctx_row(gr, i):
    with gr.Row():
        im = gr.Image(type="pil", label=f"Context {i + 1}")
        mask = gr.Image(type="pil", label="Mask (draw)", **_sketch_kwargs(gr))
    with gr.Row():
        st = gr.Slider(0, 2, value=1.0, label="Strength")
        fc = gr.Slider(0, 1, value=0.5, label="Focus")
        um = gr.Checkbox(label="Use mask")
    return [im, mask, st, fc, um]


def build_app(vdi, assets_dir: str | None = None, cache_examples: bool = True):
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError(
            "gradio is not installed; use vdtpu_torch.serving.cli for headless "
            "inference or install gradio for the WebUI") from e

    h = make_handlers(vdi)
    seed_box = lambda: gr.Number(value=0, label="Seed", precision=0)

    def tab(mode, inputs, key, outputs, example_inputs=None):
        gr.Button("Run").click(h[key], inputs, outputs)
        _maybe_examples(gr, mode, example_inputs or inputs, h[key], outputs, assets_dir,
                        cache_examples)

    with gr.Blocks() as app:
        gr.Markdown("# Versatile Diffusion (H100)")
        with gr.Tab("Text-to-Image"):
            gr.Markdown(get_instruction("Text-to-Image"))
            tab("Text-to-Image", [gr.Textbox(label="Prompt"), seed_box()], "t2i",
                gr.Gallery())
        with gr.Tab("Image-Variation"):
            gr.Markdown(get_instruction("Image-Variation"))
            tab("Image-Variation",
                [gr.Image(type="pil"), gr.Slider(0, 1, value=0.5, label="Fidelity"),
                 gr.Slider(0, 1, value=0.5, label="Focus (semantic-style)"),
                 gr.Checkbox(label="Color adjust"), seed_box()], "i2i", gr.Gallery())
        with gr.Tab("Image-to-Text"):
            gr.Markdown(get_instruction("Image-to-Text"))
            tab("Image-to-Text", [gr.Image(type="pil"), seed_box()], "i2t", gr.Textbox())
        with gr.Tab("Text-Variation"):
            gr.Markdown(get_instruction("Text-Variation"))
            tab("Text-Variation", [gr.Textbox(label="Prompt"), seed_box()], "t2t",
                gr.Textbox())
        with gr.Tab("Dual-Context"):
            gr.Markdown(get_instruction("Dual-Context"))
            tab("Dual-Context",
                [gr.Image(type="pil"), gr.Slider(0, 1, value=0.5, label="Focus"),
                 gr.Textbox(label="Text context"),
                 gr.Slider(0, 1, value=0.5, label="Text strength"), seed_box()], "dcg",
                gr.Gallery())
        with gr.Tab("Triple-Context"):
            gr.Markdown(get_instruction("Triple-Context"))
            comps = _image_ctx_row(gr, 0) + _image_ctx_row(gr, 1)
            rest = [gr.Textbox(label="Text context"),
                    gr.Slider(0, 1, value=0.0, label="Text strength"), seed_box()]
            tab("Triple-Context", comps + rest, "tcg", gr.Gallery())
        with gr.Tab("Multi-Context"):
            gr.Markdown(get_instruction("Multi-Context"))
            comps = [c for i in range(4) for c in _image_ctx_row(gr, i)]
            rest = [gr.Textbox(label="Text context"),
                    gr.Slider(0, 1, value=0.0, label="Text strength"), seed_box()]
            tab("Multi-Context", rest + comps, "mcg", gr.Gallery(), comps + rest)
    return app
