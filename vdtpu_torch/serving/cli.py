"""Headless CLI over every flow (``vdtpu/serving/cli.py``).

Usage:
  python -m vdtpu_torch.serving.cli t2i --text "a dog" --seed 0 --out out/
  python -m vdtpu_torch.serving.cli i2i --image in.png --fid 0.5 --fcs 0.5
  python -m vdtpu_torch.serving.cli i2t --image in.png
  python -m vdtpu_torch.serving.cli t2t --text "a dog"
  python -m vdtpu_torch.serving.cli dcg --image in.png --text "snowy" --textstrength 0.5
  python -m vdtpu_torch.serving.cli mcg --image a.png --image b.png --text "..."

It runs on the card unless ``--device cpu`` (or another device) is given.
Checkpoints: ``--ckpt path/to/vd-four-flow-v1-0.pth`` (a torch state_dict
with the reference's key names, loaded through ``VDSystem.load_state_dict``);
otherwise seeded random weights (smoke mode). CLIP vocabulary:
``--clip-vocab`` / ``--clip-merges`` point at the tokenizer files.

Output images are written as PNG by the standard library (``write_png``,
zlib + struct); PIL is imported only to read input images.
"""
from __future__ import annotations

import argparse
import functools
import os
import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def write_png(path: str, rgb: np.ndarray):
    """An 8-bit RGB PNG of ``rgb`` [H, W, 3] uint8 (filter 0 on every row)."""
    h, w, _ = rgb.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + row.tobytes() for row in np.ascontiguousarray(rgb, np.uint8))
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """[H, W, 3] uint8 of a PNG that ``write_png`` wrote (8-bit RGB, not
    interlaced, filter 0 on every row); raises on anything else."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = len(_PNG_SIGNATURE), [], None
    while pos < len(data):
        (n,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != zlib.crc32(kind + body):
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, color, _, _, interlace = header
    if (depth, color, interlace) != (8, 2, 0):
        raise ValueError(f"{path}: not 8-bit RGB without interlace")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row uses a PNG filter other than 0")
    return rows[:, 1:].reshape(h, w, 3).copy()


def _load_image(path: str, size: int = 512) -> np.ndarray:
    from PIL import Image
    im = Image.open(path).convert("RGB").resize((size, size), Image.Resampling.BICUBIC)
    return np.asarray(im, np.float32)[None] / 255.0


def _load_mask(path: str, size: int = 512) -> np.ndarray:
    from PIL import Image
    m = Image.open(path).convert("L").resize((size, size))
    return np.asarray(m, np.float32)[None, :, :, None] / 255.0


def _save_images(batch, out_dir: str, stem: str) -> list[str]:
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, b in enumerate(batch.float().cpu().numpy()):
        p = os.path.join(out_dir, f"{stem}_{i}.png")
        write_png(p, (b * 255).astype(np.uint8))
        paths.append(p)
    return paths


def build_inference(args):
    import torch

    from vdtpu_torch.serving.api import VDInference, VDSystem
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    sysm = VDSystem(args.config, dtype=dtype, device=args.device).init_random(0)
    if args.ckpt:
        sd = torch.load(args.ckpt, map_location="cpu")
        if "state_dict" in sd:
            sd = sd["state_dict"]
        res = sysm.load_state_dict(sd, strict=False)
        print(f"loaded checkpoint; {len(res.missing_keys)} unmatched params")
    if args.int8:
        sysm.enable_int8(image_size=args.size, latent_downsample=args.latent_downsample)
    if args.tome:
        sysm.enable_tome(ratio=args.tome)
    tokenizer = None
    if args.clip_vocab and args.clip_merges:
        from vdtpu_torch.data.tokenizers import CLIPTokenizer
        tok = CLIPTokenizer(args.clip_vocab, args.clip_merges)
        tokenizer = functools.partial(tok, max_length=args.clip_max_length)
    return VDInference(sysm, text_tokenizer=tokenizer, ddim_steps=args.steps,
                       output_dim=(args.size, args.size), n_sample_image=args.n_images,
                       n_sample_text=args.n_texts, image_latent_dim=args.image_latent_dim,
                       text_latent_dim=args.text_latent_dim,
                       latent_downsample=args.latent_downsample,
                       encoder_reuse=args.encoder_reuse or None, sampler=args.sampler,
                       cfg_interval=(tuple(float(v) for v in args.cfg_interval.split(","))
                                     if args.cfg_interval else None))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="vdtpu_torch")
    p.add_argument("flow", choices=["t2i", "i2i", "i2t", "t2t", "dcg", "tcg", "mcg"])
    p.add_argument("--text", default=None)
    p.add_argument("--image", action="append", default=[])
    p.add_argument("--mask", action="append", default=[])
    p.add_argument("--strength", type=float, action="append", default=[])
    p.add_argument("--fid", type=float, default=0.5)
    p.add_argument("--fcs", type=float, default=0.5)
    p.add_argument("--clr-adj", action="store_true")
    p.add_argument("--textstrength", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--out", default="outputs")
    p.add_argument("--config", default="vd_four_flow_v1-0")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--clip-vocab", default=None)
    p.add_argument("--clip-merges", default=None)
    p.add_argument("--clip-max-length", type=int, default=77)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs the "
                        "kernels' plain versions)")
    # generation geometry (defaults = published model; override for
    # miniature configs, e.g. --config vd_test_tiny --size 64
    # --latent-downsample 2 --text-latent-dim 96)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--n-images", type=int, default=2)
    p.add_argument("--n-texts", type=int, default=4)
    p.add_argument("--image-latent-dim", type=int, default=4)
    p.add_argument("--text-latent-dim", type=int, default=768)
    p.add_argument("--latent-downsample", type=int, default=8)
    p.add_argument("--encoder-reuse", type=int, default=0,
                   help="opt-in approximate mode: encoder-feature reuse "
                        "interval (0 = exact DDIM)")
    p.add_argument("--sampler", choices=["ddim", "dpmpp2m"], default="ddim",
                   help="dpmpp2m: second-order deterministic solver (pair "
                        "with --steps 20)")
    p.add_argument("--cfg-interval", default=None, metavar="LO,HI",
                   help="opt-in approximate mode: trajectory fractions "
                        "where CFG is active (e.g. 0.0,0.7); outside them "
                        "the UNet runs at half batch")
    p.add_argument("--int8", action="store_true",
                   help="calibrated int8 diffuser (vdtpu's serving policy)")
    p.add_argument("--tome", type=float, default=0.0, metavar="RATIO",
                   help="opt-in approximate mode: token-merging ratio for "
                        "the 4096-token self-attention sites (ToMe-SD, "
                        "arXiv 2303.17604; 0 = off, 0.5 typical)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    vdi = build_inference(args)
    if args.flow == "t2i":
        out = vdi.inference_t2i(args.text, args.seed)
        print(_save_images(out, args.out, "t2i"))
    elif args.flow == "i2i":
        im = _load_image(args.image[0], args.size)
        out = vdi.inference_i2i(im, args.fid, args.fcs, "Simple" if args.clr_adj else None,
                                args.seed)
        print(_save_images(out, args.out, "i2i"))
    elif args.flow == "i2t":
        print("\n".join(vdi.inference_i2t(_load_image(args.image[0], args.size), args.seed)))
    elif args.flow == "t2t":
        print("\n".join(vdi.inference_t2t(args.text, args.seed)))
    else:
        ctxs = []
        for i, pth in enumerate(args.image):
            ctx = {"image": _load_image(pth, args.size),
                   "strength": args.strength[i] if i < len(args.strength) else 1.0,
                   "fcs_lvl": args.fcs}
            if i < len(args.mask) and args.mask[i]:
                ctx["mask"] = _load_mask(args.mask[i], args.size)
            ctxs.append(ctx)
        if args.flow == "dcg":
            out = vdi.inference_dcg(ctxs[0]["image"], args.fcs, args.text, args.textstrength,
                                    args.seed)
        else:
            fn = vdi.inference_tcg if args.flow == "tcg" else vdi.inference_mcg
            _, out = fn(ctxs, args.text, args.textstrength, args.seed)
        print(_save_images(out, args.out, args.flow))


if __name__ == "__main__":
    main()
