"""Input-pipeline throughput (``vdtpu/data/benchmark.py``): decoded
images/s of ``ImageTextPipeline`` at a resolution and thread count. It is
host work (tar reads, PNG or JPEG decode, the bicubic resize) and touches
no card. With no ``--shards`` it synthesizes shards first, under
``build/data_benchmark/`` in the checkout.

Usage:
  python -m vdtpu_torch.data.benchmark [--shards DIR] [--image-size 512]
      [--batch-size 32] [--threads 1 4 8] [--max-batches 8] [--format png]
"""
from __future__ import annotations

import argparse
import io
import os
import tarfile
import time

import numpy as np

from vdtpu_torch.data.images import encode_png, resize_bicubic

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def synthesize_shards(root: str, n_shards: int = 2, per_shard: int = 128, size: int = 512,
                      fmt: str = "png", n_other: int = 0) -> str:
    """``n_shards`` tar shards of ``per_shard`` (image, caption) samples,
    made from seed 0: low-frequency noise (uniform [size/8]^2 RGB, bicubic up
    to the image's size), which compresses like a photograph, not like
    static. ``fmt`` "png" (the standard library) or "jpg" (Pillow, quality
    90, as the JAX package's shards). The last ``n_other`` samples of the
    set are 5/4 x 9/8 of ``size`` (width x height), so a pipeline at
    ``size`` resizes them. A shard already on disk is kept."""
    os.makedirs(root, exist_ok=True)
    rs = np.random.RandomState(0)
    other = (size * 5 // 4, size * 9 // 8)
    total = n_shards * per_shard
    for s in range(n_shards):
        path = os.path.join(root, f"shard-{s:04d}.tar")
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        with tarfile.open(tmp, "w") as tf:
            for i in range(per_shard):
                key = f"{s * 100000 + i:09d}"
                w, h = other if s * per_shard + i >= total - n_other else (size, size)
                small = (rs.rand(size // 8, size // 8, 3) * 255).astype(np.uint8)
                rgb = resize_bicubic(small, (w, h))
                if fmt == "png":
                    data, ext = encode_png(rgb), "png"
                else:
                    from PIL import Image
                    buf = io.BytesIO()
                    Image.fromarray(rgb).save(buf, format="JPEG", quality=90)
                    data, ext = buf.getvalue(), "jpg"
                for name, payload in ((f"{key}.{ext}", data),
                                      (f"{key}.txt", f"synthetic caption {key}".encode())):
                    info = tarfile.TarInfo(name)
                    info.size = len(payload)
                    tf.addfile(info, io.BytesIO(payload))
        os.replace(tmp, path)
    return root


def run(shards: str, image_size: int, batch_size: int, threads: int,
        max_batches: int) -> float:
    """Decoded images/s over ``max_batches`` batches after one warm batch."""
    from vdtpu_torch.data.webdataset import ImageTextPipeline, ShardIndex
    pipe = ImageTextPipeline(ShardIndex.from_dir(shards), batch_size=batch_size,
                             image_size=image_size, shuffle_buffer=64, num_threads=threads)
    it = iter(pipe)
    try:
        next(it)  # warm: thread pool up, first shard open
        t0 = time.perf_counter()
        n = 0
        for _ in range(max_batches):
            n += next(it)["image"].shape[0]
        return n / (time.perf_counter() - t0)
    finally:
        it.close()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--shards", default=None)
    p.add_argument("--image-size", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--threads", type=int, nargs="+", default=[1, 4, 8])
    p.add_argument("--max-batches", type=int, default=8)
    p.add_argument("--format", choices=("png", "jpg"), default="png")
    args = p.parse_args(argv)
    shards = args.shards or synthesize_shards(
        os.path.join(_ROOT, "build", "data_benchmark", f"{args.format}-{args.image_size}"),
        size=args.image_size, fmt=args.format)
    rates = {}
    for t in args.threads:
        rates[t] = run(shards, args.image_size, args.batch_size, t, args.max_batches)
        print(f"threads={t}: {rates[t]:.1f} images/s @ {args.image_size}^2 (host)")
    return rates


if __name__ == "__main__":
    main()
