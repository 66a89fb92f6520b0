"""Webdataset input pipeline (``vdtpu/data/webdataset.py``): tar shards of
(image, caption) samples into fixed-size NHWC batches in [0, 1].

- ``ShardIndex``: the shard list, split across processes and permuted per
  epoch from the seed, as the JAX package splits it.
- ``tar_samples``: members grouped by key ({key}.jpg / .png + {key}.txt),
  read by the native reader (``data/native``, built with g++ at first use)
  or, with ``use_native=False``, the standard library's ``tarfile``. A
  failed native build raises; nothing falls back quietly.
- ``decode_image``: PNG through the standard library (``data/images.py``),
  JPEG and any other format through Pillow, imported where it is used; the
  shortest side resized to ``size`` with Pillow's BICUBIC (its numpy copy
  for PNG, Pillow's own for the rest) and the center crop. Bytes that are
  not a decodable image give None (the sample is skipped, as the JAX
  package skips it); a format that needs Pillow where it is absent raises
  ``ImportError``.
- ``ImageTextPipeline``: decode in a thread pool consumed in submission
  order (bit-equal to one thread), a shuffle buffer, drop-last batches and
  a prefetch thread. Where the JAX package's pipeline cycles forever on an
  epoch that yields nothing, this one raises; an error in the producer
  thread reaches the consumer; closing the batch iterator stops the
  producer thread and joins it.
"""
from __future__ import annotations

import dataclasses
import io
import itertools
import os
import queue
import struct
import tarfile
import threading
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator, Sequence

import numpy as np

from vdtpu_torch.data.images import PNG_SIGNATURE, UnsupportedPNG, decode_png, resize_bicubic


@dataclasses.dataclass
class ShardIndex:
    shards: Sequence[str]
    process_index: int = 0
    process_count: int = 1
    seed: int = 0

    @classmethod
    def from_dir(cls, root: str, pattern: str = ".tar", **kw) -> "ShardIndex":
        shards = sorted(os.path.join(root, f) for f in os.listdir(root) if f.endswith(pattern))
        return cls(shards, **kw)

    def epoch_shards(self, epoch: int) -> list[str]:
        rng = np.random.RandomState(self.seed + epoch)
        order = rng.permutation(len(self.shards))
        mine = order[self.process_index::self.process_count]
        return [self.shards[i] for i in mine]


def _group(members: Iterator[tuple[str, Callable[[], bytes]]]) -> Iterator[dict[str, bytes]]:
    """Consecutive members with one basename key -> {extension: bytes}."""
    cur_key: str | None = None
    cur: dict[str, bytes] = {}
    for name, read in members:
        key, _, ext = os.path.basename(name).partition(".")
        if cur_key is None:
            cur_key = key
        if key != cur_key:
            if cur:
                yield cur
            cur_key, cur = key, {}
        cur[ext.lower()] = read()
    if cur:
        yield cur


def tar_samples(path: str, use_native: bool = True) -> Iterator[dict[str, bytes]]:
    """The samples of one shard, members grouped by basename key."""
    if use_native:
        from vdtpu_torch.data.native import NativeTarReader
        with NativeTarReader(path) as rd:
            yield from _group((rd.name(i), lambda i=i: rd.read(i)) for i in range(len(rd)))
        return
    with tarfile.open(path, "r|*") as tf:
        yield from _group((m.name, lambda m=m: tf.extractfile(m).read())
                          for m in tf if m.isfile())


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("decoding a JPEG (or any image but PNG) needs Pillow, which is "
                          "not installed; PNG shards decode without it") from e
    return Image


def decode_image(data: bytes, size: int = 512) -> np.ndarray | None:
    """Image bytes -> [size, size, 3] float32 in [0, 1] (shortest side
    resized to ``size``, BICUBIC, then the center crop); None when the bytes
    are not a decodable image."""
    rgb = None
    if data.startswith(PNG_SIGNATURE):
        try:
            rgb = decode_png(data)
        except UnsupportedPNG:
            pass                      # Pillow's own decoder takes it below
        except (ValueError, IndexError, struct.error, zlib.error):
            return None
    if rgb is not None:
        h, w = rgb.shape[:2]
        scale = size / min(w, h)
        im = resize_bicubic(rgb, (max(size, round(w * scale)), max(size, round(h * scale))))
    else:
        Image = _pil()
        try:
            pim = Image.open(io.BytesIO(data)).convert("RGB")
        except Exception:
            return None
        w, h = pim.size
        scale = size / min(w, h)
        pim = pim.resize((max(size, round(w * scale)), max(size, round(h * scale))),
                         Image.Resampling.BICUBIC)
        im = np.asarray(pim)
    h, w = im.shape[:2]
    left, top = (w - size) // 2, (h - size) // 2
    im = im[top:top + size, left:left + size]
    return np.asarray(im, np.float32) / 255.0


class ImageTextPipeline:
    """Shards -> decoded (image, caption) batches with threaded prefetch."""

    def __init__(self, index: ShardIndex, batch_size: int, image_size: int = 512,
                 shuffle_buffer: int = 1000, prefetch: int = 4, num_threads: int = 4,
                 transform: Callable[[np.ndarray, str], Any] | None = None,
                 use_native: bool = True):
        self.index = index
        self.batch_size = batch_size
        self.image_size = image_size
        self.shuffle_buffer = shuffle_buffer
        self.prefetch = prefetch
        self.num_threads = num_threads
        self.transform = transform
        self.use_native = use_native
        self.producers: list[threading.Thread] = []   # every producer thread started

    def _byte_samples(self, epoch: int) -> Iterator[tuple[bytes, str]]:
        for shard in self.index.epoch_shards(epoch):
            for sample in tar_samples(shard, self.use_native):
                img_bytes = sample.get("jpg") or sample.get("jpeg") or sample.get("png")
                if img_bytes is None:
                    continue
                caption = (sample.get("txt") or b"").decode("utf-8", "replace")
                yield img_bytes, caption

    def _raw_samples(self, epoch: int) -> Iterator[tuple[np.ndarray, str]]:
        """Decode in a num_threads pool, consumed in submission order, so the
        stream is bit-identical to single-threaded decode."""
        if self.num_threads <= 1:
            for data, cap in self._byte_samples(epoch):
                img = decode_image(data, self.image_size)
                if img is not None:
                    yield img, cap
            return
        max_inflight = self.num_threads * 4
        with ThreadPoolExecutor(self.num_threads) as ex:
            pending: deque = deque()
            for data, cap in self._byte_samples(epoch):
                pending.append((ex.submit(decode_image, data, self.image_size), cap))
                if len(pending) >= max_inflight:
                    fut, c = pending.popleft()
                    img = fut.result()
                    if img is not None:
                        yield img, c
            while pending:
                fut, c = pending.popleft()
                img = fut.result()
                if img is not None:
                    yield img, c

    def _shuffled(self, epoch: int) -> Iterator[tuple[np.ndarray, str]]:
        rng = np.random.RandomState(self.index.seed + 97 * epoch)
        buf: list = []
        for item in self._raw_samples(epoch):
            if len(buf) < self.shuffle_buffer:
                buf.append(item)
                continue
            j = rng.randint(len(buf))
            yield buf[j]
            buf[j] = item
        rng.shuffle(buf)
        yield from buf

    def batches(self, epoch: int = 0) -> Iterator[dict[str, Any]]:
        """Fixed-size batches; a partial trailing batch is dropped. Raises
        if the epoch yields no batch. Closing the iterator stops and joins
        the producer thread."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                imgs, caps, n = [], [], 0
                for img, cap in self._shuffled(epoch):
                    if self.transform is not None:
                        img, cap = self.transform(img, cap)
                    imgs.append(img)
                    caps.append(cap)
                    n += 1
                    if len(imgs) == self.batch_size:
                        if not put({"image": np.stack(imgs), "caption": caps}):
                            return
                        imgs, caps = [], []
                put(done if n >= self.batch_size else RuntimeError(
                    f"epoch {epoch} of {len(self.index.shards)} shard(s) yielded {n} samples, "
                    f"fewer than one batch of {self.batch_size}"))
            except BaseException as e:   # handed to the consumer
                put(e)

        t = threading.Thread(target=producer, daemon=True, name=f"pipeline-epoch{epoch}")
        self.producers.append(t)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()

    def __iter__(self):
        for epoch in itertools.count():
            yield from self.batches(epoch)
