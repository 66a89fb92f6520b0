"""The data path, port against the JAX package: shard index, tar grouping
(native reader and ``tarfile``), decoding, the pipeline's batches, and the
throughput benchmark's shards.

JPEG shards come from ``_tiny.make_shard`` (Pillow JPEGs), so both
packages decode them with Pillow and their batches must be bit-equal. PNG
decodes through the standard library in the port: held equal to Pillow's
decoder on PNGs of every filter type and colour type, and the numpy copy
of Pillow's BICUBIC resize equal to Pillow's within one code (exactly
where the image is already at size).
"""
import io
import os
import struct
import sys
import tarfile
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from _tiny import make_shard
from vdtpu.data import benchmark as jbench
from vdtpu.data import webdataset as jwds
from vdtpu_torch.data import benchmark, images, native, webdataset

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    for s in range(4):
        make_shard(str(root / f"shard-{s:04d}.tar"), 6, offset=s * 100)
    return str(root)


@pytest.mark.parametrize("use_native", [True, False])
def test_tar_grouping_matches_jax(shards, use_native):
    for path in webdataset.ShardIndex.from_dir(shards).shards:
        ours = list(webdataset.tar_samples(path, use_native=use_native))
        ref = list(jwds.tar_samples(path, use_native=False))
        assert len(ours) == 6 and ours == ref
        assert set(ours[0]) == {"jpg", "txt"}


def test_native_reader_reads_every_member(shards):
    path = webdataset.ShardIndex.from_dir(shards).shards[0]
    with native.NativeTarReader(path) as rd, tarfile.open(path) as tf:
        members = [m for m in tf if m.isfile()]
        assert len(rd) == len(members) == 12
        for i, m in enumerate(members):
            assert rd.name(i) == m.name and rd.read(i) == tf.extractfile(m).read()
    assert native.lib_path().startswith(native.BUILD_DIR)


def test_native_build_failure_raises_with_the_log(tmp_path, monkeypatch):
    bad = tmp_path / "tario.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load()


@pytest.mark.parametrize("count", [1, 2, 3])
def test_process_sharding_matches_jax(shards, count):
    seen = set()
    for i in range(count):
        ours = webdataset.ShardIndex.from_dir(shards, process_index=i, process_count=count,
                                              seed=5)
        ref = jwds.ShardIndex.from_dir(shards, process_index=i, process_count=count, seed=5)
        for epoch in range(3):
            assert ours.epoch_shards(epoch) == ref.epoch_shards(epoch)
        seen |= set(ours.epoch_shards(0))
    assert len(seen) == 4


@pytest.mark.parametrize("use_native", [True, False])
def test_batches_match_jax(shards, use_native):
    """Two epochs of batches (shuffle buffer, drop-last): images bit-equal,
    captions equal."""
    mk = lambda mod, **kw: mod.ImageTextPipeline(mod.ShardIndex.from_dir(shards, seed=3),
                                                 batch_size=5, image_size=24,
                                                 shuffle_buffer=4, num_threads=1, **kw)
    ours, ref = mk(webdataset, use_native=use_native), mk(jwds)
    for epoch in (0, 1):
        a, b = list(ours.batches(epoch)), list(ref.batches(epoch))
        assert len(a) == len(b) == 4
        for x, y in zip(a, b):
            assert x["image"].dtype == np.float32 and x["image"].shape == (5, 24, 24, 3)
            np.testing.assert_array_equal(x["image"], y["image"])
            assert x["caption"] == y["caption"]
    assert not any(t.is_alive() for t in ours.producers)


def test_threaded_decode_matches_single_thread(shards):
    mk = lambda t: webdataset.ImageTextPipeline(webdataset.ShardIndex.from_dir(shards),
                                                batch_size=4, image_size=32,
                                                shuffle_buffer=8, num_threads=t)
    b1, b4 = list(mk(1).batches(0)), list(mk(4).batches(0))
    assert len(b1) == len(b4) == 6
    for a, b in zip(b1, b4):
        np.testing.assert_array_equal(a["image"], b["image"])
        assert a["caption"] == b["caption"]


def _png(px: np.ndarray, ctype: int, filters, palette=None, depth: int = 8) -> bytes:
    """A PNG of ``px`` [H, W, C] with the given filter type on each row
    (cycled), written here so every filter the decoder undoes is present."""
    h, w = px.shape[:2]
    raw = px.astype(">u2" if depth == 16 else np.uint8).tobytes()
    stride = len(raw) // h
    bpp = stride // w
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride).astype(np.int32)
    out, prev = [], np.zeros(stride, np.int32)
    for y in range(h):
        f, cur = filters[y % len(filters)], rows[y]
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if f == 0:
            enc = cur
        elif f == 1:
            enc = cur - left
        elif f == 2:
            enc = cur - prev
        elif f == 3:
            enc = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            enc = cur - pred
        out.append(bytes([f]) + (enc & 255).astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
    if palette is not None:
        body += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return (images.PNG_SIGNATURE + body + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype,channels,depth", [(2, 3, 8), (6, 4, 8), (0, 1, 8), (4, 2, 8),
                                                  (3, 1, 8), (2, 3, 16), (6, 4, 16)])
def test_png_decode_matches_pillow(ctype, channels, depth):
    rs = np.random.RandomState(ctype + depth)
    hi = 256 if depth == 8 else 65536
    px = rs.randint(0, 16 if ctype == 3 else hi, (13, 11, channels))
    palette = rs.randint(0, 256, (16, 3)) if ctype == 3 else None
    data = _png(px, ctype, [0, 1, 2, 3, 4], palette, depth)
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(images.decode_png(data), ref)
    rgb = rs.randint(0, 256, (9, 7, 3)).astype(np.uint8)
    np.testing.assert_array_equal(images.decode_png(images.encode_png(rgb)), rgb)


@pytest.mark.parametrize("src,dst", [((40, 30), (24, 24)), ((577, 640), (512, 455)),
                                     ((33, 100), (155, 51)), ((64, 64), (512, 512)),
                                     ((20, 37), (20, 37))])
def test_resize_matches_pillow_within_one_code(src, dst):
    rgb = np.random.RandomState(sum(src)).randint(0, 256, src + (3,)).astype(np.uint8)
    ours = images.resize_bicubic(rgb, dst)
    ref = np.asarray(Image.fromarray(rgb).resize(dst, Image.Resampling.BICUBIC))
    assert ours.shape == ref.shape
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1
    if dst == (src[1], src[0]):
        np.testing.assert_array_equal(ours, rgb)


@pytest.mark.parametrize("hw", [(24, 24), (30, 40), (50, 36)])
def test_decode_image_png_matches_jax(hw):
    """decode_image on PNG bytes: the port's stdlib route against vdtpu's
    Pillow route, within one code of 255 (resize, then crop)."""
    rgb = np.random.RandomState(hw[0]).randint(0, 256, hw + (3,)).astype(np.uint8)
    data = images.encode_png(rgb)
    ours, ref = webdataset.decode_image(data, 24), jwds.decode_image(data, 24)
    assert ours.shape == ref.shape == (24, 24, 3) and ours.dtype == np.float32
    assert np.abs(ours - ref).max() <= 1.0 / 255 + 1e-7
    if hw == (24, 24):
        np.testing.assert_array_equal(ours, ref)
    assert webdataset.decode_image(b"\x89PNG\r\n\x1a\n garbage", 24) is None


def test_jpeg_without_pillow_raises(shards, monkeypatch):
    jpg = next(webdataset.tar_samples(webdataset.ShardIndex.from_dir(shards).shards[0]))["jpg"]
    png = images.encode_png(np.zeros((8, 8, 3), np.uint8))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        webdataset.decode_image(jpg, 8)
    assert webdataset.decode_image(png, 8).shape == (8, 8, 3)
    pipe = webdataset.ImageTextPipeline(webdataset.ShardIndex.from_dir(shards), batch_size=2,
                                        image_size=8, num_threads=2)
    it = iter(pipe)
    with pytest.raises(ImportError):
        next(it)
    it.close()


def test_an_epoch_without_a_batch_raises(tmp_path):
    """Where vdtpu's pipeline would cycle epochs forever, the port raises:
    shards of captions only, and fewer samples than one batch."""
    path = tmp_path / "shard-0000.tar"
    with tarfile.open(path, "w") as tf:
        for i in range(3):
            info = tarfile.TarInfo(f"{i:04d}.txt")
            info.size = 3
            tf.addfile(info, io.BytesIO(b"cap"))
    pipe = webdataset.ImageTextPipeline(webdataset.ShardIndex.from_dir(str(tmp_path)),
                                        batch_size=2, image_size=8)
    with pytest.raises(RuntimeError, match="yielded 0 samples"):
        next(iter(pipe))
    benchmark.synthesize_shards(str(tmp_path / "few"), n_shards=1, per_shard=3, size=16)
    pipe = webdataset.ImageTextPipeline(webdataset.ShardIndex.from_dir(str(tmp_path / "few")),
                                        batch_size=4, image_size=16)
    with pytest.raises(RuntimeError, match="yielded 3 samples"):
        next(iter(pipe))


def test_closing_the_iterator_stops_the_producer(shards):
    pipe = webdataset.ImageTextPipeline(webdataset.ShardIndex.from_dir(shards), batch_size=2,
                                        image_size=8, prefetch=1, num_threads=2)
    it = iter(pipe)
    next(it)
    assert pipe.producers[-1].is_alive()   # blocked on the full prefetch queue
    it.close()
    assert not any(t.is_alive() for t in pipe.producers)


def test_synthesized_jpeg_shards_match_jax(tmp_path):
    """The benchmark's JPEG shards are vdtpu's bit for bit (the same draws,
    the bicubic upsample equal to Pillow's, Pillow's encoder)."""
    ours = benchmark.synthesize_shards(str(tmp_path / "a"), n_shards=1, per_shard=3, size=64,
                                       fmt="jpg")
    ref = jbench.synthesize_shards(str(tmp_path / "b"), n_shards=1, per_shard=3, size=64)
    a = list(webdataset.tar_samples(os.path.join(ours, "shard-0000.tar")))
    b = list(jwds.tar_samples(os.path.join(ref, "shard-0000.tar"), use_native=False))
    assert a == b


def test_benchmark_png_shards_and_the_resize(tmp_path):
    """PNG shards with two samples at another size: the pipeline resizes
    them; the benchmark reports a rate."""
    root = benchmark.synthesize_shards(str(tmp_path / "png"), n_shards=2, per_shard=6, size=32,
                                       n_other=2)
    samples = [s for p in sorted(os.listdir(root))
               for s in webdataset.tar_samples(os.path.join(root, p))]
    sizes = [images.decode_png(s["png"]).shape[:2] for s in samples]
    assert sizes.count((32, 32)) == 10 and sizes[-2:] == [(36, 40), (36, 40)]
    imgs = [webdataset.decode_image(s["png"], 32) for s in samples]
    assert all(i.shape == (32, 32, 3) for i in imgs)
    assert benchmark.run(root, image_size=32, batch_size=4, threads=2, max_batches=2) > 0
