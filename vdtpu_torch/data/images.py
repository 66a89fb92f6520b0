"""Image codecs and resampling of the input pipeline, on the standard
library and numpy alone (Pillow may be absent where the port runs).

- ``encode_png`` / ``decode_png``: 8-bit PNG through ``zlib``. The decoder
  takes every filter type and the colour types Pillow's ``convert("RGB")``
  maps plainly (grey, RGB, palette, grey + alpha, RGBA at 8 bits; RGB and
  RGBA at 16 bits by their high bytes, as Pillow's unpackers take them);
  alpha is dropped, as ``convert("RGB")`` drops it. Other PNGs (interlaced,
  under 8 bits, 16-bit grey) raise ``UnsupportedPNG``.
- ``resize_bicubic``: Pillow's ``Image.resize(..., BICUBIC)`` on 8-bit RGB,
  in numpy: the same coefficients (a = -0.5, support 2 scaled by the
  reduction, normalized, in 22-bit fixed point), the horizontal pass first,
  rounded and clipped to 8 bits, then the vertical pass.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PRECISION_BITS = 32 - 8 - 2   # Pillow's 8-bit resample fixed point


class UnsupportedPNG(ValueError):
    """A PNG form this decoder does not take (interlace, < 8 bits, ...)."""


def encode_png(rgb: np.ndarray, level: int = 6) -> bytes:
    """An 8-bit RGB PNG of ``rgb`` [H, W, 3] uint8 (filter 0 on every row)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"encode_png takes [H, W, 3], got {rgb.shape}")

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, 3 * w)], axis=1)
    return (PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + chunk(b"IEND", b""))


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """PNG scanline filters undone: [h, stride] uint8."""
    rows = np.frombuffer(data, np.uint8)
    if rows.size < h * (stride + 1):
        raise ValueError("PNG: truncated image data")
    rows = rows[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        f, line = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        if f == 0:
            cur = line
        elif f == 1:     # Sub: a running sum at each of the pixel's bytes
            cur = np.zeros(stride, np.int32)
            for c in range(bpp):
                cur[c::bpp] = np.cumsum(line[c::bpp]) & 255
        elif f == 2:     # Up
            cur = (line + prev) & 255
        elif f in (3, 4):
            cur = bytearray(stride)
            ln, up = line.tolist(), prev.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if f == 3:
                    cur[i] = (ln[i] + ((a + b) >> 1)) & 255
                else:
                    cc = up[i - bpp] if i >= bpp else 0
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
                    cur[i] = (ln[i] + pred) & 255
            cur = np.frombuffer(bytes(cur), np.uint8).astype(np.int32)
        else:
            raise ValueError(f"PNG: unknown filter type {f}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """[H, W, 3] uint8 of a PNG, as Pillow's ``open(...).convert("RGB")``
    gives it; raises ``ValueError`` on a damaged file, ``UnsupportedPNG``
    on a form it does not take."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG")
    pos, idat, header, palette = len(PNG_SIGNATURE), [], None, None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise ValueError("PNG: truncated chunk")
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != \
                zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"PNG: bad CRC in {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None or not idat:
        raise ValueError("PNG: no IHDR or image data")
    w, h, depth, ctype, _, _, interlace = header
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(ctype)
    if channels is None:
        raise ValueError(f"PNG: colour type {ctype}")
    if interlace or depth not in (8, 16) or (depth == 16 and ctype in (0, 3, 4)):
        raise UnsupportedPNG(f"PNG: interlace {interlace}, depth {depth}, colour type {ctype}")
    nbytes = depth // 8
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * channels * nbytes,
                   channels * nbytes).reshape(h, w, channels * nbytes)
    if nbytes == 2:                  # big-endian samples: their high bytes
        px = px[..., 0::2]
    if ctype == 3:
        if palette is None:
            raise ValueError("PNG: palette image without PLTE")
        idx = px[..., 0]
        if int(idx.max(initial=0)) >= len(palette):
            palette = np.concatenate([palette, np.zeros((256 - len(palette), 3), np.uint8)])
        return palette[idx]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coeffs(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` (box [0, in_size]) and
    ``normalize_coeffs_8bpc``: (first source index [out], int32 weights
    [out, ksize])."""
    scale = float(np.float32(in_size)) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    x = np.arange(ksize)
    w = _bicubic((x[None, :] + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(x[None, :] < xmax[:, None], w, 0.0)
    ww = w.sum(axis=1, keepdims=True)
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    k = np.where(w < 0, np.trunc(-0.5 + w * (1 << _PRECISION_BITS)),
                 np.trunc(0.5 + w * (1 << _PRECISION_BITS))).astype(np.int64)
    return xmin, k


def _pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit pass along ``axis`` of an [H, W, C] uint8 image."""
    xmin, k = _coeffs(img.shape[axis], out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)       # [in, other, C]
    n = src.shape[0]
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    for j in range(k.shape[1]):
        idx = np.minimum(xmin + j, n - 1)                  # weights past xmax are 0
        acc += src[idx] * k[:, j].reshape(-1, *([1] * (src.ndim - 1)))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Pillow's BICUBIC ``resize`` of an [H, W, 3] uint8 image to ``size`` =
    (width, height); an image already at ``size`` is returned as it is."""
    w, h = size
    if (img.shape[1], img.shape[0]) == (w, h):
        return img
    if img.shape[1] != w:
        img = _pass(img, w, 1)
    if img.shape[0] != h:
        img = _pass(img, h, 0)
    return img
