"""PNG files and image resizes without PIL or OpenCV (the port's stand-ins
for `scenedino_tpu/datasets/kitti_360.py:27-39` and
`scenedino_tpu/datasets/seg2d.py:20-24,35-55`).

`read_png` and `write_png` handle 8-bit greyscale, RGB and RGBA PNGs
without interlacing, every one of the five row filters, on the standard
library's `zlib`; anything else raises. `resize_bilinear` and
`resize_nearest` reproduce `cv2.resize` with `INTER_LINEAR` and
`INTER_NEAREST`: half-pixel centres, no antialias, the clamped border, and
the source positions computed in float64 as OpenCV computes them.
`F.interpolate` computes them in float32, which moves a 376x1408 ->
192x640 bilinear resize by up to 7e-5 on [0, 1] data; its legacy
"nearest" agrees with OpenCV at the evaluators' shapes, but the same
float64 positions serve both here.
"""
from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np
import torch

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels, for bit depth 8
_CHANNELS = {0: 1, 2: 3, 6: 4}
_COLOUR_TYPE = {1: 0, 3: 2, 4: 6}


def _chunks(data: bytes, path):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        yield kind, body
        pos += 12 + n


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(rows: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the row filters: rows (H, W * bpp) uint8 as stored, filters (H,).

    A byte depends on the reconstructed byte one pixel to its left and on
    the row above, so the pixels of one anti-diagonal (row + column fixed)
    are independent: the walk takes H + W - 1 vector steps, each applying
    every row's own filter to its pixel on the diagonal."""
    H, n = rows.shape
    W = n // bpp
    filt = rows.reshape(H, W, bpp).astype(np.int32)
    out = np.zeros((H + 1, W + 1, bpp), np.int32)  # a zero row above and a zero pixel to the left
    ftype = filters.astype(np.int32)
    for t in range(H + W - 1):
        r = np.arange(max(0, t - W + 1), min(H, t + 1))
        x = t - r
        a = out[r + 1, x]  # left
        b = out[r, x + 1]  # up
        c = out[r, x]  # up-left
        f = ftype[r][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4], [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        out[r + 1, x + 1] = (filt[r, x] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def read_png(path) -> np.ndarray:
    """An 8-bit PNG: (H, W) uint8 for greyscale, (H, W, 3) or (H, W, 4) for
    RGB or RGBA. Other bit depths, palettes, grey with alpha and interlaced
    files raise."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: only 8-bit greyscale, RGB and RGBA PNGs without interlacing are read "
                         f"(bit depth {depth}, colour type {colour}, interlace {interlace})")
    bpp = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = width * bpp + 1
    if raw.size != height * stride:
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected {height * stride}")
    raw = raw.reshape(height, stride)
    filters = raw[:, 0]
    if int(filters.max(initial=0)) > 4:
        raise ValueError(f"{path}: unknown row filter {int(filters.max())}")
    if filters.any():
        pixels = _unfilter(raw[:, 1:], filters, bpp)
    else:
        pixels = raw[:, 1:].copy()
    pixels = pixels.reshape(height, width, bpp)
    return pixels[..., 0] if bpp == 1 else pixels


def _filter(pixels: np.ndarray, filter_type: int, bpp: int) -> np.ndarray:
    """Apply one row filter to every row: pixels (H, W * bpp) uint8."""
    x = pixels.astype(np.int32)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    pred = {0: 0, 1: left, 2: up, 3: (left + up) >> 1, 4: _paeth(left, up, upleft)}[filter_type]
    return ((x - pred) & 255).astype(np.uint8)


def write_png(path, image: np.ndarray, filter_type: int = 0) -> None:
    """Write (H, W) greyscale or (H, W, 3 | 4) RGB(A) uint8 as a PNG, every
    row with `filter_type` (0 none, 1 sub, 2 up, 3 average, 4 Paeth),
    deflated at zlib's fastest level."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 pixels, got {image.dtype}")
    bpp = 1 if image.ndim == 2 else image.shape[-1]
    if image.ndim not in (2, 3) or bpp not in _COLOUR_TYPE or filter_type not in range(5):
        raise ValueError(f"write_png takes (H, W), (H, W, 3) or (H, W, 4) and a filter 0-4, got "
                         f"{image.shape} and {filter_type}")
    height, width = image.shape[:2]
    rows = _filter(image.reshape(height, width * bpp), filter_type, bpp)
    raw = np.concatenate([np.full((height, 1), filter_type, np.uint8), rows], 1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", width, height, 8, _COLOUR_TYPE[bpp], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
                + chunk(b"IEND", b""))


def read_rgb(path) -> np.ndarray:
    """A PNG as (H, W, 3) float32 in [0, 1]: greyscale repeated, alpha
    dropped (PIL's `convert("RGB")`)."""
    img = read_png(path)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    return img[..., :3].astype(np.float32) / 255.0


def _linear_taps(n_in: int, n_out: int):
    """OpenCV's INTER_LINEAR taps of one axis: the source positions
    (d + 0.5) * n_in / n_out - 0.5 in float64, clamped at the border;
    (i0, i1, the weight of i1 in float32)."""
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(src).astype(np.int64)
    w = np.where(i0 < 0, 0.0, src - i0)
    i0 = np.clip(i0, 0, n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    return torch.from_numpy(i0), torch.from_numpy(i1), torch.from_numpy(w.astype(np.float32))


def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H, W) or (H, W, C) float image -> size (h, w), as `cv2.resize(img,
    (w, h), interpolation=cv2.INTER_LINEAR)` on float32: the horizontal
    pass, then the vertical, in float32 with float32 weights (in torch)."""
    t = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    h, w = size
    y0, y1, wy = _linear_taps(t.shape[0], h)
    x0, x1, wx = _linear_taps(t.shape[1], w)
    shape = (1, -1) + (1,) * (t.ndim - 2)
    wx, wy = wx.reshape(shape), wy.reshape((-1,) + (1,) * (t.ndim - 1))
    rows = t[:, x0] * (1.0 - wx) + t[:, x1] * wx
    return (rows[y0] * (1.0 - wy) + rows[y1] * wy).numpy()


def resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H, W) or (H, W, C) image of any dtype -> size (h, w), as
    `cv2.INTER_NEAREST`: the source index floor(d * n_in / n_out) in
    float64, clamped to the last. Values and dtype are kept (labels stay
    exact)."""
    h, w = size

    def taps(n_in, n_out):
        scale = 1.0 / (n_out / n_in)  # OpenCV's ifx = 1 / fx
        return np.minimum(np.floor(np.arange(n_out) * scale).astype(np.int64), n_in - 1)

    return np.asarray(img)[taps(img.shape[0], h)][:, taps(img.shape[1], w)]
