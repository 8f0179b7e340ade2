"""PNG and JPEG files and image resizes without PIL or OpenCV (the port's
stand-ins for `scenedino_tpu/datasets/kitti_360.py:27-39`,
`scenedino_tpu/datasets/seg2d.py:20-24,35-55` and
`scenedino_tpu/datasets/re10k.py:137,156-161`).

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

`read_jpeg` decodes baseline (and 8-bit extended) sequential Huffman
JPEGs, greyscale or YCbCr at any of libjpeg's integer samplings, as
`PIL.Image.open(path).convert("RGB")` does on libjpeg(-turbo)'s defaults,
bit for bit: the integer IDCT `jpeg_idct_islow` (jidctint.c) and its range
limit, the "fancy" triangle upsampling (jdsample.c) and the fixed-point
YCbCr -> RGB tables (jdcolor.c). Progressive, arithmetic-coded, lossless,
12-bit and four-channel files raise. The entropy decode is a Python loop
over 16-bit lookahead tables (libjpeg's `HUFF_LOOKAHEAD` idea, with the
coefficient's extra bits folded in); the rest is numpy. `write_jpeg`
writes baseline 4:2:0 with the Annex K tables at an IJG quality.
`resize_area` is `cv2.resize(..., interpolation=cv2.INTER_AREA)` on
float images in its three regimes (`F.interpolate(mode="area")` is
adaptive average pooling, which differs at fractional factors).
"""
from __future__ import annotations

import functools
import re
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


# ------------------------------------------------------------------ JPEG
# the zigzag scan: _ZIGZAG[i] is the natural (row-major) index of the i-th coefficient
_ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27,
                    20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58,
                    59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# start-of-frame markers that name another process than sequential Huffman
_SOF_REFUSED = {0xC2: "progressive", 0xC3: "lossless", 0xC5: "differential sequential",
                0xC6: "differential progressive", 0xC7: "differential lossless", 0xC9: "arithmetic-coded",
                0xCA: "arithmetic-coded progressive", 0xCB: "arithmetic-coded lossless",
                0xCD: "arithmetic-coded differential", 0xCE: "arithmetic-coded differential progressive",
                0xCF: "arithmetic-coded differential lossless"}
# jidctint.c's constants: FIX(x) = round(x * 2^13)
_CONST_BITS, _PASS1_BITS = 13, 2
_FIX = {"0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433, "0_765366865": 6270,
        "0_899976223": 7373, "1_175875602": 9633, "1_501321110": 12299, "1_847759065": 15137,
        "1_961570560": 16069, "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172}


@functools.lru_cache(maxsize=32)
def _huffman_tables(bits: bytes, values: bytes, is_dc: bool):
    """One DHT table as 16-bit lookahead lists. For a 16-bit window v
    starting at a code: the code's length and symbol, and, where the code
    and the coefficient's extra bits fit in the window, the bits consumed,
    the zero run (AC: 64 at end of block) and the coefficient; else None in
    its place (the decoder reads the extra bits after the window)."""
    bits = list(bits)
    lengths = np.repeat(np.arange(1, 17), bits)
    codes, code = [], 0
    for count in bits:
        codes.extend(range(code, code + count))
        code = (code + count) << 1
    code_len = np.zeros(65536, np.int64)
    symbol = np.zeros(65536, np.int64)
    for c, n, s in zip(codes, lengths.tolist(), values):
        lo = c << (16 - n)
        code_len[lo:lo + (1 << (16 - n))] = n
        symbol[lo:lo + (1 << (16 - n))] = s
    v = np.arange(65536, dtype=np.int64)
    size = symbol if is_dc else symbol & 15
    run = np.zeros_like(symbol) if is_dc else symbol >> 4
    if not is_dc:
        run = np.where(symbol == 0, 64, run)  # end of block
    fits = code_len + size <= 16
    extra = (v >> np.clip(16 - code_len - size, 0, 16)) & ((1 << size) - 1)
    coef = np.where(extra < (1 << np.maximum(size - 1, 0)), extra - (1 << size) + 1, extra)  # EXTEND
    coef = np.where(size == 0, 0, coef)
    total = np.where(fits, code_len + size, code_len)
    fast = [(n, r, c if ok else None) for n, r, c, ok in
            zip(total.tolist(), run.tolist(), coef.tolist(), fits.tolist())]
    return fast, code_len.tolist(), size.tolist()


def _segments(data: bytes, path):
    """(marker, payload) of each marker segment up to the first SOS, then
    ("scan", header, entropy-coded bytes) per scan, until EOI."""
    pos = 2
    n = len(data)
    while pos < n:
        if data[pos] != 0xFF:
            raise ValueError(f"{path}: expected a marker at byte {pos}")
        while pos < n and data[pos] == 0xFF:  # fill bytes
            pos += 1
        if pos >= n:
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            return
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        payload = data[pos + 2:pos + length]
        pos += length
        if marker != 0xDA:
            yield marker, payload
            continue
        end = re.compile(rb"\xff[^\x00\xd0-\xd7\xff]").search(data, pos)
        stop = n if end is None else end.start()
        yield 0xDA, (payload, data[pos:stop])
        pos = stop


def _frame(payload, path):
    precision, height, width, nc = struct.unpack(">BHHB", payload[:6])
    comps = [tuple(payload[6 + 3 * i:9 + 3 * i]) for i in range(nc)]  # (id, hv, tq)
    if precision != 8:
        raise ValueError(f"{path}: {precision}-bit samples; only 8-bit JPEGs are read")
    if nc not in (1, 3):
        raise ValueError(f"{path}: {nc} components; only greyscale and YCbCr JPEGs are read")
    if height == 0:
        raise ValueError(f"{path}: the height comes in a DNL marker, which is not read")
    return height, width, [(cid, hv >> 4, hv & 15, tq) for cid, hv, tq in comps]


def _decode_scan(header, entropy, comps, blocks, huff, restart, mcus, path):
    """Entropy-decode one sequential Huffman scan into `blocks` (per
    component a flat list of zigzag-ordered coefficients, 64 a block)."""
    ns = header[0]
    members = [(header[1 + 2 * i], header[2 + 2 * i]) for i in range(ns)]
    ss, se, a = header[1 + 2 * ns], header[2 + 2 * ns], header[3 + 2 * ns]
    if (ss, se, a) != (0, 63, 0):
        raise ValueError(f"{path}: a scan with spectral selection or successive approximation (progressive)")
    index = {c[0]: i for i, c in enumerate(comps)}
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    height, width, mcus_x, mcus_y = mcus
    schedule = []  # per MCU its blocks: (component, coefficient list, base, DC tables, AC tables)
    if ns == 1:  # non-interleaved: one block an MCU over the component's own block grid
        ci = index[members[0][0]]
        _, h, v, _ = comps[ci]
        bw = -(-(-(-width * h // hmax)) // 8)
        bh = -(-(-(-height * v // vmax)) // 8)
        stride = mcus_x * h
        dc, ac = huff[(0, members[0][1] >> 4)], huff[(1, members[0][1] & 15)]
        out = blocks[ci]
        schedule = [((ci, out, (y * stride + x) * 64, dc, ac),) for y in range(bh) for x in range(bw)]
    else:
        per = []
        for cid, tables in members:
            ci = index[cid]
            _, h, v, _ = comps[ci]
            dc, ac = huff[(0, tables >> 4)], huff[(1, tables & 15)]
            per.append((ci, h, v, mcus_x * h, dc, ac))
        for my in range(mcus_y):
            for mx in range(mcus_x):
                schedule.append(tuple((ci, blocks[ci], ((my * v + by) * stride + mx * h + bx) * 64, dc, ac)
                                      for ci, h, v, stride, dc, ac in per for by in range(v) for bx in range(h)))
    parts = re.split(rb"\xff[\xd0-\xd7]", entropy) if restart else [entropy]
    n_intervals = -(-len(schedule) // restart) if restart else 1
    if len(parts) < n_intervals:
        raise ValueError(f"{path}: {len(parts)} restart intervals, expected {n_intervals}")
    parts = [p.replace(b"\xff\x00", b"\xff") for p in parts[:n_intervals]]
    starts = np.cumsum([0] + [len(p) for p in parts])[:-1].tolist()
    raw = np.frombuffer(b"".join(parts) + b"\x00" * 8, np.uint8).astype(np.uint32)
    window = ((raw[:-3] << 24) | (raw[1:-2] << 16) | (raw[2:-1] << 8) | raw[3:]).tolist()
    per_interval = restart or len(schedule)
    for k_int, start in enumerate(starts):
        p = start * 8
        pred = [0, 0, 0]
        for mcu in schedule[k_int * per_interval:(k_int + 1) * per_interval]:
            for ci, out, base, dc, ac in mcu:
                # the DC difference
                v = (window[p >> 3] >> (16 - (p & 7))) & 0xFFFF
                n, _, diff = dc[0][v]
                if diff is None:
                    p += dc[1][v]
                    s = dc[2][v]
                    e = (window[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                    diff = e - (1 << s) + 1 if e < (1 << (s - 1)) else e
                    p += s
                else:
                    p += n
                pred[ci] += diff
                out[base] = pred[ci]
                # the AC coefficients
                fast = ac[0]
                k = 1
                while k < 64:
                    v = (window[p >> 3] >> (16 - (p & 7))) & 0xFFFF
                    n, r, c = fast[v]
                    if c is None:
                        p += ac[1][v]
                        s = ac[2][v]
                        e = (window[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                        c = e - (1 << s) + 1 if e < (1 << (s - 1)) else e
                        p += s
                    else:
                        p += n
                    k += r
                    if k >= 64:
                        break
                    out[base + k] = c
                    k += 1


def _idct_1d(x, axis, descale):
    """jpeg_idct_islow's 1-D pass along `axis` of (..., 8, 8) int64:
    coefficients in, samples out DESCALE'd by `descale` bits."""
    c = [np.take(x, i, axis=axis) for i in range(8)]
    f = _FIX
    z1 = (c[2] + c[6]) * f["0_541196100"]
    tmp2 = z1 - c[6] * f["1_847759065"]
    tmp3 = z1 + c[2] * f["0_765366865"]
    tmp0 = (c[0] + c[4]) << _CONST_BITS
    tmp1 = (c[0] - c[4]) << _CONST_BITS
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = c[7], c[5], c[3], c[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["1_175875602"]
    t0 = t0 * f["0_298631336"]
    t1 = t1 * f["2_053119869"]
    t2 = t2 * f["3_072711026"]
    t3 = t3 * f["1_501321110"]
    z1 = z1 * -f["0_899976223"]
    z2 = z2 * -f["2_562915447"]
    z3 = z3 * -f["1_961570560"] + z5
    z4 = z4 * -f["0_390180644"] + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    rounding = 1 << (descale - 1)
    out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0, tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
    return np.stack([(o + rounding) >> descale for o in out], axis=axis)


def _idct_islow(coefs: np.ndarray) -> np.ndarray:
    """(n, 8, 8) dequantized coefficients (row = vertical frequency) ->
    (n, 8, 8) uint8 samples, libjpeg's JDCT_ISLOW with its range limit: the
    result taken modulo 1024 as a signed 10-bit value, plus 128, clamped."""
    ws = _idct_1d(coefs.astype(np.int64), 1, _CONST_BITS - _PASS1_BITS)  # columns
    ws = ((ws + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31  # the work array holds C ints
    out = _idct_1d(ws, 2, _CONST_BITS + _PASS1_BITS + 3)  # rows
    out = ((out & 1023) ^ 512) - 512
    return np.clip(out + 128, 0, 255).astype(np.uint8)


def _fancy_h2(x: np.ndarray) -> np.ndarray:
    """jdsample.c's h2v1 triangle filter along the last axis: each output
    pair 3/4 of its sample plus 1/4 of the left and right neighbour, the
    edges replicated, biases 1 and 2."""
    x = x.astype(np.int32)
    left = np.concatenate([x[..., :1], x[..., :-1]], -1)
    right = np.concatenate([x[..., 1:], x[..., -1:]], -1)
    out = np.stack([(3 * x + left + 1) >> 2, (3 * x + right + 2) >> 2], -1)
    return out.reshape(*x.shape[:-1], -1)


def _fancy_v2(x: np.ndarray) -> np.ndarray:
    """jdsample.c's h1v2 triangle filter along the first axis, biases 1 and 2."""
    x = x.astype(np.int32)
    up = np.concatenate([x[:1], x[:-1]], 0)
    down = np.concatenate([x[1:], x[-1:]], 0)
    out = np.stack([(3 * x + up + 1) >> 2, (3 * x + down + 2) >> 2], 1)
    return out.reshape(-1, *x.shape[1:])


def _fancy_h2v2(x: np.ndarray) -> np.ndarray:
    """jdsample.c's h2v2 triangle filter: the column sums 3 * near + far
    row, then the same 3:1 horizontally, biases 8 and 7 over 16."""
    x = x.astype(np.int32)
    up = np.concatenate([x[:1], x[:-1]], 0)
    down = np.concatenate([x[1:], x[-1:]], 0)
    rows = np.stack([3 * x + up, 3 * x + down], 1).reshape(-1, x.shape[1])  # column sums
    left = np.concatenate([rows[:, :1], rows[:, :-1]], 1)
    right = np.concatenate([rows[:, 1:], rows[:, -1:]], 1)
    out = np.stack([(3 * rows + left + 8) >> 4, (3 * rows + right + 7) >> 4], -1)
    return out.reshape(rows.shape[0], -1)


def _upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """A component's plane of its real samples scaled by (fh, fv) as
    libjpeg's default (fancy) upsampling does: the triangle filters for
    2x1, 1x2 and 2x2 (2x1 and 2x2 only over planes wider than 2 samples),
    else sample replication."""
    if (fh, fv) == (1, 1):
        return plane
    if plane.shape[1] > 2 and (fh, fv) == (2, 1):
        return _fancy_h2(plane)
    if (fh, fv) == (1, 2):
        return _fancy_v2(plane)
    if plane.shape[1] > 2 and (fh, fv) == (2, 2):
        return _fancy_h2v2(plane)
    return np.repeat(np.repeat(plane, fv, 0), fh, 1)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert: 16-bit fixed-point tables, the green
    term shifted after the sum, clamped to [0, 255]."""
    one_half = 1 << 15
    cb = cb.astype(np.int64) - 128
    cr = cr.astype(np.int64) - 128
    y = y.astype(np.int64)

    def fix(v):
        return int(v * 65536 + 0.5)

    r = y + ((fix(1.40200) * cr + one_half) >> 16)
    g = y + ((-fix(0.34414) * cb + one_half - fix(0.71414) * cr) >> 16)
    b = y + ((fix(1.77200) * cb + one_half) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def read_jpeg(path) -> np.ndarray:
    """A baseline JPEG as (H, W, 3) uint8 RGB, greyscale repeated: equal,
    bit for bit, to `np.asarray(PIL.Image.open(path).convert("RGB"))` on
    libjpeg-turbo's default decode (ISLOW IDCT, fancy upsampling)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file")
    quant, huff, restart, frame, blocks, adobe = {}, {}, 0, None, None, None
    mcus = comps = None
    for marker, payload in _segments(data, path):
        if marker in _SOF_REFUSED:
            raise ValueError(f"{path}: a {_SOF_REFUSED[marker]} JPEG; only sequential Huffman JPEGs are read")
        if marker == 0xCC:
            raise ValueError(f"{path}: arithmetic coding (DAC); only Huffman-coded JPEGs are read")
        if marker == 0xDB:
            pos = 0
            while pos < len(payload):
                pq, tq = payload[pos] >> 4, payload[pos] & 15
                n = 64 * (pq + 1)
                table = np.frombuffer(payload[pos + 1:pos + 1 + n], ">u2" if pq else np.uint8)
                quant[tq] = table.astype(np.int64)
                pos += 1 + n
        elif marker == 0xC4:
            pos = 0
            while pos < len(payload):
                tc, th = payload[pos] >> 4, payload[pos] & 15
                n = sum(payload[pos + 1:pos + 17])
                huff[(tc, th)] = _huffman_tables(payload[pos + 1:pos + 17], payload[pos + 17:pos + 17 + n], tc == 0)
                pos += 17 + n
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", payload[:2])
        elif marker == 0xEE and payload[:5] == b"Adobe":
            adobe = payload[11] if len(payload) > 11 else 0
        elif marker in (0xC0, 0xC1):
            frame = _frame(payload, path)
            height, width, comps = frame
            hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
            mcus_x, mcus_y = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            if len(comps) == 1:
                mcus_x, mcus_y = -(-width // 8), -(-height // 8)
                comps = [(comps[0][0], 1, 1, comps[0][3])]
            mcus = (height, width, mcus_x, mcus_y)
            blocks = [[0] * (64 * mcus_x * h * mcus_y * v) for _, h, v, _ in comps]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{path}: a scan before the frame header")
            _decode_scan(*payload, comps, blocks, huff, restart, mcus, path)
    if frame is None:
        raise ValueError(f"{path}: no frame header")
    if len(comps) == 3 and (adobe == 0 or [c[0] for c in comps] == [82, 71, 66]):
        raise ValueError(f"{path}: an RGB-coded JPEG (Adobe transform 0); only YCbCr JPEGs are read")
    height, width, mcus_x, mcus_y = mcus
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    planes = []
    for (cid, h, v, tq), coefs in zip(comps, blocks):
        if tq not in quant:
            raise ValueError(f"{path}: component {cid} names quantization table {tq}, which is not defined")
        bx, by = mcus_x * h, mcus_y * v
        zz = np.array(coefs, np.int64).reshape(-1, 64) * quant[tq]
        nat = np.empty_like(zz)
        nat[:, _ZIGZAG] = zz
        samples = _idct_islow(nat.reshape(-1, 8, 8))
        plane = samples.reshape(by, bx, 8, 8).transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)
        # the component's real samples; the upsampling replicates its last column and row
        real = plane[:-(-height * v // vmax), :-(-width * h // hmax)]
        planes.append(_upsample(real, hmax // h, vmax // v)[:height, :width])
    if len(planes) == 1:
        return np.repeat(planes[0][..., None].astype(np.uint8), 3, -1)
    return _ycc_to_rgb(*planes)



# Annex K's example tables: quantization (natural order) and Huffman (BITS, the symbols' order)
_QUANT_LUMA = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69,
                        56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104,
                        113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_QUANT_CHROMA = np.full(64, 99)
_QUANT_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]
_AC_SYMBOLS = [0x00, 0xF0] + [r << 4 | s for r in range(16) for s in range(1, 11)]


def _annex_k_ac(head):
    """An Annex K AC table's symbol order: its irregular head, then every
    other symbol in increasing order (as the tables are printed)."""
    return head + sorted(set(_AC_SYMBOLS) - set(head))


_HUFF_SPECS = {  # (class, table id): (BITS, symbols)
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12))),
    (0, 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12))),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], _annex_k_ac(
        [0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71,
         0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
         0x82, 0x09, 0x0A, 0x16])),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], _annex_k_ac(
        [0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22,
         0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
         0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1])),
}


def _quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """jcparam.c's jpeg_quality_scaling and jpeg_add_quant_table (baseline:
    entries in [1, 255])."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _code_table(bits, symbols):
    """symbol -> (code, length) of a canonical Huffman table."""
    table, code, k = {}, 0, 0
    for n, count in enumerate(bits, start=1):
        for _ in range(count):
            table[symbols[k]] = (code, n)
            code += 1
            k += 1
        code <<= 1
    return table


def _fdct(blocks: np.ndarray) -> np.ndarray:
    """The orthonormal 8x8 DCT-II of (n, 8, 8) level-shifted samples, scaled
    as JPEG's (C B C^T)."""
    u = np.arange(8)
    c = np.cos((2 * u[None, :] + 1) * u[:, None] * np.pi / 16) * np.where(u == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))[:,
                                                                                                               None]
    return c @ blocks @ c.T


def _entropy_code(comp_blocks, tables) -> bytes:
    """Huffman-code the MCUs (per MCU the blocks of `comp_blocks[i]`, each an
    (n_mcu, k_i, 64) zigzag array, with `tables[i]` = (DC, AC) code tables)
    into the byte-stuffed entropy-coded segment."""
    values, lengths = [], []
    pred = [0] * len(comp_blocks)
    n_mcu = comp_blocks[0].shape[0]
    nonzero = [[[np.flatnonzero(b[1:]).tolist() for b in mcu] for mcu in blocks] for blocks in comp_blocks]
    lists = [blocks.tolist() for blocks in comp_blocks]
    for m in range(n_mcu):
        for ci, (dc_t, ac_t) in enumerate(tables):
            for b, nz in zip(lists[ci][m], nonzero[ci][m]):
                diff = b[0] - pred[ci]
                pred[ci] = b[0]
                s = abs(diff).bit_length()
                code, n = dc_t[s]
                values.append((code << s) | ((diff if diff >= 0 else diff + (1 << s) - 1) & ((1 << s) - 1)))
                lengths.append(n + s)
                last = 0
                for j in nz:
                    k = j + 1
                    run = k - last - 1
                    while run > 15:
                        code, n = ac_t[0xF0]
                        values.append(code)
                        lengths.append(n)
                        run -= 16
                    c = b[k]
                    s = abs(c).bit_length()
                    code, n = ac_t[run << 4 | s]
                    values.append((code << s) | ((c if c >= 0 else c + (1 << s) - 1) & ((1 << s) - 1)))
                    lengths.append(n + s)
                    last = k
                if last < 63:
                    code, n = ac_t[0x00]
                    values.append(code)
                    lengths.append(n)
    vals = np.array(values, np.int64)
    lens = np.array(lengths, np.int64)
    ends = np.cumsum(lens)
    owner = np.repeat(np.arange(len(lens)), lens)
    bits = (vals[owner] >> (ends[owner] - 1 - np.arange(int(ends[-1])))) & 1
    bits = np.concatenate([bits, np.ones(-len(bits) % 8, np.int64)])  # pad with 1-bits
    return np.packbits(bits.astype(np.uint8)).tobytes().replace(b"\xff", b"\xff\x00")


def write_jpeg(path, image: np.ndarray, quality: int = 75) -> None:
    """Write (H, W, 3) uint8 RGB as a baseline JFIF JPEG: YCbCr, chroma
    subsampled 2x2 (4:2:0, the mean of each 2x2 block of the edge-padded
    image), the Annex K quantization tables at IJG `quality` and the Annex
    K Huffman tables, no restart markers."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[-1] != 3:
        raise ValueError(f"write_jpeg takes (H, W, 3) uint8 RGB, got {image.shape} {image.dtype}")
    height, width = image.shape[:2]
    mx, my = -(-width // 16), -(-height // 16)
    rgb = np.pad(image.astype(np.float64), ((0, my * 16 - height), (0, mx * 16 - width), (0, 0)), mode="edge")
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128
    cb, cr = (c.reshape(my * 8, 2, mx * 8, 2).mean((1, 3)) for c in (cb, cr))
    quants = [_quality_table(_QUANT_LUMA, quality), _quality_table(_QUANT_CHROMA, quality)]

    def blocks_of(plane, qt, per):  # (n_mcu, per * per, 64) zigzag coefficients
        n = plane.shape[0] // 8, plane.shape[1] // 8
        t = plane.reshape(n[0], 8, n[1], 8).transpose(0, 2, 1, 3) - 128.0
        q = np.round(_fdct(t) / qt.reshape(8, 8)).astype(np.int64).reshape(n[0], n[1], 64)[..., _ZIGZAG]
        return q.reshape(n[0] // per, per, n[1] // per, per, 64).transpose(0, 2, 1, 3, 4).reshape(-1, per * per, 64)

    comp_blocks = [blocks_of(y, quants[0], 2), blocks_of(cb, quants[1], 1), blocks_of(cr, quants[1], 1)]
    codes = {key: _code_table(*spec) for key, spec in _HUFF_SPECS.items()}
    scan = _entropy_code(comp_blocks, [(codes[(0, 0)], codes[(1, 0)]), (codes[(0, 1)], codes[(1, 1)]),
                                       (codes[(0, 1)], codes[(1, 1)])])

    def segment(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    out = [b"\xff\xd8", segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for tq, qt in enumerate(quants):
        out.append(segment(0xDB, bytes([tq]) + bytes(qt[_ZIGZAG].astype(np.uint8).tolist())))
    out.append(segment(0xC0, struct.pack(">BHHB", 8, height, width, 3) + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for (tc, th), (bits, symbols) in _HUFF_SPECS.items():
        out.append(segment(0xC4, bytes([tc << 4 | th]) + bytes(bits) + bytes(symbols)))
    out.append(segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    out.append(scan + b"\xff\xd9")
    with open(path, "wb") as f:
        f.write(b"".join(out))


# ------------------------------------------------------------ INTER_AREA
_DBL_EPSILON = 2.220446049250313e-16


def _gathered(pairs, n_out):
    """(destination, source, weight) triples -> (n_out, T) source indices
    and float64 weights (padding: source 0, weight 0)."""
    taps = [[] for _ in range(n_out)]
    for d, s, a in pairs:
        taps[d].append((s, a))
    t = max(len(x) for x in taps)
    idx = np.zeros((n_out, t), np.int64)
    wts = np.zeros((n_out, t), np.float64)
    for d, x in enumerate(taps):
        for j, (s, a) in enumerate(x):
            idx[d, j], wts[d, j] = s, a
    return idx, wts


def _area_tab(n_in: int, n_out: int, scale: float):
    """OpenCV's computeResizeAreaTab: each output cell [d * scale, (d + 1)
    * scale) covers whole source pixels with weight 1 / cell and the two
    partial ones with their overlap (a partial one under 1e-3 dropped),
    float32 weights."""
    pairs = []
    for d in range(n_out):
        fsx1 = d * scale
        fsx2 = fsx1 + scale
        cell = min(scale, n_in - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, n_in - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            pairs.append((d, sx1 - 1, float(np.float32((sx1 - fsx1) / cell))))
        for s in range(sx1, sx2):
            pairs.append((d, s, float(np.float32(1.0 / cell))))
        if fsx2 - sx2 > 1e-3:
            pairs.append((d, sx2, float(np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell))))
    return _gathered(pairs, n_out)


def _area_linear_taps(n_in: int, n_out: int, scale: float, inv_scale: float):
    """cv2.resize's INTER_LINEAR taps in area mode (an upscaled axis of
    INTER_AREA, and the other axis too): source floor(d * scale), weight of
    the next source (d + 1) - (s + 1) / scale in float32 wrapped to [0, 1),
    the last source clamped."""
    pairs = []
    for d in range(n_out):
        s = int(np.floor(d * scale))
        f = np.float32((d + 1) - (s + 1) * inv_scale)
        f = np.float32(0.0) if f <= 0 else f - np.float32(np.floor(f))
        if s >= n_in - 1:
            s, f = n_in - 1, np.float32(0.0)
        pairs += [(d, s, float(np.float32(1.0) - f)), (d, min(s + 1, n_in - 1), float(f))]
    return _gathered(pairs, n_out)


def resize_area(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H, W) or (H, W, C) float image -> size (h, w), as `cv2.resize(img,
    (w, h), interpolation=cv2.INTER_AREA)` on float32 (to ~1e-7: the sums
    are taken in float64 with OpenCV's float32 weights). OpenCV's regimes:
    both axes shrunk by whole factors, the box mean; both shrunk, one by a
    fractional factor, the overlap weights; either axis enlarged, INTER_LINEAR
    with area-mode weights on both axes."""
    img = np.asarray(img, np.float32)
    h, w = size
    n_y, n_x = img.shape[:2]
    inv_x, inv_y = w / n_x, h / n_y  # OpenCV's inv_scale from dsize, then scale = 1 / inv_scale
    scale_x, scale_y = 1.0 / inv_x, 1.0 / inv_y
    if scale_x >= 1 and scale_y >= 1:
        ix, iy = int(round(scale_x)), int(round(scale_y))
        if abs(scale_x - ix) < _DBL_EPSILON and abs(scale_y - iy) < _DBL_EPSILON:  # resizeAreaFast
            y_taps = (np.arange(h)[:, None] * iy + np.arange(iy), np.full((h, iy), 1.0 / iy))
            x_taps = (np.arange(w)[:, None] * ix + np.arange(ix), np.full((w, ix), 1.0 / ix))
        else:
            y_taps, x_taps = _area_tab(n_y, h, scale_y), _area_tab(n_x, w, scale_x)
    else:
        y_taps = _area_linear_taps(n_y, h, scale_y, inv_y)
        x_taps = _area_linear_taps(n_x, w, scale_x, inv_x)
    x = img.astype(np.float64)
    (iy_, wy), (ix_, wx) = y_taps, x_taps
    rows = (x[:, ix_] * wx.reshape(1, w, -1, *(1,) * (x.ndim - 2))).sum(2)
    out = (rows[iy_] * wy.reshape(h, -1, *(1,) * (x.ndim - 1))).sum(1)
    return out.astype(np.float32)
