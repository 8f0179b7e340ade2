"""`scenedino_torch.datasets.image_io`'s JPEG codec and INTER_AREA resize
against PIL and OpenCV (the port's stand-ins for
`scenedino_tpu/datasets/re10k.py:137,156-161`).

`read_jpeg` is held bit for bit to `PIL.Image.open(p).convert("RGB")`
(Pillow on libjpeg-turbo: the ISLOW IDCT, fancy upsampling) on JPEGs PIL
writes here: 4:2:0, 4:2:2 and 4:4:4, greyscale, sizes that leave partial
MCUs, optimized Huffman tables, restart markers, a 640x360 frame; and on
`write_jpeg`'s files. Progressive, arithmetic-coded, 12-bit and CMYK files
raise. `resize_area` is held to `cv2.resize(..., INTER_AREA)` on [0, 1]
float32 within 1e-6 in each of OpenCV's regimes.
"""
import io

import numpy as np
import pytest
import torch

from scenedino_torch.datasets import image_io

PIL = pytest.importorskip("PIL.Image")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _texture(h, w, seed, channels=3):
    """Smooth stripes plus noise, so the coefficients reach long codes and
    large sizes without being all noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / (5 + c) + y / (9 + 2 * c) + c) for c in range(channels)], -1)
    return np.clip(img + rng.normal(0, 14, img.shape), 0, 255).astype(np.uint8)


def _pil_jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    PIL.fromarray(img if img.shape[-1] == 3 else img[..., 0]).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil_decode(data: bytes) -> np.ndarray:
    return np.asarray(PIL.open(io.BytesIO(data)).convert("RGB"))


KINDS = {
    "q75-420": ((36, 64, 3), dict(quality=75)),
    "q95-444": ((36, 64, 3), dict(quality=95, subsampling=0)),
    "q85-422": ((36, 64, 3), dict(quality=85, subsampling=1)),
    "grey": ((36, 64, 1), dict(quality=75)),
    "odd-37x65-420": ((37, 65, 3), dict(quality=75)),
    "odd-37x65-422": ((37, 65, 3), dict(quality=90, subsampling=1)),
    "odd-37x65-grey": ((37, 65, 1), dict(quality=80)),
    "q100-444": ((37, 65, 3), dict(quality=100, subsampling=0)),
    "optimize": ((37, 65, 3), dict(quality=75, optimize=True)),
    "restarts": ((37, 65, 3), dict(quality=75, restart_marker_blocks=3)),
    "restarts-grey": ((37, 65, 1), dict(quality=75, restart_marker_blocks=3)),
    "restart-rows": ((37, 65, 3), dict(quality=75, restart_marker_rows=1)),
    "frame-640x360": ((360, 640, 3), dict(quality=75)),
}


@pytest.mark.parametrize("kind", list(KINDS))
def test_read_jpeg_equals_pil_bit_for_bit(tmp_path, kind):
    (h, w, c), kw = KINDS[kind]
    data = _pil_jpeg(_texture(h, w, h * w + c, c), **kw)
    path = tmp_path / "x.jpg"
    path.write_bytes(data)
    got = image_io.read_jpeg(path)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, _pil_decode(data))


@pytest.mark.parametrize("size", [(37, 65), (360, 640), (1, 1), (8, 16)])
def test_write_jpeg_decodes_as_pil_decodes_it(tmp_path, size):
    img = _texture(*size, seed=3)
    path = tmp_path / "w.jpg"
    image_io.write_jpeg(path, img, quality=90)
    ref = _pil_decode(path.read_bytes())
    np.testing.assert_array_equal(image_io.read_jpeg(path), ref)
    # PIL reads it as a baseline 4:2:0 YCbCr JPEG with Annex K's tables at quality 90
    im = PIL.open(path)
    assert im.mode == "RGB" and [tuple(c[1:]) for c in im.layer] == [(2, 2, 0), (1, 1, 1), (1, 1, 1)]
    assert im.quantization == PIL.open(io.BytesIO(_pil_jpeg(img, quality=90))).quantization
    if size == (360, 640):
        mse = np.mean((ref.astype(np.float64) - img) ** 2)
        assert 10 * np.log10(255 ** 2 / mse) > 25


def test_write_jpeg_tables_are_pils(tmp_path):
    """The four Huffman tables write_jpeg writes are the ones PIL writes
    (Annex K) byte for byte."""
    def dht(data):
        out, i = [], 2
        while data[i + 1] != 0xDA:
            n = int.from_bytes(data[i + 2:i + 4], "big")
            if data[i + 1] == 0xC4:
                out.append(data[i + 4:i + 2 + n])
            i += 2 + n
        return b"".join(sorted(out))

    img = _texture(16, 16, 0)
    image_io.write_jpeg(tmp_path / "w.jpg", img)
    assert dht((tmp_path / "w.jpg").read_bytes()) == dht(_pil_jpeg(img))


def _with_marker(data: bytes, old: int, new: int) -> bytes:
    i = data.index(bytes([0xFF, old]))
    return data[:i + 1] + bytes([new]) + data[i + 2:]


@pytest.mark.parametrize("kind", ["progressive", "arithmetic", "arithmetic-dac", "12-bit", "cmyk", "not-a-jpeg"])
def test_read_jpeg_refuses_what_it_does_not_decode(tmp_path, kind):
    img = _texture(16, 24, 1)
    base = _pil_jpeg(img, quality=75)
    data, match = {
        "progressive": (_pil_jpeg(img, progressive=True), "progressive"),
        "arithmetic": (_with_marker(base, 0xC0, 0xC9), "arithmetic"),
        "arithmetic-dac": (base[:2] + b"\xff\xcc\x00\x04\x00\x11" + base[2:], "arithmetic"),
        "12-bit": (None, "12-bit"),
        "cmyk": (None, "4 components"),
        "not-a-jpeg": (b"\x89PNG\r\n\x1a\n", "not a JPEG"),
    }[kind]
    if kind == "12-bit":
        i = base.index(b"\xff\xc0")
        data = base[:i + 4] + bytes([12]) + base[i + 5:]
    if kind == "cmyk":
        buf = io.BytesIO()
        PIL.fromarray(img).convert("CMYK").save(buf, "JPEG")
        data = buf.getvalue()
    path = tmp_path / "x.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match):
        image_io.read_jpeg(path)


# ------------------------------------------------------------- INTER_AREA
REGIMES = {
    "box-2x": ((64, 128), (32, 64)),
    "box-4x2": ((64, 128), (16, 64)),
    "overlap-1.25": ((360, 640), (288, 512)),  # the RE10K recipe's 640x360 -> 512x288
    "overlap-odd": ((37, 65), (20, 30)),
    "linear-up": ((32, 64), (48, 96)),  # the JAX CLI test's crop of a 64x36 frame to 96x48
    "mixed-up-down": ((30, 40), (45, 20)),
    "mixed-down-up": ((30, 40), (20, 60)),
    "identity": ((33, 47), (33, 47)),
}


@pytest.mark.parametrize("regime", list(REGIMES))
@pytest.mark.parametrize("channels", [3, 0])
def test_resize_area_matches_cv2(regime, channels):
    cv2 = pytest.importorskip("cv2")
    (sh, sw), (h, w) = REGIMES[regime]
    rng = np.random.default_rng(sh * sw + channels)
    img = rng.random((sh, sw, channels) if channels else (sh, sw)).astype(np.float32)
    ref = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
    got = image_io.resize_area(img, (h, w))
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-6


def test_interpolate_area_is_not_inter_area():
    """Why the port keeps its own: adaptive average pooling differs from
    INTER_AREA at the recipe's fractional factor."""
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(0).random((36, 64, 3)).astype(np.float32)
    ref = cv2.resize(img, (48, 28), interpolation=cv2.INTER_AREA)
    pooled = torch.nn.functional.interpolate(torch.from_numpy(img).permute(2, 0, 1)[None], size=(28, 48),
                                             mode="area")[0].permute(1, 2, 0).numpy()
    assert np.abs(pooled - ref).max() > 1e-3
    assert np.abs(image_io.resize_area(img, (28, 48)) - ref).max() <= 1e-6
