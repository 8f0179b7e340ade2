"""`F.interpolate(..., align_corners=False, antialias=False)` as two matmuls
(counterpart of `scenedino_tpu/core/resize.py:35-95`).

Each 1-D resampling is a dense (n_out, n_in) matrix built once in numpy
(float64 taps summed, then rounded to float32, exactly as the reference
builds it) and kept on the device per (n_in, n_out, mode, device); an
NHWC tensor is resized by one matmul per spatial axis. The matmuls keep
the input differentiable (the student's position embedding) and replace
torch's `upsample_bicubic2d`, which on the card ran as a slow scalar
kernel. Border taps clamp to the edge sample (torch's bounded accessor).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


def _cubic_weight(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel with torch's a = -0.75."""
    ax = np.abs(x)
    return np.where(
        ax <= 1.0,
        (a + 2.0) * ax**3 - (a + 3.0) * ax**2 + 1.0,
        np.where(ax < 2.0, a * (ax**3 - 5.0 * ax**2 + 8.0 * ax - 4.0), 0.0),
    )


@lru_cache(maxsize=None)
def torch_resize_matrix(n_in: int, n_out: int, mode: str = "bilinear") -> np.ndarray:
    """(n_out, n_in) float32 M with out = M @ in: one axis of
    `F.interpolate(mode=mode, align_corners=False, antialias=False)`.
    Callers must not write to the returned array (it is shared)."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    scale = n_in / n_out
    i = np.arange(n_out, dtype=np.float64)
    src = (i + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    t = src - i0
    if mode == "nearest":  # torch "nearest": floor(i * scale), no half-pixel shift
        taps = [(np.floor(i * scale).astype(np.int64), np.ones(n_out))]
    elif mode == "bilinear":
        taps = [(i0, 1.0 - t), (i0 + 1, t)]
    elif mode == "bicubic":
        taps = [
            (i0 - 1, _cubic_weight(t + 1.0)),
            (i0, _cubic_weight(t)),
            (i0 + 1, _cubic_weight(1.0 - t)),
            (i0 + 2, _cubic_weight(2.0 - t)),
        ]
    else:
        raise ValueError(f"unsupported mode: {mode!r}")
    m = np.zeros((n_out, n_in), dtype=np.float64)
    rows = np.arange(n_out)
    for idx, w in taps:
        np.add.at(m, (rows, np.clip(idx, 0, n_in - 1)), w)
    return m.astype(np.float32)


@lru_cache(maxsize=None)
def resize_matrix(n_in: int, n_out: int, mode: str, device: torch.device) -> torch.Tensor:
    """`torch_resize_matrix` as a float32 tensor on `device`, built once.
    It is built outside inference mode even when first asked for inside it
    (a serving request), so a later training step can save it for backward."""
    with torch.inference_mode(False):
        return torch.from_numpy(torch_resize_matrix(n_in, n_out, mode)).to(device)


def torch_interpolate(x: torch.Tensor, size: Tuple[int, int], mode: str = "bilinear") -> torch.Tensor:
    """`F.interpolate(x, size, mode=mode, align_corners=False, antialias=False)`
    for NHWC input x (..., H, W, C), computed in fp32, returned in x's dtype."""
    H, W = x.shape[-3], x.shape[-2]
    my = resize_matrix(H, int(size[0]), mode, x.device)
    mx = resize_matrix(W, int(size[1]), mode, x.device)
    y = torch.einsum("oh,...hwc->...owc", my, x.float())
    y = torch.einsum("ow,...hwc->...hoc", mx, y)
    return y.to(x.dtype)
