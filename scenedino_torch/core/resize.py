"""Resizes as two matmuls: `F.interpolate(..., align_corners=False,
antialias=False)` (counterpart of `scenedino_tpu/core/resize.py:35-95`)
and the antialiased bilinear filter of `jax.image.resize` (the DINOv2
encoders' 14/16 pre-resize, `scenedino_tpu/models/encoder.py:91-96`).

Each 1-D resampling is a dense (n_out, n_in) matrix built once in numpy
and kept on the device per (n_in, n_out, mode, device); a tensor is
resized by one matmul per spatial axis. The matmuls keep the input
differentiable (the student's position embedding and image) and replace
torch's `upsample_bicubic2d`, which on the card ran as a slow scalar
kernel.

  * "nearest", "bilinear", "bicubic": torch's taps in float64, summed,
    then rounded to float32, exactly as the reference builds them; border
    taps clamp to the edge sample (torch's bounded accessor).
  * "jax_bilinear": `jax.image.resize(..., "bilinear")`, i.e. JAX's
    `scale_and_translate` with the triangle kernel widened by 1/scale on a
    downscale, in float32 as JAX computes it, each output's weights
    normalized to sum 1. Bilinear without the widening misses it by about 1
    on ImageNet-normalized images at 192x640 -> 168x560.
  * "jax_bicubic", "jax_nearest": `jax.image.resize(..., "bicubic")`
    (Keys' cubic with a = -0.5, the same widening and normalization: at a
    border the taps outside are dropped and the rest renormalized, where
    torch clamps them onto the edge) and `jax.image.resize(..., "nearest")`
    (the half-pixel rule floor((i + 0.5) n_in / n_out), where torch's
    nearest takes floor(i n_in / n_out)). `NoDecoder` resizes with them.
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


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """JAX's `_fill_keys_cubic_kernel` (a = -0.5) in float32, x >= 0."""
    f32 = np.float32
    out = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    out = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), out)
    return np.where(x >= 2.0, f32(0.0), out).astype(f32)


@lru_cache(maxsize=None)
def jax_resize_matrix(n_in: int, n_out: int, method: str = "bilinear") -> np.ndarray:
    """(n_out, n_in) float32 M with out = M @ in: one axis of
    `jax.image.resize(..., method=method)` ("nearest", "bilinear" or
    "bicubic"; antialias on, no translation), built in float32 as
    `jax._src.image.scale` builds it. Callers must not write to the
    returned array (it is shared)."""
    if n_in == n_out:  # jax.image.resize skips an axis whose size is unchanged
        return np.eye(n_in, dtype=np.float32)
    f32 = np.float32
    if method == "nearest":
        idx = np.floor((np.arange(n_out, dtype=f32) + f32(0.5)) * f32(n_in) / f32(n_out)).astype(np.int64)
        m = np.zeros((n_out, n_in), dtype=f32)
        m[np.arange(n_out), idx] = 1.0
        return m
    kernels = {"bilinear": lambda x: np.maximum(f32(0.0), f32(1.0) - x), "bicubic": _keys_cubic}
    if method not in kernels:
        raise ValueError(f"unsupported jax.image.resize method: {method!r}")
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))  # widen the kernel on a downscale only
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = kernels[method](x).astype(f32)  # (n_in, n_out)
    total = w.sum(0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps, w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, f32(0.0)).T, dtype=f32)


# resize_matrix's modes that are jax.image.resize methods
JAX_MODES = {"jax_bilinear": "bilinear", "jax_bicubic": "bicubic", "jax_nearest": "nearest"}


@lru_cache(maxsize=None)
def resize_matrix(n_in: int, n_out: int, mode: str, device: torch.device) -> torch.Tensor:
    """`torch_resize_matrix` (or, for a mode of `JAX_MODES`, `jax_resize_matrix`)
    as a float32 tensor on `device`, built once. It is built outside
    inference mode even when first asked for inside it (a serving request),
    so a later training step can save it for backward."""
    m = (jax_resize_matrix(n_in, n_out, JAX_MODES[mode]) if mode in JAX_MODES
         else torch_resize_matrix(n_in, n_out, mode))
    with torch.inference_mode(False):
        return torch.from_numpy(m).to(device)


def torch_interpolate(x: torch.Tensor, size: Tuple[int, int], mode: str = "bilinear") -> torch.Tensor:
    """`F.interpolate(x, size, mode=mode, align_corners=False, antialias=False)`
    for NHWC input x (..., H, W, C), computed in fp32, returned in x's dtype."""
    H, W = x.shape[-3], x.shape[-2]
    my = resize_matrix(H, int(size[0]), mode, x.device)
    mx = resize_matrix(W, int(size[1]), mode, x.device)
    y = torch.einsum("oh,...hwc->...owc", my, x.float())
    y = torch.einsum("ow,...hwc->...hoc", mx, y)
    return y.to(x.dtype)


def jax_resize(x: torch.Tensor, size: Tuple[int, int], method: str = "bilinear") -> torch.Tensor:
    """`jax.image.resize(x, (..., *size), method=method)` for NCHW input x
    (..., H, W), method "nearest", "bilinear" or "bicubic", computed in fp32
    and returned in x's dtype."""
    H, W = x.shape[-2], x.shape[-1]
    my = resize_matrix(H, int(size[0]), f"jax_{method}", x.device)
    mx = resize_matrix(W, int(size[1]), f"jax_{method}", x.device)
    y = torch.einsum("oh,...hw->...ow", my, x.float())
    y = torch.einsum("pw,...ow->...op", mx, y)
    return y.to(x.dtype)
