"""Positional code and depth normalization (counterpart of
`scenedino_tpu/core/encoding.py:15-59`).

The shipped config uses num_freqs=6, freq_factor=1.5, include_input=True:
d_out = 3 + 6*2*3 = 39, code_mode "z", inv_z.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from scenedino_torch.core import maximum

EPS = 1e-3


def zn_constants(d_min: float, d_max: float, inv_z: bool = True) -> Tuple[float, float]:
    """(zn_sub, zn_scale): the normalized depth is fma(x - zn_sub, zn_scale,
    -1), x = 1 / max(z, eps) under inv_z, else z. These are the float32
    constants that jitted XLA folds the JAX package's `normalize_z` into
    (its compiled HLO): zn_sub = f32(1 / d_max) (or f32(d_min)) and
    zn_scale = f32(2) / f32(1 / d_min - 1 / d_max) (or of d_max - d_min),
    the division in float32. XLA's CPU code then computes the multiply and
    the add as one fused multiply-add."""
    den = 1.0 / d_min - 1.0 / d_max if inv_z else d_max - d_min
    sub = 1.0 / d_max if inv_z else d_min
    return float(np.float32(sub)), float(np.float32(2.0) / np.float32(den))


def fma32(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """a * b + c rounded once to float32, as a fused multiply-add (a a float32
    tensor, b and c float32 values): the product is exact in float64, and the
    sum there is rounded to odd (its exact error by TwoSum), so that its
    rounding to float32 is the only one. Differentiable in a."""
    with torch.no_grad():
        p = a.detach().double() * b
        s = p + c
        t = s - p
        err = (p - (s - t)) + (c - t)
        even = (s.view(torch.int64) & 1) == 0
        out = torch.where((err != 0) & even, torch.nextafter(s, torch.where(err > 0, math.inf, -math.inf)), s).float()
    if a.requires_grad:
        ab = a * b
        out = out + (ab - ab.detach())  # adds 0: the value stays, the gradient is b
    return out


def normalize_z(z: torch.Tensor, d_min: float, d_max: float, inv_z: bool = True,
                eps: float = EPS) -> torch.Tensor:
    """Depth to [-1, 1], warped to inverse depth when inv_z. A float32 z
    gives the bits of the JAX package's `normalize_z` under jit (see
    `zn_constants`); another dtype computes (x - zn_sub) zn_scale - 1 in it."""
    zn_sub, zn_scale = zn_constants(d_min, d_max, inv_z)
    x = (1.0 / maximum(z, eps) if inv_z else z) - zn_sub
    if x.dtype == torch.float32:
        return fma32(x, zn_scale, -1.0)
    return x * zn_scale - 1.0


def encode_coords(xy: torch.Tensor, z: torch.Tensor, distance: torch.Tensor, d_min: float,
                  d_max: float, mode: str = "z", inv_z: bool = True, eps: float = EPS) -> torch.Tensor:
    """NDC xy with the normalized depth ("z") or camera distance
    ("distance") -> (..., 3)."""
    depth_like = z if mode == "z" else distance
    return torch.cat([xy, normalize_z(depth_like, d_min, d_max, inv_z=inv_z, eps=eps)], -1)


def positional_encoding_dims(num_freqs: int = 6, d_in: int = 3, include_input: bool = True) -> int:
    d = num_freqs * 2 * d_in
    return d + d_in if include_input else d


def positional_encoding(x: torch.Tensor, num_freqs: int = 6, freq_factor: float = math.pi,
                        include_input: bool = True) -> torch.Tensor:
    """NeRF sin/cos code with the reference's channel order:
    [x?, sin(f0 x0..x2), cos(f0 x0..x2), sin(f1 x0..x2), ...].

    The cosine is computed as sin(f x + pi/2), as the reference does, so
    both packages round alike.
    """
    freqs = freq_factor * 2.0 ** torch.arange(num_freqs, device=x.device, dtype=x.dtype)
    fx = x[..., None, :] * torch.repeat_interleave(freqs, 2)[:, None]
    phases = torch.zeros(2 * num_freqs, device=x.device, dtype=x.dtype)
    phases[1::2] = math.pi * 0.5
    emb = torch.sin(fx + phases[:, None]).reshape(*x.shape[:-1], 2 * num_freqs * x.shape[-1])
    if include_input:
        emb = torch.cat([x, emb], -1)
    return emb
