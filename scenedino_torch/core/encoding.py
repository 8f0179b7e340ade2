"""Positional code and depth normalization (counterpart of
`scenedino_tpu/core/encoding.py:15-59`).

The shipped config uses num_freqs=6, freq_factor=1.5, include_input=True:
d_out = 3 + 6*2*3 = 39, code_mode "z", inv_z.
"""
from __future__ import annotations

import math

import torch

from scenedino_torch.core import maximum

EPS = 1e-3


def normalize_z(z: torch.Tensor, d_min: float, d_max: float, inv_z: bool = True,
                eps: float = EPS) -> torch.Tensor:
    """Depth to [-1, 1], warped to inverse depth when inv_z."""
    if inv_z:
        zn = (1.0 / maximum(z, eps) - 1.0 / d_max) / (1.0 / d_min - 1.0 / d_max)
    else:
        zn = (z - d_min) / (d_max - d_min)
    return 2.0 * zn - 1.0


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
