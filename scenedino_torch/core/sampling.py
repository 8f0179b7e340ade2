"""Depth sampling along rays (counterpart of
`scenedino_tpu/core/sampling.py:14-102`): stratified samples and the
proposal resampler of the probe-guided render.

The draws are an explicit input: `jax.random` cannot be matched from
torch, so a caller that must agree with the reference hands both the same
numbers.
"""
from __future__ import annotations

from typing import Optional

import torch


def _draws(u: Optional[torch.Tensor], shape, like: torch.Tensor, generator, name: str) -> torch.Tensor:
    if u is None:
        return torch.rand(shape, generator=generator, device=like.device, dtype=like.dtype)
    if tuple(u.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(u.shape)}")
    return u.to(like.dtype)


def _to_depth(z_steps: torch.Tensor, near: torch.Tensor, far: torch.Tensor, lindisp: bool) -> torch.Tensor:
    if lindisp:
        return 1.0 / (1.0 / near * (1.0 - z_steps) + 1.0 / far * z_steps)
    return near * (1.0 - z_steps) + far * z_steps


def sample_coarse(rays: torch.Tensor, n_samples: int, lindisp: bool = True,
                  u: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stratified samples between near (rays[:, 6]) and far (rays[:, 7]).

    u: (R, n_samples) draws in [0, 1); drawn from `generator` when None.
    Returns (R, n_samples) depths: z_steps = linspace(0, 1-1/K, K) + u/K.
    """
    R = rays.shape[0]
    u = _draws(u, (R, n_samples), rays, generator, "u")
    step = 1.0 / n_samples
    z_steps = torch.linspace(0.0, 1.0 - step, n_samples, device=rays.device, dtype=rays.dtype)[None]
    return _to_depth(z_steps + u * step, rays[:, 6:7], rays[:, 7:8], lindisp)


def _searchsorted_right(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Per-row count of cdf entries <= u, as the reference's compare-and-sum
    (sampling.py:31): cdf (R, Kb + 1), u (R, N) -> (R, N) int64."""
    return torch.sum(cdf[:, None, :] <= u[:, :, None], -1)


def sample_coarse_from_dist(rays: torch.Tensor, weights: torch.Tensor, z_samp: torch.Tensor,
                            n_samples: int, lindisp: bool = True, eps: float = 1e-5,
                            u: Optional[torch.Tensor] = None, t: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Proposal resampling from a piecewise-constant depth histogram
    (reference sampling.py:75-102, nerf.py:143-179).

    weights, z_samp: (R, Kb), z_samp the bin centres. u picks the bin by
    inverse CDF (a u equal to a CDF value picks the bin that starts
    there), t the place inside it; both (R, n_samples) in [0, 1), drawn
    from `generator` (u first) when None. Returns (R, n_samples) depths,
    interpolated between the bin borders in disparity under lindisp.
    """
    R, num_bins = weights.shape
    w = weights.detach() + eps
    pdf = w / torch.sum(w, -1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)], -1)
    u = _draws(u, (R, n_samples), cdf, generator, "u")
    t = _draws(t, (R, n_samples), cdf, generator, "t")
    ids = torch.clamp(_searchsorted_right(cdf, u) - 1, 0, num_bins - 1)
    zs = 1.0 / z_samp if lindisp else z_samp
    centers = 0.5 * (zs[:, 1:] + zs[:, :-1])
    borders = torch.cat([zs[:, :1], centers, zs[:, -1:]], -1)  # (R, Kb + 1)
    left = torch.gather(borders, 1, ids)
    right = torch.gather(borders, 1, ids + 1)
    z_new = left * (1.0 - t) + right * t
    return 1.0 / z_new if lindisp else z_new
