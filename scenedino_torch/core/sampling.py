"""Depth sampling along rays (counterpart of
`scenedino_tpu/core/sampling.py:14-111`): stratified samples, importance
samples from the coarse weights, gaussian samples around a depth, and the
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


def _take_per_row(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[r, ids[r, n]] (the reference's one-hot contraction, sampling.py:45)."""
    return torch.gather(table, 1, ids)


def _pdf_cdf(weights: torch.Tensor, eps: float) -> torch.Tensor:
    """The CDF of the detached weights + eps, a leading 0: (R, Kb + 1)."""
    w = weights.detach() + eps
    pdf = w / torch.sum(w, -1, keepdim=True)
    return torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)], -1)


def sample_fine(rays: torch.Tensor, weights: torch.Tensor, n_samples: int, n_coarse: int,
                lindisp: bool = True, eps: float = 1e-5, u: Optional[torch.Tensor] = None,
                t: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Importance samples from the coarse weights by inverse CDF
    (reference sampling.py:53-72): u picks a coarse stratum (the count of
    CDF entries <= u, less one), t the place inside it; both
    (R, n_samples) in [0, 1), drawn from `generator` (u first) when None.
    weights (R, Kc), no gradient. Returns (R, n_samples) depths."""
    R = rays.shape[0]
    cdf = _pdf_cdf(weights, eps)
    u = _draws(u, (R, n_samples), cdf, generator, "u")
    t = _draws(t, (R, n_samples), cdf, generator, "t")
    inds = torch.clamp(_searchsorted_right(cdf, u).to(cdf.dtype) - 1.0, min=0.0)
    z_steps = (inds + t) / n_coarse
    return _to_depth(z_steps, rays[:, 6:7], rays[:, 7:8], lindisp)


def sample_fine_depth(rays: torch.Tensor, depth: torch.Tensor, n_samples: int, depth_std: float = 1.0,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Gaussian samples around each ray's depth (R,), clamped to
    [near, far] (reference sampling.py:105-111). noise: (R, n_samples)
    standard normal draws, drawn from `generator` when None. The gradient
    reaches `depth`, as in the reference."""
    R = rays.shape[0]
    if noise is None:
        noise = torch.randn((R, n_samples), generator=generator, device=depth.device, dtype=depth.dtype)
    elif tuple(noise.shape) != (R, n_samples):
        raise ValueError(f"noise must be {(R, n_samples)}, got {tuple(noise.shape)}")
    z = depth[:, None] + noise.to(depth.dtype) * depth_std
    return torch.minimum(torch.maximum(z, rays[:, 6:7]), rays[:, 7:8])


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
    cdf = _pdf_cdf(weights, eps)
    u = _draws(u, (R, n_samples), cdf, generator, "u")
    t = _draws(t, (R, n_samples), cdf, generator, "t")
    ids = torch.clamp(_searchsorted_right(cdf, u) - 1, 0, num_bins - 1)
    zs = 1.0 / z_samp if lindisp else z_samp
    centers = 0.5 * (zs[:, 1:] + zs[:, :-1])
    borders = torch.cat([zs[:, :1], centers, zs[:, -1:]], -1)  # (R, Kb + 1)
    left = _take_per_row(borders, ids)
    right = _take_per_row(borders, ids + 1)
    z_new = left * (1.0 - t) + right * t
    return 1.0 / z_new if lindisp else z_new
