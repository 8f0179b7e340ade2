"""Alpha compositing (counterpart of `scenedino_tpu/core/compositing.py`).

alpha = 1 - exp(-|delta| * relu(sigma)), an optional hard cap on the last
sample, transmittance as the exclusive product of max(1 - alpha, 1e-10),
weights = alpha * T. Accumulation is fp32 whatever the input dtype.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from scenedino_torch.core import maximum


class CompositeOut(NamedTuple):
    weights: torch.Tensor  # (..., K)
    alphas: torch.Tensor  # (..., K)
    depth: torch.Tensor  # (...)


def deltas_from_z(z_samp: torch.Tensor, inf_delta: float = 1e10) -> torch.Tensor:
    """Sample spacing with an 'infinite' last bin. (..., K) -> (..., K)."""
    d = z_samp[..., 1:] - z_samp[..., :-1]
    return torch.cat([d, torch.full_like(d[..., :1], inf_delta)], -1)


def alpha_composite(sigmas: torch.Tensor, deltas: torch.Tensor, hard_alpha_cap: bool = True):
    """Density -> (weights, alphas), both (..., K) fp32.

    The floor is max(1 - a, 1e-10), not 1 - a + 1e-10: the second form
    loses its epsilon in fp32 and saturated alphas then give exact zeros.
    Both maxima split the gradient at a tie as `jnp.maximum` does: at
    sigma = 0 (a softplus that underflowed) sigma gets half of it.
    """
    sigmas = sigmas.float()
    deltas = deltas.float()
    alphas = 1.0 - torch.exp(-torch.abs(deltas) * maximum(sigmas, 0.0))
    if hard_alpha_cap:
        alphas = torch.cat([alphas[..., :-1], torch.ones_like(alphas[..., -1:])], -1)
    shifted = torch.cat(
        [torch.ones_like(alphas[..., :1]), maximum(1.0 - alphas[..., :-1], 1e-10)], -1
    )
    T = torch.cumprod(shifted, -1)
    return alphas * T, alphas


def weight_median_depth(weights: torch.Tensor, z_samp: torch.Tensor, q: float = 0.5) -> torch.Tensor:
    """z at the first sample whose normalized weight CDF reaches q.

    The index counts the samples with CDF < q, so a CDF exactly equal to q
    picks that sample (the reference's tie rule).
    """
    w = weights.float()
    cdf = torch.cumsum(w, -1) / maximum(w.sum(-1, keepdim=True), 1e-10)
    idx = torch.sum(cdf < q, -1).clamp(0, z_samp.shape[-1] - 1)
    return torch.gather(z_samp.float(), -1, idx[..., None])[..., 0]


def composite_rays(sigmas: torch.Tensor, z_samp: torch.Tensor, hard_alpha_cap: bool = True,
                   depth_statistic: str = "expectation") -> CompositeOut:
    """Density + depths -> weights, alphas and depth (E[z] or the weight
    median)."""
    weights, alphas = alpha_composite(sigmas, deltas_from_z(z_samp), hard_alpha_cap)
    if depth_statistic == "median":
        depth = weight_median_depth(weights, z_samp)
    elif depth_statistic == "expectation":
        depth = torch.sum(weights * z_samp.float(), -1)
    else:
        raise ValueError(
            f"depth_statistic must be 'expectation' or 'median', got {depth_statistic!r}"
        )
    return CompositeOut(weights, alphas, depth)


def weighted_reduce(weights: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """sum_k w_k * v_k: (..., K) x (..., K, C) -> (..., C) fp32."""
    return torch.sum(weights[..., None] * values.float(), -2)


def neus_reweight(weights: torch.Tensor, surface_sigmoid_scale: float) -> torch.Tensor:
    """NeuS-style surface re-weighting (reference compositing.py:108): a
    gaussian over sample indices around the weights' mean index, normalized."""
    K = weights.shape[-1]
    indices = torch.arange(K, device=weights.device, dtype=weights.dtype)
    surface_index = torch.sum(weights * indices, -1, keepdim=True)
    w = torch.exp(-0.5 * ((surface_index - indices) * surface_sigmoid_scale) ** 2)
    return w / torch.sum(w, -1, keepdim=True)
