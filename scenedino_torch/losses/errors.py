"""Regularizers of the reference's research configs (counterpart of
`scenedino_tpu/losses/errors.py`): the entropy helpers, the alpha,
surfaceness, weight-entropy, density-grid, consistency and flow terms.

No shipped config reaches them; they are library functions. Masks are
applied by multiplication, `lax.stop_gradient` is `detach`, and where the
reference takes `torch.median` the lower of the two middle values is kept.
The small-probability threshold is 2^-8.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from scenedino_torch.core import absolute, clip, maximum

EPS = 2.0 ** (-8)


def _where0(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x where not mask, 0 where mask (no gradient through the masked entries)."""
    return torch.where(mask, torch.zeros_like(x), x)


# ------------------------------------------------------- entropy helpers
def normalized_entropy(p: torch.Tensor, dim: int = -1, eps: float = EPS) -> torch.Tensor:
    """Entropy of `p` along `dim`, normalized to [0, 1]."""
    h_max = math.log2(p.shape[dim])
    small = p < eps
    plp = _where0(small, torch.log2(torch.where(small, torch.ones_like(p), p)) * p)
    return -torch.sum(plp, dim) / h_max


def kl_div(p: torch.Tensor, q: torch.Tensor, dim: int = -1, eps: float = EPS) -> torch.Tensor:
    """KL(p || q) over the entries where both are at least `eps`, each
    renormalized over them (the normalizers detached)."""
    small = (p < eps) | (q < eps)
    p0, q0 = _where0(small, p), _where0(small, q)
    p1 = p0 / torch.clamp(torch.sum(p0, dim, keepdim=True).detach(), min=1e-12)
    q1 = q0 / torch.clamp(torch.sum(q0, dim, keepdim=True).detach(), min=1e-12)
    one = torch.ones_like(p1)
    els = p1 * (torch.log(torch.where(small, one, p1)) - torch.log(torch.where(small, one, q1)))
    return torch.sum(_where0(small, els), dim)


def _lower_median(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """The lower of the two middle values on an even count, as `torch.median`
    (which this is) and the reference's sort-and-take give."""
    return torch.median(x, dim, keepdim=keepdim).values


# ----------------------------------------------------------- error terms
def compute_normalized_l1(flow0: torch.Tensor, flow1: torch.Tensor) -> torch.Tensor:
    """L1 normalized by the detached flow magnitude (over dim 1)."""
    norm = torch.linalg.vector_norm(flow0.detach(), dim=1, keepdim=True)
    return absolute(flow0 - flow1) / (norm + 1e-4)


def compute_3d_smoothness(feature_sample: torch.Tensor, sigma_sample: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Variance of surface feature samples over the sample axis (dim 2)."""
    return torch.var(feature_sample, 2, correction=0)


def compute_occupancy_error(teacher_field: torch.Tensor, student_field: torch.Tensor,
                            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Teacher/student density MSE, over the masked entries with a mask."""
    err = (teacher_field - student_field) ** 2
    if mask is None:
        return err.mean()
    m = mask.to(err.dtype)
    return torch.sum(err * m) / torch.clamp(torch.sum(m), min=1.0)


def depth_regularization(depth: torch.Tensor) -> torch.Tensor:
    """Squared depth-gradient penalty of (B, 1, h, w)."""
    gx = depth[:, :, 1:, :] - depth[:, :, :-1, :]
    gy = depth[:, :, :, 1:] - depth[:, :, :, :-1]
    return (gx ** 2).mean() + (gy ** 2).mean()


def alpha_regularization(alphas: torch.Tensor, invalids: Optional[torch.Tensor] = None,
                         fraction: float = 1.0 / 8.0) -> torch.Tensor:
    """A ray's alpha mass (all samples but the last) above n_samples x fraction."""
    n = alphas.shape[-1]
    alpha_sum = torch.sum(alphas[..., :-1], -1)
    min_cap = torch.full_like(alpha_sum, n * fraction)
    if invalids is not None:
        valid = 1.0 - invalids.squeeze(-1).float()
        alpha_sum = alpha_sum * valid
        min_cap = min_cap * valid
    return maximum(alpha_sum - min_cap, 0.0)


def surfaceness_regularization(alphas: torch.Tensor, invalids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Push per-sample alphas toward {0, 1}."""
    p = -torch.log(torch.exp(-absolute(alphas)) + torch.exp(-absolute(1.0 - alphas)))
    p = p.mean(-1)
    if invalids is not None:
        p = p * (1.0 - invalids.squeeze(-1).float())
    return p.mean()


def depth_smoothness_regularization(depths: torch.Tensor) -> torch.Tensor:
    """Squared differences of neighbouring depths (not edge-aware)."""
    return ((depths[..., :-1, :] - depths[..., 1:, :]) ** 2).mean() + \
        ((depths[..., :, :-1] - depths[..., :, 1:]) ** 2).mean()


def sdf_eikonal_regularization(sdf: torch.Tensor) -> torch.Tensor:
    """|grad sdf| = 1 on a (B, 1, D, H, W) grid; returns (B,)."""
    gx = sdf[:, :1, :-1, :-1, 1:] - sdf[:, :1, :-1, :-1, :-1]
    gy = sdf[:, :1, :-1, 1:, :-1] - sdf[:, :1, :-1, :-1, :-1]
    gz = sdf[:, :1, 1:, :-1, :-1] - sdf[:, :1, :-1, :-1, :-1]
    grad = torch.sqrt(torch.sum(torch.cat([gx, gy, gz], 1) ** 2, 1))
    return ((grad - 1.0) ** 2).mean((1, 2, 3))


def weight_entropy_regularization(weights: torch.Tensor, invalids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normalized entropy of ray weights (weights below 2^-16 count 0)."""
    h_max = math.log2(weights.shape[-1])
    small = weights < 2.0 ** (-16)
    wlw = _where0(small, torch.log2(torch.where(small, torch.full_like(weights, 2.0), weights)) * weights)
    return -torch.sum(wlw, -1) / h_max


def max_alpha_regularization(alphas: torch.Tensor, invalids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """1 - a ray's largest alpha (all samples but the last), clipped to [0, 1], averaged."""
    amax = torch.amax(alphas[..., :-1], -1)
    return clip(1.0 - amax, 0.0, 1.0).mean()


def max_alpha_inputframe_regularization(alphas: torch.Tensor, ray_info: torch.Tensor,
                                        invalids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same over the rays of the input frame (ray_info[..., 0] == 0)."""
    mask = (ray_info[..., 0] == 0).to(alphas.dtype)
    amax = torch.amax(alphas, -1)
    return (clip(1.0 - amax, 0.0, 1.0) * mask).mean()


def density_grid_regularization(density_grid: torch.Tensor, threshold: float) -> torch.Tensor:
    """Sparsity penalty above `threshold`, scaled by the detached largest
    excess (at least 1); 0 where it is not finite."""
    g = maximum(absolute(density_grid) - threshold, 0.0)
    max_v = maximum(torch.amax(g), 1.0).detach()
    err = (g / max_v).mean() * max_v
    return torch.nan_to_num(err, nan=0.0, posinf=0.0, neginf=0.0)


def kl_prop(weights: torch.Tensor) -> torch.Tensor:
    """Entropy-guided KL propagation over the patch grid: weights (..., h, w, K)."""
    ent = normalized_entropy(weights.detach())
    c = ent[..., 1:-1, 1:-1]
    w_c = weights[..., 1:-1, 1:-1, :]

    def term(ent_n, w_n):
        return c * maximum(c - ent_n, 0.0) * kl_div(w_n.detach(), w_c)

    out = term(ent[..., 2:, 1:-1], weights[..., 2:, 1:-1, :])
    out = out + term(ent[..., 0:-2, 1:-1], weights[..., 0:-2, 1:-1, :])
    out = out + term(ent[..., 1:-1, 2:], weights[..., 1:-1, 2:, :])
    out = out + term(ent[..., 1:-1, 0:-2], weights[..., 1:-1, :-2, :])
    return out.mean()


def alpha_consistency(alphas: torch.Tensor, invalids: torch.Tensor, consistency_policy: str = "mean") -> torch.Tensor:
    """Per-view alphas (..., V) pulled toward a detached cross-view target
    over the rays valid in every view. The reference maps "min" to the
    maximum as well; so does the port."""
    valid = torch.all(invalids < 0.5, -1).to(alphas.dtype)
    if consistency_policy in ("max", "min"):
        target = torch.amax(alphas, -1, keepdim=True)
    elif consistency_policy == "median":
        target = _lower_median(alphas, -1, keepdim=True)
    elif consistency_policy == "mean":
        target = alphas.mean(-1, keepdim=True)
    else:
        raise NotImplementedError(consistency_policy)
    diff = absolute(alphas - target.detach()).mean(-1)
    return (diff * valid).mean()


def alpha_consistency_uncert(alphas: torch.Tensor, invalids: torch.Tensor, uncert: torch.Tensor) -> torch.Tensor:
    """A predicted uncertainty supervised by the cross-view spread of the
    detached alphas (mean absolute deviation from the lower median,
    Bessel-scaled)."""
    valid = torch.all(invalids < 0.5, -1).to(uncert.dtype)
    alphas = alphas.detach()
    nf = alphas.shape[-1]
    med = _lower_median(alphas, -1, keepdim=True)
    target = absolute(alphas - med).mean(-1) * (nf / (nf - 1))
    return (absolute(uncert - target) * valid).mean()


def entropy_based_smoothness(weights: torch.Tensor, depth: torch.Tensor,
                             invalids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depth propagated from low- to high-entropy neighbours: weights
    (..., h, w, K), depth (..., h, w)."""
    ent = normalized_entropy(weights.detach())
    if invalids is None:
        invalids = torch.zeros_like(depth)

    def err(d0, d1):
        return absolute(d0 - d1.detach())

    up = ent[..., :-1, :] * maximum(ent[..., :-1, :] - ent[..., 1:, :], 0.0) \
        * err(depth[..., :-1, :], depth[..., 1:, :]) * (1.0 - invalids[..., :-1, :])
    down = ent[..., 1:, :] * maximum(ent[..., 1:, :] - ent[..., :-1, :], 0.0) \
        * err(depth[..., 1:, :], depth[..., :-1, :]) * (1.0 - invalids[..., 1:, :])
    left = ent[..., :, :-1] * maximum(ent[..., :, :-1] - ent[..., :, 1:], 0.0) \
        * err(depth[..., :, :-1], depth[..., :, 1:]) * (1.0 - invalids[..., :, :-1])
    right = ent[..., :, 1:] * maximum(ent[..., :, 1:] - ent[..., :, :-1], 0.0) \
        * err(depth[..., :, 1:], depth[..., :, :-1]) * (1.0 - invalids[..., :, 1:])
    return up.mean() + down.mean() + left.mean() + right.mean()


def flow_regularization(flow: torch.Tensor, gt_flow: torch.Tensor, invalids: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """L1 flow supervision of the first sample's flow."""
    reg = absolute(flow[..., 0, :] - gt_flow).mean(-1, keepdim=True)
    if invalids is not None:
        reg = reg * (1.0 - invalids)
    return reg.mean()
