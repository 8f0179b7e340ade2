"""Volume renderer of the training step (counterpart of
`scenedino_tpu/renderer/nerf.py:29-262`), coarse pass.

`render_rays` samples `n_coarse` stratified depths per ray, queries the
field at every sample, and composites weights, depth, colour and DINO
features in fp32. The stratum draws `u` are an explicit input. Fine
sampling (`n_fine > 0`) is not ported; every shipped config has
`n_fine: 0`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from scenedino_torch.core import compositing, sampling


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """configs/renderer/pixelnerf.yaml + train_scenedino_kitti_360.yaml."""

    n_coarse: int = 32
    n_fine: int = 0
    n_fine_depth: int = 0
    depth_std: float = 1.0
    noise_std: float = 0.0
    white_bkgd: bool = False
    lindisp: bool = True
    hard_alpha_cap: bool = True
    render_mode: str = "volumetric"
    depth_statistic: str = "expectation"


# (xyz (B, P, 3), only_density) -> (rgb (B, P, VC), invalid (B, P, V), sigma (B, P), dino (B, P, D))
FieldFn = Callable[..., tuple]


def render_rays(field_fn: FieldFn, rays: torch.Tensor, u: torch.Tensor, cfg: RenderConfig,
                want_weights: bool = False, want_alphas: bool = False, want_z_samps: bool = False,
                want_rgb_samps: bool = False) -> Dict:
    """rays (B, R, >=8); u (B*R, n_coarse) stratum draws in [0, 1).
    Returns {"coarse": {...}} with per-ray outputs shaped (B, R, ...)."""
    if cfg.n_fine > 0 or cfg.n_fine_depth > 0:
        raise NotImplementedError("fine sampling is not ported; the shipped configs use n_fine: 0")
    if cfg.render_mode != "volumetric" or cfg.noise_std > 0.0 or cfg.white_bkgd:
        raise NotImplementedError(
            "the port renders the shipped volumetric mode without sigma noise or a white background"
        )
    B, R, r_dim = rays.shape
    flat = rays.reshape(B * R, r_dim)
    z = sampling.sample_coarse(flat, cfg.n_coarse, cfg.lindisp, u=u)
    return {"coarse": _format(_composite(field_fn, flat, z, cfg, B), B, want_weights, want_alphas,
                              want_z_samps, want_rgb_samps)}


def _composite(field_fn: FieldFn, rays: torch.Tensor, z_samp: torch.Tensor, cfg: RenderConfig, sb: int) -> Dict:
    """One compositing pass over (B*R, K) samples (nerf.py:175-233)."""
    BR, K = z_samp.shape
    points = rays[:, None, :3] + z_samp[..., None] * rays[:, None, 3:6]  # (BR, K, 3)
    rgb, invalid, sigma, dino = field_fn(points.reshape(sb, -1, 3), only_density=False)
    sigma = sigma.reshape(BR, K).float()
    invalid = invalid.reshape(BR, K, -1)
    rgb = rgb.reshape(BR, K, -1)
    dino = dino.reshape(BR, K, -1)
    comp = compositing.composite_rays(sigma, z_samp, cfg.hard_alpha_cap, depth_statistic=cfg.depth_statistic)
    return {
        "weights": comp.weights,
        "rgb": compositing.weighted_reduce(comp.weights, rgb),
        "depth": comp.depth,
        "alphas": comp.alphas,
        "invalid": invalid.float(),
        "z_samps": z_samp,
        "rgb_samps": rgb,
        "dino_features": compositing.weighted_reduce(comp.weights, dino),
    }


def _format(c: Dict, sb: int, want_weights: bool, want_alphas: bool, want_z_samps: bool,
            want_rgb_samps: bool) -> Dict:
    """Flat-ray outputs -> (SB, R, ...) (nerf.py:236-262)."""
    K = c["weights"].shape[-1]

    def r(x, *trail):
        return x.reshape(sb, -1, *trail)

    out = {
        "rgb": r(c["rgb"], c["rgb"].shape[-1]),
        "depth": c["depth"].reshape(sb, -1),
        "invalid": r(c["invalid"], K, c["invalid"].shape[-1]),
        "dino_features": r(c["dino_features"], c["dino_features"].shape[-1]),
    }
    if want_weights:
        out["weights"] = r(c["weights"], K)
    if want_alphas:
        out["alphas"] = r(c["alphas"], K)
    if want_z_samps:
        out["z_samps"] = r(c["z_samps"], K)
    if want_rgb_samps:
        out["rgb_samps"] = r(c["rgb_samps"], K, c["rgb_samps"].shape[-1])
    return out
