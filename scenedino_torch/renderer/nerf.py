"""Volume renderer of the training step and the validation render
(counterpart of `scenedino_tpu/renderer/nerf.py:29-262`).

`render_rays` samples `n_coarse` stratified depths per ray (or, with
`sample_from_dist`, depths resampled from a proposal histogram), queries
the field at every sample, and composites weights, depth, colour and DINO
features in fp32. With `n_fine > 0` it adds a fine pass: `n_fine -
n_fine_depth` importance samples from the coarse weights and
`n_fine_depth` gaussian samples around the coarse depth, sorted together
with the coarse depths and rendered again. The render modes: "volumetric";
"surface", which queries density only (no colour); "neus", which reduces
the colour with NeuS-reweighted weights (the DINO feature keeps the
plain ones). Under `training`, `noise_std` adds gaussian noise to the
densities; `white_bkgd` composites the colour over white.
`render_rays_chunked` renders full frames a chunk of rays at a time. Every
draw is an explicit input: `u` (and `t`) for the strata, `noise` for the
coarse pass's density noise, `FineDraws` for the fine pass.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

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
    render_mode: str = "volumetric"  # volumetric | surface | neus
    surface_sigmoid_scale: float = 1.0
    depth_statistic: str = "expectation"

    @property
    def using_fine(self) -> bool:
        return self.n_fine > 0


@dataclasses.dataclass
class FineDraws:
    """The fine pass's draws over the B*R flat rays: `u` and `t` (R', n_fine -
    n_fine_depth) in [0, 1) pick the coarse stratum and the place inside it
    (`sampling.sample_fine`); `noise` (R', n_fine_depth) ~ N(0, 1) places the
    depth samples (`sampling.sample_fine_depth`); `sigma_noise` (R', n_coarse
    + n_fine) ~ N(0, 1) is the fine pass's density noise under training. A
    part the config does not use is None."""

    u: Optional[torch.Tensor] = None
    t: Optional[torch.Tensor] = None
    noise: Optional[torch.Tensor] = None
    sigma_noise: Optional[torch.Tensor] = None

    @staticmethod
    def draw(generator: torch.Generator, n_rays: int, cfg: RenderConfig,
             training: bool = False) -> Optional["FineDraws"]:
        """The draws `cfg` needs for `n_rays` flat rays, from `generator` (u,
        t, noise, then sigma_noise under training with `noise_std > 0`) on its
        device; None without a fine pass."""
        if not cfg.using_fine:
            return None
        dev, n_imp = generator.device, cfg.n_fine - cfg.n_fine_depth
        out = FineDraws()
        if n_imp > 0:
            out.u = torch.rand(n_rays, n_imp, generator=generator, device=dev)
            out.t = torch.rand(n_rays, n_imp, generator=generator, device=dev)
        if cfg.n_fine_depth > 0:
            out.noise = torch.randn(n_rays, cfg.n_fine_depth, generator=generator, device=dev)
        if training and cfg.noise_std > 0.0:
            out.sigma_noise = torch.randn(n_rays, cfg.n_coarse + cfg.n_fine, generator=generator, device=dev)
        return out

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "FineDraws":
        """`fn` applied to every draw that is present."""
        return FineDraws(*(None if x is None else fn(x) for x in (self.u, self.t, self.noise, self.sigma_noise)))


@dataclasses.dataclass
class RenderDraws:
    """All draws of one `render_rays` call over R' flat rays: the strata `u`
    (R', n_coarse), the fine pass's, and the coarse pass's density noise."""

    u: torch.Tensor
    fine: Optional[FineDraws] = None
    noise: Optional[torch.Tensor] = None

    @staticmethod
    def draw(generator: torch.Generator, n_rays: int, cfg: RenderConfig, training: bool = False) -> "RenderDraws":
        """u, then the fine pass's draws, then the coarse noise, from `generator`."""
        u = torch.rand(n_rays, cfg.n_coarse, generator=generator, device=generator.device)
        fine = FineDraws.draw(generator, n_rays, cfg, training)
        return RenderDraws(u, fine, draw_sigma_noise(generator, n_rays, cfg, training))

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "RenderDraws":
        """`fn` applied to every draw that is present."""
        return RenderDraws(fn(self.u), None if self.fine is None else self.fine.map(fn),
                           None if self.noise is None else fn(self.noise))


def draw_sigma_noise(generator: torch.Generator, n_rays: int, cfg: RenderConfig,
                     training: bool = False) -> Optional[torch.Tensor]:
    """The coarse pass's density noise (n_rays, n_coarse) ~ N(0, 1) from
    `generator`, or None where the render adds none (not training, or
    `noise_std` 0)."""
    if not (training and cfg.noise_std > 0.0):
        return None
    return torch.randn(n_rays, cfg.n_coarse, generator=generator, device=generator.device)


# (xyz (B, P, 3), only_density) -> (rgb (B, P, VC) or None, invalid (B, P, V), sigma (B, P), dino (B, P, D) or None)
FieldFn = Callable[..., tuple]


def render_rays(field_fn: FieldFn, rays: torch.Tensor, u: torch.Tensor, cfg: RenderConfig,
                want_weights: bool = False, want_alphas: bool = False, want_z_samps: bool = False,
                want_rgb_samps: bool = False, fine: Optional[FineDraws] = None,
                noise: Optional[torch.Tensor] = None, training: bool = False,
                sample_from_dist: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                t: Optional[torch.Tensor] = None) -> Dict:
    """rays (B, R, >=8); u (B*R, n_coarse) stratum draws in [0, 1); `fine`
    the fine pass's draws, needed when `cfg.n_fine > 0`; `noise` (B*R,
    n_coarse) ~ N(0, 1), the coarse pass's density noise, needed under
    `training` with `cfg.noise_std > 0` (the fine pass's is
    `fine.sigma_noise`). `sample_from_dist` = (weights, z) of a proposal
    histogram, (B, R, n) or (B*R, n): the coarse depths are resampled from
    it (`sampling.sample_coarse_from_dist`, sorted), u picking the bin and
    `t` (B*R, n_coarse) the place inside it. Returns {"coarse": {...}} (and
    "fine" with a fine pass) with per-ray outputs shaped (B, R, ...)."""
    if cfg.render_mode not in ("volumetric", "surface", "neus"):
        raise ValueError(f"render_mode must be volumetric, surface or neus, got {cfg.render_mode!r}")
    if cfg.using_fine and fine is None:
        raise ValueError(f"n_fine = {cfg.n_fine} needs the fine pass's draws (`fine`)")
    noisy = training and cfg.noise_std > 0.0
    if noisy and (noise is None or (cfg.using_fine and fine.sigma_noise is None)):
        raise ValueError(f"noise_std = {cfg.noise_std} under training needs the density noise of every pass")
    B, R, r_dim = rays.shape
    flat = rays.reshape(B * R, r_dim)
    if sample_from_dist is None:
        z_coarse = sampling.sample_coarse(flat, cfg.n_coarse, cfg.lindisp, u=u)
    else:
        prop_w, prop_z = (x.reshape(B * R, x.shape[-1]) for x in sample_from_dist)
        z_coarse = sampling.sample_coarse_from_dist(flat, prop_w, prop_z, cfg.n_coarse, cfg.lindisp, u=u, t=t)
        z_coarse = torch.sort(z_coarse, -1).values
    coarse = _composite(field_fn, flat, z_coarse, cfg, B, noise if noisy else None)
    out = {"coarse": _format(coarse, B, want_weights, want_alphas, want_z_samps, want_rgb_samps)}
    if cfg.using_fine:
        samps = [z_coarse]
        if cfg.n_fine - cfg.n_fine_depth > 0:
            samps.append(sampling.sample_fine(flat, coarse["weights"], cfg.n_fine - cfg.n_fine_depth,
                                              cfg.n_coarse, cfg.lindisp, u=fine.u, t=fine.t))
        if cfg.n_fine_depth > 0:
            samps.append(sampling.sample_fine_depth(flat, coarse["depth"], cfg.n_fine_depth, cfg.depth_std,
                                                    noise=fine.noise))
        z_all = torch.sort(torch.cat(samps, -1), -1).values
        out["fine"] = _format(_composite(field_fn, flat, z_all, cfg, B, fine.sigma_noise if noisy else None), B,
                              want_weights, want_alphas, want_z_samps, want_rgb_samps)
    return out


def render_rays_chunked(field_fn: FieldFn, rays: torch.Tensor, u: torch.Tensor, cfg: RenderConfig,
                        chunk: int = 16384, fine: Optional[FineDraws] = None, noise: Optional[torch.Tensor] = None,
                        sample_from_dist: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                        t: Optional[torch.Tensor] = None, **kwargs) -> Dict:
    """`render_rays` over chunks of at most `chunk` rays of each item
    (reference nerf.py:117-172, a Python loop here): the peak live set is
    one chunk's samples; the outputs are concatenated along the ray axis
    and equal `render_rays` on the same draws."""
    B, R = rays.shape[:2]
    if R <= chunk:
        return render_rays(field_fn, rays, u, cfg, fine=fine, noise=noise, sample_from_dist=sample_from_dist, t=t,
                           **kwargs)

    def rows(x: Optional[torch.Tensor], s: slice) -> Optional[torch.Tensor]:  # the draws of rays s of every item
        return None if x is None else x.reshape(B, R, -1)[:, s].reshape(-1, x.shape[-1])

    parts = []
    for start in range(0, R, chunk):
        s = slice(start, start + chunk)
        sfd = None if sample_from_dist is None else tuple(rows(x, s) for x in sample_from_dist)
        parts.append(render_rays(field_fn, rays[:, s], rows(u, s), cfg,
                                 fine=None if fine is None else fine.map(lambda x: rows(x, s)), noise=rows(noise, s),
                                 sample_from_dist=sfd, t=rows(t, s), **kwargs))
    return {level: {k: None if parts[0][level][k] is None else torch.cat([p[level][k] for p in parts], 1)
                    for k in parts[0][level]}
            for level in parts[0]}


def _composite(field_fn: FieldFn, rays: torch.Tensor, z_samp: torch.Tensor, cfg: RenderConfig, sb: int,
               noise: Optional[torch.Tensor] = None) -> Dict:
    """One compositing pass over (B*R, K) samples (nerf.py:175-233);
    `noise` (B*R, K) ~ N(0, 1) scaled by `noise_std` is added to the densities."""
    BR, K = z_samp.shape
    points = rays[:, None, :3] + z_samp[..., None] * rays[:, None, 3:6]  # (BR, K, 3)
    rgb, invalid, sigma, dino = field_fn(points.reshape(sb, -1, 3), only_density=cfg.render_mode == "surface")
    sigma = sigma.reshape(BR, K).float()
    invalid = invalid.reshape(BR, K, -1)
    rgb = None if rgb is None else rgb.reshape(BR, K, -1)
    dino = None if dino is None else dino.reshape(BR, K, -1)
    if noise is not None:
        sigma = sigma + noise.to(sigma.dtype) * cfg.noise_std
    comp = compositing.composite_rays(sigma, z_samp, cfg.hard_alpha_cap, depth_statistic=cfg.depth_statistic)
    weights = comp.weights
    dino_final = None if dino is None else compositing.weighted_reduce(weights, dino)
    if cfg.render_mode == "neus":  # after the DINO reduce, before the colour's (nerf.py:207-212)
        weights = compositing.neus_reweight(weights, cfg.surface_sigmoid_scale)
    rgb_final = None if rgb is None else compositing.weighted_reduce(weights, rgb)
    if cfg.white_bkgd and rgb_final is not None:
        rgb_final = rgb_final + 1.0 - weights.sum(-1, keepdim=True)
    return {
        "weights": weights,
        "rgb": rgb_final,
        "depth": comp.depth,
        "alphas": comp.alphas,
        "invalid": invalid.float(),
        "z_samps": z_samp,
        "rgb_samps": rgb,
        "dino_features": dino_final,
    }


def _format(c: Dict, sb: int, want_weights: bool, want_alphas: bool, want_z_samps: bool,
            want_rgb_samps: bool) -> Dict:
    """Flat-ray outputs -> (SB, R, ...) (nerf.py:236-262); a missing
    output (colour in the surface mode) stays None."""
    K = c["weights"].shape[-1]

    def r(x, *trail):
        return x.reshape(sb, -1, *trail)

    def r_last(x):
        return None if x is None else r(x, x.shape[-1])

    out = {
        "rgb": r_last(c["rgb"]),
        "depth": c["depth"].reshape(sb, -1),
        "invalid": r(c["invalid"], K, c["invalid"].shape[-1]),
        "dino_features": r_last(c["dino_features"]),
    }
    if want_weights:
        out["weights"] = r(c["weights"], K)
    if want_alphas:
        out["alphas"] = r(c["alphas"], K)
    if want_z_samps:
        out["z_samps"] = r(c["z_samps"], K)
    if want_rgb_samps and c["rgb_samps"] is not None:
        out["rgb_samps"] = r(c["rgb_samps"], K, c["rgb_samps"].shape[-1])
    return out
