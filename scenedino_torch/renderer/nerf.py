"""Volume renderer of the training step and the validation render
(counterpart of `scenedino_tpu/renderer/nerf.py:29-262`).

`render_rays` samples `n_coarse` stratified depths per ray, queries the
field at every sample, and composites weights, depth, colour and DINO
features in fp32. With `n_fine > 0` it adds a fine pass: `n_fine -
n_fine_depth` importance samples from the coarse weights and
`n_fine_depth` gaussian samples around the coarse depth, sorted together
with the coarse depths and rendered again. `render_rays_chunked` renders
full frames a chunk of rays at a time. Every draw is an explicit input:
`u` for the strata, `FineDraws` for the fine pass.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

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

    @property
    def using_fine(self) -> bool:
        return self.n_fine > 0


@dataclasses.dataclass
class FineDraws:
    """The fine pass's draws over the B*R flat rays: `u` and `t` (R', n_fine -
    n_fine_depth) in [0, 1) pick the coarse stratum and the place inside it
    (`sampling.sample_fine`); `noise` (R', n_fine_depth) ~ N(0, 1) places the
    depth samples (`sampling.sample_fine_depth`). A part the config does
    not use is None."""

    u: Optional[torch.Tensor] = None
    t: Optional[torch.Tensor] = None
    noise: Optional[torch.Tensor] = None

    @staticmethod
    def draw(generator: torch.Generator, n_rays: int, cfg: RenderConfig) -> Optional["FineDraws"]:
        """The draws `cfg` needs for `n_rays` flat rays, from `generator` (u,
        t, then noise) on its device; None without a fine pass."""
        if not cfg.using_fine:
            return None
        dev, n_imp = generator.device, cfg.n_fine - cfg.n_fine_depth
        out = FineDraws()
        if n_imp > 0:
            out.u = torch.rand(n_rays, n_imp, generator=generator, device=dev)
            out.t = torch.rand(n_rays, n_imp, generator=generator, device=dev)
        if cfg.n_fine_depth > 0:
            out.noise = torch.randn(n_rays, cfg.n_fine_depth, generator=generator, device=dev)
        return out

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "FineDraws":
        """`fn` applied to every draw that is present."""
        return FineDraws(*(None if x is None else fn(x) for x in (self.u, self.t, self.noise)))


# (xyz (B, P, 3), only_density) -> (rgb (B, P, VC), invalid (B, P, V), sigma (B, P), dino (B, P, D))
FieldFn = Callable[..., tuple]


def render_rays(field_fn: FieldFn, rays: torch.Tensor, u: torch.Tensor, cfg: RenderConfig,
                want_weights: bool = False, want_alphas: bool = False, want_z_samps: bool = False,
                want_rgb_samps: bool = False, fine: Optional[FineDraws] = None) -> Dict:
    """rays (B, R, >=8); u (B*R, n_coarse) stratum draws in [0, 1); `fine`
    the fine pass's draws, needed when `cfg.n_fine > 0`. Returns {"coarse":
    {...}} (and "fine" with a fine pass) with per-ray outputs shaped (B, R, ...)."""
    if cfg.render_mode != "volumetric" or cfg.noise_std > 0.0 or cfg.white_bkgd:
        raise NotImplementedError(
            "the port renders the shipped volumetric mode without sigma noise or a white background"
        )
    if cfg.using_fine and fine is None:
        raise ValueError(f"n_fine = {cfg.n_fine} needs the fine pass's draws (`fine`)")
    B, R, r_dim = rays.shape
    flat = rays.reshape(B * R, r_dim)
    z_coarse = sampling.sample_coarse(flat, cfg.n_coarse, cfg.lindisp, u=u)
    coarse = _composite(field_fn, flat, z_coarse, cfg, B)
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
        out["fine"] = _format(_composite(field_fn, flat, z_all, cfg, B), B, want_weights, want_alphas,
                              want_z_samps, want_rgb_samps)
    return out


def render_rays_chunked(field_fn: FieldFn, rays: torch.Tensor, u: torch.Tensor, cfg: RenderConfig,
                        chunk: int = 16384, fine: Optional[FineDraws] = None, **kwargs) -> Dict:
    """`render_rays` over chunks of at most `chunk` rays of each item
    (reference nerf.py:117-172, a Python loop here): the peak live set is
    one chunk's samples; the outputs are concatenated along the ray axis
    and equal `render_rays` on the same draws."""
    B, R = rays.shape[:2]
    if R <= chunk:
        return render_rays(field_fn, rays, u, cfg, fine=fine, **kwargs)

    def rows(x: torch.Tensor, s: slice) -> torch.Tensor:  # flat (B*R, n) draws of rays s of every item
        return x.reshape(B, R, -1)[:, s].reshape(-1, x.shape[-1])

    parts = []
    for start in range(0, R, chunk):
        s = slice(start, start + chunk)
        parts.append(render_rays(field_fn, rays[:, s], rows(u, s), cfg,
                                 fine=None if fine is None else fine.map(lambda x: rows(x, s)), **kwargs))
    return {level: {k: torch.cat([p[level][k] for p in parts], 1) for k in parts[0][level]}
            for level in parts[0]}


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
