"""Ray samplers (counterpart of `scenedino_tpu/core/ray_sampler.py`):
grid-snapped patches, jittered free patches, uniform random pixels, full
frames, and rays through given points.

Rays are 11 floats: [origin(3), dir(3), near, far, frame_id, x_ndc,
y_ndc] (the point-based sampler's are the first 8). Every pick is an
explicit input of `sample`; each sampler's `draw` draws its picks from a
`torch.Generator` with the reference's ranges.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from scenedino_torch.core import grid_sample, rays as rays_mod


def build_frame_rays(poses_c2w: torch.Tensor, ks: torch.Tensor, z_near: float, z_far: float,
                     height: int, width: int, frame_ids: Optional[torch.Tensor] = None,
                     xy_offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-frame rays with id and xy channels. poses_c2w (V, 4, 4), ks (V, 3, 3)
    normalized; frame_ids (V,) floats, 0..V-1 by default; xy_offset (2,) a
    sub-pixel shift of the unprojected pixel centres. Returns (V, H, W, 11)."""
    V = poses_c2w.shape[0]
    r, xy = rays_mod.rays_from_k(poses_c2w, ks, width, height, z_near, z_far, xy_offset=xy_offset)
    if frame_ids is None:
        frame_ids = torch.arange(V, device=r.device, dtype=r.dtype)
    ids = frame_ids.to(r.dtype)[:, None, None, None].expand(V, height, width, 1)
    return torch.cat([r, ids, xy], -1)


@dataclasses.dataclass(frozen=True)
class PatchRaySampler:
    """Patches of patch_size^2 rays aligned to the DINO teacher grid; each
    patch carries one teacher feature vector, or with `dino_upscaled` (a
    per-pixel teacher, upsample-gt mode) each ray its pixel's."""

    z_near: float
    z_far: float
    ray_batch_size: int = 2048
    patch_size: int = 8
    dino_upscaled: bool = False
    snap_to_grid: bool = True

    @property
    def patch_count(self) -> int:
        return self.ray_batch_size // (self.patch_size * self.patch_size)

    def draw(self, B: int, V: int, H: int, W: int, shifted: bool, generator: torch.Generator,
             device=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(pv, py, px), each (B, PC) int64: view in [0, V), patch row in
        [0, H/P - s), column in [0, W/P - s), s = 1 under a grid shift."""
        P, PC, s = self.patch_size, self.patch_count, int(shifted)

        def randint(high):
            return torch.randint(0, high, (B, PC), generator=generator, device=device)

        return randint(V), randint(H // P - s), randint(W // P - s)

    def sample(self, images: torch.Tensor, poses_c2w: torch.Tensor, ks: torch.Tensor,
               pv: torch.Tensor, py: torch.Tensor, px: torch.Tensor,
               frame_ids: Optional[torch.Tensor] = None,
               dino_features: Optional[torch.Tensor] = None,
               grid_shift: Optional[torch.Tensor] = None):
        """images (B, V, C, H, W); poses_c2w (B, V, 4, 4); ks (B, V, 3, 3);
        pv, py, px (B, PC); dino_features (B, V, Cd, Gh, Gw); grid_shift (2,)
        ints in [-P/2, P/2). Returns (rays (B, R, 11), rgb_gt (B, R, C),
        dino_gt (B, PC, Cd), or (B, R, Cd) with `dino_upscaled`, or None)."""
        B, V, C, H, W = images.shape
        P = self.patch_size
        if not self.snap_to_grid:
            raise NotImplementedError("only grid-snapped patches are supported, as in the reference")
        if grid_shift is not None:
            sy, sx = (int(s) for s in grid_shift)
            y0, x0 = sy % P + P * py, sx % P + P * px
            patch_y, patch_x = py + int(sy < 0), px + int(sx < 0)
        else:
            y0, x0 = P * py, P * px
            patch_y, patch_x = py, px
        yy, xx = _patch_pixels(y0, x0, P)
        flat = ((pv[..., None, None] * H + yy) * W + xx).reshape(B, -1)  # (B, R)

        rays, rgb_gt = _take_rays(poses_c2w, ks, self.z_near, self.z_far, H, W, flat, images, frame_ids)
        if dino_features is None:
            return rays, rgb_gt, None
        _, Vd, Cd, Gh, Gw = dino_features.shape
        if self.dino_upscaled:
            # the ray's own pixel, sliced like the rgb (ray_sampler.py:122-131);
            # under a grid shift the teacher saw the shifted image and is still
            # read at the shifted pixel, as the reference reads it
            if (Gh, Gw) != (H, W):
                raise ValueError(f"an upscaled teacher map must be {(H, W)}, got {(Gh, Gw)}")
            rows = torch.arange(B, device=flat.device)[:, None]
            return rays, rgb_gt, dino_features.reshape(B, Vd, Cd, H * W)[rows, flat // (H * W), :, flat % (H * W)]
        if (Gh, Gw) != (H // P, W // P):
            # JAX's gather fills NaN there and its downsampler then fails to broadcast (ROADMAP queue 3)
            raise ValueError(f"the teacher's grid is {Gh}x{Gw}, but {P}-pixel patches of a {H}x{W} image make a "
                             f"{H // P}x{W // P} grid: the ray sampler's patch_size must be the teacher's patch size "
                             f"({H // Gh})")
        dflat = dino_features.permute(0, 1, 3, 4, 2).reshape(B, Vd * Gh * Gw, Cd)
        didx = (pv * Gh + patch_y) * Gw + patch_x
        dino_gt = torch.gather(dflat, 1, didx[..., None].expand(B, didx.shape[1], Cd))
        return rays, rgb_gt, dino_gt

    def reconstruct(self, flat: torch.Tensor) -> torch.Tensor:
        """(B, R, ...) -> (B, PC, P, P, ...)."""
        return flat.reshape(flat.shape[0], self.patch_count, self.patch_size, self.patch_size,
                            *flat.shape[2:])


def _patch_pixels(py: torch.Tensor, px: torch.Tensor, P: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel rows and columns (B, PC, P, P) of patches whose corner is (py, px)."""
    o = torch.arange(P, device=py.device)
    return py[..., None, None] + o[:, None], px[..., None, None] + o[None, :]


def _take_rays(poses_c2w, ks, z_near, z_far, H, W, flat, images=None, frame_ids=None, xy_offset=None):
    """Per item b, the rays of flat pixel indices flat[b] into its (V*H*W)
    full-frame rays, and the images' values there: (B, R, 11), (B, R, C)."""
    rays, rgb = [], []
    for b in range(flat.shape[0]):
        fr = build_frame_rays(poses_c2w[b], ks[b], z_near, z_far, H, W, frame_ids, xy_offset)
        rays.append(fr.reshape(-1, fr.shape[-1])[flat[b]])
        if images is not None:
            rgb.append(images[b].permute(0, 2, 3, 1).reshape(-1, images.shape[2])[flat[b]])
    return torch.stack(rays), (torch.stack(rgb) if images is not None else None)


@dataclasses.dataclass(frozen=True)
class JitteredPatchRaySampler(PatchRaySampler):
    """Free-floating patches (not grid-snapped) whose rays are shifted by one
    sub-pixel offset per call; the colour ground truth is sampled
    bilinearly at the shifted pixels (ray_sampler.py:147-203). No teacher
    vector per patch, as in the reference."""

    jitter_scale: float = 1.0

    def draw(self, B: int, V: int, H: int, W: int, generator: torch.Generator, device=None):
        """(xy_offset (2,) in [-j/2, j/2) pixels, then pv, py, px (B, PC)
        int64: view, the patch's top row in [0, H - P) and left column in [0, W - P))."""
        P, PC = self.patch_size, self.patch_count
        xy_offset = (torch.rand(2, generator=generator, device=device) - 0.5) * self.jitter_scale

        def randint(high):
            return torch.randint(0, high, (B, PC), generator=generator, device=device)

        return xy_offset, randint(V), randint(H - P), randint(W - P)

    def sample(self, images: torch.Tensor, poses_c2w: torch.Tensor, ks: torch.Tensor, xy_offset: torch.Tensor,
               pv: torch.Tensor, py: torch.Tensor, px: torch.Tensor, frame_ids: Optional[torch.Tensor] = None):
        """images (B, V, C, H, W) -> (rays (B, R, 11), rgb_gt (B, R, C), None)."""
        B, V, C, H, W = images.shape
        P = self.patch_size
        yy, xx = _patch_pixels(py, px, P)
        flat = ((pv[..., None, None] * H + yy) * W + xx).reshape(B, -1)
        rays, _ = _take_rays(poses_c2w, ks, self.z_near, self.z_far, H, W, flat, frame_ids=frame_ids,
                             xy_offset=xy_offset)
        off = xy_offset.to(images.dtype)
        gx, gy = torch.broadcast_tensors((xx + off[0] + 0.5) / W * 2 - 1, (yy + off[1] + 0.5) / H * 2 - 1)
        gxy = torch.stack([gx, gy], -1).reshape(B, -1, 2)
        per_view = grid_sample.grid_sample_views(images, gxy[:, None].expand(B, V, *gxy.shape[1:]))  # (B, V, R, C)
        view = pv.repeat_interleave(P * P, 1)  # (B, R)
        rgb = torch.gather(per_view, 1, view[:, None, :, None].expand(B, 1, view.shape[1], C))[:, 0]
        return rays, rgb, None


@dataclasses.dataclass(frozen=True)
class RandomRaySampler:
    """Uniform random pixels of the given views (ray_sampler.py:206-223)."""

    z_near: float
    z_far: float
    ray_batch_size: int = 4096

    def draw(self, B: int, V: int, H: int, W: int, generator: torch.Generator, device=None) -> torch.Tensor:
        """(B, ray_batch_size) int64 flat pixel indices in [0, V*H*W)."""
        return torch.randint(0, V * H * W, (B, self.ray_batch_size), generator=generator, device=device)

    def sample(self, images: torch.Tensor, poses_c2w: torch.Tensor, ks: torch.Tensor, idx: torch.Tensor,
               frame_ids: Optional[torch.Tensor] = None):
        """images (B, V, C, H, W); idx (B, R) from `draw` -> (rays (B, R, 11), rgb (B, R, C), None)."""
        H, W = images.shape[-2:]
        rays, rgb = _take_rays(poses_c2w, ks, self.z_near, self.z_far, H, W, idx, images, frame_ids)
        return rays, rgb, None


@dataclasses.dataclass(frozen=True)
class ImageRaySampler:
    """All rays of full frames (the validation render's sampler)."""

    z_near: float
    z_far: float
    height: int
    width: int

    def sample(self, poses_c2w: torch.Tensor, ks: torch.Tensor) -> torch.Tensor:
        """poses_c2w (B, V, 4, 4), ks (B, V, 3, 3) -> rays (B, V*H*W, 11),
        frame ids 0..V-1."""
        return torch.stack([
            build_frame_rays(p, k, self.z_near, self.z_far, self.height, self.width).reshape(-1, 11)
            for p, k in zip(poses_c2w, ks)
        ])

    def reconstruct(self, flat: torch.Tensor, n_views: int = 1) -> torch.Tensor:
        """(B, V*H*W, ...) -> (B*V, H, W, ...)."""
        return flat.reshape(flat.shape[0] * n_views, self.height, self.width, *flat.shape[2:])


@dataclasses.dataclass(frozen=True)
class PointBasedRaySampler:
    """Rays from a camera's origin through given world points
    (ray_sampler.py:258-274), the consistency branch's."""

    z_near: float
    z_far: float

    def sample(self, points: torch.Tensor, cam_pose_c2w: torch.Tensor) -> torch.Tensor:
        """points (B, P, 3); cam_pose_c2w (B, 4, 4) -> rays (B, P, 8)."""
        origin = cam_pose_c2w[:, None, :3, 3]
        d = points - origin
        d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-8)
        near = torch.full_like(d[..., :1], self.z_near)
        far = torch.full_like(d[..., :1], self.z_far)
        return torch.cat([origin.expand(d.shape), d, near, far], -1)


def get_ray_sampler(conf: dict):
    """A sampler from a `ray_sampler` config block (ray_sampler.py:277-295):
    `sample_mode` patch (the default), random or image."""
    mode = conf.get("sample_mode", "patch")
    args = dict(conf.get("args", {}) or {})
    zn, zf = conf.get("z_near", 3.0), conf.get("z_far", 80.0)
    if mode == "patch":
        return PatchRaySampler(zn, zf, ray_batch_size=args.get("ray_batch_size", 2048),
                               patch_size=args.get("patch_size", 8), dino_upscaled=args.get("dino_upscaled", False),
                               snap_to_grid=args.get("snap_to_grid", True))
    if mode == "random":
        return RandomRaySampler(zn, zf, ray_batch_size=args.get("ray_batch_size", 4096))
    if mode == "image":
        return ImageRaySampler(zn, zf, height=args.get("height"), width=args.get("width"))
    raise ValueError(mode)
