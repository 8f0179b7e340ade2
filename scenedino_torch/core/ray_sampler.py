"""Grid-snapped patch ray sampling and full-frame rays (counterpart of
`scenedino_tpu/core/ray_sampler.py:23-143,228-255`).

Rays are 11 floats: [origin(3), dir(3), near, far, frame_id, x_ndc,
y_ndc]. The patch picks `pv` (view), `py`, `px` (patch row and column on
the teacher grid) are explicit inputs; `PatchRaySampler.draw` draws them
from a `torch.Generator` with the reference's ranges.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from scenedino_torch.core import rays as rays_mod


def build_frame_rays(poses_c2w: torch.Tensor, ks: torch.Tensor, z_near: float, z_far: float,
                     height: int, width: int, frame_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-frame rays with id and xy channels. poses_c2w (V, 4, 4), ks (V, 3, 3)
    normalized; frame_ids (V,) floats, 0..V-1 by default. Returns (V, H, W, 11)."""
    V = poses_c2w.shape[0]
    r, xy = rays_mod.rays_from_k(poses_c2w, ks, width, height, z_near, z_far)
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
        if grid_shift is not None:
            sy, sx = (int(s) for s in grid_shift)
            y0, x0 = sy % P + P * py, sx % P + P * px
            patch_y, patch_x = py + int(sy < 0), px + int(sx < 0)
        else:
            y0, x0 = P * py, P * px
            patch_y, patch_x = py, px
        o = torch.arange(P, device=images.device)
        yy = y0[..., None, None] + o[:, None]
        xx = x0[..., None, None] + o[None, :]
        flat = ((pv[..., None, None] * H + yy) * W + xx).reshape(B, -1)  # (B, R)

        rays, rgb = [], []
        for b in range(B):
            fr = build_frame_rays(poses_c2w[b], ks[b], self.z_near, self.z_far, H, W, frame_ids)
            rays.append(fr.reshape(V * H * W, -1)[flat[b]])
            rgb.append(images[b].permute(0, 2, 3, 1).reshape(V * H * W, C)[flat[b]])
        rays, rgb_gt = torch.stack(rays), torch.stack(rgb)
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
        dflat = dino_features.permute(0, 1, 3, 4, 2).reshape(B, Vd * Gh * Gw, Cd)
        didx = (pv * Gh + patch_y) * Gw + patch_x
        dino_gt = torch.gather(dflat, 1, didx[..., None].expand(B, didx.shape[1], Cd))
        return rays, rgb_gt, dino_gt

    def reconstruct(self, flat: torch.Tensor) -> torch.Tensor:
        """(B, R, ...) -> (B, PC, P, P, ...)."""
        return flat.reshape(flat.shape[0], self.patch_count, self.patch_size, self.patch_size,
                            *flat.shape[2:])


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
