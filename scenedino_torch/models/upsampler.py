"""Teacher-feature upsamplers of the "upsample-gt" encoder mode
(counterpart of `scenedino_tpu/models/upsampler.py`).

`InterpolatedGT` resizes the teacher's patch grid to the image with the
reference's `F.interpolate` (`core.resize.torch_interpolate`).
`MultiScaleCropGT` encodes, per image, `num_views` views in the order
[n_aug crops, the flipped image, the image] (n_aug = num_views - 2), each
crop an axis-aligned RandomResizedCrop (area 0.5-1 of the image, relative
aspect 1/1.2-1.2, a random position, a random horizontal flip) resampled
to the image size; the teacher's grids are upsampled to the image with
`jax.image.resize`'s bilinear filter (`core.resize.jax_resize`; on an
upscale it equals `F.interpolate(align_corners=False)`), the crops warped
back onto the image with their inverse maps, the flipped view flipped
back, and the views averaged where each is valid, then L2-normalized.

The crop draws are an explicit input (`CropDraws`, drawn by
`sample_crop_params` from a `torch.Generator` with the reference's
distributions). The teacher runs once on every view of every image; the
upsampling, the warp back and the mean then go one image at a time, which
bounds the memory of the full-resolution maps and gives the same numbers
as the whole batch at once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from scenedino_torch.core import safe_normalize
from scenedino_torch.core.resize import jax_resize, torch_interpolate


@dataclasses.dataclass
class CropDraws:
    """The crops of `MultiScaleCropGT`, each (n_images, n_aug) fp32, in NDC
    of the [-1, 1] image: half-extents `hw` (x) and `hh` (y), centres `cx`
    and `cy`, and `flip` (-1 mirrors the crop, 1 keeps it)."""

    hw: torch.Tensor
    hh: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    flip: torch.Tensor

    def to(self, device) -> "CropDraws":
        return CropDraws(*(getattr(self, f.name).to(device) for f in dataclasses.fields(self)))


def sample_crop_params(generator: torch.Generator, n_images: int, n_aug: int) -> CropDraws:
    """`n_aug` crops of each of `n_images` images from `generator`, on its
    device (upsampler.py:48-70): the area in [0.5, 1] of the image's, the
    log of the relative aspect in [log(1/1.2), log(1.2)], the centre's x
    and y, and the flip (p = 1/2), drawn in that order."""
    dev = generator.device

    def uniform(low, high):
        return low + (high - low) * torch.rand(n_images, n_aug, generator=generator, device=dev)

    area = uniform(0.5, 1.0)
    ratio = torch.exp(uniform(math.log(1 / 1.2), math.log(1.2)))
    hw = torch.clip(torch.sqrt(area) * torch.sqrt(ratio), 0.05, 1.0)
    hh = torch.clip(torch.sqrt(area) / torch.sqrt(ratio), 0.05, 1.0)
    cx, cy = uniform(-1.0, 1.0) * (1.0 - hw), uniform(-1.0, 1.0) * (1.0 - hh)
    flip = torch.where(torch.rand(n_images, n_aug, generator=generator, device=dev) < 0.5, -1.0, 1.0)
    return CropDraws(hw, hh, cx, cy, flip)


class InterpolatedGT(nn.Module):
    """Teacher patch grid -> pixel grid by `F.interpolate` (upsampler.py:29-45)."""

    crop_views = 0

    def __init__(self, interpolation: str = "bilinear", image_size: Tuple[int, int] = (192, 640)):
        super().__init__()
        self.interpolation = interpolation
        self.image_size = tuple(image_size)

    def forward(self, gt_encoder: nn.Module, x: torch.Tensor, crops=None) -> torch.Tensor:
        feats = gt_encoder(x)[-1]  # (B, C, Gh, Gw)
        out = torch_interpolate(feats.permute(0, 2, 3, 1), self.image_size, mode=self.interpolation)
        return out.permute(0, 3, 1, 2)


def _pixel_ndc(n: int, device) -> torch.Tensor:
    """The NDC of n pixel centres: linspace(-1 + 1/n, 1 - 1/n, n)."""
    return torch.linspace(-1 + 1 / n, 1 - 1 / n, n, device=device)


def _sample(img: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor) -> torch.Tensor:
    """img (N, C, H, W) at NDC (sx, sy), each (N, H', W'): bilinear, border
    padding, align_corners=False (the reference's grid_sample_2d)."""
    return F.grid_sample(img, torch.stack([sx, sy], -1), mode="bilinear", padding_mode="border",
                         align_corners=False)


class MultiScaleCropGT(nn.Module):
    """Multi-scale-crop teacher features (upsampler.py:73-150):
    forward(gt_encoder, x (B, 3, H, W), crops (B, n_aug)) -> (B, C, H, W)."""

    def __init__(self, num_views: int = 4):
        super().__init__()
        self.num_views = num_views

    @property
    def crop_views(self) -> int:
        """Crops drawn per image (the views besides the image and its flip)."""
        return self.num_views - 2

    def forward(self, gt_encoder: nn.Module, x: torch.Tensor, crops: CropDraws) -> torch.Tensor:
        B, _, H, W = x.shape
        n_aug, V = self.crop_views, self.num_views
        if crops is None or tuple(crops.hw.shape) != (B, n_aug):
            raise ValueError(f"MultiScaleCropGT needs (B, n_aug) = {(B, n_aug)} crop draws, got "
                             f"{None if crops is None else tuple(crops.hw.shape)}")
        crops = crops.to(x.device)
        gy, gx = torch.meshgrid(_pixel_ndc(H, x.device), _pixel_ndc(W, x.device), indexing="ij")  # (H, W)

        def per_crop(t):  # (B, n_aug) -> (B * n_aug, 1, 1)
            return t.reshape(-1, 1, 1).float()

        hw, hh, cx, cy, fl = (per_crop(t) for t in (crops.hw, crops.hh, crops.cx, crops.cy, crops.flip))
        # view pixel u -> source NDC A u + t
        src = x.float().repeat_interleave(n_aug, 0)
        aug = _sample(src, gx * hw * fl + cx, gy * hh + cy).reshape(B, n_aug, 3, H, W).to(x.dtype)
        views = torch.cat([aug, x.flip(-1)[:, None], x[:, None]], 1).reshape(B * V, 3, H, W)
        grids = gt_encoder(views)[-1]  # (B * V, C, Gh, Gw): the teacher on every view at once
        C = grids.shape[1]
        grids = grids.reshape(B, V, C, *grids.shape[-2:])
        # original pixel p is valid in crop i iff its view coordinate (p - t) / A lies in [-1, 1]
        vx, vy = (gx - cx) / (hw * fl), (gy - cy) / hh  # (B * n_aug, H, W)
        valid = ((vx.abs() <= 1.0) & (vy.abs() <= 1.0)).reshape(B, n_aug, 1, H, W).float()
        out = []
        for b in range(B):
            feats = jax_resize(grids[b].float(), (H, W), "bilinear")  # (V, C, H, W)
            rows = slice(b * n_aug, (b + 1) * n_aug)
            warped = _sample(feats[:n_aug], vx[rows], vy[rows])
            summed = (warped * valid[b]).sum(0)
            summed = summed + feats[n_aug].flip(-1) + feats[n_aug + 1]  # the flip and the image: valid everywhere
            out.append(safe_normalize(summed / (valid[b].sum(0) + 2.0), dim=0, eps=1e-12))
        return torch.stack(out)
