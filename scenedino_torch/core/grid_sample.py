"""Bilinear / nearest NDC sampling of per-view maps (counterpart of
`scenedino_tpu/core/grid_sample.py:27-98`), channels first and last.

The reference reimplements `F.grid_sample(align_corners=False,
padding_mode="border")` as four gathers; here it is that call. The map is
sampled in fp32 whatever its dtype (the reference blends bf16 corner
values with fp32 weights, which promotes to fp32). A non-finite
coordinate (a singular pose) gives NaN in bilinear mode and, in nearest
mode, pixel 0 for NaN and the edge for +-inf, as the reference's gathers
do; grid_sample itself would clamp NaN to the border, and its backward
writes out of bounds for it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_views(feats: torch.Tensor, xy: torch.Tensor, mode: str = "bilinear") -> torch.Tensor:
    """feats (B, V, C, H, W); xy (B, V, P, 2) NDC (x, y). Returns (B, V, P, C) fp32."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"mode must be 'bilinear' or 'nearest', got {mode!r}")
    B, V, C, H, W = feats.shape
    grid = xy.reshape(B * V, 1, -1, 2).float()
    finite = torch.isfinite(grid)
    grid = torch.nan_to_num(grid, nan=-1.0, posinf=1.0, neginf=-1.0)  # NaN: pixel 0, +-inf: the edges
    if mode == "nearest":
        # the reference rounds half up (floor(x + 0.5)) after the border
        # clamp; grid_sample's nearest rounds half to even, so snap the
        # coordinate to the chosen pixel centre first
        size = grid.new_tensor([W, H])
        px = torch.minimum(torch.maximum(torch.floor((grid + 1.0) * 0.5 * size), grid.new_zeros(2)), size - 1)
        grid = (px + 0.5) / size * 2.0 - 1.0
    out = F.grid_sample(feats.reshape(B * V, C, H, W).float(), grid, mode=mode,
                        padding_mode="border", align_corners=False)
    if mode == "bilinear":
        out = out + torch.where(finite.all(-1), 0.0, float("nan"))[:, None]
    return out[:, :, 0].transpose(1, 2).reshape(B, V, -1, C)


def grid_sample_views_hwc(feats: torch.Tensor, xy: torch.Tensor, mode: str = "bilinear") -> torch.Tensor:
    """Channels-last `grid_sample_views` (reference :87): feats (B, V, H, W, C);
    xy (B, V, P, 2) NDC. Returns (B, V, P, C) fp32."""
    return grid_sample_views(feats.permute(0, 1, 4, 2, 3), xy, mode)
