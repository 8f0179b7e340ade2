"""Ray generation (counterpart of `scenedino_tpu/core/rays.py:16-97`).

Rays are packed as 8 floats [origin(3), dir(3), near(1), far(1)].
"""
from __future__ import annotations

import torch


def _per_camera(v, name: str, device, dtype) -> torch.Tensor:
    """Scalar, (2,) or (N, 2) focal / principal point -> (N, 2)."""
    v = torch.as_tensor(v, device=device, dtype=dtype)
    if v.ndim == 0:
        return v.expand(1, 2).clone()
    if v.ndim == 1:
        if v.shape[0] == 2:
            return v[None]
        if v.shape[0] == 1:
            return v.expand(2)[None].clone()
        raise ValueError(f"ambiguous {name} shape {tuple(v.shape)}: pass (N, 2)")
    return v


def unproj_map(width: int, height: int, f, c=None, norm_dir: bool = True,
               device=None, dtype=torch.float32, xy_offset=None):
    """Per-pixel camera-space ray directions.

    f, c: focal and principal point in NDC units, scalar / (2,) / (N, 2);
    c defaults to 0; xy_offset (2,): a sub-pixel shift of every pixel
    centre, in pixels (the jittered sampler's). Returns (dirs (N, H, W, 3), xy_img (N, H, W, 2)) with
    pixel centres at linspace(-1 + 1/W, 1 - 1/W, W) like the reference.
    """
    f = _per_camera(f, "focal", device, dtype)
    c = torch.zeros_like(f) if c is None else _per_camera(c, "principal-point", device, dtype)
    n = max(f.shape[0], c.shape[0])
    pw, ph = 2.0 / width, 2.0 / height
    x = torch.linspace(-1 + 0.5 * pw, 1 - 0.5 * pw, width, device=f.device, dtype=dtype)
    y = torch.linspace(-1 + 0.5 * ph, 1 - 0.5 * ph, height, device=f.device, dtype=dtype)
    if xy_offset is not None:
        x = x + xy_offset[0] * pw
        y = y + xy_offset[1] * ph
    yg, xg = torch.meshgrid(y, x, indexing="ij")
    xy_img = torch.stack([xg, yg], -1)[None].expand(n, height, width, 2)
    xy = (xy_img - c[:, None, None, :]) / f[:, None, None, :]
    dirs = torch.cat([xy, torch.ones_like(xy[..., :1])], -1)
    if norm_dir:
        dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    return dirs, xy_img


def gen_rays(poses_c2w: torch.Tensor, width: int, height: int, z_near: float, z_far: float,
             focal, c=None, norm_dir: bool = True, xy_offset=None):
    """Camera rays for a batch of views. poses_c2w: (N, 4, 4).
    Returns (rays (N, H, W, 8), xy (N, H, W, 2))."""
    n = poses_c2w.shape[0]
    dirs, xy = unproj_map(width, height, focal, c=c, norm_dir=norm_dir,
                          device=poses_c2w.device, dtype=poses_c2w.dtype, xy_offset=xy_offset)
    dirs = dirs.expand(n, height, width, 3)
    xy = xy.expand(n, height, width, 2)
    origins = poses_c2w[:, None, None, :3, 3].expand(n, height, width, 3)
    world_dirs = torch.einsum("nij,nhwj->nhwi", poses_c2w[:, :3, :3], dirs)
    nears = torch.full_like(dirs[..., :1], z_near)
    fars = torch.full_like(dirs[..., :1], z_far)
    return torch.cat([origins, world_dirs, nears, fars], -1), xy


def rays_from_k(poses_c2w: torch.Tensor, ks: torch.Tensor, width: int, height: int,
                z_near: float, z_far: float, norm_dir: bool = True, xy_offset=None):
    """Rays from full normalized intrinsics (N, 3, 3)."""
    focal = torch.stack([ks[:, 0, 0], ks[:, 1, 1]], -1)
    c = torch.stack([ks[:, 0, 2], ks[:, 1, 2]], -1)
    return gen_rays(poses_c2w, width, height, z_near, z_far, focal, c=c, norm_dir=norm_dir, xy_offset=xy_offset)
