"""Camera-geometry helpers (counterpart of `scenedino_tpu/core/geometry.py`):
the ray-distance to camera-z conversion of the depth metric."""
from __future__ import annotations

import torch


def _ray_norm_factors(projs: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """cos(angle to the optical axis) per pixel, z / ||K^-1 [x, y, 1]||, on
    the reference's grid: linspace(-1, 1) over the full NDC range
    (geometry.py:27-36). projs (..., 3, 3) -> (..., h, w), fp32."""
    projs = projs.float()
    inv_k = torch.linalg.inv(projs)
    gx = torch.linspace(-1.0, 1.0, w, device=projs.device)
    gy = torch.linspace(-1.0, 1.0, h, device=projs.device)
    gyy, gxx = torch.meshgrid(gy, gx, indexing="ij")
    img = torch.stack([gxx, gyy, torch.ones_like(gxx)], 0).reshape(3, -1)  # (3, hw)
    cam = inv_k @ img
    factors = cam[..., 2, :] / torch.linalg.vector_norm(cam, dim=-2)
    return factors.reshape(*projs.shape[:-2], h, w)


def distance_to_z(depths: torch.Tensor, projs: torch.Tensor) -> torch.Tensor:
    """Euclidean ray distance -> camera z depth (geometry.py:39-44).
    depths (n, nv, h, w); projs (n, nv, 3, 3) normalized intrinsics."""
    n, nv, h, w = depths.shape
    return depths * _ray_norm_factors(projs, h, w)
