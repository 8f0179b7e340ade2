"""Pinhole projection (counterpart of `scenedino_tpu/core/cameras.py` and
the single-view `project` of `scenedino_tpu/ops/fast_field.py:848-854`).

Intrinsics are normalized: applied to camera-space points they give NDC
image coordinates in [-1, 1]. Poses `w2c` map world to camera (the camera
looks down +z). All math is fp32. Bounds are `jnp.maximum`/`jnp.clip`
twins (`core.maximum`, `core.clip`), so ties split the gradient as in JAX.
"""
from __future__ import annotations

import torch

from scenedino_torch.core import clip, maximum

EPS = 1e-3


def project(pts: torch.Tensor, w2c: torch.Tensor, k: torch.Tensor, clamp_ndc: float = 2.0):
    """World points into one camera.

    pts: (..., 3); w2c: (4, 4); k: (3, 3) normalized intrinsics.
    Returns (xy (..., 2) NDC clamped to +-clamp_ndc, z (..., 1) the
    projected depth, cam (..., 3) camera-space points). The divide clamps
    z to >= EPS, like the reference.
    """
    cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
    proj = cam @ k.T
    z = proj[..., 2:3]
    xy = proj[..., :2] / maximum(z, EPS)
    return clip(xy, -clamp_ndc, clamp_ndc), z, cam


def project_points(pts: torch.Tensor, poses_w2c: torch.Tensor, ks: torch.Tensor, clamp_ndc: float = 2.0):
    """World points into several views (`cameras.project_points`, :100).

    pts: (B, P, 3); poses_w2c: (B, V, 4, 4); ks: (B, V, 3, 3).
    Returns xy (B, V, P, 2) clamped to +-clamp_ndc, z (B, V, P, 1),
    distance |p_cam| (B, V, P, 1) and invalid (B, V, P, 1) bool: behind
    the near limit or outside [-1, 1]^2 before the clamp.
    """
    cam = torch.einsum("bvij,bpj->bvpi", poses_w2c[..., :3, :3], pts) + poses_w2c[:, :, None, :3, 3]
    distance = torch.linalg.vector_norm(cam, dim=-1, keepdim=True)
    proj = torch.einsum("bvij,bvpj->bvpi", ks, cam)
    z = proj[..., 2:3]
    xy = proj[..., :2] / maximum(z, EPS)
    invalid = (z <= EPS) | (xy.abs() > 1.0).any(-1, keepdim=True)
    return clip(xy, -clamp_ndc, clamp_ndc), z, distance, invalid
