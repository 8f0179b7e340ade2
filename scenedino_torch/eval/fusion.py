"""TSDF fusion of depth (and colour) frames into a voxel volume
(counterpart of `scenedino_tpu/eval/fusion.py`; reference
`sscbench/fusion.py`, TSDFVolume :21, integrate :246-358, itself the
tsdf-fusion-python CPU path), on tensors on the caller's device.

The reference's semantics are kept:

  * voxel centres at origin + (i + 0.5) * voxel_size (vox2world :205-219);
  * the pixel of a voxel is its ROUNDED projection (half to even, as
    `jnp.round` and `torch.round`), its depth the nearest pixel's
    (cam2pix :223-232);
  * a voxel is updated where its pixel lies in the frame, z > 0, the depth
    is valid (> 0) and depth - z >= -10 m (integrate :310-324); the stored
    value is the cumulative weighted mean of the raw depth - z, not
    truncated (integrate_tsdf :236-244) unless `truncation` is set, which
    clamps (depth - z) / truncation to [-1, 1];
  * the colour is the cumulative weighted mean of the observed pixels.

Every voxel computes its own update, so a frame is one gather and a
masked average over the volume. `extract_surface_points` gives the
observed voxels within one voxel of the zero crossing (the surface the
reference meshes by marching cubes), `save_surface_ply` their cube mesh
through `eval.voxel_io`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class TSDFState(NamedTuple):
    """The volume: tsdf (X, Y, Z) the weighted mean of depth - z, weight
    (X, Y, Z) the observation weights, color (X, Y, Z, 3) the mean colour."""

    tsdf: torch.Tensor
    weight: torch.Tensor
    color: torch.Tensor


@dataclasses.dataclass(frozen=True)
class TSDFVolumeConfig:
    """The volume's geometry (TSDFVolume.__init__:24-69)."""

    vol_bounds: Tuple[Tuple[float, float], ...]  # ((x0, x1), (y0, y1), (z0, z1))
    voxel_size: float
    truncation: Optional[float] = None  # None: the reference's raw depth - z
    depth_diff_floor: float = -10.0  # integrate:324 `depth_diff >= -10`

    @property
    def vol_dim(self) -> Tuple[int, int, int]:
        b = np.asarray(self.vol_bounds, np.float64)
        return tuple(int(n) for n in np.ceil((b[:, 1] - b[:, 0]) / self.voxel_size))

    @property
    def origin(self) -> np.ndarray:
        return np.asarray(self.vol_bounds, np.float32)[:, 0]


def create_volume(cfg: TSDFVolumeConfig, device=None) -> TSDFState:
    """An empty volume on `device` (the CPU by default)."""
    dim = cfg.vol_dim
    return TSDFState(tsdf=torch.zeros(dim, device=device), weight=torch.zeros(dim, device=device),
                     color=torch.zeros((*dim, 3), device=device))


def voxel_centers(cfg: TSDFVolumeConfig, device=None) -> torch.Tensor:
    """(X, Y, Z, 3) world coordinates of the voxel centres (vox2world), fp32."""
    axes = [torch.arange(n, device=device, dtype=torch.float32) for n in cfg.vol_dim]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)
    return torch.from_numpy(cfg.origin).to(device) + (grid + 0.5) * cfg.voxel_size


def integrate(state: TSDFState, cfg: TSDFVolumeConfig, depth_im: torch.Tensor, cam_intr: torch.Tensor,
              cam_pose: torch.Tensor, color_im: Optional[torch.Tensor] = None, obs_weight: float = 1.0) -> TSDFState:
    """One frame (TSDFVolume.integrate:246-358): depth_im (H, W) metric
    depth, 0 where invalid; cam_intr (3, 3) pixel intrinsics; cam_pose
    (4, 4) camera to world; color_im (H, W, 3) or None. On the state's device."""
    H, W = depth_im.shape
    device = state.tsdf.device
    x, y, zw = voxel_centers(cfg, device).reshape(-1, 3).unbind(-1)
    # the camera inverse on the host and the transform one rounded product and sum at a time: the same bits on
    # every device, so the rounded pixel of a voxel does not depend on where the volume lies
    w2c = torch.linalg.inv(cam_pose.float().cpu()).to(device)
    cx, cy, z = (x * w2c[i, 0] + y * w2c[i, 1] + zw * w2c[i, 2] + w2c[i, 3] for i in range(3))
    k = cam_intr.float().to(device)
    px = torch.round(cx * k[0, 0] / z + k[0, 2]).to(torch.int64)
    py = torch.round(cy * k[1, 1] / z + k[1, 2]).to(torch.int64)
    in_frame = (px >= 0) & (px < W) & (py >= 0) & (py < H) & (z > 0)
    pxc, pyc = px.clamp(0, W - 1), py.clamp(0, H - 1)
    depth_im = depth_im.float().to(device)
    depth_val = torch.where(in_frame, depth_im[pyc, pxc], 0.0)

    diff = depth_val - z
    valid = in_frame & (depth_val > 0) & (diff >= cfg.depth_diff_floor)
    dist = diff if cfg.truncation is None else torch.clamp(diff / cfg.truncation, -1.0, 1.0)

    w_old = state.weight.reshape(-1)
    add = torch.where(valid, obs_weight, 0.0)
    w_new = w_old + add
    denom = torch.clamp_min(w_new, 1e-12)
    tsdf = torch.where(valid, (w_old * state.tsdf.reshape(-1) + add * dist) / denom, state.tsdf.reshape(-1))

    color = state.color
    if color_im is not None:
        c_obs = torch.where(in_frame[:, None], color_im.float().to(device)[pyc, pxc], 0.0)
        c_old = state.color.reshape(-1, 3)
        c_new = (w_old[:, None] * c_old + add[:, None] * c_obs) / denom[:, None]
        color = torch.where(valid[:, None], c_new, c_old).reshape(state.color.shape)
    # add is 0 where invalid: there the weight stays as it was
    return TSDFState(tsdf=tsdf.reshape(state.tsdf.shape), weight=w_new.reshape(state.weight.shape), color=color)


def integrate_frames(cfg: TSDFVolumeConfig, depths: torch.Tensor, intrs: torch.Tensor, poses: torch.Tensor,
                     colors: Optional[torch.Tensor] = None, obs_weight: float = 1.0) -> TSDFState:
    """Fuse a sequence into a new volume on the frames' device: depths
    (F, H, W), intrs (F, 3, 3), poses (F, 4, 4) camera to world, colors
    (F, H, W, 3) or None."""
    state = create_volume(cfg, depths.device)
    for f in range(depths.shape[0]):
        state = integrate(state, cfg, depths[f], intrs[f], poses[f],
                          color_im=None if colors is None else colors[f], obs_weight=obs_weight)
    return state


def _surface(state: TSDFState, cfg: TSDFVolumeConfig, level: float, band: Optional[float]):
    """The host's tsdf, colours and the surface mask: observed voxels
    within `band` of `level` (one voxel by default; under `truncation` the
    stored values are divided by it, and so is the band)."""
    if band is None:
        band = cfg.voxel_size if cfg.truncation is None else cfg.voxel_size / cfg.truncation
    tsdf = state.tsdf.cpu().numpy()
    mask = (state.weight.cpu().numpy() > 0) & (np.abs(tsdf - level) <= band)
    return mask, state.color.cpu().numpy()


def extract_surface_points(state: TSDFState, cfg: TSDFVolumeConfig, level: float = 0.0,
                           band: Optional[float] = None):
    """The surface voxels' centres (N, 3) float32 and colours (N, 3) uint8
    (get_point_cloud:366-384), in index order."""
    mask, color = _surface(state, cfg, level, band)
    pts = cfg.origin + (np.argwhere(mask) + 0.5) * cfg.voxel_size
    return pts.astype(np.float32), color[mask].clip(0, 255).astype(np.uint8)


def save_surface_ply(path: str, state: TSDFState, cfg: TSDFVolumeConfig, level: float = 0.0):
    """The surface voxels' cube mesh as a binary PLY (`eval.voxel_io`);
    returns its (vertex count, face count)."""
    from scenedino_torch.eval.voxel_io import save_as_voxel_ply

    mask, color = _surface(state, cfg, level, None)
    return save_as_voxel_ply(path, mask, origin=cfg.origin, voxel_size=cfg.voxel_size,
                             colors=color.clip(0, 255) / 255.0)
