"""The SSCBench-KITTI-360 voxel grid (the port's copy of
`scenedino_tpu/eval/sscbench.py:27-59,114-135`, numpy only).

Only the grid the voxel query runs over: 256x256x32 voxel centres of
0.2 m over 51.2 x 51.2 x 6.4 m in front of the camera, in the camera
frame, with the release's calibration and its field-of-view mask. The
evaluator itself (pooling, carving, the mIoU tables) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

SIGMA_CUTOFF = 0.2
VOXEL_SIZE = 0.2
SIZES = (12.8, 25.6, 51.2)
VOX_ORIGIN = np.array([0.0, -25.6, -2.0], np.float32)
SCENE_SIZE = (51.2, 51.2, 6.4)
IMG_W, IMG_H = 1408, 376

# SSCBench-KITTI-360 calibration (sscbench/point_utils.py:84-157)
CAM_K = np.array(
    [[552.554261, 0.0, 682.049453], [0.0, 552.554261, 238.769549], [0.0, 0.0, 1.0]],
    np.float64,
)
CAM2VELO = np.array(
    [
        [0.04307104361, -0.08829286498, 0.995162929, 0.8043914418],
        [-0.999004371, 0.007784614041, 0.04392796942, 0.2993489574],
        [-0.01162548558, -0.9960641394, -0.08786966659, -0.1770225824],
        [0.0, 0.0, 0.0, 1.0],
    ],
    np.float64,
)
VELO2CAM = np.linalg.inv(CAM2VELO)


@dataclasses.dataclass(frozen=True)
class SSCCalib:
    """Per-export calibration (defaults: the SSCBench-KITTI-360 release)."""

    cam_k: np.ndarray = dataclasses.field(default_factory=lambda: CAM_K)
    velo2cam: np.ndarray = dataclasses.field(default_factory=lambda: VELO2CAM)
    img_w: int = IMG_W
    img_h: int = IMG_H


def generate_point_grid(voxel_size=VOXEL_SIZE, vox_origin=VOX_ORIGIN, scene_size=SCENE_SIZE,
                        calib: Optional[SSCCalib] = None):
    """Voxel-centre points in the camera frame and the field-of-view mask
    (sscbench/point_utils.py:17-82). Returns (pts (N, 3) float32,
    fov_mask (N,) bool), N = 256*256*32 at 0.2 m, voxels in (x, y, z)
    index order."""
    calib = calib or SSCCalib()
    vol_dim = np.ceil(np.array(scene_size) / voxel_size).astype(int)
    xv, yv, zv = np.meshgrid(range(vol_dim[0]), range(vol_dim[1]), range(vol_dim[2]), indexing="ij")
    coords = np.stack([xv.reshape(-1), yv.reshape(-1), zv.reshape(-1)], 1).astype(np.float32)
    velo_pts = vox_origin[None] + voxel_size * coords + voxel_size * 0.5

    v2c, cam_k = calib.velo2cam, calib.cam_k
    cam_pts = (v2c[:3, :3] @ velo_pts.T).T + v2c[:3, 3]
    pix_x = np.round(cam_pts[:, 0] * cam_k[0, 0] / cam_pts[:, 2] + cam_k[0, 2]).astype(np.int64)
    pix_y = np.round(cam_pts[:, 1] * cam_k[1, 1] / cam_pts[:, 2] + cam_k[1, 2]).astype(np.int64)
    pix_z = cam_pts[:, 2]
    fov_mask = (
        (pix_x >= 0) & (pix_x < calib.img_w) & (pix_y >= 0) & (pix_y < calib.img_h) & (pix_z > 0)
    )
    return cam_pts.astype(np.float32), fov_mask
