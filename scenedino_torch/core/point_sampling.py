"""Regular 3D point grids on the host (the port's copy of
`scenedino_tpu/core/point_sampling.py:26-51`; reference
`scenedino/common/point_sampling.py:regular_grid:8` and the KITTI-360
occupancy probe grid, `old_kitti_360.py:get_points:236-273`: X (-9, 9) x
256, Y (0, 0.75) x 64, Z (21, 3) x 256 with the 5-degree camera
inclination). Numpy: the grid feeds the dataset's `get_points`, not the
device path.
"""
from __future__ import annotations

import numpy as np

# the KITTI-360 cameras' ~5 degree negative inclination (old_kitti_360.py:253-261)
KITTI_CAM_INCL_ADJUST = np.array(
    [
        [1.0, 0.0, 0.0, 0.0],
        [0.0, 0.9961947, -0.0871557, 0.0],
        [0.0, 0.0871557, 0.9961947, 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ],
    dtype=np.float32,
)


def regular_grid(x_range, y_range, z_range, x_res: int, y_res: int, z_res: int,
                 cam_incl_adjust: np.ndarray | None = None) -> np.ndarray:
    """(x_res, y_res, z_res, 3) float32 points; axis i of the output varies
    coordinate i only, and a range may descend (KITTI's Z is (21, 3)).
    `cam_incl_adjust` (4, 4) moves every point by its rotation and shift."""
    x = np.linspace(x_range[0], x_range[1], x_res, dtype=np.float32)
    y = np.linspace(y_range[0], y_range[1], y_res, dtype=np.float32)
    z = np.linspace(z_range[0], z_range[1], z_res, dtype=np.float32)
    xyz = np.stack(np.meshgrid(x, y, z, indexing="ij"), axis=-1)
    if cam_incl_adjust is not None:
        xyz = xyz @ cam_incl_adjust[:3, :3].T + cam_incl_adjust[:3, 3]
    return xyz


def kitti_occupancy_grid_points() -> np.ndarray:
    """The KITTI-360 datasets' fixed occupancy probe grid (`get_points`):
    (256, 64, 256, 3) camera-frame points, the inclination applied."""
    return regular_grid((-9.0, 9.0), (0.0, 0.75), (21.0, 3.0), 256, 64, 256, cam_incl_adjust=KITTI_CAM_INCL_ADJUST)
