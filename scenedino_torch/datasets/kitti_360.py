"""KITTI-360 calibration and poses (the part of
`scenedino_tpu/datasets/kitti_360.py` that the SSCBench loader needs:
`load_calibs` :211 and `load_poses` :299).

The fisheye cameras' MEI models (`image_02.yaml`, `image_03.yaml`) and
their resampler to pinhole views are not ported: `load_calibs` reads the
perspective calibration only, and the fisheye cameras keep their
rectifying rotations (`fisheye_rotation`) and poses. The multi-view
KITTI-360 loader waits in ROADMAP queue 1, item 7.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np


def _read_kv(path) -> Dict[str, np.ndarray]:
    """"key: floats" lines; lines whose value is not numbers are skipped."""
    out = {}
    with open(path) as f:
        for line in f.readlines():
            key, value = line.split(":", 1)
            try:
                out[key] = np.array([float(v) for v in value.split()], np.float32)
            except ValueError:
                pass
    return out


def load_calibs(data_path, fisheye_rotation=(0, -15)) -> Dict:
    """Parse and normalize the KITTI-360 calibration (old_kitti_360.py:388-573)
    under `<data_path>/calibration`: calib_cam_to_pose.txt,
    calib_cam_to_velo.txt and perspective.txt. Returns the normalized
    perspective intrinsics ("K_perspective", also "K_fisheye" as in the
    reference), the camera-to-pose transforms of cameras 00-03
    ("T_cam_to_pose"), the velodyne transforms and the rectified image
    size ("im_size", (H, W))."""
    from scipy.spatial.transform import Rotation

    calib = Path(data_path) / "calibration"
    cam_to_pose = _read_kv(calib / "calib_cam_to_pose.txt")
    with open(calib / "calib_cam_to_velo.txt") as f:
        cam_to_velo = np.array([float(v) for v in f.readline().split()], np.float32)
    intr = _read_kv(calib / "perspective.txt")

    im_size_rect = (int(intr["S_rect_00"][1]), int(intr["S_rect_00"][0]))
    P_rect_00 = intr["P_rect_00"].reshape(3, 4)
    R_rect_00 = np.eye(4, dtype=np.float32)
    R_rect_01 = np.eye(4, dtype=np.float32)
    R_rect_00[:3, :3] = intr["R_rect_00"].reshape(3, 3)
    R_rect_01[:3, :3] = intr["R_rect_01"].reshape(3, 3)

    rot = np.array(fisheye_rotation, np.float32).reshape(1, 2)
    R_02 = np.eye(4, dtype=np.float32)
    R_03 = np.eye(4, dtype=np.float32)
    R_02[:3, :3] = Rotation.from_euler("xy", rot[:, [1, 0]], degrees=True).as_matrix().astype(np.float32)
    R_03[:3, :3] = Rotation.from_euler("xy", rot[:, [1, 0]] * np.array([[1, -1]]),
                                       degrees=True).as_matrix().astype(np.float32)

    def T_of(key):
        T = np.eye(4, dtype=np.float32)
        T[:3, :] = cam_to_pose[key].reshape(3, 4)
        return T

    T_00, T_01, T_02, T_03 = T_of("image_00"), T_of("image_01"), T_of("image_02"), T_of("image_03")
    T_00_velo = np.eye(4, dtype=np.float32)
    T_00_velo[:3, :] = cam_to_velo.reshape(3, 4)

    T_rect_00_to_pose = T_00 @ np.linalg.inv(R_rect_00)
    T_rect_01_to_pose = T_01 @ np.linalg.inv(R_rect_01)
    T_velo_to_rect_00 = R_rect_00 @ np.linalg.inv(T_00_velo)
    T_velo_to_pose = T_rect_00_to_pose @ T_velo_to_rect_00
    T_velo_to_rect_01 = np.linalg.inv(T_rect_01_to_pose) @ T_velo_to_pose

    K = P_rect_00[:3, :3].copy()
    K[0, 0] = K[0, 0] / im_size_rect[1] * 2.0
    K[1, 1] = K[1, 1] / im_size_rect[0] * 2.0
    K[0, 2] = K[0, 2] / im_size_rect[1] * 2.0 - 1
    K[1, 2] = K[1, 2] / im_size_rect[0] * 2.0 - 1

    return {
        "K_perspective": K,
        "K_fisheye": K,
        "T_cam_to_pose": {"00": T_rect_00_to_pose, "01": T_rect_01_to_pose, "02": T_02 @ R_02,
                          "03": T_03 @ R_03},
        "T_velo_to_cam": {"00": T_velo_to_rect_00, "01": T_velo_to_rect_01},
        "T_velo_to_pose": T_velo_to_pose,
        "im_size": im_size_rect,
    }


def load_poses(pose_path, sequences):
    """Per sequence (image ids, poses (N, 4, 4) system -> world) from
    `<pose_path>/<sequence>/poses.txt` (old_kitti_360.py:590-611)."""
    ids, poses = {}, {}
    for seq in sequences:
        data = np.loadtxt(Path(pose_path) / seq / "poses.txt")
        ids[seq] = data[:, 0].astype(int)
        p = data[:, 1:].astype(np.float32).reshape(-1, 3, 4)
        p = np.concatenate([p, np.zeros_like(p[:, :1])], axis=1)
        p[:, 3, 3] = 1
        poses[seq] = p
    return ids, poses
