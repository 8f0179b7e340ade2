"""SSCBench-KITTI-360 frames with their 256x256x32 voxel ground truth (the
port's `scenedino_tpu/datasets/sscbench.py:27-117`, without the fisheyes).

The front perspective image of each frame that has a
`{frame:06d}_1_1.npy` voxel file, read with the port's PNG reader and
resized as `cv2.INTER_LINEAR` does (`datasets.image_io`), its pose and
normalized intrinsics from the KITTI-360 calibration.
"""
from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from scenedino_torch.datasets.image_io import read_rgb, resize_bilinear
from scenedino_torch.datasets.kitti_360 import load_calibs, load_poses


@dataclasses.dataclass
class SSCBenchDataset:
    """__getitem__ -> {"imgs" (1, 3, H, W) in [-1, 1], "projs" (1, 3, 3),
    "poses" (1, 4, 4) camera -> world, "voxel_gt" (256, 256, 32) uint8,
    "index" (1,)} (sscbench_dataset.py:443-508). `voxel_gt_path=None`
    lists every rectified front image and gives no "voxel_gt".
    `load_fisheye=True` raises: the fisheye resampler waits in ROADMAP
    queue 1, item 7."""

    data_path: str
    voxel_gt_path: Optional[str] = None
    pose_path: Optional[str] = None
    sequences: Tuple[str, ...] = ("2013_05_28_drive_0009_sync",)
    target_image_size: Tuple[int, int] = (192, 640)
    load_fisheye: bool = False

    def __post_init__(self):
        if self.load_fisheye:
            raise NotImplementedError("SSCBenchDataset(load_fisheye=True): the fisheye-to-pinhole resampler is not "
                                      "ported (ROADMAP queue 1, item 7)")
        self._calibs = load_calibs(self.data_path)
        pose_path = self.pose_path or os.path.join(self.data_path, "data_poses")
        self._img_ids, self._poses = load_poses(pose_path, self.sequences)
        self._datapoints = self._load_datapoints()

    def _load_datapoints(self):
        dps = []
        for seq in self.sequences:
            if self.voxel_gt_path is None:
                img_dir = Path(self.data_path) / "data_2d_raw" / seq / "image_00" / "data_rect"
                dps += [(seq, int(f.stem)) for f in (sorted(img_dir.glob("*.png")) if img_dir.exists() else [])]
                continue
            gt_dir = Path(self.voxel_gt_path) / seq
            if gt_dir.exists():
                dps += [(seq, int(f.name[:6])) for f in sorted(gt_dir.glob("*_1_1.npy"))]
        return dps

    def __len__(self):
        return len(self._datapoints)

    def _image(self, seq, img_id):
        p = Path(self.data_path) / "data_2d_raw" / seq / "image_00" / "data_rect" / f"{img_id:010d}.png"
        img = read_rgb(p)
        if img.shape[:2] != tuple(self.target_image_size):
            img = resize_bilinear(img, self.target_image_size)
        return (img * 2 - 1).transpose(2, 0, 1).astype(np.float32)

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        seq, frame_id = self._datapoints[index]
        # the frame id names the image; the pose row is found by image id
        pose_idx = min(int(np.searchsorted(self._img_ids[seq], frame_id)), len(self._poses[seq]) - 1)
        out = {
            "imgs": self._image(seq, frame_id)[None],
            "poses": (self._poses[seq][pose_idx] @ self._calibs["T_cam_to_pose"]["00"])[None].astype(np.float32),
            "projs": self._calibs["K_perspective"][None].astype(np.float32),
            "index": np.array([index]),
        }
        if self.voxel_gt_path is not None:
            out["voxel_gt"] = np.load(Path(self.voxel_gt_path) / seq / f"{frame_id:06d}_1_1.npy")
        return out
