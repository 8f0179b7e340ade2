"""SSCBench-KITTI-360 frames with their 256x256x32 voxel ground truth (the
port's `scenedino_tpu/datasets/sscbench.py:27-117`).

The front perspective image of each frame that has a
`{frame:06d}_1_1.npy` voxel file, read with the port's PNG reader and
resized as `cv2.INTER_LINEAR` does (`datasets.image_io`), its pose and
normalized intrinsics from the KITTI-360 calibration; with `load_fisheye`
also the two fisheye views `fisheye_offset` pose rows later, resampled to
the pinhole view through their MEI models.
"""
from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from scenedino_torch.datasets.image_io import read_rgb, resize_bilinear
from scenedino_torch.datasets.kitti_360 import FisheyeToPinholeSampler, load_calibs, load_poses


@dataclasses.dataclass
class SSCBenchDataset:
    """__getitem__ -> {"imgs" (V, 3, H, W) in [-1, 1], "projs" (V, 3, 3),
    "poses" (V, 4, 4) camera -> world, "voxel_gt" (256, 256, 32) uint8,
    "index" (1,)} (sscbench_dataset.py:443-508): V = 1, or 3 with
    `load_fisheye` (the front view, then fisheyes 02 and 03 of the pose row
    `fisheye_offset` after the frame's, clamped to the sequence).
    `voxel_gt_path=None` lists every rectified front image and gives no
    "voxel_gt". The fisheye calibrations are read only with `load_fisheye`."""

    data_path: str
    voxel_gt_path: Optional[str] = None
    pose_path: Optional[str] = None
    sequences: Tuple[str, ...] = ("2013_05_28_drive_0009_sync",)
    target_image_size: Tuple[int, int] = (192, 640)
    fisheye_rotation: Tuple[int, int] = (0, -15)
    fisheye_offset: int = 10
    load_fisheye: bool = False

    def __post_init__(self):
        self._calibs = load_calibs(self.data_path, self.fisheye_rotation, fisheye=self.load_fisheye)
        if self.load_fisheye:
            fish = self._calibs["fisheye"]
            self._resamplers = {cam: FisheyeToPinholeSampler(self._calibs["K_fisheye"], self.target_image_size,
                                                             fish[f"calib_{cam}"], fish[f"R_{cam}"])
                                for cam in ("02", "03")}
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

    def _image(self, seq, img_id, cam="00"):
        folder = "data_rect" if cam in ("00", "01") else "data_rgb"
        img = read_rgb(Path(self.data_path) / "data_2d_raw" / seq / f"image_{cam}" / folder / f"{img_id:010d}.png")
        if cam in ("02", "03"):
            img = self._resamplers[cam].resample(img)
        elif img.shape[:2] != tuple(self.target_image_size):
            img = resize_bilinear(img, self.target_image_size)
        return (img * 2 - 1).transpose(2, 0, 1).astype(np.float32)

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        seq, frame_id = self._datapoints[index]
        # the frame id names the image; the pose row is found by image id
        pose_idx = min(int(np.searchsorted(self._img_ids[seq], frame_id)), len(self._poses[seq]) - 1)
        T = self._calibs["T_cam_to_pose"]
        imgs = [self._image(seq, frame_id)]
        poses = [self._poses[seq][pose_idx] @ T["00"]]
        projs = [self._calibs["K_perspective"]]
        if self.load_fisheye:
            # the fisheyes' image and pose from one pose row, clamped to the sequence
            fid_idx = min(pose_idx + self.fisheye_offset, len(self._poses[seq]) - 1)
            fid = int(self._img_ids[seq][fid_idx])
            imgs += [self._image(seq, fid, "02"), self._image(seq, fid, "03")]
            poses += [self._poses[seq][fid_idx] @ T["02"], self._poses[seq][fid_idx] @ T["03"]]
            projs += [self._calibs["K_fisheye"]] * 2
        out = {
            "imgs": np.stack(imgs).astype(np.float32),
            "poses": np.stack(poses).astype(np.float32),
            "projs": np.stack(projs).astype(np.float32),
            "index": np.array([index]),
        }
        if self.voxel_gt_path is not None:
            out["voxel_gt"] = np.load(Path(self.voxel_gt_path) / seq / f"{frame_id:06d}_1_1.npy")
        return out
