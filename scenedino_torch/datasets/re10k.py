"""The RealEstate10K loader (counterpart of
`scenedino_tpu/datasets/re10k.py`): per-sequence pickled metadata
(timestamps in microseconds, 3x4 world-to-camera poses, intrinsics in
pixel-normalized units), frames under `frames_720/<split>/<seq>/<ms>.jpg`,
windows of `frame_count` frames `dilation` apart (one per frame but the
last, clamped at the sequence's end; every 10th row of the metadata when no
split file is given), or a split file's frame pairs; each frame cropped at
the centre to the target aspect, resized with OpenCV's INTER_AREA, its
intrinsics renormalized to NDC, its pose inverted to camera-to-world.

Host numpy in the reference's float32 arithmetic; JPEGs through
`image_io.read_jpeg` and the resize through `image_io.resize_area`, the
port's stand-ins for PIL and cv2.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from scenedino_torch.datasets.image_io import read_jpeg, resize_area


def process_proj(K_norm_pix, orig_size, crop):
    """Pixel-normalized K (fx, fy, cx, cy in units of the frame) -> NDC K
    after a crop (scenedino_tpu/datasets/re10k.py:20-44); NDC intrinsics do
    not change under the resize that follows."""
    H, W = orig_size
    fx = K_norm_pix[0, 0] * W
    fy = K_norm_pix[1, 1] * H
    cx = K_norm_pix[0, 2] * W
    cy = K_norm_pix[1, 2] * H
    if crop is not None:
        y0, x0, ch, cw = crop
        cx, cy = cx - x0, cy - y0
        H, W = ch, cw
    return np.array([[fx * 2.0 / W, 0, cx * 2.0 / W - 1], [0, fy * 2.0 / H, cy * 2.0 / H - 1], [0, 0, 1]],
                    np.float32)


def center_crop_to_aspect(img, target_aspect):
    """The centre crop of `img` (H, W, ...) to width / height =
    `target_aspect`, the kept side rounded as Python's `round`; returns
    (crop, (y0, x0, height, width))."""
    h, w = img.shape[:2]
    if w / h > target_aspect:
        cw = int(round(h * target_aspect))
        x0 = (w - cw) // 2
        return img[:, x0:x0 + cw], (0, x0, h, cw)
    ch = int(round(w / target_aspect))
    y0 = (h - ch) // 2
    return img[y0:y0 + ch], (y0, 0, ch, w)


@dataclasses.dataclass
class RealEstate10kDataset:
    """An item is {"imgs" (V, 3, H, W) in [-1, 1], "poses" (V, 4, 4)
    camera to world, "projs" (V, 3, 3) NDC intrinsics, "index" (1,)}; V is
    `frame_count`, or 2 for a split file's pair."""

    data_path: str  # <data_root>/<split>.pickle
    split_path: Optional[str] = None
    image_size: Tuple[int, int] = (256, 384)
    frame_count: int = 4
    dilation: int = 3

    def __post_init__(self):
        self.data_root = os.path.dirname(self.data_path)
        self.split = os.path.basename(self.data_path).split(".")[0]
        with open(self.data_path, "rb") as f:
            seq_data = pickle.load(f)
        frames_root = Path(self.data_root) / "frames_720" / self.split
        self._seq_data = {k: v for k, v in seq_data.items() if (frames_root / k).exists()}
        if self.split_path is None:
            for v in self._seq_data.values():
                v["timestamps"] = v["timestamps"][::10]
                v["poses"] = v["poses"][::10]
                v["intrinsics"] = v["intrinsics"][::10]
        sub = (self.frame_count - 1) * self.dilation
        if self.split_path is not None:
            self._datapoints = self._load_split(self.split_path)
        else:
            # one window a frame but the last; the windows near the end clamp in __getitem__
            self._datapoints = [(k, i) for k, v in self._seq_data.items() if len(v["timestamps"]) >= sub
                                for i in range(len(v["timestamps"]) - 1)]

    def _get_id_from_timestamp(self, seq, timestamp):
        """The row of a timestamp given in milliseconds or microseconds."""
        ts = np.asarray(self._seq_data[seq]["timestamps"])
        hit = np.where(((ts / 1000).astype(np.int64) == int(timestamp)) | (ts.astype(np.int64) == int(timestamp)))[0]
        return int(hit[0])

    def _load_split(self, split_path):
        """Split-file lines `seq t0 t1` -> (seq, (row0, row1)) frame pairs,
        as the JAX loader reads them (scenedino_tpu/datasets/re10k.py:112-128:
        three fields; a two-field line raises IndexError there and here)."""
        dps = []
        with open(split_path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                seq, t0, t1 = parts[0], parts[1], parts[2]
                if seq not in self._seq_data:
                    continue
                dps.append((seq, (self._get_id_from_timestamp(seq, t0), self._get_id_from_timestamp(seq, t1))))
        return dps

    def __len__(self):
        return len(self._datapoints)

    def _frame_path(self, seq, timestamp):
        # frames are named by the millisecond timestamp; the metadata holds microseconds
        return Path(self.data_root) / "frames_720" / self.split / seq / f"{int(timestamp) // 1000}.jpg"

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        seq, i0 = self._datapoints[index]
        data = self._seq_data[seq]
        n = len(data["timestamps"])
        if isinstance(i0, tuple):  # a split file's pair
            ids = list(i0)
        else:  # the keyframe-first window, clamped at the sequence's end
            ids = [min(max(i0 + j * self.dilation, 0), n - 1) for j in range(self.frame_count)]
        imgs, poses, projs = [], [], []
        for i in ids:
            img = read_jpeg(self._frame_path(seq, data["timestamps"][i])).astype(np.float32) / 255.0
            orig = img.shape[:2]
            img, crop = center_crop_to_aspect(img, self.image_size[1] / self.image_size[0])
            img = resize_area(img, tuple(self.image_size))
            imgs.append((img * 2 - 1).transpose(2, 0, 1))
            pose_w2c = np.concatenate([data["poses"][i].reshape(3, 4), [[0, 0, 0, 1]]], 0).astype(np.float32)
            poses.append(np.linalg.inv(pose_w2c))
            intr = data["intrinsics"][i]
            K_norm = np.array([[intr[0], 0, intr[2]], [0, intr[1], intr[3]], [0, 0, 1]], np.float32)
            projs.append(process_proj(K_norm, orig, crop))
        return {
            "imgs": np.stack(imgs).astype(np.float32),
            "poses": np.stack(poses).astype(np.float32),
            "projs": np.stack(projs).astype(np.float32),
            "index": np.array([index]),
        }
