"""2D semantic-segmentation evaluation sets: Cityscapes and BDD (the port's
`scenedino_tpu/datasets/seg2d.py:27-136`, without PIL or OpenCV).

The geometry of `datasets/cityscapes/cityscapes_dataset.py`: a bilinear
resize to (320, 640), a centre crop to (192, 640), identity pose and
intrinsics, the image in [-1, 1]; targets resized nearest and mapped to
trainIds (-1 ignored). BDD's masks already hold the 19 trainIds.
"""
from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from scenedino_torch.datasets.image_io import read_png, read_rgb, resize_bilinear, resize_nearest
from scenedino_torch.datasets.labels import map_id_to_train_id


def _center_crop(img, size):
    h, w = img.shape[:2]
    th, tw = size
    y0, x0 = (h - th) // 2, (w - tw) // 2
    return img[y0:y0 + th, x0:x0 + tw]


def load_eval_image(path, image_size=(192, 640), resize_to=(320, 640)) -> np.ndarray:
    """Image -> (3, H, W) float32 in [-1, 1] with the reference's resize and crop."""
    img = _center_crop(resize_bilinear(read_rgb(path), resize_to), image_size)
    return (img * 2.0 - 1.0).transpose(2, 0, 1)


def load_eval_target(path, image_size=(192, 640), resize_to=(320, 640), id_map=None) -> np.ndarray:
    """Label PNG -> (H, W) int64, through `id_map` when given."""
    seg = read_png(path).astype(np.int32)
    seg = _center_crop(resize_nearest(seg, resize_to), image_size).astype(np.int64)
    return id_map(seg) if id_map is not None else seg


def _identity_sample(img, seg, index) -> Dict[str, np.ndarray]:
    return {
        "imgs": img[None].astype(np.float32),  # (1, 3, H, W)
        "poses": np.eye(4, dtype=np.float32)[None],
        "projs": np.eye(3, dtype=np.float32)[None],
        "segs": seg[None],
        "index": np.array([index]),
    }


@dataclasses.dataclass
class CityscapesSeg:
    """Cityscapes val-set segmentation (cityscapes_dataset.py:30-82):
    `leftImg8bit/<split>/<city>/*_leftImg8bit.png` with
    `gtFine/<split>/<city>/*_gtFine_labelIds.png`."""

    root: str
    image_set: str = "val"
    image_size: Tuple[int, int] = (192, 640)

    def __post_init__(self):
        img_dir = Path(self.root) / "leftImg8bit" / self.image_set
        self.items = []
        for city in sorted(os.listdir(img_dir)) if img_dir.exists() else []:
            for f in sorted(os.listdir(img_dir / city)):
                if f.endswith("_leftImg8bit.png"):
                    base = f[:-len("_leftImg8bit.png")]
                    seg = Path(self.root) / "gtFine" / self.image_set / city / f"{base}_gtFine_labelIds.png"
                    self.items.append((img_dir / city / f, seg))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        img_path, seg_path = self.items[index]
        img = load_eval_image(img_path, self.image_size)
        seg = load_eval_target(seg_path, self.image_size, id_map=map_id_to_train_id)
        return _identity_sample(img, seg, index)


@dataclasses.dataclass
class BDDSeg:
    """BDD10k val segmentation (bdd_dataset.py): `images/10k/<split>/*` with
    `labels/sem_seg/masks/<split>/*.png`. The port reads PNG only: the
    release's JPEG images raise until they are converted."""

    root: str
    image_set: str = "val"
    image_size: Tuple[int, int] = (192, 640)

    def __post_init__(self):
        img_dir = Path(self.root) / "images" / "10k" / self.image_set
        seg_dir = Path(self.root) / "labels" / "sem_seg" / "masks" / self.image_set
        self.items = [(img_dir / f, seg_dir / f"{os.path.splitext(f)[0]}.png")
                      for f in (sorted(os.listdir(img_dir)) if img_dir.exists() else [])]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index) -> Dict[str, np.ndarray]:
        img_path, seg_path = self.items[index]
        img = load_eval_image(img_path, self.image_size)
        seg = load_eval_target(seg_path, self.image_size)
        return _identity_sample(img, np.where(seg == 255, -1, seg), index)
