"""Dataset factories (counterpart of `scenedino_tpu/datasets/__init__.py`):
the synthetic training set, and the evaluation sets SSCBench,
Cityscapes_seg and BDD_seg."""
from __future__ import annotations

from typing import Tuple


def make_datasets(config: dict) -> Tuple:
    """(train, test) datasets from a `dataset:` config block."""
    kind = config.get("type", "old_KITTI_360")
    if kind == "synthetic":
        from scenedino_torch.datasets.synthetic import SyntheticMultiViewDataset

        ds = SyntheticMultiViewDataset(
            length=config.get("length", 64),
            n_views=config.get("n_views", 8),
            image_size=tuple(config.get("image_size", (48, 96))),
            textured=config.get("textured", True),
        )
        return ds, ds
    raise NotImplementedError(f"the port reads the synthetic dataset only, got type {kind!r}")


def make_test_dataset(config: dict):
    """An evaluation set from a `dataset:` config block (the reference's
    make_test_dataset, scenedino_tpu/datasets/__init__.py:130-146). The 2D
    sets crop to the block's `image_size` (the reference keeps its default,
    (192, 640), which every shipped config gives). The KITTI-360 kinds
    raise: that loader waits in ROADMAP queue 1, item 7."""
    kind = config.get("type")
    size = tuple(config.get("image_size", (192, 640)))
    if kind == "Cityscapes_seg":
        from scenedino_torch.datasets.seg2d import CityscapesSeg

        return CityscapesSeg(root=config["data_path"], image_set=config.get("split", "val"), image_size=size)
    if kind == "BDD_seg":
        from scenedino_torch.datasets.seg2d import BDDSeg

        return BDDSeg(root=config["data_path"], image_set=config.get("split", "val"), image_size=size)
    if kind == "SSCBench":
        from scenedino_torch.datasets.sscbench import SSCBenchDataset

        return SSCBenchDataset(data_path=config["data_path"], voxel_gt_path=config["voxel_gt_path"])
    if kind in ("old_KITTI_360", "KITTI_360", "KITTI_360_v2"):
        raise NotImplementedError(f"dataset type {kind!r}: the KITTI-360 loader is not ported (ROADMAP queue 1, "
                                  "item 7)")
    raise ValueError(f"unknown test dataset type: {kind!r}")
