"""Dataset factories (counterpart of `scenedino_tpu/datasets/__init__.py`):
the KITTI-360 loader (types old_KITTI_360, KITTI_360, KITTI_360_v2), the
RealEstate10K loader (types RealEstate10k, RealEstate10K, re10k), the
synthetic training set, and the evaluation sets SSCBench, Cityscapes_seg
and BDD_seg."""
from __future__ import annotations

import os
from typing import Tuple

from scenedino_torch.datasets.labels import map_id_to_train_id

KITTI_360_KINDS = ("old_KITTI_360", "KITTI_360", "KITTI_360_v2")
RE10K_KINDS = ("RealEstate10k", "RealEstate10K", "re10k")


def _kitti_360_common(config: dict, kind: str) -> dict:
    """The KITTI360Dataset arguments that the train and test instances share
    (scenedino_tpu/datasets/__init__.py:43-68). old_KITTI_360 and KITTI_360
    take the offsets layout (the reference's KITTI_360 refactor reads the
    same data and geometry), KITTI_360_v2 the overlap sampling. The stereo
    offset defaults to the dataset's 0: the reference's factory never passes
    it (its kwarg is commented out, scenedino/datasets/__init__.py:87,97)."""
    return dict(
        data_path=config["data_path"],
        pose_path=config["pose_path"],
        target_image_size=tuple(config.get("image_size", (192, 640))),
        frame_count=config.get("data_fc", config.get("frame_count", 2)),
        return_stereo=config.get("data_stereo", True),
        return_fisheye=config.get("data_fisheye", True),
        return_segmentation=config.get("data_segmentation", config.get("return_segmentation", False)),
        keyframe_offset=config.get("keyframe_offset", 0),
        dilation=config.get("dilation", 1),
        fisheye_rotation=config.get("fisheye_rotation", (0, -15)),
        stereo_offset=config.get("stereo_offset", 0),
        is_preprocessed=config.get("is_preprocessed", False),
        return_3d_bboxes=config.get("data_3d_bboxes", config.get("return_3d_bboxes", False)),
        frame_sampling_strategy="overlap" if kind == "KITTI_360_v2" else config.get("frame_sampling_strategy",
                                                                                       "offsets"),
        overlap_min_ratio=config.get("overlap_min_ratio", 0.4),
        overlap_max_samples=config.get("overlap_max_samples", 128),
        overlap_ranges=config.get("overlap_ranges"),
    )


def make_datasets(config: dict) -> Tuple:
    """(train, test) datasets from a `dataset:` config block. For KITTI-360
    a `split_path` that is a directory means its train_files.txt and (unless
    `test_split_path` is given) test_files.txt, a file is read as it is; the
    test instance returns depth, pins the fisheye offset to 10 and has no
    colour jitter (scenedino/datasets/__init__.py:66-107)."""
    kind = config.get("type", "old_KITTI_360")
    if kind in KITTI_360_KINDS:
        from scenedino_torch.datasets.kitti_360 import KITTI360Dataset

        common = _kitti_360_common(config, kind)
        split_path = config.get("split_path")
        test_split_path = config.get("test_split_path")
        if split_path is not None and os.path.isdir(split_path):
            if test_split_path is None:
                test_split_path = os.path.join(split_path, "test_files.txt")
            split_path = os.path.join(split_path, "train_files.txt")
        train = KITTI360Dataset(split_path=split_path, fisheye_offset=config.get("fisheye_offset", (10,)),
                                color_aug=config.get("color_aug", False), **common)
        test = KITTI360Dataset(split_path=test_split_path, fisheye_offset=(10,), color_aug=False,
                               return_depth=True, **common)
        return train, test
    if kind in RE10K_KINDS:
        from scenedino_torch.datasets.re10k import RealEstate10kDataset

        # a directory split_path: its train_files.txt where there is one (else
        # the full windows) and its val_files.txt for the test instance
        # (scenedino_tpu/datasets/__init__.py:92-116); no test split: the
        # training set serves as the test instance
        split_path = config.get("split_path")
        test_split_path = config.get("test_split_path")
        if split_path is not None and os.path.isdir(split_path):
            if test_split_path is None:
                test_split_path = os.path.join(split_path, "val_files.txt")
            train_file = os.path.join(split_path, "train_files.txt")
            split_path = train_file if os.path.isfile(train_file) else None
        common = dict(data_path=config["data_path"], image_size=tuple(config.get("image_size", (256, 384))),
                      frame_count=config.get("data_fc", 4), dilation=config.get("dilation", 3))
        train = RealEstate10kDataset(split_path=split_path, **common)
        if test_split_path is None:
            return train, train
        return train, RealEstate10kDataset(split_path=test_split_path, **common)
    if kind == "synthetic":
        from scenedino_torch.datasets.synthetic import SyntheticMultiViewDataset

        ds = SyntheticMultiViewDataset(
            length=config.get("length", 64),
            n_views=config.get("n_views", 8),
            image_size=tuple(config.get("image_size", (48, 96))),
            textured=config.get("textured", True),
        )
        return ds, ds
    raise ValueError(f"unknown dataset type: {kind}")


class TrainIdSegs:
    """A dataset whose items' "segs" (KITTI-360 semantic ids, 0-44) are
    mapped to the 19 train ids (-1 ignored) with `labels.map_id_to_train_id`,
    as the reference's semantic head maps its targets
    (semantic_head.py:247-254). The KITTI-360 loader returns the PNG's ids
    unmapped, as the JAX loader does; the JAX package hands them on unmapped
    too, where an id >= 19 makes the linear probes' cross entropy NaN (every
    stage-2 step is skipped) and an id < 19 is scored as that train id. The
    port's stage-2 and 2D-evaluation CLIs read the KITTI-360 kinds through
    this view (ROADMAP queue 3). The Cityscapes and BDD loaders map their own
    labels already."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index):
        item = self.dataset[index]
        if "segs" in item:
            item = {**item, "segs": map_id_to_train_id(item["segs"])}
        return item


def with_train_ids(dataset, config: dict):
    """`dataset` read through `TrainIdSegs` when the `dataset:` block is a
    KITTI-360 kind, else as it is."""
    return TrainIdSegs(dataset) if config.get("type", "old_KITTI_360") in KITTI_360_KINDS else dataset


def make_test_dataset(config: dict):
    """An evaluation set from a `dataset:` config block (the reference's
    make_test_dataset, scenedino_tpu/datasets/__init__.py:130-146). The 2D
    sets crop to the block's `image_size` (the reference keeps its default,
    (192, 640), which every shipped config gives). The KITTI-360 kinds
    build the test instance from the block's test split (a directory's
    test_files.txt) with depth, the block's fisheye offset (default 1, not
    make_datasets' pinned 10; scenedino/datasets/__init__.py:220-240) and
    no colour jitter; other kinds (RealEstate10K among them) take
    make_datasets' test instance."""
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
    if kind in KITTI_360_KINDS:
        from scenedino_torch.datasets.kitti_360 import KITTI360Dataset

        split_path = config.get("split_path")
        if split_path is not None and os.path.isdir(split_path):
            split_path = os.path.join(split_path, "test_files.txt")
        return KITTI360Dataset(split_path=split_path, fisheye_offset=config.get("fisheye_offset", (1,)),
                               return_depth=True, **_kitti_360_common(config, kind))
    _, test = make_datasets(config)
    return test
