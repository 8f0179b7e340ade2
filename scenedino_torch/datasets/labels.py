"""KITTI-360 / Cityscapes label taxonomy (the port's copy of
`scenedino_tpu/datasets/labels.py:17-114`, the part the loaders and the
evaluators use): the canonical Cityscapes label table with id, trainId,
name and colour; trainIds 0..18 are the 19 evaluation classes, 255 the
ignored ones (-1 after `map_id_to_train_id`).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Label:
    name: str
    id: int
    trainId: int
    color: Tuple[int, int, int]


LABELS = [
    Label("unlabeled", 0, 255, (0, 0, 0)),
    Label("ego vehicle", 1, 255, (0, 0, 0)),
    Label("rectification border", 2, 255, (0, 0, 0)),
    Label("out of roi", 3, 255, (0, 0, 0)),
    Label("static", 4, 255, (0, 0, 0)),
    Label("dynamic", 5, 255, (111, 74, 0)),
    Label("ground", 6, 255, (81, 0, 81)),
    Label("road", 7, 0, (128, 64, 128)),
    Label("sidewalk", 8, 1, (244, 35, 232)),
    Label("parking", 9, 255, (250, 170, 160)),
    Label("rail track", 10, 255, (230, 150, 140)),
    Label("building", 11, 2, (70, 70, 70)),
    Label("wall", 12, 3, (102, 102, 156)),
    Label("fence", 13, 4, (190, 153, 153)),
    Label("guard rail", 14, 255, (180, 165, 180)),
    Label("bridge", 15, 255, (150, 100, 100)),
    Label("tunnel", 16, 255, (150, 120, 90)),
    Label("pole", 17, 5, (153, 153, 153)),
    Label("polegroup", 18, 255, (153, 153, 153)),
    Label("traffic light", 19, 6, (250, 170, 30)),
    Label("traffic sign", 20, 7, (220, 220, 0)),
    Label("vegetation", 21, 8, (107, 142, 35)),
    Label("terrain", 22, 9, (152, 251, 152)),
    Label("sky", 23, 10, (70, 130, 180)),
    Label("person", 24, 11, (220, 20, 60)),
    Label("rider", 25, 12, (255, 0, 0)),
    Label("car", 26, 13, (0, 0, 142)),
    Label("truck", 27, 14, (0, 0, 70)),
    Label("bus", 28, 15, (0, 60, 100)),
    Label("caravan", 29, 255, (0, 0, 90)),
    Label("trailer", 30, 255, (0, 0, 110)),
    Label("train", 31, 16, (0, 80, 100)),
    Label("motorcycle", 32, 17, (0, 0, 230)),
    Label("bicycle", 33, 18, (119, 11, 32)),
    Label("garage", 34, 2, (64, 128, 128)),
    Label("gate", 35, 4, (190, 153, 153)),
    Label("stop", 36, 255, (150, 120, 90)),
    Label("smallpole", 37, 5, (153, 153, 153)),
    Label("lamp", 38, 255, (0, 64, 64)),
    Label("trash bin", 39, 255, (0, 128, 192)),
    Label("vending machine", 40, 255, (128, 64, 0)),
    Label("box", 41, 255, (64, 64, 128)),
    Label("unknown construction", 42, 255, (102, 0, 0)),
    Label("unknown vehicle", 43, 255, (51, 0, 51)),
    Label("unknown object", 44, 255, (32, 32, 32)),
    Label("license plate", -1, -1, (0, 0, 142)),
]

N_TRAIN_CLASSES = 19

# trainId -> its first label in the table (the reference's trainId2label)
TRAINID2LABEL = {}
for _l in LABELS:
    TRAINID2LABEL.setdefault(_l.trainId, _l)

# the 19 train classes' colours in [0, 1], then black (the PLY sequence's class colours)
TRAIN_CLASS_COLORS = np.array(
    [TRAINID2LABEL[t].color for t in range(N_TRAIN_CLASSES)] + [(0, 0, 0)], np.float32
) / 255.0

_ID_TO_TRAIN = np.full(256, -1, np.int64)
for _l in LABELS:
    if 0 <= _l.id < 256:
        _ID_TO_TRAIN[_l.id] = _l.trainId if _l.trainId != 255 else -1


def map_id_to_train_id(labels):
    """KITTI/Cityscapes ids -> trainIds with 255 -> -1
    (semantic_head.py:247-254)."""
    return _ID_TO_TRAIN[np.asarray(labels, np.int64)]

# KITTI-360's own annotation ids (the "kittiId" column of the canonical
# table): the 3D bbox XMLs store these, not the Cityscapes ids
# (scenedino_tpu/datasets/labels.py:74-93)
KITTI_ID_BY_NAME = {
    "road": 1, "parking": 2, "sidewalk": 3, "terrain": 4, "vegetation": 5,
    "gate": 6, "wall": 7, "fence": 8, "sky": 9, "rail track": 10,
    "building": 11, "garage": 12, "car": 13, "truck": 14, "trailer": 15,
    "caravan": 16, "motorcycle": 17, "bicycle": 18, "person": 19,
    "rider": 20, "pole": 21, "smallpole": 22, "traffic light": 23,
    "traffic sign": 24, "lamp": 25, "trash bin": 26, "vending machine": 27,
    "box": 28, "stop": 29, "guard rail": 30, "bridge": 31, "tunnel": 32,
    "train": 33, "bus": 34, "unknown construction": 35,
    "unknown vehicle": 36, "unknown object": 37,
}

NAME2LABEL = {l.name: l for l in LABELS}
KITTIID2LABEL = {KITTI_ID_BY_NAME[l.name]: l for l in LABELS if l.name in KITTI_ID_BY_NAME}
