"""KITTI-360's 3D bounding boxes on the host (the port's copy of
`scenedino_tpu/datasets/annotations.py`; reference
`datasets/kitti_360/annotation.py:111-174` and
`old_kitti_360.py:615-650, 768-795`).

A sequence's boxes are in `data_3d_bboxes/train_full/<sequence>.xml`:
each object node holds an OpenCV-matrix transform and a template's
vertices and faces, and either a `semanticId` (a KITTI id) for an instance
or a `label` string for stuff.
"""
from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from scenedino_torch.datasets.labels import KITTIID2LABEL, NAME2LABEL

# stuff labels whose strings differ from the canonical names (annotation.py:155-161)
_STUFF_CLASSMAP = {
    "driveway": "parking", "ground": "terrain", "unknownGround": "ground",
    "railtrack": "rail track", "bigPole": "pole",
    "unknownObject": "unknown object", "smallPole": "smallpole",
    "trafficSign": "traffic sign", "trashbin": "trash bin",
    "guardrail": "guard rail", "trafficLight": "traffic light",
    "pedestrian": "person", "vendingmachine": "vending machine",
    "unknownConstruction": "unknown construction",
    "unknownVehicle": "unknown vehicle",
}


@dataclasses.dataclass
class Bbox3D:
    """One box: world-frame vertices and the faces over them."""

    vertices: np.ndarray  # (8+, 3) float64
    faces: np.ndarray  # (F, vertices a face)
    semantic_id: int  # the Cityscapes-style id
    instance_id: int  # -1 for stuff
    name: str
    start_frame: int
    end_frame: int
    timestamp: int  # -1 for a static object


def _opencv_matrix(node) -> np.ndarray:
    rows, cols = int(node.find("rows").text), int(node.find("cols").text)
    return np.asarray([float(d) for d in node.find("data").text.split()], np.float64).reshape(rows, cols)


def _parse_object(child) -> Optional[Bbox3D]:
    if child.find("transform") is None:
        return None
    sem = child.find("semanticId")
    if sem is not None:  # an instance (annotation.py:138-153)
        label = KITTIID2LABEL[int(sem.text)]
        name, instance_id = label.name, int(child.find("instanceId").text)
    else:  # stuff (annotation.py:155-174)
        name = _STUFF_CLASSMAP.get(child.find("label").text, child.find("label").text)
        label, instance_id = NAME2LABEL[name], -1
    transform = _opencv_matrix(child.find("transform"))
    vertices = _opencv_matrix(child.find("vertices")) @ transform[:3, :3].T + transform[:3, 3]
    return Bbox3D(vertices=vertices, faces=_opencv_matrix(child.find("faces")), semantic_id=label.id,
                  instance_id=instance_id, name=name, start_frame=int(child.find("start_frame").text),
                  end_frame=int(child.find("end_frame").text), timestamp=int(child.find("timestamp").text))


def load_3d_bboxes(xml_path) -> Dict[int, List[Bbox3D]]:
    """One sequence's XML -> {timestamp: [Bbox3D, ...]}; a static object's
    timestamp is -1 and it belongs to every frame."""
    objects: Dict[int, List[Bbox3D]] = defaultdict(list)
    for child in ET.parse(str(xml_path)).getroot():
        obj = _parse_object(child)
        if obj is not None:
            objects[obj.timestamp].append(obj)
    return objects


def load_sequence_bboxes(data_path, sequences) -> Dict[str, Dict[int, List[Bbox3D]]]:
    """Every sequence's boxes from `data_3d_bboxes/train_full/<sequence>.xml`."""
    root = Path(data_path) / "data_3d_bboxes" / "train_full"
    return {seq: load_3d_bboxes(root / f"{seq}.xml") for seq in sequences}


def get_3d_bboxes(seq_bboxes: Dict[int, List[Bbox3D]], img_id: int, pose_c2w: np.ndarray, projs: np.ndarray,
                  z_far: float = 80.0) -> List[Dict]:
    """The boxes of one frame (the static ones and the frame's own) of which
    a vertex projects into the normalized image [-1, 1]^2 at a depth in
    (0, z_far], in the reference's dict layout: vertices, faces, semanticId,
    instanceId."""
    w2c = np.linalg.inv(np.asarray(pose_c2w, np.float64))
    K = np.asarray(projs, np.float64)

    def visible(box: Bbox3D) -> bool:
        verts = (K @ (w2c[:3, :3] @ box.vertices.T + w2c[:3, 3, None])).T
        with np.errstate(divide="ignore", invalid="ignore"):
            xy = verts[:, :2] / verts[:, 2:3]
        z = verts[:, 2]
        return bool(np.any((xy[:, 0] >= -1) & (xy[:, 0] <= 1) & (xy[:, 1] >= -1) & (xy[:, 1] <= 1)
                           & (z > 0) & (z <= z_far)))

    boxes = seq_bboxes.get(-1, []) + seq_bboxes.get(img_id, [])
    return [{"vertices": b.vertices, "faces": b.faces, "semanticId": b.semantic_id, "instanceId": b.instance_id}
            for b in boxes if visible(b)]
